"""Monte-Carlo policy sweeps: one launch, many weight variants.

A policy variant that changes only score *weights* is a row of a [V, S]
weight matrix: every variant's whole sequential pass over the same cluster
and queue runs in one launch of the `sweep_run` kernel (engine/cuda.py,
csrc/seq_kernels.cu), one block per variant at a time. Variants that change
the plugin *set* need one sweep per set.

The reference vmaps its pass over the variants, and since vmap cannot
branch it runs DefaultPreemption either masked (the dry run every step,
select-gated) or as a two-phase host event loop (the pass without
preemption up to each variant's first preemption-eligible failure, then
that pod's dry run, eviction, retry and bind). Both give each variant's
sequential placements. A block of `sweep_run` branches per variant, so
every mode runs the one kernel, and each variant equals `seq_run` on its
weights.
"""

from __future__ import annotations

import numpy as np
import torch

from ..engine import cuda
from ..engine.encode import EncodedCluster
from ..engine.engine import BatchedScheduler


def weights_for(enc: EncodedCluster, overrides: "dict[str, int]") -> np.ndarray:
    """One weight vector in the engine's score-plugin order, starting from
    the configuration's weights with `overrides` applied by plugin name."""
    specs = list(enc.config.score_plugins())
    unknown = set(overrides) - {n for n, _ in specs}
    if unknown:
        raise KeyError(f"not score plugins in this config: {sorted(unknown)}")
    return np.asarray([overrides.get(n, w) for n, w in specs], dtype=np.int32)


class WeightSweep:
    """The sequential pass over score-weight variants.

    `preempt` is the reference's strategy name and is validated as it is:
    "auto" gives "phase" when the configuration enables DefaultPreemption,
    else "off"; `record=True` with "phase" gives "masked"; "off" with
    DefaultPreemption raises ValueError. Every mode runs the same kernel.
    `mesh`: sharding the variants over several cards is not ported yet
    (anything but None raises NotImplementedError). Runs on the CUDA card
    unless `device` names another.
    """

    def __init__(
        self,
        enc: EncodedCluster,
        *,
        mesh=None,
        record: bool = False,
        preempt: str = "auto",
        device: "str | torch.device | None" = None,
    ):
        has_preempt = "DefaultPreemption" in enc.config.enabled("postFilter")
        if preempt == "auto":
            preempt = "phase" if has_preempt else "off"
        if preempt not in ("phase", "masked", "off"):
            raise ValueError(
                f"preempt must be auto|phase|masked|off, got {preempt!r}"
            )
        if preempt != "off" and not has_preempt:
            preempt = "off"
        if preempt == "off" and has_preempt:
            raise ValueError(
                "config enables DefaultPreemption; use preempt='phase' or "
                "'masked' (or disable the postFilter)"
            )
        if record and preempt == "phase":
            # the reference's per-step trace exists only in its masked form
            preempt = "masked"
        if mesh is not None:
            raise NotImplementedError("sweeps over a device mesh are not ported; pass mesh=None")
        self.preempt = preempt
        self.sched = BatchedScheduler(
            enc, record=record, strict=True, preempt_mode="masked", device=device
        )
        self.enc = self.sched.enc
        self.device = self.sched.device

    def run(self, weight_matrix) -> tuple:
        """weight_matrix: [V, S] ints (S = score plugins in config order).
        Returns (final states, selections [V, Q] int32): every SchedState
        field with a leading [V]; each variant's queue-indexed selections
        (the bound node, -1 for none). With `record`, (final states, trace):
        `BatchedScheduler`'s trace slots, each with a leading [V]."""
        w = np.asarray(weight_matrix, np.int32)
        S = len(self.sched.weights)
        if w.ndim != 2 or w.shape[1] != S:
            raise ValueError(f"weight matrix must be [V, {S}], got {w.shape}")
        enc, dev = self.enc, self.device
        weights = torch.as_tensor(w).to(device=dev, dtype=enc.policy.score)
        states0 = cuda.stack_states([enc.state0] * w.shape[0])
        queue = torch.as_tensor(np.asarray(enc.queue, np.int32), device=dev)
        return cuda.sweep_run(self.sched.program, enc.arrays, states0, queue, weights,
                              record=self.sched.record)

    def placements(self, sels) -> list[dict]:
        """Decode selections into per-variant {(ns, name): node} dicts."""
        sels = np.asarray(torch.as_tensor(sels).cpu())
        return [self.enc.decode_selection(sels[v]) for v in range(sels.shape[0])]
