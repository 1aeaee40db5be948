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

`GangSweep` is the same sweep through the gang (fixpoint) engine: every
round of every variant is one launch of each K9 kernel (engine/gang.py's
round body over a [V, ...] stack of states), and DefaultPreemption's
phases run all variants' pending segments in one `sweep_run` launch. Its
host loop is the reference's: the variants advance in lockstep, so one that
has settled rides along through the phases and resumed passes of the
others (each resume runs at least one round of every variant).
"""

from __future__ import annotations

import numpy as np
import torch

from ..engine import cuda, packing
from ..engine.encode import EncodedCluster, SchedState
from ..engine.engine import BatchedScheduler
from ..engine.gang import GangScheduler


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
        return cuda.sweep_run(self.sched.program, packing.widen(enc), states0, queue, weights,
                              record=self.sched.record)

    def placements(self, sels) -> list[dict]:
        """Decode selections into per-variant {(ns, name): node} dicts."""
        sels = np.asarray(torch.as_tensor(sels).cpu())
        return [self.enc.decode_selection(sels[v]) for v in range(sels.shape[0])]


class GangSweep:
    """The gang (fixpoint) pass over score-weight variants: the reference's
    `GangSweep` (its `gangsweep.vrun`, `vrun_resume` and `vphase`).

    `chunk`, `loop` and `eval_window` are `GangScheduler`'s (each variant
    keeps its own window offset); under loop="static" a gang pass is
    counted passes of every variant, resumed while any variant spent its
    whole budget (`gang.static_rounds`, read at run time) and the total
    pending count shrinks (`_passes`). A `mesh` other than None is not
    ported and raises NotImplementedError.
    Runs on the CUDA card unless `device` names another. The reference
    evaluates every queue row every round (`compact=False`); this sweep
    evaluates each variant's pending rows only, which places the same pods
    in the same rounds. A gang pass runs the variants in groups when the
    round buffers of all of them ([V, Q, N] scores) would not fit the
    card's free memory; variants are independent inside a pass, so the
    groups change no result. `last_stats` holds what the last `run()` did:
    rounds and phase pods per variant, each phase's segment lengths and the
    pods it bound per variant, the passes, host readbacks and the groups of
    each pass."""

    _group_cap: "int | None" = None  # at most this many variants a group (tests)

    def __init__(
        self,
        enc: EncodedCluster,
        *,
        mesh=None,
        chunk: int = 256,
        loop: str = "dynamic",
        eval_window: "int | None" = None,
        device: "str | torch.device | None" = None,
    ):
        if mesh is not None:
            raise NotImplementedError("sweeps over a device mesh are not ported; pass mesh=None")
        self.gang = GangScheduler(enc, chunk=chunk, loop=loop, eval_window=eval_window,
                                  device=device)
        self.enc = self.gang.enc
        self.device = self.gang.device
        self.loop = loop
        self.last_stats: dict = {}
        self._states = None
        # a private hold for checks: (phases, passes) — run exactly that many
        # phases and gang passes, whatever they bind, as a longer sweep did
        # (one of its variants alone, held to its lockstep)
        self._hold: "tuple[int, int] | None" = None

    def run(self, weight_matrix) -> tuple:
        """weight_matrix: [V, S] ints (S = score plugins in config order).
        Returns (assignments [V, P] int32, rounds [V] int32) on the engine's
        device."""
        w = np.asarray(weight_matrix, np.int32)
        S = len(self.gang.weights)
        if w.ndim != 2 or w.shape[1] != S:
            raise ValueError(f"weight matrix must be [V, {S}], got {w.shape}")
        with self.gang.widened() as a:
            return self._run(w, a)

    def _run(self, w, a) -> tuple:
        """`run` on the widened planes `a`."""
        g, enc = self.gang, self.enc
        V = w.shape[0]
        weights = torch.as_tensor(w).to(device=self.device, dtype=enc.policy.score)
        states = cuda.stack_states([enc.state0] * V)
        stats = {"rounds": [0] * V, "passes": 0, "phases": 0, "phase_pods": [0] * V,
                 "phase_pending": [], "phase_bound": [], "host_syncs": 0, "groups": []}
        self.last_stats = g.last_stats = stats  # _gang_pass counts its readbacks there
        rounds, n_pend = self._passes(states, weights)
        hold = self._hold
        prog = g._base.program
        while g.preempts:
            # the reference's rule: a phase while any variant has pods pending,
            # a resumed pass of every variant while any phase bound a pod
            if (max(n_pend) == 0 if hold is None else stats["phases"] >= hold[0]):
                break
            segs, qpos = self._segments(states, n_pend)
            states, sel = cuda.sweep_run(prog, a, states, segs, weights, record=False, qpos=qpos)
            n_bound = (sel >= 0).sum(dim=1).tolist()
            stats["host_syncs"] += 1
            stats["phases"] += 1
            stats["phase_pending"].append(list(n_pend))
            stats["phase_bound"].append(n_bound)
            stats["phase_pods"] = [x + y for x, y in zip(stats["phase_pods"], n_pend)]
            if (sum(n_bound) == 0 if hold is None else stats["passes"] >= hold[1]):
                break
            r2, n_pend = self._passes(states, weights)
            rounds = [x + y for x, y in zip(rounds, r2)]
        stats["rounds"] = rounds
        self._states = states  # every variant's final state, for checks
        return states.assignment, torch.tensor(rounds, dtype=torch.int32, device=self.device)

    def _passes(self, states: SchedState, weights) -> tuple:
        """A gang pass of every variant; under loop="static" the reference's
        per-variant-array auto-resume (its `GangSweep.run.gang_pass`):
        another counted pass of every variant while any variant's last pass
        progressed through the whole budget and pods are pending, until
        the total pending count stops shrinking. Returns (rounds, pods still
        pending), lists of V."""
        rounds, n_pend = self._pass(states, weights)
        last = rounds
        while (self.loop == "static" and sum(n_pend) > 0
               and any(r >= self.gang.static_rounds for r in last)):
            last, n2 = self._pass(states, weights)
            rounds = [x + y for x, y in zip(rounds, last)]
            stalled, n_pend = sum(n2) >= sum(n_pend), n2
            if stalled:
                break
        return rounds, n_pend

    def _pass(self, states: SchedState, weights) -> tuple:
        """One gang pass of every variant, in place, the variants in groups
        (`_group_size`). Returns (rounds, pods still pending), lists of V."""
        V = weights.shape[0]
        G = self._group_size(V)
        rounds, n_pend = [], []
        for g0 in range(0, V, G):
            part = cuda.variant_slice(states, g0, g0 + G)
            r, n = self.gang._gang_pass(part, weights[g0:g0 + G])
            rounds += r
            n_pend += n
        self.last_stats["groups"].append(-(-V // G))
        self.last_stats["passes"] += 1
        return rounds, n_pend

    def _group_size(self, V: int) -> int:
        """The variants a gang pass runs at once: all of them, unless their
        round buffers (the first round's scores [Q, N] and top-k [Q, W] a
        variant, its row lists and matching scratch) would take more than
        half of the card's free memory."""
        if self._group_cap is not None:
            return max(1, min(V, int(self._group_cap)))
        if self.device.type != "cuda":
            return V
        g, enc = self.gang, self.enc
        Q, N = len(enc.queue), enc.N
        isz = torch.empty((), dtype=enc.policy.score).element_size()
        W = g.match_width if g.match_width < N else 0
        C = packing.logical_dim(enc, "pod_claim")
        per_variant = Q * (N * isz + W * (isz + 4) + 64) + 4 * (3 * N + 2 * C + 8)
        free, _ = torch.cuda.mem_get_info(self.device)
        free += torch.cuda.memory_reserved(self.device) - torch.cuda.memory_allocated(self.device)
        return max(1, min(V, (free // 2) // per_variant))

    def _segments(self, states: SchedState, n_pend: list) -> tuple:
        """Each variant's preempt segment: its pending pods in queue order,
        -1 padded to the longest ([V, K] int32), and their queue positions
        (the bind order of the phase's steps)."""
        g = self.gang
        rows, count = g._pending(states, sort=True)
        K = max(1, max(n_pend))
        pos = torch.arange(K, device=self.device)[None, :]
        segs = torch.where(pos < count[:, None], rows[:, :K], -1).to(torch.int32).contiguous()
        qpos = torch.where(segs >= 0, g._order[segs.clamp(min=0).long()], 0).contiguous()
        return segs, qpos

    def placements(self, assignments) -> list[dict]:
        """Per-variant {(ns, name): node} decode of the assignment axis."""
        assignments = np.asarray(torch.as_tensor(assignments).cpu())
        return [self.enc.decode_assignment(assignments[v]) for v in range(assignments.shape[0])]
