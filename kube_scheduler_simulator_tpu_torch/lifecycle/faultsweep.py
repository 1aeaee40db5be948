"""Monte-Carlo node-failure sweeps: many sampled fault scenarios of one
cluster in one pass on the card (the reference's `lifecycle/faultsweep.py`,
K11 `faultsweep.one`, `vrun` and `bind_all`).

  1. The cluster is encoded once with every pod in the queue; the pods
     bound in the baseline are bound into the baseline state with one
     launch of the gang engine's bind (`cuda.gang_bind`, `bind_all`), so a
     scenario can evict them and queue them again without a new encoding.
  2. A scenario is a row of an [S, N] failure mask: each real node fails
     with `fail_prob` (`sample_masks`, the reference's `jax.random` draw bit
     for bit: utils/prng.py).
  3. For every scenario at once: `cuda.fault_evict` evicts the bound pods of
     its failed nodes and writes its node mask (node_mask & ~fail); the
     gang round fixpoint runs every scenario through the K9 kernels' tenant
     forms, one launch of each a round (engine/gang.py `_ScenarioRounds`),
     each scenario to its own fixpoint (loop="static": one counted pass);
     `cuda.fault_tally` counts the evicted pods bound again (rescheduled)
     and the rest (stranded).

As the reference's, the sweep runs the round fixpoint only, with no
preempt phases even where the profile enables DefaultPreemption: it
measures re-placement capacity, not eviction cascades. `run_one` is the
S = 1 form of the same code, the parity probe of `run`. Under PACKED the
baseline bind and each sweep widen the encoding's planes once
(`packing.widen`, a K8 launch each).
"""

from __future__ import annotations

import numpy as np
import torch

from ..engine import cuda, packing
from ..engine.encode import TPU32, EncodedCluster, SchedState, encode_cluster
from ..engine.gang import GangScheduler, _ScenarioRounds
from ..utils import prng


class FaultSweep:
    """Monte-Carlo node-failure sweep over one encoded cluster, on `device`
    (the CUDA card unless the caller names another). `chunk`, `loop` and
    `eval_window` are `GangScheduler`'s; under loop="static" each scenario
    runs exactly one counted pass of the gang's `static_rounds` slots, with
    no auto-resume, as the reference's (a scenario that needs more rounds
    strands pods the dynamic sweep places). `mesh` (sharding the scenarios
    over several cards) is not ported and raises NotImplementedError."""

    def __init__(
        self,
        enc: EncodedCluster,
        assignment: "dict[tuple[str, str], str] | None" = None,
        *,
        mesh=None,
        chunk: int = 256,
        loop: str = "dynamic",
        eval_window: "int | None" = None,
        device: "str | torch.device | None" = None,
    ):
        """`enc` holds the swept pods pending (in the queue), as
        `from_cluster` encodes them; `assignment` maps (ns, name) -> node
        name for the pods bound in the baseline state."""
        if mesh is not None:
            raise NotImplementedError("sweeps over a device mesh are not ported; pass mesh=None")
        # compact=False as the reference's; the scenario rounds evaluate
        # pending rows only, which commits the same pods in the same rounds
        self.gang = GangScheduler(enc, compact=False, chunk=chunk, loop=loop,
                                  eval_window=eval_window, device=device)
        self.enc = self.gang.enc
        self.device = self.gang.device
        self._order, _ = self.gang.order_arrays()
        self.weights = self.gang.weights
        self._state_bound = self._bind_baseline(assignment or {})
        # what the last sweep did: scenarios, rounds, host readbacks, the
        # bytes of the per-scenario order, claims and carrier rows
        self.last_stats: dict = {}
        self._states = None

    # -- construction helpers -------------------------------------------------

    @classmethod
    def from_cluster(
        cls,
        nodes: list[dict],
        pods: list[dict],
        config,
        *,
        policy=TPU32,
        priorityclasses=None,
        namespaces=None,
        pvcs=None,
        pvs=None,
        storageclasses=None,
        device: "str | torch.device | None" = None,
        **kwargs,
    ) -> "FaultSweep":
        """Encode `nodes` + `pods` for sweeping: every pod joins the queue
        (its `spec.nodeName` stripped) and the recorded bindings become the
        baseline state."""
        assignment: dict[tuple[str, str], str] = {}
        pending = []
        for p in pods:
            meta = p.get("metadata", {}) or {}
            key = (meta.get("namespace", "default"), meta.get("name", ""))
            node_name = (p.get("spec") or {}).get("nodeName", "")
            if node_name:
                assignment[key] = node_name
                p = {**p, "spec": {k: v for k, v in (p.get("spec") or {}).items()
                                   if k != "nodeName"}}
            pending.append(p)
        enc = encode_cluster(
            nodes, pending, config, policy=policy, priorityclasses=priorityclasses,
            namespaces=namespaces, pvcs=pvcs, pvs=pvs, storageclasses=storageclasses,
            device=device,
        )
        return cls(enc, assignment, device=device, **kwargs)

    def _bind_baseline(self, assignment: dict) -> SchedState:
        """state0 with every assigned pod bound to its node (K11
        `faultsweep.bind_all`: one `gang_bind` launch over the assigned
        pods, each at bind order P + its queue position)."""
        enc = self.enc
        if not assignment:
            return enc.state0
        node_idx = {n: i for i, n in enumerate(enc.node_names)}
        pods, nodes = [], []
        for p_idx, key in enumerate(enc.pod_keys):
            node_name = assignment.get(key, "")
            if node_name:
                if node_name not in node_idx:
                    raise ValueError(f"pod {key} assigned to unknown node {node_name!r}")
                pods.append(p_idx)
                nodes.append(node_idx[node_name])
        state = enc.state0.clone()
        if pods:
            i32 = dict(dtype=torch.int32, device=self.device)
            cuda.gang_bind(self.gang._base.program, packing.widen(enc), state,
                           torch.tensor(pods, **i32), None, torch.tensor(nodes, **i32),
                           self._order)
        return state

    # -- sampling ---------------------------------------------------------------

    def sample_masks(self, n_scenarios: int, seed: int, fail_prob: float, *,
                     x64: bool = False) -> torch.Tensor:
        """[S, N] bool failure masks on the sweep's device: each real node
        fails independently with `fail_prob` in each scenario; deterministic
        in (seed, S, p). The reference's `jax.random.bernoulli` draw bit for
        bit (utils/prng.py), which depends on one JAX process flag: `x64`
        gives the draw of a process with `jax_enable_x64` (float64 uniforms,
        the seed's high word in the key), the default that of one without
        it, as the reference's command line runs."""
        if n_scenarios < 1:
            raise ValueError(f"n_scenarios must be >= 1, got {n_scenarios}")
        if not (0.0 <= fail_prob <= 1.0):
            raise ValueError(f"fail_prob must be in [0, 1], got {fail_prob}")
        draw = prng.bernoulli(seed, fail_prob, (n_scenarios, self.enc.N), x64=x64)
        return torch.as_tensor(draw, device=self.device) & self.enc.arrays.node_mask[None, :]

    # -- execution --------------------------------------------------------------

    def _fail(self, masks) -> torch.Tensor:
        """The failure masks as a bool [S, N] tensor on the sweep's device."""
        m = masks if isinstance(masks, torch.Tensor) else torch.tensor(np.asarray(masks))
        m = m.to(device=self.device, dtype=torch.bool)
        if m.dim() != 2 or m.shape[1] != self.enc.N:
            raise ValueError(f"masks must be [S, {self.enc.N}], got {tuple(m.shape)}")
        return m.contiguous()

    def _sweep(self, fail: torch.Tensor, weights) -> tuple:
        """Every scenario of `fail` [S, N] on the card: the eviction
        prologue, the round fixpoint, the counters. Returns (assignments [S,
        P], evicted, rescheduled, stranded, rounds), [S] int32 each."""
        g, enc = self.gang, self.enc
        S = fail.shape[0]
        w = self.weights if weights is None else torch.as_tensor(
            weights, dtype=enc.policy.score, device=self.device)
        w = w[None].expand(S, -1).contiguous()
        states = cuda.stack_states([self._state_bound] * S)
        with g.widened() as a:
            evict, evicted, node_masks = cuda.fault_evict(g._base.program, a, states, fail)
            t = _ScenarioRounds(g, node_masks, a)
            # the first round takes rows up to the most pods pending in a
            # scenario; a counted pass (loop="static") is one, not resumed
            k0 = int(t._pending(states, sort=False)[1].max())
            rounds, _ = t._gang_pass(states, w, k0=k0)
        rescheduled, stranded = cuda.fault_tally(states.assignment, evict, evicted)
        self._states = states  # every scenario's final state, for checks
        self.last_stats = {"scenarios": S, "rounds": rounds,
                           "host_syncs": t.last_stats["host_syncs"] + 1,
                           "dup_bytes": t.dup_bytes}
        return (states.assignment, evicted, rescheduled, stranded,
                torch.tensor(rounds, dtype=torch.int32, device=self.device))

    def run(self, masks, weights=None) -> dict:
        """Sweep the [S, N] failure masks, every scenario at once. Returns
        the disruption profile (`_profile`)."""
        fail = self._fail(masks)
        return self._profile(fail, self._sweep(fail, weights))

    def run_one(self, mask, weights=None) -> tuple:
        """One scenario through the same code (S = 1): the parity probe of
        `run`. Returns (assignment [P], evicted, rescheduled, stranded,
        rounds) as tensors."""
        m = mask if isinstance(mask, torch.Tensor) else torch.tensor(np.asarray(mask))
        return tuple(x[0] for x in self._sweep(self._fail(m[None]), weights))

    def _profile(self, fail: torch.Tensor, out: tuple) -> dict:
        assignments, evicted, rescheduled, stranded, rounds = (
            np.asarray(x.cpu()) for x in out
        )
        S = assignments.shape[0]
        failed_per = np.asarray(fail.sum(dim=1).cpu())
        return {
            "scenarios": int(S),
            "failedNodes": {
                "mean": float(failed_per.mean()),
                "max": int(failed_per.max()),
            },
            "evicted": evicted.astype(int).tolist(),
            "rescheduled": rescheduled.astype(int).tolist(),
            "stranded": stranded.astype(int).tolist(),
            "rounds": rounds.astype(int).tolist(),
            "totals": {
                "evicted": int(evicted.sum()),
                "rescheduled": int(rescheduled.sum()),
                "stranded": int(stranded.sum()),
            },
            "worstScenario": int(stranded.argmax()) if S else -1,
            "assignments": assignments,
        }

    def placements(self, assignments) -> list[dict]:
        """Per-scenario {(ns, name): node | ""} decode."""
        assignments = np.asarray(torch.as_tensor(assignments).cpu())
        return [self.enc.decode_assignment(assignments[s]) for s in range(assignments.shape[0])]
