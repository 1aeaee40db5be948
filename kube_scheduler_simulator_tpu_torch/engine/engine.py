"""The sequential scheduler: one pass over the pod queue.

Each step schedules one pod exactly as the upstream framework does
(PreFilter → Filter → PreScore → Score → Normalize → weight → select →
bind; reference call stack SURVEY.md §3.3), with every per-node,
per-plugin evaluation vectorized over the whole node axis. Scanning the
queue in PrioritySort order with a scatter-update of node state after each
pod gives the placements of the one-pod-at-a-time reference scheduler (pod
i sees pod i-1's binding).

On the card the whole pass is one launch of the `seq_run` kernel
(engine/cuda.py); on the CPU its plain PyTorch version runs. `results()`
converts the dense trace host-side into the reference's exact annotation
wire format (sched/results.py). This is the reference package's
`engine/engine.py` without preemption, PACKED, chunked runs or sweeps.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..sched.results import (
    PASSED_FILTER_MESSAGE,
    SUCCESS_MESSAGE,
    PodSchedulingResult,
    record_bind_points,
)
from . import cuda
from . import kernels as K
from .encode import TPU32, DTypePolicy, EncodedCluster, encode_cluster, resolve_device


class UnsupportedPluginError(NotImplementedError):
    pass


# Trace slot layout of run()'s record=True output, by tuple position
# (the reference's engine.py:53; no preemption slots in this slice).
TRACE_SLOTS_PLAIN = ("pf_codes", "codes", "raw", "final", "sel")


def supported_config() -> "SchedulerConfiguration":
    """The default-plugin-order configuration restricted to the extension
    points and plugins the port has kernels for (this slice's set), with
    default weights."""
    from ..sched.config import SchedulerConfiguration, default_plugins

    dp = default_plugins()
    star = [{"name": "*"}]

    def keep(point, names):
        return {
            "disabled": star,
            "enabled": [e for e in dp[point] if e["name"] in names],
        }

    plugins = {
        "preFilter": keep(
            "preFilter", set(K.PREFILTER_KERNELS) | K.TRIVIAL_PREFILTER
        ),
        "filter": keep("filter", set(K.FILTER_KERNELS)),
        "postFilter": keep("postFilter", set(K.POSTFILTER_KERNELS)),
        "preScore": keep("preScore", set(K.PRESCORE_KERNELS) | K.TRIVIAL_PRESCORE),
        "score": keep("score", set(K.SCORE_KERNELS)),
    }
    return SchedulerConfiguration.from_dict(
        {"profiles": [{"schedulerName": "default-scheduler", "plugins": plugins}]}
    )


def unsupported_plugins(cfg: "SchedulerConfiguration") -> list[str]:
    """Enabled plugins the port has no kernel for (the strict-mode check)."""
    missing = [n for n in cfg.enabled("filter") if n not in K.FILTER_KERNELS]
    missing += [n for n, _ in cfg.score_plugins() if n not in K.SCORE_KERNELS]
    missing += [
        n
        for n in cfg.enabled("preFilter")
        if n not in K.PREFILTER_KERNELS and n not in K.TRIVIAL_PREFILTER
    ]
    missing += [
        n
        for n in cfg.enabled("preScore")
        if n not in K.PRESCORE_KERNELS and n not in K.TRIVIAL_PRESCORE
    ]
    missing += [
        n for n in cfg.enabled("postFilter") if n not in K.POSTFILTER_KERNELS
    ]
    return sorted(set(missing))


class BatchedScheduler:
    """The sequential scheduling engine over one `EncodedCluster`, on
    `device` (the CUDA card unless the caller names another; the encoding
    moves there if it lies elsewhere)."""

    def __init__(
        self,
        enc: EncodedCluster,
        *,
        record: bool = True,
        strict: bool = True,
        device: "str | torch.device | None" = None,
    ):
        self.device = resolve_device(device)
        self.enc = enc = enc.to(self.device)
        self.record = record
        cfg = enc.config
        # All prefilter names emitted into the trace (oracle order); every
        # one in this slice is trivially "success".
        self._prefilter_names = [
            n
            for n in cfg.enabled("preFilter")
            if n in K.PREFILTER_KERNELS or n in K.TRIVIAL_PREFILTER
        ]
        self._filter_names = [n for n in cfg.enabled("filter") if n in K.FILTER_KERNELS]
        self._prescore_names = [
            n
            for n in cfg.enabled("preScore")
            if n in K.TRIVIAL_PRESCORE or n in K.PRESCORE_KERNELS
        ]
        self._score_specs = [
            (n, w) for n, w in cfg.score_plugins() if n in K.SCORE_KERNELS
        ]
        if strict:
            missing = unsupported_plugins(cfg)
            if missing:
                raise UnsupportedPluginError(
                    f"no kernel for enabled plugins: {missing} "
                    "(pass strict=False to skip them)"
                )
        self.program = cuda.build_program(
            enc, self._filter_names, [n for n, _ in self._score_specs]
        )
        self.weights = torch.tensor(
            [w for _, w in self._score_specs], dtype=enc.policy.score, device=self.device
        )
        # run_fn is the pass itself: (arrays, state0, queue, weights) ->
        # (final_state, trace); run() pads the queue and calls it.
        self.run_fn = functools.partial(cuda.seq_run, self.program, record=record)
        self._trace = None
        self._final_state = None

    # -- single-pod segments (the reference's seq.attempt / seq.bind /
    # seq.step programs) -----------------------------------------------------

    def attempt_fn(self, arrays, state, weights, p):
        """One Filter→Score→Normalize→select pass for pod p: (pf_codes,
        codes, raw, final, sel, pf_ok) as the reference's attempt_fn."""
        codes, raw, final, sel = cuda.seq_attempt(self.program, arrays, state, weights, int(p))
        pf_codes = torch.zeros((0,), dtype=torch.int32, device=self.device)
        pf_ok = torch.ones((), dtype=torch.bool, device=self.device)
        return pf_codes, codes, raw, final, sel, pf_ok

    def bind_fn(self, arrays, state, p, sel, qi):
        """Bind pod p to node `sel` at queue position qi, updating `state`
        in place (the reference returns a new state); returns it."""
        return cuda.seq_bind(self.program, arrays, state, int(p), sel, int(qi))

    def attempt_bind_fn(self, arrays, state, weights, p, qi):
        """The single-pod step: attempt, then bind its selection (in
        place). Returns the attempt outputs and the state."""
        out = self.attempt_fn(arrays, state, weights, p)
        return (*out, self.bind_fn(arrays, state, p, out[4], qi))

    # -- execution ----------------------------------------------------------

    @staticmethod
    def queue_bucket(n: int) -> int:
        """The padded pass length for a pending queue of `n` pods: the
        geometric bucket above the live length, padded with no-op steps
        (pod index -1)."""
        from ..utils.compilecache import shape_bucket

        return shape_bucket(n, lo=8)

    def run(self, weights: "torch.Tensor | None" = None):
        """Execute the pass; returns (final_state, trace).

        The queue is padded to its geometric bucket with no-op steps (pod
        index -1), as the reference does — trace rows beyond the live
        queue are padding (`results()` decodes the live queue only)."""
        w = self.weights if weights is None else weights
        queue = np.asarray(self.enc.queue, np.int32)
        bucket = self.queue_bucket(len(queue))
        if bucket > len(queue):
            queue = np.concatenate(
                [queue, np.full(bucket - len(queue), -1, np.int32)]
            )
        state, out = self.run_fn(
            self.enc.arrays, self.enc.state0, torch.as_tensor(queue, device=self.device), w
        )
        self._final_state = state
        self._trace = out
        return state, out

    def placements(self) -> dict[tuple[str, str], str]:
        """pod (ns, name) → node name ("" = unschedulable)."""
        if self._final_state is None:
            self.run()
        return self.enc.decode_assignment(self._final_state.assignment)

    # -- trace → reference annotation records -------------------------------

    def _fill_attempt(self, res, codes_row, raw_row, final_row, sel_val):
        """Fill one Filter→Score attempt into a result record. Returns True
        when the attempt scheduled the pod."""
        enc = self.enc
        feasible = []
        for n in range(enc.n_nodes):
            ok = True
            for j, fname in enumerate(self._filter_names):
                c = int(codes_row[n, j])
                if c:
                    res.add_filter(
                        enc.node_names[n],
                        fname,
                        K.FILTER_KERNELS[fname][1](c, enc, n),
                    )
                    ok = False
                    break
                res.add_filter(enc.node_names[n], fname, PASSED_FILTER_MESSAGE)
            if ok:
                feasible.append(n)
        if not feasible:
            res.status = "Unschedulable"
            return False
        for pname in self._prescore_names:
            res.pre_score[pname] = SUCCESS_MESSAGE
        for j, (sname, _) in enumerate(self._score_specs):
            for n in feasible:
                res.add_score(enc.node_names[n], sname, int(raw_row[n, j]))
                res.add_final_score(enc.node_names[n], sname, int(final_row[n, j]))
        s = int(sel_val)
        res.selected_node = enc.node_names[s]
        res.status = "Scheduled"
        record_bind_points(enc.config, res)
        return True

    def results(
        self, pods: "set[tuple[str, str]] | None" = None
    ) -> list[PodSchedulingResult]:
        """Convert the dense trace into the reference's per-pod scheduling
        records (the oracle's output shape).

        `pods`: optional set of (namespace, name) keys — decode only those
        pods' records. A record is O(N x plugins) host objects, so at full
        width selective decode keeps the cost proportional to the pods
        asked about."""
        if not self.record:
            raise RuntimeError("engine built with record=False has no trace")
        if self._trace is None:
            self.run()
        enc = self.enc
        _, codes, raw, final, sel = (x.cpu().numpy() for x in self._trace)
        results = []
        for qi, p in enumerate(enc.queue):
            ns, name = enc.pod_keys[p]
            if pods is not None and (ns, name) not in pods:
                continue
            res = PodSchedulingResult(pod_namespace=ns, pod_name=name)
            for pname in self._prefilter_names:
                res.pre_filter_status[pname] = SUCCESS_MESSAGE
            self._fill_attempt(res, codes[qi], raw[qi], final[qi], sel[qi])
            results.append(res)
        return results


def schedule(
    nodes: list[dict],
    pods: list[dict],
    config: "SchedulerConfiguration | None" = None,
    *,
    policy: DTypePolicy = TPU32,
    device: "str | torch.device | None" = None,
    decode: "set[tuple[str, str]] | None" = None,
) -> tuple[dict, list[PodSchedulingResult]]:
    """One sequential scheduling pass over a cluster: encode, run, decode.

    Returns (placements, results): pod (ns, name) → node name ("" =
    unschedulable), and the per-pod scheduling records in queue order.
    `config` defaults to this slice's plugin set (`supported_config()`).
    `decode`: the (namespace, name) keys whose records to decode (None:
    every pending pod). Runs on the CUDA card unless `device` names another."""
    enc = encode_cluster(
        nodes, pods, config or supported_config(), policy=policy, device=device
    )
    eng = BatchedScheduler(enc, device=enc.device)
    eng.run()
    return eng.placements(), eng.results(pods=decode)
