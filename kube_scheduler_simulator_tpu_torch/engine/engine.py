"""The sequential scheduler: one pass over the pod queue.

Each step schedules one pod exactly as the upstream framework does
(PreFilter → Filter → PreScore → Score → Normalize → weight → select →
bind; reference call stack SURVEY.md §3.3), with every per-node,
per-plugin evaluation vectorized over the whole node axis. Scanning the
queue in PrioritySort order with a scatter-update of node state after each
pod gives the placements of the one-pod-at-a-time reference scheduler (pod
i sees pod i-1's binding).

When DefaultPreemption is enabled and a pod is unschedulable, the step
runs the dry run, evicts the nominated node's victims, retries the pod on
the state after eviction and records a second dry run (never evicting),
then binds the retry's selection (the reference's `lax.cond` branch).

On the card the whole pass is one launch of the `seq_run` kernel
(engine/cuda.py); on the CPU its plain PyTorch version runs. `results()`
converts the trace host-side into the reference's exact annotation wire
format (sched/results.py). This is the reference package's
`engine/engine.py` without PACKED or chunked runs; its `preempt_mode`
("cond" or "masked") selects no other code here (the reference pins the
two byte-identical). Sweeps over weight variants are `parallel/sweep.py`.
Its victim masks are recorded as CSR lists (engine/cuda.py
TRACE_SLOTS_PREEMPT), not as dense [N, P] masks.
"""

from __future__ import annotations

import dataclasses
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
from . import preempt as PR
from .cuda import TRACE_SLOTS_PLAIN, TRACE_SLOTS_PREEMPT  # noqa: F401  (the trace layouts)
from .encode import TPU32, DTypePolicy, EncodedCluster, encode_cluster, resolve_device


class UnsupportedPluginError(NotImplementedError):
    pass


def _restricted_config(names: "dict[str, set[str]]") -> "SchedulerConfiguration":
    """The default-plugin-order configuration with only the named plugins
    enabled at each extension point (disable "*", then enable), at default
    weights."""
    from ..sched.config import SchedulerConfiguration, default_plugins

    dp = default_plugins()
    plugins = {
        point: {
            "disabled": [{"name": "*"}],
            "enabled": [e for e in dp[point] if e["name"] in keep],
        }
        for point, keep in names.items()
    }
    return SchedulerConfiguration.from_dict(
        {"profiles": [{"schedulerName": "default-scheduler", "plugins": plugins}]}
    )


def supported_config() -> "SchedulerConfiguration":
    """The default-plugin-order configuration restricted to the extension
    points and plugins the port has kernels for, with default weights: the
    reference's whole default profile (15 filters, the VolumeBinding
    prefilter, DefaultPreemption, 7 scores) — the default path."""
    return _restricted_config({
        "preFilter": set(K.PREFILTER_KERNELS) | K.TRIVIAL_PREFILTER,
        "filter": set(K.FILTER_KERNELS),
        "postFilter": set(K.POSTFILTER_KERNELS),
        "preScore": set(K.PRESCORE_KERNELS) | K.TRIVIAL_PRESCORE,
        "score": set(K.SCORE_KERNELS),
    })


# The first slice's plugin set: resource fit, node name, unschedulable and
# taints, with the fit, balanced-allocation and taint scores.
FIT_PLUGINS = {
    "preFilter": {"NodeResourcesFit"},
    "filter": {"NodeUnschedulable", "NodeName", "TaintToleration", "NodeResourcesFit"},
    "postFilter": set(),
    "preScore": {
        "TaintToleration",
        "NodeAffinity",
        "NodeResourcesFit",
        "NodeResourcesBalancedAllocation",
    },
    "score": {"NodeResourcesFit", "NodeResourcesBalancedAllocation", "TaintToleration"},
}


def fit_config() -> "SchedulerConfiguration":
    """The first slice's configuration (FIT_PLUGINS in default order, at
    default weights): the fit path `chip_smoke.py` keeps measuring."""
    return _restricted_config(FIT_PLUGINS)


# The second slice's plugin set: the default profile without the volume
# family and DefaultPreemption (8 filters, 7 scores).
AFFINITY_PLUGINS = {
    "preFilter": {"NodeResourcesFit", "NodeAffinity", "NodePorts", "PodTopologySpread",
                  "InterPodAffinity"},
    "filter": {"NodeUnschedulable", "NodeName", "TaintToleration", "NodeResourcesFit",
               "NodeAffinity", "NodePorts", "PodTopologySpread", "InterPodAffinity"},
    "postFilter": set(),
    "preScore": {"InterPodAffinity", "PodTopologySpread", "TaintToleration", "NodeAffinity",
                 "NodeResourcesFit", "NodeResourcesBalancedAllocation"},
    "score": {"NodeResourcesFit", "NodeResourcesBalancedAllocation", "TaintToleration",
              "NodeAffinity", "ImageLocality", "PodTopologySpread", "InterPodAffinity"},
}


def affinity_config() -> "SchedulerConfiguration":
    """The second slice's configuration (AFFINITY_PLUGINS in default order,
    at default weights): the affinity path `chip_smoke.py` keeps
    measuring."""
    return _restricted_config(AFFINITY_PLUGINS)


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
        preempt_mode: str = "cond",
        device: "str | torch.device | None" = None,
    ):
        # preempt_mode: how the reference gates its PostFilter dry run per
        # step — "cond" (a branch) or "masked" (always run, outputs
        # select-gated; what it needs under vmap). The two give the same
        # placements and trace, and here both run the same kernel, whose
        # step branches.
        if preempt_mode not in ("cond", "masked"):
            raise ValueError(
                f"preempt_mode must be cond|masked, got {preempt_mode!r}"
            )
        self.preempt_mode = preempt_mode
        self.device = resolve_device(device)
        self.enc = enc = enc.to(self.device)
        self.record = record
        cfg = enc.config
        # All prefilter names emitted into the trace (oracle order); the
        # kernel-backed subset contributes codes, the trivial subset is
        # always "success".
        self._prefilter_names = [
            n
            for n in cfg.enabled("preFilter")
            if n in K.PREFILTER_KERNELS or n in K.TRIVIAL_PREFILTER
        ]
        self._prefilter_kernel_names = [
            n for n in self._prefilter_names if n in K.PREFILTER_KERNELS
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
        self.preempts = "DefaultPreemption" in cfg.enabled("postFilter")
        self.program = cuda.build_program(
            enc, self._filter_names, [n for n, _ in self._score_specs],
            self._prefilter_kernel_names, preempt=self.preempts,
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
    # seq.step programs, and the extender loop's preempt / evict) ---------

    def attempt_fn(self, arrays, state, weights, p):
        """One PreFilter→Filter→Score→Normalize→select pass for pod p:
        (pf_codes, codes, raw, final, sel, pf_ok) as the reference's
        attempt_fn."""
        codes, raw, final, sel, pf_codes = cuda.seq_attempt(
            self.program, arrays, state, weights, int(p))
        return pf_codes, codes, raw, final, sel, (pf_codes == 0).all()

    def bind_fn(self, arrays, state, p, sel, qi):
        """Bind pod p to node `sel` at queue position qi, updating `state`
        in place (the reference returns a new state); returns it."""
        return cuda.seq_bind(self.program, arrays, state, int(p), sel, int(qi))

    def attempt_bind_fn(self, arrays, state, weights, p, qi):
        """The single-pod step: attempt, then bind its selection (in
        place). Returns the attempt outputs and the state."""
        out = self.attempt_fn(arrays, state, weights, p)
        return (*out, self.bind_fn(arrays, state, p, out[4], qi))

    def preempt_fn(self, arrays, state, p):
        """The DefaultPreemption dry run for pod p at `state`: (pcode [N],
        victim offsets [N+1], victim pod indices, nominated) — the
        reference's preempt closure, victims as a CSR record."""
        return cuda.seq_preempt(self.program, arrays, state, int(p))

    def evict_fn(self, arrays, state, mask):
        """Remove the pods of `mask` ([P] bool) from their nodes, in place
        (the reference's evict_all); returns the state."""
        return cuda.seq_evict(self.program, arrays, state, mask)

    # -- engine reuse (the serving layer's engine cache) ---------------------

    @staticmethod
    def queue_bucket(n: int) -> int:
        """The padded pass length for a pending queue of `n` pods: the
        geometric bucket above the live length, padded with no-op steps
        (pod index -1)."""
        from ..utils.compilecache import shape_bucket

        return shape_bucket(n, lo=8)

    @staticmethod
    def compile_signature(
        enc: EncodedCluster, record: bool = True, include_queue_len: bool = True
    ) -> tuple:
        """Everything an engine's program takes from its encoding beyond the
        tensors it is handed: the configuration, the dtype policy, the
        resource vocabulary's order, the node-pair count (`np1`), the
        preemption victim bound (from node capacities and the initial
        assignment), the queue's bucket (left out with
        `include_queue_len=False`: the gang engine takes the queue as a
        fixed-[P] order), and every tensor's shape and dtype. Two encodings
        with equal signatures can share one engine through `retarget`. The
        reference's signature, component for component (with no custom
        plugin statics).

        Memoised on the encoding: the delta encoder updates tensors in
        place, so recomputing it on an older encoding would read the newer
        content."""
        memo = getattr(enc, "_sig_memo", None)
        if memo is None:
            memo = enc._sig_memo = {}
        key = (record, include_queue_len)
        if key in memo:
            return memo[key]
        shapes = tuple(
            (tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for obj in (enc.arrays, enc.arrays.rel, enc.state0)
            for f in dataclasses.fields(obj)
            if isinstance(t := getattr(obj, f.name), torch.Tensor)
        )
        filter_names = [n for n in enc.config.enabled("filter") if n in K.FILTER_KERNELS]
        has_preempt = "DefaultPreemption" in enc.config.enabled("postFilter")
        sig = (
            enc.config.fingerprint(),
            enc.policy.name,
            tuple(enc.resource_names),
            enc.aux.get("n_node_pairs"),
            PR.victim_bound(enc, filter_names) if has_preempt else 0,
            BatchedScheduler.queue_bucket(len(enc.queue)) if include_queue_len else None,
            record,
            shapes,
        )
        memo[key] = sig
        return sig

    def retarget(self, enc: EncodedCluster) -> "BatchedScheduler":
        """Point this engine at a new encoding with an equal compile
        signature (same shapes and program content, other tensor contents):
        the program is kept, the decode tables come from the new encoding.
        Raises ValueError for an encoding that is not compatible."""
        if self.compile_signature(enc, self.record) != self.compile_signature(
            self.enc, self.record
        ):
            raise ValueError("encoding is not compile-compatible; rebuild")
        self.enc = enc.to(self.device)
        self._trace = None
        self._final_state = None
        return self

    # -- execution ----------------------------------------------------------

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
        names, node_names = self._filter_names, enc.node_names
        F = len(names)
        if F:
            # each node's filters pass up to its first failing one, which
            # records its reason and ends the node's row
            fail = np.asarray(codes_row[: enc.n_nodes]) != 0
            first = np.where(fail.any(axis=1), fail.argmax(axis=1), F).tolist()
            passed = [(n, PASSED_FILTER_MESSAGE) for n in names]
            for n, f in enumerate(first):
                row = dict(passed[:f])
                if f < F:
                    row[names[f]] = K.FILTER_KERNELS[names[f]][1](int(codes_row[n, f]), enc, n)
                res.filter[node_names[n]] = row
            feasible = [n for n, f in enumerate(first) if f == F]
        else:
            feasible = list(range(enc.n_nodes))
        if not feasible:
            res.status = "Unschedulable"
            return False
        for pname in self._prescore_names:
            res.pre_score[pname] = SUCCESS_MESSAGE
        if self._score_specs:
            snames = [s for s, _ in self._score_specs]
            S = len(snames)
            raw_l = np.asarray(raw_row)[feasible, :S].tolist()
            final_l = np.asarray(final_row)[feasible, :S].tolist()
            for n, r, f in zip(feasible, raw_l, final_l):
                res.score[node_names[n]] = dict(zip(snames, map(str, r)))
                res.final_score[node_names[n]] = dict(zip(snames, map(str, f)))
        s = int(sel_val)
        res.selected_node = enc.node_names[s]
        res.status = "Scheduled"
        record_bind_points(enc.config, res)
        return True

    def _ordered_victims(self, off, vidx, seq) -> "dict[int, list[int]]":
        """Per node, the victim pod indices of one dry run's CSR record
        (offsets `off` [N+1] into `vidx`) in the order the records promise:
        priority descending, bind order `seq` ascending."""
        prio = self._priority
        out = {}
        for n in range(self.enc.n_nodes):
            vs = [int(v) for v in vidx[off[n]:off[n + 1]]]
            vs.sort(key=lambda v: (-int(prio[v]), int(seq[v])))
            out[n] = vs
        return out

    def _fill_postfilter(self, res, pcode_row, off, vidx, seq):
        """Attach DefaultPreemption's per-node messages. Returns the victim
        names by node."""
        enc = self.enc
        victims = self._ordered_victims(off, vidx, seq)
        victims_by_node = {}
        for n in range(enc.n_nodes):
            code = int(pcode_row[n])
            names = [f"{enc.pod_keys[v][0]}/{enc.pod_keys[v][1]}" for v in victims[n]]
            victims_by_node[n] = names
            if code == PR.PREEMPT_SILENT:
                continue
            res.post_filter.setdefault(enc.node_names[n], {})[
                "DefaultPreemption"
            ] = PR.decode_preemption(code, enc, n, names)
        return victims_by_node

    def results(
        self, pods: "set[tuple[str, str]] | None" = None
    ) -> list[PodSchedulingResult]:
        """Convert the trace into the reference's per-pod scheduling records
        (the oracle's output shape).

        `pods`: optional set of (namespace, name) keys — decode only those
        pods' records. A record is O(N x plugins) host objects, so at full
        width selective decode keeps the cost proportional to the pods
        asked about."""
        if not self.record:
            raise RuntimeError("engine built with record=False has no trace")
        if self._trace is None:
            self.run()
        enc = self.enc
        if self.preempts:
            # the retry rows are read only where the dry run fired: copy those
            tr = self._trace
            n_retry = cuda.TRACE_SLOTS_PREEMPT.index("codes2")
            did_t = tr[cuda.TRACE_SLOTS_PREEMPT.index("did")]
            vals = [x.cpu().numpy() for x in tr[:n_retry]]
            retry = [x[did_t].cpu().numpy() for x in tr[n_retry:n_retry + 3]]
            (pf_codes, codes, raw, final, sel, did, pcode, nominated, sel2, pcode2,
             nominated2, final_sel) = vals
            codes2, raw2, final2 = retry
            voff, vidx = (x.cpu().numpy() for x in tr[n_retry + 3:])
            fired = np.cumsum(did) - 1  # the step's row in the retry rows
            self._priority = enc.arrays.pod_priority.cpu().numpy()
        else:
            pf_codes, codes, raw, final, sel = (x.cpu().numpy() for x in self._trace)
            final_sel = sel
        results = []

        def evicted(qi):
            """The victims the step qi's dry run evicted (on its nominated
            node), or none."""
            if not self.preempts or not did[qi] or int(nominated[qi]) < 0:
                return np.zeros(0, np.int64)
            off, nom = voff[qi, 0], int(nominated[qi])
            return vidx[off[nom]:off[nom + 1]]

        # bind chronology for victim ordering (mirrors state.bound_seq)
        seq = enc.state0.bound_seq.cpu().numpy().copy()
        for qi, p in enumerate(enc.queue):
            ns, name = enc.pod_keys[p]
            if pods is not None and (ns, name) not in pods:
                # the chronology must still advance so later decoded pods
                # order their victim lists correctly
                if int(final_sel[qi]) >= 0:
                    seq[p] = enc.P + qi
                seq[evicted(qi)] = -1
                continue
            res = PodSchedulingResult(pod_namespace=ns, pod_name=name)
            pf_failed = False
            for pname in self._prefilter_names:
                c = 0
                if pname in K.PREFILTER_KERNELS:
                    c = int(pf_codes[qi, self._prefilter_kernel_names.index(pname)])
                res.pre_filter_status[pname] = (
                    K.PREFILTER_KERNELS[pname][1](c, enc) if c else SUCCESS_MESSAGE)
                pf_failed = pf_failed or c != 0
            if pf_failed:
                res.status = "Unschedulable"
                results.append(res)
                continue
            self._fill_attempt(res, codes[qi], raw[qi], final[qi], sel[qi])
            if self.preempts and did[qi]:
                f = fired[qi]
                victims_by_node = self._fill_postfilter(res, pcode[qi], voff[qi, 0], vidx, seq)
                nom = int(nominated[qi])
                if nom >= 0:
                    res.status = "Nominated"
                    res.nominated_node = enc.node_names[nom]
                    res.preemption_victims = victims_by_node[nom]
                    results.append(res)
                    # the retry (the pod re-queued at the head; a second
                    # failure is terminally Unschedulable)
                    res2 = PodSchedulingResult(pod_namespace=ns, pod_name=name)
                    res2.pre_filter_status = dict(res.pre_filter_status)
                    if not self._fill_attempt(res2, codes2[f], raw2[f], final2[f], sel2[qi]):
                        self._fill_postfilter(res2, pcode2[qi], voff[qi, 1], vidx, seq)
                        nom2 = int(nominated2[qi])
                        if nom2 >= 0:
                            res2.nominated_node = enc.node_names[nom2]
                        res2.status = "Unschedulable"
                    results.append(res2)
                else:
                    res.status = "Unschedulable"
                    results.append(res)
            else:
                results.append(res)
            if int(final_sel[qi]) >= 0:
                seq[p] = enc.P + qi
            seq[evicted(qi)] = -1
        return results


def schedule(
    nodes: list[dict],
    pods: list[dict],
    config: "SchedulerConfiguration | None" = None,
    *,
    policy: DTypePolicy = TPU32,
    device: "str | torch.device | None" = None,
    decode: "set[tuple[str, str]] | None" = None,
    **objects,
) -> tuple[dict, list[PodSchedulingResult]]:
    """One sequential scheduling pass over a cluster: encode, run, decode.

    Returns (placements, results): pod (ns, name) → node name ("" =
    unschedulable), and the per-pod scheduling records in queue order.
    `config` defaults to the reference's default profile
    (`supported_config()`). `decode`: the (namespace, name) keys whose
    records to decode (None: every pending pod). `objects`: the other
    kinds `encode_cluster` takes (priorityclasses, namespaces, pvcs, pvs,
    storageclasses). Runs on the CUDA card unless `device` names another."""
    enc = encode_cluster(
        nodes, pods, config or supported_config(), policy=policy, device=device, **objects
    )
    eng = BatchedScheduler(enc, device=enc.device)
    eng.run()
    return eng.placements(), eng.results(pods=decode)
