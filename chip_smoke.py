#!/usr/bin/env python3
"""Drive the PyTorch port's sequential scheduling pass on one NVIDIA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Two paths run through the same three kernels: the fit path (the first
slice's plugin set, `fit_config()`) and the affinity path (the default
profile without volumes and preemption, `slice_config()`, on BASELINE
config #3's workload). Phases, in order; any failure raises and the process
exits non-zero:

1. the device: its name, `nvidia-smi`'s name and power limit, the torch
   and CUDA versions;
2. build: the CUDA kernels (csrc/seq_kernels.cu) compiled for sm_90a into
   build/kernels/, with the compiler's register and spill report;
3. each kernel against its plain PyTorch version on the card, under TPU32
   and EXACT, exact equality: (fit) three fit-path configurations on a
   256-node x 2,000-pod cluster dressed with taints, tolerations, cordoned
   nodes, nodeName pods and pods too large for any node; (affinity)
   `slice_config()` on `synth.dressed_affinity_cluster(256, 2000)` (every
   feature the affinity plugins read; the port's tests use the same
   generator). Each: `seq_attempt` at 64 pods x random states (random
   bindings and port counters for the affinity path), `seq_bind` on those
   pods, `seq_run` over the whole queue (trace, final state, placements);
4. the fit path at full width: `schedule()` on 1,024 nodes x 10,000 pods
   (TPU32, trace recorded) with the launch counters set to 0 just before
   and read just after — the pass must launch `seq_run` and no plain
   version; its placements, trace and 100 sampled pods' annotations must
   equal the plain version's run on the card. Then the single-pod step
   path (`attempt_bind_fn`, launching `seq_attempt` and `seq_bind`) is
   driven over the same queue with the counters reset again, and each step
   must reproduce the pass's trace row;
4b. the affinity path at full width, the same way: BASELINE config #3,
   `synthetic_affinity_cluster(500, 5000, seed=11)`;
5. kernel times on both paths (CUDA events; the per-pod kernels replayed
   from a CUDA graph so host enqueue time is not counted, at the state
   half-way through the queue), the plain versions' times and each
   kernel's bound (`attempt_bound`: the bytes that attempt reads and
   writes), printed as one JSON line with a `path` field per entry; 5b:
   each plugin body the second slice added, alone inside `seq_attempt`;
6. the card's name and power limit, then the result line.

It imports nothing of JAX or of the reference package.
"""

from __future__ import annotations

import faulthandler
import functools
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# the whole run, build included, stays inside 1,200 s
TIME_LIMIT_S = 1100
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
SCALAR_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores
SOURCE = "kube_scheduler_simulator_tpu_torch/csrc/seq_kernels.cu"
REPLACES = {
    "seq_attempt": "kube_scheduler_simulator_tpu/engine/engine.py:404",
    "seq_bind": "kube_scheduler_simulator_tpu/engine/engine.py:466",
    "seq_run": "kube_scheduler_simulator_tpu/engine/engine.py:657",
}


def log(*args):
    print(*args, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_report(text):
    """One line per kernel from nvcc's -Xptxas -v output: registers, stack,
    spills."""
    import re

    out, name, props = [], None, ""
    for ln in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?_Z\w*?"
                      r"(seq_(?:attempt|bind|run)_kernel)I([ix])", ln)
        if m:
            name = f"{m.group(1)}<{'int32' if m.group(2) == 'i' else 'int64'}>"
        elif "spill" in ln:
            props = ln.strip()
        elif "registers" in ln and name:
            out.append(f"{name}: {ln.split(':', 1)[1].strip()}; {props}")
            name, props = None, ""
    # a report whose names this parser does not know is shown as it is
    return out or [ln.strip() for ln in text.splitlines() if "registers" in ln or "spill" in ln]


def dressed_cluster(kp, n_nodes, n_pods, seed):
    """The port's synthetic cluster with every code path of the slice in
    it: NoSchedule taints on every 7th node, PreferNoSchedule on every 11th,
    NoExecute on every 13th, cordoned nodes, ephemeral storage, tolerations
    on every 5th pod, pods pinned to an existing node (pre-bound) or to a
    missing one, and pods too large for any node."""
    nodes, pods = kp.synthetic_cluster(n_nodes, n_pods, seed=seed, priorities=True)
    for i, nd in enumerate(nodes):
        taints = []
        if i % 7 == 0:
            taints.append({"key": "dedicated", "value": "gpu", "effect": "NoSchedule"})
        if i % 11 == 0:
            taints.append({"key": "spot", "value": "true", "effect": "PreferNoSchedule"})
        if i % 13 == 4:
            taints.append({"key": "maint", "effect": "NoExecute"})
        nd["spec"] = {"taints": taints} if taints else {}
        if i % 17 == 6:
            nd["spec"]["unschedulable"] = True
        if i % 3 == 1:
            nd["status"]["allocatable"]["ephemeral-storage"] = f"{20 + i % 50}Gi"
    for j, pd in enumerate(pods):
        spec = pd["spec"]
        req = spec["containers"][0]["resources"]["requests"]
        if j % 5 == 0:
            spec["tolerations"] = [
                {"key": "dedicated", "operator": "Equal", "value": "gpu", "effect": "NoSchedule"},
                {"key": "spot", "operator": "Exists"},
            ]
        if j % 35 == 7:
            spec["tolerations"] = [{"operator": "Exists"}]
        if j % 37 == 3:
            spec["nodeName"] = nodes[(j * 7) % len(nodes)]["metadata"]["name"]
        if j % 41 == 5:
            spec["nodeName"] = "missing-node"
        if j % 97 == 11:
            req.update({"cpu": "200", "memory": "2Ti"})
        if j % 6 == 1:
            req["ephemeral-storage"] = f"{1 + j % 9}Gi"
    return nodes, pods


def configs(kp):
    """The fit path's configuration, and two that reach the other
    NodeResourcesFit strategies and BalancedAllocation's 3-resource branch
    (the float32 branch under TPU32)."""
    from kube_scheduler_simulator_tpu_torch.sched.config import SchedulerConfiguration

    plugins = kp.fit_config().to_dict()["profiles"][0]["plugins"]
    three = [{"name": r, "weight": 1} for r in ("cpu", "memory", "ephemeral-storage")]

    def with_args(fit_strategy):
        return SchedulerConfiguration.from_dict({"profiles": [{
            "schedulerName": "default-scheduler",
            "plugins": plugins,
            "pluginConfig": [
                {"name": "NodeResourcesFit", "args": {"scoringStrategy": fit_strategy}},
                {"name": "NodeResourcesBalancedAllocation", "args": {"resources": three}},
            ],
        }]})

    return {
        "fit": kp.fit_config(),
        "most-3": with_args({"type": "MostAllocated", "resources": [
            {"name": "cpu", "weight": 2}, {"name": "memory", "weight": 1},
            {"name": "example.com/absent", "weight": 1}]}),
        "rtcr-3": with_args({"type": "RequestedToCapacityRatio", "resources": three,
                             "requestedToCapacityRatio": {"shape": [
                                 {"utilization": 0, "score": 10},
                                 {"utilization": 40, "score": 6},
                                 {"utilization": 100, "score": 1}]}}),
    }


STATE_FIELDS = ("requested", "s_requested", "n_pods", "assignment", "used_pair",
                "used_wild", "used_trip", "bound_seq")


class Diff:
    """Exact comparison of kernel and plain outputs; keeps the largest
    absolute difference seen per (path, kernel)."""

    def __init__(self):
        self.err = {}

    def check(self, path, kernel, what, got, want):
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(f"{path} {kernel} {what}: {got.dtype}{tuple(got.shape)} "
                                 f"vs plain {want.dtype}{tuple(want.shape)}")
        err = float((got.double() - want.double()).abs().max()) if got.numel() else 0.0
        self.err[path, kernel] = max(self.err.get((path, kernel), 0.0), err)
        if not torch.equal(got, want):
            raise AssertionError(
                f"{path} {kernel} {what}: kernel differs from plain (max |d| {err})")


def random_state(enc, rng, bind):
    """A node state with usage up to 130% of capacity and pod counts about
    the 110-pod limit (what the pass reaches only partly). `bind`: port
    counters of 0..2 users, and about half of the pending pods bound,
    mostly to the first third of the nodes (skewed topology counts)."""
    from kube_scheduler_simulator_tpu_torch.engine.encode import SchedState

    alloc = enc.arrays.node_alloc.cpu().numpy()
    dt, dev = alloc.dtype, enc.device
    req = np.floor(alloc * rng.uniform(0.0, 1.3, alloc.shape)).astype(dt)
    sreq = np.floor(alloc * rng.uniform(0.0, 1.3, alloc.shape)).astype(dt)
    n_pods = rng.integers(0, 112, alloc.shape[0]).astype(np.int32)
    st = enc.state0.clone()
    st.requested = torch.as_tensor(req, device=dev)
    st.s_requested = torch.as_tensor(sreq, device=dev)
    st.n_pods = torch.as_tensor(n_pods, device=dev)
    if bind:
        for f in ("used_pair", "used_wild", "used_trip"):
            setattr(st, f, torch.as_tensor(rng.integers(0, 3, tuple(getattr(st, f).shape)),
                                           dtype=torch.int32, device=dev))
        assignment = enc.state0.assignment.cpu().numpy().copy()
        free = (assignment < 0) & (rng.random(assignment.shape) < 0.5)
        free[enc.n_pods:] = False
        hi = np.where(rng.random(int(free.sum())) < 0.8, max(1, enc.n_nodes // 3), enc.n_nodes)
        assignment[free] = rng.integers(0, hi)
        st.assignment = torch.as_tensor(assignment, device=dev)
    return st


def compare_kernels(kp, cuda, diff, path, nodes, pods, cfgs, bind, namespaces=None):
    """Phase 3: every kernel against its plain version, exact, for each
    configuration in `cfgs` under TPU32 and EXACT."""
    for pol in (kp.TPU32, kp.EXACT):
        for cname, cfg in cfgs.items():
            enc = kp.encode_cluster(nodes, pods, cfg, policy=pol, namespaces=namespaces)
            eng = kp.BatchedScheduler(enc)
            prog, a, w = eng.program, enc.arrays, eng.weights
            rng = np.random.default_rng(3)
            for k in range(4):
                st = random_state(enc, rng, bind)
                for qi, p in enumerate(rng.choice(enc.n_pods, 16, replace=False).tolist()):
                    got = cuda.seq_attempt(prog, a, st, w, p)
                    want = cuda.seq_attempt_plain(prog, a, st, w, p)
                    for name, g, h in zip(("codes", "raw", "final", "sel"), got, want):
                        diff.check(path, "seq_attempt", f"{pol.name}/{cname} pod {p} {name}",
                                   g, h)
                    # bind the selection, an unschedulable pick, and a padding step
                    for pp, sel in ((p, got[3]), (p, torch.full_like(got[3], -1)),
                                    (-1, got[3])):
                        s1 = cuda.seq_bind(prog, a, st.clone(), pp, sel, qi + 16 * k)
                        s2 = cuda.seq_bind_plain(prog, a, st.clone(), pp, sel, qi + 16 * k)
                        for f in STATE_FIELDS:
                            diff.check(path, "seq_bind", f"{pol.name}/{cname} pod {pp} {f}",
                                       getattr(s1, f), getattr(s2, f))
            queue = padded_queue(eng)
            s_k, t_k = cuda.seq_run(prog, a, enc.state0, queue, w, record=True)
            s_p, t_p = cuda.seq_run_plain(prog, a, enc.state0, queue, w, record=True)
            for name, g, h in zip(("pf_codes", "codes", "raw", "final", "sel"), t_k, t_p):
                diff.check(path, "seq_run", f"{pol.name}/{cname} {name}", g, h)
            for f in STATE_FIELDS:
                diff.check(path, "seq_run", f"{pol.name}/{cname} state {f}",
                           getattr(s_k, f), getattr(s_p, f))
            s_n, sel_n = cuda.seq_run(prog, a, enc.state0, queue, w, record=False)
            diff.check(path, "seq_run", f"{pol.name}/{cname} unrecorded sel", sel_n, t_p[4])
            diff.check(path, "seq_run", f"{pol.name}/{cname} unrecorded assignment",
                       s_n.assignment, s_p.assignment)
            placed = int((s_k.assignment >= 0).sum()) - int((enc.state0.assignment >= 0).sum())
            codes = t_k[1][: len(enc.queue)]
            seen = [sorted(set(codes[:, :, f].unique().tolist())) for f in range(codes.shape[2])]
            log(f"  {path:8s} {pol.name:5s} {cname:7s}: 64 attempts, 192 binds and a "
                f"{len(queue)}-step pass equal to plain ({placed} of "
                f"{len(enc.queue)} pending pods placed; filter codes seen {seen})")


def padded_queue(eng):
    """The engine's queue padded to its bucket with -1, on its device."""
    q = eng.enc.queue
    return torch.as_tensor(np.concatenate([q, np.full(eng.queue_bucket(len(q)) - len(q), -1)])
                           .astype(np.int32), device=eng.device)


def events_ms(fn, iters, reps=5):
    """Median over `reps` of the mean time of `iters` calls of fn, from
    CUDA events."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(iters):
            fn()
        e1.record()
        torch.cuda.synchronize()
        out.append(e0.elapsed_time(e1) / iters)
    return statistics.median(out)


def graph_ms(fn, iters=100, reps=5):
    """Median device time of one call of fn, from a CUDA graph of `iters`
    calls replayed between events: the host's enqueue time is not in it."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    return events_ms(g.replay, 1, reps) / iters


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def ops_per_node(enc, prog):
    """A rough count of the integer operations one attempt does per node,
    read off the kernel's code for this configuration (each compare, add,
    multiply or divide counts one)."""
    from kube_scheduler_simulator_tpu_torch.engine import kernels as K

    a, rel = enc.arrays, enc.arrays.rel
    T, L, R = a.taint_key.shape[1], a.tol_key.shape[1], enc.R
    K_, HC, SC = a.label_val.shape[1], rel.sph_key.shape[1], rel.sps_key.shape[1]
    taint = T * (3 + 8 * L)
    _, TM, E, VV = a.raff_vals.shape
    affinity = 3 * a.nsel_key.shape[1] + TM * E * (VV + 6)
    per_filter = {"NodeUnschedulable": 3, "NodeName": 3, "TaintToleration": taint,
                  "NodeResourcesFit": 4 + 6 * R, "NodeAffinity": 2,
                  "NodePorts": 2 * a.want_wild.shape[1] + 4 * a.want_trip.shape[1],
                  "PodTopologySpread": 8 * HC,
                  "InterPodAffinity": 3 * K_ + 4 * rel.ian_key.shape[1] + 6 * rel.ia_key.shape[1]}
    per_score = {"NodeResourcesFit": 12 * len(K.fit_score_args(enc)[1]) + 4,
                 "NodeResourcesBalancedAllocation": 45 * len(K.balanced_resources(enc)) + 20,
                 "TaintToleration": taint,
                 "NodeAffinity": a.paff_vals.shape[1] * E * (VV + 6),
                 "ImageLocality": 3 * a.pod_img.shape[1] + 20,
                 "PodTopologySpread": 14 * SC + 10, "InterPodAffinity": 3 * K_}
    normalize_select = 10 * len(prog.score_names) + 8
    # the relational node phases: NodeAffinity per node, pair aggregation,
    # the spread score's prologue
    rel_node = 0
    if {"NodeAffinity", "PodTopologySpread"} & set(prog.filter_names + prog.score_names):
        rel_node = affinity + 6 * (HC + SC)
    return (sum(per_filter[n] for n in prog.filter_names)
            + sum(per_score[n] for n in prog.score_names) + normalize_select + rel_node)


def bound(bytes_moved, ops):
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / SCALAR_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def cluster_bytes(enc):
    """Every plane the kernels read, each once."""
    import dataclasses

    a = enc.arrays
    return (nbytes(*(getattr(a, f.name) for f in dataclasses.fields(a) if f.name != "rel"))
            + nbytes(*(getattr(a.rel, f.name) for f in dataclasses.fields(a.rel))))


# planes and state indexed by node (or by neither axis), read whole; of the
# others, indexed by pod, an attempt reads the step pod's row
NODE_PLANES = {"node_alloc", "node_unsched", "node_mask", "taint_key", "taint_val",
               "taint_effect", "label_val", "label_num", "label_num_ok", "trip_pair",
               "img_contrib", "node_pair", "spread_lut", "requested", "s_requested",
               "n_pods", "used_pair", "used_wild", "used_trip"}
LABELS = ("label_val", "label_num", "label_num_ok")
NODE_AFFINITY = ("nsel_key", "nsel_val", "pod_has_raff", "raff_key", "raff_op", "raff_vals",
                 "raff_num", "raff_num_ok", "raff_term_valid")
TAINTS = ("taint_key", "taint_val", "taint_effect", "tol_key", "tol_val", "tol_effect",
          "tol_op")
FLAG = {"sph": "sph_self", "sps": "sps_host", "ia": "ia_self"}


def domain(d):
    """The planes of relational term domain d."""
    return tuple(f"{d}_{m}" for m in ("key", "ctype", "ckey", "cpairs", "skew", "nsall", "ns",
                                      "weight")) + ((FLAG[d],) if d in FLAG else ())


# What each plugin reads in the kernel (csrc/seq_kernels.cu filter_code,
# score_raw and the node phases), besides the other pods' relational rows
# that `rel_reads` counts. The spread plugins run the NodeAffinity body.
READS = {
    ("filter", "NodeUnschedulable"): ("node_unsched", "pod_tol_unsched"),
    ("filter", "NodeName"): ("pod_node_name",),
    ("filter", "TaintToleration"): TAINTS,
    ("filter", "NodeResourcesFit"): ("node_alloc", "requested", "n_pods", "pod_req",
                                     "pod_req_rank"),
    ("filter", "NodeAffinity"): LABELS + NODE_AFFINITY,
    ("filter", "NodePorts"): ("used_pair", "used_wild", "used_trip", "trip_pair", "want_wild",
                              "want_trip"),
    ("filter", "PodTopologySpread"): LABELS + NODE_AFFINITY + ("node_pair", "ns_id")
    + domain("sph"),
    ("filter", "InterPodAffinity"): ("node_pair", "ns_id") + domain("ia") + domain("ian"),
    ("score", "NodeResourcesFit"): ("node_alloc", "s_requested", "pod_sreq"),
    ("score", "NodeResourcesBalancedAllocation"): ("node_alloc", "s_requested", "pod_sreq"),
    ("score", "TaintToleration"): TAINTS,
    ("score", "NodeAffinity"): LABELS + ("paff_key", "paff_op", "paff_vals", "paff_num",
                                         "paff_num_ok", "paff_weight", "paff_term_valid"),
    ("score", "ImageLocality"): ("img_contrib", "pod_img", "pod_ncont"),
    ("score", "PodTopologySpread"): LABELS + NODE_AFFINITY
    + ("node_pair", "ns_id", "req_all", "spread_lut") + domain("sps"),
    ("score", "InterPodAffinity"): ("node_pair", "ns_id") + domain("ipa") + domain("ipan")
    + domain("ia"),
}


def relational(enc, prog):
    """Which relational phases the kernel runs for this program (its
    `need_of`): spread filter, spread score, inter-pod filter and score,
    and hardPodAffinityWeight."""
    from kube_scheduler_simulator_tpu_torch.engine import kernels as K

    prescore = enc.config.enabled("preScore")
    return ("PodTopologySpread" in prog.filter_names,
            "PodTopologySpread" in prog.score_names and "PodTopologySpread" in prescore,
            "InterPodAffinity" in prog.filter_names,
            "InterPodAffinity" in prog.score_names and "InterPodAffinity" in prescore,
            K.interpod_hard_weight(enc))


def term_ops(C, VP):
    return C * (VP + 3) + 6


def rel_reads(enc, prog, st, p):
    """(bytes, operations) of one attempt's walk over the other pods for
    step pod p at state st, as the kernel's `rel_pod` reads them: every
    pod's assignment; for each bound pod its mask, namespace and (spread)
    deletion flag; the key row of each of its terms the reverse directions
    test and, for a term whose topology pair is on the pod's node and whose
    namespace matches, that term's namespace and clause rows; and one 32-byte
    sector for each distinct sector of the pod-label bitsets a clause
    gathers (the other pod's row in the forward directions, p's in the
    reverse). A term's clauses are counted whole where the kernel stops at
    the first that fails."""
    f_spread, s_spread, f_ipa, s_ipa, hard_w = relational(enc, prog)
    if not (f_spread or s_spread or f_ipa or s_ipa):
        return 0, 0
    import dataclasses

    rel = {f.name: getattr(enc.arrays.rel, f.name).cpu().numpy()
           for f in dataclasses.fields(enc.arrays.rel)}
    asg = st.assignment.cpu().numpy()
    live = (asg >= 0) & enc.arrays.pod_mask.cpu().numpy()
    P, LP = rel["pair_present"].shape
    KK = rel["key_present"].shape[1]
    byts, ops = 4 * P + int((asg >= 0).sum()), 2 * P
    qs = np.nonzero(live)[0]
    npq = rel["node_pair"][asg[qs]]  # [Q, K] the bound pods' nodes' pair ids
    ns_q, ns_p = rel["ns_id"][qs], int(rel["ns_id"][p])
    byts += 4 * len(qs)
    ops += 4 * len(qs)
    gathers = {"pair_present": [], "key_present": []}  # flat element indices

    def cols(d, owners, t):
        """Per owner, the pair ids and key ids term t's clauses gather."""
        ct = rel[f"{d}_ctype"][owners, t]  # [O, C]
        cp = np.where(((ct == 0) | (ct == 1))[..., None], rel[f"{d}_cpairs"][owners, t], -1)
        ck = np.where((ct == 2) | (ct == 3), rel[f"{d}_ckey"][owners, t], -1)
        return cp.reshape(len(owners), cp.shape[1] * cp.shape[2]), ck

    def gather(rows, pids, kids, width_p=LP, width_k=KK):
        for plane, ids, width in (("pair_present", pids, width_p), ("key_present", kids, width_k)):
            flat = (rows[:, None].astype(np.int64) * width + ids)[ids >= 0]
            gathers[plane].append(flat)

    def forward(d, extra):
        nonlocal ops
        _, T, C, VP = rel[f"{d}_cpairs"].shape
        for t in range(T):
            key = int(rel[f"{d}_key"][p, t])
            if key < 0:
                continue
            sel = extra(d, t, key)
            pids, kids = cols(d, np.array([p]), t)
            tq = qs[sel]
            gather(tq, np.repeat(pids, len(tq), 0), np.repeat(kids, len(tq), 0))
            ops += int(sel.sum()) * term_ops(C, VP)

    def spread_ok(d, t, key):
        return (ns_q == ns_p) & ~rel["deleted"][qs]

    def ipa_ok(d, t, key):
        ns_ok = rel[f"{d}_nsall"][p, t] | rel[f"{d}_ns"][p, t][ns_q]
        return (npq[:, key] > 0) & ns_ok

    if f_spread or s_spread:
        byts += int((ns_q == ns_p).sum())  # deleted
        for d, on in (("sph", f_spread), ("sps", s_spread)):
            if on:
                forward(d, spread_ok)
    fwd = (("ian", "ia") if f_ipa else ()) + (("ipa", "ipan") if s_ipa else ())
    for d in fwd:
        forward(d, ipa_ok)
    rev = (("ian",) if f_ipa else ()) + ((("ipa", "ipan", "ia") if hard_w > 0
                                          else ("ipa", "ipan")) if s_ipa else ())
    for d in rev:
        _, T, C, VP = rel[f"{d}_cpairs"].shape
        row = 4 * C * (2 + VP) + (4 if f"{d}_weight" in rel else 0)
        for t in range(T):
            keys = rel[f"{d}_key"][qs, t]
            on = (keys >= 0) & (npq[np.arange(len(qs)), np.maximum(keys, 0)] > 0)
            nsall = rel[f"{d}_nsall"][qs, t]
            ok = on & (nsall | rel[f"{d}_ns"][qs, t, ns_p])
            byts += 4 * len(qs) + int(on.sum()) + int((on & ~nsall).sum()) + row * int(ok.sum())
            ops += 3 * len(qs) + term_ops(C, VP) * int(ok.sum())
            pids, kids = cols(d, qs[ok], t)
            gather(np.full(len(pids), p), pids, kids)
    for plane, parts in gathers.items():
        if parts:
            byts += 32 * np.unique(np.concatenate(parts) // 32).size
    return byts, ops


def attempt_bound(enc, prog, st, p, weights):
    """The least time of one attempt of pod p at state st: the node planes
    its plugins read, whole, the pod's own rows, the other pods' relational
    reads (`rel_reads`), the weights and one trace row written, against
    the rough operation count."""
    planes = {"node_mask"}
    for n in prog.filter_names:
        planes.update(READS["filter", n])
    for n in prog.score_names:
        planes.update(READS["score", n])
    a, P = enc.arrays, enc.P
    byts = 0
    for name in planes:
        t = next((getattr(o, name) for o in (a, a.rel, st) if hasattr(o, name)), None)
        if t is not None:
            byts += nbytes(t) if name in NODE_PLANES else nbytes(t) // P
    F, S, isz = len(prog.filter_names), len(prog.score_names), a.node_alloc.element_size()
    rel_b, rel_ops = rel_reads(enc, prog, st, p)
    byts += rel_b + nbytes(weights) + enc.N * (4 * F + 2 * isz * S) + 4
    return bound(byts, ops_per_node(enc, prog) * enc.N + rel_ops)


def mid_state(cuda, eng):
    """The state after the first half of the queue (the kernel's pass, not
    recorded), and the next pod: the work an attempt does mid-pass."""
    enc = eng.enc
    half = len(enc.queue) // 2
    queue = padded_queue(eng)[:half].contiguous()
    st, _ = cuda.seq_run(eng.program, enc.arrays, enc.state0, queue, eng.weights, record=False)
    return st, int(enc.queue[half])


def drive_path(kp, cuda, diff, path, nodes, pods, cfg, sample, smi):
    """Phase 4 / 4b: one path at full width. `schedule()` with the counters
    set to 0 just before and read just after, the layer split, the plain
    pass on the card against it, then the single-pod step path with the
    counters reset again. Returns what phase 5 needs."""
    n_pods = len(pods)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()  # what earlier phases still hold
    cuda.reset_counts()
    t0 = time.perf_counter()
    placements, results = kp.schedule(nodes, pods, config=cfg, policy=kp.TPU32, decode=sample)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    pass_counts, pass_plain = dict(cuda.LAUNCHES), dict(cuda.PLAIN_CALLS)
    peak = torch.cuda.max_memory_allocated() - base
    if pass_counts["seq_run"] < 1 or any(pass_plain.values()):
        raise AssertionError(f"the pass did not go through seq_run: {pass_counts} {pass_plain}")
    n_placed = sum(1 for v in placements.values() if v)
    log(f"    schedule(): {wall_s:.3f} s wall (encode + pass + decode of {len(sample)} pods), "
        f"{n_pods / wall_s:.1f} decisions/s, {n_placed} placed, peak memory "
        f"{peak / 2**30:.3f} GiB, launches {pass_counts}, plain calls {pass_plain} "
        f"[{smi}]")

    # where the time goes: the same pass split into its layers
    t0 = time.perf_counter()
    enc = kp.encode_cluster(nodes, pods, cfg, policy=kp.TPU32)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    eng = kp.BatchedScheduler(enc)
    state_k, trace_k = eng.run()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    eng.placements()
    eng.results(pods=sample)
    t3 = time.perf_counter()
    split = (t1 - t0, t2 - t1, t3 - t2)
    log(f"    split: encode {split[0]:.3f} s, engine + pass {split[1]:.3f} s, decode "
        f"(placements + {len(sample)} records) {split[2]:.3f} s")
    eng_p = kp.BatchedScheduler(enc)
    eng_p.run_fn = functools.partial(cuda.seq_run_plain, eng_p.program, record=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state_p, trace_p = eng_p.run()
    torch.cuda.synchronize()
    plain_run_s = time.perf_counter() - t0
    for slot, g, h in zip(("pf_codes", "codes", "raw", "final", "sel"), trace_k, trace_p):
        diff.check(path, "seq_run", f"full width {slot}", g, h)
    for f in STATE_FIELDS:
        diff.check(path, "seq_run", f"full width state {f}", getattr(state_k, f),
                   getattr(state_p, f))
    if eng_p.placements() != placements:
        raise AssertionError(f"{path} full width: placements differ from the plain run's")
    want = {(r.pod_namespace, r.pod_name): r.to_annotations() for r in eng_p.results(pods=sample)}
    got = {(r.pod_namespace, r.pod_name): r.to_annotations() for r in results}
    if got != want or len(got) != len(sample & set(placements)):
        raise AssertionError(f"{path} full width: sampled annotations differ from the plain run's")
    log(f"    plain version of the pass on the card: {plain_run_s:.3f} s; trace "
        f"({len(trace_k[4])} steps), state, placements and {len(got)} pods' annotations equal")

    # the single-pod step path: attempt_bind_fn over the same queue
    a, w = enc.arrays, eng.weights
    st = enc.state0.clone()
    bad = torch.zeros((), dtype=torch.bool, device=enc.device)
    cuda.reset_counts()
    t0 = time.perf_counter()
    for qi, p in enumerate(enc.queue.tolist()):
        _, codes, raw, final, sel, _, st = eng.attempt_bind_fn(a, st, w, p, qi)
        for row, out in zip(trace_k[1:], (codes, raw, final, sel)):
            bad |= (row[qi] != out).any()
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    step_counts, step_plain = dict(cuda.LAUNCHES), dict(cuda.PLAIN_CALLS)
    if bool(bad):
        raise AssertionError(f"{path}: single-pod steps differ from the pass's trace rows")
    for f in STATE_FIELDS:
        diff.check(path, "seq_bind", f"step path state {f}", getattr(st, f), getattr(state_k, f))
    n_q = len(enc.queue)
    if step_counts["seq_attempt"] != n_q or step_counts["seq_bind"] != n_q or any(
            step_plain.values()):
        raise AssertionError(f"{path} step path launches {step_counts}, plain {step_plain}")
    log(f"    single-pod step path: {n_q} steps in {step_s:.3f} s, every trace row and the "
        f"final state equal the pass's; launches {step_counts}")
    return dict(enc=enc, eng=eng, trace=trace_k, pass_counts=pass_counts,
                step_counts=step_counts, plain_run_s=plain_run_s, mid=mid_state(cuda, eng))


def kernel_rows(cuda, diff, path, run):
    """Phase 5 for one path: each kernel's time, its plain version's time
    and its bound, as entries of the kernels line. The per-pod kernels are
    timed at the state half-way through the queue, on the next pod."""
    enc, eng, trace_k = run["enc"], run["eng"], run["trace"]
    a, w, prog = enc.arrays, eng.weights, eng.program
    queue = padded_queue(eng)
    st, q = run["mid"]
    st = st.clone()
    codes, raw, final, sel = cuda.seq_attempt(prog, a, st, w, q)
    attempt_ms = graph_ms(lambda: cuda.seq_attempt(prog, a, st, w, q))
    attempt_plain_ms = events_ms(lambda: cuda.seq_attempt_plain(prog, a, st, w, q), 20)
    b_att = attempt_bound(enc, prog, st, q, w)
    # binding the pod again and again only grows the counters it adds to
    bind_ms = graph_ms(lambda: cuda.seq_bind(prog, a, st, q, sel, 0))
    bind_plain_ms = events_ms(lambda: cuda.seq_bind_plain(prog, a, st, q, sel, 0), 20)
    run_ms = events_ms(lambda: cuda.seq_run(prog, a, enc.state0, queue, w, record=True), 1, 3)
    state_bytes = nbytes(*(getattr(enc.state0, f) for f in STATE_FIELDS))
    port_row = nbytes(a.want_pair[0], a.want_wild[0], a.want_trip[0])
    b_bind = bound(nbytes(a.pod_req[0], a.pod_sreq[0]) + 2 * 2 * nbytes(st.requested[0])
                   + 3 * port_row + 2 * 4 + 3 * 4, 3 * enc.R + 4 + port_row // 4)
    # the mid-pass step's operations for every step: the relational walk
    # grows with the bound pods, so the middle step is about the mean
    step_ops = ops_per_node(enc, prog) * enc.N + rel_reads(enc, prog, run["mid"][0], q)[1]
    b_run = bound(cluster_bytes(enc) + state_bytes + nbytes(queue, w) + nbytes(*trace_k)
                  + state_bytes, step_ops * len(queue))
    rows = [
        ("seq_attempt", run["step_counts"], attempt_ms, attempt_plain_ms, b_att),
        ("seq_bind", run["step_counts"], bind_ms, bind_plain_ms, b_bind),
        ("seq_run", run["pass_counts"], run_ms, run["plain_run_s"] * 1e3, b_run),
    ]
    return [{
        "name": k, "path": path, "route": "cuda", "source": SOURCE, "replaces": REPLACES[k],
        "launches": counts[k], "max_abs_err": diff.err[path, k], "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b[0], "bound_by": b[1], "library_ms": None,
    } for k, counts, ms, plain_ms, b in rows]


# The plugin bodies this slice added (K4/K5 of the reference)
BODIES = (("filter", "NodeAffinity"), ("filter", "NodePorts"), ("filter", "PodTopologySpread"),
          ("filter", "InterPodAffinity"), ("score", "NodeAffinity"), ("score", "ImageLocality"),
          ("score", "PodTopologySpread"), ("score", "InterPodAffinity"))


def body_times(kp, cuda, run, smi):
    """Phase 5b: each plugin body this slice added, timed inside
    `seq_attempt` with that plugin alone enabled (its PreScore too), beside
    its plain body on the same inputs and the bound of that attempt
    (`attempt_bound`). On the affinity path's cluster at the state half-way
    through its queue, on the next pod. The time includes the launch and
    the select that every attempt does."""
    from kube_scheduler_simulator_tpu_torch.engine import kernels as K
    from kube_scheduler_simulator_tpu_torch.sched.config import SchedulerConfiguration

    enc = run["enc"]
    a = enc.arrays
    st, p = run["mid"]
    out = []
    for point, name in BODIES:
        star = [{"name": "*"}]
        plugins = {pt: {"disabled": star, "enabled": []}
                   for pt in ("preFilter", "filter", "postFilter", "preScore", "score")}
        plugins[point]["enabled"] = [{"name": name, "weight": 1}] if point == "score" else [
            {"name": name}]
        if point == "score" and name in K.TRIVIAL_PRESCORE:
            plugins["preScore"]["enabled"] = [{"name": name}]
        cfg = SchedulerConfiguration.from_dict(
            {"profiles": [{"schedulerName": "default-scheduler", "plugins": plugins}]})
        enc1 = type(enc)(a, enc.state0, node_names=enc.node_names, pod_keys=enc.pod_keys,
                         resource_names=enc.resource_names, queue=enc.queue,
                         policy=enc.policy, config=cfg, n_nodes=enc.n_nodes,
                         n_pods=enc.n_pods, aux=enc.aux)
        eng = kp.BatchedScheduler(enc1)
        prog, w = eng.program, eng.weights
        ms = graph_ms(lambda: cuda.seq_attempt(prog, a, st, w, p))
        reg = K.FILTER_KERNELS if point == "filter" else K.SCORE_KERNELS
        body = reg[name][0](enc1)
        feasible = a.node_mask.clone()
        plain = (lambda: body(a, st, p)) if point == "filter" else (
            lambda: body(a, st, p, feasible))
        plain_ms = events_ms(plain, 20)
        b = attempt_bound(enc1, prog, st, p, w)
        out.append((point, name, ms, plain_ms, b))
        log(f"    {point:6s} {name:18s} seq_attempt alone {ms:.6f} ms (plain body "
            f"{plain_ms:.3f} ms, bound {b[0]:.6f} ms by {b[1]}) [{smi}]")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    faulthandler.dump_traceback_later(TIME_LIMIT_S, exit=True)
    t_start = time.perf_counter()
    import kube_scheduler_simulator_tpu_torch as kp
    from kube_scheduler_simulator_tpu_torch.engine import cuda
    from kube_scheduler_simulator_tpu_torch.synth import DRESSED_NAMESPACES, dressed_affinity_cluster

    # -- 1. device --------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"[1] device: {name} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"| CUDA {torch.version.cuda} | cards: {torch.cuda.device_count()}")

    # -- 2. build ---------------------------------------------------------
    path, build_s = cuda.build()
    cuda.library()
    log(f"[2] built {path.name} in {build_s:.1f} s")
    for ln in ptxas_report(path.with_suffix(".log").read_text()):
        log(f"    ptxas: {ln}")

    # -- 3. kernels vs plain ----------------------------------------------
    log("[3] kernels against their plain versions on the card (exact equality)")
    diff = Diff()
    nodes, pods = dressed_cluster(kp, 256, 2000, seed=11)
    compare_kernels(kp, cuda, diff, "fit", nodes, pods, configs(kp), bind=False)
    nodes, pods = dressed_affinity_cluster(256, 2000, seed=11)
    compare_kernels(kp, cuda, diff, "affinity", nodes, pods, {"slice": kp.slice_config()},
                    bind=True, namespaces=DRESSED_NAMESPACES)
    log(f"    phase 3 done at {time.perf_counter() - t_start:.1f} s")

    # -- 4. the fit path at full width --------------------------------------
    n_nodes, n_pods = 1024, 10000
    nodes, pods = kp.synthetic_cluster(n_nodes, n_pods, seed=7)
    rng = np.random.default_rng(7)
    sample = {("default", f"pod-{i}") for i in rng.choice(n_pods, 100, replace=False)}
    log(f"[4] fit path at full width: {n_nodes} nodes x {n_pods} pods, fit_config(), TPU32, "
        "trace recorded")
    fit = drive_path(kp, cuda, diff, "fit", nodes, pods, kp.fit_config(), sample, smi)

    # -- 4b. the affinity path at full width (BASELINE config #3) -----------
    n_nodes, n_pods = 500, 5000
    nodes, pods = kp.synthetic_affinity_cluster(n_nodes, n_pods, seed=11)
    rng = np.random.default_rng(11)
    sample = {("default", f"pod-{i}") for i in rng.choice(n_pods, 100, replace=False)}
    log(f"[4b] affinity path at full width: {n_nodes} nodes x {n_pods} pods "
        "(synthetic_affinity_cluster, seed 11), slice_config(), TPU32, trace recorded")
    aff = drive_path(kp, cuda, diff, "affinity", nodes, pods, kp.slice_config(), sample, smi)

    # -- 5. kernel times --------------------------------------------------
    kernels = kernel_rows(cuda, diff, "fit", fit) + kernel_rows(cuda, diff, "affinity", aff)
    log(f"[5] kernel times at full width, TPU32 [{smi}]")
    for kr in kernels:
        log(f"    {kr['path']:8s} {kr['name']:11s} {kr['ms']:.6f} ms (plain "
            f"{kr['plain_ms']:.3f} ms, bound {kr['bound_ms']:.6f} ms by {kr['bound_by']}), "
            f"{kr['launches']} launches")
    log(f"[5b] the slice's plugin bodies inside seq_attempt, affinity path's cluster, "
        f"TPU32 [{smi}]")
    body_times(kp, cuda, aff, smi)
    log(f"    total {time.perf_counter() - t_start:.1f} s")
    faulthandler.cancel_dump_traceback_later()

    # -- 6. result --------------------------------------------------------
    print(json.dumps({"kernels": kernels}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
