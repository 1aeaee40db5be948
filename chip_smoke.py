#!/usr/bin/env python3
"""Drive the PyTorch port's sequential scheduling pass on one NVIDIA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure raises and the process exits non-zero:

1. the device: its name, `nvidia-smi`'s name and power limit, the torch
   and CUDA versions;
2. build: the CUDA kernels (csrc/seq_kernels.cu) compiled for sm_90a into
   build/kernels/, with the compiler's register and spill report;
3. each kernel against its plain PyTorch version on the card, under TPU32
   and EXACT and three plugin configurations, on a 256-node x 2,000-pod
   cluster dressed with taints, tolerations, cordoned nodes, nodeName pods
   and pods too large for any node: `seq_attempt` at 64 pods x random
   states, `seq_bind` on those pods, `seq_run` over the whole queue (trace,
   final state, placements). Every comparison is exact equality;
4. full width: `schedule()` on 1,024 nodes x 10,000 pods (TPU32, trace
   recorded) with the launch counters set to 0 just before and read just
   after — the pass must launch `seq_run` and no plain version; its
   placements, trace and 100 sampled pods' annotations must equal the plain
   version's run on the card. Then the single-pod step path
   (`attempt_bind_fn`, launching `seq_attempt` and `seq_bind`) is driven
   over the same queue with the counters reset again, and each step must
   reproduce the pass's trace row;
5. kernel times (CUDA events; the per-pod kernels replayed from a CUDA
   graph so host enqueue time is not counted), the plain versions' times
   and each kernel's bound, printed as one JSON line;
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
    """The slice's default configuration, and two that reach the other
    NodeResourcesFit strategies and BalancedAllocation's 3-resource branch
    (the float32 branch under TPU32)."""
    from kube_scheduler_simulator_tpu_torch.sched.config import SchedulerConfiguration

    plugins = kp.slice_config().to_dict()["profiles"][0]["plugins"]
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
        "slice": kp.slice_config(),
        "most-3": with_args({"type": "MostAllocated", "resources": [
            {"name": "cpu", "weight": 2}, {"name": "memory", "weight": 1},
            {"name": "example.com/absent", "weight": 1}]}),
        "rtcr-3": with_args({"type": "RequestedToCapacityRatio", "resources": three,
                             "requestedToCapacityRatio": {"shape": [
                                 {"utilization": 0, "score": 10},
                                 {"utilization": 40, "score": 6},
                                 {"utilization": 100, "score": 1}]}}),
    }


class Diff:
    """Exact comparison of kernel and plain outputs; keeps the largest
    absolute difference seen per kernel."""

    def __init__(self):
        self.err = {}

    def check(self, kernel, what, got, want):
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(f"{kernel} {what}: {got.dtype}{tuple(got.shape)} "
                                 f"vs plain {want.dtype}{tuple(want.shape)}")
        err = float((got.double() - want.double()).abs().max()) if got.numel() else 0.0
        self.err[kernel] = max(self.err.get(kernel, 0.0), err)
        if not torch.equal(got, want):
            raise AssertionError(f"{kernel} {what}: kernel differs from plain (max |d| {err})")


def random_state(enc, rng):
    """A node state with usage up to 130% of capacity and pod counts about
    the 110-pod limit (what the pass reaches only partly)."""
    from kube_scheduler_simulator_tpu_torch.engine.encode import SchedState

    alloc = enc.arrays.node_alloc.cpu().numpy()
    dt, dev = alloc.dtype, enc.device
    req = np.floor(alloc * rng.uniform(0.0, 1.3, alloc.shape)).astype(dt)
    sreq = np.floor(alloc * rng.uniform(0.0, 1.3, alloc.shape)).astype(dt)
    n_pods = rng.integers(0, 112, alloc.shape[0]).astype(np.int32)
    return SchedState(
        requested=torch.as_tensor(req, device=dev),
        s_requested=torch.as_tensor(sreq, device=dev),
        n_pods=torch.as_tensor(n_pods, device=dev),
        assignment=enc.state0.assignment.clone(),
        bound_seq=enc.state0.bound_seq.clone(),
    )


def compare_kernels(kp, cuda, diff):
    """Phase 3: every kernel against its plain version, exact."""
    nodes, pods = dressed_cluster(kp, 256, 2000, seed=11)
    for pol in (kp.TPU32, kp.EXACT):
        for cname, cfg in configs(kp).items():
            enc = kp.encode_cluster(nodes, pods, cfg, policy=pol)
            eng = kp.BatchedScheduler(enc)
            prog, a, w = eng.program, enc.arrays, eng.weights
            rng = np.random.default_rng(3)
            for k in range(4):
                st = random_state(enc, rng)
                for qi, p in enumerate(rng.choice(enc.n_pods, 16, replace=False).tolist()):
                    got = cuda.seq_attempt(prog, a, st, w, p)
                    want = cuda.seq_attempt_plain(prog, a, st, w, p)
                    for name, g, h in zip(("codes", "raw", "final", "sel"), got, want):
                        diff.check("seq_attempt", f"{pol.name}/{cname} pod {p} {name}", g, h)
                    # bind the selection, an unschedulable pick, and a padding step
                    for pp, sel in ((p, got[3]), (p, torch.full_like(got[3], -1)),
                                    (-1, got[3])):
                        s1 = cuda.seq_bind(prog, a, st.clone(), pp, sel, qi + 16 * k)
                        s2 = cuda.seq_bind_plain(prog, a, st.clone(), pp, sel, qi + 16 * k)
                        for f in ("requested", "s_requested", "n_pods", "assignment",
                                  "bound_seq"):
                            diff.check("seq_bind", f"{pol.name}/{cname} pod {pp} {f}",
                                       getattr(s1, f), getattr(s2, f))
            queue = torch.as_tensor(
                np.concatenate([enc.queue, np.full(
                    eng.queue_bucket(len(enc.queue)) - len(enc.queue), -1)]).astype(np.int32),
                device=enc.device)
            s_k, t_k = cuda.seq_run(prog, a, enc.state0, queue, w, record=True)
            s_p, t_p = cuda.seq_run_plain(prog, a, enc.state0, queue, w, record=True)
            for name, g, h in zip(("pf_codes", "codes", "raw", "final", "sel"), t_k, t_p):
                diff.check("seq_run", f"{pol.name}/{cname} {name}", g, h)
            for f in ("requested", "s_requested", "n_pods", "assignment", "bound_seq"):
                diff.check("seq_run", f"{pol.name}/{cname} state {f}",
                           getattr(s_k, f), getattr(s_p, f))
            s_n, sel_n = cuda.seq_run(prog, a, enc.state0, queue, w, record=False)
            diff.check("seq_run", f"{pol.name}/{cname} unrecorded sel", sel_n, t_p[4])
            diff.check("seq_run", f"{pol.name}/{cname} unrecorded assignment",
                       s_n.assignment, s_p.assignment)
            placed = int((s_k.assignment >= 0).sum()) - int((enc.state0.assignment >= 0).sum())
            log(f"  {pol.name:5s} {cname:7s}: 64 attempts, 192 binds and a "
                f"{len(queue)}-step pass equal to plain ({placed} of "
                f"{len(enc.queue)} pending pods placed)")


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

    T, L, R = enc.arrays.taint_key.shape[1], enc.arrays.tol_key.shape[1], enc.R
    taint = T * (3 + 8 * L)
    per_filter = {"NodeUnschedulable": 3, "NodeName": 3, "TaintToleration": taint,
                  "NodeResourcesFit": 4 + 6 * R}
    per_score = {"NodeResourcesFit": 12 * len(K.fit_score_args(enc)[1]) + 4,
                 "NodeResourcesBalancedAllocation": 45 * len(K.balanced_resources(enc)) + 20,
                 "TaintToleration": taint}
    normalize_select = 8 * len(prog.score_names) + 8
    return (sum(per_filter[n] for n in prog.filter_names)
            + sum(per_score[n] for n in prog.score_names) + normalize_select)


def bound(bytes_moved, ops):
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / SCALAR_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    faulthandler.dump_traceback_later(TIME_LIMIT_S, exit=True)
    t_start = time.perf_counter()
    import kube_scheduler_simulator_tpu_torch as kp
    from kube_scheduler_simulator_tpu_torch.engine import cuda

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
    compare_kernels(kp, cuda, diff)

    # -- 4. full width ----------------------------------------------------
    n_nodes, n_pods = 1024, 10000
    nodes, pods = kp.synthetic_cluster(n_nodes, n_pods, seed=7)
    rng = np.random.default_rng(7)
    sample = {("default", f"pod-{i}") for i in rng.choice(n_pods, 100, replace=False)}
    log(f"[4] full width: {n_nodes} nodes x {n_pods} pods, TPU32, trace recorded")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda.reset_counts()
    t0 = time.perf_counter()
    placements, results = kp.schedule(nodes, pods, policy=kp.TPU32, decode=sample)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    pass_counts, pass_plain = dict(cuda.LAUNCHES), dict(cuda.PLAIN_CALLS)
    peak = torch.cuda.max_memory_allocated()
    if pass_counts["seq_run"] < 1 or any(pass_plain.values()):
        raise AssertionError(f"the pass did not go through seq_run: {pass_counts} {pass_plain}")
    n_placed = sum(1 for v in placements.values() if v)
    log(f"    schedule(): {wall_s:.3f} s wall (encode + pass + decode of 100 pods), "
        f"{n_pods / wall_s:.1f} decisions/s, {n_placed} placed, peak memory "
        f"{peak / 2**30:.3f} GiB, launches {pass_counts}, plain calls {pass_plain} "
        f"[{smi}]")

    # where the time goes: the same pass split into its layers
    t0 = time.perf_counter()
    enc = kp.encode_cluster(nodes, pods, kp.slice_config(), policy=kp.TPU32)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    eng = kp.BatchedScheduler(enc)
    state_k, trace_k = eng.run()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    eng.placements()
    eng.results(pods=sample)
    t3 = time.perf_counter()
    log(f"    split: encode {t1 - t0:.3f} s, engine + pass {t2 - t1:.3f} s, decode "
        f"(placements + 100 records) {t3 - t2:.3f} s")
    eng_p = kp.BatchedScheduler(enc)
    eng_p.run_fn = functools.partial(cuda.seq_run_plain, eng_p.program, record=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state_p, trace_p = eng_p.run()
    torch.cuda.synchronize()
    plain_run_s = time.perf_counter() - t0
    for slot, g, h in zip(("pf_codes", "codes", "raw", "final", "sel"), trace_k, trace_p):
        diff.check("seq_run", f"full width {slot}", g, h)
    for f in ("requested", "s_requested", "n_pods", "assignment", "bound_seq"):
        diff.check("seq_run", f"full width state {f}", getattr(state_k, f), getattr(state_p, f))
    if eng_p.placements() != placements:
        raise AssertionError("full width: placements differ from the plain run's")
    want = {(r.pod_namespace, r.pod_name): r.to_annotations() for r in eng_p.results(pods=sample)}
    got = {(r.pod_namespace, r.pod_name): r.to_annotations() for r in results}
    if got != want or len(got) != len(sample & set(placements)):
        raise AssertionError("full width: sampled annotations differ from the plain run's")
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
        raise AssertionError("single-pod steps differ from the pass's trace rows")
    for f in ("requested", "s_requested", "n_pods", "assignment", "bound_seq"):
        diff.check("seq_bind", f"step path state {f}", getattr(st, f), getattr(state_k, f))
    n_q = len(enc.queue)
    if step_counts["seq_attempt"] != n_q or step_counts["seq_bind"] != n_q or any(
            step_plain.values()):
        raise AssertionError(f"step path launches {step_counts}, plain {step_plain}")
    log(f"    single-pod step path: {n_q} steps in {step_s:.3f} s, every trace row and the "
        f"final state equal the pass's; launches {step_counts}")

    # -- 5. kernel times --------------------------------------------------
    prog, q = eng.program, enc.queue[0].item()
    queue = torch.as_tensor(np.concatenate([enc.queue, np.full(
        eng.queue_bucket(n_q) - n_q, -1)]).astype(np.int32), device=enc.device)
    st = enc.state0.clone()
    codes, raw, final, sel = cuda.seq_attempt(prog, a, st, w, q)
    attempt_ms = graph_ms(lambda: cuda.seq_attempt(prog, a, st, w, q))
    attempt_plain_ms = events_ms(lambda: cuda.seq_attempt_plain(prog, a, st, w, q), 20)
    bind_ms = graph_ms(lambda: cuda.seq_bind(prog, a, st, q, sel, 0))
    bind_plain_ms = events_ms(lambda: cuda.seq_bind_plain(prog, a, st, q, sel, 0), 20)
    run_ms = events_ms(lambda: cuda.seq_run(prog, a, enc.state0, queue, w, record=True), 1, 3)
    run_plain_ms = plain_run_s * 1e3
    node_in = nbytes(a.node_alloc, a.node_unsched, a.node_mask, a.taint_key, a.taint_val,
                     a.taint_effect, enc.state0.requested, enc.state0.s_requested,
                     enc.state0.n_pods)
    pod_row = (nbytes(a.pod_req, a.pod_sreq, a.pod_req_rank, a.pod_node_name,
                      a.pod_tol_unsched, a.tol_key, a.tol_val, a.tol_effect, a.tol_op)
               // enc.P)
    step_out = nbytes(codes, raw, final, sel)
    per_step_ops = ops_per_node(enc, prog) * enc.N
    b_att = bound(node_in + pod_row + nbytes(w) + step_out, per_step_ops)
    b_bind = bound(nbytes(a.pod_req[0], a.pod_sreq[0]) + 2 * 2 * nbytes(st.requested[0])
                   + 2 * 4 + 3 * 4, 3 * enc.R + 4)
    pod_planes = nbytes(a.pod_req, a.pod_sreq, a.pod_req_rank, a.pod_node_name,
                        a.pod_tol_unsched, a.tol_key, a.tol_val, a.tol_effect, a.tol_op)
    state_bytes = nbytes(*(getattr(enc.state0, f) for f in
                           ("requested", "s_requested", "n_pods", "assignment", "bound_seq")))
    b_run = bound(node_in + pod_planes + state_bytes + nbytes(queue, w)
                  + nbytes(*trace_k) + state_bytes, per_step_ops * len(queue))
    rows = [
        ("seq_attempt", step_counts, attempt_ms, attempt_plain_ms, b_att),
        ("seq_bind", step_counts, bind_ms, bind_plain_ms, b_bind),
        ("seq_run", pass_counts, run_ms, run_plain_ms, b_run),
    ]
    kernels = [{
        "name": k, "route": "cuda", "source": SOURCE, "replaces": REPLACES[k],
        "launches": counts[k], "max_abs_err": diff.err[k], "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b[0], "bound_by": b[1], "library_ms": None,
    } for k, counts, ms, plain_ms, b in rows]
    log(f"[5] kernel times at full width (1024 nodes, TPU32) [{smi}]")
    for kr in kernels:
        log(f"    {kr['name']:11s} {kr['ms']:.6f} ms (plain {kr['plain_ms']:.3f} ms, bound "
            f"{kr['bound_ms']:.6f} ms by {kr['bound_by']}), {kr['launches']} launches")
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
