"""The CUDA sources (csrc/seq_kernels.cu, csrc/delta_kernels.cu) run on
the CPU against the plain versions, through the wrappers of engine/cuda.py
and engine/scatter.py.

The host's C++ compiler builds the kernel source with stand-ins for the
CUDA built-ins (`HOST_CUDA` below): a block of one thread, whose loops
stride by 1 and whose warp shuffles return the thread's own value (so each
reduction sees one lane holding every node's result), barriers that do
nothing and atomics that add in turn. That runs every phase of every step
in order — the plugin bodies, the arithmetic in the policy's type, the
relational counts, the normalizes, the select and the bind, the structs'
layout and the wrappers' arguments — but not the interleaving of threads,
which only the card's tests (test_torch_cuda.py) see. Skipped where no
`g++` is found. Tolerance: exact equality.
"""

import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

import kube_scheduler_simulator_tpu_torch as kp
from kube_scheduler_simulator_tpu_torch.engine import cuda, scatter
from kube_scheduler_simulator_tpu_torch.engine.delta import DeltaEncoder
from kube_scheduler_simulator_tpu_torch.models.store import ResourceStore
from kube_scheduler_simulator_tpu_torch.sched.config import SchedulerConfiguration

from test_torch_clusters import NAMESPACES, rel_cluster
from test_torch_cuda import (
    STATE_FIELDS,
    check_k10,
    check_segments,
    check_stacked_gang,
    cluster,
    random_state,
)
from test_torch_delta import TEMPLATES, assert_port_equal, from_template, full_encode

HOST_CUDA = r"""
#pragma once
#include <cmath>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__
#define __shared__ static
#define __launch_bounds__(x)
struct Dim3 { unsigned x, y, z; };
static Dim3 threadIdx, blockIdx;
static Dim3 gridDim = {1, 1, 1};
// one thread is the block: strides of 1, and one warp for the reductions
struct BlockDimX {
  operator unsigned() const { return 1; }
  int operator>>(int) const { return 1; }
};
struct BlockDim { BlockDimX x; };
static BlockDim blockDim;
typedef struct CUstream_st* cudaStream_t;
inline int cudaGetLastError() { return 0; }
inline void __syncthreads() {}
inline int __syncthreads_or(int v) { return v; }
template <typename T> T __shfl_down_sync(unsigned, T v, int) { return v; }
inline int atomicAdd(int* p, int v) { int o = *p; *p += v; return o; }
inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) {
  unsigned long long o = *p; *p += v; return o;
}
inline int atomicMin(int* p, int v) { int o = *p; if (v < o) *p = v; return o; }
inline int atomicOr(int* p, int v) { int o = *p; *p |= v; return o; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
inline double __dsqrt_rn(double a) { return std::sqrt(a); }
"""

POLICIES = {"exact": kp.EXACT, "i32": kp.TPU32}


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernel source on the host")
    d = tmp_path_factory.mktemp("host_kernels")
    shutil.copy(cuda.LAYOUT_H, d)
    return host_build(d, (cuda.CSRC, cuda.DELTA_CSRC), "kernels")


@pytest.fixture
def host(host_lib, monkeypatch):
    """The wrappers (engine/cuda.py's and engine/scatter.py's) launch the
    host build of the kernels on CPU tensors."""
    monkeypatch.setattr(cuda, "build", lambda: (host_lib, 0.0))
    for name, value in (("_LIB", None), ("_LAYOUT", None), ("KERNEL_DEVICE_TYPES", ("cpu",))):
        monkeypatch.setattr(cuda, name, value)
    monkeypatch.setattr(cuda, "_on_cpu", lambda a: False)
    monkeypatch.setattr(scatter, "_on_cpu", lambda a: False)
    monkeypatch.setattr(cuda, "_stream", lambda: 0)
    cuda.reset_counts()
    scatter.reset_counts()


def host_build(d, srcs, name):
    """Compile CUDA sources for the host with the stand-ins of HOST_CUDA
    into one shared library; returns its path. A `.cu` file a source
    includes is rewritten beside it the same way."""
    (d / "cuda_runtime.h").write_text(HOST_CUDA)
    host_srcs = []

    def for_host(src):
        # a launch `k<<<grid, block, smem, stream>>>(args)` becomes the call k(args)
        text = re.sub(r"<<<.*?>>>", "", src.read_text(), flags=re.S)
        for inc in re.findall(r'#include "(\w+\.cu)"', text):
            (d / inc).write_text(for_host(src.with_name(inc)))
        return text

    for src in srcs:
        host_src = d / f"{src.stem}_host.cpp"
        host_src.write_text(for_host(src))
        host_srcs.append(str(host_src))
    lib = d / f"lib{name}_host.so"
    # -ffp-contract=off: no fused multiply-add, as the kernels' float steps
    subprocess.run([shutil.which("g++"), "-std=c++17", "-O1", "-ffp-contract=off", "-shared",
                    "-fPIC", "-w", "-I", str(d), "-o", str(lib), *host_srcs],
                   check=True, capture_output=True)
    return lib


def engine(policy, kind, config, seed=1):
    if kind == "fit":
        nodes, pods = cluster(24, 120, seed)
    elif kind == "rel":
        nodes, pods = rel_cluster(seed, 20, 120)
    else:
        nodes, pods = kp.synthetic_affinity_cluster(16, 90, seed=seed)
    cfg = kp.fit_config() if config == "fit" else kp.affinity_config()
    enc = kp.encode_cluster(nodes, pods, cfg, policy=POLICIES[policy], namespaces=NAMESPACES,
                            device="cpu")
    return kp.BatchedScheduler(enc, device="cpu")


def padded_queue(eng):
    q = eng.enc.queue
    pad = np.full(eng.queue_bucket(len(q)) - len(q), -1)
    return torch.as_tensor(np.concatenate([q, pad]).astype(np.int32))


def same(got, want, what):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert torch.equal(got, want), what


CASES = [("fit", "fit"), ("rel", "fit"), ("rel", "slice"), ("chain", "slice")]
IDS = ["fit-cluster", "rel-cluster-fit", "rel-cluster-slice", "chains-slice"]


@pytest.mark.parametrize("kind,config", CASES, ids=IDS)
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_attempt_and_bind_match_plain(host, policy, kind, config):
    eng = engine(policy, kind, config)
    enc, prog, a, w = eng.enc, eng.program, eng.enc.arrays, eng.weights
    rng = np.random.default_rng(5)
    for k in range(3):
        st = random_state(enc, rng)
        for qi, p in enumerate(rng.choice(enc.n_pods, 8, replace=False).tolist()):
            got = cuda.seq_attempt(prog, a, st, w, p)
            want = cuda.seq_attempt_plain(prog, a, st, w, p)
            for name, g, h in zip(("codes", "raw", "final", "sel"), got, want):
                same(g, h, (k, p, name))
            # the selection, an unschedulable pick and a padding step
            for pp, sel in ((p, got[3]), (p, torch.full_like(got[3], -1)), (-1, got[3])):
                s1 = cuda.seq_bind(prog, a, st.clone(), pp, sel, qi)
                s2 = cuda.seq_bind_plain(prog, a, st.clone(), pp, sel, qi)
                for f in STATE_FIELDS:
                    same(getattr(s1, f), getattr(s2, f), (k, pp, f))
    assert cuda.LAUNCHES["seq_attempt"] == 24 and cuda.LAUNCHES["seq_bind"] == 72


@pytest.mark.parametrize("kind,config", CASES, ids=IDS)
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_run_matches_plain(host, policy, kind, config):
    eng = engine(policy, kind, config, seed=2)
    enc, q = eng.enc, padded_queue(eng)
    args = (eng.program, enc.arrays, enc.state0, q, eng.weights)
    s_k, t_k = cuda.seq_run(*args, record=True)
    s_p, t_p = cuda.seq_run_plain(*args, record=True)
    for name, g, h in zip(("pf_codes", "codes", "raw", "final", "sel"), t_k, t_p):
        same(g, h, name)
    for f in STATE_FIELDS:
        same(getattr(s_k, f), getattr(s_p, f), f)
    s_n, sel_n = cuda.seq_run(*args, record=False)
    same(sel_n, t_p[4], "unrecorded sel")
    same(s_n.assignment, s_p.assignment, "unrecorded assignment")
    assert cuda.LAUNCHES["seq_run"] == 2 and int((s_k.assignment >= 0).sum()) > 0


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("prescore", ["on", "off"])
def test_custom_normalizes_with_no_feasible_node(host, policy, prescore):
    nodes, pods = rel_cluster(3, 16, 40)
    pods[7]["spec"]["containers"][0]["resources"]["requests"] = {"cpu": "999"}
    cfg = kp.affinity_config().to_dict()
    if prescore == "off":
        cfg["profiles"][0]["plugins"]["preScore"]["enabled"] = []
    enc = kp.encode_cluster(nodes, pods, SchedulerConfiguration.from_dict(cfg),
                            policy=POLICIES[policy], namespaces=NAMESPACES, device="cpu")
    eng = kp.BatchedScheduler(enc, device="cpu")
    got = cuda.seq_attempt(eng.program, enc.arrays, enc.state0, eng.weights, 7)
    want = cuda.seq_attempt_plain(eng.program, enc.arrays, enc.state0, eng.weights, 7)
    assert int(got[3]) == -1
    for name, g, h in zip(("codes", "raw", "final", "sel"), got, want):
        same(g, h, name)


def preempt_engine(policy, kind, seed=3):
    """The default profile on a preemption_cluster, or on the dressed
    relational cluster with random priorities (spread and inter-pod rows in
    the dry run)."""
    objects = {}
    if kind == "preempt":
        nodes, pods, objects = kp.preemption_cluster(16, 100, seed=seed)
    else:
        nodes, pods = rel_cluster(seed, 20, 120)
        rng = np.random.default_rng(seed)
        for pd in pods:
            pd["spec"]["priority"] = int(rng.choice([0, 3, 7, 50]))
    enc = kp.encode_cluster(nodes, pods, kp.supported_config(), policy=POLICIES[policy],
                            namespaces=NAMESPACES, device="cpu", **objects)
    return kp.BatchedScheduler(enc, device="cpu")


PREEMPT_KINDS = ["preempt", "rel"]


@pytest.mark.parametrize("kind", PREEMPT_KINDS)
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_preempt_and_evict_match_plain(host, policy, kind):
    eng = preempt_engine(policy, kind)
    enc, prog, a = eng.enc, eng.program, eng.enc.arrays
    rng = np.random.default_rng(9)
    nominated = 0
    for k in range(3):
        st = random_state(enc, rng)
        for p in rng.choice(enc.n_pods, 8, replace=False).tolist():
            got = cuda.seq_preempt(prog, a, st, p)
            want = cuda.seq_preempt_plain(prog, a, st, p)
            for name, g, h in zip(("pcode", "voff", "vidx", "nominated"), got, want):
                same(g, h, (k, p, name))
            nominated += int(got[3]) >= 0
        mask = (st.assignment >= 0) & torch.as_tensor(rng.random(enc.P) < 0.3)
        s1 = cuda.seq_evict(prog, a, st.clone(), mask)
        s2 = cuda.seq_evict_plain(prog, a, st.clone(), mask)
        for f in STATE_FIELDS:
            same(getattr(s1, f), getattr(s2, f), (k, "evict", f))
    assert nominated > 0
    assert cuda.LAUNCHES["seq_preempt"] == 24 and cuda.LAUNCHES["seq_evict"] == 3


@pytest.mark.parametrize("kind", PREEMPT_KINDS)
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_run_with_preemption_matches_plain(host, policy, kind, monkeypatch):
    eng = preempt_engine(policy, kind, seed=4)
    enc, q = eng.enc, padded_queue(eng)
    args = (eng.program, enc.arrays, enc.state0, q, eng.weights)
    s_k, t_k = cuda.seq_run(*args, record=True)
    s_p, t_p = cuda.seq_run_plain(*args, record=True)
    assert len(t_k) == len(cuda.TRACE_SLOTS_PREEMPT)
    for name, g, h in zip(cuda.TRACE_SLOTS_PREEMPT, t_k, t_p):
        same(g, h, name)
    for f in STATE_FIELDS:
        same(getattr(s_k, f), getattr(s_p, f), f)
    # dry runs fired (and on the preemption cluster, nominated and evicted)
    assert int(t_k[5].sum()) > 0 and (kind == "rel" or int((t_k[7] >= 0).sum()) > 0)
    s_n, sel_n = cuda.seq_run(*args, record=False)
    same(sel_n, t_p[cuda.TRACE_SLOTS_PREEMPT.index("final_sel")], "unrecorded final_sel")
    same(s_n.assignment, s_p.assignment, "unrecorded assignment")
    # a victim record too small for the pass raises; it never truncates
    if kind == "preempt":
        monkeypatch.setattr(cuda, "VICTIM_CAP", len(t_k[-1]) - 1)
        with pytest.raises(RuntimeError, match="victim capacity"):
            cuda.seq_run(*args, record=True)


@pytest.mark.parametrize("record", [True, False], ids=["record", "no-record"])
@pytest.mark.parametrize("kind", ["preempt", "fit"])
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_sweep_matches_plain(host, policy, kind, record):
    """K11 sweep_run: three weight variants in one launch (one block of the
    host build strides over them) against the per-variant plain passes;
    on the preemption cluster dry runs fire in every variant."""
    eng = preempt_engine(policy, "preempt", seed=4) if kind == "preempt" else engine(
        policy, "fit", "fit", seed=2)
    enc = eng.enc
    q = torch.as_tensor(np.asarray(enc.queue, np.int32))
    w = torch.stack([eng.weights, torch.ones_like(eng.weights), eng.weights * 3 + 1])
    states0 = cuda.stack_states([enc.state0] * 3)
    before = states0.clone()
    args = (eng.program, enc.arrays, states0, q, w)
    s_k, out_k = cuda.sweep_run(*args, record=record, grid=2)
    s_p, out_p = cuda.sweep_run_plain(*args, record=record)
    assert cuda.LAUNCHES["sweep_run"] == 1 and cuda.PLAIN_CALLS["sweep_run"] == 0
    for f in STATE_FIELDS:
        same(getattr(s_k, f), getattr(s_p, f), f)
        same(getattr(states0, f), getattr(before, f), ("left as it was", f))
    if not record:
        same(out_k, out_p, "selections")
        return
    slots = cuda.TRACE_SLOTS_PREEMPT if eng.preempts else cuda.TRACE_SLOTS_PLAIN
    assert len(out_k) == len(slots)
    for name, g, h in zip(slots, out_k, out_p):
        same(g, h, name)
    if eng.preempts:
        did = out_k[slots.index("did")]
        assert all(bool(did[v].any()) for v in range(3))


def test_k10_kernels_match_plain(host):
    """K10 (csrc/delta_kernels.cu): set, add (repeated indices, int32
    wrap) and vector add over bool, int32 and int64 planes with rows of
    rank 0 to 3; a zero-width plane launches nothing."""
    assert check_k10(torch.device("cpu"), scatter, seed=4) == 35
    assert scatter.LAUNCHES == {"delta_scatter_set": 12, "delta_scatter_add": 8,
                                "delta_vec_add": 8}
    assert not any(scatter.PLAIN_CALLS.values())


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_delta_passes_through_the_k10_kernels(host, policy):
    """Arrivals from the delta templates, binds and a cordon: each delta
    pass goes through the kernels, and the retained encoding equals a
    from-scratch encode."""
    store = ResourceStore()
    cfg = SchedulerConfiguration.default()
    for i in range(4):
        store.apply("nodes", {"metadata": {"name": f"n{i}", "labels": {
            "zone": "a" if i % 2 else "b", "kubernetes.io/hostname": f"n{i}"}},
            "status": {"allocatable": {"cpu": "8", "memory": "16Gi", "pods": "110"}}})
    for j, t in enumerate(TEMPLATES * 2):  # 10 pods: the 16-pod bucket holds the arrivals
        store.apply("pods", from_template(t, f"{t['metadata']['name']}-seed{j}"))
    delta = DeltaEncoder(policy=POLICIES[policy], device="cpu")
    assert delta.encode(store, cfg)[1]["mode"] == "full"
    for k in range(6):
        store.apply("pods", from_template(TEMPLATES[k % len(TEMPLATES)], f"a{k}"))
        seed_pod = f"{TEMPLATES[k % 5]['metadata']['name']}-seed{k % 5}"
        store.apply("pods", {"metadata": {"name": seed_pod}, "spec": {"nodeName": f"n{k % 4}"}})
        store.apply("nodes", {"metadata": {"name": f"n{k % 4}"},
                              "spec": {"unschedulable": k % 2 == 0}})
        scatter.reset_counts()
        _, info = delta.encode(store, cfg)
        assert info["mode"] == "delta", info
        assert scatter.LAUNCHES["delta_scatter_set"] > 0 and not any(scatter.PLAIN_CALLS.values())
        assert_port_equal(delta._st.enc, full_encode(store, cfg, delta.policy), k)


# -- K9: the gang kernels (csrc/gang_kernels.cu) ------------------------------

GANG_CASES = [("fit", "fit", None), ("rel", "slice", None), ("chain", "slice", None),
              ("preempt", None, "preempt"), ("rel", None, "rel")]
GANG_IDS = ["fit-cluster", "rel-cluster-slice", "chains-slice", "preempt-default",
            "rel-default"]


def gang_engine(policy, kind, config, preempt_kind, small=False, **opts):
    if small and kind == "rel":  # a whole pass: one round a carrier
        nodes, pods = rel_cluster(2, 12, 40)
        enc = kp.encode_cluster(nodes, pods, kp.affinity_config(), policy=POLICIES[policy],
                                namespaces=NAMESPACES, device="cpu")
    else:
        enc = (preempt_engine(policy, preempt_kind) if preempt_kind
               else engine(policy, kind, config)).enc
    g = kp.GangScheduler(enc, device="cpu", **opts)
    g._prep()
    return g


@pytest.mark.parametrize("kind,config,preempt_kind", GANG_CASES, ids=GANG_IDS)
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_gang_kernels_match_plain(host, policy, kind, config, preempt_kind):
    """gang_eval (score rows and trace rows), gang_topk, gang_match and
    gang_bind at random states and row lists, each against its plain
    version."""
    g = gang_engine(policy, kind, config, preempt_kind)
    enc, prog, a, w = g.enc, g._base.program, g.enc.arrays, g.weights
    N, C = enc.N, a.pod_claim.shape[1]
    rng = np.random.default_rng(11)
    i32 = torch.int32
    for k in range(2):
        st = random_state(enc, rng)
        rows = torch.as_tensor(rng.permutation(np.asarray(enc.queue))[:24].astype(np.int32))
        live = torch.tensor([20], dtype=i32)
        got = cuda.gang_eval(prog, a, st, w, rows, live, g._order)
        want = cuda.gang_eval_plain(prog, a, st, w, rows, live, g._order)
        same(got[:20], want[:20], (k, "scores"))
        assert bool((want[:20] > cuda._neg(want.dtype)).any()), "no feasible row"
        # the record form: trace rows at chosen slots, unpending pods too
        Q = len(enc.queue)
        slot = torch.as_tensor(rng.choice(Q, 24, replace=False).astype(np.int32))
        traces = []
        for fn in (cuda.gang_eval, cuda.gang_eval_plain):
            tr = (torch.zeros((Q, len(prog.prefilters)), dtype=i32),
                  torch.zeros((Q, N, len(prog.filters)), dtype=i32),
                  torch.zeros((Q, N, len(prog.scores)), dtype=prog.score_dtype),
                  torch.zeros((Q, N, len(prog.scores)), dtype=prog.score_dtype))
            fn(prog, a, st, w, rows, None, g._order, check_pending=False, slot=slot, trace=tr)
            traces.append(tr)
        for name, x, y in zip(("pf", "codes", "raw", "final"), *traces):
            same(x, y, (k, "trace", name))
        for mw in (1, 3, N):
            vals, idx = cuda.gang_topk(got, live, mw)
            pv, pi = cuda.gang_topk_plain(want, live, mw)
            same(vals[:20], pv[:20], (k, mw, "vals"))
            same(idx[:20], pi[:20], (k, mw, "idx"))
            for carrier in (None, g._carrier, torch.as_tensor(rng.random(enc.P) < 0.3)):
                for iters in (1, 64):
                    args = (rows, live, g._order, g._claims, carrier, N, C, iters)
                    ix = None if mw == N else idx
                    sel, stat = cuda.gang_match(vals if ix is not None else got, ix, *args)
                    psel, pstat = cuda.gang_match_plain(pv if ix is not None else want,
                                                        None if ix is None else pi, *args)
                    same(sel, psel, (k, mw, iters, "sel"))
                    same(stat, pstat, (k, mw, iters, "stat"))
            s1 = cuda.gang_bind(prog, a, st.clone(), rows, live, sel, g._order)
            s2 = cuda.gang_bind_plain(prog, a, st.clone(), rows, live, sel, g._order)
            for f in STATE_FIELDS:
                same(getattr(s1, f), getattr(s2, f), (k, mw, "bind", f))
    assert cuda.LAUNCHES["gang_match"] == 2 * 3 * 3 * 2
    assert not any(cuda.PLAIN_CALLS[x] for x in ("gang_eval", "gang_topk", "gang_match",
                                                   "gang_bind"))


@pytest.mark.parametrize("kind,config,preempt_kind", [GANG_CASES[1], GANG_CASES[3]],
                         ids=[GANG_IDS[1], GANG_IDS[3]])
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_gang_pass_matches_plain(host, monkeypatch, policy, kind, config, preempt_kind):
    """A whole gang pass through the kernels (rounds, preempt phases
    through seq_run with queue positions, the record replay) against the
    plain versions: final state, rounds and every record."""
    opts = dict(chunk=8, match_width=3, small=True)
    g = gang_engine(policy, kind, config, preempt_kind, **opts)
    got = g.results()
    assert cuda.LAUNCHES["gang_eval"] > 0 and cuda.LAUNCHES["gang_match"] > 0
    assert (cuda.LAUNCHES["seq_run"] > 0) == g.preempts
    with monkeypatch.context() as m:
        m.setattr(cuda, "_on_cpu", lambda x: True)  # the plain versions again
        p = gang_engine(policy, kind, config, preempt_kind, **opts)
        want = p.results()
    assert g._rounds == p._rounds and g.last_stats == p.last_stats
    for f in STATE_FIELDS:
        same(getattr(g._final_state, f), getattr(p._final_state, f), f)
    assert [(r.status, r.to_annotations()) for r in got] == [
        (r.status, r.to_annotations()) for r in want]


# -- the variant axis (the gang weight sweep) ----------------------------------


@pytest.mark.parametrize("kind,config,preempt_kind", GANG_CASES, ids=GANG_IDS)
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_stacked_gang_kernels_match_plain(host, policy, kind, config, preempt_kind):
    """The four K9 kernels at V = 3 (random per-variant states, weights and
    row lists; one variant frozen with live 0), one launch each, against
    their plain versions."""
    g = gang_engine(policy, kind, config, preempt_kind)
    assert check_stacked_gang(g, np.random.default_rng(19), torch.device("cpu"),
                              widths=(1, 3)) > 0
    assert cuda.LAUNCHES == {**dict.fromkeys(cuda.KERNELS, 0), "gang_eval": 1, "gang_topk": 2,
                             "gang_match": 6, "gang_bind": 3}
    assert not any(cuda.PLAIN_CALLS.values())


@pytest.mark.parametrize("kind", PREEMPT_KINDS)
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_segmented_sweep_matches_plain(host, policy, kind):
    """sweep_run over per-variant segments with queue positions (one a
    whole queue, one all padding, one every other pod) in one launch,
    against the plain version and each variant's own seq_run segment."""
    sel = check_segments(preempt_engine(policy, kind, seed=4), torch.device("cpu"))
    assert cuda.LAUNCHES["sweep_run"] == 1 and not any(cuda.PLAIN_CALLS.values())
    assert bool((sel[0] >= 0).any()) and bool((sel[1] == -1).all())


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_gang_sweep_matches_plain(host, monkeypatch, policy):
    """A whole GangSweep of three variants through the kernels (each round
    one launch of each K9 kernel, each preempt phase one sweep_run launch)
    against the plain versions: assignments, rounds and the sweep's
    counts."""
    enc = preempt_engine(policy, "preempt", seed=4).enc
    base = kp.weights_for(enc, {})
    w = np.stack([base, np.ones_like(base), base * 3 + 1])
    sweep = kp.GangSweep(enc, chunk=8, device="cpu")
    asg, rounds = sweep.run(w)
    st = sweep.last_stats
    assert st["phases"] > 0
    n_rounds = st["host_syncs"] - st["phases"]
    assert cuda.LAUNCHES["gang_eval"] == cuda.LAUNCHES["gang_bind"] == n_rounds
    assert cuda.LAUNCHES["sweep_run"] == st["phases"] and not any(cuda.PLAIN_CALLS.values())
    with monkeypatch.context() as m:
        m.setattr(cuda, "_on_cpu", lambda x: True)  # the plain versions again
        plain = kp.GangSweep(enc, chunk=8, device="cpu")
        want, want_rounds = plain.run(w)
    same(asg, want, "assignments")
    same(rounds, want_rounds, "rounds")
    assert plain.last_stats == st
