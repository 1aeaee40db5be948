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
from test_torch_cuda import STATE_FIELDS, check_k10, cluster
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
    into one shared library; returns its path."""
    (d / "cuda_runtime.h").write_text(HOST_CUDA)
    host_srcs = []
    for src in srcs:
        host_src = d / f"{src.stem}_host.cpp"
        # a launch `k<<<grid, block, smem, stream>>>(args)` becomes the call k(args)
        host_src.write_text(re.sub(r"<<<.*?>>>", "", src.read_text()))
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


def random_state(enc, rng):
    """Usage up to 130% of capacity, port counters of 0..2 users and about
    half the pending pods bound, mostly to the first third of the nodes."""
    st = enc.state0.clone()
    alloc = enc.arrays.node_alloc
    for f in ("requested", "s_requested"):
        frac = torch.as_tensor(rng.uniform(0.0, 1.3, tuple(alloc.shape)))
        setattr(st, f, torch.floor(alloc * frac).to(alloc.dtype))
    st.n_pods = torch.as_tensor(rng.integers(0, 112, enc.N), dtype=torch.int32)
    for f in ("used_pair", "used_wild", "used_trip"):
        shape = tuple(getattr(st, f).shape)
        setattr(st, f, torch.as_tensor(rng.integers(0, 3, shape), dtype=torch.int32))
    asg = st.assignment.numpy().copy()
    free = (asg < 0) & (rng.random(asg.shape) < 0.5)
    free[enc.n_pods:] = False
    hi = np.where(rng.random(int(free.sum())) < 0.8, max(1, enc.n_nodes // 3), enc.n_nodes)
    asg[free] = rng.integers(0, hi)
    st.assignment = torch.as_tensor(asg)
    return st


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
