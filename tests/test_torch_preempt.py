"""DefaultPreemption in the PyTorch port against the reference engine.

The reference's preemption parity scenarios (test_engine_parity_preempt.py),
re-built from the same manifest builders and configurations, plus two of
the ranking's edges (a tie on all three keys; priority sums past 2^31), the
volume holders' evictions, and the whole default profile on a small
`preemption_cluster`. Each runs through the JAX engine and the port (plain
versions, CPU) under EXACT and TPU32. Compared: placements; every dense
trace tensor (padding rows included); each step's CSR victim records
against the reference's [N, P] victim masks; the final state;
every pod's status and annotations. Tolerance: exact equality.
"""

import dataclasses
import random

import numpy as np
import pytest

from kube_scheduler_simulator_tpu.engine import BatchedScheduler as JBatchedScheduler
from kube_scheduler_simulator_tpu.engine import encode_cluster as j_encode_cluster
from kube_scheduler_simulator_tpu.engine.engine import TRACE_SLOTS_PREEMPT as J_SLOTS
from kube_scheduler_simulator_tpu.sched.config import SchedulerConfiguration as JConfig

import kube_scheduler_simulator_tpu_torch as kp
from kube_scheduler_simulator_tpu_torch.engine import cuda
from kube_scheduler_simulator_tpu_torch.engine.encode import SchedState
from kube_scheduler_simulator_tpu_torch.sched.config import SchedulerConfiguration as PConfig

from helpers import node, pod
from test_engine_parity_preempt import preempt_config, row_config
from test_torch_encode import POLICIES

# the trace slots both engines record densely, one row per step
DENSE = ("pf_codes", "codes", "raw", "final", "sel", "did", "pcode", "nominated", "codes2",
         "raw2", "final2", "sel2", "pcode2", "nominated2", "final_sel")


def assert_same(name, ref, got):
    ref = np.asarray(ref)
    got = got.cpu().numpy()
    assert got.dtype == ref.dtype, (name, got.dtype, ref.dtype)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    assert np.array_equal(got, ref), (name, np.argwhere(got != ref)[:5])


def assert_preempt_traces_agree(j_trace, p_trace, P):
    """The port's trace (engine/cuda.py TRACE_SLOTS_PREEMPT) against the
    reference's dense one."""
    ref = dict(zip(J_SLOTS, (np.asarray(x) for x in j_trace)))
    got = dict(zip(cuda.TRACE_SLOTS_PREEMPT, p_trace))
    for name in DENSE:
        assert_same(name, ref[name], got[name])
    voff, vidx = got["voff"], got["vidx"]
    assert tuple(voff.shape) == ref["pcode"].shape[:1] + (2, ref["pcode"].shape[1] + 1)
    # one contiguous victim list: each record starts where the last ended
    starts = voff[:, :, 0].flatten().tolist()
    ends = voff[:, :, -1].flatten().tolist()
    assert starts == ([0] + ends[:-1] if starts else []) and (ends[-1] if ends else 0) == len(vidx)
    for j, name in ((0, "vmask"), (1, "vmask2")):
        for qi in range(len(voff)):
            mask = cuda.csr_mask(voff[qi, j], vidx, P).numpy()
            assert np.array_equal(mask, ref[name][qi]), (name, qi)


def assert_full_engines_agree(j_eng, p_eng):
    """Trace, final state, placements and every pod's record; returns the
    port's records."""
    j_state, j_trace = j_eng.run()
    p_state, p_trace = p_eng.run()
    if p_eng.preempts:
        assert len(p_trace) == len(cuda.TRACE_SLOTS_PREEMPT)
        assert_preempt_traces_agree(j_trace, p_trace, p_eng.enc.P)
    else:
        assert len(j_trace) == len(p_trace) == len(cuda.TRACE_SLOTS_PLAIN)
        for name, w, h in zip(cuda.TRACE_SLOTS_PLAIN, j_trace, p_trace):
            assert_same(name, w, h)
    for f in dataclasses.fields(SchedState):
        assert_same(f.name, getattr(j_state, f.name), getattr(p_state, f.name))
    assert p_eng.placements() == j_eng.placements()
    want, got = j_eng.results(), p_eng.results()
    assert [(r.pod_namespace, r.pod_name, r.status) for r in got] == [
        (r.pod_namespace, r.pod_name, r.status) for r in want]
    for w, g in zip(want, got):
        assert g.to_annotations() == w.to_annotations(), w.pod_name
    return got


# reference engines by compile signature: a scenario whose encoding has an
# equal signature reuses the compiled program (`retarget`)
_J_ENGINES: dict = {}


def run_both(nodes, pods, cfg: dict, policy: str, **objects):
    """The JAX engine and the port on the same cluster; asserts they agree
    and returns the port's records."""
    j_pol, p_pol = POLICIES[policy]
    j_enc = j_encode_cluster(nodes, pods, JConfig.from_dict(cfg), policy=j_pol, **objects)
    sig = JBatchedScheduler.compile_signature(j_enc)
    j_eng = _J_ENGINES.get(sig)
    j_eng = j_eng.retarget(j_enc) if j_eng is not None else JBatchedScheduler(j_enc)
    _J_ENGINES[sig] = j_eng
    p_enc = kp.encode_cluster(nodes, pods, PConfig.from_dict(cfg), policy=p_pol,
                              device="cpu", **objects)
    return assert_full_engines_agree(j_eng, kp.BatchedScheduler(p_enc, device="cpu"))


# -- the reference's scenarios -----------------------------------------------


def _basic():
    nodes = [node("n0", cpu="2"), node("n1", cpu="2")]
    pods = [pod("low-a", cpu="1500m", priority=1, node_name="n0"),
            pod("low-b", cpu="1500m", priority=1, node_name="n1"),
            pod("high", cpu="1500m", priority=100)]
    return nodes, pods, {}, [("Nominated", "n0"), ("Scheduled", "")]


def _rank():
    nodes = [node("n0", cpu="2"), node("n1", cpu="2")]
    pods = [pod("vip", cpu="1500m", priority=50, node_name="n0"),
            pod("pleb", cpu="1500m", priority=1, node_name="n1"),
            pod("high", cpu="1500m", priority=100)]
    return nodes, pods, {}, [("Nominated", "n1"), ("Scheduled", "")]


def _reprieve():
    nodes = [node("n0", cpu="3", pods="10")]
    pods = [pod("small", cpu="500m", priority=1, node_name="n0"),
            pod("big", cpu="2", priority=2, node_name="n0"),
            pod("high", cpu="2500m", priority=100)]
    return nodes, pods, {}, [("Nominated", "n0"), ("Scheduled", "")]


def _no_lower():
    nodes = [node("n0", cpu="1")]
    pods = [pod("equal", cpu="800m", priority=100, node_name="n0"),
            pod("high", cpu="800m", priority=100)]
    return nodes, pods, {}, [("Unschedulable", "")]


def _would_not_help():
    nodes = [node("n0", cpu="1")]
    pods = [pod("low", cpu="500m", priority=1, node_name="n0"),
            pod("huge", cpu="4", priority=100)]
    return nodes, pods, {}, [("Unschedulable", "")]


def _priorityclass():
    nodes = [node("n0", cpu="2")]
    pcs = [{"metadata": {"name": "critical"}, "value": 1000},
           {"metadata": {"name": "batch"}, "value": 1, "globalDefault": True}]
    pods = [pod("old", cpu="1500m", node_name="n0"),
            pod("vip", cpu="1500m", priority_class="critical")]
    return nodes, pods, {"priorityclasses": pcs}, [("Nominated", "n0"), ("Scheduled", "")]


def _cascade():
    nodes = [node("n0", cpu="2"), node("n1", cpu="2")]
    pods = [pod("l0", cpu="1500m", priority=1, node_name="n0"),
            pod("l1", cpu="1500m", priority=2, node_name="n1"),
            pod("h0", cpu="1500m", priority=100),
            pod("h1", cpu="1500m", priority=100)]
    return nodes, pods, {}, None


def _randomized(seed):
    def build():
        rng = random.Random(4000 + seed)
        n_nodes = rng.randint(2, 5)
        nodes = [node(f"n{i}", cpu=f"{rng.randint(1, 4)}") for i in range(n_nodes)]
        pods = []
        for i in range(rng.randint(2, 6)):
            pods.append(pod(f"f{i}", cpu=f"{rng.choice([500, 1000, 1500])}m",
                            priority=rng.randint(0, 10),
                            node_name=f"n{rng.randint(0, n_nodes - 1)}"))
        for i in range(rng.randint(3, 8)):
            pods.append(pod(f"p{i}", cpu=f"{rng.choice([500, 1000, 2000])}m",
                            priority=rng.choice([0, 5, 50, 100])))
        return nodes, pods, {}, None
    return build


def _tie():
    """Nodes 1 and 2 tie on all three keys (one victim of priority 3 each);
    node 0's victim has a higher priority: the lower index of the tie."""
    nodes = [node(f"n{i}", cpu="2") for i in range(3)]
    pods = [pod("v0", cpu="1500m", priority=7, node_name="n0"),
            pod("v1", cpu="1500m", priority=3, node_name="n1"),
            pod("v2", cpu="1500m", priority=3, node_name="n2"),
            pod("high", cpu="1500m", priority=100)]
    return nodes, pods, {}, [("Nominated", "n1"), ("Scheduled", "")]


def _wide_sums(all_past):
    """Victim priorities of 1.5e9: every candidate's priority sum passes
    2^31 (a 32-bit sum would wrap). With `all_past` False one node's sum
    stays below the int32 max and wins; with it True every sum exceeds the
    int32 max the reference minimises against, and it nominates no node
    (where the pure-Python oracle would)."""
    def build():
        nodes = [node(f"n{i}", cpu="2") for i in range(3)]
        b = 600_000_000 if not all_past else 1_400_000_000
        pods = [pod("a0", cpu="1", priority=1_500_000_000, node_name="n0"),
                pod("a1", cpu="1", priority=1_500_000_000, node_name="n0"),
                pod("b0", cpu="1", priority=1_500_000_000, node_name="n1"),
                pod("b1", cpu="1", priority=b, node_name="n1"),
                pod("c0", cpu="1", priority=1_500_000_000, node_name="n2"),
                pod("c1", cpu="1", priority=1_500_000_000, node_name="n2"),
                pod("critical", cpu="2", priority=2_000_000_000)]
        want = [("Unschedulable", "")] if all_past else [("Nominated", "n1"), ("Scheduled", "")]
        return nodes, pods, {}, want
    return build


PORTS = [{"containerPort": 80, "hostPort": 80}]


def _ports_holder(holder_priority):
    def build():
        nodes = [node("n0", cpu="4")]
        pods = [pod("holder", cpu="100m", priority=holder_priority, node_name="n0",
                    ports=PORTS),
                pod("high", cpu="100m", priority=100, ports=PORTS)]
        want = ([("Nominated", "n0"), ("Scheduled", "")] if holder_priority < 100
                else [("Unschedulable", "")])
        return nodes, pods, {}, want
    return build


def _spread_row():
    spread = [{"maxSkew": 1, "topologyKey": "zone", "whenUnsatisfiable": "DoNotSchedule",
               "labelSelector": {"matchLabels": {"app": "x"}}}]
    nodes = [node("n0", cpu="1", labels={"zone": "z0"}),
             node("n1", cpu="1", labels={"zone": "z1"})]
    pods = [pod("a1", cpu="600m", priority=1, node_name="n0", labels={"app": "x"}),
            pod("a2", cpu="400m", priority=1, node_name="n0", labels={"app": "x"}),
            pod("b1", cpu="1", priority=1, node_name="n1", labels={"app": "x"}),
            pod("hi", cpu="500m", priority=10, labels={"app": "x"}, spread=spread)]
    return nodes, pods, {}, None


def _interpod_row():
    anti = {"podAntiAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": [{
        "topologyKey": "kubernetes.io/hostname",
        "labelSelector": {"matchLabels": {"app": "db"}}}]}}
    nodes = [node("n0", cpu="4", labels={"kubernetes.io/hostname": "n0"})]
    pods = [pod("dbpod", cpu="100m", priority=1, node_name="n0", labels={"app": "db"}),
            pod("high", cpu="100m", priority=100, affinity=anti)]
    return nodes, pods, {}, [("Nominated", "n0"), ("Scheduled", "")]


def _config(kind):
    if kind == "fit":
        return preempt_config().to_dict()
    if kind == "ports":
        return row_config(("NodeResourcesFit", "NodePorts"),
                          prefilters=("NodeResourcesFit", "NodePorts")).to_dict()
    if kind == "spread":
        return row_config(("NodeResourcesFit", "PodTopologySpread")).to_dict()
    if kind == "interpod":
        return row_config(("NodeResourcesFit", "InterPodAffinity")).to_dict()
    return kp.supported_config().to_dict()


SCENARIOS = {
    "basic": ("fit", _basic),
    "rank": ("fit", _rank),
    "reprieve": ("fit", _reprieve),
    "no-lower": ("fit", _no_lower),
    "would-not-help": ("fit", _would_not_help),
    "priorityclass": ("fit", _priorityclass),
    "cascade": ("fit", _cascade),
    **{f"randomized-{s}": ("fit", _randomized(s)) for s in range(5)},
    "tie": ("fit", _tie),
    "sums-past-2^31": ("fit", _wide_sums(False)),
    "sums-past-int32-max": ("fit", _wide_sums(True)),
    "ports-holder": ("ports", _ports_holder(1)),
    "ports-holder-higher": ("ports", _ports_holder(200)),
    "spread-row": ("spread", _spread_row),
    "interpod-row": ("interpod", _interpod_row),
}


# Every scenario pads to these capacities (masked rows), so the scenarios of
# one configuration share their tensor shapes and the reference compiles
# one program for them (its persistent compile cache).
CAPACITY = {"node_capacity": 8, "pod_capacity": 16}


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_preemption_matches_reference(scenario, policy):
    kind, build = SCENARIOS[scenario]
    nodes, pods, objects, want = build()
    got = run_both(nodes, pods, _config(kind), policy, **CAPACITY, **objects)
    if want is not None:
        last = [r for r in got if r.pod_name == pods[-1]["metadata"]["name"]]
        assert [(r.status, r.nominated_node) for r in last] == want


def test_step_path_reproduces_the_pass():
    """The single-pod step path (attempt_fn, preempt_fn, evict_fn, bind_fn)
    over a preemption_cluster's queue reproduces the pass's trace rows and
    final state."""
    nodes, pods, objects = kp.preemption_cluster(16, 100, seed=2)
    eng = kp.BatchedScheduler(
        kp.encode_cluster(nodes, pods, kp.supported_config(), device="cpu", **objects),
        device="cpu")
    state_k, tr = eng.run()
    t = dict(zip(cuda.TRACE_SLOTS_PREEMPT, tr))
    a, w, st = eng.enc.arrays, eng.weights, eng.enc.state0.clone()
    n_fired = 0
    for qi, p in enumerate(eng.enc.queue.tolist()):
        pf, codes, raw, final, sel, pf_ok = eng.attempt_fn(a, st, w, p)
        for name, got in (("pf_codes", pf), ("codes", codes), ("raw", raw), ("final", final),
                          ("sel", sel)):
            assert np.array_equal(got.numpy(), t[name][qi].numpy()), (qi, name)
        final_sel = sel
        if int(sel) < 0 and bool(pf_ok) and bool(a.pod_mask[p]):
            pcode, off, idx, nom = eng.preempt_fn(a, st, p)
            assert np.array_equal(pcode.numpy(), t["pcode"][qi].numpy())
            rec = t["vidx"][t["voff"][qi, 0, 0]:t["voff"][qi, 0, -1]]
            assert np.array_equal(idx.numpy(), rec.numpy())
            if int(nom) >= 0:
                mask = cuda.csr_mask(off, idx, eng.enc.P)[int(nom)]
                eng.evict_fn(a, st, mask)
                final_sel = eng.attempt_fn(a, st, w, p)[4]
            assert int(nom) == int(t["nominated"][qi])
            n_fired += 1
        assert int(final_sel) == int(t["final_sel"][qi])
        eng.bind_fn(a, st, p, final_sel, qi)
    assert n_fired == int(t["did"].sum()) > 0
    for f in dataclasses.fields(SchedState):
        assert np.array_equal(getattr(st, f.name).numpy(), getattr(state_k, f.name).numpy())
