"""The port's gang (fixpoint) engine against the reference's GangScheduler.

The scenarios of test_engine_gang.py, re-built from the same manifest
builders and configurations, plus a small `preemption_cluster`. Each runs
through the JAX GangScheduler and the port's (plain versions, CPU) under
EXACT and TPU32 with the same options. Compared: the rounds, every
final-state tensor (assignment, bind order, every node counter) and the
placements. Tolerance: exact equality. Reference engines are kept by
compile signature and options, so scenarios of one shape share a compile.
"""

import dataclasses

import numpy as np
import pytest

from kube_scheduler_simulator_tpu.engine import encode_cluster as j_encode_cluster
from kube_scheduler_simulator_tpu.engine.engine import supported_config as j_supported_config
from kube_scheduler_simulator_tpu.engine.gang import GangScheduler as JGang
from kube_scheduler_simulator_tpu.sched.config import SchedulerConfiguration as JConfig

import kube_scheduler_simulator_tpu_torch as kp
from kube_scheduler_simulator_tpu_torch.engine import cuda
from kube_scheduler_simulator_tpu_torch.engine.encode import SchedState
from kube_scheduler_simulator_tpu_torch.sched.config import SchedulerConfiguration as PConfig

from helpers import node, pod
from test_engine_parity import restricted_config
from test_engine_parity_preempt import preempt_config
from test_engine_parity_vol import claim_vol, pv, pvc, vol_config
from test_torch_encode import POLICIES

_J_ENGINES: dict = {}


def j_gang(j_enc, opts):
    """The reference engine for this encoding and these options, reused
    (`retarget`) where one with the same signature exists."""
    key = (JGang.compile_signature(j_enc),
           JGang.effective_window(j_enc, opts.get("eval_window"), opts.get("chunk", 256)),
           tuple(sorted(opts.items())))
    eng = _J_ENGINES.get(key)
    eng = eng.retarget(j_enc) if eng is not None else JGang(j_enc, **opts)
    _J_ENGINES[key] = eng
    return eng


def encodings(nodes, pods, cfg, policy, objects=None):
    """The reference's and the port's encodings of one cluster (cfg: a
    configuration dict)."""
    j_pol, p_pol = POLICIES[policy]
    objects = objects or {}
    j_enc = j_encode_cluster(nodes, pods, JConfig.from_dict(cfg), policy=j_pol, **objects)
    p_enc = kp.encode_cluster(nodes, pods, PConfig.from_dict(cfg), policy=p_pol, device="cpu",
                              **objects)
    return j_enc, p_enc


def assert_states_equal(j_state, p_state, what=""):
    for f in dataclasses.fields(SchedState):
        want = np.asarray(getattr(j_state, f.name))
        got = getattr(p_state, f.name).numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want), (what, f.name)


def run_both(nodes, pods, cfg, policy, objects=None, **opts):
    """Both gang engines on one cluster: rounds, final state and placements
    equal. Returns the port's engine (run)."""
    j_enc, p_enc = encodings(nodes, pods, cfg, policy, objects)
    j = j_gang(j_enc, opts)
    j_state, j_rounds = j.run()
    p = kp.GangScheduler(p_enc, device="cpu", **opts)
    p_state, p_rounds = p.run()
    assert p_rounds == int(np.asarray(j_rounds)), opts
    assert_states_equal(j_state, p_state, opts)
    assert p.placements() == j.placements()
    return p


def seq_placements(nodes, pods, cfg, policy, objects=None):
    _, p_enc = encodings(nodes, pods, cfg, policy, objects)
    eng = kp.BatchedScheduler(p_enc, record=False, device="cpu")
    eng.run()
    return eng.placements()


def cfg_dict(cfg):
    return cfg.to_dict()


PINNED_CFG = cfg_dict(restricted_config(
    filters=("NodeUnschedulable", "NodeName", "NodeAffinity", "NodeResourcesFit")))
FIT_CFG = cfg_dict(restricted_config())
PREEMPT_CFG = cfg_dict(preempt_config())


def pinned():
    nodes = [node(f"n{i}", labels={"k": f"v{i}"}) for i in range(6)]
    pods = [pod(f"p{i}", node_selector={"k": f"v{i}"}) for i in range(6)]
    return nodes, pods


def random_cluster(seed, n_nodes=8, n_pods=40, prio=True):
    rng = np.random.default_rng(seed)
    nodes = [node(f"n{i}", cpu=str(2 + int(rng.integers(3)))) for i in range(n_nodes)]
    pods = [pod(f"p{i}", cpu=f"{int(rng.integers(200, 900))}m",
                priority=int(rng.integers(3)) if prio else 0) for i in range(n_pods)]
    return nodes, pods


def rwop():
    nodes = [node("n0"), node("n1")]
    pods = [pod("first", priority=10, volumes=[claim_vol("solo")]),
            pod("second", priority=1, volumes=[claim_vol("solo")])]
    objects = dict(pvcs=[pvc("solo", modes=("ReadWriteOncePod",), volume_name="pv-s")],
                   pvs=[pv("pv-s")])
    return nodes, pods, objects


def all_need_eviction():
    nodes = [node(f"n{i}", cpu="2", pods="8") for i in range(4)]
    pods = [pod(f"low-{i}", cpu="1500m", priority=1, node_name=f"n{i}") for i in range(4)]
    pods += [pod(f"high-{i}", cpu="1200m", priority=100) for i in range(3)]
    return nodes, pods


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_no_contention_matches_sequential(policy):
    nodes, pods = pinned()
    p = run_both(nodes, pods, PINNED_CFG, policy)
    assert p.placements() == seq_placements(nodes, pods, PINNED_CFG, policy)
    assert p._rounds == 2  # one committing round, one empty
    assert p.last_stats["host_syncs"] == 2 and p.last_stats["phases"] == 0


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_contended_priority_order_and_capacity(policy):
    nodes = [node("n0", cpu="2"), node("n1", cpu="8", unschedulable=True)]
    pods = [pod("lo1", cpu="1", priority=1), pod("hi", cpu="1", priority=10),
            pod("lo2", cpu="1", priority=1), pod("lo3", cpu="1", priority=1)]
    got = run_both(nodes, pods, FIT_CFG, policy).placements()
    assert got[("default", "hi")] == got[("default", "lo1")] == "n0"
    assert got[("default", "lo2")] == got[("default", "lo3")] == ""
    assert got == seq_placements(nodes, pods, FIT_CFG, policy)


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_random_contended_cluster(policy):
    nodes, pods = random_cluster(3)
    p = run_both(nodes, pods, FIT_CFG, policy, chunk=16)
    placed = sum(1 for v in p.placements().values() if v)
    assert placed >= sum(1 for v in seq_placements(nodes, pods, FIT_CFG, policy).values() if v)


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_rwop_claim_single_winner(policy):
    nodes, pods, objects = rwop()
    cfg = cfg_dict(vol_config())
    for mw in (None, 1):
        got = run_both(nodes, pods, cfg, policy, objects, match_width=mw).placements()
        assert got[("default", "first")] != "" and got[("default", "second")] == ""


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_affinity_chain_resolves_across_rounds(policy):
    nodes = [node(f"n{i}", labels={"zone": "z"}) for i in range(2)]
    aff = {"podAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": [
        {"labelSelector": {"matchLabels": {"app": "frontend"}}, "topologyKey": "zone"}]}}
    pods = [pod("backend", affinity=aff), pod("frontend", labels={"app": "frontend"})]
    cfg = cfg_dict(restricted_config(
        filters=("NodeUnschedulable", "NodeResourcesFit", "InterPodAffinity"),
        prefilters=("NodeResourcesFit", "InterPodAffinity")))
    got = run_both(nodes, pods, cfg, policy).placements()
    assert got[("default", "frontend")] != "" and got[("default", "backend")] != ""
    assert seq_placements(nodes, pods, cfg, policy)[("default", "backend")] == ""


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_anti_affinity_carriers_take_exclusive_rounds(policy):
    """Every pod carries a required anti-affinity term against its own app
    (rel_serialize's carriers): one pod a round, in queue order, as the
    sequential engine places them."""
    nodes = [node(f"n{i}", labels={"zone": f"z{i % 3}"}) for i in range(6)]
    anti = {"podAntiAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": [
        {"labelSelector": {"matchLabels": {"app": "db"}}, "topologyKey": "zone"}]}}
    pods = [pod(f"db{i}", labels={"app": "db"}, affinity=anti, priority=i % 2)
            for i in range(5)] + [pod(f"web{i}") for i in range(4)]
    cfg = kp.affinity_config().to_dict()
    p = run_both(nodes, pods, cfg, policy)
    got = p.placements()
    assert sum(1 for k, v in got.items() if k[1].startswith("db") and v) == 3
    assert p._rounds >= 4
    run_both(nodes, pods, cfg, policy, rel_serialize=False)  # carriers batched


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_infeasible_pods_terminate(policy):
    nodes = [node("n0", cpu="1")]
    pods = [pod(f"p{i}", cpu="4") for i in range(10)]
    p = run_both(nodes, pods, FIT_CFG, policy)
    assert p._rounds == 1 and not any(p.placements().values())


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_full_default_config_runs_preemption_phase(policy):
    nodes = [node(f"n{i}") for i in range(3)]
    pods = [pod(f"p{i}") for i in range(5)]
    p = run_both(nodes, pods, j_supported_config().to_dict(), policy)
    assert p.skipped_postfilter == [] and p.preempts
    assert all(v != "" for v in p.placements().values())


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_preempt_phase_matches_sequential(policy):
    nodes, pods = all_need_eviction()
    p = run_both(nodes, pods, PREEMPT_CFG, policy)
    assert p.placements() == seq_placements(nodes, pods, PREEMPT_CFG, policy)
    assert p.last_stats["phases"] >= 1
    assert int((p._final_state.assignment < 0).sum()) > 0


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_preempt_phase_then_rounds_resume(policy):
    nodes = [node("n0", cpu="2", pods="8"), node("n1", cpu="2", pods="8"),
             node("n2", cpu="1", pods="8")]
    pods = [pod("low-0", cpu="1800m", priority=1, node_name="n0"),
            pod("low-1", cpu="1800m", priority=1, node_name="n1"),
            pod("high-0", cpu="1500m", priority=100),
            pod("high-1", cpu="1500m", priority=100),
            pod("small", cpu="500m", priority=50), pod("small2", cpu="600m", priority=50)]
    p = run_both(nodes, pods, PREEMPT_CFG, policy)
    got = p.placements()
    assert {got[("default", "high-0")], got[("default", "high-1")]} == {"n0", "n1"}
    assert p.last_stats["phases"] >= 1


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("opts", [{"match_width": 1}, {"chunk": 16, "match_width": 2},
                                  {"chunk": 8, "compact": False}, {"chunk": 4, "eval_window": 4},
                                  {"chunk": 4, "eval_window": 4, "compact": False},
                                  {"inner_iters": 1}, {"max_rounds": 2}],
                         ids=["mw1", "mw2", "compact-off", "window", "window-compact-off",
                              "iters1", "cap2"])
def test_options_on_a_contended_cluster(policy, opts):
    nodes, pods = random_cluster(9)
    run_both(nodes, pods, FIT_CFG, policy, **opts)


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_compact_is_bit_identical(policy):
    nodes, pods = random_cluster(17, 6, 30, prio=False)
    on = run_both(nodes, pods, FIT_CFG, policy, chunk=8, compact=True)
    off = run_both(nodes, pods, FIT_CFG, policy, chunk=8, compact=False)
    assert on.placements() == off.placements()


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_window_sweeps_past_a_blocked_prefix(policy):
    nodes = [node("n0", cpu="32", pods="110")]
    pods = [pod(f"big{i}", cpu="100", priority=100) for i in range(2)]
    pods += [pod(f"ok{i}", cpu="1", priority=1) for i in range(8)]
    p = run_both(nodes, pods, PINNED_CFG, policy, chunk=2, eval_window=2, rel_serialize=False,
                 max_rounds=12)
    got = p.placements()
    assert all(got[("default", f"ok{i}")] for i in range(8)) and p._rounds > 12
    capped = run_both(nodes, pods, PINNED_CFG, policy, chunk=2, eval_window=2,
                      rel_serialize=False, max_rounds=7)
    assert sum(1 for v in capped.placements().values() if v) == 7
    _, p_enc = encodings(nodes, pods, PINNED_CFG, policy)
    with pytest.raises(ValueError, match="dynamic per-pass commit budget"):
        kp.GangScheduler(p_enc, device="cpu", chunk=2, eval_window=2, max_rounds=4)
    with pytest.raises(ValueError, match="eval_window"):
        kp.GangScheduler(p_enc, device="cpu", eval_window=0)


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_small_preemption_cluster(policy):
    nodes, pods, objects = kp.preemption_cluster(12, 60, seed=5)
    p = run_both(nodes, pods, kp.supported_config().to_dict(), policy, objects, chunk=16)
    assert p.last_stats["phases"] == 2  # a phase, resumed rounds, a phase that binds nothing


def test_static_loops_are_not_ported():
    nodes, pods = pinned()
    _, p_enc = encodings(nodes, pods, PINNED_CFG, "i32")
    for kw in ({"loop": "static"}, {"inner_loop": "static"}, {"static_rounds": 8}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            kp.GangScheduler(p_enc, device="cpu", **kw)
    with pytest.raises(ValueError, match="loop"):
        kp.GangScheduler(p_enc, device="cpu", loop="banana")


def test_plain_versions_run_on_the_cpu_only():
    """On CPU tensors the wrappers take the plain versions; every gang
    launch counter stays 0."""
    nodes, pods = random_cluster(5, 6, 20)
    cuda.reset_counts()
    _, p_enc = encodings(nodes, pods, FIT_CFG, "i32")
    kp.GangScheduler(p_enc, device="cpu", match_width=2).run()
    assert all(cuda.LAUNCHES[k] == 0 for k in cuda.LAUNCHES)
    assert all(cuda.PLAIN_CALLS[k] > 0 for k in ("gang_eval", "gang_topk", "gang_match",
                                                    "gang_bind"))


def test_signature_leaves_out_the_queue_length():
    nodes, pods = random_cluster(5, 6, 20)
    _, a = encodings(nodes, pods, FIT_CFG, "i32")
    _, b = encodings(nodes, pods[:12] + [dict(p, spec={**p["spec"], "nodeName": "n0"})
                                         for p in pods[12:]], FIT_CFG, "i32")
    assert kp.GangScheduler.compile_signature(a) == kp.GangScheduler.compile_signature(b)
    assert kp.BatchedScheduler.compile_signature(a) != kp.BatchedScheduler.compile_signature(b)
    g = kp.GangScheduler(a, device="cpu")
    assert g.retarget(b).enc is b
