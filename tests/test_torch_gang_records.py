"""The port's gang record path against the reference's.

`results()` of the port's GangScheduler (plain versions, CPU) must give
the reference GangScheduler's records byte for byte — status, nominated
node, victims and the 13 annotations of every record, in order — on the
cases of test_gang_records.py, a phase followed by resumed rounds, the
leftovers of a configuration without preemption and a small
`preemption_cluster`; and `run_recorded()` must place exactly as `run()`.
TPU32 and EXACT. Tolerance: exact equality.
"""

import numpy as np
import pytest

from kube_scheduler_simulator_tpu.engine.engine import supported_config as j_supported_config

import kube_scheduler_simulator_tpu_torch as kp
from kube_scheduler_simulator_tpu_torch.synth import synthetic_cluster

from helpers import node, pod
from test_torch_gang import (
    FIT_CFG,
    PREEMPT_CFG,
    all_need_eviction,
    assert_states_equal,
    encodings,
    j_gang,
)
from test_torch_encode import POLICIES

DEFAULT_CFG = j_supported_config().to_dict()


def record(r):
    return (r.pod_namespace, r.pod_name, r.status, r.selected_node, r.nominated_node,
            r.preemption_victims, r.to_annotations())


def records_both(nodes, pods, cfg, policy, objects=None, pods_subset=None, **opts):
    """Both engines' records of one cluster, equal record for record; the
    port's run_recorded() places as its run() does. Returns the port's
    engine."""
    j_enc, p_enc = encodings(nodes, pods, cfg, policy, objects)
    j = j_gang(j_enc, opts)
    want = j.results(pods_subset)
    p = kp.GangScheduler(p_enc, device="cpu", **opts)
    got = p.results(pods_subset)
    assert [record(r) for r in got] == [record(r) for r in want]
    assert_states_equal(j._final_state, p._final_state, opts)
    plain = kp.GangScheduler(p_enc, device="cpu", **opts)
    state, rounds = plain.run()
    assert rounds == p._rounds and plain.placements() == p.placements()
    assert np.array_equal(state.assignment.numpy(), p._final_state.assignment.numpy())
    return p


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_single_pod_record(policy):
    nodes = [node(f"n{i}", cpu="4", pods="8") for i in range(3)]
    records_both(nodes, [pod("solo", cpu="1")], DEFAULT_CFG, policy)


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_synthetic_cluster_records(policy):
    nodes, pods = synthetic_cluster(16, 64, seed=9)
    p = records_both(nodes, pods, DEFAULT_CFG, policy, chunk=32)
    assert sum(1 for v in p.placements().values() if v) > 0


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_preemption_phase_records(policy):
    nodes, pods = all_need_eviction()
    p = records_both(nodes, pods, PREEMPT_CFG, policy)
    assert any(r.status == "Nominated" and r.preemption_victims for r in p.results())


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_phase_then_resumed_rounds_records(policy):
    nodes = [node("n0", cpu="2", pods="8"), node("n1", cpu="2", pods="8"),
             node("n2", cpu="1", pods="8")]
    pods = [pod("low-0", cpu="1800m", priority=1, node_name="n0"),
            pod("low-1", cpu="1800m", priority=1, node_name="n1"),
            pod("high-0", cpu="1500m", priority=100), pod("high-1", cpu="1500m", priority=100),
            pod("small", cpu="500m", priority=50), pod("small2", cpu="600m", priority=50)]
    p = records_both(nodes, pods, PREEMPT_CFG, policy)
    kinds = [e[0] for e in p._chronology]
    assert kinds[:3] == ["rounds", "phase", "rounds"], kinds


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_contended_records_and_leftovers(policy):
    """Two pods contend for each node and two never fit (no preemption):
    the losers' records show their committed node, the leftovers' why
    every node fails."""
    nodes = [node("a", cpu="2", pods="8"), node("b", cpu="2", pods="8")]
    pods = [pod(f"p{i}", cpu="1") for i in range(4)] + [pod("big0", cpu="9"),
                                                        pod("big1", cpu="9")]
    p = records_both(nodes, pods, FIT_CFG, policy)
    assert p._chronology[-1][0] == "leftover"


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_subset_decode(policy):
    nodes, pods = synthetic_cluster(8, 24, seed=3)
    some = {("default", pods[i]["metadata"]["name"]) for i in (1, 5, 11)}
    records_both(nodes, pods, DEFAULT_CFG, policy, pods_subset=some)


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_windowed_records(policy):
    nodes, pods = synthetic_cluster(8, 48, seed=6)
    records_both(nodes, pods, DEFAULT_CFG, policy, chunk=8, eval_window=8)


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_small_preemption_cluster_records(policy):
    nodes, pods, objects = kp.preemption_cluster(12, 60, seed=5)
    p = records_both(nodes, pods, kp.supported_config().to_dict(), policy, objects, chunk=16)
    assert any(r.preemption_victims for r in p.results())
