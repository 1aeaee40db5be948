"""The port's gang record path against the reference's.

`results()` of the port's GangScheduler (plain versions, CPU) must give
the reference GangScheduler's records byte for byte — status, nominated
node, victims and the 13 annotations of every record, in order — on the
cases of test_gang_records.py and the leftovers of a configuration
without preemption; and `run_recorded()` must place exactly as `run()`.
TPU32 and EXACT. Tolerance: exact equality. The one-pod cluster and a
phase followed by resumed rounds are in test_torch_gang_records_small.py,
a small `preemption_cluster` in test_torch_gang_records_preempt.py (each
file under a minute alone).
"""

import numpy as np
import pytest

from kube_scheduler_simulator_tpu.engine.engine import BatchedScheduler as JBatchedScheduler
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
# test_synthetic_cluster_records's cluster: the subset and windowed cases
# share its shape, so the reference's programs are traced once for the three
SYNTHETIC = (16, 64, 9)


def record(r):
    return (r.pod_namespace, r.pod_name, r.status, r.selected_node, r.nominated_node,
            r.preemption_victims, r.to_annotations())


# The reference's record-path programs by the recorder's compile signature:
# its recorder engine, chunk evaluator and replay round. `retarget` drops
# them with the encoding; an encoding of the same signature (the same
# cluster shape, whatever the gang options) takes them back, as
# `BatchedScheduler.retarget`'s contract allows, instead of tracing them
# again.
_J_RECORDERS: dict = {}


def j_results(j, pods_subset):
    """The reference gang engine's records, its record-path programs
    reused across encodings of one signature."""
    key = JBatchedScheduler.compile_signature(j.enc, record=True)
    held = _J_RECORDERS.get(key)
    if held is not None and j._rec is None:
        rec, j._eval_rec, j._replay_round = held
        j._rec = rec.retarget(j.enc)
    out = j.results(pods_subset)
    _J_RECORDERS[key] = (j._rec, j._eval_rec, j._replay_round)
    return out


def records_both(nodes, pods, cfg, policy, objects=None, pods_subset=None, **opts):
    """Both engines' records of one cluster, equal record for record; the
    port's run_recorded() places as its run() does. Returns the port's
    engine."""
    j_enc, p_enc = encodings(nodes, pods, cfg, policy, objects)
    j = j_gang(j_enc, opts)
    want = j_results(j, pods_subset)
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
def test_synthetic_cluster_records(policy):
    nodes, pods = synthetic_cluster(*SYNTHETIC[:2], seed=SYNTHETIC[2])
    p = records_both(nodes, pods, DEFAULT_CFG, policy, chunk=32)
    assert sum(1 for v in p.placements().values() if v) > 0


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_preemption_phase_records(policy):
    nodes, pods = all_need_eviction()
    p = records_both(nodes, pods, PREEMPT_CFG, policy)
    assert any(r.status == "Nominated" and r.preemption_victims for r in p.results())


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
    n, m, seed = SYNTHETIC
    nodes, pods = synthetic_cluster(n, m, seed=seed)
    some = {("default", pods[i]["metadata"]["name"]) for i in (1, 5, 11, 40)}
    records_both(nodes, pods, DEFAULT_CFG, policy, pods_subset=some, chunk=32)


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_windowed_records(policy):
    n, m, seed = SYNTHETIC
    nodes, pods = synthetic_cluster(n, m, seed=seed)
    records_both(nodes, pods, DEFAULT_CFG, policy, chunk=8, eval_window=8)
