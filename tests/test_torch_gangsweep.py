"""The port's GangSweep against the reference's.

The same cluster and the same [V, S] weight matrix (numpy, shared) go
through the JAX package's `parallel.GangSweep` (on the CPU, as its own
tests run it) and the port's (plain versions, CPU). Compared: the
assignments [V, P], the rounds [V] and the decoded placements. Cases: a
contended random cluster under a fit-only profile (TPU32 and EXACT),
`eval_window` with per-variant window offsets, the preemption workloads
(every high pod must evict; test_torch_gangsweep_default.py runs a small
`preemption_cluster` under the whole default profile), and the
reference's lockstep rule: a settled
variant rides along through the phases and resumed passes of the others,
each resume giving it one more round. Tolerance: exact equality.

Each reference sweep compiles its vmapped programs once per instance, so
every case builds one and runs it once; the clusters stay small.
"""

import numpy as np
import pytest
import torch

from kube_scheduler_simulator_tpu.engine import encode_cluster as j_encode_cluster
from kube_scheduler_simulator_tpu.parallel import GangSweep as JGangSweep
from kube_scheduler_simulator_tpu.sched.config import SchedulerConfiguration as JConfig

import kube_scheduler_simulator_tpu_torch as kp
from kube_scheduler_simulator_tpu_torch.parallel import GangSweep, weights_for
from kube_scheduler_simulator_tpu_torch.sched.config import SchedulerConfiguration as PConfig

from helpers import node, pod
from test_engine_parity import restricted_config
from test_engine_parity_preempt import preempt_config
from test_torch_encode import POLICIES
from test_torch_gang import all_need_eviction, random_cluster


def prefer_zone(zone):
    return {"nodeAffinity": {"preferredDuringSchedulingIgnoredDuringExecution": [
        {"weight": 100, "preference": {"matchExpressions": [
            {"key": "zone", "operator": "In", "values": [zone]}]}}]}}


def two_nodes():
    """Two nodes of 2 CPUs in zones a and b; `low` (priority 1) bound on n1;
    `a` (priority 100, 1 CPU) prefers zone b, `b` (priority 50) needs 2
    CPUs. With NodeResourcesFit heavy, `a` takes n0, `b` must preempt `low`
    on n1 (a phase); with NodeAffinity heavy, both place in round 1."""
    nodes = [node("n0", cpu="2", labels={"zone": "a"}),
             node("n1", cpu="2", labels={"zone": "b"})]
    pods = [pod("low", cpu="1", priority=1, node_name="n1"),
            pod("a", cpu="1", priority=100, affinity=prefer_zone("b")),
            pod("b", cpu="2", priority=50)]
    return nodes, pods, {}


def small_default():
    return kp.preemption_cluster(6, 30, seed=1)


def fit_cluster():
    nodes, pods = random_cluster(3, n_nodes=6, n_pods=30)
    return nodes, pods, {}


def windowed_cluster():
    nodes, pods = kp.synthetic_cluster(8, 48, seed=9)
    return nodes, pods, {}


def contended():
    nodes, pods = all_need_eviction()
    return nodes, pods, {}


def offsets(b, n):
    return [b + 3 * i for i in range(n)]


# name -> (cluster, configuration, the weight rows from the base weights,
# GangSweep options)
CASES = {
    "fit": (fit_cluster, restricted_config, lambda b: offsets(b, 4), {}),
    "windowed": (windowed_cluster, restricted_config,
                 lambda b: [b, b * 4, np.asarray([1, 7], np.int32)],
                 dict(chunk=8, eval_window=8)),
    "evict": (contended, preempt_config, lambda b: offsets(b, 3), {}),
    "default": (small_default, kp.supported_config,
                lambda b: [b] + [np.eye(len(b), dtype=np.int32)[i] * 10 for i in (0, 3)], {}),
    "lockstep": (two_nodes, kp.supported_config, None, dict(chunk=16)),
}
LOCKSTEP = [{"NodeAffinity": 1, "NodeResourcesFit": 10},
            {"NodeAffinity": 10, "NodeResourcesFit": 1}]


def encodings(case, policy):
    nodes, pods, objects = CASES[case][0]()
    cfg = CASES[case][1]().to_dict()
    j_pol, p_pol = POLICIES[policy]
    j_enc = j_encode_cluster(nodes, pods, JConfig.from_dict(cfg), policy=j_pol, **objects)
    p_enc = kp.encode_cluster(nodes, pods, PConfig.from_dict(cfg), policy=p_pol, device="cpu",
                              **objects)
    return j_enc, p_enc


def weight_matrix(p_enc, case):
    if case == "lockstep":
        return np.stack([weights_for(p_enc, ov) for ov in LOCKSTEP])
    return np.stack(CASES[case][2](weights_for(p_enc, {}))).astype(np.int32)


def run_both(case, policy):
    """Both sweeps on one case: assignments, rounds and placements equal.
    Returns (the port's sweep, its assignments, its rounds)."""
    j_enc, p_enc = encodings(case, policy)
    w = weight_matrix(p_enc, case)
    opts = CASES[case][3]
    j = JGangSweep(j_enc, **opts)
    j_asg, j_rounds = j.run(w)
    p = GangSweep(p_enc, device="cpu", **opts)
    asg, rounds = p.run(w)
    assert asg.dtype == torch.int32 and rounds.dtype == torch.int32
    np.testing.assert_array_equal(asg.numpy(), np.asarray(j_asg))
    np.testing.assert_array_equal(rounds.numpy(), np.asarray(j_rounds))
    assert p.placements(asg) == j.placements(j_asg)
    return p, asg, rounds


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_contended_fit_sweep_matches_reference(policy):
    p, asg, _ = run_both("fit", policy)
    assert p.last_stats["phases"] == 0
    placed = [(a >= 0).sum() for a in asg[:, :30].numpy()]
    assert min(placed) < 30  # contended: some pod stays pending in every variant


def test_windowed_sweep_matches_reference():
    """eval_window under the variant axis: each variant its own window
    offset, as the reference's vmapped row-subset rounds."""
    p, asg, rounds = run_both("windowed", "i32")
    for placed in p.placements(asg):
        assert all(placed.values())
    assert int(rounds.min()) > 1


def check_preempting(case):
    p, _, _ = run_both(case, "i32")
    st = p.last_stats
    assert st["phases"] > 0 and all(n > 0 for n in st["phase_pods"])
    return p


def test_preempting_sweep_matches_reference():
    """Every high-priority pod must evict a low one, in every variant
    (test_torch_gangsweep_default.py holds the whole default profile)."""
    check_preempting("evict")


def test_lockstep_rounds_match_reference():
    """Variant 0 needs a preempt phase (`b` evicts `low`); variant 1 places
    both pods in round 1 and has nothing pending. The reference resumes
    every variant after a phase, so variant 1 counts one more round than
    a lone GangScheduler does: rounds [3, 3] against 2."""
    p, asg, rounds = run_both("lockstep", "i32")
    assert rounds.tolist() == [3, 3]
    assert p.last_stats["phase_bound"] == [[1, 0]]
    w = weight_matrix(p.enc, "lockstep")
    for v, want_rounds in ((0, 3), (1, 2)):
        g = kp.GangScheduler(p.enc, chunk=16, device="cpu")
        state, n = g.run(w[v])
        assert n == want_rounds
        assert torch.equal(state.assignment, asg[v])


def test_held_run_replays_a_variant_of_a_longer_sweep():
    """A one-variant sweep held to the two-variant sweep's phases and passes
    gives that variant's assignment and rounds: variant 1 alone, held to
    one phase and two passes, counts 3."""
    _, p_enc = encodings("lockstep", "i32")
    w = weight_matrix(p_enc, "lockstep")
    both = GangSweep(p_enc, chunk=16, device="cpu")
    asg2, rounds2 = both.run(w)
    assert (both.last_stats["phases"], both.last_stats["passes"]) == (1, 2)
    solo = GangSweep(p_enc, chunk=16, device="cpu")
    assert solo.run(w[1:])[1].tolist() == [2]
    solo._hold = (both.last_stats["phases"], both.last_stats["passes"])
    asg, rounds = solo.run(w[1:])
    assert rounds.tolist() == [3] and solo.last_stats["phase_bound"] == [[0]]
    assert torch.equal(asg[0], asg2[1])


def test_groups_change_nothing():
    """Variants run in groups (here one at a time) when their round buffers
    do not fit together: the same assignments, rounds and phases."""
    _, p_enc = encodings("default", "i32")
    w = weight_matrix(p_enc, "default")
    whole = GangSweep(p_enc, device="cpu")
    asg, rounds = whole.run(w)
    parts = GangSweep(p_enc, device="cpu")
    parts._group_cap = 1
    asg1, rounds1 = parts.run(w)
    assert torch.equal(asg, asg1) and torch.equal(rounds, rounds1)
    assert parts.last_stats["groups"] == [3] * len(parts.last_stats["groups"])
    assert whole.last_stats["groups"] == [1] * len(whole.last_stats["groups"])
    assert parts.last_stats["phase_bound"] == whole.last_stats["phase_bound"]


def test_rejections():
    """A mesh is not ported; a weight matrix of the wrong shape raises the
    reference's ValueError. (The counted loop is ported:
    tests/test_torch_gang_static.py.)"""
    _, p_enc = encodings("evict", "i32")
    with pytest.raises(NotImplementedError, match="mesh"):
        GangSweep(p_enc, mesh=object(), device="cpu")
    assert GangSweep(p_enc, loop="static", device="cpu").gang.loop == "static"
    sweep = GangSweep(p_enc, device="cpu")
    S = len(weights_for(p_enc, {}))
    for bad in (np.ones((S,), np.int32), np.ones((2, S + 1), np.int32)):
        with pytest.raises(ValueError, match=rf"weight matrix must be \[V, {S}\]"):
            sweep.run(bad)


def test_gang_sweep_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, p_enc = encodings("evict", "i32")
    with pytest.raises(RuntimeError, match="CUDA"):
        GangSweep(p_enc)
