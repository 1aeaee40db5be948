"""The port's counted gang loops against the reference's.

`loop="static"` (the counted round loop: exactly `static_rounds` round
slots a pass, rounds = the slots that progressed, the host's auto-resume),
`inner_loop="static"` (the counted matching: exactly `inner_iters`
iterations) and `static_rounds` for `GangScheduler`, `GangSweep` and
`FaultSweep`. The cases of tests/test_engine_gang.py,
tests/test_parallel.py and tests/test_faultsweep.py that run a counted
loop, re-built from the same manifest builders and configurations, plus a
`FaultSweep` whose budget strands pods the dynamic sweep places and a
record path whose counted pass holds a slot that binds nothing. Each runs
through the JAX package (on the CPU, as its own tests run it) and the port
(plain versions, CPU). Compared: rounds, every final-state tensor and the
placements (and the decoded records, or the sweep's profile). Tolerance:
exact equality. Reference engines are shared by compile signature and
options (`j_gang`), so cases of one shape share a compile.
"""

import numpy as np
import pytest

from kube_scheduler_simulator_tpu.lifecycle.faultsweep import FaultSweep as JFaultSweep
from kube_scheduler_simulator_tpu.parallel import GangSweep as JGangSweep
from kube_scheduler_simulator_tpu.sched.config import SchedulerConfiguration as JConfig

import kube_scheduler_simulator_tpu_torch as kp
from kube_scheduler_simulator_tpu_torch.engine import cuda
from kube_scheduler_simulator_tpu_torch.lifecycle import FaultSweep
from kube_scheduler_simulator_tpu_torch.parallel import GangSweep, weights_for
from kube_scheduler_simulator_tpu_torch.sched.config import SchedulerConfiguration as PConfig

from helpers import node, pod
from test_engine_parity_vol import vol_config
from test_torch_gang import (
    FIT_CFG,
    PINNED_CFG,
    PREEMPT_CFG,
    all_need_eviction,
    assert_states_equal,
    encodings,
    j_gang,
    random_cluster,
    run_both,
    rwop,
    seq_placements,
)
from test_torch_gang_records import records_both

STATIC = {"loop": "static"}


def placed(p):
    return sum(1 for v in p.placements().values() if v)


def one_node_pinned(n=12, misfit=False):
    """tests/test_engine_gang.py's auto-resume cluster: n pods pinned to one
    node, one a round (and a pod that fits nowhere)."""
    nodes = [node("n0", cpu="16", pods="110", labels={"k": "v"})]
    pods = [pod(f"p{i}", node_selector={"k": "v"}) for i in range(n)]
    if misfit:
        pods.append(pod("misfit", node_selector={"k": "nope"}))
    return nodes, pods


def blocked_prefix(n_nodes, n_big, n_ok, cpu="8"):
    """High-priority pods that fit nowhere ahead of small ones in the queue."""
    nodes = [node(f"n{i}", cpu=cpu, pods="110") for i in range(n_nodes)]
    pods = [pod(f"big{i}", cpu="100", priority=100) for i in range(n_big)]
    return nodes, pods + [pod(f"ok{i}", cpu="1", priority=1) for i in range(n_ok)]


# one contended cluster and one option set for the counted loop's cases, so
# that the reference's counted program compiles once for them
CONTENDED = dict(chunk=16, inner_iters=12)


def contended(**opts):
    nodes, pods = random_cluster(11, 6, 30, prio=False)
    return run_both(nodes, pods, FIT_CFG, "exact", **CONTENDED, **opts)


def test_static_loop_matches_dynamic():
    """Counted rounds place as the dynamic loop at equal inner depth; the
    rounds are those that committed (the dynamic count less its empty
    round); the pass reads back once."""
    stat = contended(**STATIC)
    dyn = kp.GangScheduler(stat.enc, device="cpu", **CONTENDED)
    dyn.run()
    assert stat.placements() == dyn.placements()
    assert stat._rounds == dyn._rounds - 1
    assert stat.last_stats["host_syncs"] == 1 and dyn.last_stats["host_syncs"] == dyn._rounds


@pytest.mark.parametrize("inner", ["dynamic", "static"])
def test_hybrid_inner_loop_matches_pure_static(inner):
    """Both hybrids (counted rounds with the matching's while loop, and the
    dynamic rounds with the counted matching) place as the all-counted
    program."""
    loop = "static" if inner == "dynamic" else "dynamic"
    hybrid = contended(loop=loop, inner_loop=inner)
    assert (hybrid.loop, hybrid.inner_loop) == (loop, inner)
    assert hybrid.placements() == contended(**STATIC).placements()


def test_compact_on_and_off():
    """Under the counted loop (the dynamic loop's case is
    test_torch_gang.py's test_compact_is_bit_identical)."""
    off = contended(compact=False, **STATIC)
    assert off.placements() == contended(**STATIC).placements()


def test_static_loop_rwop_claims():
    nodes, pods, objects = rwop()
    got = run_both(nodes, pods, vol_config().to_dict(), "exact", objects, **STATIC).placements()
    assert got[("default", "first")] != "" and got[("default", "second")] == ""


def test_preempt_phase_static_loop():
    nodes, pods = all_need_eviction()
    p = run_both(nodes, pods, PREEMPT_CFG, "exact", **STATIC)
    assert p.placements() == seq_placements(nodes, pods, PREEMPT_CFG, "exact")
    assert p.last_stats["phases"] >= 1


def test_static_match_width():
    nodes, pods = random_cluster(9, 8, 40, prio=False)
    stat = run_both(nodes, pods, FIT_CFG, "exact", chunk=16, match_width=2, inner_iters=64,
                    **STATIC)
    assert stat.placements() == kp.GangScheduler(stat.enc, device="cpu", chunk=16,
                                                 match_width=2).placements()


def test_static_budget_auto_resumes():
    """A small budget is a per-pass quantum: the pass resumes until the
    fixpoint; an infeasible remainder ends it after one pass without
    progress; an explicit max_rounds is a total cap across passes."""
    nodes, pods = one_node_pinned()
    p = run_both(nodes, pods, PINNED_CFG, "exact", static_rounds=5, **STATIC)
    assert placed(p) == 12 and p._rounds >= 12 and p.last_stats["host_syncs"] == 3
    assert placed(kp.GangScheduler(p.enc, device="cpu", **STATIC)) == 12  # the default budget
    nodes, pods = one_node_pinned(misfit=True)
    p = run_both(nodes, pods, PINNED_CFG, "exact", static_rounds=6, **STATIC)
    got = p.placements()
    assert got[("default", "misfit")] == "" and placed(p) == 12 and p._rounds == 12
    # max_rounds=7 on the budget-5 program (the reference's counted program
    # reads it between passes only, so its engine of the first case serves)
    nodes, pods = one_node_pinned()
    j_enc, p_enc = encodings(nodes, pods, PINNED_CFG, "exact")
    j = j_gang(j_enc, dict(static_rounds=5, **STATIC))
    j.max_rounds = 7
    try:
        j_state, j_rounds = j.run()
    finally:
        j.max_rounds = None
    capped = kp.GangScheduler(p_enc, device="cpu", static_rounds=5, max_rounds=7, **STATIC)
    state, rounds = capped.run()
    assert rounds == int(np.asarray(j_rounds)) == 10  # two passes: 10 >= 7 stops
    assert_states_equal(j_state, state)
    assert placed(capped) == 10


class TestEvalWindow:
    """The counted cases of the reference's eval_window tests: the window
    offset rides through the budget slots on the card."""

    def test_binding_window_places_all(self):
        nodes = [node(f"n{i}", cpu="8", pods="110") for i in range(3)]
        pods = [pod(f"p{i}", cpu="1") for i in range(16)]
        p = run_both(nodes, pods, PINNED_CFG, "exact", chunk=2, eval_window=2,
                     rel_serialize=False, **STATIC)
        assert placed(p) == 16

    def test_blocked_window_prefix_sweeps_to_feasible_pods(self):
        nodes, pods = blocked_prefix(2, 4, 8)
        p = run_both(nodes, pods, PINNED_CFG, "exact", chunk=2, eval_window=2,
                     rel_serialize=False, **STATIC)
        got = p.placements()
        assert all(got[("default", f"ok{i}")] for i in range(8))
        assert not any(got[("default", f"big{i}")] for i in range(4)) and p._rounds <= 24

    def test_explicit_budget_below_sweep_width_rejected(self):
        nodes = [node("n0", cpu="8", pods="110")]
        pods = [pod(f"p{i}", cpu="1") for i in range(16)]
        _, p_enc = encodings(nodes, pods, PINNED_CFG, "exact")
        for kw in ({"max_rounds": 4}, {"static_rounds": 7}):
            with pytest.raises(ValueError, match="full eval_window sweep"):
                kp.GangScheduler(p_enc, device="cpu", chunk=2, eval_window=2, **kw, **STATIC)
        # at the sweep width it is legal; a dynamic loop takes any static_rounds
        kp.GangScheduler(p_enc, device="cpu", chunk=2, eval_window=2, static_rounds=8, **STATIC)
        kp.GangScheduler(p_enc, device="cpu", chunk=2, eval_window=2, static_rounds=1)

    def test_static_budget_covers_full_window_sweep(self):
        nodes, pods = blocked_prefix(8, 14, 2)
        p = run_both(nodes, pods, PINNED_CFG, "exact", chunk=2, eval_window=2,
                     rel_serialize=False, **STATIC)
        assert p.static_rounds >= 8  # the clamp engaged
        got = p.placements()
        assert all(got[("default", f"ok{i}")] for i in range(2))
        assert not any(got[("default", f"big{i}")] for i in range(14))


def sweeps_both(j_enc, p_enc, w, budget=None, **opts):
    """The reference's and the port's GangSweep over one weight matrix, a
    counted budget set after construction (read at run time): assignments
    and rounds equal. Returns the port's sweep and assignments."""
    j = JGangSweep(j_enc, **opts)
    p = GangSweep(p_enc, device="cpu", **opts)
    if budget is not None:
        j.gang.static_rounds = p.gang.static_rounds = budget
    j_asg, j_rounds = j.run(w)
    p_asg, p_rounds = p.run(w)
    assert np.array_equal(p_asg.numpy(), np.asarray(j_asg))
    assert p_rounds.tolist() == np.asarray(j_rounds).tolist()
    assert p.placements(p_asg) == j.placements(j_asg)
    return p, p_asg


def test_static_loop_gang_sweep_matches_dynamic():
    """tests/test_parallel.py's: three variants of a contended cluster at a
    budget of 3, set after construction, so the counted passes resume;
    every variant places as the dynamic sweep."""
    nodes, pods = kp.synthetic_cluster(4, 24, seed=5)
    j_enc, p_enc = encodings(nodes, pods, FIT_CFG, "i32")
    variants = [{}, {"NodeResourcesFit": 5}, {"NodeResourcesBalancedAllocation": 9}]
    w = np.stack([weights_for(p_enc, ov) for ov in variants])
    stat, asg = sweeps_both(j_enc, p_enc, w, budget=3, chunk=16, loop="static")
    assert stat.last_stats["passes"] > 1
    dyn_asg, _ = GangSweep(p_enc, device="cpu", chunk=16).run(w)
    assert np.array_equal(asg.numpy(), dyn_asg.numpy())


def test_windowed_static_sweep_with_blocked_prefix():
    nodes, pods = blocked_prefix(8, 14, 2)
    j_enc, p_enc = encodings(nodes, pods, PINNED_CFG, "exact")
    w = np.stack([weights_for(p_enc, {}), weights_for(p_enc, {"NodeResourcesFit": 3})])
    sweep, asg = sweeps_both(j_enc, p_enc, w, chunk=2, loop="static", eval_window=2)
    for d in sweep.placements(asg):
        assert all(d[("default", f"ok{i}")] for i in range(2))


def fault_pair(nodes, pods, cfg, **opts):
    j = JFaultSweep.from_cluster(nodes, pods, JConfig.from_dict(cfg), **opts)
    p = FaultSweep.from_cluster(nodes, pods, PConfig.from_dict(cfg), device="cpu", **opts)
    return j, p


def faults_both(j, p, masks):
    """Both sweeps' profiles of the same masks, equal key by key. Returns
    the port's."""
    want = j.run(masks)
    got = p.run(masks)
    assert np.array_equal(got["assignments"], np.asarray(want["assignments"]))
    for k in ("scenarios", "failedNodes", "evicted", "rescheduled", "stranded", "rounds",
              "totals", "worstScenario"):
        assert got[k] == want[k], k
    return got


def test_static_fault_sweep_within_budget_equals_dynamic():
    """Every scenario reaches its fixpoint inside the budget: the counted
    sweep's assignments are the dynamic sweep's, its rounds one fewer."""
    nodes = [node(f"n{i}", cpu="8") for i in range(4)]
    pods = ([pod(f"b{i}", cpu="1", node_name=f"n{i % 4}") for i in range(10)]
            + [pod(f"q{i}", cpu="1") for i in range(2)])
    cfg = FIT_CFG
    j, p = fault_pair(nodes, pods, cfg, **STATIC)
    masks = np.zeros((4, 4), bool)
    masks[1, 0] = masks[2, 1:3] = masks[3] = True
    got = faults_both(j, p, masks)
    dyn = FaultSweep.from_cluster(nodes, pods, PConfig.from_dict(cfg), device="cpu").run(masks)
    assert np.array_equal(got["assignments"], dyn["assignments"])
    assert got["rounds"] == [r - 1 for r in dyn["rounds"]]
    assert got["totals"]["evicted"] > 0 and p.last_stats["host_syncs"] == 2


def test_static_fault_sweep_budget_strands_pods():
    """Pods pinned to one node re-place one a round: the budget
    (ceil(P/N) + 4 = 8 slots) strands the rest, which the dynamic sweep
    places. The reference's counted sweep has no resume either."""
    nodes = [node("n0", cpu="16", labels={"k": "v"}), node("n1", cpu="16"), node("n2")]
    pods = [pod(f"b{i}", node_selector={"k": "v"}, node_name="n1") for i in range(12)]
    j, p = fault_pair(nodes, pods, PINNED_CFG, **STATIC)
    assert p.gang.static_rounds == 8
    masks = np.array([[False, True, False], [False, False, False]])
    got = faults_both(j, p, masks)
    dyn = FaultSweep.from_cluster(nodes, pods, PConfig.from_dict(PINNED_CFG),
                                  device="cpu").run(masks)
    assert got["stranded"] == [4, 0] and dyn["stranded"] == [0, 0]
    assert got["rounds"] == [8, 0]


def test_static_records_with_a_window_and_an_empty_slot():
    """run_recorded() + results() under loop="static" with a binding window:
    the first slot's window holds only pods that fit nowhere (a slot that
    binds nothing inside the pass), so the bind rounds are slots with gaps.
    The records equal the reference's byte for byte."""
    nodes, pods = blocked_prefix(2, 2, 6, cpu="4")
    p = records_both(nodes, pods, PINNED_CFG, "i32", chunk=2, eval_window=2,
                     rel_serialize=False, **STATIC)
    br = p._chronology[0][2].numpy()
    assert 0 not in br and (br >= 0).sum() == 6


def test_counted_kernels_take_plain_versions_on_the_cpu():
    """On CPU tensors a counted pass calls the counted matching's and the
    round accounting's plain versions, a slot each; no kernel launches."""
    nodes, pods = random_cluster(5, 6, 20)
    _, p_enc = encodings(nodes, pods, FIT_CFG, "i32")
    cuda.reset_counts()
    g = kp.GangScheduler(p_enc, device="cpu", static_rounds=3, **STATIC)
    g.run()
    passes = g.last_stats["host_syncs"]
    assert cuda.PLAIN_CALLS["gang_match_counted"] == cuda.PLAIN_CALLS["gang_advance"] == 3 * passes
    assert cuda.PLAIN_CALLS["gang_match"] == 0 and not any(cuda.LAUNCHES.values())
