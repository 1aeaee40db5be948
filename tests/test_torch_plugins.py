"""The demo out-of-tree plugins (NetworkBandwidth, NodeNumber) in the
PyTorch port against the reference engine.

Both sides' plugin modules are imported, which registers them. Each case
runs one cluster through the JAX engine and the port (plain versions,
CPU): the reference's five NetworkBandwidth and three NodeNumber cases
(NodeNumber's parity also against the reference's `Oracle`); a 32-node
mixed cluster under the default profile plus both plugins (16 filters, 9
scores, DefaultPreemption) with a preemptor only NetworkBandwidth's row
decides, under EXACT, TPU32 and PACKED; a pass where no node is feasible
(the normalize's sentinels meet); a `GangScheduler` pass; three
`SchedulerService.schedule()` passes around a plain and an annotated
arrival (only the second changes the plugin statics and builds a new
engine); and the compile signature's plugin statics. Compared: placements, every trace
tensor, victims, the final state and every pod's annotations. Reference
programs are shared by compile signature. Tolerance: exact equality.
"""

import copy

import numpy as np
import pytest

import kube_scheduler_simulator_tpu.plugins.networkbandwidth  # noqa: F401  (registers)
import kube_scheduler_simulator_tpu.plugins.nodenumber  # noqa: F401  (registers)
from kube_scheduler_simulator_tpu.engine import BatchedScheduler as JBatchedScheduler
from kube_scheduler_simulator_tpu.engine import encode_cluster as j_encode_cluster
from kube_scheduler_simulator_tpu.server.service import SimulatorService as JSim
from kube_scheduler_simulator_tpu.sched.config import SchedulerConfiguration as JConfig
from kube_scheduler_simulator_tpu.sched.oracle import Oracle

import kube_scheduler_simulator_tpu_torch as kp
import kube_scheduler_simulator_tpu_torch.plugins.networkbandwidth as nb
import kube_scheduler_simulator_tpu_torch.plugins.nodenumber  # noqa: F401  (registers)
from kube_scheduler_simulator_tpu_torch.engine import cuda
from kube_scheduler_simulator_tpu_torch.engine import kernels as K
from kube_scheduler_simulator_tpu_torch.engine.engine import UnsupportedPluginError
from kube_scheduler_simulator_tpu_torch.sched.config import SchedulerConfiguration as PConfig
from kube_scheduler_simulator_tpu_torch.server.service import SimulatorService

from helpers import node, pod
from test_plugin_networkbandwidth import nb_config, nb_node, nb_pod
from test_plugin_nodenumber import _config as nn_config
from test_torch_encode import POLICIES
from test_torch_gang import run_both as gang_both
from test_torch_preempt import assert_full_engines_agree
from test_torch_service import record

# PACKED's trace and placements are TPU32's (the reference pins it): the
# port's PACKED runs are held against the reference's TPU32 engine, whose
# program the TPU32 case compiled
POLICIES = {**POLICIES, "packed": (POLICIES["i32"][0], kp.PACKED)}

# reference engines by compile signature (`retarget` within one)
_J_ENGINES: dict = {}


def run_both(nodes, pods, cfg: dict, policy: str, **objects):
    """The JAX engine and the port (plain versions, CPU) on one cluster;
    asserts they agree and returns the port's records."""
    j_pol, p_pol = POLICIES[policy]
    j_enc = j_encode_cluster(nodes, pods, JConfig.from_dict(cfg), policy=j_pol, **objects)
    sig = JBatchedScheduler.compile_signature(j_enc)
    j_eng = _J_ENGINES.get(sig)
    j_eng = j_eng.retarget(j_enc) if j_eng is not None else JBatchedScheduler(j_enc)
    _J_ENGINES[sig] = j_eng
    p_enc = kp.encode_cluster(nodes, pods, PConfig.from_dict(cfg), policy=p_pol,
                              device="cpu", **objects)
    return assert_full_engines_agree(j_eng, kp.BatchedScheduler(p_enc, device="cpu"))


def demo_config(reverse=False) -> dict:
    return kp.demo_config(reverse=reverse).to_dict()


def nb_messages(records) -> int:
    """Records whose filter results carry NetworkBandwidth's message."""
    return sum(nb.FILTER_MESSAGE in r.to_annotations().get(
        "scheduler-simulator/filter-result", "") for r in records)


# -- the reference's NetworkBandwidth cases ----------------------------------


def _filter_capacity():
    nodes = [nb_node("small", limit="100Mi"), nb_node("big", limit="10Gi"),
             nb_node("unlimited")]
    pods = [nb_pod("heavy", ingress="1Gi", egress="1Gi"), nb_pod("light", ingress="50Mi"),
            nb_pod("none")]
    return nodes, pods, nb_config()


def _accumulates():
    nodes = [nb_node("n0", limit="1Gi"), nb_node("n1", limit="1Gi")]
    pods = [nb_pod("a", ingress="700Mi", priority=10), nb_pod("b", ingress="700Mi", priority=5),
            nb_pod("c", ingress="700Mi", priority=1)]
    return nodes, pods, nb_config()


def _headroom():
    nodes = [nb_node("tight", limit="200Mi"), nb_node("roomy", limit="4Gi")]
    return nodes, [nb_pod("w", ingress="100Mi")], nb_config()


def _preempt():
    nodes = [nb_node("only", limit="1Gi")]
    pods = [nb_pod("squatter", ingress="900Mi", priority=1, node_name="only"),
            nb_pod("urgent", ingress="900Mi", priority=100)]
    return nodes, pods, nb_config(postfilters=("DefaultPreemption",))


def _strict():
    return [nb_node("n0", limit="1Gi")], [nb_pod("p", ingress="1Mi")], nb_config()


NB_CASES = {"filter_capacity_and_skip": _filter_capacity, "accumulates": _accumulates,
            "score_prefers_headroom": _headroom, "preemption_over_bandwidth": _preempt,
            "strict_accepts": _strict}
WANT = {
    "filter_capacity_and_skip": lambda by: nb.FILTER_MESSAGE in by["heavy"].to_annotations()[
        "scheduler-simulator/filter-result"],
    "accumulates": lambda by: (by["a"].selected_node != by["b"].selected_node
                               and by["c"].status == "Unschedulable"),
    "score_prefers_headroom": lambda by: by["w"].selected_node == "roomy",
    # the nomination's record, then the retry's (the last by name)
    "preemption_over_bandwidth": lambda by: by["urgent"].status == "Scheduled",
    "strict_accepts": lambda by: by["p"].status == "Scheduled",
}


@pytest.mark.parametrize("policy", ["exact", "i32"])
@pytest.mark.parametrize("case", sorted(NB_CASES))
def test_networkbandwidth_cases(case, policy):
    nodes, pods, cfg = NB_CASES[case]()
    got = run_both(nodes, pods, cfg.to_dict(), policy)
    assert WANT[case]({r.pod_name: r for r in got})
    assert any(r.status == "Nominated" for r in got) == (case == "preemption_over_bandwidth")


# -- the reference's NodeNumber cases -----------------------------------------


def _suffix():
    return [node("node0"), node("node1"), node("node3")], [pod("web1"), pod("db3")], False


def _reverse():
    return [node("node1"), node("node2")], [pod("app1")], True


def _oracle():
    nodes = [node(f"node{i}") for i in range(5)] + [node("master")]
    return nodes, [pod(f"p{i}") for i in range(8)] + [pod("nodigit")], False


NN_CASES = {"suffix_match": _suffix, "reverse_arg": _reverse, "oracle_parity": _oracle}


@pytest.mark.parametrize("policy", ["exact", "i32"])
@pytest.mark.parametrize("case", sorted(NN_CASES))
def test_nodenumber_cases(case, policy):
    nodes, pods, reverse = NN_CASES[case]()
    cfg = nn_config(reverse=reverse)
    got = run_both(nodes, pods, cfg.to_dict(), policy)
    oracle = Oracle([dict(n) for n in nodes], [dict(p) for p in pods],
                    JConfig.from_dict(cfg.to_dict()))
    assert {r.pod_name: r.selected_node for r in got} == {
        r.pod_name: r.selected_node for r in oracle.schedule_all()}
    if case == "suffix_match":
        assert [r.selected_node for r in got] == ["node1", "node3"]
    if case == "reverse_arg":
        assert got[0].selected_node == "node2"


# -- the default profile plus both plugins -------------------------------------


def mixed_cluster():
    """32 nodes of the dressed default cluster, annotated, with a preemptor
    that only NetworkBandwidth's row decides: node-3 has CPU for it but not
    the bandwidth, until its low-priority bandwidth user leaves."""
    nodes, pods, objects = kp.synth.dressed_default_cluster(32, 24, seed=11)
    kp.synth.annotate_bandwidth(nodes, pods, seed=7)
    nodes[3]["metadata"]["annotations"]["node.kubernetes.io/network-limit"] = "1Gi"
    for pd in pods:
        if pd["spec"].get("nodeName") == "node-3":
            for key in (nb.INGRESS_ANNOTATION, nb.EGRESS_ANNOTATION):
                pd["metadata"].get("annotations", {}).pop(key, None)
    squat = nb_pod("squatter-3", ingress="900Mi", priority=1, node_name="node-3", cpu="10m")
    urgent = nb_pod("urgent-3", ingress="900Mi", priority=1000, cpu="10m")
    urgent["spec"]["nodeSelector"] = {"kubernetes.io/hostname": "node-3"}
    return nodes, pods + [squat, urgent], objects


@pytest.mark.parametrize("policy", ["exact", "i32", "packed"])
def test_default_profile_with_both_plugins(policy):
    nodes, pods, objects = mixed_cluster()
    cfg = demo_config()
    got = run_both(nodes, pods, cfg, policy, **objects)
    enc = kp.encode_cluster(nodes, pods, PConfig.from_dict(cfg), device="cpu", **objects)
    prog = kp.BatchedScheduler(enc, device="cpu").program
    assert (len(prog.filter_names), len(prog.score_names)) == (16, 9)
    nominated = [r for r in got if r.pod_name == "urgent-3" and r.status == "Nominated"]
    assert [r.preemption_victims for r in nominated] == [["default/squatter-3"]]
    assert nb_messages(got) > 0


def test_no_feasible_node_normalize():
    nodes = [nb_node("n0", limit="1Gi"), nb_node("n1", limit="2Gi"), nb_node("n2")]
    pods = [nb_pod("fits", ingress="100Mi"), nb_pod("huge", ingress="10Mi", cpu="999"),
            nb_pod("after", ingress="300Mi")]
    for policy in ("exact", "i32"):
        got = run_both(nodes, pods, nb_config().to_dict(), policy)
        assert [r.status for r in got] == ["Scheduled", "Unschedulable", "Scheduled"]


def test_gang_pass():
    nodes = [nb_node(f"n{i}", limit=("1Gi", "2Gi")[i % 2]) for i in range(6)]
    pods = [nb_pod(f"p{j}", ingress=f"{100 + 90 * j}Mi", priority=j % 3) for j in range(14)]
    for policy in ("exact", "i32"):
        g = gang_both(nodes, pods, nb_config().to_dict(), policy)
        assert any(v == "" for v in g.placements().values())


# -- the serving path and the compile signature --------------------------------


def test_serving_passes_rebuild_on_new_statics():
    """Serving passes around arrivals (the reference's service beside the
    port's): records equal pass by pass."""
    nodes = [nb_node(f"n{i}", limit="1Gi") for i in range(4)]
    snap = {"nodes": nodes, "pods": [nb_pod(f"p{j}", ingress="300Mi") for j in range(6)]}
    cfg = nb_config()
    sims = JSim(initial_config=JConfig.from_dict(cfg.to_dict())), \
        SimulatorService(initial_config=PConfig.from_dict(cfg.to_dict()), device="cpu")
    for sim in sims:
        sim.import_(copy.deepcopy(snap))
    builds = []
    for arrival in (None, nb_pod("plain"), nb_pod("late", ingress="800Mi")):
        if arrival is not None:
            for sim in sims:
                sim.store.apply("pods", copy.deepcopy(arrival))
        want = sims[0].scheduler.schedule()
        got = sims[1].scheduler.schedule()
        assert [record(r) for r in got] == [record(r) for r in want]
        builds.append(sims[1].scheduler.metrics.phases()["engineBuilds"])
    # a pod with no request leaves the statics (and the shapes) as they
    # were: the engine is retargeted; one with a request changes them
    assert builds == [1, 1, 2]


def test_signature_keys_plugin_statics():
    nodes = [nb_node("n0", limit="1Gi"), nb_node("n1", limit="2Gi")]
    pods = [nb_pod("p0", ingress="100Mi"), nb_pod("p1", ingress="200Mi")]
    other = copy.deepcopy(pods)
    other[1]["metadata"]["annotations"]["kubernetes.io/ingress-request"] = "201Mi"
    cfg = nb_config()
    e1 = kp.encode_cluster(nodes, pods, cfg_of(cfg), device="cpu")
    e2 = kp.encode_cluster(nodes, other, cfg_of(cfg), device="cpu")
    e3 = kp.encode_cluster(nodes, copy.deepcopy(pods), cfg_of(cfg), device="cpu")
    sig = kp.BatchedScheduler.compile_signature
    assert sig(e1) != sig(e2) and sig(e1) == sig(e3)
    eng = kp.BatchedScheduler(e1, device="cpu")
    eng.retarget(e3)
    with pytest.raises(ValueError, match="compile-compatible"):
        eng.retarget(e2)
    # the engine holds what its program baked: the pod list changing under
    # an encoding (as the delta encoder changes it) does not move it
    e3.pods[1] = other[1]
    assert kp.BatchedScheduler.compile_signature(e3) == eng.signature  # memoised
    with pytest.raises(ValueError, match="compile-compatible"):
        eng.retarget(kp.encode_cluster(nodes, e3.pods, cfg_of(cfg), device="cpu"))


def cfg_of(cfg):
    return PConfig.from_dict(cfg.to_dict())


def test_unported_plugin_refused(monkeypatch):
    """A plugin registered without a kernel id has no body on the card:
    strict engines refuse it, the others skip it."""
    monkeypatch.setitem(K.FILTER_KERNELS, "MyFilter", (lambda enc: None, None, None))
    d = nb_config().to_dict()
    d["profiles"][0]["plugins"]["filter"]["enabled"].append({"name": "MyFilter"})
    enc = kp.encode_cluster([nb_node("n0", limit="1Gi")], [nb_pod("p", ingress="1Mi")],
                            PConfig.from_dict(d), device="cpu")
    with pytest.raises(UnsupportedPluginError, match="MyFilter"):
        kp.BatchedScheduler(enc, device="cpu")
    assert "MyFilter" not in kp.BatchedScheduler(enc, strict=False, device="cpu")._filter_names


def test_plugin_planes_reach_the_program():
    nodes, pods, objects = mixed_cluster()
    enc = kp.encode_cluster(nodes, pods, PConfig.from_dict(demo_config(reverse=True)),
                            device="cpu", **objects)
    prog = kp.BatchedScheduler(enc, device="cpu").program
    assert set(prog.planes) == set(cuda.PLUGIN_PLANES)
    assert prog.cfg[-1] == 1  # Cfg's nn_reverse
    limit, has, bw = (prog.planes[k] for k in ("nb_limit", "nb_has", "nb_bw"))
    assert limit.dtype == bw.dtype == kp.TPU32.res and has.dtype.is_floating_point is False
    assert has.tolist() == [i % 8 != 7 for i in range(32)] and int(limit[3]) == 1024
    assert np.array_equal(prog.planes["nn_node"][:4].numpy(), [0, 1, 2, 3])
