"""The port's pass against the reference engine on the reference's own
parity scenarios for NodeAffinity, NodePorts, ImageLocality
(test_engine_parity_m3.py), PodTopologySpread (test_engine_parity_spread.py)
and InterPodAffinity (test_engine_parity_interpod.py).

The scenarios are re-built here from the same manifest builders
(`helpers.node`/`pod`) and run under the same plugin configurations as the
reference tests, then under `affinity_config()`; each runs through the JAX
engine and the port (plain versions, CPU) under EXACT and TPU32. Placements,
every trace tensor (padding rows included), the final state and every pod's
annotations must be equal. Tolerance: exact equality.
"""

import pytest

from kube_scheduler_simulator_tpu.engine import BatchedScheduler as JBatchedScheduler
from kube_scheduler_simulator_tpu.engine import encode_cluster as j_encode_cluster
from kube_scheduler_simulator_tpu.sched.config import SchedulerConfiguration as JConfig

import kube_scheduler_simulator_tpu_torch as kp
from kube_scheduler_simulator_tpu_torch.sched.config import SchedulerConfiguration as PConfig

from helpers import node, pod
from test_engine_parity_interpod import aff, ipa_config, term
from test_engine_parity_interpod import zone_nodes as ipa_zone_nodes
from test_engine_parity_m3 import m3a_config
from test_engine_parity_spread import spread_config, spread_pod
from test_engine_parity_spread import zone_nodes as spread_zone_nodes
from test_torch_encode import POLICIES
from test_torch_engine import assert_engines_agree

HOST = "kubernetes.io/hostname"


def _node_affinity():
    nodes = [
        node("ssd-east", labels={"disk": "ssd", "zone": "east", "idx": "10"}),
        node("hdd-east", labels={"disk": "hdd", "zone": "east", "idx": "2"}),
        node("ssd-west", labels={"disk": "ssd", "zone": "west"}),
        node("bare"),
    ]

    def required(*terms):
        return {"nodeAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": {
            "nodeSelectorTerms": list(terms)}}}

    pods = [
        pod("sel", node_selector={"disk": "ssd"}),
        pod("sel-missing-key", node_selector={"gpu": "a100"}),
        pod("req-terms", affinity=required(
            {"matchExpressions": [{"key": "disk", "operator": "In", "values": ["ssd"]}]},
            {"matchExpressions": [{"key": "zone", "operator": "NotIn", "values": ["west"]},
                                  {"key": "disk", "operator": "Exists"}]})),
        pod("req-numeric", affinity=required(
            {"matchExpressions": [{"key": "idx", "operator": "Gt", "values": ["5"]}]})),
        pod("req-lt", affinity=required(
            {"matchExpressions": [{"key": "idx", "operator": "Lt", "values": ["5"]}]})),
        pod("req-fields", affinity=required(
            {"matchFields": [{"key": "metadata.name", "operator": "In", "values": ["bare"]}]})),
        pod("bogus-field", affinity=required(
            {"matchFields": [{"key": "metadata.bogus", "operator": "DoesNotExist"}]})),
        pod("bad-op", affinity=required(
            {"matchExpressions": [{"key": "disk", "operator": "Bogus", "values": ["x"]}]})),
        pod("preferred", affinity={"nodeAffinity": {
            "preferredDuringSchedulingIgnoredDuringExecution": [
                {"weight": 10, "preference": {"matchExpressions": [
                    {"key": "disk", "operator": "In", "values": ["ssd"]}]}},
                {"weight": 5, "preference": {"matchExpressions": [
                    {"key": "zone", "operator": "In", "values": ["east"]}]}},
            ]}}),
        pod("dne", affinity=required(
            {"matchExpressions": [{"key": "disk", "operator": "DoesNotExist"}]})),
    ]
    return nodes, pods


def _node_ports():
    nodes = [node("p0"), node("p1")]
    pods = [
        pod("existing", ports=[{"hostPort": 443}], node_name="p0"),
        pod("web-a", ports=[{"hostPort": 80}]),
        pod("web-b", ports=[{"hostPort": 80}]),
        pod("udp", ports=[{"hostPort": 80, "protocol": "UDP"}]),
        pod("ip-specific", ports=[{"hostPort": 80, "hostIP": "10.0.0.1"}]),
        pod("other-port", ports=[{"hostPort": 8080}]),
        pod("incoming", ports=[{"hostPort": 443}]),
    ]
    return nodes, pods


def _image_locality():
    big = 500 * 1024 * 1024
    nodes = [
        node("has-both", images=[{"names": ["nginx:latest"], "sizeBytes": big},
                                 {"names": ["redis"], "sizeBytes": big // 2}]),
        node("has-one", images=[{"names": ["nginx"], "sizeBytes": big}]),
        node("has-none"),
    ]
    pods = [
        pod("uses-both", images=["nginx", "redis:latest"]),
        pod("uses-one", images=["nginx:latest"]),
        pod("uses-unknown", images=["mysql"]),
    ]
    return nodes, pods


def _m3():
    """The NodeAffinity, NodePorts and ImageLocality scenarios in one
    cluster."""
    parts = [_node_affinity(), _node_ports(), _image_locality()]
    return [n for ns, _ in parts for n in ns], [p for _, ps in parts for p in ps]


def _spread_hard():
    nodes = spread_zone_nodes() + [node("unlabeled")]
    pods = [spread_pod(f"w{i}") for i in range(7)]
    pods += [spread_pod(f"h{i}", key=HOST) for i in range(3)]
    return nodes, pods


def _spread_unschedulable():
    nodes = spread_zone_nodes(n_per_zone=1, zones=("a", "b"), cpu="1")
    pods = [spread_pod("pre-a", node_name="n-a0")]
    pods += [spread_pod(f"w{i}", cpu="400m") for i in range(4)]
    return nodes, pods


def _spread_soft():
    nodes = spread_zone_nodes()
    pods = [spread_pod(f"s{i}", when="ScheduleAnyway", max_skew=2) for i in range(5)]
    pods += [pod(f"d{i}", labels={"app": "web"}) for i in range(3)]  # System defaults
    for i in range(4):
        pods.append(pod(f"m{i}", labels={"app": "web"}, spread=[
            {"maxSkew": 1, "topologyKey": "topology.kubernetes.io/zone",
             "whenUnsatisfiable": "DoNotSchedule",
             "labelSelector": {"matchLabels": {"app": "web"}}},
            {"maxSkew": 1, "topologyKey": HOST, "whenUnsatisfiable": "ScheduleAnyway",
             "labelSelector": {"matchLabels": {"app": "web"}}},
        ]))
    return nodes, pods


def _interpod_required():
    nodes = ipa_zone_nodes()
    pods = [
        pod("db", labels={"app": "db"}, node_name="n-b0"),
        pod("grumpy", labels={"app": "cache"}, node_name="n-a0",
            affinity=aff(anti_required=[term("loner")])),
        pod("other-ns-db", labels={"app": "db"}, ns="prod", node_name="n-a1"),
        pod("web", labels={"app": "web"}, affinity=aff(required=[term("db")])),
        pod("away", labels={"app": "away"}, affinity=aff(anti_required=[term("db")])),
        pod("loner", labels={"app": "loner"}),
        pod("web2", labels={"app": "web"}, affinity=aff(required=[term("db", ns=["prod"])])),
        pod("first", labels={"app": "first"}, affinity=aff(required=[term("first")])),
        pod("orphan", labels={"app": "orphan"}, affinity=aff(required=[term("nobody")])),
    ]
    pods += [pod(f"r{i}", labels={"app": "chain"},
                 affinity=aff(anti_required=[term("chain", key=HOST)])) for i in range(5)]
    return nodes, pods


def _interpod():
    """Required and preferred terms in both directions, namespaces, the
    first pod of a series and an anti-affinity chain."""
    nodes, pods = _interpod_required()
    pods += [
        pod("db2", labels={"app": "db"}, node_name="n-b1"),
        pod("clingy", labels={"app": "cl"}, node_name="n-a0",
            affinity=aff(required=[term("pw")])),
        pod("pw", labels={"app": "pw"}, affinity=aff(preferred=[
            {"weight": 50, "podAffinityTerm": term("db")}])),
        pod("ploner", labels={"app": "ploner"}, affinity=aff(anti_preferred=[
            {"weight": 80, "podAffinityTerm": term("db")}])),
    ]
    return nodes, pods


def _first_pod_gate():
    nodes = [node("keyed", labels={"topology.kubernetes.io/zone": "a"}),
             node("keyless", labels={})]
    pods = [pod("first", cpu="100m", labels={"app": "self"}, affinity=aff(
        required=[{"topologyKey": "topology.kubernetes.io/zone",
                   "labelSelector": {"matchLabels": {"app": "self"}}}]))]
    return nodes, pods


SCENARIOS = {
    "m3": (_m3, m3a_config),
    "spread-hard": (_spread_hard, spread_config),
    "spread-unschedulable": (_spread_unschedulable, spread_config),
    "spread-soft": (_spread_soft, spread_config),
    "interpod": (_interpod, ipa_config),
    "interpod-first-pod": (_first_pod_gate, ipa_config),
}


def no_prescore_config():
    """affinity_config() with PodTopologySpread's and InterPodAffinity's
    PreScore disabled: both scores are then 0 everywhere."""
    cfg = kp.affinity_config().to_dict()
    pre = cfg["profiles"][0]["plugins"]["preScore"]
    pre["enabled"] = [e for e in pre["enabled"]
                      if e["name"] not in ("PodTopologySpread", "InterPodAffinity")]
    return cfg


# (scenario, configuration): every scenario under affinity_config(), some
# under the reference test's own configuration too
CASES = [(name, "slice") for name in SCENARIOS] + [
    ("m3", "scenario"), ("spread-soft", "scenario"), ("interpod", "scenario"),
    ("interpod", "no-prescore"),
]


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("scenario,config", CASES)
def test_scenario_matches_reference(scenario, config, policy):
    build, scenario_config = SCENARIOS[scenario]
    nodes, pods = build()
    cfg = {
        "scenario": lambda: scenario_config().to_dict(),
        "slice": lambda: kp.affinity_config().to_dict(),
        "no-prescore": no_prescore_config,
    }[config]()
    j_pol, p_pol = POLICIES[policy]
    j_eng = JBatchedScheduler(j_encode_cluster(nodes, pods, JConfig.from_dict(cfg), policy=j_pol))
    p_eng = kp.BatchedScheduler(
        kp.encode_cluster(nodes, pods, PConfig.from_dict(cfg), policy=p_pol, device="cpu"),
        device="cpu",
    )
    assert_engines_agree(j_eng, p_eng)
