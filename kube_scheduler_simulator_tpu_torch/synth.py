"""Synthetic cluster generators for benchmarks and `chip_smoke.py`.

Mirror the workload shapes in BASELINE.json's configs (100 pods × 10 nodes
… 100k pods × 10k nodes, and config #3's anti-affinity chains):
heterogeneous node capacities, mixed pod sizes, optional priorities — all
Mi-granular so the 32-bit dtype policy is exact (engine/encode.py TPU32).
Same generator, same seed, same cluster as the reference package's
`synth.synthetic_cluster` and `synth.synthetic_affinity_cluster`.
`dressed_affinity_cluster` adds every feature the affinity plugins read; the
port's tests and `chip_smoke.py` draw their relational clusters from it.
"""

from __future__ import annotations

import random

import numpy as np


def synthetic_cluster(
    n_nodes: int,
    n_pods: int,
    seed: int = 0,
    *,
    priorities: bool = False,
) -> tuple[list[dict], list[dict]]:
    rng = random.Random(seed)
    nodes = []
    for i in range(n_nodes):
        cores = rng.choice([4, 8, 16, 32, 64])
        nodes.append(
            {
                "metadata": {"name": f"node-{i}"},
                "status": {
                    "allocatable": {
                        "cpu": str(cores),
                        "memory": f"{cores * 4}Gi",
                        "pods": "110",
                    }
                },
            }
        )
    pods = []
    for i in range(n_pods):
        cpu_m = rng.choice([100, 250, 500, 1000, 2000])
        mem_mi = rng.choice([128, 256, 512, 1024, 2048])
        spec: dict = {
            "containers": [
                {
                    "name": "c",
                    "resources": {
                        "requests": {"cpu": f"{cpu_m}m", "memory": f"{mem_mi}Mi"}
                    },
                }
            ]
        }
        if priorities and rng.random() < 0.3:
            spec["priority"] = rng.randint(0, 100)
        pods.append(
            {
                "metadata": {"name": f"pod-{i}", "namespace": "default"},
                "spec": spec,
            }
        )
    return nodes, pods


def synthetic_affinity_cluster(
    n_nodes: int,
    n_pods: int,
    seed: int = 0,
    *,
    replicas_per_service: int = 10,
) -> tuple[list[dict], list[dict]]:
    """InterPodAffinity-heavy workload (BASELINE config #3): pods grouped
    into services whose replicas carry required anti-affinity to their own
    service on the hostname topology (one replica per node: an
    anti-affinity chain per service), and a third of the services carry
    required affinity to the previous service on the zone topology
    (co-location chains across services). Nodes are labelled with their
    hostname and one of eight zones."""
    rng = random.Random(seed)
    nodes = []
    for i in range(n_nodes):
        cores = rng.choice([8, 16, 32])
        nodes.append(
            {
                "metadata": {
                    "name": f"node-{i}",
                    "labels": {
                        "kubernetes.io/hostname": f"node-{i}",
                        "topology.kubernetes.io/zone": f"z{i % 8}",
                    },
                },
                "status": {
                    "allocatable": {
                        "cpu": str(cores),
                        "memory": f"{cores * 4}Gi",
                        "pods": "110",
                    }
                },
            }
        )
    pods = []
    n_services = max(1, n_pods // replicas_per_service)
    for i in range(n_pods):
        svc = i % n_services
        anti = {
            "requiredDuringSchedulingIgnoredDuringExecution": [
                {
                    "labelSelector": {"matchLabels": {"app": f"svc-{svc}"}},
                    "topologyKey": "kubernetes.io/hostname",
                }
            ]
        }
        affinity: dict = {"podAntiAffinity": anti}
        if svc % 3 == 0 and svc > 0:
            # co-locate with the previous service's zone (a chain)
            affinity["podAffinity"] = {
                "requiredDuringSchedulingIgnoredDuringExecution": [
                    {
                        "labelSelector": {"matchLabels": {"app": f"svc-{svc - 1}"}},
                        "topologyKey": "topology.kubernetes.io/zone",
                    }
                ]
            }
        pods.append(
            {
                "metadata": {
                    "name": f"pod-{i}",
                    "namespace": "default",
                    "labels": {"app": f"svc-{svc}"},
                },
                "spec": {
                    "containers": [
                        {
                            "name": "c",
                            "resources": {"requests": {"cpu": "250m", "memory": "256Mi"}},
                        }
                    ],
                    "affinity": affinity,
                },
            }
        )
    return nodes, pods


# the namespaces `dressed_affinity_cluster`'s pods and terms name
DRESSED_NAMESPACES = [
    {"metadata": {"name": "default", "labels": {"team": "core"}}},
    {"metadata": {"name": "prod", "labels": {"team": "core", "tier": "prod"}}},
]

ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"
OPERATORS = ("In", "NotIn", "Exists", "DoesNotExist", "Gt", "Lt")


def _node_affinity(rng, n_nodes, op):
    if op in ("Gt", "Lt"):
        expr = {"key": "rack", "operator": op, "values": [str(int(rng.integers(2, 18)))]}
    else:
        expr = {"key": "disk", "operator": op,
                "values": ["ssd", "nvme"] if op in ("In", "NotIn") else []}
    terms = [{"matchExpressions": [expr]}]
    if rng.random() < 0.3:
        terms.append({"matchFields": [{"key": "metadata.name", "operator": "In",
                                       "values": [f"node-{int(rng.integers(n_nodes))}"]}]})
    return {"requiredDuringSchedulingIgnoredDuringExecution": {"nodeSelectorTerms": terms}}


def _spread(rng, app):
    r = rng.random()
    if r < 0.15:
        return [{"maxSkew": int(rng.integers(1, 3)), "topologyKey": ZONE,
                 "whenUnsatisfiable": "DoNotSchedule",
                 "labelSelector": {"matchLabels": {"app": app},
                                   "matchExpressions": [{"key": "tier", "operator": "In",
                                                         "values": ["web", "db"]}]}}]
    if r < 0.25:
        return [{"maxSkew": 1, "topologyKey": HOST, "whenUnsatisfiable": "DoNotSchedule",
                 "labelSelector": {"matchExpressions": [
                     {"key": "app", "operator": "NotIn", "values": [app, "svc-0"]}]}}]
    if r < 0.4:
        return [
            {"maxSkew": 1, "topologyKey": HOST, "whenUnsatisfiable": "ScheduleAnyway",
             "labelSelector": {"matchExpressions": [
                 {"key": "tier", "operator": str(rng.choice(["Exists", "DoesNotExist"]))}]}},
            {"maxSkew": 2, "topologyKey": ZONE, "whenUnsatisfiable": "ScheduleAnyway",
             "labelSelector": {"matchLabels": {"app": app}}},
        ]
    if r < 0.43:
        # no labelSelector: a nil selector matches no pod
        return [{"maxSkew": 1, "topologyKey": ZONE, "whenUnsatisfiable": "ScheduleAnyway"}]
    return None  # System defaulting


def _pod_term(rng, key):
    other = f"svc-{int(rng.integers(0, 12))}"
    t = {"topologyKey": key, "labelSelector": {"matchLabels": {"app": other}}}
    r = rng.random()
    if r < 0.15:
        t["namespaceSelector"] = {"matchLabels": {"tier": "prod"}}
    elif r < 0.25:
        t["namespaceSelector"] = {}
    elif r < 0.35:
        t["namespaces"] = ["prod", "default"]
    elif r < 0.4:
        t["labelSelector"]["matchExpressions"] = [{"key": "tier", "operator": "Gt",
                                                   "values": ["1"]}]
    return t


def dressed_affinity_cluster(n_nodes: int, n_pods: int, seed: int = 0
                             ) -> tuple[list[dict], list[dict]]:
    """`synthetic_affinity_cluster` (six replicas a service) dressed with
    every feature the affinity plugins read: node labels (zone, hostname, a
    numeric rack, a disk kind, nodes without a zone, images held by nodes),
    nodeSelector, required node affinity cycling through all six operators
    (some with a matchFields term), preferred node affinity, wildcard and
    IP-specific host ports, container images, hard and soft spread
    constraints with multi-clause selectors (a nil selector, and pods left
    to System defaulting), required and preferred pod affinity and
    anti-affinity across the two namespaces of `DRESSED_NAMESPACES`
    (namespace lists and selectors), pre-bound pods and one pod being
    deleted. Choices come from a numpy generator seeded with `seed`."""
    nodes, pods = synthetic_affinity_cluster(n_nodes, n_pods, seed=seed,
                                             replicas_per_service=6)
    rng = np.random.default_rng(seed)
    images = ["nginx", "redis:6", "reg.io/app/db"]
    n_aff = 0  # required node affinity cycles through the operators
    for i, nd in enumerate(nodes):
        lab = nd["metadata"]["labels"]
        lab["rack"] = str(int(rng.integers(0, 20)))
        if rng.random() < 0.6:
            lab["disk"] = str(rng.choice(["ssd", "hdd", "nvme"]))
        if i % 9 == 4:
            del lab[ZONE]
        if rng.random() < 0.5:
            nd["status"]["images"] = [{"names": [str(rng.choice(images))],
                                       "sizeBytes": int(rng.integers(30, 900)) << 20}]
    for j, pd in enumerate(pods):
        spec, meta = pd["spec"], pd["metadata"]
        app = meta["labels"]["app"]
        if j % 5 == 1:
            meta["labels"]["tier"] = str(rng.choice(["web", "db"]))
        if j % 7 == 1:
            meta["namespace"] = "prod"
        aff = spec["affinity"]
        r = rng.random()
        if r < 0.12:
            spec["nodeSelector"] = {"disk": str(rng.choice(["ssd", "hdd"]))}
        elif r < 0.35:
            aff["nodeAffinity"] = _node_affinity(rng, n_nodes, OPERATORS[n_aff % 6])
            n_aff += 1
        if rng.random() < 0.3:
            aff.setdefault("nodeAffinity", {})["preferredDuringSchedulingIgnoredDuringExecution"] = [
                {"weight": int(rng.integers(1, 100)), "preference": {"matchExpressions": [
                    {"key": "rack", "operator": str(rng.choice(["Gt", "Lt"])),
                     "values": [str(int(rng.integers(0, 20)))]}]}},
                {"weight": int(rng.integers(1, 100)), "preference": {"matchExpressions": [
                    {"key": "disk", "operator": "In", "values": ["nvme"]}]}},
            ]
        c = spec["containers"][0]
        if rng.random() < 0.2:
            c["ports"] = [{"hostPort": int(rng.choice([80, 443])),
                           "hostIP": str(rng.choice(["0.0.0.0", "10.0.0.1", "10.0.0.2"])),
                           "protocol": str(rng.choice(["TCP", "UDP"]))}]
        if rng.random() < 0.4:
            c["image"] = str(rng.choice(images + ["nginx:latest", "mysql"]))
        if rng.random() < 0.1:
            spec["containers"].append({"name": "side", "image": "nginx"})
        spread = _spread(rng, app)
        if spread:
            spec["topologySpreadConstraints"] = spread
        r = rng.random()
        key = str(rng.choice([HOST, ZONE]))
        if r < 0.15:
            aff.setdefault("podAffinity", {})["preferredDuringSchedulingIgnoredDuringExecution"] = [
                {"weight": int(rng.integers(1, 100)), "podAffinityTerm": _pod_term(rng, key)}]
        elif r < 0.3:
            aff["podAntiAffinity"]["preferredDuringSchedulingIgnoredDuringExecution"] = [
                {"weight": int(rng.integers(1, 100)), "podAffinityTerm": _pod_term(rng, key)}]
        elif r < 0.36:
            aff["podAntiAffinity"]["requiredDuringSchedulingIgnoredDuringExecution"].append(
                _pod_term(rng, key))
        elif r < 0.4:
            aff.setdefault("podAffinity", {}).setdefault(
                "requiredDuringSchedulingIgnoredDuringExecution", []).append(_pod_term(rng, ZONE))
        if j % 13 == 3:
            spec["nodeName"] = f"node-{int(rng.integers(n_nodes))}"
    pods[5]["metadata"]["deletionTimestamp"] = "2024-01-01T00:00:00Z"
    pods[5]["spec"]["nodeName"] = "node-0"
    return nodes, pods
