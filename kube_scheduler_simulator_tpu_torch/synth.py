"""Synthetic cluster generators for benchmarks and `chip_smoke.py`.

Mirror the workload shapes in BASELINE.json's configs (100 pods × 10 nodes
… 100k pods × 10k nodes, and config #3's anti-affinity chains):
heterogeneous node capacities, mixed pod sizes, optional priorities — all
Mi-granular so the 32-bit dtype policy is exact (engine/encode.py TPU32).
Same generator, same seed, same cluster as the reference package's
`synth.synthetic_cluster` and `synth.synthetic_affinity_cluster`.
`dressed_affinity_cluster` adds every feature the affinity plugins read; the
port's tests and `chip_smoke.py` draw their relational clusters from it.
`annotate_bandwidth` adds the demo NetworkBandwidth plugin's annotations.
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


IMAGES = ["nginx", "redis:6", "reg.io/app/db"]


def _dress_node(rng, i, nd):
    """Node i's dressing: a numeric rack, a disk kind, no zone on every 9th
    node, an image held."""
    lab = nd["metadata"]["labels"]
    lab["rack"] = str(int(rng.integers(0, 20)))
    if rng.random() < 0.6:
        lab["disk"] = str(rng.choice(["ssd", "hdd", "nvme"]))
    if i % 9 == 4:
        del lab[ZONE]
    if rng.random() < 0.5:
        nd["status"]["images"] = [{"names": [str(rng.choice(IMAGES))],
                                   "sizeBytes": int(rng.integers(30, 900)) << 20}]


def _dress_pod(rng, j, pd, n_nodes, n_aff) -> int:
    """Pod j's dressing (every feature the affinity plugins read); returns
    the count of required node-affinity terms handed out so far, which
    cycles through the operators."""
    spec, meta = pd["spec"], pd["metadata"]
    app = meta["labels"]["app"]
    if j % 5 == 1:
        meta["labels"]["tier"] = str(rng.choice(["web", "db"]))
    if j % 7 == 1:
        meta["namespace"] = "prod"
    aff = spec.setdefault("affinity", {})
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
        c["image"] = str(rng.choice(IMAGES + ["nginx:latest", "mysql"]))
    if rng.random() < 0.1:
        spec["containers"].append({"name": "side", "image": "nginx"})
    spread = _spread(rng, app)
    if spread:
        spec["topologySpreadConstraints"] = spread
    r = rng.random()
    key = str(rng.choice([HOST, ZONE]))
    anti = aff.setdefault("podAntiAffinity", {})
    if r < 0.15:
        aff.setdefault("podAffinity", {})["preferredDuringSchedulingIgnoredDuringExecution"] = [
            {"weight": int(rng.integers(1, 100)), "podAffinityTerm": _pod_term(rng, key)}]
    elif r < 0.3:
        anti["preferredDuringSchedulingIgnoredDuringExecution"] = [
            {"weight": int(rng.integers(1, 100)), "podAffinityTerm": _pod_term(rng, key)}]
    elif r < 0.36:
        anti.setdefault("requiredDuringSchedulingIgnoredDuringExecution", []).append(
            _pod_term(rng, key))
    elif r < 0.4:
        aff.setdefault("podAffinity", {}).setdefault(
            "requiredDuringSchedulingIgnoredDuringExecution", []).append(_pod_term(rng, ZONE))
    if not anti:
        del aff["podAntiAffinity"]
    return n_aff


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
    for i, nd in enumerate(nodes):
        _dress_node(rng, i, nd)
    n_aff = 0  # required node affinity cycles through the operators
    for j, pd in enumerate(pods):
        n_aff = _dress_pod(rng, j, pd, n_nodes, n_aff)
        if j % 13 == 3:
            pd["spec"]["nodeName"] = f"node-{int(rng.integers(n_nodes))}"
    pods[5]["metadata"]["deletionTimestamp"] = "2024-01-01T00:00:00Z"
    pods[5]["spec"]["nodeName"] = "node-0"
    return nodes, pods


def dressed_default_cluster(n_nodes: int, n_pending: int, seed: int = 0
                            ) -> tuple[list[dict], list[dict], dict]:
    """`preemption_cluster` (volumes, pre-bound low-priority filler, a
    pending queue that preempts) with the affinity dressing of
    `dressed_affinity_cluster` on every node and on about a third of the
    pods, filler and pending alike: the whole default profile's every code
    path. Returns (nodes, pods, objects); `objects` adds the namespaces the
    dressing's terms name."""
    nodes, pods, objects = preemption_cluster(n_nodes, n_pending, seed=seed)
    rng = np.random.default_rng(seed + 1)
    for i, nd in enumerate(nodes):
        _dress_node(rng, i, nd)
    n_aff = 0
    for j, pd in enumerate(pods):
        if rng.random() < 0.35:
            n_aff = _dress_pod(rng, j, pd, n_nodes, n_aff)
    return nodes, pods, {**objects, "namespaces": DRESSED_NAMESPACES}


def preemption_cluster(n_nodes: int, n_pending: int, seed: int = 0, *, fill: float = 0.9
                       ) -> tuple[list[dict], list[dict], dict]:
    """BASELINE config #5's "mixed PriorityClass preemption" as an imported
    snapshot presents it, under the whole default profile: most pods
    already bound, a pending queue that must preempt to place.

    * Nodes: `synthetic_cluster`'s mix (4–64 cores, 4 Gi a core, 110
      pods), labelled with their hostname and one of four zones; every
      97th node is cordoned and every 31st carries a NoSchedule taint.
    * Pre-bound filler (`spec.nodeName`, priority 0–9) fills each node to
      about `fill` of its CPU.
    * `n_pending` pending pods with `synthetic_cluster`'s request mix and
      priorities drawn from {0, 5, 50, 100}.
    * Volumes, on filler and pending pods alike: about 10% mount a
      PersistentVolumeClaim from a shared pool (WaitForFirstConsumer and
      Immediate StorageClasses, claims bound to zonal PVs with and without
      node affinity, ReadWriteOncePod claims, a few missing claims); about
      5% mount inline awsElasticBlockStore, gcePersistentDisk or azureDisk
      volumes, some of them sharing a disk read-write, and a few carry
      enough disks of one type to meet the per-node limits.
    * A few pods carry a hard zone spread constraint, a required
      anti-affinity to their own app on the hostname, a zone nodeSelector,
      a toleration, a host port, or a nodeName naming no node.

    Returns (nodes, pods, objects): `objects` holds the `pvcs`, `pvs` and
    `storageclasses` to pass to `encode_cluster` or `schedule()`. Choices
    come from a numpy generator seeded with `seed`; the node mix from
    `synthetic_cluster(n_nodes, 0, seed)`."""
    nodes, _ = synthetic_cluster(n_nodes, 0, seed=seed)
    rng = np.random.default_rng(seed)
    zones = [f"z{i}" for i in range(4)]
    for i, nd in enumerate(nodes):
        nd["metadata"]["labels"] = {HOST: nd["metadata"]["name"], ZONE: zones[i % 4]}
        spec = {}
        if i % 97 == 5:
            spec["unschedulable"] = True
        if i % 31 == 7:
            spec["taints"] = [{"key": "dedicated", "value": "infra", "effect": "NoSchedule"}]
        if spec:
            nd["spec"] = spec

    n_claims = max(8, n_nodes // 4)
    storageclasses = [
        {"metadata": {"name": "wffc"}, "volumeBindingMode": "WaitForFirstConsumer"},
        {"metadata": {"name": "std"}, "volumeBindingMode": "Immediate"},
    ]
    pvs, pvcs = [], []
    for k in range(n_claims):
        zone = zones[k % 4]
        spec: dict = {"resources": {"requests": {"storage": "1Gi"}}}
        kind = k % 8
        if kind in (0, 1, 2):  # provisioned on the first consumer's node
            spec["storageClassName"] = "wffc"
        elif kind in (3, 4):  # bound to a zonal PV pinned by node affinity
            spec["volumeName"] = f"pv-{k}"
            pvs.append({"metadata": {"name": f"pv-{k}", "labels": {ZONE: zone}},
                        "spec": {"capacity": {"storage": "10Gi"},
                                 "accessModes": ["ReadWriteOnce"],
                                 "nodeAffinity": {"required": {"nodeSelectorTerms": [
                                     {"matchExpressions": [{"key": ZONE, "operator": "In",
                                                            "values": [zone]}]}]}}}})
        elif kind == 5:  # bound to a PV labelled with its zone only
            spec["volumeName"] = f"pv-{k}"
            pvs.append({"metadata": {"name": f"pv-{k}", "labels": {ZONE: zone}},
                        "spec": {"capacity": {"storage": "10Gi"},
                                 "accessModes": ["ReadWriteOnce"]}})
        elif kind == 6:  # Immediate, needs an unbound compatible PV
            spec["storageClassName"] = "std"
            spec["resources"]["requests"]["storage"] = "4Gi" if k % 16 == 6 else "1Gi"
        else:  # ReadWriteOncePod, bound
            spec["volumeName"] = f"pv-{k}"
            spec["accessModes"] = ["ReadWriteOncePod"]
            pvs.append({"metadata": {"name": f"pv-{k}"},
                        "spec": {"capacity": {"storage": "10Gi"},
                                 "accessModes": ["ReadWriteOncePod"]}})
        pvcs.append({"metadata": {"name": f"claim-{k}", "namespace": "default"},
                     "spec": spec})
    for z, zone in enumerate(zones):  # the Immediate claims' unbound PVs
        pvs.append({"metadata": {"name": f"pv-std-{z}"},
                    "spec": {"capacity": {"storage": "2Gi"}, "storageClassName": "std",
                             "accessModes": ["ReadWriteOnce"],
                             "nodeAffinity": {"required": {"nodeSelectorTerms": [
                                 {"matchExpressions": [{"key": ZONE, "operator": "In",
                                                        "values": [zone]}]}]}}}})

    n_disks = max(4, n_nodes // 16)

    def volumes():
        r = rng.random()
        if r < 0.10:
            k = int(rng.integers(n_claims))
            claim = f"claim-{k}" if rng.random() > 0.02 else f"missing-{k}"
            return [{"name": "data", "persistentVolumeClaim": {"claimName": claim}}]
        if r < 0.15:
            kind = int(rng.integers(3))
            ro = bool(rng.random() < 0.5)
            d = int(rng.integers(n_disks))
            if kind == 0:
                return [{"name": "ebs", "awsElasticBlockStore": {"volumeID": f"vol-{d}",
                                                                 "readOnly": ro}}]
            if kind == 1:
                return [{"name": "pd", "gcePersistentDisk": {"pdName": f"pd-{d}",
                                                             "readOnly": ro}}]
            return [{"name": "az", "azureDisk": {"diskName": f"az-{d}"}}]
        if r < 0.156:  # a bulk of one type's disks, read-only, from a shared pool
            kind = int(rng.integers(3))
            k = int(rng.integers(6, 15)) if kind else int(rng.integers(20, 38))
            if kind == 0:
                return [{"name": f"e{i}", "awsElasticBlockStore": {
                    "volumeID": f"bulk-{i}", "readOnly": True}} for i in range(k)]
            if kind == 1:
                return [{"name": f"g{i}", "gcePersistentDisk": {
                    "pdName": f"bulk-{i}", "readOnly": True}} for i in range(k)]
            return [{"name": f"a{i}", "azureDisk": {"diskName": f"bulk-{i}"}}
                    for i in range(k)]
        return None

    cpu_mix = (100, 250, 500, 1000, 2000)
    mem_mix = (128, 256, 512, 1024, 2048)

    def pod(name, cpu_m, mem_mi, priority):
        spec: dict = {"containers": [{"name": "c", "resources": {"requests": {
            "cpu": f"{cpu_m}m", "memory": f"{mem_mi}Mi"}}}], "priority": priority}
        vols = volumes()
        if vols:
            spec["volumes"] = vols
        app = f"app-{int(rng.integers(16))}"
        r = rng.random()
        if r < 0.01:
            spec["topologySpreadConstraints"] = [{
                "maxSkew": 1, "topologyKey": ZONE, "whenUnsatisfiable": "DoNotSchedule",
                "labelSelector": {"matchLabels": {"app": app}}}]
        elif r < 0.02:
            spec["affinity"] = {"podAntiAffinity": {
                "requiredDuringSchedulingIgnoredDuringExecution": [{
                    "topologyKey": HOST, "labelSelector": {"matchLabels": {"app": app}}}]}}
        elif r < 0.025:
            spec["nodeSelector"] = {ZONE: str(rng.choice(zones))}
        elif r < 0.035:
            spec["containers"][0]["ports"] = [{"containerPort": 8080, "hostPort": 8080}]
        if rng.random() < 0.05:
            spec["tolerations"] = [{"key": "dedicated", "operator": "Exists"}]
        return {"metadata": {"name": name, "namespace": "default", "labels": {"app": app}},
                "spec": spec}

    pods = []
    for i, nd in enumerate(nodes):
        budget = int(nd["status"]["allocatable"]["cpu"]) * 1000 * fill
        used = 0
        while True:
            cpu_m = int(rng.choice(cpu_mix))
            if used + cpu_m > budget:
                break
            used += cpu_m
            p = pod(f"filler-{len(pods)}", cpu_m, int(rng.choice(mem_mix)),
                    int(rng.integers(0, 10)))
            p["spec"]["nodeName"] = nd["metadata"]["name"]
            pods.append(p)
    for i in range(n_pending):
        p = pod(f"pod-{i}", int(rng.choice(cpu_mix)), int(rng.choice(mem_mix)),
                int(rng.choice([0, 5, 50, 100])))
        if i % 500 == 17:
            p["spec"]["nodeName"] = "missing-node"
        pods.append(p)
    return nodes, pods, {"pvcs": pvcs, "pvs": pvs, "storageclasses": storageclasses}


# The demo NetworkBandwidth plugin's annotations (plugins/networkbandwidth.py):
# node limits, and the ranges of the pods' requests in Mi
NETWORK_LIMITS = ("1Gi", "2Gi", "4Gi", "10Gi")
INGRESS_MI, EGRESS_MI = (10, 800), (10, 200)


def annotate_bandwidth(nodes: list[dict], pods: list[dict], seed: int = 7) -> None:
    """Annotate a cluster for the demo NetworkBandwidth plugin, in place: a
    `node.kubernetes.io/network-limit` from `NETWORK_LIMITS` on 7 of every
    8 nodes (not on node i with i % 8 == 7), an ingress request on 3 of
    every 4 pods (not on pod j with j % 4 == 3) and an egress request on
    every other pod (j even), pre-bound pods included, each drawn uniformly
    in Mi from INGRESS_MI / EGRESS_MI. Choices come from a numpy generator
    seeded with `seed`. The ranges make the plugin's filter reject a node
    for about a fifth of `synthetic_cluster`'s pods at 10 pods a node."""
    rng = np.random.default_rng(seed)
    for i, nd in enumerate(nodes):
        if i % 8 != 7:
            meta = nd.setdefault("metadata", {})
            ann = meta["annotations"] = dict(meta.get("annotations") or {})
            ann["node.kubernetes.io/network-limit"] = str(rng.choice(NETWORK_LIMITS))
    for j, pd in enumerate(pods):
        ann = {}
        if j % 4 != 3:
            mi = int(rng.integers(*INGRESS_MI, endpoint=True))
            ann["kubernetes.io/ingress-request"] = f"{mi}Mi"
        if j % 2 == 0:
            mi = int(rng.integers(*EGRESS_MI, endpoint=True))
            ann["kubernetes.io/egress-request"] = f"{mi}Mi"
        if ann:
            meta = pd.setdefault("metadata", {})
            meta["annotations"] = {**(meta.get("annotations") or {}), **ann}
