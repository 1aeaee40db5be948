"""Typed views over Kubernetes manifest dicts.

Resources are plain JSON-shaped dicts, the wire format the reference's
export/import uses (reference: simulator/server/handler/export.go:21-30).
These views provide the typed accessors the encoder needs. The resource-request
arithmetic mirrors the upstream scheduler's pod resource accounting that the
reference delegates to (effective requests = max(per-init-container,
sum-of-containers) + overhead; scoring applies non-zero defaults of 100m cpu
/ 200MB memory), re-implemented here from the documented semantics.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Any

from ..utils.quantity import parse_quantity

# Non-zero request defaults used by scoring (LeastAllocated /
# BalancedAllocation): cpu in cores, memory in bytes.
DEFAULT_CPU_REQUEST = Fraction(100, 1000)  # 100m
DEFAULT_MEMORY_REQUEST = Fraction(200 * 1024 * 1024)  # 200MB

CPU = "cpu"
MEMORY = "memory"


def _get(d: "dict | None", *path, default=None):
    cur: Any = d
    for p in path:
        if not isinstance(cur, dict) or p not in cur:
            return default
        cur = cur[p]
    return cur


def _sum_resources(into: dict[str, Fraction], res: "dict | None"):
    for name, q in (res or {}).items():
        into[name] = into.get(name, Fraction(0)) + parse_quantity(q).value


def pod_effective_requests(pod: dict) -> dict[str, Fraction]:
    """Effective scheduling requests of a pod.

    max(sum of app containers, max over init containers) + pod overhead —
    the quantity the Filter path compares against node allocatable.
    """
    spec = pod.get("spec", {})
    total: dict[str, Fraction] = {}
    for c in spec.get("containers", []) or []:
        _sum_resources(total, _get(c, "resources", "requests"))
    init_max: dict[str, Fraction] = {}
    for c in spec.get("initContainers", []) or []:
        one: dict[str, Fraction] = {}
        _sum_resources(one, _get(c, "resources", "requests"))
        for name, v in one.items():
            if v > init_max.get(name, Fraction(0)):
                init_max[name] = v
    for name, v in init_max.items():
        if v > total.get(name, Fraction(0)):
            total[name] = v
    _sum_resources(total, spec.get("overhead"))
    return {k: v for k, v in total.items() if v != 0}


def pod_scoring_requests(pod: dict) -> dict[str, Fraction]:
    """Requests with the non-zero cpu/memory defaults applied (scoring path)."""
    req = dict(pod_effective_requests(pod))
    if req.get(CPU, Fraction(0)) == 0:
        req[CPU] = DEFAULT_CPU_REQUEST
    if req.get(MEMORY, Fraction(0)) == 0:
        req[MEMORY] = DEFAULT_MEMORY_REQUEST
    return req


class _View:
    def __init__(self, obj: dict):
        self.obj = obj

    @property
    def name(self) -> str:
        return _get(self.obj, "metadata", "name", default="")

    @property
    def namespace(self) -> str:
        return _get(self.obj, "metadata", "namespace", default="default")

    @property
    def labels(self) -> dict[str, str]:
        return _get(self.obj, "metadata", "labels", default={}) or {}


class PodView(_View):
    @property
    def spec(self) -> dict:
        return self.obj.get("spec", {}) or {}

    @property
    def node_name(self) -> str:
        return self.spec.get("nodeName") or ""

    @property
    def priority(self) -> "int | None":
        return self.spec.get("priority")

    @property
    def priority_class_name(self) -> str:
        return self.spec.get("priorityClassName") or ""

    @property
    def node_selector(self) -> dict[str, str]:
        return self.spec.get("nodeSelector") or {}

    @property
    def affinity(self) -> dict:
        return self.spec.get("affinity") or {}

    @property
    def node_affinity(self) -> dict:
        return self.affinity.get("nodeAffinity") or {}

    @property
    def pod_affinity(self) -> dict:
        return self.affinity.get("podAffinity") or {}

    @property
    def pod_anti_affinity(self) -> dict:
        return self.affinity.get("podAntiAffinity") or {}

    @property
    def tolerations(self) -> list[dict]:
        return self.spec.get("tolerations") or []

    @property
    def topology_spread_constraints(self) -> list[dict]:
        return self.spec.get("topologySpreadConstraints") or []

    @property
    def host_ports(self) -> list[tuple[str, str, int]]:
        """(protocol, hostIP, hostPort) triples for every declared hostPort."""
        out = []
        for c in self.spec.get("containers", []) or []:
            for p in c.get("ports", []) or []:
                hp = p.get("hostPort")
                if hp:
                    out.append(
                        (p.get("protocol") or "TCP", p.get("hostIP") or "0.0.0.0", int(hp))
                    )
        return out

    @property
    def container_images(self) -> list[str]:
        return [c.get("image", "") for c in self.spec.get("containers", []) or [] if c.get("image")]

    @property
    def num_containers(self) -> int:
        return len(self.spec.get("containers", []) or [])

    @property
    def deleted(self) -> bool:
        """metadata.deletionTimestamp is set (the pod is terminating)."""
        return bool(_get(self.obj, "metadata", "deletionTimestamp"))

    @property
    def volumes(self) -> list[dict]:
        return self.spec.get("volumes", []) or []

    @property
    def pvc_names(self) -> list[str]:
        """The claim names of the pod's persistentVolumeClaim volumes, in
        volume order."""
        out = []
        for v in self.volumes:
            claim = _get(v, "persistentVolumeClaim", "claimName")
            if claim:
                out.append(claim)
        return out


class NodeView(_View):
    @property
    def allocatable(self) -> dict[str, Fraction]:
        out: dict[str, Fraction] = {}
        alloc = _get(self.obj, "status", "allocatable", default=None)
        if alloc is None:
            alloc = _get(self.obj, "status", "capacity", default={}) or {}
        for name, q in alloc.items():
            out[name] = parse_quantity(q).value
        return out

    @property
    def unschedulable(self) -> bool:
        return bool(_get(self.obj, "spec", "unschedulable", default=False))

    @property
    def taints(self) -> list[dict]:
        return _get(self.obj, "spec", "taints", default=[]) or []

    @property
    def images(self) -> list[tuple[list[str], int]]:
        """[(names, sizeBytes)] from status.images."""
        out = []
        for img in _get(self.obj, "status", "images", default=[]) or []:
            out.append((img.get("names") or [], int(img.get("sizeBytes") or 0)))
        return out


# ---------------------------------------------------------------------------
# Label- and node-selector semantics shared with the relational and volume
# encoders.
# ---------------------------------------------------------------------------


def match_label_selector(selector: "dict | None", labels: dict[str, str]) -> bool:
    """metav1.LabelSelector match (matchLabels AND matchExpressions).

    A nil selector matches nothing; an empty selector matches everything.
    """
    if selector is None:
        return False
    for k, v in (selector.get("matchLabels") or {}).items():
        if labels.get(k) != v:
            return False
    for req in selector.get("matchExpressions") or []:
        if not _match_expression(req, labels, allow_numeric=False):
            return False
    return True


def _match_expression(req: dict, labels: dict[str, str], allow_numeric: bool) -> bool:
    """One requirement. Gt/Lt are only legal in node-selector expressions
    (`allow_numeric=True`); a metav1.LabelSelector carrying them matches
    nothing. NotIn matches when the key is absent (upstream
    labels.Requirement.Matches)."""
    key, op = req.get("key", ""), req.get("operator", "")
    values = req.get("values") or []
    present = key in labels
    val = labels.get(key)
    if op == "In":
        return present and val in values
    if op == "NotIn":
        return (not present) or (val not in values)
    if op == "Exists":
        return present
    if op == "DoesNotExist":
        return not present
    if (op == "Gt" or op == "Lt") and allow_numeric:
        if not present:
            return False
        try:
            lhs = int(val)  # type: ignore[arg-type]
            rhs = int(values[0])
        except (ValueError, IndexError):
            return False
        return lhs > rhs if op == "Gt" else lhs < rhs
    return False


def match_node_selector_term(term: dict, node: NodeView) -> bool:
    """One nodeSelectorTerm: AND of matchExpressions and matchFields."""
    exprs = term.get("matchExpressions") or []
    fields = term.get("matchFields") or []
    if not exprs and not fields:
        return False  # empty term matches nothing (upstream semantics)
    for req in exprs:
        if not _match_expression(req, node.labels, allow_numeric=True):
            return False
    for req in fields:
        if not _match_expression(req, {"metadata.name": node.name}, allow_numeric=True):
            return False
    return True


def match_node_selector_terms(terms: list[dict], node: NodeView) -> bool:
    """nodeSelectorTerms are ORed (a PersistentVolume's node affinity)."""
    return any(match_node_selector_term(t, node) for t in terms)


# ---------------------------------------------------------------------------
# Toleration and priority semantics shared with the encoder.
# ---------------------------------------------------------------------------


def toleration_tolerates_taint(tol: dict, taint: dict) -> bool:
    """core/v1 Toleration.ToleratesTaint semantics."""
    if tol.get("effect") and tol["effect"] != taint.get("effect"):
        return False
    if tol.get("key") and tol["key"] != taint.get("key"):
        return False
    op = tol.get("operator") or "Equal"
    if op == "Exists":
        return True
    if op == "Equal":
        return (tol.get("value") or "") == (taint.get("value") or "")
    return False


def tolerations_tolerate_taint(tols: list[dict], taint: dict) -> bool:
    return any(toleration_tolerates_taint(t, taint) for t in tols)


def resolve_pod_priority(pod: PodView, priorityclasses: dict[str, dict]) -> int:
    """Effective pod priority: explicit spec.priority, else the named
    PriorityClass value, else the globalDefault PriorityClass, else 0.
    Shared by the oracle's snapshot and the engine's encoder so PrioritySort
    queue order can never diverge between them."""
    if pod.priority is not None:
        return int(pod.priority)
    pc_name = pod.priority_class_name
    if pc_name and pc_name in priorityclasses:
        return int(priorityclasses[pc_name].get("value", 0))
    for pc in priorityclasses.values():
        if pc.get("globalDefault"):
            return int(pc.get("value", 0))
    return 0
