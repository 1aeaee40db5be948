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
    def tolerations(self) -> list[dict]:
        return self.spec.get("tolerations") or []


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
