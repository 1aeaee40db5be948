"""Plugin constants and semantics shared by the encoder and the kernels.

The reference package keeps these beside its pure-Python oracle
(`sched/oracle_plugins.py`); the port carries only what its encoder and
kernels need.
"""

from __future__ import annotations

import math

from ..models.objects import PodView, match_label_selector
from .config import MAX_NODE_SCORE

# Usage fractions are quantized to 1/2^16 so the BalancedAllocation score is
# decided purely by integer arithmetic (upstream computes a float64 std;
# float division is not bit-portable across compilers). Results can differ
# from upstream Go by at most 1 point when a usage fraction straddles a
# 2^-16 quantum.
BALANCED_SCALE = 1 << 16


def rtcr_shape(strategy: dict) -> list[tuple[int, int]]:
    """The RequestedToCapacityRatio shape points, scaled the upstream way:
    user scores are 0..10 (MaxCustomPriorityScore) and are multiplied by
    MaxNodeScore/10 when the scorer is built; sorted by utilization."""
    pts = (strategy.get("requestedToCapacityRatio") or {}).get("shape") or [
        {"utilization": 0, "score": 0},
        {"utilization": 100, "score": 10},
    ]
    return sorted(
        (int(p.get("utilization", 0)), int(p.get("score", 0)) * (MAX_NODE_SCORE // 10))
        for p in pts
    )


# ---------------------------------------------------------------------------
# InterPodAffinity term helpers
# ---------------------------------------------------------------------------


def _namespaces_for_term(term: dict, owner_ns: str, snapshot) -> "set[str] | None":
    """Resolve an affinity term's namespace set. None means "all namespaces"
    (a present-but-empty namespaceSelector). Defaults to the owner pod's
    namespace when neither namespaces nor namespaceSelector is given.
    `snapshot.namespaces` maps namespace name → Namespace object."""
    namespaces = set(term.get("namespaces") or [])
    ns_selector = term.get("namespaceSelector")
    if ns_selector is not None:
        if ns_selector == {} or (
            not ns_selector.get("matchLabels") and not ns_selector.get("matchExpressions")
        ):
            return None  # empty selector matches every namespace
        for ns_name, ns_obj in snapshot.namespaces.items():
            labels = (ns_obj.get("metadata", {}) or {}).get("labels") or {}
            if match_label_selector(ns_selector, labels):
                namespaces.add(ns_name)
    if not namespaces and ns_selector is None:
        namespaces = {owner_ns}
    return namespaces


def _term_matches_pod(term: dict, owner_ns: str, other: PodView, snapshot) -> bool:
    """Does an affinity term (owned by a pod in owner_ns) select `other`?"""
    ns = _namespaces_for_term(term, owner_ns, snapshot)
    if ns is not None and other.namespace not in ns:
        return False
    return match_label_selector(term.get("labelSelector"), other.labels)


def _required_terms(affinity: dict) -> list[dict]:
    return affinity.get("requiredDuringSchedulingIgnoredDuringExecution") or []


def _preferred_terms(affinity: dict) -> list[dict]:
    return affinity.get("preferredDuringSchedulingIgnoredDuringExecution") or []


# ---------------------------------------------------------------------------
# PodTopologySpread
# ---------------------------------------------------------------------------

_SYSTEM_DEFAULT_CONSTRAINTS = [
    {"maxSkew": 3, "topologyKey": "topology.kubernetes.io/zone", "whenUnsatisfiable": "ScheduleAnyway"},
    {"maxSkew": 5, "topologyKey": "kubernetes.io/hostname", "whenUnsatisfiable": "ScheduleAnyway"},
]

# Spread score weights log(topoSize+2) are quantized to 1/2^12 fixed point,
# computed on the host by this exact Python expression, so the score is
# decided by integer arithmetic (same rationale as BALANCED_SCALE).
SPREAD_SCALE = 1 << 12


def spread_log_weight(m: int) -> int:
    """floor(log(m+2) * 2^12) — the fixed-point topology weight."""
    return int(math.log(m + 2) * SPREAD_SCALE)


def resolve_spread_constraints(
    explicit: list[dict], args: dict
) -> tuple[list[dict], list[dict], bool]:
    """(hard, soft, is_explicit): a pod's spread constraints split by
    whenUnsatisfiable.

    System defaulting (PodTopologySpreadArgs.defaultingType=System): two
    ScheduleAnyway constraints whose selector is derived from the pod's
    owning services/controllers. The simulator has no Service kind, so the
    derived selector matches nothing — defaults contribute uniformly to
    scores."""
    if explicit:
        source = explicit
    elif args.get("defaultingType", "System") == "System":
        source = _SYSTEM_DEFAULT_CONSTRAINTS
    else:
        source = args.get("defaultConstraints") or []
    hard = [
        c for c in source
        if (c.get("whenUnsatisfiable") or "DoNotSchedule") == "DoNotSchedule"
    ]
    soft = [
        c for c in source
        if (c.get("whenUnsatisfiable") or "DoNotSchedule") == "ScheduleAnyway"
    ]
    return hard, soft, bool(explicit)


# ---------------------------------------------------------------------------
# ImageLocality
# ---------------------------------------------------------------------------

# Thresholds in Ki units (Mi multiples, so exact): the ImageLocality sum is
# kept in Ki so every intermediate fits int32. Container counts clamp at 64
# so 100*(sum-min) stays in range.
_IMG_MIN_KI = 23 * 1024
_IMG_MAX_CONTAINER_KI = 1000 * 1024
_IMG_MAX_CONTAINERS = 64


def _normalized_image_name(name: str) -> str:
    if ":" not in name.rsplit("/", 1)[-1]:
        name = name + ":latest"
    return name
