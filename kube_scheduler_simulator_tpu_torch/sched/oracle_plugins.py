"""Plugin constants and semantics shared by the encoder and the kernels.

The reference package keeps these beside its pure-Python oracle
(`sched/oracle_plugins.py`); the port carries only what its encoder and
kernels need: the volume plugins' functions among them, which the volume
encoder (`engine/encode_vol.py`) calls once per (claim, node) against the
snapshot of `sched/oracle.py`.
"""

from __future__ import annotations

import math

from ..models.objects import PodView, match_label_selector, match_node_selector_terms
from ..utils.quantity import parse_quantity
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


# ---------------------------------------------------------------------------
# Volume plugins (VolumeBinding, VolumeZone, VolumeRestrictions' disk
# identities, the volume-count limits)
# ---------------------------------------------------------------------------


def _pod_pvcs(ctx, pod: PodView) -> "list[tuple[str, dict | None]]":
    out = []
    for claim in pod.pvc_names:
        out.append((claim, ctx.snapshot.pvcs.get(f"{pod.namespace}/{claim}")))
    return out


def volume_binding_pre_filter(ctx, pod: PodView) -> "str | None":
    for claim, pvc in _pod_pvcs(ctx, pod):
        if pvc is None:
            return f'persistentvolumeclaim "{claim}" not found'
    return None


def _pv_matches_node(pv: dict, ni) -> bool:
    required = ((pv.get("spec", {}) or {}).get("nodeAffinity") or {}).get("required")
    if not required:
        return True
    return match_node_selector_terms(required.get("nodeSelectorTerms") or [], ni.node)


def volume_binding_filter(ctx, pod: PodView, ni) -> "str | None":
    snapshot = ctx.snapshot
    for claim, pvc in _pod_pvcs(ctx, pod):
        if pvc is None:
            return f'persistentvolumeclaim "{claim}" not found'
        spec = pvc.get("spec", {}) or {}
        bound_pv_name = spec.get("volumeName")
        if bound_pv_name:
            pv = snapshot.pvs.get(bound_pv_name)
            if pv is not None and not _pv_matches_node(pv, ni):
                return "node(s) had volume node affinity conflict"
            continue
        sc_name = spec.get("storageClassName")
        sc = snapshot.storageclasses.get(sc_name) if sc_name else None
        if sc is not None and sc.get("volumeBindingMode") == "WaitForFirstConsumer":
            continue  # provisioning deferred to this node
        # Immediate binding: a compatible unbound PV must exist for this node
        if not any(
            _static_pv_matches(pv, pvc) and _pv_matches_node(pv, ni)
            for pv in snapshot.pvs.values()
        ):
            return "node(s) didn't find available persistent volumes to bind"
    return None


def _static_pv_matches(pv: dict, pvc: dict) -> bool:
    pv_spec = pv.get("spec", {}) or {}
    pvc_spec = pvc.get("spec", {}) or {}
    claim_name = (pvc.get("metadata", {}) or {}).get("name")
    if (pv_spec.get("claimRef") or {}).get("name") not in (None, claim_name):
        return False
    if (pv_spec.get("storageClassName") or "") != (pvc_spec.get("storageClassName") or ""):
        return False
    want_modes = set(pvc_spec.get("accessModes") or [])
    if want_modes and not want_modes.issubset(set(pv_spec.get("accessModes") or [])):
        return False
    want = (pvc_spec.get("resources") or {}).get("requests", {}).get("storage")
    have = (pv_spec.get("capacity") or {}).get("storage")
    if want and have and parse_quantity(have).value < parse_quantity(want).value:
        return False
    sel = pvc_spec.get("selector")
    labels = (pv.get("metadata", {}) or {}).get("labels") or {}
    if sel is not None and not match_label_selector(sel, labels):
        return False
    return True


_ZONE_LABELS = (
    "topology.kubernetes.io/zone",
    "topology.kubernetes.io/region",
    "failure-domain.beta.kubernetes.io/zone",
    "failure-domain.beta.kubernetes.io/region",
)


def volume_zone_filter(ctx, pod: PodView, ni) -> "str | None":
    snapshot = ctx.snapshot
    for claim, pvc in _pod_pvcs(ctx, pod):
        if pvc is None:
            continue
        pv_name = (pvc.get("spec", {}) or {}).get("volumeName")
        if not pv_name:
            continue
        pv = snapshot.pvs.get(pv_name)
        if pv is None:
            continue
        pv_labels = (pv.get("metadata", {}) or {}).get("labels") or {}
        for zl in _ZONE_LABELS:
            if zl not in pv_labels:
                continue
            allowed = set(pv_labels[zl].split("__"))
            if ni.node.labels.get(zl) not in allowed:
                return "node(s) had no available volume zone"
    return None


def pod_disk_keys(p: PodView) -> "list[tuple[str, str, bool]]":
    """(kind, identity, readOnly) per exclusive-disk volume of the pod: the
    conflict identity VolumeRestrictions compares."""
    keys = []
    for v in p.volumes:
        gce = v.get("gcePersistentDisk")
        if gce:
            keys.append(("gce", gce.get("pdName"), bool(gce.get("readOnly"))))
        ebs = v.get("awsElasticBlockStore")
        if ebs:
            keys.append(("ebs", ebs.get("volumeID"), bool(ebs.get("readOnly"))))
        rbd = v.get("rbd")
        if rbd:
            keys.append(("rbd", f"{rbd.get('pool')}/{rbd.get('image')}", bool(rbd.get("readOnly"))))
        iscsi = v.get("iscsi")
        if iscsi:
            keys.append(("iscsi", f"{iscsi.get('targetPortal')}/{iscsi.get('iqn')}",
                         bool(iscsi.get("readOnly"))))
    return keys


# plugin → (the volume type it counts, the per-node limit)
_VOLUME_LIMITS = {
    "EBSLimits": ("awsElasticBlockStore", 39),
    "GCEPDLimits": ("gcePersistentDisk", 16),
    "AzureDiskLimits": ("azureDisk", 16),
}
