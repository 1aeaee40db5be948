"""Snapshot export and import: the reference package's `models/snapshot.py`.

Wire-compatible with the reference simulator's `ResourcesForImport` JSON:
keys `pods, nodes, pvs, pvcs, storageClasses, priorityClasses,
schedulerConfig, namespaces` (plus `deployments` and `replicasets`).
Import applies in dependency order (namespaces, priority classes, storage
classes, PVCs, nodes, workloads, pods), then PVs with their claimRef
re-linked to the new PVC's uid. Export drops server stamps and system
objects (`system-` priority classes, `kube-*` and `default` namespaces).
"""

from __future__ import annotations

import json
from typing import Any

from .store import ResourceStore

_KIND_TO_JSON = {
    "pods": "pods",
    "nodes": "nodes",
    "pvs": "pvs",
    "pvcs": "pvcs",
    "storageclasses": "storageClasses",
    "priorityclasses": "priorityClasses",
    "namespaces": "namespaces",
    "deployments": "deployments",
    "replicasets": "replicasets",
}

_STRIP_META = ("resourceVersion", "uid", "creationTimestamp", "managedFields", "generation")


def _clean(obj: dict) -> dict:
    out = json.loads(json.dumps(obj))
    meta = out.get("metadata", {})
    for f in _STRIP_META:
        meta.pop(f, None)
    return out


def export_snapshot(store: ResourceStore, scheduler_config: "dict | None") -> dict:
    out: dict[str, Any] = {}
    for kind, jkey in _KIND_TO_JSON.items():
        objs = store.list(kind)
        if kind == "priorityclasses":
            objs = [o for o in objs
                    if not (o.get("metadata", {}).get("name", "")).startswith("system-")]
        if kind == "namespaces":
            objs = [
                o for o in objs
                if not (o.get("metadata", {}).get("name", "")).startswith("kube-")
                and o.get("metadata", {}).get("name", "") != "default"
            ]
        out[jkey] = [_clean(o) for o in objs]
    out["schedulerConfig"] = scheduler_config
    return out


def import_snapshot(
    store: ResourceStore,
    snapshot: dict,
    ignore_err: bool = False,
) -> "tuple[dict | None, list[str]]":
    """Apply a snapshot in dependency order. Returns (schedulerConfig,
    errors): the configuration the snapshot carries and, with
    `ignore_err`, the objects skipped and why."""
    errors: list[str] = []

    def _apply(kind: str, objs):
        for obj in objs or []:
            try:
                store.apply(kind, obj)
            except Exception as e:  # noqa: BLE001 — the ignore-errors import mode
                if not ignore_err:
                    raise
                errors.append(f"{kind}: {e}")

    _apply("namespaces", snapshot.get("namespaces"))
    _apply("priorityclasses", snapshot.get("priorityClasses"))
    _apply("storageclasses", snapshot.get("storageClasses"))
    _apply("pvcs", snapshot.get("pvcs"))
    _apply("nodes", snapshot.get("nodes"))
    _apply("deployments", snapshot.get("deployments"))
    _apply("replicasets", snapshot.get("replicasets"))
    _apply("pods", snapshot.get("pods"))

    # PVs last, their claimRef re-linked to the re-created PVC's uid
    pvs = []
    for pv in snapshot.get("pvs") or []:
        pv = json.loads(json.dumps(pv))
        claim = (pv.get("spec", {}) or {}).get("claimRef")
        if claim and claim.get("name"):
            pvc = store.get("pvcs", claim["name"], claim.get("namespace", "default"))
            if pvc is not None:
                claim["uid"] = pvc["metadata"].get("uid", "")
                claim["resourceVersion"] = pvc["metadata"].get("resourceVersion", "")
        pvs.append(pv)
    _apply("pvs", pvs)

    return snapshot.get("schedulerConfig"), errors
