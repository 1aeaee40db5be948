"""Volume-family encodings (VolumeBinding, VolumeZone, VolumeRestrictions,
EBS/GCEPD/AzureDisk limits): the reference package's `engine/encode_vol.py`.

  * VolumeBinding and VolumeZone consult only static objects (PVCs, PVs,
    StorageClasses and node labels), none of which change while pods
    schedule. Their per-(pod, node) verdicts are evaluated once on the host
    by the plugin functions of `sched/oracle_plugins.py` and shipped as
    gather tables over the pods that reference claims ([N, VB], VB = claim
    pods, not [N, P]).
  * VolumeRestrictions and the volume-count limits depend on which pods are
    bound where, so they read counters of `SchedState`: per-node disk and
    volume counts and a global ReadWriteOncePod claim usage vector, added
    to at bind and taken from at eviction.

Failure messages are interned into one table (`aux["vol_messages"]`, id 0 =
pass) so device codes decode to the reference's exact annotation strings.
"""

from __future__ import annotations

import numpy as np

from ..models.objects import PodView
from ..sched import oracle_plugins as op
from ..sched.oracle import ClusterSnapshot, CycleContext

# Column order of the per-type volume-count arrays; rows of
# oracle_plugins._VOLUME_LIMITS (plugin → (volume type, limit)).
VOL_LIMIT_PLUGINS = ("EBSLimits", "GCEPDLimits", "AzureDiskLimits")


def pod_disk_vol_rows(pv, disk_ids, D):
    """(pod_disk_any, pod_disk_rw, pod_vol3) rows for one pod against a
    fixed exclusive-disk vocabulary."""
    disk_any = np.zeros(D, np.int32)
    disk_rw = np.zeros(D, np.int32)
    for kind, ident, ro in op.pod_disk_keys(pv):
        d = disk_ids[(kind, ident)]
        disk_any[d] += 1
        if not ro:
            disk_rw[d] += 1
    vol3 = np.zeros(len(VOL_LIMIT_PLUGINS), np.int32)
    for j, plugin in enumerate(VOL_LIMIT_PLUGINS):
        vol_type, _ = op._VOLUME_LIMITS[plugin]
        vol3[j] = sum(1 for v in pv.volumes if v.get(vol_type))
    return disk_any, disk_rw, vol3


def encode_volumes(
    pod_views: list,
    nodes: list[dict],
    N: int,
    P: int,
    pvcs: list[dict],
    pvs: list[dict],
    storageclasses: list[dict],
    config,
) -> tuple[dict, dict]:
    """Returns (arrays dict for ClusterArrays, aux dict)."""
    snapshot = ClusterSnapshot.build(nodes, pvcs, pvs, storageclasses)
    ctx = CycleContext(snapshot, config)
    nis = snapshot.node_list()

    messages = [""]
    msg_ids: dict[str, int] = {"": 0}

    def intern(msg: "str | None") -> int:
        if not msg:
            return 0
        if msg not in msg_ids:
            msg_ids[msg] = len(messages)
            messages.append(msg)
        return msg_ids[msg]

    # -- static verdict tables (VolumeBinding / VolumeZone) -----------------
    # The plugins evaluate a pod's claims in order and return the first
    # failure, and every per-claim verdict depends only on the claim, so
    # verdicts are memoized per (ns/claim, node) through a single-claim
    # probe pod, and a pod's code is its first failing claim's.
    claim_cache: dict[str, tuple[int, np.ndarray, np.ndarray]] = {}

    def claim_verdicts(ns: str, claim: str):
        key = f"{ns}/{claim}"
        hit = claim_cache.get(key)
        if hit is None:
            probe = PodView({
                "metadata": {"name": "_probe", "namespace": ns},
                "spec": {"volumes": [
                    {"name": "v", "persistentVolumeClaim": {"claimName": claim}}]},
            })
            pf = intern(op.volume_binding_pre_filter(ctx, probe))
            vb = np.asarray(
                [intern(op.volume_binding_filter(ctx, probe, ni)) for ni in nis], np.int32)
            vz = np.asarray(
                [intern(op.volume_zone_filter(ctx, probe, ni)) for ni in nis], np.int32)
            hit = claim_cache[key] = (pf, vb, vz)
        return hit

    claim_pods = [i for i, pv in enumerate(pod_views) if pv.pvc_names]
    VB = max(1, len(claim_pods))
    vb_row = np.full(P, -1, np.int32)
    vb_code = np.zeros((N, VB), np.int32)
    vz_code = np.zeros((N, VB), np.int32)
    vb_pf = np.zeros(P, np.int32)
    n_real = len(nis)
    for r, i in enumerate(claim_pods):
        vb_row[i] = r
        pv = pod_views[i]
        for claim in pv.pvc_names:
            pf, vb, vz = claim_verdicts(pv.namespace, claim)
            if vb_pf[i] == 0:
                vb_pf[i] = pf
            # first failing claim wins per node (claim-order return)
            col_b = vb_code[:n_real, r]
            vb_code[:n_real, r] = np.where(col_b != 0, col_b, vb)
            col_z = vz_code[:n_real, r]
            vz_code[:n_real, r] = np.where(col_z != 0, col_z, vz)

    # -- ReadWriteOncePod claim usage (VolumeRestrictions, global) ----------
    rwop_ids: dict[str, int] = {}
    for pv in pod_views:
        for claim in pv.pvc_names:
            key = f"{pv.namespace}/{claim}"
            pvc = snapshot.pvcs.get(key)
            if pvc and "ReadWriteOncePod" in (
                (pvc.get("spec", {}) or {}).get("accessModes") or []
            ):
                rwop_ids.setdefault(key, len(rwop_ids))
    C = max(1, len(rwop_ids))
    pod_claim = np.zeros((P, C), bool)
    for i, pv in enumerate(pod_views):
        for claim in pv.pvc_names:
            cid = rwop_ids.get(f"{pv.namespace}/{claim}")
            if cid is not None:
                pod_claim[i, cid] = True

    # -- exclusive-disk conflict identities (VolumeRestrictions, per node) --
    disk_ids: dict[tuple[str, str], int] = {}
    for pv in pod_views:
        for kind, ident, _ in op.pod_disk_keys(pv):
            disk_ids.setdefault((kind, ident), len(disk_ids))
    D = max(1, len(disk_ids))
    pod_disk_any = np.zeros((P, D), np.int32)
    pod_disk_rw = np.zeros((P, D), np.int32)
    pod_vol3 = np.zeros((P, len(VOL_LIMIT_PLUGINS)), np.int32)
    for i, pv in enumerate(pod_views):
        pod_disk_any[i], pod_disk_rw[i], pod_vol3[i] = pod_disk_vol_rows(pv, disk_ids, D)

    arrays = dict(
        vb_row=vb_row,
        vb_code=vb_code,
        vz_code=vz_code,
        vb_pf=vb_pf,
        pod_claim=pod_claim,
        pod_disk_any=pod_disk_any,
        pod_disk_rw=pod_disk_rw,
        pod_vol3=pod_vol3,
    )
    return arrays, {"vol_messages": messages, "disk_ids": disk_ids, "rwop_ids": rwop_ids}
