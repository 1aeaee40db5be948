"""The volume family in the PyTorch port against the reference engine.

The reference's volume parity scenarios (test_engine_parity_vol.py):
VolumeBinding's prefilter and static table, VolumeZone, VolumeRestrictions
(ReadWriteOncePod claims, disk conflicts, rbd/iscsi identities) and the
volume-count limits, with and without DefaultPreemption evicting a volume
holder — re-built from the same manifest builders and configurations (the
whole default profile's scenario runs in test_torch_default_volumes.py).
Each runs through the JAX engine and the port (plain versions, CPU) under
EXACT and TPU32; placements, every trace tensor, the final state (the
volume counters included) and every pod's annotations must be equal
(test_torch_preempt.run_both). The encoders' volume planes are compared
leaf by leaf. Tolerance: exact equality.
"""

import random

import numpy as np
import pytest

from kube_scheduler_simulator_tpu.engine import encode_cluster as j_encode_cluster
from kube_scheduler_simulator_tpu.sched.config import SchedulerConfiguration as JConfig

import kube_scheduler_simulator_tpu_torch as kp
from kube_scheduler_simulator_tpu_torch.sched.config import SchedulerConfiguration as PConfig

from helpers import node, pod
from test_engine_parity_vol import ZONE, claim_vol, pv, pvc, storageclass, vol_config
from test_torch_encode import POLICIES
from test_torch_preempt import assert_same, run_both

VOLUME_FIELDS = ("vb_row", "vb_code", "vz_code", "vb_pf", "pod_claim", "pod_disk_any",
                 "pod_disk_rw", "pod_vol3")
VOLUME_STATE = ("used_claims", "node_disk_any", "node_disk_rw", "node_vol3")


def _missing_pvc():
    return [node("n0")], [pod("p0", volumes=[claim_vol("ghost")]), pod("ok")], {}


def _bound_pv_affinity():
    aff = {"required": {"nodeSelectorTerms": [
        {"matchExpressions": [{"key": ZONE, "operator": "In", "values": ["z1"]}]}]}}
    nodes = [node("in-zone", labels={ZONE: "z1"}), node("off-zone", labels={ZONE: "z2"})]
    return nodes, [pod("p0", volumes=[claim_vol("data")])], dict(
        pvcs=[pvc("data", volume_name="pv-data")], pvs=[pv("pv-data", node_affinity=aff)])


def _wffc():
    return [node("n0")], [pod("p0", volumes=[claim_vol("lazy")])], dict(
        pvcs=[pvc("lazy", sc="wffc")],
        storageclasses=[storageclass("wffc", mode="WaitForFirstConsumer")])


def _immediate():
    pods = [pod("p0", volumes=[claim_vol("big")]), pod("p1", volumes=[claim_vol("ok")])]
    return [node("n0"), node("n1")], pods, dict(
        pvcs=[pvc("big", sc="std", storage="5Gi"), pvc("ok", sc="std", storage="1Gi")],
        pvs=[pv("small", sc="std", capacity="2Gi")], storageclasses=[storageclass("std")])


def _zone_conflict():
    nodes = [node("a", labels={ZONE: "z1"}), node("b", labels={ZONE: "z2"})]
    return nodes, [pod("p0", volumes=[claim_vol("zonal")])], dict(
        pvcs=[pvc("zonal", volume_name="pv-z")], pvs=[pv("pv-z", labels={ZONE: "z1"})])


def _multi_zone():
    nodes = [node("a", labels={ZONE: "z1"}), node("b", labels={ZONE: "z3"})]
    return nodes, [pod("p0", volumes=[claim_vol("multi")])], dict(
        pvcs=[pvc("multi", volume_name="pv-m")], pvs=[pv("pv-m", labels={ZONE: "z1__z2"})])


RWOP = dict(pvcs=[pvc("solo", modes=("ReadWriteOncePod",), volume_name="pv-s")],
            pvs=[pv("pv-s")])


def _rwop_in_use():
    pods = [pod("holder", node_name="n0", volumes=[claim_vol("solo")]),
            pod("wants", volumes=[claim_vol("solo")])]
    return [node("n0"), node("n1")], pods, RWOP


def _rwop_sequenced():
    pods = [pod("first", priority=10, volumes=[claim_vol("solo")]),
            pod("second", priority=1, volumes=[claim_vol("solo")])]
    return [node("n0"), node("n1")], pods, RWOP


def _disk_conflict():
    gce_rw = {"name": "d", "gcePersistentDisk": {"pdName": "disk-1"}}
    gce_ro = {"name": "d", "gcePersistentDisk": {"pdName": "disk-1", "readOnly": True}}
    pods = [pod("holder-ro", node_name="n0", volumes=[gce_ro]),
            pod("rw-pod", volumes=[gce_rw]), pod("ro-pod", volumes=[gce_ro])]
    return [node("n0"), node("n1")], pods, {}


def _rbd_iscsi():
    rbd = {"name": "r", "rbd": {"pool": "rp", "image": "img1"}}
    iscsi = {"name": "i", "iscsi": {"targetPortal": "10.0.0.9:3260", "iqn": "iqn.x:t"}}
    pods = [pod("a", volumes=[rbd]), pod("b", volumes=[dict(rbd)]),
            pod("c", volumes=[iscsi]), pod("d", volumes=[dict(iscsi)])]
    return [node("n0"), node("n1")], pods, {}


def _disks(tag, k, kind="gcePersistentDisk"):
    key = {"gcePersistentDisk": "pdName", "awsElasticBlockStore": "volumeID"}[kind]
    return [{"name": f"{tag}-{i}", kind: {key: f"{tag}-{i}", "readOnly": True}}
            for i in range(k)]


def _gce_limit():
    pods = [pod("bulk", node_name="n0", volumes=_disks("a", 10)),
            pod("fits", volumes=_disks("b", 6)), pod("over", volumes=_disks("c", 7))]
    return [node("n0")], pods, {}


def _types_separately():
    vols = [{"name": "az", "azureDisk": {"diskName": "d1"}},
            {"name": "eb", "awsElasticBlockStore": {"volumeID": "v1", "readOnly": True}}]
    return [node("n0")], [pod("mixed", volumes=vols), pod("plain")], {}


def _default_profile():
    rng = random.Random(11)
    zones = ["z1", "z2"]
    nodes = [node(f"n{i}", cpu="4", mem="8Gi", labels={ZONE: zones[i % 2]}) for i in range(4)]
    pvs_ = [pv(f"pv{i}", sc="std", capacity="10Gi", labels={ZONE: zones[i % 2]})
            for i in range(3)]
    pvcs_ = [pvc(f"c{i}", sc="std", storage="1Gi") for i in range(2)] + [
        pvc("zonal", volume_name="pv0")]
    pods = []
    for i in range(12):
        vols = []
        r = rng.random()
        if r < 0.3:
            vols.append(claim_vol(rng.choice(["c0", "c1", "zonal"])))
        elif r < 0.5:
            vols.append({"name": "d", "gcePersistentDisk": {
                "pdName": f"disk-{rng.randrange(3)}", "readOnly": rng.random() < 0.5}})
        pods.append(pod(f"p{i}", cpu="200m", mem="256Mi", volumes=vols or None,
                        priority=rng.choice([0, 0, 10])))
    return nodes, pods, dict(pvcs=pvcs_, pvs=pvs_, storageclasses=[storageclass("std")])


def _disk_holder():
    gce = {"name": "d", "gcePersistentDisk": {"pdName": "hot-disk"}}
    pods = [pod("victim", priority=1, node_name="only", volumes=[dict(gce)]),
            pod("urgent", priority=100, volumes=[dict(gce)])]
    return [node("only")], pods, {}


def _rwop_holder():
    pods = [pod("victim", priority=1, node_name="only", volumes=[claim_vol("solo")]),
            pod("urgent", priority=100, volumes=[claim_vol("solo")])]
    return [node("only")], pods, RWOP


def _limit_holder():
    pods = [pod("victim", priority=1, node_name="only", volumes=_disks("a", 16)),
            pod("urgent", priority=100, volumes=_disks("b", 1))]
    return [node("only")], pods, {}


# scenario -> (builder, configuration, the statuses of the pods in order)
SCENARIOS = {
    "missing-pvc": (_missing_pvc, "vol", ["Unschedulable", "Scheduled"]),
    "bound-pv-affinity": (_bound_pv_affinity, "vol", ["Scheduled"]),
    "wait-for-first-consumer": (_wffc, "vol", ["Scheduled"]),
    "immediate-binding": (_immediate, "vol", ["Unschedulable", "Scheduled"]),
    "zone-conflict": (_zone_conflict, "vol", ["Scheduled"]),
    "multi-zone": (_multi_zone, "vol", ["Scheduled"]),
    "rwop-in-use": (_rwop_in_use, "vol", ["Unschedulable"]),
    "rwop-sequenced": (_rwop_sequenced, "vol", ["Scheduled", "Unschedulable"]),
    "disk-conflict": (_disk_conflict, "vol", ["Scheduled", "Scheduled"]),
    "rbd-iscsi": (_rbd_iscsi, "vol", ["Scheduled"] * 4),
    "gce-pd-limit": (_gce_limit, "vol", ["Scheduled", "Unschedulable"]),
    "types-separately": (_types_separately, "vol", ["Scheduled", "Scheduled"]),
    "preempt-disk-holder": (_disk_holder, "vol-preempt", ["Nominated", "Scheduled"]),
    "preempt-rwop-holder": (_rwop_holder, "vol-preempt", ["Nominated", "Scheduled"]),
    "preempt-limit-holder": (_limit_holder, "vol-preempt", ["Nominated", "Scheduled"]),
}


def _config(kind):
    return vol_config(postfilters=("DefaultPreemption",) if kind == "vol-preempt" else ()
                      ).to_dict()


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_volumes_match_reference(scenario, policy):
    build, kind, want = SCENARIOS[scenario]
    nodes, pods, objects = build()
    got = run_both(nodes, pods, _config(kind), policy, **objects)
    if want is not None:
        assert [r.status for r in got] == want


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_volume_encoding_matches_reference(policy):
    """The volume planes, the pre-bound counters and the message table of
    the port's encoder against the reference's, on a preemption_cluster."""
    nodes, pods, objects = kp.preemption_cluster(16, 80, seed=4)
    cfg = kp.supported_config().to_dict()
    j_pol, p_pol = POLICIES[policy]
    ref = j_encode_cluster(nodes, pods, JConfig.from_dict(cfg), policy=j_pol, **objects)
    got = kp.encode_cluster(nodes, pods, PConfig.from_dict(cfg), policy=p_pol, device="cpu",
                            **objects)
    for f in VOLUME_FIELDS:
        assert_same(f, getattr(ref.arrays, f), getattr(got.arrays, f))
    for f in VOLUME_STATE:
        assert_same(f, getattr(ref.state0, f), getattr(got.state0, f))
    assert got.aux["vol_messages"] == ref.aux["vol_messages"]
    assert got.aux["disk_ids"] == ref.aux["disk_ids"]
    assert got.aux["rwop_ids"] == ref.aux["rwop_ids"]
    # the cluster reaches every volume message and counter
    assert len(got.aux["vol_messages"]) >= 4 and int(got.state0.used_claims.sum()) > 0
    assert np.asarray(got.arrays.pod_vol3).max() > 10
