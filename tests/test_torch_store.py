"""The port's ResourceStore and snapshot export/import against the
reference package's.

One seeded operation script (numpy generator) drives both stores: applies
(new objects and merges), wholesale replacements, deletes (node cascades
included), re-adds of deleted keys, and a log small enough to be pruned.
After every operation the two must agree on every kind's list, the latest
resourceVersion, `events_since` and `dirty_since` from a few watermarks,
and on which watermarks are stale. Tolerance: exact equality.
"""

import copy

import numpy as np
import pytest

from kube_scheduler_simulator_tpu.models.snapshot import export_snapshot as j_export
from kube_scheduler_simulator_tpu.models.snapshot import import_snapshot as j_import
from kube_scheduler_simulator_tpu.models.store import ResourceStore as JStore
from kube_scheduler_simulator_tpu.models.store import StaleResourceVersion as JStale

from kube_scheduler_simulator_tpu_torch.models.snapshot import export_snapshot, import_snapshot
from kube_scheduler_simulator_tpu_torch.models.store import KINDS, ResourceStore
from kube_scheduler_simulator_tpu_torch.models.store import StaleResourceVersion

from helpers import node, pod


def op_script(seed, n_ops=160):
    """A list of (method, args) store operations drawn from `seed`."""
    rng = np.random.default_rng(seed)
    ops = []
    nodes = [f"n{i}" for i in range(5)]
    for i, name in enumerate(nodes):
        ops.append(("apply", ("nodes", node(name, cpu=str(2 + i)))))
    ops.append(("apply", ("priorityclasses", {"metadata": {"name": "high"}, "value": 100})))
    ops.append(("apply", ("namespaces", {"metadata": {"name": "team"}})))
    pods = []
    for _ in range(n_ops):
        r = rng.random()
        if r < 0.35 or not pods:
            name = f"p{len(pods)}"
            ns = "team" if rng.random() < 0.3 else "default"
            bound = nodes[int(rng.integers(len(nodes)))] if rng.random() < 0.4 else None
            pods.append((ns, name))
            ops.append(("apply", ("pods", pod(name, ns=ns, node_name=bound,
                                               cpu=f"{int(rng.integers(1, 9)) * 100}m"))))
        elif r < 0.55:
            ns, name = pods[int(rng.integers(len(pods)))]
            ops.append(("apply", ("pods", {
                "metadata": {"name": name, "namespace": ns,
                             "annotations": {"k": str(int(rng.integers(100)))}},
                "spec": {"nodeName": nodes[int(rng.integers(len(nodes)))]}})))
        elif r < 0.65:
            ns, name = pods[int(rng.integers(len(pods)))]
            ops.append(("replace", ("pods", pod(name, ns=ns, cpu="50m"))))
        elif r < 0.8:
            ns, name = pods[int(rng.integers(len(pods)))]
            ops.append(("delete", ("pods", name, ns)))
        elif r < 0.86:
            name = nodes[int(rng.integers(len(nodes)))]
            ops.append(("apply", ("nodes", {"metadata": {"name": name},
                                            "spec": {"unschedulable": bool(rng.random() < 0.5)}})))
        elif r < 0.9:
            name = nodes[int(rng.integers(len(nodes)))]
            ops.append(("delete", ("nodes", name)))
            ops.append(("apply", ("nodes", node(name))))
        else:
            ns, name = pods[int(rng.integers(len(pods)))]
            ops.append(("apply", ("pods", pod(name, ns=ns))))
    return ops


def assert_same_views(ref, got, watermarks):
    assert got.latest_rv() == ref.latest_rv()
    for kind in KINDS:
        assert got.list(kind) == ref.list(kind), kind
        assert got.count(kind) == len(ref.list(kind)), kind
    for rv in watermarks:
        try:
            want = ref.dirty_since(rv)
        except JStale:
            with pytest.raises(StaleResourceVersion):
                got.dirty_since(rv)
            with pytest.raises(StaleResourceVersion):
                got.events_since("pods", rv)
            continue
        assert got.dirty_since(rv) == want
        # ADDED keys come in re-insertion order: the order must match too
        for kind, per in want.items():
            assert list(got.dirty_since(rv)[kind]) == list(per), kind
        for kind in ("pods", "nodes"):
            g = [(e.event_type, e.kind, e.obj, e.resource_version)
                 for e in got.events_since(kind, rv)]
            w = [(e.event_type, e.kind, e.obj, e.resource_version)
                 for e in ref.events_since(kind, rv)]
            assert g == w, (kind, rv)


@pytest.mark.parametrize("seed, capacity", [(0, 100_000), (1, 100_000), (2, 40)])
def test_store_matches_reference(seed, capacity):
    ref, got = JStore(event_log_capacity=capacity), ResourceStore(event_log_capacity=capacity)
    marks = [0]
    for k, (method, args) in enumerate(op_script(seed)):
        out_ref = getattr(ref, method)(*copy.deepcopy(args))
        out_got = getattr(got, method)(*copy.deepcopy(args))
        assert out_got == out_ref, (k, method, args)
        if k % 7 == 0:
            marks.append(ref.latest_rv())
        if k % 13 == 0:
            assert_same_views(ref, got, marks[-4:] + [0])
    assert_same_views(ref, got, marks)


def test_reset_and_snapshot_round_trip():
    ref, got = JStore(), ResourceStore()
    script = op_script(3, n_ops=60)
    for method, args in script[:30]:
        getattr(ref, method)(*copy.deepcopy(args))
        getattr(got, method)(*copy.deepcopy(args))
    ref.snapshot_initial()
    got.snapshot_initial()
    for method, args in script[30:]:
        getattr(ref, method)(*copy.deepcopy(args))
        getattr(got, method)(*copy.deepcopy(args))
    cfg = {"profiles": []}
    snap = export_snapshot(got, cfg)
    assert snap == j_export(ref, cfg)
    ref.reset()
    got.reset()
    assert_same_views(ref, got, [0, ref.latest_rv() // 2])
    # import the snapshot into fresh stores: equal stores, and an export
    # that round-trips
    ref2, got2 = JStore(), ResourceStore()
    pvc = {"metadata": {"name": "c0", "namespace": "default"}, "spec": {}}
    pv = {"metadata": {"name": "v0"}, "spec": {"claimRef": {"name": "c0"}}}
    snap = dict(snap, pvcs=[pvc], pvs=[pv])
    assert import_snapshot(got2, copy.deepcopy(snap)) == j_import(ref2, copy.deepcopy(snap))
    assert_same_views(ref2, got2, [0])
    assert export_snapshot(got2, cfg) == j_export(ref2, cfg)
    assert export_snapshot(got2, cfg)["pods"] == snap["pods"]
    bad = dict(snap, nodes=[{"metadata": {}}])
    errors = import_snapshot(ResourceStore(), copy.deepcopy(bad), ignore_err=True)[1]
    assert errors == j_import(JStore(), copy.deepcopy(bad), ignore_err=True)[1]
    assert len(errors) == 1
