"""The port's serving path against the reference package's: the same store
operations go into the reference's `SimulatorService` and the port's
(`device="cpu"`), and each scheduling pass must leave both stores with
byte-equal exports, return the same records (the 13 annotations, status,
nomination and victims), report the same encode path
(`last_encode_info`) and the same `phases()` counters.

The cluster: 8 nodes, 36 pods (4 pending), then passes with arrivals drawn
from the delta templates, a cordon and an uncordon, and a preempting
arrival whose victims the pass deletes. Every pass's queue and pod count
stay in one shape bucket, so the reference compiles one default-profile
program. Tolerance: exact equality.
"""

import json

import pytest

from kube_scheduler_simulator_tpu.server.service import SimulatorService as JSim

from kube_scheduler_simulator_tpu_torch.engine import scatter
from kube_scheduler_simulator_tpu_torch.engine.delta import DeltaEncoder
from kube_scheduler_simulator_tpu_torch.server.service import (
    InvalidSchedulerConfiguration,
    SchedulerService,
    SimulatorService,
)

from helpers import node, pod
from test_torch_delta import TEMPLATES, from_template

COUNTERS = ("deltaEncodes", "fullEncodes", "cachedEncodes", "emptyEncodes", "engineBuilds")


def snapshot():
    nodes = [node(f"n{i}", cpu="4", mem="8Gi", labels={
        "zone": "a" if i % 2 else "b", "kubernetes.io/hostname": f"n{i}"}) for i in range(8)]
    pods = []
    for j in range(36):
        p = from_template(TEMPLATES[j % len(TEMPLATES)], f"p{j}")
        if j >= 4:
            p["spec"]["nodeName"] = f"n{j % 8}"
        pods.append(p)
    return {"nodes": nodes, "pods": pods}


def record(r):
    return (r.pod_namespace, r.pod_name, r.status, r.selected_node, r.nominated_node,
            r.preemption_victims, r.to_annotations())


@pytest.fixture(scope="module")
def sims():
    return JSim(), SimulatorService(device="cpu")


def both(sims, method, *args):
    for sim in sims:
        getattr(sim.store, method)(*args)


def run_pass(sims, ctx):
    j, p = sims
    scatter.reset_counts()
    want = j.scheduler.schedule()
    got = p.scheduler.schedule()
    assert [record(r) for r in got] == [record(r) for r in want], ctx
    assert p.scheduler.last_encode_info == j.scheduler.last_encode_info, ctx
    assert json.dumps(p.export()) == json.dumps(j.export()), ctx
    jp = j.scheduler.metrics.snapshot()["phases"]
    pp = p.scheduler.metrics.phases()
    assert {k: pp[k] for k in COUNTERS} == {k: jp[k] for k in COUNTERS}, ctx
    # the pass records: mode, distinct pods recorded, pods scheduled
    rec_p = [(r.mode, r.pods, r.scheduled) for r in p.scheduler.metrics.passes()]
    rec_j = [(r["mode"], r["pods"], r["scheduled"])
             for r in j.scheduler.metrics.snapshot()["recent"]]
    assert rec_p[-len(rec_j):] == rec_j, ctx
    mode = p.scheduler.last_encode_info["mode"]
    assert (sum(scatter.PLAIN_CALLS.values()) > 0) == (mode == "delta"), ctx
    return mode, got


def test_serving_passes_match_reference(sims):
    j, p = sims
    snap = snapshot()
    assert p.import_(json.loads(json.dumps(snap))) == j.import_(json.loads(json.dumps(snap)))
    modes = [run_pass(sims, "pass 1")[0]]
    k = 0
    for step in range(2, 5):
        for _ in range(3):
            both(sims, "apply", "pods", from_template(TEMPLATES[k % len(TEMPLATES)], f"a{k}"))
            k += 1
        if step == 2:
            both(sims, "apply", "nodes", {"metadata": {"name": "n1"},
                                          "spec": {"unschedulable": True}})
        if step == 3:
            both(sims, "apply", "nodes", {"metadata": {"name": "n1"},
                                          "spec": {"unschedulable": False}})
        if step == 4:
            both(sims, "apply", "pods", pod("preemptor", cpu="4", mem="64Mi", priority=1000))
        mode, got = run_pass(sims, f"pass {step}")
        modes.append(mode)
    # the preemptor was nominated and its victims are gone from the store
    nominated = [r for r in got if r.pod_name == "preemptor" and r.status == "Nominated"]
    assert nominated and nominated[0].preemption_victims
    for victim in nominated[0].preemption_victims:
        ns, name = victim.split("/")
        assert p.store.get("pods", name, ns) is None
    modes.append(run_pass(sims, "after the evictions")[0])
    modes.append(run_pass(sims, "no event between")[0])
    assert modes[:4] == ["full", "delta", "delta", "delta"], modes
    assert modes[4] in ("full", "empty") and modes[5] in ("cached", "empty"), modes
    assert p.scheduler.metrics.phases()["engineBuilds"] == 1


def test_reset_restart_and_refusals(sims, monkeypatch):
    j, p = sims
    p.reset()
    j.reset()
    assert json.dumps(p.export()) == json.dumps(j.export())
    assert p.scheduler.get_config() == j.scheduler.get_config()
    bad = {"profiles": [{"schedulerName": "default-scheduler", "plugins": {
        "filter": {"enabled": [{"name": "NoSuchPlugin"}]}}}]}
    with pytest.raises(InvalidSchedulerConfiguration):
        p.scheduler.restart(bad)
    with pytest.raises(NotImplementedError, match="extenders"):
        p.scheduler.restart({"extenders": [{"urlPrefix": "http://localhost:1"}]})
    assert p.scheduler.get_config() == j.scheduler.get_config()
    # PACKED (K8) is not ported: the service refuses it rather than serve TPU32
    monkeypatch.setenv("KSS_DTYPE_POLICY", "packed")
    p.store.apply("pods", pod("late"))
    with pytest.raises(NotImplementedError, match="packed"):
        p.scheduler.schedule()


def test_service_runs_on_the_card_by_default(monkeypatch):
    import torch

    from kube_scheduler_simulator_tpu_torch.models.store import ResourceStore

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SimulatorService()
    with pytest.raises(RuntimeError, match="CUDA"):
        SchedulerService(ResourceStore())
    with pytest.raises(RuntimeError, match="CUDA"):
        DeltaEncoder()
