"""Gang passes through the port's service against the reference's.

The same store operations go into the reference's `SimulatorService` and
the port's (`device="cpu"`); after each `schedule_gang` pass both return
the same placements, rounds and records (status, nomination, victims and
the 13 annotations) and leave byte-equal store exports. Passes: with
records, without (node names only), with `window=`, and with a
preempting arrival whose victims the pass deletes. The port keeps one
engine per (gang signature, effective window) and reuses it across
passes. Tolerance: exact equality.
"""

import json

import pytest

from kube_scheduler_simulator_tpu.server.service import SimulatorService as JSim
from kube_scheduler_simulator_tpu.server.service import gang_chunk as j_gang_chunk

from kube_scheduler_simulator_tpu_torch.server.service import (
    GANG_CHUNK,
    SimulatorService,
    gang_chunk,
)

from helpers import pod
from test_torch_delta import TEMPLATES, from_template
from test_torch_service import record, snapshot


@pytest.fixture(scope="module")
def sims():
    j, p = JSim(), SimulatorService(device="cpu")
    snap = snapshot()
    assert p.import_(json.loads(json.dumps(snap))) == j.import_(json.loads(json.dumps(snap)))
    return j, p


def both(sims, method, *args):
    for sim in sims:
        getattr(sim.store, method)(*args)


def gang_pass(sims, ctx, **kw):
    j, p = sims
    want = j.scheduler.schedule_gang(**kw)
    got = p.scheduler.schedule_gang(**kw)
    assert got[:2] == want[:2], ctx
    if kw.get("record", True):
        assert [record(r) for r in got[2]] == [record(r) for r in want[2]], ctx
    else:
        assert got[2] is None and want[2] is None
    assert json.dumps(p.export()) == json.dumps(j.export()), ctx
    return got


def arrivals(sims, k, n=3):
    for i in range(n):
        both(sims, "apply", "pods", from_template(TEMPLATES[(k + i) % len(TEMPLATES)],
                                                  f"g{k + i}"))


def test_gang_passes_match_reference(sims, monkeypatch):
    j, p = sims
    placements, rounds, results = gang_pass(sims, "pass 1")
    assert rounds >= 2 and results and any(placements.values())
    arrivals(sims, 0)
    gang_pass(sims, "pass 2 (no records)", record=False)
    arrivals(sims, 3)
    gang_pass(sims, "pass 3", record=True)
    # one engine served the three passes: built once, retargeted twice
    phases = p.scheduler.metrics.phases()
    assert phases["engineBuilds"] == 1 and len(p.scheduler._engines) == 1
    ((kind, _, window),) = p.scheduler._engines
    assert kind == "gang" and window is None
    arrivals(sims, 6)
    # a window binds below the pod bucket: a chunk of 2 makes it 2 rows
    monkeypatch.setenv("KSS_GANG_CHUNK", "2")
    gang_pass(sims, "pass 4 (window)", window=2)
    monkeypatch.delenv("KSS_GANG_CHUNK")
    assert p.scheduler.metrics.phases()["engineBuilds"] == 2  # its own cache key
    assert {k[2] for k in p.scheduler._engines} == {None, 2}
    both(sims, "apply", "pods", pod("preemptor", cpu="4", mem="64Mi", priority=1000))
    _, _, got = gang_pass(sims, "pass 5 (preemption)")
    nominated = [r for r in got if r.pod_name == "preemptor" and r.status == "Nominated"]
    assert nominated and nominated[0].preemption_victims
    for victim in nominated[0].preemption_victims:
        ns, name = victim.split("/")
        assert p.store.get("pods", name, ns) is None
    assert p.scheduler.metrics.phases()["gangFixpointRounds"] == sum(
        r.rounds for r in p.scheduler.metrics.passes() if r.mode == "gang")
    with pytest.raises(ValueError, match="window"):
        p.scheduler.schedule_gang(window=0)


def test_passes_after_the_queue_settles(sims):
    gang_pass(sims, "settle")  # what the last pass left pending
    gang_pass(sims, "again, no event between")


def test_gang_chunk_knob(monkeypatch):
    monkeypatch.delenv("KSS_GANG_CHUNK", raising=False)
    assert gang_chunk() == GANG_CHUNK == 64
    for raw, want in (("16", 16), ("0", 64), ("banana", 64), ("8.0", 64)):
        monkeypatch.setenv("KSS_GANG_CHUNK", raw)
        assert gang_chunk() == want, raw


@pytest.mark.parametrize("raw", ["", "8", " 8 ", "2.5", "1e2", "0", "-3", "abc", "nan", "inf"])
def test_gang_chunk_parses_as_the_reference(monkeypatch, raw):
    """`int(raw)`, falling back to the default on a ValueError or a value
    below 1, as the reference's `_coerce_env_number` does."""
    monkeypatch.setenv("KSS_GANG_CHUNK", raw)
    assert gang_chunk() == j_gang_chunk()


def test_extenders_are_refused():
    p = SimulatorService(device="cpu")
    with pytest.raises(NotImplementedError, match="extenders"):
        p.scheduler.restart({"extenders": [{"urlPrefix": "http://localhost:1"}]})
