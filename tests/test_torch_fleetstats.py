"""The port's fleet & memory observatory (utils/fleetstats.py) against the
reference package's.

* K12 `fleet.quality`: the plain version (`cuda.fleet_quality_plain`,
  through the `fleetstats.quality` entry a sample calls) against the
  reference's `fleetstats._quality` under `jax.jit`, on seeded numpy
  inputs in int32 and int64: padded nodes, zero-alloc lanes,
  over-committed nodes, utilizations on the exact bin edges (k/10 as
  float32), a resource with no free capacity, and one node. Tolerance: the
  histogram, pending and max exact; the mean and the fragmentation within
  1e-5 absolute (float32 sums in another order than XLA's).
* The non-HTTP cases of the reference's `tests/test_fleetstats.py`,
  rebuilt on the port's services (`device="cpu"`): the ring, the env
  parse, subscribers, off by default, a sample a pass (pass id, mode,
  session), the cadence, pending ages, counter tracks, placement
  invariance with stats on and off, the headroom gate, the device-memory
  shape, the census and the session plane's hooks.
* One parity pass: the same store through the reference's and the port's
  `SchedulerService` (a gang pass, then a sequential pass) under TPU32,
  EXACT and PACKED, the samples' `fleet` dicts held equal (histogram,
  pending, nodes exact; mean, max and fragmentation within 1e-5). The
  services run the fit profile (`fit_config()`): the reference's default
  profile costs about 36 s of compiles a policy on the CPU, past this
  file's budget; the sample does not depend on the profile beyond the
  placements.
* A batch window of two tenants with stats and tracing on: each tenant's
  sample (the final state a slice of the stacked tenants' state) equals
  its solo pass's, and the window's spans and occupancy counter are
  recorded.
"""

from __future__ import annotations

import gc
import threading

import jax
import numpy as np
import pytest
import torch

from kube_scheduler_simulator_tpu.models.store import ResourceStore as JStore
from kube_scheduler_simulator_tpu.sched.config import SchedulerConfiguration as JConfig
from kube_scheduler_simulator_tpu.server.service import SchedulerService as JService
from kube_scheduler_simulator_tpu.utils import fleetstats as jfleet

import kube_scheduler_simulator_tpu_torch as kp
from kube_scheduler_simulator_tpu_torch.engine import cuda
from kube_scheduler_simulator_tpu_torch.models.store import ResourceStore
from kube_scheduler_simulator_tpu_torch.server.batchplane import BatchPlane
from kube_scheduler_simulator_tpu_torch.server.service import SchedulerService, SimulatorService
from kube_scheduler_simulator_tpu_torch.server.sessions import SessionManager
from kube_scheduler_simulator_tpu_torch.utils import fleetstats, telemetry

from helpers import node, pod
from test_torch_cuda import FLEET_CASES, FLEET_TOL as TOL, fleet_inputs

POLICIES = ("i32", "exact", "packed")


@pytest.fixture(autouse=True)
def _clean():
    """Every test starts and ends with both observatories and both
    recorders off and no session provider."""
    for mod in (fleetstats, telemetry, jfleet):
        mod.deactivate()
    yield
    for mod in (fleetstats, telemetry, jfleet):
        mod.deactivate()
    fleetstats.set_session_provider(None)


@pytest.fixture()
def recorder():
    rec = fleetstats.FleetRecorder(capacity=64)
    fleetstats.activate(rec)
    return rec


def _store(n_nodes=2, n_pods=4, store_cls=ResourceStore):
    """The reference test's store (tests/test_fleetstats.py `_store`)."""
    store = store_cls()
    for i in range(n_nodes):
        store.apply("nodes", node(f"fn{i}", cpu="4", mem="8Gi"))
    for i in range(n_pods):
        store.apply("pods", pod(f"fp{i}", cpu="100m"))
    return store


def _service(store=None, config=None):
    return SchedulerService(store if store is not None else _store(), config, device="cpu")


# -- K12 against the reference's _quality ------------------------------------


def check_quality(got, want):
    hist, mean, mx, frag, pending = got
    j_hist, j_mean, j_max, j_frag, j_pending = (np.asarray(x) for x in want)
    assert np.array_equal(hist, j_hist), (hist, j_hist)
    assert int(pending) == int(j_pending)
    assert np.float32(mx).tobytes() == np.float32(j_max).tobytes(), (mx, j_max)
    assert abs(float(mean) - float(j_mean)) <= TOL
    assert np.abs(frag.astype(np.float64) - j_frag.astype(np.float64)).max() <= TOL


@pytest.mark.parametrize("dtype", [np.int32, np.int64], ids=["int32", "int64"])
@pytest.mark.parametrize("case", sorted(FLEET_CASES))
def test_quality_plain_matches_reference(case, dtype):
    ins = fleet_inputs(7, dtype=dtype, **FLEET_CASES[case])
    cuda.reset_counts()
    got = fleetstats.quality(*(torch.as_tensor(x) for x in ins))
    assert cuda.PLAIN_CALLS["fleet_quality"] == 1 and cuda.LAUNCHES["fleet_quality"] == 0
    want = jax.jit(jfleet._quality)(*ins)
    check_quality(got, want)
    if case == "bin-edges":
        assert (got[0][1:] > 0).sum() >= 8  # the edge nodes spread over the bins
    if case == "no-free":
        assert got[3][-1] == 0.0
    if case == "over-committed":
        assert got[0][-1] >= 10 and got[2] == 1.0


def test_quality_buffer_layout():
    ins = [torch.as_tensor(x) for x in fleet_inputs(3, 16, 5, 40, np.int64, pad=2)]
    buf = cuda.fleet_quality_plain(*ins)
    assert buf.dtype == torch.int32 and tuple(buf.shape) == (cuda.FLEET_HEAD + 5,)
    hist, mean, mx, frag, pending = cuda.fleet_fields(buf)
    assert hist.sum() == 14 and frag.shape == (5,) and 0.0 <= mean <= mx <= 1.0
    assert pending == int(((ins[3] < 0) & ins[4]).sum())


def test_quality_refuses_what_the_kernel_does_not_take():
    ins = [torch.as_tensor(x) for x in fleet_inputs(3, 8, 4, 10, np.int32)]
    with pytest.raises(ValueError, match="requested"):
        cuda.fleet_quality(ins[0], ins[1], ins[2].long(), ins[3], ins[4])
    with pytest.raises(ValueError, match="pod_mask"):
        cuda.fleet_quality(*ins[:4], ins[4][:-1])


# -- the ring ------------------------------------------------------------------


def test_ring_bounded_under_concurrent_writers():
    rec = fleetstats.FleetRecorder(capacity=16)
    threads = [threading.Thread(target=lambda k=k: [
        rec.push({"session": f"s{k}", "fleet": {}, "i": i}) for i in range(200)])
        for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert rec.emitted == 8 * 200 and len(rec) == 16 and rec.dropped == 8 * 200 - 16
    seqs = [s["seq"] for s in rec.snapshot()]
    assert seqs == sorted(seqs) and len(seqs) == 16 and seqs[-1] == 8 * 200 - 1


def test_ring_capacity_and_cadence_env_parse(monkeypatch):
    monkeypatch.setenv(fleetstats.CAP_VAR, "not-a-number")
    assert fleetstats.ring_capacity_from_env() == fleetstats.DEFAULT_RING_CAP
    monkeypatch.setenv(fleetstats.CAP_VAR, "-3")
    assert fleetstats.ring_capacity_from_env() == fleetstats.DEFAULT_RING_CAP
    monkeypatch.setenv(fleetstats.SAMPLE_VAR, "0")
    assert fleetstats.sample_every_from_env() == 1
    monkeypatch.setenv(fleetstats.SAMPLE_VAR, "4")
    assert fleetstats.sample_every_from_env() == 4
    with pytest.raises(ValueError):
        fleetstats.FleetRecorder(capacity=0)


def test_env_arms_and_caches_a_recorder(monkeypatch):
    monkeypatch.setenv(fleetstats.ENV_VAR, "1")
    monkeypatch.setenv(fleetstats.CAP_VAR, "8")
    rec = fleetstats.active()
    assert rec is not None and rec.capacity == 8 and fleetstats.active() is rec
    monkeypatch.setenv(fleetstats.ENV_VAR, "off")
    assert fleetstats.active() is None and not fleetstats.enabled()


def test_subscribers_receive_samples_and_never_break_the_push():
    rec = fleetstats.FleetRecorder(capacity=4)
    seen: list = []
    rec.subscribe(seen.append)
    rec.subscribe(lambda s: 1 / 0)  # a dead subscriber is contained
    rec.push({"session": "default", "fleet": {}})
    assert len(seen) == 1 and seen[0]["seq"] == 0
    rec.unsubscribe(seen.append)
    rec.push({"session": "default", "fleet": {}})
    assert len(seen) == 1


# -- sampling --------------------------------------------------------------------


def test_off_by_default_emits_nothing(monkeypatch):
    monkeypatch.delenv(fleetstats.ENV_VAR, raising=False)
    assert fleetstats.active() is None
    cuda.reset_counts()
    svc = _service()
    placements, _, _ = svc.schedule_gang(record=False)
    assert any(v for v in placements.values())
    assert fleetstats.active() is None
    assert cuda.PLAIN_CALLS["fleet_quality"] == 0


def test_pass_sampling_populates_ring(recorder):
    svc = _service(_store(n_nodes=2, n_pods=3))
    cuda.reset_counts()
    svc.schedule_gang(record=False)
    svc.store.apply("pods", pod("fp-late"))
    svc.schedule()  # the sequential finish samples too
    assert recorder.emitted == 2 and cuda.PLAIN_CALLS["fleet_quality"] == 2
    s, s2 = recorder.snapshot()
    assert (s["session"], s["mode"], s["passId"]) == ("default", "gang", 1)
    assert (s2["mode"], s2["passId"]) == ("sequential", 2)
    fleet = s["fleet"]
    assert fleet["nodes"] == 2 and fleet["pendingPods"] == 0
    assert sum(fleet["utilization"]["histogram"]) == 2
    assert 0.0 <= fleet["utilization"]["mean"] <= fleet["utilization"]["max"] <= 1.0
    # two equally loaded nodes split the free capacity: index about 0.5
    assert fleet["fragmentationIndex"] == pytest.approx(0.5, abs=0.05)
    assert "cpu" in fleet["fragmentation"]
    buffers = s["buffers"]
    assert buffers["deltaRetainedBytes"] > 0 and buffers["warmEngines"] >= 1
    # the CPU keeps no allocator census
    assert "liveBytes" not in buffers and s["hbm"] == {}
    assert s["devices"] == [{"id": 0, "platform": "cpu"}]


def test_sample_cadence_skips_passes(recorder, monkeypatch):
    monkeypatch.setenv(fleetstats.SAMPLE_VAR, "3")
    store = _store()
    store.apply("pods", pod("never-fits", cpu="100"))  # stays pending
    svc = _service(store)
    for _ in range(4):
        svc.schedule_gang(record=False)
    # every pass reaches the finish; passes 1 and 4 sample
    assert recorder.emitted == 2
    assert [s["passId"] for s in recorder.snapshot()] == [1, 4]


def test_pending_age_tracking_across_samples(recorder):
    store = _store(n_nodes=1, n_pods=0)
    store.apply("pods", pod("huge", cpu="100"))  # can never fit
    svc = _service(store)
    svc.schedule_gang(record=False)
    svc.schedule_gang(record=False)
    first, second = recorder.snapshot()
    assert first["fleet"]["pendingPods"] == 1
    ages1, ages2 = first["fleet"]["pendingAges"], second["fleet"]["pendingAges"]
    assert ages1["count"] == ages2["count"] == 1
    assert ages2["maxSeconds"] >= ages1["maxSeconds"]
    assert list(recorder._pending_seen) == [("default", "default", "huge")]
    # bound or gone: the stamp leaves
    svc.store.delete("pods", "huge", "default")
    svc.store.apply("pods", pod("small"))
    svc.schedule()
    assert recorder._pending_seen == {}


def test_counter_tracks_emitted_when_tracing_on(recorder):
    span_rec = telemetry.SpanRecorder(capacity=4096)
    telemetry.activate(span_rec)
    _service().schedule_gang(record=False)
    counters = {e["name"] for e in span_rec.snapshot() if e.get("ph") == "C"}
    assert {"fleet.pendingPods", "fleet.utilizationMax",
            "fleet.fragmentationIndex"} <= counters


def test_failed_sample_never_fails_the_pass(recorder, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("sample failed")

    monkeypatch.setattr(fleetstats, "quality", boom)
    placements, _, _ = _service().schedule_gang(record=False)
    assert any(v for v in placements.values()) and recorder.emitted == 0


# -- sampling invariance -----------------------------------------------------------


def _placements(armed: bool, monkeypatch) -> dict:
    monkeypatch.delenv(fleetstats.ENV_VAR, raising=False)
    monkeypatch.delenv(fleetstats.SAMPLE_VAR, raising=False)
    fleetstats.activate(fleetstats.FleetRecorder(capacity=64) if armed else None)
    try:
        svc = _service(_store(n_nodes=3, n_pods=8))
        placements, _, _ = svc.schedule_gang(record=False)
        svc.store.apply("pods", pod("late-1", cpu="100m"))
        second, _, _ = svc.schedule_gang(record=False)
        svc.store.apply("pods", pod("late-2", cpu="100m"))
        records = svc.schedule()
        return {**placements, **second,
                "seq": [(r.pod_name, r.selected_node, r.to_annotations()) for r in records]}
    finally:
        fleetstats.deactivate()


def test_stats_on_is_placement_invariant(monkeypatch):
    off = _placements(False, monkeypatch)
    on = _placements(True, monkeypatch)
    assert off == on
    assert any(v for k, v in off.items() if k != "seq")


# -- the headroom gate and the device memory -----------------------------------------


def test_speculation_memory_ok_defaults_open(monkeypatch):
    monkeypatch.delenv(fleetstats.HEADROOM_VAR, raising=False)
    assert fleetstats.speculation_memory_ok()


def test_headroom_gate_closes_below_the_floor(monkeypatch):
    monkeypatch.setenv(fleetstats.HEADROOM_VAR, str(1 << 30))
    monkeypatch.setattr(fleetstats, "hbm_headroom_bytes", lambda: 1024)
    assert not fleetstats.speculation_memory_ok()
    monkeypatch.setattr(fleetstats, "hbm_headroom_bytes", lambda: 4 << 30)
    assert fleetstats.speculation_memory_ok()


def test_headroom_gate_passes_when_unmeasurable(monkeypatch):
    monkeypatch.setenv(fleetstats.HEADROOM_VAR, str(1 << 30))
    assert fleetstats.hbm_headroom_bytes() is None  # the CPU reports no bytes
    assert fleetstats.speculation_memory_ok()


def test_device_memory_never_raises_and_shapes_entries():
    devices = fleetstats.device_memory()
    assert isinstance(devices, list) and devices
    for d in devices:
        assert "id" in d and d["platform"] in ("gpu", "cpu")
    assert fleetstats.device_memory([torch.device("cpu")]) == [{"id": 0, "platform": "cpu"}]
    assert fleetstats.device_memory(["no-such-device"]) == []


# -- the census and the session plane's hooks -----------------------------------------


def test_buffer_census_reports_sessions():
    fleetstats.set_session_provider(lambda: ["default", "s-a", "s-b"])
    census = fleetstats.buffer_census()
    assert census["sessions"] == 3 and "liveBytes" not in census
    fleetstats.set_session_provider(lambda: 1 / 0)  # a broken provider: no filter
    assert fleetstats.known_sessions() is None


def test_deleted_session_drops_ages_and_exposition_series():
    rec = fleetstats.FleetRecorder(capacity=16)
    rec._pending_seen[("s-dead", "default", "p0")] = 0.0
    rec._pending_seen[("s-live", "default", "p1")] = 0.0
    for sid, n in (("s-dead", 9), ("s-live", 1)):
        rec.push({"session": sid, "fleet": {"pendingPods": n,
                  "utilization": {"mean": 0.1, "max": 0.2}, "fragmentationIndex": 0.3},
                  "buffers": {}, "devices": [{"id": 0, "platform": "gpu", "bytesInUse": 7}]})
    rec.drop_session("s-dead")
    assert list(rec._pending_seen) == [("s-live", "default", "p1")]
    fleetstats.set_session_provider(lambda: ["s-live"])
    text = fleetstats.render_prometheus(rec)
    assert "s-live" in text and "s-dead" not in text
    assert 'kss_device_hbm_bytes_in_use{device="0"} 7' in text
    assert "kss_fleet_samples_total 2" in text
    assert len(rec.snapshot()) == 2
    assert fleetstats.render_prometheus(fleetstats.FleetRecorder(capacity=2)) == ""


def test_session_delete_forwards_to_the_recorder(recorder):
    mgr = SessionManager(SimulatorService(device="cpu"))
    sess, _ = mgr.create(name="t")
    recorder._pending_seen[(sess.id, "default", "p0")] = 0.0
    recorder._pending_seen[("default", "default", "p1")] = 0.0
    assert fleetstats.known_sessions() == {"default", sess.id}
    mgr.delete(sess.id)
    assert list(recorder._pending_seen) == [("default", "default", "p1")]
    assert fleetstats.known_sessions() == {"default"}


def test_manager_provider_is_weakref_backed():
    mgr = SessionManager(SimulatorService(device="cpu"))
    assert fleetstats.known_sessions() == {"default"}
    mgr.shutdown()
    del mgr
    gc.collect()
    assert fleetstats.known_sessions() is None


# -- parity with the reference's service -------------------------------------------------


def _fleet(sample: dict) -> dict:
    f = dict(sample["fleet"])
    f["pendingAges"] = f["pendingAges"]["count"]
    return f


def assert_fleet_close(got: dict, want: dict, what):
    g, w = _fleet(got), _fleet(want)
    for key in ("nodes", "pendingPods", "pendingAges"):
        assert g[key] == w[key], (what, key)
    assert g["utilization"]["histogram"] == w["utilization"]["histogram"], what
    for key in ("mean", "max"):
        assert abs(g["utilization"][key] - w["utilization"][key]) <= TOL, (what, key)
    assert g["fragmentation"].keys() == w["fragmentation"].keys(), what
    for r, v in w["fragmentation"].items():
        assert abs(g["fragmentation"][r] - v) <= TOL, (what, r)
    assert abs(g["fragmentationIndex"] - w["fragmentationIndex"]) <= TOL, what


@pytest.mark.parametrize("policy", POLICIES)
def test_samples_match_the_reference_service(policy, monkeypatch):
    monkeypatch.setenv("KSS_DTYPE_POLICY", policy)
    jrec, prec = jfleet.FleetRecorder(capacity=8), fleetstats.FleetRecorder(capacity=8)
    jfleet.activate(jrec)
    fleetstats.activate(prec)
    cfg = kp.fit_config()
    jsvc = JService(_store(2, 3, JStore), JConfig.from_dict(cfg.to_dict()))
    psvc = _service(_store(2, 3), cfg)
    for svc in (jsvc, psvc):
        svc.store.apply("pods", pod("huge", cpu="100"))  # stays pending
        svc.schedule_gang(record=False)
        svc.store.apply("pods", pod("fp-late", cpu="1500m", mem="6Gi"))
        svc.schedule()
    got, want = prec.snapshot(), jrec.snapshot()
    assert [(s["passId"], s["mode"], s["session"]) for s in got] == [
        (s["passId"], s["mode"], s["session"]) for s in want] == [
        (1, "gang", "default"), (2, "sequential", "default")]
    for g, w in zip(got, want):
        assert_fleet_close(g, w, (policy, g["mode"]))
    assert got[0]["fleet"]["pendingPods"] == 1
    assert got[1]["fleet"]["utilization"]["max"] > got[0]["fleet"]["utilization"]["max"]


# -- a batch window's samples ---------------------------------------------------------------


def _tenant(i: int) -> dict:
    return {"nodes": [node(f"n{j}", cpu="16") for j in range(3)],
            "pods": [pod(f"p{j}", cpu=f"{100 + 100 * i + 50 * j}m") for j in range(4)]}


def _window(mgr, sessions, fn):
    barrier = threading.Barrier(len(sessions))
    errors: list = []

    def run(sess):
        try:
            barrier.wait(timeout=30)
            with mgr.pass_slot():
                fn(sess)
        except Exception as e:  # noqa: BLE001 — surfaced by the assert
            errors.append(repr(e))

    threads = [threading.Thread(target=run, args=(s,)) for s in sessions]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads), errors


@pytest.mark.parametrize("kind", ["seq", "gang"])
def test_batch_window_samples_each_tenant(kind):
    def run(sess):
        if kind == "seq":
            sess.service.scheduler.schedule()
        else:
            sess.service.scheduler.schedule_gang(record=False)

    # the tenants' solo samples
    solo_rec = fleetstats.FleetRecorder(capacity=8)
    fleetstats.activate(solo_rec)
    mgr = SessionManager(max_sessions=8, device="cpu")
    for i in range(2):
        run(mgr.create(name=f"solo{i}", snapshot=_tenant(i))[0])
    solo = [_fleet(s) for s in solo_rec.snapshot()]
    # the same passes in one window
    rec, spans = fleetstats.FleetRecorder(capacity=8), telemetry.SpanRecorder(capacity=4096)
    fleetstats.activate(rec)
    telemetry.activate(spans)
    mgr = SessionManager(max_sessions=8, device="cpu")
    plane = BatchPlane(window_ms=5000.0, max_sessions=2,
                       metrics=mgr.get("default").service.scheduler.metrics)
    mgr.batch_plane = plane
    sessions = [mgr.create(name=f"t{i}", snapshot=_tenant(i))[0] for i in range(2)]
    cuda.reset_counts()
    _window(mgr, sessions, run)
    assert cuda.PLAIN_CALLS["batch_run" if kind == "seq" else "batch_eval"] >= 1
    assert cuda.PLAIN_CALLS["fleet_quality"] == 2
    samples = {s["session"]: s for s in rec.snapshot()}
    assert set(samples) == {s.id for s in sessions}
    for i, sess in enumerate(sessions):
        assert _fleet(samples[sess.id]) == solo[i], i
        assert samples[sess.id]["mode"] == ("sequential" if kind == "seq" else "gang")
    events = spans.snapshot()
    telemetry.check_nesting(events)
    enroll = [e for e in events if e["name"] == "batch.enroll"]
    assert sorted(e["args"]["outcome"] for e in enroll) == ["batched", "batched"]
    assert {e["args"]["session"] for e in enroll} == {s.id for s in sessions}
    (execute,) = [e for e in events if e["name"] == "batch.execute"]
    assert execute["tid"] == telemetry.DEVICE_TID and execute["args"]["fill"] == 2
    occupancy = [e for e in events if e["name"] == "fleet.batchOccupancy"]
    assert [e["args"]["value"] for e in occupancy] == [2.0]
