"""The port's span flight recorder (utils/telemetry.py): the reference's
`tests/test_telemetry.py` classes rebuilt (the ring's bound, the on/off
switch, pass-id causality, nesting well-formedness and the Chrome trace
export), and the serving path's spans: one traced pass of the port's
`SchedulerService` of each kind, balanced, each pass-level span stamped
with its pass id, and the fleet observatory's counter tracks beside them.
"""

from __future__ import annotations

import json
import threading

import pytest

from kube_scheduler_simulator_tpu_torch.models.store import ResourceStore
from kube_scheduler_simulator_tpu_torch.server.service import SchedulerService
from kube_scheduler_simulator_tpu_torch.utils import fleetstats, telemetry

from helpers import node, pod

FLEET_COUNTERS = {"fleet.pendingPods", "fleet.utilizationMax", "fleet.fragmentationIndex",
                  "hbm.bytesInUse"}


@pytest.fixture(autouse=True)
def _no_ambient_recorder():
    """Every test starts from the environment-driven default and leaves
    nothing armed."""
    telemetry.deactivate()
    fleetstats.deactivate()
    yield
    telemetry.deactivate()
    fleetstats.deactivate()


class TestRingBuffer:
    def test_bound_holds_under_concurrent_writers(self):
        rec = telemetry.SpanRecorder(capacity=256)
        writers, per_writer = 8, 500

        def hammer(w: int) -> None:
            for i in range(per_writer):
                rec.emit({"ph": "i", "name": f"w{w}", "ts": float(i)})

        threads = [threading.Thread(target=hammer, args=(w,)) for w in range(writers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        total = writers * per_writer
        assert rec.emitted == total
        assert rec.dropped == total - 256
        assert len(rec) == 256
        window = rec.snapshot()
        assert len(window) == 256 and all(ev is not None for ev in window)

    def test_snapshot_oldest_first_after_wrap(self):
        rec = telemetry.SpanRecorder(capacity=4)
        for i in range(10):
            rec.emit({"seq": i})
        assert [ev["seq"] for ev in rec.snapshot()] == [6, 7, 8, 9]
        assert rec.dropped == 6

    def test_capacity_validation_and_env_fallback(self, monkeypatch):
        with pytest.raises(ValueError):
            telemetry.SpanRecorder(capacity=0)
        monkeypatch.setenv("KSS_TRACE_RING_CAP", "32")
        assert telemetry.ring_capacity_from_env() == 32
        for bad in ("nope", "0", "-5", ""):
            monkeypatch.setenv("KSS_TRACE_RING_CAP", bad)
            assert telemetry.ring_capacity_from_env() == telemetry.DEFAULT_RING_CAP

    def test_dead_subscriber_never_breaks_emission(self):
        rec = telemetry.SpanRecorder(capacity=8)
        got = []

        def bad(ev):
            raise RuntimeError("subscriber died")

        rec.subscribe(bad)
        rec.subscribe(got.append)
        rec.emit({"name": "survives"})
        assert [ev["name"] for ev in got] == ["survives"]
        rec.unsubscribe(bad)
        rec.unsubscribe(got.append)
        rec.emit({"name": "after"})
        assert len(got) == 1


class TestOnOffSwitch:
    def test_off_by_default_emits_nothing(self, monkeypatch):
        monkeypatch.delenv(telemetry.ENV_VAR, raising=False)
        assert telemetry.active() is None
        assert not telemetry.enabled()
        with telemetry.span("never", pass_id=3):
            telemetry.instant("never")
        telemetry.complete("never", 0.0, 1.0)
        telemetry.counter("never", 1.0)

    def test_kss_trace_zero_emits_nothing(self, monkeypatch):
        monkeypatch.setenv(telemetry.ENV_VAR, "0")
        assert telemetry.active() is None
        with telemetry.span("never"):
            pass
        assert telemetry.span("never2") is telemetry.span("never3")  # the shared no-op

    def test_env_arms_a_recorder_with_env_capacity(self, monkeypatch):
        monkeypatch.setenv(telemetry.ENV_VAR, "1")
        monkeypatch.setenv(telemetry.CAP_VAR, "64")
        rec = telemetry.active()
        assert rec is not None and rec.capacity == 64
        with telemetry.span("seen"):
            pass
        assert [ev["ph"] for ev in rec.snapshot()] == ["B", "E"]

    def test_activate_overrides_env(self, monkeypatch):
        monkeypatch.setenv(telemetry.ENV_VAR, "0")
        mine = telemetry.SpanRecorder(capacity=16)
        telemetry.activate(mine)
        assert telemetry.active() is mine
        telemetry.instant("mark")
        assert len(mine) == 1
        telemetry.deactivate()
        assert telemetry.active() is None


class TestPassCausality:
    def test_spans_carry_the_current_pass_id(self):
        rec = telemetry.SpanRecorder(capacity=32)
        telemetry.activate(rec)
        with telemetry.pass_context(7):
            assert telemetry.current_pass_id() == 7
            with telemetry.span("inner"):
                telemetry.instant("mark")
            with telemetry.pass_context(8):
                telemetry.instant("nested")
            assert telemetry.current_pass_id() == 7
        assert telemetry.current_pass_id() is None
        passes = [ev["args"].get("pass") for ev in rec.snapshot()]
        assert passes == [7, 7, 7, 8]  # B, i(mark), E, i(nested)

    def test_session_context_stamps_and_restores(self):
        rec = telemetry.SpanRecorder(capacity=8)
        telemetry.activate(rec)
        with telemetry.session_context("s-a"):
            assert telemetry.current_session_id() == "s-a"
            telemetry.instant("mark")
            telemetry.complete("window", 1.0, 2.0, tid=telemetry.DEVICE_TID)
        assert telemetry.current_session_id() is None
        assert [ev["args"]["session"] for ev in rec.snapshot()] == ["s-a", "s-a"]

    def test_context_reenters_on_worker_threads(self):
        rec = telemetry.SpanRecorder(capacity=32)
        telemetry.activate(rec)
        armed_by = 41
        done = threading.Event()

        def worker():
            with telemetry.pass_context(armed_by):
                telemetry.instant("speculative-ish")
            done.set()

        threading.Thread(target=worker).start()
        assert done.wait(timeout=10)
        (ev,) = rec.snapshot()
        assert ev["args"]["pass"] == armed_by
        assert ev["tid"] != threading.get_ident()


class TestWellFormedness:
    def test_intervals_and_balanced_nesting(self):
        rec = telemetry.SpanRecorder(capacity=64)
        telemetry.activate(rec)
        with telemetry.span("outer"):
            with telemetry.span("inner"):
                pass
        telemetry.complete("window", 1.0, 2.0, tid=telemetry.DEVICE_TID)
        events = rec.snapshot()
        telemetry.check_nesting(events)
        ivs = {iv["name"]: iv for iv in telemetry.span_intervals(events)}
        assert set(ivs) == {"outer", "inner", "window"}
        assert ivs["window"]["tid"] == telemetry.DEVICE_TID
        assert ivs["window"]["end_us"] - ivs["window"]["start_us"] == 1e6
        assert ivs["inner"]["start_us"] >= ivs["outer"]["start_us"]
        assert ivs["inner"]["end_us"] <= ivs["outer"]["end_us"]

    def test_check_nesting_rejects_malformed(self):
        tid = 9
        with pytest.raises(ValueError, match="unmatched E"):
            telemetry.check_nesting([{"ph": "E", "name": "x", "tid": tid}])
        with pytest.raises(ValueError, match="interleaved"):
            telemetry.check_nesting([{"ph": "B", "name": "a", "tid": tid},
                                     {"ph": "B", "name": "b", "tid": tid},
                                     {"ph": "E", "name": "a", "tid": tid}])
        with pytest.raises(ValueError, match="unclosed"):
            telemetry.check_nesting([{"ph": "B", "name": "a", "tid": tid}])

    def test_ring_wrapped_window_tolerates_orphan_ends(self):
        rec = telemetry.SpanRecorder(capacity=4)
        telemetry.activate(rec)
        with telemetry.span("outer"):
            with telemetry.span("mid"):
                with telemetry.span("inner"):
                    pass
        events = rec.snapshot()
        assert rec.dropped > 0
        with pytest.raises(ValueError, match="unmatched E"):
            telemetry.check_nesting(events)
        telemetry.check_nesting(events, dropped=rec.dropped)
        tid = 9
        with pytest.raises(ValueError, match="interleaved"):
            telemetry.check_nesting([{"ph": "B", "name": "a", "tid": tid},
                                     {"ph": "B", "name": "b", "tid": tid},
                                     {"ph": "E", "name": "a", "tid": tid}], dropped=3)

    def test_chrome_trace_export_loadable(self, tmp_path):
        rec = telemetry.SpanRecorder(capacity=32)
        telemetry.activate(rec)
        with telemetry.span("pass.gang", pass_id=1):
            pass
        telemetry.complete("device.execute", 0.5, 1.5, tid=telemetry.DEVICE_TID, pass_id=1)
        out = tmp_path / "trace.json"
        assert telemetry.dump_chrome_trace(str(out), rec) == 3
        doc = json.loads(out.read_text())
        events = doc["traceEvents"]
        assert any(ev["ph"] == "M" and ev["name"] == "process_name" for ev in events)
        device_meta = [ev for ev in events if ev["ph"] == "M" and ev["name"] == "thread_name"
                       and ev["tid"] == telemetry.DEVICE_TID]
        assert device_meta and "device" in device_meta[0]["args"]["name"]
        assert doc["otherData"]["droppedEvents"] == 0
        empty = tmp_path / "empty.json"
        telemetry.deactivate()
        assert telemetry.dump_chrome_trace(str(empty)) == 0
        assert json.loads(empty.read_text())["traceEvents"][0]["name"] == "process_name"
        assert telemetry.clock_us() > 0


class TestServingSpans:
    @staticmethod
    def traced_passes(monkeypatch, census: bool):
        """A gang pass and a sequential pass of a 2-node store with tracing
        and stats on; with `census`, the card's allocator census stood in
        (the CPU keeps none)."""
        if census:
            monkeypatch.setattr(fleetstats, "buffer_census",
                                lambda service=None: {"liveBytes": 4096})
        rec = telemetry.SpanRecorder(capacity=4096)
        telemetry.activate(rec)
        fleetstats.activate(fleetstats.FleetRecorder(capacity=8))
        store = ResourceStore()
        for i in range(2):
            store.apply("nodes", node(f"fn{i}", cpu="4", mem="8Gi"))
        store.apply("pods", pod("fp0"))
        svc = SchedulerService(store, device="cpu")
        svc.session_id = "s-a"
        assert svc.next_pass_id_hint() == 1
        svc.schedule_gang(record=False)
        store.apply("pods", pod("fp1"))
        svc.schedule()
        assert svc.next_pass_id_hint() == 3
        return rec.snapshot()

    def test_pass_spans_nest_and_carry_their_pass(self, monkeypatch):
        events = self.traced_passes(monkeypatch, census=False)
        telemetry.check_nesting(events)
        passes = [ev for ev in events if ev["ph"] == "B" and ev["name"].startswith("pass.")]
        assert [(ev["name"], ev["args"]["pass"]) for ev in passes] == [
            ("pass.gang", 1), ("pass.sequential", 2)]
        ivs = telemetry.span_intervals(events)
        by_pass = {iv["args"]["pass"]: iv for iv in ivs if iv["name"].startswith("pass.")
                   and iv["name"] != "pass.encode"}
        for name, mode in (("pass.encode", None), ("device.execute", "gang"),
                           ("device.execute", "sequential")):
            got = [iv for iv in ivs if iv["name"] == name
                   and (mode is None or iv["args"]["mode"] == mode)]
            assert got, name
            for iv in got:
                outer = by_pass[iv["args"]["pass"]]
                assert outer["start_us"] <= iv["start_us"] <= iv["end_us"] <= outer["end_us"]
                assert iv["args"]["session"] == "s-a"
        assert all(iv["tid"] == telemetry.DEVICE_TID for iv in ivs
                   if iv["name"] == "device.execute")
        counters = {ev["name"] for ev in events if ev["ph"] == "C"}
        # the CPU has no allocator census: no hbm.bytesInUse there
        assert counters == FLEET_COUNTERS - {"hbm.bytesInUse"}

    def test_memory_counter_with_a_census(self, monkeypatch):
        events = self.traced_passes(monkeypatch, census=True)
        counters = [ev for ev in events if ev["ph"] == "C"]
        assert {ev["name"] for ev in counters} == FLEET_COUNTERS
        assert [ev["args"]["value"] for ev in counters if ev["name"] == "hbm.bytesInUse"] == [
            4096.0, 4096.0]
