"""The port's cross-tenant batch plane (server/batchplane.py) and its
sequential passes (`batch.seq.run`) against the reference's.

The reference's `tests/test_batchplane.py`, rebuilt on the port's session
plane (`device="cpu"`: the kernels' plain versions, each tenant's own in
turn). The parity pin: with a plane armed, every tenant of a window gets
placements and records (status, node and all 13 annotations) byte-identical
to the reference's solo dispatch of the same snapshot, preemption included
under TPU32 and EXACT (the reference pins its batched results equal to its
solo ones; its own batched window runs once in
test_torch_batchplane_reference.py, the other EXACT cases in
test_torch_batchplane_exact.py). Then the fallbacks (a recorded gang pass, incompatible shapes, a
failed batched launch), fairness and liveness (a lone tenant waits at most
one window, the window flushes on its timer behind a semaphore, a drain
flushes it, a window of one is born full), a session deleted mid-window, and
the plumbing (`from_env`, the manager arming every session, the counters).

The reference's solo results are computed once a (policy, fixture) for the
module (`ref_solo`). Not rebuilt: the async `begin_pass` cases (ROADMAP.md
queue 1 item 9: skipped with that reason), the fault-scoped session and the
program ledger (items 8 and 9). Tolerance: exact equality.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import threading
import time

import pytest

from kube_scheduler_simulator_tpu.server.batchplane import BatchPlane as JPlane
from kube_scheduler_simulator_tpu.server.service import SimulatorService as JSim
from kube_scheduler_simulator_tpu.server.sessions import SessionManager as JManager
from kube_scheduler_simulator_tpu.utils.metrics import SchedulingMetrics as JMetrics

from kube_scheduler_simulator_tpu_torch.engine import cuda
from kube_scheduler_simulator_tpu_torch.server import batchplane as bp
from kube_scheduler_simulator_tpu_torch.server.batchplane import BatchPlane, from_env
from kube_scheduler_simulator_tpu_torch.server.sessions import SessionManager
from kube_scheduler_simulator_tpu_torch.utils.metrics import SchedulingMetrics

from helpers import node, pod

N = 3
POLICIES = ("tpu32", "exact")
COUNTERS = ("batchedPasses", "batchWindows", "batchOccupancySum", "soloFallbacks",
            "batchedGangPasses")


def snapshot(i: int, preempt: bool = False) -> dict:
    """Tenant i's cluster (the reference's `_snapshot`): equal shapes for
    every i (one compile signature), the tenant's own values."""
    if preempt:
        return {
            "nodes": [node(f"n{j}", cpu="2") for j in range(2)],
            "pods": [
                pod("low-a", cpu="1500m", priority=1 + i, node_name="n0"),
                pod("low-b", cpu="1500m", priority=1, node_name="n1"),
                pod("high", cpu=f"{1200 + 100 * i}m", priority=100),
                pod("filler", cpu="300m", priority=50),
            ],
        }
    return {
        "nodes": [node(f"n{j}", cpu="16") for j in range(3)],
        "pods": [pod(f"p{j}", cpu=f"{100 + 100 * i + 50 * j}m") for j in range(4)],
    }


def results_doc(results) -> str:
    """One canonical byte string of a pass's records: status, placement and
    the 13 annotations."""
    return json.dumps([{"ns": r.pod_namespace, "name": r.pod_name, "status": r.status,
                        "node": r.selected_node, "ann": r.to_annotations()}
                       for r in results], sort_keys=True)


@contextlib.contextmanager
def dtype_policy(name: str):
    """KSS_DTYPE_POLICY for both packages' encoders."""
    old = os.environ.get("KSS_DTYPE_POLICY")
    os.environ["KSS_DTYPE_POLICY"] = name
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("KSS_DTYPE_POLICY", None)
        else:
            os.environ["KSS_DTYPE_POLICY"] = old


def manager(max_passes: int = 8, ref: bool = False):
    if ref:
        return JManager(JSim(), max_sessions=16, max_concurrent_passes=max_passes)
    return SessionManager(max_sessions=16, max_concurrent_passes=max_passes, device="cpu")


def armed(window_ms: float = 5000.0, max_sessions: int = N, max_passes: int = 8,
          max_wait_ms: "float | None" = None, ref: bool = False):
    """A manager with a plane armed by hand (the reference tests' way)."""
    mgr = manager(max_passes, ref)
    cls = JPlane if ref else BatchPlane
    plane = cls(window_ms=window_ms, max_wait_ms=max_wait_ms, max_sessions=max_sessions,
                metrics=mgr.get("default").service.scheduler.metrics)
    mgr.batch_plane = plane
    mgr.get("default").service.scheduler.batch_plane = plane
    return mgr, plane


def phases(sess) -> dict:
    """The batching counters of a session (either package's)."""
    m = sess.service.scheduler.metrics
    ph = m.snapshot()["phases"] if hasattr(m, "snapshot") else m.phases()
    return {k: ph[k] for k in COUNTERS}


def concurrent(mgr, sessions, fn):
    """Run fn(session) for every session at once, barrier-aligned so that all
    enroll in one window (which flushes only when full). Returns {i: out}."""
    out, errors = {}, {}
    barrier = threading.Barrier(len(sessions))

    def run(i):
        try:
            barrier.wait(timeout=30)
            with mgr.pass_slot():
                out[i] = fn(sessions[i])
        except Exception as e:  # noqa: BLE001 — surfaced by the assert
            errors[i] = repr(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(sessions))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    assert not errors, errors
    assert len(out) == len(sessions)
    return out


def schedule_doc(sess) -> str:
    return results_doc(sess.service.scheduler.schedule())


@functools.lru_cache(maxsize=None)
def ref_solo(policy: str, preempt: bool) -> "dict[int, str]":
    """The reference's solo records of each tenant (an unarmed manager),
    computed once for the module."""
    with dtype_policy(policy):
        mgr = manager(ref=True)
        try:
            return {i: schedule_doc(mgr.create(name=f"solo{i}", snapshot=snapshot(i, preempt))[0])
                    for i in range(N)}
        finally:
            mgr.shutdown()


def batched_run(ref: bool, preempt: bool, n: int = N, **kw):
    """N tenants' passes through one armed window: (records by tenant,
    counters by tenant, the default session's counters)."""
    mgr, _ = armed(ref=ref, **kw)
    try:
        sessions = [mgr.create(name=f"t{i}", snapshot=snapshot(i, preempt))[0]
                    for i in range(n)]
        out = concurrent(mgr, sessions, schedule_doc)
        return out, [phases(s) for s in sessions], phases(mgr.get("default"))
    finally:
        mgr.shutdown()


class TestBatchedParity:
    @pytest.mark.parametrize("policy", ["tpu32"])
    def test_sync_parity_and_counters(self, policy):
        solo = ref_solo(policy, False)
        cuda.reset_counts()
        with dtype_policy(policy):
            out, per, default = batched_run(ref=False, preempt=False)
        for i in range(N):
            assert out[i] == solo[i], f"tenant {i} differs from the reference's solo pass"
        # one window, filled by all N passes, served by one batched launch
        assert cuda.PLAIN_CALLS["batch_run"] == 1 and cuda.PLAIN_CALLS["seq_run"] == 0
        assert default["batchWindows"] == 1 and default["batchOccupancySum"] == N
        for ph in per:
            assert ph["batchedPasses"] == 1 and ph["soloFallbacks"] == 0

    @pytest.mark.parametrize("policy", POLICIES)
    def test_preemption_parity(self, policy):
        """The preemption branch in the tenant form (each tenant's own dry
        runs, victims and retry) gives the reference's solo records."""
        solo = ref_solo(policy, True)
        assert any('"Nominated"' in d for d in solo.values()), "the fixture must preempt"
        with dtype_policy(policy):
            out, per, _ = batched_run(ref=False, preempt=True)
        for i in range(N):
            assert out[i] == solo[i], f"tenant {i} differs from the reference's solo pass"
        assert all(ph["batchedPasses"] == 1 for ph in per)

    @pytest.mark.skip(reason="the async begin_pass pipeline is not ported (ROADMAP.md queue 1 "
                             "item 9)")
    def test_async_begin_pass_parity(self):
        pass


class TestFallbacks:
    def test_recorded_gang_pass_falls_back_solo(self):
        """A recorded gang pass never enrolls: solo, counted once, and its
        placements and records equal an unarmed manager's."""
        solo_mgr = manager()
        try:
            s, _ = solo_mgr.create(name="g0", snapshot=snapshot(0))
            solo_placements, _, solo_results = s.service.scheduler.schedule_gang()
        finally:
            solo_mgr.shutdown()
        mgr, _ = armed(window_ms=50.0)
        try:
            sess, _ = mgr.create(name="g", snapshot=snapshot(0))
            placements, _, results = sess.service.scheduler.schedule_gang()
            assert placements == solo_placements
            assert results_doc(results) == results_doc(solo_results)
            ph = phases(sess)
            assert ph["soloFallbacks"] == 1 and ph["batchedPasses"] == 0
            assert ph["batchedGangPasses"] == 0
            assert phases(mgr.get("default"))["batchWindows"] == 0
        finally:
            mgr.shutdown()

    def test_incompatible_shapes_never_share_a_window(self):
        """Different compile signatures key different windows: both passes
        complete solo, each counted once, with an unarmed manager's records."""
        big = {"nodes": [node(f"n{j}", cpu="16") for j in range(12)],
               "pods": [pod(f"p{j}", cpu="100m") for j in range(4)]}
        snaps = [snapshot(0), big]
        solo_mgr = manager()
        try:
            solo = [schedule_doc(solo_mgr.create(snapshot=sn)[0]) for sn in snaps]
        finally:
            solo_mgr.shutdown()
        mgr, _ = armed(window_ms=150.0, max_sessions=4)
        try:
            sessions = [mgr.create(snapshot=sn)[0] for sn in snaps]
            out = concurrent(mgr, sessions, schedule_doc)
            assert [out[0], out[1]] == solo
            for sess in sessions:
                ph = phases(sess)
                assert ph["batchedPasses"] == 0 and ph["soloFallbacks"] == 1
        finally:
            mgr.shutdown()

    def test_failed_batched_launch_falls_back_per_session(self, monkeypatch):
        """Any failure inside the batched execution sends every enrollee
        solo: each answer still equals the reference's solo one."""
        solo = ref_solo("tpu32", False)

        def boom(self, kind, key, items):
            raise RuntimeError("injected batch failure")

        monkeypatch.setattr(BatchPlane, "_execute_inner", boom)
        with dtype_policy("tpu32"):
            out, per, default = batched_run(ref=False, preempt=False)
        for i in range(N):
            assert out[i] == solo[i]
        assert all(ph["soloFallbacks"] == 1 and ph["batchedPasses"] == 0 for ph in per)
        assert default["batchWindows"] == 0


def repend(sess, i):
    """Delete tenant i's pods and import them again, pending."""
    for p in snapshot(i)["pods"]:
        sess.service.store.delete("pods", p["metadata"]["name"], "default")
    sess.service.import_({"pods": snapshot(i)["pods"]})


class TestFairnessAndLiveness:
    def test_lone_tenant_bounded_by_one_window(self):
        mgr, _ = armed(window_ms=150.0, max_sessions=4)
        try:
            sess, _ = mgr.create(name="lone", snapshot=snapshot(0))
            sess.service.scheduler.schedule()
            repend(sess, 0)
            t0 = time.monotonic()
            assert sess.service.scheduler.schedule()
            elapsed = time.monotonic() - t0
            assert elapsed < 2.0, f"lone tenant waited {elapsed:.2f}s"
            ph = phases(sess)
            assert ph["soloFallbacks"] == 2 and ph["batchedPasses"] == 0
            assert phases(mgr.get("default"))["batchWindows"] == 0
        finally:
            mgr.shutdown()

    def test_concurrent_windows_of_different_keys(self):
        """A sequential window and a gang window open at once (two batch
        keys, a leader thread each): both flush full and run batched, none
        of their passes falls back, and each tenant's answer equals its solo
        one (the reference's records; an unarmed manager's placements)."""
        solo = ref_solo("tpu32", False)
        with dtype_policy("tpu32"):
            solo_mgr = manager()
            try:
                want_gang = [solo_mgr.create(snapshot=snapshot(i))[0].service.scheduler
                             .schedule_gang(record=False)[0] for i in range(2)]
            finally:
                solo_mgr.shutdown()
            cuda.reset_counts()
            mgr, _ = armed(max_sessions=2)
            try:
                seq = [mgr.create(name=f"s{i}", snapshot=snapshot(i))[0] for i in range(2)]
                gang = [mgr.create(name=f"g{i}", snapshot=snapshot(i))[0] for i in range(2)]
                out = concurrent(mgr, seq + gang, lambda s: schedule_doc(s) if s in seq else
                                 s.service.scheduler.schedule_gang(record=False)[0])
                per = [phases(s) for s in seq + gang]
                default = phases(mgr.get("default"))
            finally:
                mgr.shutdown()
        assert [out[0], out[1]] == [solo[0], solo[1]]
        assert [out[2], out[3]] == want_gang
        assert (default["batchWindows"], default["batchOccupancySum"]) == (2, 4)
        for i, ph in enumerate(per):
            assert (ph["batchedPasses"], ph["soloFallbacks"], ph["batchedGangPasses"]) == (
                1, 0, int(i >= 2)), (i, ph)
        assert cuda.PLAIN_CALLS["batch_run"] == 1 and cuda.PLAIN_CALLS["batch_eval"] > 0

    def test_max_wait_caps_the_window(self):
        for cls in (BatchPlane, JPlane):
            assert cls(window_ms=60000.0, max_wait_ms=100.0).wait_s == pytest.approx(0.1)
            assert cls(window_ms=50.0).wait_s == pytest.approx(0.05)

    def test_one_session_windows_are_born_full(self):
        """max_sessions=1: the window closes at once (no wait out of a long
        window) and its lone pass goes solo."""
        mgr, _ = armed(window_ms=60000.0, max_sessions=1)
        try:
            sess, _ = mgr.create(snapshot=snapshot(0))
            t0 = time.monotonic()
            assert sess.service.scheduler.schedule()
            assert time.monotonic() - t0 < 30
            assert phases(sess)["soloFallbacks"] == 1
        finally:
            mgr.shutdown()

    def test_semaphore_waiters_do_not_deadlock_on_the_window(self):
        """One concurrent-pass slot: the second session's pass waits on the
        slot while the first sits out its window, which must flush on its
        timer, so both complete."""
        mgr, _ = armed(window_ms=200.0, max_sessions=4, max_passes=1)
        try:
            sessions = [mgr.create(name=f"t{i}", snapshot=snapshot(i))[0] for i in range(2)]
            for i, sess in enumerate(sessions):
                sess.service.scheduler.schedule()
                repend(sess, i)
            done, errors = [], {}

            def run(i):
                try:
                    for _ in range(400):
                        try:
                            with mgr.pass_slot():
                                sessions[i].service.scheduler.schedule()
                            done.append(i)
                            return
                        except Exception as e:  # noqa: BLE001
                            if "concurrent-pass" not in str(e):
                                raise
                            time.sleep(0.02)
                    errors[i] = "never got a slot"
                except Exception as e:  # noqa: BLE001
                    errors[i] = repr(e)

            ts = [threading.Thread(target=run, args=(i,)) for i in range(2)]
            t0 = time.monotonic()
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=120)
            assert not errors, errors
            assert sorted(done) == [0, 1]
            assert time.monotonic() - t0 < 60
        finally:
            mgr.shutdown()

    def test_drain_flushes_a_partial_window(self):
        """A pass sitting out a long window is flushed by the plane's drain
        (`begin_drain`, what the manager's shutdown calls), and new passes
        go solo at once."""
        mgr, plane = armed(window_ms=30000.0, max_sessions=4)
        try:
            sess, _ = mgr.create(name="d", snapshot=snapshot(0))
            state = {}

            def run():
                t0 = time.monotonic()
                with mgr.pass_slot():
                    state["doc"] = schedule_doc(sess)
                state["elapsed"] = time.monotonic() - t0

            th = threading.Thread(target=run)
            th.start()
            time.sleep(0.4)  # the pass enrolls and sits in its window
            assert plane.stats()["openWindows"] == 1
            plane.begin_drain()
            th.join(timeout=30)
            assert "elapsed" in state, "the drain left the enrolled pass stuck"
            assert state["elapsed"] < 10.0, state
            st = plane.stats()
            assert st["openWindows"] == 0 and st["draining"] is True
            repend(sess, 0)
            t0 = time.monotonic()
            sess.service.scheduler.schedule()
            assert time.monotonic() - t0 < 10.0
            assert phases(sess)["soloFallbacks"] == 2
        finally:
            mgr.shutdown()

    def test_abandoned_follower_is_not_counted_batched(self, monkeypatch):
        """A follower whose wait on the leader expires dispatches solo and is
        marked abandoned; the late leader counts only the passes it served."""
        monkeypatch.setattr(bp, "_FOLLOWER_TIMEOUT_S", 0.05)
        real = BatchPlane._execute_inner

        def slow(self, kind, key, items):
            time.sleep(0.5)
            return real(self, kind, key, items)

        monkeypatch.setattr(BatchPlane, "_execute_inner", slow)
        solo = ref_solo("tpu32", False)
        with dtype_policy("tpu32"):
            out, per, default = batched_run(ref=False, preempt=False)
        assert [out[i] for i in range(N)] == [solo[i] for i in range(N)]
        assert sorted(ph["batchedPasses"] for ph in per) == [0, 0, 1]
        assert sorted(ph["soloFallbacks"] for ph in per) == [0, 1, 1]
        assert default["batchWindows"] == 1 and default["batchOccupancySum"] == N


class TestMidBatchDelete:
    def test_mid_batch_session_delete(self):
        """A session deleted while its pass waits in a window: the pass
        still completes (its write-backs land on the orphaned store), and
        both enrollees equal the reference's solo records."""
        solo = ref_solo("tpu32", False)
        with dtype_policy("tpu32"):
            mgr, _ = armed(window_ms=1500.0, max_sessions=3)
            try:
                a, _ = mgr.create(name="a", snapshot=snapshot(0))
                b, _ = mgr.create(name="b", snapshot=snapshot(1))
                out, errors = {}, {}
                barrier = threading.Barrier(3)

                def run(i, sess):
                    try:
                        barrier.wait(timeout=30)
                        with mgr.pass_slot():
                            out[i] = schedule_doc(sess)
                    except Exception as e:  # noqa: BLE001
                        errors[i] = repr(e)

                def deleter():
                    barrier.wait(timeout=30)
                    time.sleep(0.2)  # mid-window: both passes enrolled
                    mgr.delete(b.id)

                ts = [threading.Thread(target=run, args=(0, a)),
                      threading.Thread(target=run, args=(1, b)),
                      threading.Thread(target=deleter)]
                for t in ts:
                    t.start()
                for t in ts:
                    t.join(timeout=120)
                assert not errors, errors
                assert out[0] == solo[0] and out[1] == solo[1]
                with pytest.raises(KeyError):
                    mgr.get(b.id)
                assert phases(a)["batchedPasses"] == phases(b)["batchedPasses"] == 1
            finally:
                mgr.shutdown()


class TestPlumbing:
    def test_from_env(self, monkeypatch):
        from kube_scheduler_simulator_tpu.server.batchplane import from_env as j_from_env

        monkeypatch.delenv("KSS_BATCH", raising=False)
        assert from_env() is None and j_from_env() is None
        for env in ({"KSS_BATCH": "1"},
                    {"KSS_BATCH": "t", "KSS_BATCH_WINDOW_MS": "25", "KSS_BATCH_MAX_WAIT_MS": "10",
                     "KSS_BATCH_MAX_SESSIONS": "4"},
                    # malformed values fall back, as the reference's lenient knobs do
                    {"KSS_BATCH": "yes", "KSS_BATCH_WINDOW_MS": "nope",
                     "KSS_BATCH_MAX_SESSIONS": "2.5"},
                    {"KSS_BATCH": "on", "KSS_BATCH_WINDOW_MS": "-3",
                     "KSS_BATCH_MAX_SESSIONS": "0"}):
            for k in ("KSS_BATCH_WINDOW_MS", "KSS_BATCH_MAX_WAIT_MS", "KSS_BATCH_MAX_SESSIONS"):
                monkeypatch.delenv(k, raising=False)
            for k, v in env.items():
                monkeypatch.setenv(k, v)
            got, want = from_env(), j_from_env()
            assert (got.window_s, got.wait_s, got.max_sessions) == (
                want.window_s, want.wait_s, want.max_sessions), env
        monkeypatch.setenv("KSS_BATCH", "1")
        monkeypatch.delenv("KSS_BATCH_WINDOW_MS")
        monkeypatch.delenv("KSS_BATCH_MAX_SESSIONS")
        plane = from_env()
        assert plane.window_s == pytest.approx(0.005) and plane.max_sessions == 8

    def test_session_manager_arms_from_env(self, monkeypatch):
        monkeypatch.setenv("KSS_BATCH", "1")
        mgr = manager()
        try:
            assert mgr.batch_plane is not None
            assert mgr.get("default").service.scheduler.batch_plane is mgr.batch_plane
            sess, _ = mgr.create(name="t")
            assert sess.service.scheduler.batch_plane is mgr.batch_plane
            assert sess.service.scheduler.session_id == sess.id
            stats = mgr.stats()["batching"]
            assert stats["armed"] is True and stats["maxSessions"] == 8
        finally:
            mgr.shutdown()
        assert mgr.batch_plane.stats()["draining"] is True

    def test_stats_unarmed(self):
        mgr = manager()
        try:
            assert mgr.stats()["batching"] == {"armed": False}
        finally:
            mgr.shutdown()

    def test_batching_counters_match_the_reference(self):
        got, want = SchedulingMetrics(), JMetrics()
        for m in (got, want):
            m.record_batching(batched_passes=3, windows=2, occupancy=5, solo_fallbacks=1)
            m.record_gang(fixpoint_rounds=7, batched_passes=2)
            m.record_gang(fixpoint_rounds=3)
        snap = want.snapshot()
        assert {k: got.phases()[k] for k in COUNTERS + ("gangFixpointRounds",)} == {
            k: snap["phases"][k] for k in COUNTERS + ("gangFixpointRounds",)}
        assert snap["batching"] == {"batchOccupancy": 2.5}
        assert snap["phases"]["batchOccupancySum"] / snap["phases"]["batchWindows"] == 2.5
