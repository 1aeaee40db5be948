"""The port's session plane (server/sessions.py) against the reference's.

The cases of the reference's `tests/test_sessions.py` that the port's cut
covers, driven on both packages' `SessionManager`s where the behaviour is
the manager's own: session create/get/list/delete and explicit ids,
isolation between sessions (a session's pass equals the reference
session's records and touches no other session), the admission limits
(KSS_MAX_SESSIONS, the pending-pod quota on single pods, replaces and bulk
imports, KSS_MAX_CONCURRENT_PASSES) with their exceptions, and the strict
parsing of the admission knobs. The port's services run on the manager's
device (`device="cpu"` here). Not rebuilt (ROADMAP.md queue 1 item 8): the
HTTP routes, fork, eviction and restore, drain, journals and replication,
readiness, SSE and telemetry labels. Tolerance: exact equality.
"""

from __future__ import annotations

import json

import pytest

from kube_scheduler_simulator_tpu.server.service import SimulatorService as JSim
from kube_scheduler_simulator_tpu.server.sessions import SessionManager as JManager

from kube_scheduler_simulator_tpu_torch.server import sessions as S
from kube_scheduler_simulator_tpu_torch.server.sessions import SessionManager

from helpers import node, pod
from test_torch_batchplane import results_doc


def managers(**kw):
    """(the port's manager on the CPU, the reference's)."""
    return SessionManager(device="cpu", **kw), JManager(JSim(), **kw)


def outcome(fn):
    """The exception class's name fn raises, or None."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — compared across packages
        return type(e).__name__
    return None


class TestCrudAndIsolation:
    def test_create_list_get_delete(self):
        mgr = SessionManager(device="cpu")
        sess, errors = mgr.create(name="tenant-a")
        assert errors == [] and sess.id.startswith("s-") and sess.name == "tenant-a"
        assert set(mgr.session_ids()) == {"default", sess.id}
        assert [d["id"] for d in mgr.list_info()] == ["default", sess.id]
        info = mgr.info(sess.id)
        assert info["name"] == "tenant-a" and info["passes"] == 0 and info["pods"] == 0
        assert mgr.get(sess.id) is sess
        assert [sid for sid, _ in mgr.live_services()] == ["default", sess.id]
        mgr.delete(sess.id)
        with pytest.raises(S.UnknownSession) as e:
            mgr.get(sess.id)
        assert isinstance(e.value, KeyError) and sess.id in str(e.value)
        with pytest.raises(S.UnknownSession):
            mgr.delete(sess.id)
        with pytest.raises(ValueError, match="default session"):
            mgr.delete("default")

    def test_explicit_session_ids(self):
        mgr, ref = managers()
        for sid in ("tenant.1", "a" * 64, "bad id", "a" * 65, "default", "", "tenant.1"):
            assert outcome(lambda: mgr.create(session_id=sid)) == outcome(
                lambda: ref.create(session_id=sid)), sid
        assert {"tenant.1", "a" * 64} <= set(mgr.session_ids())

    def test_sessions_are_isolated_and_equal_the_reference(self):
        """Scheduling in A binds A's pod only; B and the default session see
        nothing, and A's records equal the reference session's."""
        mgr, ref = managers()
        docs = []
        for m in (mgr, ref):
            a, _ = m.create()
            b, _ = m.create()
            with m.using(a.id) as sa:
                sa.service.store.apply("nodes", node("n0"))
                sa.service.store.apply("pods", pod("w"))
                docs.append(results_doc(sa.service.scheduler.schedule()))
            assert [p["spec"]["nodeName"] for p in a.service.store.list("pods")] == ["n0"]
            for other in (b, m.get("default")):
                assert other.service.store.list("pods") == []
                assert other.service.store.count("nodes") == 0
        assert docs[0] == docs[1]
        assert mgr.info(mgr.session_ids()[1])["totalScheduled"] == 1
        assert mgr.get(mgr.session_ids()[1])._active_requests == 0

    def test_create_with_snapshot_imports(self):
        mgr = SessionManager(device="cpu")
        sess, errors = mgr.create(snapshot={"nodes": [node("sn0")], "pods": [pod("sp0")]})
        assert errors == []
        assert [n["metadata"]["name"] for n in sess.service.store.list("nodes")] == ["sn0"]
        assert mgr.info(sess.id)["pendingPods"] == 1

    def test_services_run_on_the_managers_device(self):
        mgr = SessionManager(device="cpu")
        sess, _ = mgr.create()
        assert sess.service.scheduler.device.type == "cpu"
        assert mgr.get("default").service.scheduler.device.type == "cpu"


class TestAdmission:
    def test_session_limit_sheds(self):
        mgr, ref = managers(max_sessions=2)  # default + 1
        for m in (mgr, ref):
            m.create()
        assert outcome(mgr.create) == outcome(ref.create) == "SessionLimitExceeded"
        assert S.SessionLimitExceeded.retry_after_s == 5
        assert len(mgr.session_ids()) == 2

    def test_pending_pod_quota(self):
        """Growth of the pending queue is metered; updates of pending pods,
        bound pods and merges onto bound pods are not; a replace that unbinds
        is."""
        mgr, ref = managers(pending_pod_quota=2)
        ops = [("a", pod("a"), False), ("b", pod("b"), False), ("c", pod("c"), False),
               ("d", pod("d", node_name="n0"), False),
               ("a", {**pod("a"), "metadata": {"name": "a", "namespace": "default",
                                               "labels": {"tier": "gold"}}}, False),
               ("a", pod("a"), True), ("d", pod("d"), False), ("d", pod("d"), True)]
        got = {}
        for m in (mgr, ref):
            svc = m.create()[0].service
            seen = []
            for _, obj, replace in ops:
                r = outcome(lambda: m.admit_pod(svc, obj, replace=replace))
                seen.append(r)
                if r is None:
                    (svc.store.replace if replace else svc.store.apply)("pods", obj)
            got[m is ref] = seen
        assert got[False] == got[True]
        assert got[False][2] == "SessionQuotaExceeded" and got[False][7] == "SessionQuotaExceeded"
        assert got[False][:2] == [None, None] and got[False][3] is None

    def test_bulk_admission(self):
        """An import (or a create's snapshot) past the quota is shed whole,
        leaving nothing behind; bound pods do not count."""
        mgr, ref = managers(pending_pod_quota=2)
        for m in (mgr, ref):
            svc = m.create()[0].service
            assert outcome(lambda: m.admit_import(
                svc, {"pods": [pod(f"q{i}") for i in range(3)]})) == "SessionQuotaExceeded"
            assert outcome(lambda: m.admit_import(
                svc, {"pods": [pod(f"b{i}", node_name="n0") for i in range(5)]
                      + [pod("p0")]})) is None
            before = len(m.session_ids())
            assert outcome(lambda: m.create(
                snapshot={"pods": [pod("a"), pod("b"), pod("c")]})) == "SessionQuotaExceeded"
            assert len(m.session_ids()) == before

    def test_concurrent_pass_slots_shed(self):
        mgr = SessionManager(device="cpu", max_concurrent_passes=1)
        with mgr.pass_slot():
            with pytest.raises(S.ServerSaturated, match="KSS_MAX_CONCURRENT_PASSES"):
                with mgr.pass_slot():
                    pass
        with mgr.pass_slot():
            pass
        assert S.ServerSaturated.retry_after_s == 1 and S.SessionQuotaExceeded.retry_after_s == 2
        assert issubclass(S.SessionBusy, RuntimeError)

    def test_env_knobs(self):
        """KSS_MAX_* are read strictly (a malformed value raises), as the
        reference reads them; arguments override them."""
        for env in ({"KSS_MAX_SESSIONS": "lots"}, {"KSS_MAX_CONCURRENT_PASSES": "0"},
                    {"KSS_MAX_PENDING_PODS_PER_SESSION": "-1"}):
            with pytest.raises(ValueError) as got:
                SessionManager(device="cpu", env=env)
            with pytest.raises(ValueError) as want:
                JManager(JSim(), env=env)
            assert str(got.value) == str(want.value)
        env = {"KSS_MAX_SESSIONS": "3", "KSS_MAX_PENDING_PODS_PER_SESSION": "7",
               "KSS_MAX_CONCURRENT_PASSES": "2"}
        mgr, ref = SessionManager(device="cpu", env=env), JManager(JSim(), env=env)
        for m in (mgr, ref):
            stats = m.stats()
            assert (stats["maxSessions"], stats["maxPendingPodsPerSession"],
                    stats["maxConcurrentPasses"]) == (3, 7, 2)
        assert SessionManager(device="cpu", env=env, max_sessions=9).max_sessions == 9
        d = SessionManager(device="cpu", env={}).stats()
        assert (d["maxSessions"], d["maxPendingPodsPerSession"], d["maxConcurrentPasses"]) == (
            64, 0, 4)
        assert json.dumps(d["batching"]) == '{"armed": false}'
