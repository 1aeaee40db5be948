"""The multi-tenant session plane: many isolated simulations in one process.

The reference package's `server/sessions.py`, cut to the core. Each session
owns its own `SimulatorService`: its `ResourceStore`, its
`SchedulerService` with its metrics, encoding cache, delta encoder and
engines. The manager admits sessions and requests:

  * ``KSS_MAX_SESSIONS`` bounds the session count (the default session
    included), ``KSS_MAX_PENDING_PODS_PER_SESSION`` bounds each tenant's
    pending queue (0: unlimited; `admit_pod`, `admit_import`), and
    ``KSS_MAX_CONCURRENT_PASSES`` bounds the device-driving requests in
    flight (`pass_slot`); each sheds with its own exception;
  * with ``KSS_BATCH`` set it arms one cross-tenant batch plane
    (server/batchplane.py) and hands it to every session's scheduler, so
    concurrent compatible passes of different sessions run as one launch;
  * it tells the fleet observatory (utils/fleetstats.py) which sessions
    exist, through a weakref-backed provider (the census counts them, the
    exposition drops a deleted tenant's gauges), and a deleted session's
    pending-age stamps are purged.

The ``default`` session wraps the service the manager is given (or a new
one). Every service runs on `device` (the CUDA card unless the caller names
another). Under ``KSS_DTYPE_POLICY=packed`` a session keeps only its packed
encoding between passes: the widened planes live while a pass runs.

Not ported (ROADMAP.md queue 1 item 8): idle eviction and restore,
snapshots, `fork`, `drain`/`adopt_snapshots`, journals, replication,
per-session fault planes and SLO planes, the shared compile broker.
"""

from __future__ import annotations

import os
import secrets
import threading
import time
import weakref
from contextlib import contextmanager

import torch

from ..utils import fleetstats
from . import batchplane as batchplane_mod
from .service import SimulatorService

DEFAULT_SESSION_ID = "default"


class UnknownSession(KeyError):
    """No session with that id."""

    def __init__(self, sid: str):
        super().__init__(sid)
        self.sid = sid

    def __str__(self):
        return f"unknown session {self.sid!r}"


class SessionLimitExceeded(RuntimeError):
    """KSS_MAX_SESSIONS reached: session creation is shed."""

    retry_after_s = 5


class SessionQuotaExceeded(RuntimeError):
    """A session's pending-pod quota is full: the mutation is shed until the
    tenant schedules or deletes some of its queue."""

    retry_after_s = 2


class ServerSaturated(RuntimeError):
    """Every concurrent-pass slot is taken: the device-driving request is
    shed instead of queueing behind the device."""

    retry_after_s = 1


class SessionBusy(RuntimeError):
    """The session has a pass in flight (the reference's eviction refusal;
    kept for its callers)."""


def _env_int(env, name: str, default: int, minimum: int) -> int:
    raw = env.get(name, "")
    if not raw:
        return default
    try:
        v = int(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r}: expected an integer") from None
    if v < minimum:
        raise ValueError(f"{name}={raw!r}: must be >= {minimum}")
    return v


class Session:
    """One tenant: an id, a name and its `SimulatorService`."""

    def __init__(self, sid: str, name: str, service: SimulatorService):
        self.id = sid
        self.name = name
        self.service = service
        self.state = "live"
        self.created_at = time.time()
        self.last_touch = time.monotonic()
        # requests routed into this session (`using`), under the manager lock
        self._active_requests = 0

    def info(self) -> dict:
        svc = self.service
        passes = svc.scheduler.metrics.passes()
        return {
            "id": self.id,
            "name": self.name,
            "state": self.state,
            "createdAt": round(self.created_at, 3),
            "idleSeconds": round(time.monotonic() - self.last_touch, 3),
            "passes": len(passes),
            "totalScheduled": sum(p.scheduled for p in passes),
            "pendingPods": svc.store.count_pending_pods(),
            "pods": svc.store.count("pods"),
            "nodes": svc.store.count("nodes"),
        }


class SessionManager:
    """Owns every session, the admission knobs and the batch plane."""

    def __init__(
        self,
        default_service: "SimulatorService | None" = None,
        *,
        max_sessions: "int | None" = None,
        pending_pod_quota: "int | None" = None,
        max_concurrent_passes: "int | None" = None,
        env: "dict | None" = None,
        device: "str | torch.device | None" = None,
    ):
        env = os.environ if env is None else env
        self.max_sessions = (max_sessions if max_sessions is not None
                             else _env_int(env, "KSS_MAX_SESSIONS", 64, 1))
        # 0 = unlimited
        self.pending_pod_quota = (
            pending_pod_quota if pending_pod_quota is not None
            else _env_int(env, "KSS_MAX_PENDING_PODS_PER_SESSION", 0, 0))
        self.max_concurrent_passes = (
            max_concurrent_passes if max_concurrent_passes is not None
            else _env_int(env, "KSS_MAX_CONCURRENT_PASSES", 4, 1))
        if default_service is None:
            default_service = SimulatorService(device=device)
        # every session's service runs where the default session's does
        self.device = default_service.scheduler.device
        self._lock = threading.RLock()
        self._pass_sem = threading.BoundedSemaphore(self.max_concurrent_passes)
        # the cross-tenant batch plane (KSS_BATCH): window and occupancy
        # counters land on the default session's registry
        self.batch_plane = batchplane_mod.from_env(metrics=default_service.scheduler.metrics)
        default_service.scheduler.session_id = DEFAULT_SESSION_ID
        default_service.scheduler.batch_plane = self.batch_plane
        self._sessions: "dict[str, Session]" = {
            DEFAULT_SESSION_ID: Session(DEFAULT_SESSION_ID, DEFAULT_SESSION_ID, default_service)
        }
        # the fleet observatory reads the known session ids through this
        # hook (the most recent manager wins); weakref-backed, so a dropped
        # manager does not stay reachable through a module global
        manager_ref = weakref.ref(self)

        def _known_session_ids() -> "list[str] | None":
            mgr = manager_ref()
            return None if mgr is None else mgr.session_ids()

        fleetstats.set_session_provider(_known_session_ids)

    # -- lookup ----------------------------------------------------------------

    def get(self, sid: str, touch: bool = True, track: bool = False) -> Session:
        """The session; `track` registers the caller as a request in flight
        (pair it with `using`)."""
        with self._lock:
            sess = self._sessions.get(sid)
            if sess is None:
                raise UnknownSession(sid)
            if touch:
                sess.last_touch = time.monotonic()
            if track:
                sess._active_requests += 1
            return sess

    @contextmanager
    def using(self, sid: str):
        """Route a request into a session for the duration of the block."""
        sess = self.get(sid, track=True)
        try:
            yield sess
        finally:
            with self._lock:
                sess._active_requests -= 1
                sess.last_touch = time.monotonic()

    def info(self, sid: str) -> dict:
        with self._lock:
            sess = self._sessions.get(sid)
            if sess is None:
                raise UnknownSession(sid)
            return sess.info()

    def list_info(self) -> list[dict]:
        with self._lock:
            return [s.info() for s in sorted(self._sessions.values(),
                                             key=lambda s: s.created_at)]

    def live_services(self) -> "list[tuple[str, SimulatorService]]":
        """One consistent cut of every session's (id, service)."""
        with self._lock:
            return [(s.id, s.service) for s in sorted(self._sessions.values(),
                                                      key=lambda s: s.created_at)]

    def session_ids(self) -> "list[str]":
        with self._lock:
            return list(self._sessions)

    def stats(self) -> dict:
        with self._lock:
            return {
                "sessions": len(self._sessions),
                "live": len(self._sessions),
                "maxSessions": self.max_sessions,
                "maxPendingPodsPerSession": self.pending_pod_quota,
                "maxConcurrentPasses": self.max_concurrent_passes,
                # the batch plane's configuration and open windows
                "batching": (self.batch_plane.stats() if self.batch_plane is not None
                             else {"armed": False}),
            }

    # -- create / delete ---------------------------------------------------------

    def create(self, name: "str | None" = None, snapshot: "dict | None" = None,
               session_id: "str | None" = None) -> "tuple[Session, list[str]]":
        """A new session (admission-controlled), its service on the
        manager's device and armed with the batch plane. `session_id` pins
        an explicit id (1-64 of [A-Za-z0-9._-], not taken; else
        ValueError). `snapshot` is imported like `SimulatorService.import_`;
        returns (session, import errors). An over-quota snapshot is shed
        whole before anything exists."""
        self.admit_import(None, snapshot)
        with self._lock:
            self._admit_session_locked()
            sid = (self._claim_sid_locked(session_id) if session_id is not None
                   else self._new_sid_locked())
            service = SimulatorService(device=self.device)
            service.scheduler.session_id = sid
            service.scheduler.batch_plane = self.batch_plane
            sess = Session(sid, name or sid, service)
            self._sessions[sid] = sess
        errors = service.import_(snapshot) if snapshot else []
        return sess, errors

    def delete(self, sid: str) -> None:
        if sid == DEFAULT_SESSION_ID:
            raise ValueError("the default session cannot be deleted")
        with self._lock:
            if self._sessions.pop(sid, None) is None:
                raise UnknownSession(sid)
        # its pending-age stamps in the fleet observatory
        fleetstats.drop_session(sid)

    def _admit_session_locked(self) -> None:
        if len(self._sessions) >= self.max_sessions:
            raise SessionLimitExceeded(
                f"session limit reached ({self.max_sessions}, KSS_MAX_SESSIONS); delete a "
                "session or retry later")

    def _new_sid_locked(self) -> str:
        while True:
            sid = "s-" + secrets.token_hex(4)
            if sid not in self._sessions:
                return sid

    # explicit ids land in URLs and file names: a conservative charset
    _SID_CHARS = frozenset("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789.-_")

    def _claim_sid_locked(self, session_id: str) -> str:
        sid = str(session_id).strip()
        if not sid or len(sid) > 64 or not set(sid) <= self._SID_CHARS:
            raise ValueError(f"session id {session_id!r} must be 1-64 chars of [A-Za-z0-9._-]")
        if sid == DEFAULT_SESSION_ID:
            raise ValueError(f"session id {DEFAULT_SESSION_ID!r} is reserved")
        if sid in self._sessions:
            raise ValueError(f"session id {sid!r} already exists")
        return sid

    # -- admission (per request) ---------------------------------------------------

    def admit_pod(self, service: SimulatorService, obj: dict, *, replace: bool = False) -> None:
        """The pending-pod quota where a pod enters a store: an operation
        that would grow the pending queue (a pod without spec.nodeName) past
        the quota raises SessionQuotaExceeded (quota 0 always passes). An
        update of an already pending pod passes; `replace` marks an item
        replace, whose missing spec.nodeName unbinds a bound pod (metered)."""
        if self.pending_pod_quota <= 0:
            return
        if ((obj or {}).get("spec") or {}).get("nodeName"):
            return
        meta = (obj or {}).get("metadata") or {}
        name = meta.get("name")
        if name:
            existing = service.store.get("pods", name, meta.get("namespace") or "default")
            if existing is not None:
                if not (existing.get("spec") or {}).get("nodeName"):
                    return  # already pending: the queue does not grow
                if not replace:
                    return  # a merge keeps the binding
        pending = service.store.count_pending_pods()
        if pending >= self.pending_pod_quota:
            raise SessionQuotaExceeded(
                f"pending-pod quota reached ({pending} >= {self.pending_pod_quota}, "
                "KSS_MAX_PENDING_PODS_PER_SESSION); schedule or delete pods first")

    def admit_import(self, service: "SimulatorService | None", snapshot) -> None:
        """The quota for bulk entry (an import, a create's snapshot): a
        snapshot whose pending pods would pass the quota is shed whole,
        before anything applies. `service` None: a new session."""
        if self.pending_pod_quota <= 0 or not isinstance(snapshot, dict):
            return
        incoming = sum(1 for p in snapshot.get("pods") or []
                       if isinstance(p, dict) and not (p.get("spec") or {}).get("nodeName"))
        if not incoming:
            return
        pending = service.store.count_pending_pods() if service else 0
        if pending + incoming > self.pending_pod_quota:
            raise SessionQuotaExceeded(
                f"snapshot carries {incoming} pending pods; with {pending} already queued "
                f"that exceeds the quota ({self.pending_pod_quota}, "
                "KSS_MAX_PENDING_PODS_PER_SESSION)")

    @contextmanager
    def pass_slot(self):
        """One of the bounded concurrent-pass slots for a device-driving
        request; saturation raises ServerSaturated at once."""
        if not self._pass_sem.acquire(blocking=False):
            raise ServerSaturated(
                f"all {self.max_concurrent_passes} concurrent-pass slots are busy "
                "(KSS_MAX_CONCURRENT_PASSES); retry later")
        try:
            yield
        finally:
            self._pass_sem.release()

    def shutdown(self) -> None:
        """Drain the batch plane: open windows flush, new passes go solo."""
        if self.batch_plane is not None:
            self.batch_plane.begin_drain()
