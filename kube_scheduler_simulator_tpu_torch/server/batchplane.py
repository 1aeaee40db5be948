"""Cross-tenant continuous batching: the micro-batch dispatch plane.

The reference package's `server/batchplane.py`. The session plane
(server/sessions.py) gives each tenant its own store and scheduling service,
so without this plane the card serves one tenant's pass at a time. With it,
concurrent passes of different sessions that share a batch key (the engine
kind and its compile signature) enroll in one collection window and run as
ONE launch on the card: B sequential passes through the tenant form of
`sweep_run` (`cuda.batch_run`, K11 `batch.seq.run`), or B gang fixpoints
through the tenant forms of the K9 kernels and of `sweep_run`'s segments
(`gang.batch_fixpoint`, K11 `batch.gang.run`). Each tenant keeps its own
cluster planes on the card (the kernels read them through a table of the
tenants' Planes structs), its own queue, weights, state and trace. A
tenant's encoding may be PACKED (its batch key carries the policy and the
packed lane counts, so only PACKED tenants of one shape share a window): it
stays packed at rest, and the window widens each tenant's planes once (a K8
launch a tenant) for the launch.

How a window forms (the reference's semantics):

  * The first enrollee is the window's LEADER and its timer: it waits out
    ``KSS_BATCH_WINDOW_MS`` (capped by ``KSS_BATCH_MAX_WAIT_MS``) or until
    ``KSS_BATCH_MAX_SESSIONS`` passes filled the window, then executes
    every enrolled pass in one launch and hands each enrollee its slice.
    ``KSS_BATCH_MAX_SESSIONS=1`` makes a window born full.
  * A window that closes with one enrollee dispatches SOLO (the caller's
    own path), as do passes enrolling while the plane drains.
  * A follower waits on the leader with a timeout; one that gives up is
    marked abandoned, dispatches solo, and the late leader does not count
    it as batched.
  * Any error inside the batched execution marks every enrollee solo: each
    falls back to its own dispatch. The plane can cost throughput, never
    change an answer: each tenant's slice equals its solo dispatch, byte
    for byte.
  * Accounting happens once for each pass served: ``batchedPasses`` (and
    ``batchedGangPasses``) on the enrollee's registry, ``batchWindows`` and
    ``batchOccupancySum`` on the plane's.

The reference pads the batch axis to a geometric bucket (replaying slot 0)
only so that fills 3 and 5..8 reuse XLA compilations. The card compiles
nothing per shape, so the port launches exactly B tenants; that changes no
answer and no counter (the reference's ``batchOccupancySum`` counts B too).

With tracing on (``KSS_TRACE``, utils/telemetry.py) each enrollment emits
a ``batch.enroll`` complete event (fill, leader, outcome), and each batched
launch a ``batch.execute`` on the device track and a
``fleet.batchOccupancy`` counter sample.

Not ported: the per-program ledger and its per-tenant attribution, and the
lock-order witness (ROADMAP.md queue 1, the JAX-specific infrastructure);
plain `threading.Lock`s stand in.
"""

from __future__ import annotations

import os
import threading
import time

from ..utils import telemetry

# how long a follower waits on the leader's execution before it gives up
# and dispatches solo (the leader always signals, in a finally block)
_FOLLOWER_TIMEOUT_S = 600.0

_TRUTHY = ("1", "true", "yes", "on", "t")  # the reference's boolean vocabulary


def _coerce(raw: str, default, convert, minimum):
    """A lenient knob, as the reference's: `convert(raw)` when it parses and
    is at least `minimum`, else `default` (a malformed value must not take
    serving down)."""
    try:
        v = convert(raw) if raw else default
    except ValueError:
        return default
    return v if v >= minimum else default


def _env_float_ms(name: str, default_ms: float) -> float:
    return _coerce(os.environ.get(name, ""), default_ms, float, 0.0)


def _env_int(name: str, default: int, minimum: int) -> int:
    return _coerce(os.environ.get(name, ""), default, int, minimum)


def from_env(metrics=None) -> "BatchPlane | None":
    """An armed `BatchPlane` when ``KSS_BATCH`` is truthy, else None
    (batching is off by default)."""
    if os.environ.get("KSS_BATCH", "").strip().lower() not in _TRUTHY:
        return None
    window_ms = _env_float_ms("KSS_BATCH_WINDOW_MS", 5.0)
    max_wait_ms = _env_float_ms("KSS_BATCH_MAX_WAIT_MS", window_ms)
    max_sessions = _env_int("KSS_BATCH_MAX_SESSIONS", 8, 1)
    return BatchPlane(window_ms=window_ms, max_wait_ms=max_wait_ms,
                      max_sessions=max_sessions, metrics=metrics)


class _Enrollee:
    """One pass enrolled in a window: its engine (a `BatchedScheduler` or a
    `GangScheduler` over the pass's encoding), its registry and the slot the
    leader fills."""

    __slots__ = ("engine", "metrics", "done", "state", "trace", "error", "abandoned")

    def __init__(self, engine, metrics):
        self.engine = engine
        self.metrics = metrics
        self.done = threading.Event()
        self.state = None
        self.trace = None
        self.error: "Exception | None" = None
        # set (under the plane lock) by a follower whose wait expired: it
        # dispatches solo, so the late leader must not count it as batched
        self.abandoned = False


class _Window:
    """One collection window of one batch key. `full` wakes the leader
    early; `closed` sends late joiners to a successor window."""

    __slots__ = ("key", "kind", "items", "closed", "full")

    def __init__(self, key, kind="seq"):
        self.key = key
        self.kind = kind  # "seq" | "gang": the key's leading element fixes it
        self.items: "list[_Enrollee]" = []
        self.closed = False
        self.full = threading.Event()


class BatchPlane:
    """The micro-batch dispatch plane: one a SessionManager, shared by every
    session's SchedulerService."""

    def __init__(self, *, window_ms: float = 5.0, max_wait_ms: "float | None" = None,
                 max_sessions: int = 8, metrics=None):
        self.window_s = max(0.0, float(window_ms)) / 1000.0
        wait_s = self.window_s if max_wait_ms is None else max(0.0, float(max_wait_ms)) / 1000.0
        # the fairness bound: no enrollee waits more than one window
        self.wait_s = min(self.window_s, wait_s)
        self.max_sessions = max(1, int(max_sessions))
        # window and occupancy counters land here (the default session's
        # registry); per-pass counters on each enrollee's own
        self.metrics = metrics
        self._lock = threading.Lock()
        self._open: "dict[object, _Window]" = {}
        self._draining = False

    def stats(self) -> dict:
        """The plane's configuration and open windows (the session plane's
        `stats()["batching"]`)."""
        with self._lock:
            return {
                "armed": True,
                "windowMs": round(self.window_s * 1000.0, 3),
                "maxWaitMs": round(self.wait_s * 1000.0, 3),
                "maxSessions": self.max_sessions,
                "openWindows": len(self._open),
                "draining": self._draining,
            }

    def begin_drain(self) -> None:
        """Flush every partly filled window now and send new enrollments to
        solo dispatch. Idempotent."""
        with self._lock:
            self._draining = True
            windows = list(self._open.values())
            self._open.clear()
        for win in windows:
            win.full.set()  # wakes the leader; it closes and executes or goes solo

    def submit(self, key, engine, *, metrics, kind="seq"):
        """Enroll one pass under batch `key` (its engine kind and compile
        signature). Blocks until the window executes, then returns this
        pass's `(final state, trace)` (`kind="seq"`) or `(final state,
        rounds)` (`kind="gang"`), or None: the caller dispatches solo (a
        lone window, a draining plane, a failed batched execution)."""
        me = _Enrollee(engine, metrics)
        with self._lock:
            if self._draining:
                return None
            win = self._open.get(key)
            if win is not None and (win.closed or len(win.items) >= self.max_sessions):
                win = None  # missed it: open the successor window
            if win is None:
                win = _Window(key, kind)
                win.items.append(me)
                self._open[key] = win
                leader = True
                if len(win.items) >= self.max_sessions:
                    win.full.set()  # max_sessions=1: born full
            else:
                win.items.append(me)
                leader = False
                if len(win.items) >= self.max_sessions:
                    win.full.set()
        t0 = time.perf_counter()
        if leader:
            # the leader is the window's timer: it wakes after one window
            # even if no other pass arrives, so semaphore waiters queued
            # behind it never deadlock against the window
            win.full.wait(self.wait_s)
            with self._lock:
                win.closed = True
                if self._open.get(key) is win:
                    del self._open[key]
                items = list(win.items)
            if len(items) == 1:
                # a lone tenant: solo, no batched launch for one
                telemetry.complete("batch.enroll", t0, time.perf_counter(), fill=1,
                                   leader=True, outcome="solo")
                return None
            self._execute(win.kind, key, items)
        elif not me.done.wait(_FOLLOWER_TIMEOUT_S):
            with self._lock:
                if not me.done.is_set():
                    me.abandoned = True
        batched = not me.abandoned and me.error is None and me.state is not None
        telemetry.complete("batch.enroll", t0, time.perf_counter(), fill=len(win.items),
                           leader=leader, outcome="error" if me.error is not None else (
                               "batched" if batched else "solo"))
        if not batched:
            return None
        return me.state, me.trace

    def _execute(self, kind, key, items: "list[_Enrollee]") -> None:
        """Run one closed window as one launch and hand out the slices.
        Never raises: a failure marks every enrollee solo."""
        try:
            self._execute_inner(kind, key, items)
        except Exception as e:  # noqa: BLE001 — contained: everyone goes solo
            for it in items:
                it.error = e
        finally:
            for it in items:
                it.done.set()

    def _execute_inner(self, kind, key, items: "list[_Enrollee]") -> None:
        from ..engine.engine import run_batch
        from ..engine.gang import batch_fixpoint

        B = len(items)
        engines = [it.engine for it in items]
        t0 = time.perf_counter()
        if kind == "gang":
            outs = batch_fixpoint(engines)
        else:
            outs = run_batch(engines)
        dev = engines[0].device
        if dev.type == "cuda":
            import torch

            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        for it, (state, second) in zip(items, outs):
            it.state, it.trace = state, second
        with self._lock:
            served = [it for it in items if not it.abandoned]
        for it in served:
            if it.metrics is not None:
                it.metrics.record_batching(batched_passes=1)
                if kind == "gang":
                    it.metrics.record_gang(batched_passes=1)
                it.metrics.record_phase_seconds(execute=dt)
        if self.metrics is not None:
            self.metrics.record_batching(windows=1, occupancy=B)
        telemetry.counter("fleet.batchOccupancy", float(B))
        # the launch's width is B: the card pads no batch bucket
        telemetry.complete("batch.execute", t0, time.perf_counter(), tid=telemetry.DEVICE_TID,
                           fill=B, bucket=B)
