"""The span flight recorder: the reference package's `utils/telemetry.py`,
cut to the core the serving path emits into.

Spans land in a bounded ring (`SpanRecorder`: always the most recent
window, never unbounded growth), exported as Chrome trace-event JSON that
Perfetto and `chrome://tracing` load as they are.

Span model:

  * `span(name, **attrs)` — a context manager: a `B` (begin) event at
    entry and a matching `E` (end) at exit on the calling thread's track,
    so B/E are balanced per thread by construction;
  * `complete(name, start_s, end_s, *, tid=...)` — one `X` (complete)
    event over an explicit interval; the device window of a pass lands on
    the synthetic `DEVICE_TID` track;
  * `counter(name, value)` — a `C` counter-track sample (the fleet
    observatory's gauges, utils/fleetstats.py);
  * `instant(name, **attrs)` — a point event (`i`).

Causality: every span and instant carries the current pass id (the
thread-local `pass_context` that `SchedulerService` enters around each
pass) and session id (`session_context`, entered by a session's service).

Cost model: tracing is off by default (``KSS_TRACE``) and near-free when
off: `span()` returns a shared no-op after one environment probe cached on
the raw string. The ring holds ``KSS_TRACE_RING_CAP`` events (default
65536); past it the oldest are overwritten. Timestamps are
`time.perf_counter()` microseconds.

Not ported (ROADMAP.md queue 1, the remaining server and fleet): the fleet
router's distributed trace context (`traceparent`, `trace_context`,
`merged_chrome_trace`).
"""

from __future__ import annotations

import json
import os
import threading
import time

ENV_VAR = "KSS_TRACE"
CAP_VAR = "KSS_TRACE_RING_CAP"
DEFAULT_RING_CAP = 65536

# the reference's boolean vocabulary (its utils/envcheck.py TRUTHY)
TRUTHY = ("1", "true", "yes", "on", "t")

# The synthetic track for intervals that are not thread-shaped (a pass's
# device window). Python thread idents are never 0.
DEVICE_TID = 0

_PID = os.getpid()


def _now_us() -> float:
    return time.perf_counter() * 1e6


def lenient_int(raw: str, default: int, minimum: int) -> int:
    """A lenient knob (this module's and utils/fleetstats.py's): a
    malformed or too small value gives `default` (a typo must never disable
    a recorder or blow its bound)."""
    try:
        v = int(raw) if raw else default
    except ValueError:
        return default
    return v if v >= minimum else default


def ring_capacity_from_env() -> int:
    """Ring capacity from KSS_TRACE_RING_CAP; malformed or non-positive
    values give the default."""
    return lenient_int(os.environ.get(CAP_VAR, ""), DEFAULT_RING_CAP, 1)


class SpanRecorder:
    """A bounded ring of Chrome trace events plus live subscribers. `emit`
    holds the lock only to place the event and advance the sequence;
    subscribers run outside it. Snapshots are oldest-first."""

    def __init__(self, capacity: "int | None" = None):
        cap = ring_capacity_from_env() if capacity is None else int(capacity)
        if cap < 1:
            raise ValueError(f"ring capacity must be >= 1, got {cap}")
        self.capacity = cap
        self._lock = threading.Lock()
        self._ring: "list[dict | None]" = [None] * cap
        self._seq = 0  # events ever emitted
        self._subs: list = []

    def emit(self, ev: dict) -> None:
        with self._lock:
            self._ring[self._seq % self.capacity] = ev
            self._seq += 1
            subs = tuple(self._subs) if self._subs else ()
        for fn in subs:
            try:
                fn(ev)
            except Exception:  # noqa: BLE001 — a dead subscriber never breaks a pass
                pass

    @property
    def emitted(self) -> int:
        """Events ever emitted (>= len(self): the ring drops the oldest)."""
        with self._lock:
            return self._seq

    @property
    def dropped(self) -> int:
        with self._lock:
            return max(0, self._seq - self.capacity)

    def __len__(self) -> int:
        with self._lock:
            return min(self._seq, self.capacity)

    def snapshot(self) -> list[dict]:
        """The retained events, oldest first."""
        with self._lock:
            n = self._seq
            if n <= self.capacity:
                return list(self._ring[:n])
            i = n % self.capacity
            return self._ring[i:] + self._ring[:i]

    def subscribe(self, fn) -> None:
        with self._lock:
            self._subs.append(fn)

    def unsubscribe(self, fn) -> None:
        with self._lock:
            try:
                self._subs.remove(fn)
            except ValueError:
                pass


# -- the process-wide active recorder ------------------------------------------

_lock = threading.Lock()
# (KSS_TRACE, KSS_TRACE_RING_CAP) raw strings -> the recorder parsed from
# them; `activate` overrides the environment until `deactivate`. Both are
# read without the lock on the hot path: each holds one immutable tuple,
# swapped whole.
_cached: "tuple[tuple[str, str], SpanRecorder | None] | None" = None
_override_state: "tuple[bool, SpanRecorder | None]" = (False, None)


def active() -> "SpanRecorder | None":
    """The active recorder, or None (the default: tracing off). Reads the
    environment each call and rebuilds the recorder only when it changed."""
    global _cached
    overridden, override = _override_state
    if overridden:
        return override
    key = (os.environ.get(ENV_VAR, ""), os.environ.get(CAP_VAR, ""))
    cached = _cached
    if cached is not None and cached[0] == key:
        return cached[1]
    with _lock:
        overridden, override = _override_state
        if overridden:
            return override
        cached = _cached
        if cached is not None and cached[0] == key:
            return cached[1]
        rec = (SpanRecorder(ring_capacity_from_env())
               if key[0].strip().lower() in TRUTHY else None)
        _cached = (key, rec)
        return rec


def enabled() -> bool:
    return active() is not None


def activate(recorder: "SpanRecorder | None") -> None:
    """Install `recorder` whatever the environment says (None: tracing
    explicitly off) until `deactivate`."""
    global _override_state
    with _lock:
        _override_state = (True, recorder)


def deactivate() -> None:
    """Drop any `activate` override; the environment rules again."""
    global _override_state
    with _lock:
        _override_state = (False, None)


# -- pass and session causality ----------------------------------------------

_ctx = threading.local()


def current_pass_id() -> "int | None":
    """The pass id of the innermost `pass_context` on this thread."""
    return getattr(_ctx, "pass_id", None)


def current_session_id() -> "str | None":
    """The session id of the innermost `session_context` on this thread."""
    return getattr(_ctx, "session_id", None)


class session_context:
    """Thread-local session causality: spans and instants emitted inside
    carry ``args["session"]``."""

    __slots__ = ("_session_id", "_prev")

    def __init__(self, session_id: "str | None"):
        self._session_id = session_id
        self._prev = None

    def __enter__(self):
        self._prev = getattr(_ctx, "session_id", None)
        _ctx.session_id = self._session_id
        return self

    def __exit__(self, *exc):
        _ctx.session_id = self._prev
        return False


class pass_context:
    """Thread-local pass causality: spans and instants emitted inside carry
    ``args["pass"]``. Stamped whether tracing is on or off (the fleet
    samples read it); a plain class keeps the cost to two attribute
    writes."""

    __slots__ = ("_pass_id", "_prev")

    def __init__(self, pass_id: "int | None"):
        self._pass_id = pass_id
        self._prev = None

    def __enter__(self):
        self._prev = getattr(_ctx, "pass_id", None)
        _ctx.pass_id = self._pass_id
        return self

    def __exit__(self, *exc):
        _ctx.pass_id = self._prev
        return False


# -- emission ------------------------------------------------------------------


def _args(pass_id, attrs: dict) -> dict:
    if pass_id is None:
        pass_id = current_pass_id()
    session_id = attrs.get("session", current_session_id())
    if pass_id is not None or session_id is not None:
        attrs = dict(attrs)
        if pass_id is not None:
            attrs["pass"] = pass_id
        if session_id is not None:
            attrs["session"] = session_id
    return attrs


class _NullSpan:
    """The shared no-op span that `span()` hands out with tracing off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _LiveSpan:
    __slots__ = ("_rec", "_name", "_a")

    def __init__(self, rec: SpanRecorder, name: str, args: dict):
        self._rec = rec
        self._name = name
        self._a = args

    def _event(self, ph: str) -> dict:
        return {"ph": ph, "name": self._name, "cat": "kss", "ts": _now_us(), "pid": _PID,
                "tid": threading.get_ident(), "args": self._a}

    def __enter__(self):
        self._rec.emit(self._event("B"))
        return self

    def __exit__(self, *exc):
        self._rec.emit(self._event("E"))
        return False


def span(name: str, pass_id: "int | None" = None, **attrs):
    """A context manager recording `name` as a B/E span on the calling
    thread's track, stamped with the current (or given) pass id; the shared
    no-op when tracing is off."""
    rec = active()
    if rec is None:
        return _NULL_SPAN
    return _LiveSpan(rec, name, _args(pass_id, attrs))


def complete(name: str, start_s: float, end_s: float, *, tid: "int | None" = None,
             pass_id: "int | None" = None, **attrs) -> None:
    """One `X` (complete) event over [start_s, end_s] perf_counter seconds,
    on `tid` (default: the calling thread; `DEVICE_TID` for the device
    track)."""
    rec = active()
    if rec is None:
        return
    rec.emit({
        "ph": "X", "name": name, "cat": "kss", "ts": start_s * 1e6,
        "dur": max(0.0, (end_s - start_s) * 1e6), "pid": _PID,
        "tid": threading.get_ident() if tid is None else tid, "args": _args(pass_id, attrs),
    })


def counter(name: str, value: float, tid: "int | None" = None) -> None:
    """A counter-track sample (`C` event): one series per name, under the
    args key ``value``."""
    rec = active()
    if rec is None:
        return
    rec.emit({
        "ph": "C", "name": name, "cat": "kss", "ts": _now_us(), "pid": _PID,
        "tid": threading.get_ident() if tid is None else tid, "args": {"value": float(value)},
    })


def instant(name: str, pass_id: "int | None" = None, **attrs) -> None:
    """A point event on the calling thread's track."""
    rec = active()
    if rec is None:
        return
    rec.emit({
        "ph": "i", "name": name, "cat": "kss", "s": "t", "ts": _now_us(), "pid": _PID,
        "tid": threading.get_ident(), "args": _args(pass_id, attrs),
    })


# -- Chrome trace-event export -------------------------------------------------


def chrome_trace(events: list[dict], *, dropped: int = 0) -> dict:
    """The Chrome trace-event JSON document (the JSON Object Format) for
    `events`, with process and thread metadata so Perfetto names the
    tracks."""
    names = {t.ident: t.name for t in threading.enumerate() if t.ident}
    meta: list[dict] = [{"ph": "M", "name": "process_name", "pid": _PID, "tid": DEVICE_TID,
                         "args": {"name": "kube-scheduler-simulator-tpu-torch"}}]
    seen: set = set()
    for ev in events:
        tid = ev.get("tid")
        if tid in seen:
            continue
        seen.add(tid)
        label = "device (pass windows)" if tid == DEVICE_TID else names.get(tid, f"thread-{tid}")
        meta.append({"ph": "M", "name": "thread_name", "pid": _PID, "tid": tid,
                     "args": {"name": label}})
    return {
        "traceEvents": meta + list(events),
        "displayTimeUnit": "ms",
        "otherData": {"producer": "kube_scheduler_simulator_tpu_torch.utils.telemetry",
                      "droppedEvents": dropped},
    }


def dump_chrome_trace(path: str, recorder: "SpanRecorder | None" = None) -> int:
    """Write the recorder's retained window as a Chrome trace JSON file;
    returns the events written. With no recorder, an empty (still
    loadable) document."""
    rec = recorder if recorder is not None else active()
    events = rec.snapshot() if rec is not None else []
    doc = chrome_trace(events, dropped=rec.dropped if rec is not None else 0)
    with open(path, "w") as f:
        json.dump(doc, f)
    return len(events)


def clock_us() -> float:
    """This process's trace clock (perf_counter microseconds)."""
    return _now_us()


# -- span intervals and well-formedness ----------------------------------------


def span_intervals(events: list[dict]) -> list[dict]:
    """Closed spans of a trace-event list: each `X` event, and each balanced
    B/E pair of one (pid, tid) track, as ``{"name", "pid", "tid",
    "start_us", "end_us", "args"}``; unmatched B/E are skipped."""
    out: list[dict] = []
    stacks: "dict[tuple, list[dict]]" = {}

    def interval(b, end_us):
        return {"name": b["name"], "pid": b.get("pid"), "tid": b.get("tid"),
                "start_us": float(b["ts"]), "end_us": end_us, "args": b.get("args", {})}

    for ev in events:
        ph = ev.get("ph")
        if ph == "X":
            out.append(interval(ev, float(ev["ts"]) + float(ev.get("dur", 0.0))))
        elif ph == "B":
            stacks.setdefault((ev.get("pid"), ev.get("tid")), []).append(ev)
        elif ph == "E":
            stack = stacks.get((ev.get("pid"), ev.get("tid")))
            if stack and stack[-1]["name"] == ev["name"]:
                out.append(interval(stack.pop(), float(ev["ts"])))
    return out


def check_nesting(events: list[dict], *, dropped: int = 0) -> None:
    """Raise ValueError unless every (pid, tid) track's B/E events form
    balanced, properly nested pairs. With `dropped` > 0 (a ring-wrapped
    window), an E on an empty stack is tolerated: its B was evicted."""
    stacks: "dict[tuple, list[str]]" = {}
    for ev in events:
        ph = ev.get("ph")
        tid = (ev.get("pid"), ev.get("tid"))
        if ph == "B":
            stacks.setdefault(tid, []).append(ev["name"])
        elif ph == "E":
            stack = stacks.setdefault(tid, [])
            if not stack:
                if dropped > 0:
                    continue
                raise ValueError(f"unmatched E {ev['name']!r} on tid {tid} (no open span)")
            if stack[-1] != ev["name"]:
                raise ValueError(f"interleaved spans on tid {tid}: E {ev['name']!r} "
                                 f"closes innermost B {stack[-1]!r}")
            stack.pop()
    open_spans = {t: s for t, s in stacks.items() if s}
    if open_spans:
        raise ValueError(f"unclosed spans at end of window: {open_spans}")
