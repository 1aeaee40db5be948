"""The fleet & memory observatory: per-device memory accounting and
per-pass cluster-quality samples. The reference package's
`utils/fleetstats.py`.

Two halves a sample:

  * **device memory** — the caching allocator's bytes in use and peak and
    the card's total memory, per card (`device_memory`; a CPU service's
    sample has no byte fields), and a **buffer census** that attributes
    what the service holds: the delta encoder's retained encoding, the
    warm engines, the allocator's live blocks, the session count;
  * **cluster quality** — K12 `fleet.quality` over the pass's encoded
    cluster and final state (`quality`: one launch of the hand-written
    kernel on the card, csrc/fleet_kernels.cu, its plain version on CPU
    tensors): a per-node dominant-utilization histogram, its mean and max,
    a **fragmentation index** per resource (1 - largest free / total free:
    0 when one node could take the fleet's whole slack, towards 1 as it
    shatters), the pending count, and host-side pending-age percentiles
    (first-seen tracking per (session, pod)).

Samples land in a bounded ring (`FleetRecorder`, the `SpanRecorder`
shape: short lock hold, subscribers called outside the lock), and surface
as the ``kss_device_hbm_*``/``kss_fleet_*`` gauges (`render_prometheus`)
and as counter tracks beside the pass spans (``fleet.*``,
``hbm.bytesInUse``; utils/telemetry.py).

Off by default (``KSS_FLEET_STATS``). When armed, every
``KSS_FLEET_SAMPLE``-th pass pays one K12 launch and one small readback;
the sample only reads the pass's tensors, so placements are byte-equal
with stats on and off. `speculation_memory_ok` is the reference's
headroom gate (``KSS_SPEC_MEM_HEADROOM_BYTES``); the compile broker that
consumes it is not ported (ROADMAP.md queue 1, the JAX-specific
infrastructure).

Not ported: the SLO plane's pending-age hook (`record_pending_age`) and
the ledger's executable bytes (`ledgerMemoryBytes`), which wait for those
planes; the HTTP routes that serve the ring wait for the HTTP server.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time

import numpy as np
import torch

from ..engine import cuda
from . import telemetry

ENV_VAR = "KSS_FLEET_STATS"
CAP_VAR = "KSS_FLEET_RING_CAP"
SAMPLE_VAR = "KSS_FLEET_SAMPLE"
HEADROOM_VAR = "KSS_SPEC_MEM_HEADROOM_BYTES"

DEFAULT_RING_CAP = 1024

# per-node utilization histogram bins: [0, 0.1) ... [0.9, 1.0]
UTIL_BINS = cuda.FLEET_BINS

TRUTHY = telemetry.TRUTHY
_lenient_int = telemetry.lenient_int


def ring_capacity_from_env() -> int:
    return _lenient_int(os.environ.get(CAP_VAR, ""), DEFAULT_RING_CAP, 1)


def sample_every_from_env() -> int:
    """Sample cadence from KSS_FLEET_SAMPLE: every Nth pass (default 1)."""
    return _lenient_int(os.environ.get(SAMPLE_VAR, ""), 1, 1)


def spec_mem_headroom_bytes() -> int:
    """The speculation memory floor from KSS_SPEC_MEM_HEADROOM_BYTES; 0
    (the default) disables the gate."""
    return _lenient_int(os.environ.get(HEADROOM_VAR, ""), 0, 0)


# -- device memory -------------------------------------------------------------


def _cuda_stats(dev: torch.device) -> "dict | None":
    """The caching allocator's counters for a card, or None when its
    context does not exist yet (asking would create one)."""
    if not torch.cuda.is_initialized():
        return None
    return torch.cuda.memory_stats(dev)


def device_memory(devices=None) -> "list[dict]":
    """Per-device memory: ``{"id", "platform"}`` for each device (the CUDA
    cards when there are any, else the CPU as device 0; `devices`: an
    iterable of torch devices), with ``bytesInUse`` and ``peakBytesInUse``
    (the caching allocator's allocated bytes, current and peak) and
    ``bytesLimit`` (the card's total memory) on a card whose context
    exists. Never raises: a dead device gives a shorter list, not a failed
    sample."""
    try:
        if devices is None:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            devices = ([torch.device("cuda", i) for i in range(n)] if n
                       else [torch.device("cpu")])
        devices = [torch.device(d) for d in devices]
    except Exception:  # noqa: BLE001 — a dead backend still has a sample
        return []
    out: list[dict] = []
    for d in devices:
        gpu = d.type == "cuda"
        entry: dict = {"id": (d.index or 0) if gpu else len(out),
                       "platform": "gpu" if gpu else "cpu"}
        if gpu:
            try:
                stats = _cuda_stats(d)
                if stats is not None:
                    entry["bytesInUse"] = int(stats.get("allocated_bytes.all.current", 0))
                    entry["peakBytesInUse"] = int(stats.get("allocated_bytes.all.peak", 0))
                    entry["bytesLimit"] = int(torch.cuda.mem_get_info(d)[1])
            except Exception:  # noqa: BLE001 — optional per device
                pass
        out.append(entry)
    return out


def hbm_headroom_bytes() -> "int | None":
    """The tightest card's free memory, min over devices of (bytesLimit -
    bytesInUse), or None when no device reports both (the CPU)."""
    head = [d["bytesLimit"] - d["bytesInUse"] for d in device_memory()
            if "bytesLimit" in d and "bytesInUse" in d]
    return min(head) if head else None


def speculation_memory_ok() -> bool:
    """The headroom gate: False when KSS_SPEC_MEM_HEADROOM_BYTES is set and
    some card's free memory is below it. Unmeasurable headroom passes."""
    need = spec_mem_headroom_bytes()
    if need <= 0:
        return True
    head = hbm_headroom_bytes()
    return head is None or head >= need


# -- the buffer census -----------------------------------------------------------

# the session plane registers its id lister here (server/sessions.py); None
# until a SessionManager exists
_session_ids_fn = None


def set_session_provider(fn) -> None:
    """Register the known-session-id lister (the most recent manager wins).
    `fn()` answers an iterable of session ids, or None when the plane is
    gone (the manager registers a weakref-backed closure)."""
    global _session_ids_fn
    _session_ids_fn = fn


def known_sessions() -> "set[str] | None":
    """The session plane's ids, or None when no plane is registered
    (callers read None as "no filter", never as an empty plane)."""
    fn = _session_ids_fn
    if fn is None:
        return None
    try:
        ids = fn()
    except Exception:  # noqa: BLE001 — the census is best-effort
        return None
    return None if ids is None else {str(s) for s in ids}


def _tree_bytes(obj) -> int:
    """The bytes of every tensor in a nest of dataclasses, sequences and
    dicts (the retained encoding's census)."""
    if isinstance(obj, torch.Tensor):
        return obj.nbytes
    if dataclasses.is_dataclass(obj):
        return sum(_tree_bytes(getattr(obj, f.name)) for f in dataclasses.fields(obj))
    if isinstance(obj, (list, tuple)):
        return sum(_tree_bytes(x) for x in obj)
    if isinstance(obj, dict):
        return sum(_tree_bytes(x) for x in obj.values())
    return 0


def buffer_census(service=None) -> dict:
    """Attribute held device memory: the allocator's live blocks and bytes
    on the service's card (``liveArrays``, ``liveBytes``; none on the CPU,
    where torch keeps no census), the delta encoder's retained encoding
    and the warm engines (when `service` is given), and the session count.
    Best-effort field by field."""
    out: dict = {}
    dev = getattr(service, "device", None)
    if dev is None and torch.cuda.is_available() and torch.cuda.is_initialized():
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev is not None and dev.type == "cuda":
        try:
            stats = _cuda_stats(dev)
            if stats is not None:
                out["liveArrays"] = int(stats.get("active.all.current", 0))
                out["liveBytes"] = int(stats.get("allocated_bytes.all.current", 0))
        except Exception:  # noqa: BLE001
            pass
    if service is not None:
        try:
            st = service._delta._st
            if st is not None:
                out["deltaRetainedBytes"] = _tree_bytes((st.enc.arrays, st.enc.state0))
        except Exception:  # noqa: BLE001
            pass
        try:
            out["warmEngines"] = len(service._engines)
        except Exception:  # noqa: BLE001
            pass
    known = known_sessions()
    if known is not None:
        out["sessions"] = len(known)
    return out


# -- the cluster-quality program (K12) -------------------------------------------


def quality(node_alloc, node_mask, requested, assignment, pod_mask) -> tuple:
    """K12 `fleet.quality` over one pass's tensors: (histogram int32 [10],
    mean, max (float32), fragmentation float32 [R], pending int32), numpy,
    from one launch of `fleet_quality` on the card (or its plain version on
    CPU tensors) and one readback."""
    buf = cuda.fleet_quality(node_alloc, node_mask, requested, assignment, pod_mask)
    return cuda.fleet_fields(buf.cpu())


def _percentile(sorted_vals: "list[float]", q: float) -> float:
    if not sorted_vals:
        return 0.0
    return sorted_vals[int(round(q * (len(sorted_vals) - 1)))]


# -- the sample ring -------------------------------------------------------------


class FleetRecorder:
    """A bounded ring of fleet samples and live subscribers: `push` holds
    the lock only to place the sample and advance the sequence;
    subscribers run outside it."""

    def __init__(self, capacity: "int | None" = None):
        cap = ring_capacity_from_env() if capacity is None else int(capacity)
        if cap < 1:
            raise ValueError(f"ring capacity must be >= 1, got {cap}")
        self.capacity = cap
        self._lock = threading.Lock()
        self._ring: "list[dict | None]" = [None] * cap
        self._seq = 0
        self._subs: list = []
        self._pass_count = 0  # the KSS_FLEET_SAMPLE cadence
        # (session, ns, name) -> monotonic first-seen-pending stamp
        self._pending_seen: "dict[tuple, float]" = {}

    def push(self, sample: dict) -> None:
        with self._lock:
            sample = dict(sample)
            sample["seq"] = self._seq
            self._ring[self._seq % self.capacity] = sample
            self._seq += 1
            subs = tuple(self._subs) if self._subs else ()
        for fn in subs:
            try:
                fn(sample)
            except Exception:  # noqa: BLE001 — a dead subscriber never breaks a pass
                pass

    @property
    def emitted(self) -> int:
        with self._lock:
            return self._seq

    @property
    def dropped(self) -> int:
        with self._lock:
            return max(0, self._seq - self.capacity)

    def __len__(self) -> int:
        with self._lock:
            return min(self._seq, self.capacity)

    def snapshot(self) -> "list[dict]":
        with self._lock:
            n = self._seq
            if n <= self.capacity:
                return list(self._ring[:n])
            i = n % self.capacity
            return self._ring[i:] + self._ring[:i]

    def drop_session(self, sid: str) -> None:
        """Purge a deleted session's pending-age stamps; its ring samples
        stay (the series records what happened)."""
        with self._lock:
            for key in [k for k in self._pending_seen if k[0] == sid]:
                del self._pending_seen[key]

    def subscribe(self, fn) -> None:
        with self._lock:
            self._subs.append(fn)

    def unsubscribe(self, fn) -> None:
        with self._lock:
            try:
                self._subs.remove(fn)
            except ValueError:
                pass

    def sample_pass(self, service, enc, state, mode: str,
                    assignment: "np.ndarray | None" = None) -> "dict | None":
        """One sample over the pass's encoding and final state (the
        service's finish paths call it inside the never-raise
        `_fleet_sample`). `assignment`: the host copy of the final
        assignment the finish path already made (else it is read back
        here). Honors the KSS_FLEET_SAMPLE cadence; returns the sample, or
        None when this pass was skipped."""
        with self._lock:
            self._pass_count += 1
            if (self._pass_count - 1) % sample_every_from_env():
                return None
        a = enc.arrays
        hist, util_mean, util_max, frag, pending = quality(
            a.node_alloc, a.node_mask, state.requested, state.assignment, a.pod_mask)
        if assignment is None:
            assignment = state.assignment.cpu().numpy()
        session = service.session_id or "default"
        ages = self._pending_ages(session, enc, assignment)
        frag_by_res = {name: round(float(frag[i]), 6)
                       for i, name in enumerate(enc.resource_names) if i < len(frag)}
        frag_index = round(max(frag_by_res.values(), default=0.0), 6)
        devices = device_memory([service.device])
        hbm: dict = {}
        for key in ("bytesInUse", "peakBytesInUse", "bytesLimit"):
            vals = [d[key] for d in devices if key in d]
            if vals:
                hbm[key] = sum(vals)
        sample = {
            "wallTime": round(time.time(), 3),
            "passId": telemetry.current_pass_id(),
            "session": session,
            "mode": mode,
            "devices": devices,
            "hbm": hbm,
            "buffers": buffer_census(service),
            "fleet": {
                "nodes": enc.n_nodes,
                "pendingPods": int(pending),
                "utilization": {
                    "mean": round(float(util_mean), 6),
                    "max": round(float(util_max), 6),
                    "histogram": [int(x) for x in hist],
                },
                "fragmentation": frag_by_res,
                "fragmentationIndex": frag_index,
                "pendingAges": ages,
            },
        }
        self.push(sample)
        # counter tracks beside the pass spans (no-ops with tracing off)
        telemetry.counter("fleet.pendingPods", int(pending))
        telemetry.counter("fleet.utilizationMax", float(util_max))
        telemetry.counter("fleet.fragmentationIndex", frag_index)
        mem = hbm.get("bytesInUse", sample["buffers"].get("liveBytes"))
        if mem is not None:
            telemetry.counter("hbm.bytesInUse", float(mem))
        return sample

    def _pending_ages(self, session: str, enc, assignment) -> dict:
        """Pending-age percentiles from first-seen tracking: a pod enters
        the map at the first sample that finds it pending (keyed by
        session) and leaves when it binds or vanishes."""
        now = time.monotonic()
        pending_keys = {(session, *enc.pod_keys[p]) for p in range(enc.n_pods)
                        if int(assignment[p]) < 0}
        with self._lock:
            for key in [k for k in self._pending_seen
                        if k[0] == session and k not in pending_keys]:
                del self._pending_seen[key]
            ages = sorted(now - self._pending_seen.setdefault(key, now) for key in pending_keys)
        return {
            "count": len(ages),
            "p50Seconds": round(_percentile(ages, 0.5), 6),
            "p90Seconds": round(_percentile(ages, 0.9), 6),
            "maxSeconds": round(ages[-1], 6) if ages else 0.0,
        }


# -- the process-wide active recorder --------------------------------------------

_lock = threading.Lock()
# (KSS_FLEET_STATS, KSS_FLEET_RING_CAP) raw strings -> recorder; read
# without the lock on the hot path, as telemetry.active()
_cached: "tuple[tuple[str, str], FleetRecorder | None] | None" = None
_override_state: "tuple[bool, FleetRecorder | None]" = (False, None)


def active() -> "FleetRecorder | None":
    """The active fleet recorder, or None (the default: stats off). Reads
    the environment each call and rebuilds only when it changed."""
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
        rec = (FleetRecorder(ring_capacity_from_env())
               if key[0].strip().lower() in TRUTHY else None)
        _cached = (key, rec)
        return rec


def enabled() -> bool:
    return active() is not None


def activate(recorder: "FleetRecorder | None") -> None:
    """Install `recorder` whatever the environment says (None: stats
    explicitly off) until `deactivate`."""
    global _override_state
    with _lock:
        _override_state = (True, recorder)


def deactivate() -> None:
    global _override_state
    with _lock:
        _override_state = (False, None)


def drop_session(sid: str) -> None:
    """Forward a session deletion to the active recorder; no-op with stats
    off."""
    rec = active()
    if rec is not None:
        rec.drop_session(sid)


# -- Prometheus exposition ---------------------------------------------------------


def _fmt_value(v) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def render_prometheus(recorder: "FleetRecorder | None" = None) -> str:
    """The ``kss_device_hbm_*`` and ``kss_fleet_*`` gauge families from the
    recorder's newest samples: device families from the latest sample,
    fleet families one series a session (its latest sample; sessions the
    plane no longer knows are left out). Empty with stats off or nothing
    sampled yet."""
    rec = active() if recorder is None else recorder
    if rec is None:
        return ""
    samples = rec.snapshot()
    if not samples:
        return ""
    latest = samples[-1]
    by_session: "dict[str, dict]" = {}
    for s in samples:
        by_session[s.get("session") or "default"] = s
    lines: list[str] = []

    def family(name: str, help_text: str, rows, label: str) -> None:
        if not rows:
            return
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} gauge")
        for key, v in rows:
            lines.append(f'{name}{{{label}="{key}"}} {_fmt_value(v)}')

    for name, help_text, key in (
        ("kss_device_hbm_bytes_in_use",
         "Device memory in use (the caching allocator's allocated bytes).", "bytesInUse"),
        ("kss_device_hbm_peak_bytes", "Peak device memory in use since process start.",
         "peakBytesInUse"),
        ("kss_device_hbm_bytes_limit", "The device's total memory.", "bytesLimit"),
    ):
        family(name, help_text,
               [(d["id"], d[key]) for d in latest.get("devices", ()) if key in d], "device")

    known = known_sessions()
    for name, help_text, value_of in (
        ("kss_fleet_pending_pods", "Pending-queue depth at the session's last sampled pass.",
         lambda s: s["fleet"]["pendingPods"]),
        ("kss_fleet_utilization_mean",
         "Mean per-node dominant-resource utilization (last sample).",
         lambda s: s["fleet"]["utilization"]["mean"]),
        ("kss_fleet_utilization_max",
         "Max per-node dominant-resource utilization (last sample).",
         lambda s: s["fleet"]["utilization"]["max"]),
        ("kss_fleet_fragmentation_index",
         "1 - largest-free-block / total-free, worst resource (last sample).",
         lambda s: s["fleet"]["fragmentationIndex"]),
    ):
        rows = [(sid, value_of(by_session[sid])) for sid in sorted(by_session)
                if known is None or sid in known]
        family(name, help_text, [(sid, v) for sid, v in rows if v is not None], "session")

    def global_sample(name: str, mtype: str, help_text: str, value) -> None:
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {mtype}")
        lines.append(f"{name} {_fmt_value(value)}")

    live = latest.get("buffers", {}).get("liveBytes")
    if live is not None:
        global_sample("kss_fleet_live_buffer_bytes", "gauge",
                      "Bytes the caching allocator holds allocated (the buffer census).", live)
    global_sample("kss_fleet_samples_total", "counter",
                  "Fleet samples recorded since the recorder was born.", rec.emitted)
    return "\n".join(lines) + "\n"
