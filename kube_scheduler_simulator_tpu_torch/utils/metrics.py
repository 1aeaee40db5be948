"""Pass statistics of a scheduling service: the reference package's
`utils/metrics.py` cut to what the serving path records.

Each pass lands as a `PassRecord` (mode, pods, scheduled, wall seconds,
and for a gang pass its rounds);
the phase breakdown splits a pass's wall time into encode, engine build,
execute and decode seconds, and counts which encode path served it
(delta, full, cached, empty) and how many engines were built; the batch
plane's counters (server/batchplane.py) count the passes a batched launch
served, the windows, their fill and the passes that fell back to solo
dispatch; `encodePolicyMisses` counts the full encodes a dtype-policy flip
forced. `phases()` reads them under the reference's key names, and
`render_prometheus` gives the counters in the Prometheus text format under
the reference's metric names.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass


@dataclass
class PassRecord:
    """One scheduling pass (one engine run over the queue)."""

    mode: str  # "sequential" | "gang"
    pods: int  # distinct pods the pass recorded
    scheduled: int  # records that bound their pod
    wall_s: float
    rounds: int = 0  # gang mode only


class SchedulingMetrics:
    """Thread-safe pass statistics of one service."""

    def __init__(self, keep: int = 256):
        self.keep = keep
        self._lock = threading.Lock()
        self._passes: list[PassRecord] = []
        self._phase_s = {"encode": 0.0, "compile": 0.0, "execute": 0.0, "decode": 0.0}
        self._encode_counts = {"delta": 0, "full": 0, "cached": 0, "empty": 0}
        self._engine_builds = 0
        self._gang_fixpoint_rounds = 0
        self._batched_passes = 0
        self._batch_windows = 0
        self._batch_occupancy_sum = 0
        self._solo_fallbacks = 0
        self._batched_gang_passes = 0
        self._encode_policy_misses = 0

    def record(self, rec: PassRecord) -> None:
        with self._lock:
            self._passes.append(rec)
            if len(self._passes) > self.keep:
                self._passes = self._passes[-self.keep:]

    def record_encode(self, mode: str, seconds: float = 0.0) -> None:
        """One encode: `mode` is the path that served it; `seconds` its host
        time (event replay and cache probes included)."""
        with self._lock:
            self._encode_counts[mode] = self._encode_counts.get(mode, 0) + 1
            self._phase_s["encode"] += float(seconds)

    def record_encode_policy_miss(self) -> None:
        """One full re-encode forced by a dtype-policy flip
        (KSS_DTYPE_POLICY changed between passes)."""
        with self._lock:
            self._encode_policy_misses += 1

    def record_engine_build(self, seconds: float = 0.0) -> None:
        """One engine built (its first run included); a pass that reuses an
        engine through `retarget` does not land here."""
        with self._lock:
            self._engine_builds += 1
            self._phase_s["compile"] += float(seconds)

    def record_gang(self, *, fixpoint_rounds: int = 0, batched_passes: int = 0) -> None:
        """Gang-engine accounting: the rounds a gang pass used (booked at
        decode, where they are read with the assignment), and the gang
        passes a cross-tenant batched launch served (`batch.gang.run`)."""
        with self._lock:
            self._gang_fixpoint_rounds += int(fixpoint_rounds)
            self._batched_gang_passes += int(batched_passes)

    def record_batching(self, *, batched_passes: int = 0, windows: int = 0, occupancy: int = 0,
                        solo_fallbacks: int = 0) -> None:
        """Batch-plane accounting (server/batchplane.py): `batched_passes`
        this service's passes served by a batched launch, `solo_fallbacks`
        its passes that fell back to solo dispatch (a lone window, a
        draining plane, a failed batched launch, an ineligible pass);
        `windows` batched windows executed and `occupancy` their fill (both
        booked on the plane's registry)."""
        with self._lock:
            self._batched_passes += int(batched_passes)
            self._batch_windows += int(windows)
            self._batch_occupancy_sum += int(occupancy)
            self._solo_fallbacks += int(solo_fallbacks)

    def record_phase_seconds(self, execute: float = 0.0, decode: float = 0.0) -> None:
        """A pass's execute (engine run) and decode (results and write-back)
        seconds."""
        with self._lock:
            self._phase_s["execute"] += float(execute)
            self._phase_s["decode"] += float(decode)

    @contextmanager
    def time_pass(self, mode: str):
        """`ctx.done(pods, scheduled)` inside the block stamps the pass; its
        wall time is measured around the block."""
        holder = {}

        class _Ctx:
            @staticmethod
            def done(pods: int, scheduled: int, rounds: int = 0):
                holder["args"] = (pods, scheduled, rounds)

        t0 = time.perf_counter()
        yield _Ctx
        pods, scheduled, rounds = holder.get("args", (0, 0, 0))
        self.record(PassRecord(mode, pods, scheduled, time.perf_counter() - t0, rounds))

    def passes(self) -> list[PassRecord]:
        """The most recent passes (at most `keep`), oldest first."""
        with self._lock:
            return list(self._passes)

    def phases(self) -> dict:
        """The phase breakdown under the reference's `phases` key names."""
        with self._lock:
            return {
                "encodeSeconds": round(self._phase_s["encode"], 6),
                "compileSeconds": round(self._phase_s["compile"], 6),
                "executeSeconds": round(self._phase_s["execute"], 6),
                "decodeSeconds": round(self._phase_s["decode"], 6),
                "deltaEncodes": self._encode_counts.get("delta", 0),
                "fullEncodes": self._encode_counts.get("full", 0),
                "cachedEncodes": self._encode_counts.get("cached", 0),
                "emptyEncodes": self._encode_counts.get("empty", 0),
                "encodePolicyMisses": self._encode_policy_misses,
                "engineBuilds": self._engine_builds,
                "batchedPasses": self._batched_passes,
                "batchWindows": self._batch_windows,
                "batchOccupancySum": self._batch_occupancy_sum,
                "soloFallbacks": self._solo_fallbacks,
                "gangFixpointRounds": self._gang_fixpoint_rounds,
                "batchedGangPasses": self._batched_gang_passes,
            }


# (metric name, help, `phases()` key): the reference's names for the
# counters the port keeps
_PROM_COUNTERS = (
    ("kss_encode_policy_misses_total", "Full re-encodes forced by a dtype-policy flip.",
     "encodePolicyMisses"),
    ("kss_engine_builds_total", "Compiled-engine constructions (the recompile proxy).",
     "engineBuilds"),
)
_ENCODE_MODES = (("delta", "deltaEncodes"), ("full", "fullEncodes"),
                 ("cached", "cachedEncodes"), ("empty", "emptyEncodes"))


def render_prometheus(metrics: SchedulingMetrics) -> str:
    """The service's counters in the Prometheus text exposition format
    (version 0.0.4): the policy misses, the engine builds and the encodes
    by the path that served them."""
    phases = metrics.phases()
    lines = []
    for name, help_text, key in _PROM_COUNTERS:
        lines += [f"# HELP {name} {help_text}", f"# TYPE {name} counter",
                  f"{name} {phases[key]}"]
    lines += ["# HELP kss_encodes_total Cluster encodes by the path that served them.",
              "# TYPE kss_encodes_total counter"]
    lines += [f'kss_encodes_total{{mode="{mode}"}} {phases[key]}' for mode, key in _ENCODE_MODES]
    return "\n".join(lines) + "\n"
