"""Pass statistics of a scheduling service: the reference package's
`utils/metrics.py` cut to what the serving path records.

Each pass lands as a `PassRecord` (mode, pods, scheduled, wall seconds,
and for a gang pass its rounds);
the phase breakdown splits a pass's wall time into encode, engine build,
execute and decode seconds, and counts which encode path served it
(delta, full, cached, empty) and how many engines were built. `phases()`
reads them under the reference's key names.
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

    def record_engine_build(self, seconds: float = 0.0) -> None:
        """One engine built (its first run included); a pass that reuses an
        engine through `retarget` does not land here."""
        with self._lock:
            self._engine_builds += 1
            self._phase_s["compile"] += float(seconds)

    def record_gang(self, *, fixpoint_rounds: int = 0) -> None:
        """Gang-engine accounting: the rounds a gang pass used (booked at
        decode, where they are read with the assignment)."""
        with self._lock:
            self._gang_fixpoint_rounds += int(fixpoint_rounds)

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
                "engineBuilds": self._engine_builds,
                "gangFixpointRounds": self._gang_fixpoint_rounds,
            }
