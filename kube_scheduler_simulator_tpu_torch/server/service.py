"""Simulator services: the scheduler's configuration lifecycle and its
scheduling passes over one `ResourceStore`, and the export/import/reset
composites. The reference package's `server/service.py`, cut to the
synchronous sequential pass:

  * `SchedulerService.schedule()` encodes the store's pending state (the
    EncodingCache for an unchanged store, else the delta encoder, which
    falls back to a full encode where it cannot prove the delta exact),
    runs the sequential engine, deletes preemption victims and writes
    `spec.nodeName` plus the 13 result annotations back onto each pod it
    attempted (the last record of a pod wins);
  * `SchedulerService.schedule_gang()` runs the same encode through the
    gang (fixpoint) engine (engine/gang.py): rounds of all pending pods in
    parallel, preempt phases between them; victims are deleted and, with
    `record=True`, the records written back by the same rule (without,
    only `spec.nodeName`);
  * engines are kept in a small LRU keyed by ("seq", compile signature) or
    ("gang", gang signature, effective window): built on a miss,
    `retarget`ed onto the new encoding on a hit;
  * `SimulatorService` composes the store and the scheduler with export,
    import and reset;
  * each pass carries a per-service pass id (`telemetry.pass_context`,
    stamped with tracing on or off) and, with ``KSS_TRACE`` armed, emits
    the reference's pass-level spans: ``pass.sequential``/``pass.gang``
    around the pass, ``pass.encode`` over its encode and ``device.execute``
    (on the device track) over its dispatch (utils/telemetry.py); a
    session's service stamps its session id on them;
  * with ``KSS_FLEET_STATS`` armed, the end of each pass takes one fleet
    sample (utils/fleetstats.py: K12 `fleet.quality` over the pass's
    encoding and final state, the memory census); a failed sample never
    fails the pass, and placements do not depend on it;
  * with a cross-tenant batch plane armed (`batch_plane`, set by the
    session plane, server/sessions.py), a sequential pass, or an unrecorded
    gang pass, enrolls in the plane's window under its compile signature and
    comes back with its slice of one batched launch (server/batchplane.py);
    a pass the plane does not serve — a lone window, a draining plane, a
    failed batched launch, a recorded gang pass — dispatches solo and counts
    one `soloFallbacks`.

Not ported: the extender loop (a configuration with extenders raises
NotImplementedError, for gang passes as for sequential ones), the compile broker's
speculation, the async pass pipeline (and its spans) and the execution ladder's
retries and CPU failover: a device fault raises.

Services run on the CUDA card unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

import numpy as np
import torch

from ..engine.delta import DeltaEncoder
from ..engine.encode import EncodingCache, policy_from_env, resolve_device
from ..engine.engine import BatchedScheduler, unsupported_plugins
from ..engine.gang import GangScheduler
from ..models.snapshot import export_snapshot, import_snapshot
from ..models.store import ResourceStore
from ..sched.config import SchedulerConfiguration
from ..sched.results import PodSchedulingResult
from ..utils import fleetstats, telemetry
from ..utils.metrics import SchedulingMetrics

# engines kept per service (the reference broker's warm-engine capacity)
ENGINE_CACHE_CAP = 8

# The gang engine's evaluation chunk on the serving path: it sets the eval
# window's granularity (placements do not depend on it otherwise), and it
# is part of the engine cache key through the effective window.
GANG_CHUNK = 64


def gang_chunk() -> int:
    """The serving-path gang chunk: ``KSS_GANG_CHUNK`` when `int()` takes it
    and it is >= 1, else `GANG_CHUNK` (unset, malformed — "2.5", "1e2",
    "inf" — or below 1 falls back, as the reference's lenient knob does).
    Read per pass."""
    raw = os.environ.get("KSS_GANG_CHUNK", "")
    try:
        v = int(raw) if raw else GANG_CHUNK
    except ValueError:
        return GANG_CHUNK
    return v if v >= 1 else GANG_CHUNK


class InvalidSchedulerConfiguration(ValueError):
    pass


def _check_runnable(config: SchedulerConfiguration) -> None:
    if config.extenders:
        raise NotImplementedError("scheduler extenders are not ported yet")
    missing = unsupported_plugins(config)
    if missing:
        raise InvalidSchedulerConfiguration(f"no kernel for enabled plugins: {missing}")


class SchedulerService:
    """Scheduler configuration lifecycle and sequential scheduling passes."""

    def __init__(
        self,
        store: ResourceStore,
        initial_config: "SchedulerConfiguration | None" = None,
        metrics: "SchedulingMetrics | None" = None,
        *,
        device: "str | torch.device | None" = None,
    ):
        self.device = resolve_device(device)
        self.store = store
        self.metrics = metrics if metrics is not None else SchedulingMetrics()
        self._initial = initial_config or SchedulerConfiguration.default()
        _check_runnable(self._initial)
        self._config = self._initial
        self._lock = threading.Lock()  # the configuration and last_encode_info
        self._schedule_lock = threading.Lock()  # one pass at a time
        # the encoding stack: an LRU over (latest rv, policy) x config for
        # an unchanged store, then the delta encoder
        self._enc_cache = EncodingCache()
        self._delta = DeltaEncoder(device=self.device)
        self._engines: "dict[tuple, BatchedScheduler | GangScheduler]" = {}
        # the last pass's encode outcome ({"mode": ..., ...})
        self.last_encode_info: "dict | None" = None
        # the session this service serves (server/sessions.py), and the
        # cross-tenant batch plane shared by every session (None: off)
        self.session_id: "str | None" = None
        self.batch_plane = None
        # per pass: a solo fallback is counted once; the engines that
        # decode a batched pass's slice, kept by signature across passes
        self._batch_fallback_counted = False
        self._batch_decode_cache: "tuple | None" = None
        self._batch_gang_decode_cache: "tuple | None" = None
        # the causal pass counter (telemetry.pass_context), under _lock
        self._pass_seq = 0

    # -- configuration lifecycle -------------------------------------------

    @property
    def config(self) -> SchedulerConfiguration:
        with self._lock:
            return self._config

    def get_config(self) -> dict:
        return self.config.to_dict()

    def restart(self, new_config: "dict | SchedulerConfiguration") -> None:
        """Swap in a new configuration; an unusable one raises and the old
        stays."""
        if not isinstance(new_config, SchedulerConfiguration):
            new_config = SchedulerConfiguration.from_dict(new_config)
        _check_runnable(new_config)
        with self._lock:
            self._config = new_config

    def reset(self) -> None:
        """Restore the boot-time configuration."""
        with self._lock:
            self._config = self._initial

    # -- pass ids and contexts -----------------------------------------------

    def _next_pass_id(self) -> int:
        """The next causal pass id; called with `_schedule_lock` held."""
        with self._lock:
            self._pass_seq += 1
            return self._pass_seq

    def next_pass_id_hint(self) -> int:
        """The pass id the next pass will carry (exact while the caller is
        the only one running passes on this service)."""
        with self._lock:
            return self._pass_seq + 1

    def _session_scope(self):
        """The pass's session context: spans emitted inside carry this
        service's session id (none for a sessionless service)."""
        if self.session_id is None:
            return contextlib.nullcontext()
        return telemetry.session_context(self.session_id)

    # -- scheduling ---------------------------------------------------------

    def schedule(self) -> list[PodSchedulingResult]:
        """One sequential scheduling pass over the store's state: encode,
        run, delete preemption victims, write placements and annotations
        back. Returns the per-pod records (a nominated pod has two). Passes
        are serialised."""
        with self._schedule_lock, self._session_scope():
            config = self.config  # one read: encode and engine see the same
            self._batch_fallback_counted = False
            pass_id = self._next_pass_id()
            with telemetry.pass_context(pass_id), telemetry.span(
                    "pass.sequential", pass_id=pass_id):
                with self.metrics.time_pass("sequential") as ctx:
                    results = self._schedule_locked(config)
                    ctx.done(
                        pods=len({(r.pod_namespace, r.pod_name) for r in results}),
                        scheduled=sum(1 for r in results if r.status == "Scheduled"),
                    )
            return results

    def schedule_gang(
        self, record: bool = True, window: "int | None" = None
    ) -> "tuple[dict, int, list[PodSchedulingResult] | None]":
        """One gang pass over the store's state; returns ({(ns, name): node
        | ""}, rounds, results). `record=True` writes the 13 annotations back
        as `schedule()` does and returns the records; `record=False` writes
        back the node names only (results is None). `window` is the gang
        engine's `eval_window`. Passes are serialised."""
        if window is not None and int(window) < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        with self._schedule_lock, self._session_scope():
            self._batch_fallback_counted = False
            return self._schedule_gang_timed(record, window)

    def _schedule_gang_timed(self, record: bool, window: "int | None" = None):
        config = self.config  # never has extenders: restart refuses them
        pass_id = self._next_pass_id()
        with telemetry.pass_context(pass_id), telemetry.span("pass.gang", pass_id=pass_id):
            with self.metrics.time_pass("gang") as ctx:
                placements, rounds, results = self._schedule_gang_locked(config, record, window)
                ctx.done(pods=len(placements),
                         scheduled=sum(1 for v in placements.values() if v), rounds=rounds)
        return placements, rounds, results

    def _schedule_gang_locked(self, config, record: bool, window=None):
        t0 = time.perf_counter()
        disp = self._gang_dispatch_once(config, record, window)
        if disp is None:
            return {}, 0, ([] if record else None)
        telemetry.complete("device.execute", t0, time.perf_counter(), tid=telemetry.DEVICE_TID,
                           mode="gang")
        return self._gang_finish_inner(disp, record)

    def _gang_dispatch_once(self, config, record: bool, window=None):
        """Encode and run one gang pass; returns (enc, engine), or None when
        nothing is schedulable. The engine is reused when the gang signature
        and the effective window match one kept."""
        enc = self._encode_current(config)
        if enc is None:
            return None
        chunk = gang_chunk()
        sig = ("gang", GangScheduler.compile_signature(enc),
               GangScheduler.effective_window(enc, window, chunk))
        if not record:
            disp = self._maybe_batched_gang_dispatch(sig, enc, chunk, window)
            if disp is not None:
                return disp
        else:
            # recorded passes stay solo: their replay is per-session host work
            self._count_solo_fallback()
        t0 = time.perf_counter()
        engine = self._engines.pop(sig, None)
        built = engine is None
        if built:
            engine = GangScheduler(enc, strict=True, chunk=chunk, eval_window=window,
                                   device=self.device)
        else:
            engine.retarget(enc)
        engine.run_recorded() if record else engine.run()
        self._engines[sig] = engine  # most recent last
        while len(self._engines) > ENGINE_CACHE_CAP:
            del self._engines[next(iter(self._engines))]
        self._sync()
        if built:
            self.metrics.record_engine_build(time.perf_counter() - t0)
        else:
            self.metrics.record_phase_seconds(execute=time.perf_counter() - t0)
        return enc, engine

    def _gang_finish_inner(self, disp, record: bool):
        """Decode, delete the victims, write back: the records by the
        sequential rule with `record`, else each placed pod's node name."""
        enc, gang = disp
        t_decode = time.perf_counter()
        results = gang.results() if record else None
        before = enc.state0.assignment.cpu().numpy()
        after = gang._final_state.assignment.cpu().numpy()
        placements = gang.enc.decode_assignment(after)
        rounds = int(gang._rounds)
        self.metrics.record_gang(fixpoint_rounds=rounds)
        for p_idx in np.nonzero((before >= 0) & (after < 0))[0]:
            ns, name = enc.pod_keys[int(p_idx)]
            self.store.delete("pods", name, ns)
        if results is not None:
            self._write_back(results, placements)
        else:
            for (ns, name), node_name in placements.items():
                if node_name and self.store.get("pods", name, ns) is not None:
                    self.store.apply("pods", {"metadata": {"name": name, "namespace": ns},
                                              "spec": {"nodeName": node_name}})
        self.metrics.record_phase_seconds(decode=time.perf_counter() - t_decode)
        self._fleet_sample(enc, gang._final_state, "gang", after)
        return placements, rounds, results

    def _schedule_locked(self, config) -> list[PodSchedulingResult]:
        # the pass's device window (encode and engine run inside the
        # dispatch), on the device track
        t0 = time.perf_counter()
        disp = self._seq_dispatch_once(config)
        if disp is None:
            return []
        telemetry.complete("device.execute", t0, time.perf_counter(), tid=telemetry.DEVICE_TID,
                           mode="sequential")
        return self._seq_finish_inner(disp)

    def _fleet_sample(self, enc, state, mode: str, assignment=None) -> None:
        """One fleet-observatory sample over this pass's encoding and final
        state (utils/fleetstats.py); `assignment` is the finish path's host
        copy of the final assignment. It only reads the pass's tensors, and
        never raises: a failed sample never fails a pass. No-op unless
        KSS_FLEET_STATS (or `fleetstats.activate`) armed a recorder."""
        rec = fleetstats.active()
        if rec is None:
            return
        try:
            rec.sample_pass(self, enc, state, mode, assignment)
        except Exception:  # noqa: BLE001 — a failed sample never fails a pass
            pass

    def _encode_current(self, config) -> "object | None":
        """Encode the store's pending state: the (latest rv, policy) LRU
        serves an unchanged store; the delta encoder replays the store's
        events into the retained encoding; it falls back to a full encode
        where it must. None when nothing is schedulable."""
        t0 = time.perf_counter()
        policy = policy_from_env()
        cache_key = (self.store.latest_rv(), policy.name)
        cached = self._enc_cache.get(cache_key, config)
        if cached is not EncodingCache.MISS:
            with self._lock:
                self.last_encode_info = {"mode": "cached"}
            self.metrics.record_encode("cached", time.perf_counter() - t0)
            telemetry.complete("pass.encode", t0, time.perf_counter(), mode="cached")
            return cached
        self._delta.policy = policy
        enc, info = self._delta.encode(self.store, config)
        if info.get("reason") == "dtype-policy-change":
            self.metrics.record_encode_policy_miss()
        self._enc_cache.put(cache_key, config, enc)
        with self._lock:
            self.last_encode_info = info
        self._sync()
        self.metrics.record_encode(info["mode"], time.perf_counter() - t0)
        telemetry.complete("pass.encode", t0, time.perf_counter(), mode=info["mode"])
        return enc

    def _sync(self) -> None:
        """Wait for the card, so that a phase's seconds hold its device work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _seq_dispatch_once(self, config):
        """Encode and run one pass; returns (enc, engine) for the finish, or
        None when nothing is schedulable. The engine is reused when the
        encoding's compile signature matches one kept."""
        enc = self._encode_current(config)
        if enc is None:
            return None
        sig = ("seq", BatchedScheduler.compile_signature(enc))
        disp = self._maybe_batched_dispatch(sig, enc)
        if disp is not None:
            return disp
        t0 = time.perf_counter()
        engine = self._engines.pop(sig, None)
        if engine is None:
            engine = BatchedScheduler(enc, record=True, strict=True, device=self.device)
            engine.run()
            built = True
        else:
            engine.retarget(enc)
            engine.run()
            built = False
        self._engines[sig] = engine  # most recent last
        while len(self._engines) > ENGINE_CACHE_CAP:
            del self._engines[next(iter(self._engines))]
        self._sync()
        if built:
            self.metrics.record_engine_build(time.perf_counter() - t0)
        else:
            self.metrics.record_phase_seconds(execute=time.perf_counter() - t0)
        return enc, engine

    def _count_solo_fallback(self) -> None:
        """One `soloFallbacks` a pass that the armed plane did not serve."""
        if self.batch_plane is None or self._batch_fallback_counted:
            return
        self._batch_fallback_counted = True
        self.metrics.record_batching(solo_fallbacks=1)

    def _maybe_batched_dispatch(self, sig: tuple, enc):
        """Serve this sequential pass through the batch plane: enroll it
        under `sig` and come back with its slice of one `batch.seq.run`
        launch (placements and trace as a solo pass's). Returns (enc, engine)
        as `_seq_dispatch_once` does, or None for solo dispatch (a lone
        window, a draining plane, a failed batched launch: counted)."""
        plane = self.batch_plane
        if plane is None:
            return None
        # the engine that decodes this pass's slice (never run: the slice
        # lands in _final_state and _trace); a signature-stable session
        # reuses the last one through retarget
        cached = self._batch_decode_cache
        if cached is not None and cached[0] == sig:
            engine = cached[1].retarget(enc)
        else:
            engine = BatchedScheduler(enc, record=True, strict=True, device=self.device)
            self._batch_decode_cache = (sig, engine)
        out = plane.submit(sig, engine, metrics=self.metrics)
        if out is None:
            self._count_solo_fallback()
            return None
        engine._final_state, engine._trace = out
        return enc, engine

    def _maybe_batched_gang_dispatch(self, sig: tuple, enc, chunk, window):
        """The gang twin of `_maybe_batched_dispatch` for an unrecorded gang
        pass (`batch.gang.run`): returns (enc, gang) with the pass's final
        state and rounds from one batched fixpoint, or None for solo."""
        plane = self.batch_plane
        if plane is None:
            return None
        cached = self._batch_gang_decode_cache
        if cached is not None and cached[0] == sig:
            gang = cached[1].retarget(enc)
        else:
            gang = GangScheduler(enc, strict=True, chunk=chunk, eval_window=window,
                                 device=self.device)
            self._batch_gang_decode_cache = (sig, gang)
        out = plane.submit(sig, gang, metrics=self.metrics, kind="gang")
        if out is None:
            self._count_solo_fallback()
            return None
        gang._final_state, gang._rounds = out
        return enc, gang

    def _seq_finish_inner(self, disp) -> list[PodSchedulingResult]:
        """Decode the trace, delete the victims, write the records back.
        Reads the pass's encoding as "before": this pass's finish precedes
        the next encode (passes are synchronous)."""
        enc, engine = disp
        t0 = time.perf_counter()
        results = engine.results()
        self.metrics.record_phase_seconds(decode=time.perf_counter() - t0)

        # preemption victims: pre-bound pods that lost their node are
        # deleted, as the upstream scheduler deletes them through the API
        t_decode = time.perf_counter()
        before = enc.state0.assignment.cpu().numpy()
        after = engine._final_state.assignment.cpu().numpy()
        placements = enc.decode_assignment(after)
        for p_idx in np.nonzero((before >= 0) & (after < 0))[0]:
            ns, name = enc.pod_keys[int(p_idx)]
            self.store.delete("pods", name, ns)

        self._write_back(results, placements)
        self.metrics.record_phase_seconds(decode=time.perf_counter() - t_decode)
        self._fleet_sample(enc, engine._final_state, "sequential", after)
        return results

    def _write_back(self, results, placements) -> None:
        """Write each record's annotations (and its node, when placed) onto
        its pod; the last record of a pod wins (a nominated pod's retry
        overwrites its first record)."""
        for res in results:
            patch: dict = {
                "metadata": {
                    "name": res.pod_name,
                    "namespace": res.pod_namespace,
                    "annotations": res.to_annotations(),
                }
            }
            sel = placements.get((res.pod_namespace, res.pod_name), "")
            if sel:
                patch["spec"] = {"nodeName": sel}
            if self.store.get("pods", res.pod_name, res.pod_namespace) is not None:
                self.store.apply("pods", patch)


class SimulatorService:
    """Store + scheduler + snapshot composites."""

    def __init__(
        self,
        initial_config: "SchedulerConfiguration | None" = None,
        *,
        device: "str | torch.device | None" = None,
    ):
        self.store = ResourceStore()
        self.scheduler = SchedulerService(self.store, initial_config, device=device)
        self.store.snapshot_initial()

    def export(self) -> dict:
        """The resources and the scheduler configuration, as a snapshot."""
        return export_snapshot(self.store, self.scheduler.get_config())

    def import_(self, snapshot: dict, ignore_err: bool = False) -> list[str]:
        """Restart the scheduler with the snapshot's configuration (when it
        has one), then apply its resources in dependency order. Returns the
        skipped objects' errors (with `ignore_err`)."""
        cfg = snapshot.get("schedulerConfig")
        if cfg:
            self.scheduler.restart(cfg)
        _, errors = import_snapshot(self.store, snapshot, ignore_err=ignore_err)
        return errors

    def reset(self) -> None:
        """Restore the boot resources and the boot configuration."""
        self.store.reset()
        self.scheduler.reset()
