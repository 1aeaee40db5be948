"""One-shot batch simulation runs (KEP-159 / KEP-184).

A batch is a list of jobs, each read from a spec (KEP-184's file-based
contract: every ``*.json`` / ``*.yaml`` spec in an input directory is a job,
and each job writes ``<name>.result.json`` into an output directory):

  * ``sweep`` — the Monte-Carlo fast path (BASELINE config #4): a cluster
    snapshot and a list of score-weight variants, every variant's pass in
    one launch of the `sweep_run` kernel (parallel/sweep.py) where KEP-159
    would run one simulator replica per variant
    (``engine: gang`` sweeps the gang engine instead, `GangSweep`: each
    round of every variant one launch of each K9 kernel);
  * ``scenario`` — a KEP-140 scenario run. The scenario engine is not
    ported yet (its ``operations`` are not read): such a job becomes a
    ``phase: Failed`` result naming NotImplementedError, and the rest of
    the batch still runs (the runner's per-job isolation).

YAML specs parse only where PyYAML is installed; elsewhere such a spec is a
failed job.

    python -m kube_scheduler_simulator_tpu_torch.scenario.batch \\
        --input-dir specs/ --out-dir results/ [--device cpu]
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass, field

import numpy as np

from ..models.snapshot import import_snapshot
from ..models.store import ResourceStore
from ..sched.config import SchedulerConfiguration


@dataclass
class BatchJob:
    """One simulation job (the SchedulerSimulation analogue)."""

    name: str
    kind: str = "scenario"  # "scenario" | "sweep"
    snapshot: "dict | None" = None  # sweep: cluster snapshot (import wire shape)
    scheduler_config: "SchedulerConfiguration | None" = None
    # sweep: list of {plugin name -> weight} override dicts, one per variant
    weight_variants: list[dict] = field(default_factory=list)
    # sweep engine: "sequential" | "gang"
    engine: str = "sequential"
    # set when the spec file could not be parsed; the job then fails at
    # run time like any other job, preserving batch isolation
    parse_error: str = ""

    @classmethod
    def from_spec(cls, name: str, spec: dict) -> "BatchJob":
        cfg = spec.get("schedulerConfig")
        job = cls(
            name=name,
            kind=spec.get("kind", "scenario"),
            snapshot=spec.get("snapshot"),
            scheduler_config=SchedulerConfiguration.from_dict(cfg) if cfg else None,
            weight_variants=spec.get("weightVariants", []),
            engine=spec.get("engine", "sequential"),
        )
        if job.kind not in ("scenario", "sweep"):
            raise ValueError(f"job {name!r}: unknown kind {job.kind!r}")
        if job.kind == "sweep" and job.snapshot is None:
            raise ValueError(f"job {name!r}: sweep jobs need a snapshot")
        if job.engine not in ("sequential", "gang"):
            raise ValueError(f"job {name!r}: unknown engine {job.engine!r}")
        return job


def _run_sweep_job(job: BatchJob, device=None) -> dict:
    from ..engine.encode import TPU32, encode_cluster
    from ..parallel.sweep import GangSweep, WeightSweep, weights_for

    store = ResourceStore()
    import_snapshot(store, job.snapshot)
    cfg = job.scheduler_config or SchedulerConfiguration.default()
    enc = encode_cluster(
        store.list("nodes"),
        store.list("pods"),
        cfg,
        policy=TPU32,
        priorityclasses=store.list("priorityclasses"),
        namespaces=store.list("namespaces"),
        pvcs=store.list("pvcs"),
        pvs=store.list("pvs"),
        storageclasses=store.list("storageclasses"),
        device=device,
    )
    variants = job.weight_variants or [{}]
    w = np.stack([weights_for(enc, ov) for ov in variants])
    if job.engine == "gang":
        sweep = GangSweep(enc, device=device)
        assignments, _ = sweep.run(w)
        placements = sweep.placements(assignments)
    else:
        sweep = WeightSweep(enc, device=device)
        _, sels = sweep.run(w)
        placements = sweep.placements(sels)
    return {
        "phase": "Succeeded",
        "variants": [
            {
                "weights": {n: int(wv) for (n, _), wv in zip(enc.config.score_plugins(), w[v])},
                "scheduled": sum(1 for x in placements[v].values() if x),
                "unschedulable": sum(1 for x in placements[v].values() if not x),
                "placements": {
                    f"{ns}/{name}": node_ for (ns, name), node_ in sorted(placements[v].items())
                },
            }
            for v in range(len(variants))
        ],
    }


# Sweep jobs are device-bound: one at a time per process, whoever the
# caller is.
_DEVICE_JOB_LOCK = threading.Lock()


def run_job(job: BatchJob, *, device=None) -> dict:
    """Execute one job; returns its result dict (the KEP-184 output file
    payload). Sweep jobs serialize process-wide. Runs on the CUDA card
    unless `device` names another."""
    if job.parse_error:
        raise ValueError(job.parse_error)
    if job.kind == "sweep":
        with _DEVICE_JOB_LOCK:
            return _run_sweep_job(job, device=device)
    raise NotImplementedError("scenario jobs (the KEP-140 scenario engine) are not ported yet")


def run_batch(
    jobs: list[BatchJob],
    *,
    out_dir: "str | None" = None,
    device=None,
) -> dict[str, dict]:
    """Run every job; optionally write ``<name>.result.json`` files.

    Jobs run one after another on the host; the parallel axis is inside
    each sweep job's launch. A job that raises is recorded as
    phase=Failed; the remaining jobs still run.
    """
    names = [j.name for j in jobs]
    dupes = {n for n in names if names.count(n) > 1}
    if dupes:
        raise ValueError(f"duplicate job names would silently drop results: {sorted(dupes)}")

    results = {}
    for job in jobs:
        try:
            results[job.name] = run_job(job, device=device)
        except Exception as e:  # noqa: BLE001 — job failure is a result
            results[job.name] = {"phase": "Failed", "message": f"{type(e).__name__}: {e}"}
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        for name, res in results.items():
            with open(os.path.join(out_dir, f"{name}.result.json"), "w") as f:
                json.dump(res, f, indent=2, sort_keys=True)
    return results


def load_jobs(input_dir: str) -> list[BatchJob]:
    """Every *.json / *.yaml / *.yml spec file in `input_dir` → one job,
    named after its file stem. A malformed spec becomes a job that fails at
    run time. Files sharing a stem (a.json + a.yaml) are told apart by
    their extension."""
    jobs = []
    stems: set[str] = set()
    for fn in sorted(os.listdir(input_dir)):
        stem, ext = os.path.splitext(fn)
        path = os.path.join(input_dir, fn)
        if ext not in (".json", ".yaml", ".yml"):
            continue
        if stem in stems:
            stem = f"{stem}.{ext[1:]}"
        stems.add(stem)
        try:
            if ext == ".json":
                with open(path) as f:
                    spec = json.load(f)
            else:
                import yaml

                with open(path) as f:
                    spec = yaml.safe_load(f)
            if not isinstance(spec, dict):
                raise ValueError(f"spec must be a mapping, got {type(spec).__name__}")
            jobs.append(BatchJob.from_spec(stem, spec))
        except Exception as e:  # noqa: BLE001 — isolate per spec file
            jobs.append(BatchJob(name=stem, parse_error=f"{type(e).__name__}: {e}"))
    return jobs


def main(argv: "list[str] | None" = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="kube_scheduler_simulator_tpu_torch.scenario.batch",
        description="One-shot batch simulation runner (KEP-159/184).",
    )
    ap.add_argument("--input-dir", required=True, help="directory of job specs")
    ap.add_argument("--out-dir", required=True, help="directory for results")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA card)")
    args = ap.parse_args(argv)
    jobs = load_jobs(args.input_dir)
    results = run_batch(jobs, out_dir=args.out_dir, device=args.device)
    failed = [n for n, r in results.items() if r.get("phase") == "Failed"]
    print(
        f"batch: {len(jobs)} jobs, {len(jobs) - len(failed)} succeeded, "
        f"{len(failed)} failed" + (f" ({', '.join(failed)})" if failed else "")
    )
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
