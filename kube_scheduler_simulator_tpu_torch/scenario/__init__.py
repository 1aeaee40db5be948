"""One-shot batch simulation runs (KEP-159 / KEP-184), cut to sweep jobs."""

from .batch import BatchJob, load_jobs, run_batch, run_job

__all__ = ["BatchJob", "load_jobs", "run_batch", "run_job"]
