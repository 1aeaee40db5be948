"""kube_scheduler_simulator_tpu_torch — the simulator's port to PyTorch and
CUDA on an NVIDIA H100.

The JAX package `kube_scheduler_simulator_tpu` beside it is the reference;
this package imports nothing of it (nor `jax`) and keeps its own copies of
what it needs. It grows slice by slice. It runs the sequential scheduling
pass: encode → one pass over the queue → result decode, for the
reference's whole default plugin profile (`supported_config()`, also
`slice_config()`): 15 filters with the volume family, the VolumeBinding
prefilter, DefaultPreemption with its dry run, eviction and retry, and 7
scores. Two smaller profiles stay as the earlier slices' paths:
`fit_config()` (fit, node name, unschedulable, taints) and
`affinity_config()` (the default profile without the volume family and
DefaultPreemption). On the card the pass runs in hand-written CUDA kernels
(csrc/seq_kernels.cu, engine/cuda.py); on the CPU their plain PyTorch
versions run.

The serving path (`SimulatorService`, `SchedulerService`) keeps a
`ResourceStore` and schedules it pass by pass: an unchanged store reuses
its encoding, a changed one is replayed into the retained encoding by the
delta encoder (`DeltaEncoder`, whose row scatters are the K10 kernels of
csrc/delta_kernels.cu), and placements and the 13 result annotations are
written back onto the pods. `SchedulerService.schedule_gang()` runs a
store's pass through the gang (fixpoint) engine, `GangScheduler`: rounds
that evaluate every pending pod at once (the K9 kernels of
csrc/gang_kernels.cu), with DefaultPreemption's phases between them.

Monte-Carlo weight sweeps (`WeightSweep`, BASELINE config #4) run the
sequential pass for every row of a [V, S] score-weight matrix over one
cluster in a single launch of the `sweep_run` kernel, one block per variant
at a time; the KEP-184 batch runner (`scenario/batch.py`, `python -m
kube_scheduler_simulator_tpu_torch.scenario.batch`) runs sweep jobs from
spec files. `GangSweep` sweeps the gang engine the same way: every round of
every variant is one launch of each K9 kernel, and the preempt phases of
all variants one `sweep_run` launch over per-variant segments (a batch
job's `engine: gang`).

The session plane (`SessionManager`, server/sessions.py) keeps many tenants'
services in one process; with ``KSS_BATCH`` set its batch plane
(`BatchPlane`, server/batchplane.py) serves concurrent compatible passes of
different sessions as one launch on the card: B sequential passes through
the tenant form of `sweep_run`, or B gang fixpoints through the tenant forms
of the K9 kernels, each tenant over its own cluster.

Monte-Carlo node-failure sweeps (`FaultSweep`, lifecycle/faultsweep.py)
read a policy's disruption profile over S sampled failure scenarios of one
cluster: the bound pods of each scenario's failed nodes are evicted
(`fault_evict`, csrc/fault_kernels.cu), every scenario's gang round
fixpoint runs through the K9 kernels' tenant forms, one launch of each a
round, and `fault_tally` counts the pods rescheduled and stranded.

Three dtype policies: `EXACT` (int64), `TPU32` (int32, memory in Mi; the
default) and `PACKED` (``KSS_DTYPE_POLICY=packed``: TPU32's arithmetic with
ids and counts narrowed and masks bit-packed at rest, engine/packing.py).
Every path widens a PACKED encoding once at a pass's entry with the K8
kernel (csrc/pack_kernels.cu) and then runs as under TPU32, with the same
placements and trace.

Entry points run on the CUDA card unless the caller passes `device="cpu"`;
with no card and no explicit device they raise RuntimeError.

Layout:
  models/   manifest views, string vocabularies, the resource store and
            snapshot export/import
  sched/    scheduler configuration, per-pod result records, the volume
            plugins' snapshot
  engine/   encoder, delta encoder, plugin bodies, the sequential engine,
            kernel bindings
  server/   the scheduling service over a store, the session and batch planes
  parallel/ weight sweeps (`WeightSweep`, `GangSweep`, `weights_for`)
  lifecycle/ node-failure sweeps (`FaultSweep`)
  scenario/ the batch runner's sweep jobs
  csrc/     the CUDA sources
  utils/    quantities, shape buckets, pass metrics, the reference's
            failure-mask draw (`prng`)
"""

from .engine.delta import DeltaEncoder
from .engine.encode import EXACT, PACKED, TPU32, encode_cluster, from_reference_arrays
from .engine.engine import (
    BatchedScheduler,
    affinity_config,
    demo_config,
    fit_config,
    schedule,
    supported_config,
)
from .engine.engine import supported_config as slice_config
from .engine.gang import GangScheduler
from .lifecycle import FaultSweep
from .models.store import ResourceStore
from .parallel import GangSweep, WeightSweep, weights_for
from .server.batchplane import BatchPlane
from .server.service import SchedulerService, SimulatorService
from .server.sessions import SessionManager
from .synth import preemption_cluster, synthetic_affinity_cluster, synthetic_cluster

__version__ = "0.1.0"

__all__ = [
    "EXACT",
    "PACKED",
    "TPU32",
    "BatchPlane",
    "BatchedScheduler",
    "DeltaEncoder",
    "FaultSweep",
    "GangScheduler",
    "GangSweep",
    "ResourceStore",
    "SchedulerService",
    "SessionManager",
    "SimulatorService",
    "WeightSweep",
    "affinity_config",
    "demo_config",
    "encode_cluster",
    "fit_config",
    "from_reference_arrays",
    "preemption_cluster",
    "schedule",
    "slice_config",
    "supported_config",
    "synthetic_affinity_cluster",
    "synthetic_cluster",
    "weights_for",
]
