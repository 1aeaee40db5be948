"""kube_scheduler_simulator_tpu_torch — the simulator's port to PyTorch and
CUDA on an NVIDIA H100.

The JAX package `kube_scheduler_simulator_tpu` beside it is the reference;
this package imports nothing of it (nor `jax`) and keeps its own copies of
what it needs. It grows slice by slice. This slice is the sequential
scheduling pass: encode → one pass over the queue → result decode, with
the NodeUnschedulable, NodeName, TaintToleration and NodeResourcesFit
filters and the NodeResourcesFit, NodeResourcesBalancedAllocation and
TaintToleration scores. On the card the pass runs in hand-written CUDA
kernels (csrc/seq_kernels.cu, engine/cuda.py); on the CPU their plain
PyTorch versions run.

Entry points run on the CUDA card unless the caller passes `device="cpu"`;
with no card and no explicit device they raise RuntimeError.

Layout:
  models/   manifest views, string vocabularies
  sched/    scheduler configuration, per-pod result records
  engine/   encoder, plugin bodies, the sequential engine, kernel bindings
  csrc/     the CUDA sources
  utils/    quantities, shape buckets
"""

from .engine.encode import EXACT, TPU32, encode_cluster, from_reference_arrays
from .engine.engine import BatchedScheduler, schedule
from .engine.engine import supported_config as slice_config
from .synth import synthetic_cluster

__version__ = "0.1.0"

__all__ = [
    "EXACT",
    "TPU32",
    "BatchedScheduler",
    "encode_cluster",
    "from_reference_arrays",
    "schedule",
    "slice_config",
    "synthetic_cluster",
]
