"""Cluster-lifecycle sweeps: for now the Monte-Carlo node-failure sweep,
`FaultSweep` (the reference's `lifecycle/faultsweep.py`), which reads a
policy's disruption profile across many sampled failure scenarios of one
cluster in one pass on the card.

Still to be ported from the reference's `lifecycle/`: the host-side
discrete-event engine (`LifecycleEngine`, `engine.py`) with the chaos
timeline schema it replays (`scenario/chaos.py`), run checkpoints
(`checkpoint.py`) and the command line (`__main__.py`, whose `--sweep` mode
calls `FaultSweep` after the timeline)."""

from .faultsweep import FaultSweep

__all__ = ["FaultSweep"]
