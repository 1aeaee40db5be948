"""Monte-Carlo weight sweeps: many score-weight variants of one pass, through
the sequential engine (`WeightSweep`) or the gang engine (`GangSweep`)."""

from .sweep import GangSweep, WeightSweep, weights_for

__all__ = ["GangSweep", "WeightSweep", "weights_for"]
