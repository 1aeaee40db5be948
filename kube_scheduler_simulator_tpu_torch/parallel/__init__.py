"""Monte-Carlo weight sweeps: many score-weight variants of one pass."""

from .sweep import WeightSweep, weights_for

__all__ = ["WeightSweep", "weights_for"]
