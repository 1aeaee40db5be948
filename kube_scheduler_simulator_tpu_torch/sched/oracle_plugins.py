"""Plugin constants shared by the encoder and the kernels.

The reference package keeps these beside its pure-Python oracle
(`sched/oracle_plugins.py`); the port carries only the two it needs.
"""

from __future__ import annotations

from .config import MAX_NODE_SCORE

# Usage fractions are quantized to 1/2^16 so the BalancedAllocation score is
# decided purely by integer arithmetic (upstream computes a float64 std;
# float division is not bit-portable across compilers). Results can differ
# from upstream Go by at most 1 point when a usage fraction straddles a
# 2^-16 quantum.
BALANCED_SCALE = 1 << 16


def rtcr_shape(strategy: dict) -> list[tuple[int, int]]:
    """The RequestedToCapacityRatio shape points, scaled the upstream way:
    user scores are 0..10 (MaxCustomPriorityScore) and are multiplied by
    MaxNodeScore/10 when the scorer is built; sorted by utilization."""
    pts = (strategy.get("requestedToCapacityRatio") or {}).get("shape") or [
        {"utilization": 0, "score": 0},
        {"utilization": 100, "score": 10},
    ]
    return sorted(
        (int(p.get("utilization", 0)), int(p.get("score", 0)) * (MAX_NODE_SCORE // 10))
        for p in pts
    )
