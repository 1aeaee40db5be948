"""Shape buckets for padded axes."""

from __future__ import annotations


def shape_bucket(n: int, lo: int = 8) -> int:
    """Geometric (power-of-two) shape bucket for a live object count.

    Padded-axis lengths — the sequential pass's queue length among them —
    are rounded up to the next power of two at or above `lo`, so churn
    that adds or removes a few objects keeps one shape class. `n <= 0`
    maps to 0: an empty axis is its own shape class, not an 8-wide one.
    """
    if n <= 0:
        return 0
    c = lo
    while c < n:
        c *= 2
    return c
