"""Shape buckets for padded axes, and the capacity buckets of the serving
path."""

from __future__ import annotations

# the smallest capacity bucket of the serving path's node and pod axes
CAPACITY_LO = 8


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


def capacity_buckets(n_nodes: int, n_pods: int) -> tuple[int, int]:
    """(node_capacity, pod_capacity) for a cluster of live counts: the
    bucket policy every `encode_cluster` caller of the serving path shares
    (server/service.py, the delta encoder). Two stores whose counts land
    in the same buckets encode to tensors of the same shapes."""
    return (
        max(shape_bucket(n_nodes, CAPACITY_LO), 1),
        max(shape_bucket(n_pods, CAPACITY_LO), 1),
    )
