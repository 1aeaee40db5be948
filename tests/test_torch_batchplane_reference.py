"""The reference's own batched windows against the port's, once a kind.

The reference's batch plane (`batch.seq.run`, `batch.gang.run`: one vmapped
program a window) serves one window of three tenants of the preempting
fixture; the port's plane serves the same window (one launch of the tenant
forms; the plain versions here). Each tenant's records (sequential) or
placements, rounds and store bytes (gang) are equal, and so are the batching
counters of every tenant and of the plane. The reference pins its batched
answers equal to its solo ones, which the other batch-plane files compare
against. Tolerance: exact equality.
"""

from __future__ import annotations

from test_torch_batchplane import batched_run, dtype_policy
from test_torch_gang_batchplane import batched_gang


def test_sequential_window_equals_the_reference_batched_window():
    with dtype_policy("tpu32"):
        want = batched_run(ref=True, preempt=True)
        got = batched_run(ref=False, preempt=True)
    assert got[0] == want[0]
    assert got[1] == want[1] and got[2] == want[2]
    assert want[2]["batchWindows"] == 1 and want[2]["batchOccupancySum"] == 3
    assert any('"Nominated"' in d for d in want[0].values())


def test_gang_window_equals_the_reference_batched_window():
    with dtype_policy("tpu32"):
        want = batched_gang("preempt", ref=True)
        got = batched_gang("preempt")
    assert got[0] == want[0]
    assert got[1] == want[1] and got[2] == want[2]
    assert all(ph["batchedGangPasses"] == 1 for ph in want[1])
