"""The batch plane's gang windows under the EXACT dtype policy, and a
window whose tenants need different numbers of preempt phases.

EXACT (64-bit integers, exact quantities): each tenant of a batched gang
window, with and without preemption, gives the placements, rounds and
store bytes of the reference's solo `schedule_gang(record=False)` (the
sequential windows' EXACT case is in test_torch_batchplane.py). Then the
lockstep trap of test_torch_gang_batchplane.py under EXACT. Tolerance:
exact equality.
"""

from __future__ import annotations

import pytest

from test_torch_batchplane import N, dtype_policy
from test_torch_gang_batchplane import batched_gang, check_own_loops, ref_gang


@pytest.mark.parametrize("fixture", ["plain", "preempt"])
def test_gang_windows_equal_the_reference_under_exact(fixture):
    solo = ref_gang(fixture, "exact")
    with dtype_policy("exact"):
        out, per, default, stats = batched_gang(fixture)
    for i in range(N):
        assert out[i] == solo[i], f"tenant {i} differs from the reference's solo pass"
        assert per[i]["batchedGangPasses"] == 1 and per[i]["soloFallbacks"] == 0
    assert default["batchWindows"] == 1 and default["batchOccupancySum"] == N


def test_each_tenant_stops_with_its_own_loop():
    check_own_loops("exact")
