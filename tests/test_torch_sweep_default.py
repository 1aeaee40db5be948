"""The port's WeightSweep against the reference's under the whole default
profile.

As test_torch_sweep.py, on its small `preemption_cluster` (volumes, mixed
priorities; the variants are the configuration's weights and three single
plugins at weight 10): every `SchedState` field of every variant, the
selections and the placements equal the reference's, TPU32 against its
phase event loop and EXACT against its masked scan (the reference pins the
two equal); the variants place differently and their dry runs evict.
Tolerance: exact equality.
"""

import pytest

from test_torch_sweep import (  # noqa: F401  (reference: the module's fixture)
    assert_same,
    assert_states_equal,
    evicted,
    port_sweep,
    reference,
)


@pytest.mark.parametrize("policy,mode", [("i32", "phase"), ("exact", "masked")])
def test_default_profile_sweep_matches_reference(reference, policy, mode):
    """The whole default profile on a small preemption_cluster (volumes,
    mixed priorities): TPU32 against the phase loop, EXACT against the
    masked scan (the reference pins the two equal)."""
    _, j_states, j_sels, j_place = reference("default", policy, mode)
    sweep, w, (states, sels) = port_sweep("default", policy)
    assert sweep.preempt == "phase"
    assert_states_equal(j_states, states, len(w))
    assert_same("sels", j_sels, sels)
    assert sweep.placements(sels) == j_place
    # the variants place differently, and dry runs nominated and evicted
    assert len({tuple(x) for x in sels.tolist()}) > 1
    assert any(evicted(sweep, states))
