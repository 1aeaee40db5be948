"""The port's GangSweep against the reference's on the whole default
profile: a small `preemption_cluster` (pre-bound low-priority pods, every
variant runs preempt phases) under `supported_config()`, TPU32, three
weight variants. Compared as in test_torch_gangsweep.py: assignments [V,
P], rounds [V] and placements, exactly. A file of its own so that its
reference compiles (three vmapped default-profile programs) run beside the
other file's.
"""

from test_torch_gangsweep import check_preempting


def test_default_profile_sweep_matches_reference():
    p = check_preempting("default")
    assert len(p.last_stats["phase_bound"]) == p.last_stats["phases"]
