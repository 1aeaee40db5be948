"""The port's gang record path against the reference's on a small
`preemption_cluster`.

As test_torch_gang_records.py (`records_both`): the port's `results()` must
give the reference GangScheduler's records byte for byte — status,
nominated node, victims and the 13 annotations of every record, in order —
and `run_recorded()` must place exactly as `run()`; here under the whole
default profile with volumes: two preempt phases with rounds between.
TPU32 and EXACT. Tolerance: exact equality.
"""

import pytest

import kube_scheduler_simulator_tpu_torch as kp

from test_torch_encode import POLICIES
from test_torch_gang_records import records_both


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_small_preemption_cluster_records(policy):
    nodes, pods, objects = kp.preemption_cluster(12, 60, seed=5)
    p = records_both(nodes, pods, kp.supported_config().to_dict(), policy, objects, chunk=16)
    assert any(r.preemption_victims for r in p.results())
