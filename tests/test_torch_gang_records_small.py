"""The port's gang record path against the reference's on two small
clusters: one pod alone under the whole default profile, and a preempt
phase followed by resumed rounds.

As test_torch_gang_records.py (`records_both`): the port's `results()` must
give the reference GangScheduler's records byte for byte — status,
nominated node, victims and the 13 annotations of every record, in order —
and `run_recorded()` must place exactly as `run()`. TPU32 and EXACT.
Tolerance: exact equality.
"""

import pytest

from helpers import node, pod
from test_torch_encode import POLICIES
from test_torch_gang import PREEMPT_CFG
from test_torch_gang_records import DEFAULT_CFG, records_both


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_single_pod_record(policy):
    nodes = [node(f"n{i}", cpu="4", pods="8") for i in range(3)]
    records_both(nodes, [pod("solo", cpu="1")], DEFAULT_CFG, policy)


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_phase_then_resumed_rounds_records(policy):
    nodes = [node("n0", cpu="2", pods="8"), node("n1", cpu="2", pods="8"),
             node("n2", cpu="1", pods="8")]
    pods = [pod("low-0", cpu="1800m", priority=1, node_name="n0"),
            pod("low-1", cpu="1800m", priority=1, node_name="n1"),
            pod("high-0", cpu="1500m", priority=100), pod("high-1", cpu="1500m", priority=100),
            pod("small", cpu="500m", priority=50), pod("small2", cpu="600m", priority=50)]
    p = records_both(nodes, pods, PREEMPT_CFG, policy)
    kinds = [e[0] for e in p._chronology]
    assert kinds[:3] == ["rounds", "phase", "rounds"], kinds
