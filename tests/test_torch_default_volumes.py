"""The reference's default-profile volume scenario
(test_engine_parity_vol.py `test_default_config_parity_with_volumes`): the
whole default KubeSchedulerConfiguration over PVC, PV and inline-disk pods,
through the JAX engine and the port (plain versions, CPU) under EXACT and
TPU32 (test_torch_preempt.run_both; exact equality)."""

import pytest

from kube_scheduler_simulator_tpu.sched.config import SchedulerConfiguration as JConfig

from test_torch_encode import POLICIES
from test_torch_preempt import run_both
from test_torch_volumes import _default_profile


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_default_profile_with_volumes_matches_reference(policy):
    nodes, pods, objects = _default_profile()
    got = run_both(nodes, pods, JConfig.default().to_dict(), policy, **objects)
    assert {r.status for r in got} == {"Scheduled"}
