"""The PyTorch port's encoder against the reference encoder.

Every leaf the two encodings share (the cluster planes, the initial state
and the PrioritySort queue) must be equal field by field: same dtype, same
shape, same values. Tolerance: exact equality.
"""

import dataclasses

import numpy as np
import pytest

from kube_scheduler_simulator_tpu.engine import EXACT as J_EXACT
from kube_scheduler_simulator_tpu.engine import TPU32 as J_TPU32
from kube_scheduler_simulator_tpu.engine import encode_cluster as j_encode_cluster
from kube_scheduler_simulator_tpu.sched.config import SchedulerConfiguration as JConfig

import kube_scheduler_simulator_tpu_torch as kp
from kube_scheduler_simulator_tpu_torch.engine.encode import ClusterArrays, SchedState
from kube_scheduler_simulator_tpu_torch.sched.config import SchedulerConfiguration as PConfig

POLICIES = {"exact": (J_EXACT, kp.EXACT), "i32": (J_TPU32, kp.TPU32)}

PRIORITY_CLASSES = [
    {"metadata": {"name": "high"}, "value": 1000},
    {"metadata": {"name": "low"}, "value": -5, "globalDefault": True},
]


def port_cluster(seed, n_nodes=24, n_pods=100):
    """A synthetic cluster dressed so every path of the slice fires: taints
    of all three effects, tolerations (Equal, Exists, wildcard key, unknown
    operator), cordoned nodes, pods pinned by nodeName (to a real node, so
    pre-bound, and to a missing one), pods too large for any node, explicit
    and class-derived priorities, and an extended resource. Choices come
    from a numpy generator seeded with `seed`."""
    nodes, pods = kp.synthetic_cluster(n_nodes, n_pods, seed=seed, priorities=True)
    rng = np.random.default_rng(seed)
    for i, nd in enumerate(nodes):
        taints = []
        if i % 7 == 3:
            taints.append({"key": "dedicated", "value": "gpu", "effect": "NoSchedule"})
        if i % 11 == 2:
            taints.append({"key": "spot", "value": "true", "effect": "PreferNoSchedule"})
        if i % 13 == 5:
            taints.append({"key": "maint", "effect": "NoExecute"})
        spec = {}
        if taints:
            spec["taints"] = taints
        if rng.random() < 0.1:
            spec["unschedulable"] = True
        nd["spec"] = spec
        if i % 4 == 0:
            nd["status"]["allocatable"]["ephemeral-storage"] = f"{int(rng.integers(10, 100))}Gi"
            nd["status"]["allocatable"]["example.com/gpu"] = str(int(rng.integers(0, 3)))
    for i, pd in enumerate(pods):
        spec = pd["spec"]
        req = spec["containers"][0]["resources"]["requests"]
        if i % 5 == 0:
            spec["tolerations"] = [
                {"key": "dedicated", "operator": "Equal", "value": "gpu", "effect": "NoSchedule"}
            ]
        if i % 10 == 1:
            spec["tolerations"] = [
                {"key": "spot", "operator": "Exists"},
                {"operator": "Exists", "effect": "NoExecute"},
            ]
        if i % 29 == 8:
            spec["tolerations"] = [{"operator": "Exists"}]
        if i % 31 == 9:
            spec["tolerations"] = [{"key": "spot", "operator": "Bogus"}]
        if i % 17 == 4:
            spec["nodeName"] = nodes[int(rng.integers(n_nodes))]["metadata"]["name"]
        if i % 23 == 6:
            spec["nodeName"] = "ghost"
        if i % 19 == 7:
            req.update({"cpu": "500", "memory": "1Ti"})
        if i % 6 == 2:
            req["ephemeral-storage"] = f"{int(rng.integers(1, 20))}Gi"
        if i % 9 == 4:
            req["example.com/gpu"] = "1"
        if i % 8 == 3:
            spec.pop("priority", None)
            spec["priorityClassName"] = "high"
    return nodes, pods


def to_numpy(t):
    return t.cpu().numpy()


def assert_same_leaf(name, ref, got):
    ref = np.asarray(ref)
    assert got.dtype == ref.dtype, (name, got.dtype, ref.dtype)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    assert np.array_equal(got, ref), name


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("capacity", [None, (40, 130)])
def test_encoding_matches_reference(policy, seed, capacity):
    nodes, pods = port_cluster(seed)
    cfg = kp.slice_config().to_dict()
    kw = {}
    if capacity:
        kw = {"node_capacity": capacity[0], "pod_capacity": capacity[1]}
    j_pol, p_pol = POLICIES[policy]
    ref = j_encode_cluster(
        nodes, pods, JConfig.from_dict(cfg), policy=j_pol,
        priorityclasses=PRIORITY_CLASSES, **kw,
    )
    got = kp.encode_cluster(
        nodes, pods, PConfig.from_dict(cfg), policy=p_pol,
        priorityclasses=PRIORITY_CLASSES, device="cpu", **kw,
    )
    for f in dataclasses.fields(ClusterArrays):
        assert_same_leaf(f.name, getattr(ref.arrays, f.name), to_numpy(getattr(got.arrays, f.name)))
    for f in dataclasses.fields(SchedState):
        assert_same_leaf(f.name, getattr(ref.state0, f.name), to_numpy(getattr(got.state0, f.name)))
    assert_same_leaf("queue", np.asarray(ref.queue, np.int32), np.asarray(got.queue))
    assert got.node_names == ref.node_names
    assert got.pod_keys == ref.pod_keys
    assert got.resource_names == ref.resource_names
    assert got.aux["node_taints"] == ref.aux["node_taints"]
    assert (got.N, got.P, got.n_nodes, got.n_pods) == (ref.N, ref.P, ref.n_nodes, ref.n_pods)
    # the cluster really carries what the docstring promises
    assert int(got.state0.n_pods.sum()) > 0  # pre-bound pods
    assert (got.arrays.pod_node_name == -2).any()  # a missing nodeName
    assert (got.arrays.taint_effect == 1).any() and (got.arrays.tol_op == 2).any()


def test_capacity_below_live_counts_raises():
    nodes, pods = port_cluster(0, n_nodes=4, n_pods=8)
    with pytest.raises(ValueError):
        kp.encode_cluster(nodes, pods, node_capacity=2, device="cpu")
    with pytest.raises(ValueError):
        kp.encode_cluster(nodes, pods, pod_capacity=4, device="cpu")
