"""The PyTorch port's plugin bodies against the reference's JAX kernels.

Each filter and score body of the slice runs on the same encoding (the
reference's, carried across with `from_reference_arrays`) at random node
states and pods made with numpy from a seed. Covered: all three
NodeResourcesFit scoring strategies (RequestedToCapacityRatio with a
negative slope, a weighted spec list naming a resource no node has),
BalancedAllocation over 2 and 3 resources under both dtype policies, and
TaintToleration's default_reverse normalize with and without a zero max.
Tolerance: exact equality (same dtype, same values).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_scheduler_simulator_tpu.engine import BatchedScheduler as JBatchedScheduler
from kube_scheduler_simulator_tpu.engine import encode_cluster as j_encode_cluster
from kube_scheduler_simulator_tpu.engine import kernels as JK
from kube_scheduler_simulator_tpu.sched.config import SchedulerConfiguration as JConfig
from kube_scheduler_simulator_tpu.sched.oracle_plugins import broken_linear

import kube_scheduler_simulator_tpu_torch as kp
from kube_scheduler_simulator_tpu_torch.engine import kernels as PK
from kube_scheduler_simulator_tpu_torch.engine.encode import SchedState

from test_torch_encode import POLICIES, port_cluster

FILTERS = ("NodeUnschedulable", "NodeName", "TaintToleration", "NodeResourcesFit")
SCORES = ("NodeResourcesFit", "NodeResourcesBalancedAllocation", "TaintToleration")

FIT_STRATEGIES = {
    "least": {"type": "LeastAllocated"},
    "most": {
        "type": "MostAllocated",
        "resources": [
            {"name": "cpu", "weight": 2},
            {"name": "memory", "weight": 1},
            {"name": "example.com/absent", "weight": 3},
        ],
    },
    "rtcr": {
        "type": "RequestedToCapacityRatio",
        "resources": [
            {"name": "cpu", "weight": 1},
            {"name": "memory", "weight": 2},
            {"name": "ephemeral-storage", "weight": 1},
        ],
        # a falling shape: negative slopes exercise the truncating division
        "requestedToCapacityRatio": {
            "shape": [
                {"utilization": 0, "score": 10},
                {"utilization": 40, "score": 7},
                {"utilization": 100, "score": 0},
            ]
        },
    },
}
BALANCED = {
    2: [{"name": "cpu", "weight": 1}, {"name": "memory", "weight": 1}],
    3: [
        {"name": "cpu", "weight": 1},
        {"name": "memory", "weight": 1},
        {"name": "ephemeral-storage", "weight": 1},
    ],
}


def config_dict(fit="least", balanced=2):
    star = [{"name": "*"}]
    plugins = {
        "preFilter": {"disabled": star, "enabled": [{"name": "NodeResourcesFit"}]},
        "filter": {"disabled": star, "enabled": [{"name": n} for n in FILTERS]},
        "postFilter": {"disabled": star, "enabled": []},
        "preScore": {"disabled": star, "enabled": [{"name": "TaintToleration"}]},
        "score": {"disabled": star, "enabled": [{"name": n, "weight": 2} for n in SCORES]},
    }
    return {
        "profiles": [
            {
                "schedulerName": "default-scheduler",
                "plugins": plugins,
                "pluginConfig": [
                    {"name": "NodeResourcesFit",
                     "args": {"scoringStrategy": FIT_STRATEGIES[fit]}},
                    {"name": "NodeResourcesBalancedAllocation",
                     "args": {"resources": BALANCED[balanced]}},
                ],
            }
        ]
    }


def reference_pair(policy, cfg, seed=0, strip_prefer=False):
    """(reference encoding, the port's encoding of the same leaves)."""
    nodes, pods = port_cluster(seed)
    if strip_prefer:
        for nd in nodes:
            nd["spec"].pop("taints", None)
    j_pol, _ = POLICIES[policy]
    ref = j_encode_cluster(nodes, pods, JConfig.from_dict(cfg), policy=j_pol)
    arrays = {f: np.asarray(getattr(ref.arrays, f)) for f in
              [f.name for f in dataclasses.fields(ref.arrays) if f.name != "rel"]}
    state = {f: np.asarray(getattr(ref.state0, f)) for f in
             [f.name for f in dataclasses.fields(ref.state0)]}
    meta = {
        "node_names": ref.node_names,
        "pod_keys": ref.pod_keys,
        "resource_names": ref.resource_names,
        "policy": ref.policy.name,
        "config": ref.config.to_dict(),
        "node_taints": ref.aux["node_taints"],
    }
    got = kp.from_reference_arrays(arrays, state, ref.queue, meta, device="cpu")
    return ref, got


def random_states(ref, rng, count):
    """Node states as (reference SchedState, port SchedState) pairs: usage
    up to 130% of capacity, pod counts around the 110-pod limit."""
    alloc = np.asarray(ref.arrays.node_alloc)
    dt = alloc.dtype
    for _ in range(count):
        frac = rng.uniform(0.0, 1.3, size=alloc.shape)
        req = np.floor(alloc * frac).astype(dt)
        sreq = np.floor(alloc * rng.uniform(0.0, 1.3, size=alloc.shape)).astype(dt)
        n_pods = rng.integers(0, 112, size=alloc.shape[0]).astype(np.int32)
        j_state = ref.state0.replace(
            requested=jnp.asarray(req), s_requested=jnp.asarray(sreq),
            n_pods=jnp.asarray(n_pods),
        )
        p_state = SchedState(
            requested=torch.as_tensor(req), s_requested=torch.as_tensor(sreq),
            n_pods=torch.as_tensor(n_pods),
            assignment=torch.tensor(np.asarray(ref.state0.assignment)),
            bound_seq=torch.tensor(np.asarray(ref.state0.bound_seq)),
        )
        yield j_state, p_state


def assert_equal(name, ref, got):
    ref = np.asarray(ref)
    got = got.cpu().numpy()
    assert got.dtype == ref.dtype, (name, got.dtype, ref.dtype)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    assert np.array_equal(got, ref), (name, np.argwhere(got != ref)[:5])


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize(
    "fit,balanced", [("least", 2), ("most", 3), ("rtcr", 3), ("rtcr", 2)]
)
def test_plugin_bodies_match_reference(policy, fit, balanced):
    ref, got = reference_pair(policy, config_dict(fit, balanced), seed=1)
    rng = np.random.default_rng(7)
    pods = rng.choice(ref.n_pods, size=4, replace=False).tolist()
    bodies = [(n, JK.FILTER_KERNELS[n][0](ref), PK.FILTER_KERNELS[n][0](got)) for n in FILTERS]
    bodies += [(n, JK.SCORE_KERNELS[n][0](ref), PK.SCORE_KERNELS[n][0](got)) for n in SCORES]
    hit_over = False
    for j_state, p_state in random_states(ref, rng, 2):
        for p in pods:
            for name, jk, pk in bodies:
                assert_equal((name, p), jk(ref.arrays, j_state, p), pk(got.arrays, p_state, p))
            sreq = np.asarray(j_state.s_requested) + np.asarray(ref.arrays.pod_sreq)[p]
            hit_over |= bool((sreq > np.asarray(ref.arrays.node_alloc)).any())
    assert hit_over  # the over-capacity masks were exercised


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_broken_linear_negative_slope(policy):
    ref, got = reference_pair(policy, config_dict("rtcr", 2))
    shape = PK.fit_score_args(got)[3]
    assert any(y2 < y1 for (_, y1), (_, y2) in zip(shape, shape[1:]))
    # the reference builds its vector form inside build_fit_score; hold the
    # port's against the reference oracle's scalar form at every utilization
    u = torch.arange(-5, 130, dtype=got.policy.score)
    ys = PK.broken_linear_vec(shape, u)
    assert [int(y) for y in ys] == [broken_linear(shape, int(x)) for x in u]


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("strip_prefer", [False, True], ids=["max>0", "max==0"])
def test_attempt_normalize_matches_reference(policy, strip_prefer):
    cfg = config_dict("least", 2)
    ref, got = reference_pair(policy, cfg, seed=2, strip_prefer=strip_prefer)
    j_eng = JBatchedScheduler(ref)
    p_eng = kp.BatchedScheduler(got, device="cpu")
    rng = np.random.default_rng(11)
    taint_j = list(SCORES).index("TaintToleration")
    maxes = set()
    for j_state, p_state in random_states(ref, rng, 2):
        for p in rng.choice(ref.n_pods, size=5, replace=False).tolist():
            want = j_eng.attempt_fn(ref.arrays, j_state, j_eng.weights, p)
            have = p_eng.attempt_fn(got.arrays, p_state, p_eng.weights, p)
            for name, w, h in zip(("pf_codes", "codes", "raw", "final", "sel"), want, have):
                assert_equal((name, p), w, h)
            assert bool(want[5]) == bool(have[5])
            feasible = (np.asarray(want[1]) == 0).all(axis=1) & np.asarray(ref.arrays.node_mask)
            if feasible.any():
                maxes.add(int(np.asarray(want[2])[feasible, taint_j].max()) > 0)
    # the branch of default_reverse this case is for was taken (with
    # PreferNoSchedule taints some pods still tolerate them all)
    if strip_prefer:
        assert maxes == {False}
    else:
        assert True in maxes
