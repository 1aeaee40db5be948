"""The PyTorch port's plugin bodies against the reference's JAX kernels.

Each filter and score body of the slice runs on the same encoding (the
reference's, carried across with `from_reference_arrays`) at random node
states and pods made with numpy from a seed. Covered: all three
NodeResourcesFit scoring strategies (RequestedToCapacityRatio with a
negative slope, a weighted spec list naming a resource no node has),
BalancedAllocation over 2 and 3 resources under both dtype policies,
TaintToleration's default_reverse normalize with and without a zero max,
and on the relational cluster (test_torch_clusters.rel_cluster) the
NodeAffinity, NodePorts, PodTopologySpread and InterPodAffinity filters and
the NodeAffinity, ImageLocality, PodTopologySpread and InterPodAffinity
scores with both custom normalizes (an all-infeasible node set included),
at random bindings and port counters. Tolerance: exact equality (same
dtype, same values).
"""

import dataclasses

import jax
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

from test_torch_clusters import NAMESPACES, rel_cluster
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


def reference_pair(policy, cfg, seed=0, strip_prefer=False, rel=False):
    """(reference encoding, the port's encoding of the same leaves); `rel`
    takes the relational cluster."""
    nodes, pods = rel_cluster(seed) if rel else port_cluster(seed)
    if strip_prefer:
        for nd in nodes:
            nd["spec"].pop("taints", None)
    j_pol, _ = POLICIES[policy]
    ref = j_encode_cluster(nodes, pods, JConfig.from_dict(cfg), policy=j_pol,
                           namespaces=NAMESPACES)
    arrays = {f: np.asarray(getattr(ref.arrays, f)) for f in
              [f.name for f in dataclasses.fields(ref.arrays) if f.name != "rel"]}
    arrays["rel"] = {f.name: np.asarray(getattr(ref.arrays.rel, f.name))
                     for f in dataclasses.fields(ref.arrays.rel)}
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


def random_states(ref, rng, count, bind=False, aux_seed=17):
    """Node states as (reference SchedState, port SchedState) pairs: usage
    up to 130% of capacity, pod counts around the 110-pod limit, port
    counters of 0..2 users. `bind`: besides the pre-bound pods, about 70%
    of the others are bound, mostly to the first third of the nodes (so
    topology counts are skewed)."""
    alloc = np.asarray(ref.arrays.node_alloc)
    dt = alloc.dtype
    N = alloc.shape[0]
    # ports and bindings come from their own generator, so rng's draws stay
    # those the fit-path tests were written against
    aux = np.random.default_rng(aux_seed)
    for _ in range(count):
        frac = rng.uniform(0.0, 1.3, size=alloc.shape)
        req = np.floor(alloc * frac).astype(dt)
        sreq = np.floor(alloc * rng.uniform(0.0, 1.3, size=alloc.shape)).astype(dt)
        n_pods = rng.integers(0, 112, size=N).astype(np.int32)
        ports = {k: aux.integers(0, 3, size=np.asarray(getattr(ref.state0, k)).shape)
                 .astype(np.int32) * (aux.random() < 0.7)
                 for k in ("used_pair", "used_wild", "used_trip")}
        assignment = np.asarray(ref.state0.assignment).copy()
        if bind:
            free = (assignment < 0) & (aux.random(assignment.shape) < 0.7)
            free[ref.n_pods:] = False
            hi = np.where(aux.random(int(free.sum())) < 0.8, max(1, ref.n_nodes // 3),
                          ref.n_nodes)
            assignment[free] = aux.integers(0, hi)
        j_state = ref.state0.replace(
            requested=jnp.asarray(req), s_requested=jnp.asarray(sreq),
            n_pods=jnp.asarray(n_pods), assignment=jnp.asarray(assignment),
            **{k: jnp.asarray(v) for k, v in ports.items()},
        )
        p_state = SchedState(
            requested=torch.as_tensor(req), s_requested=torch.as_tensor(sreq),
            n_pods=torch.as_tensor(n_pods),
            assignment=torch.tensor(assignment),
            **{k: torch.as_tensor(v) for k, v in ports.items()},
            **{k: torch.tensor(np.asarray(getattr(ref.state0, k)))
               for k in ("used_claims", "node_disk_any", "node_disk_rw", "node_vol3")},
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


REL_FILTERS = ("NodeAffinity", "NodePorts", "PodTopologySpread", "InterPodAffinity")
REL_SCORES = ("NodeAffinity", "ImageLocality", "PodTopologySpread", "InterPodAffinity")


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("seed", [1, 2])
def test_relational_bodies_match_reference(policy, seed):
    """The slice's new filter and score bodies, and both custom normalizes,
    at random bindings, port counters and feasible sets (all-infeasible and
    all-feasible included)."""
    ref, got = reference_pair(policy, kp.affinity_config().to_dict(), seed=seed, rel=True)
    rng = np.random.default_rng(seed)
    filters = [(n, jax.jit(JK.FILTER_KERNELS[n][0](ref)), PK.FILTER_KERNELS[n][0](got))
               for n in REL_FILTERS]
    scores = []
    for n in REL_SCORES:
        jk = JK.SCORE_KERNELS[n][0](ref)
        norm = getattr(jk, "_normalize", None)
        scores.append((n, jax.jit(jk), norm and jax.jit(norm), PK.SCORE_KERNELS[n][0](got)))
    N = got.N
    rel = got.arrays.rel
    # pods with hard spread constraints, inter-pod terms, node affinity and
    # host ports first, then any
    picks = torch.nonzero((rel.sph_key >= 0).any(dim=1))[:3, 0].tolist()
    picks += [int(torch.nonzero(m)[0]) for m in (
        (rel.ia_key >= 0).any(dim=1), (rel.ian_key >= 0).sum(dim=1) > 1,
        (rel.ipan_key >= 0).any(dim=1), got.arrays.pod_has_raff,
        (got.arrays.want_trip > 0).any(dim=1), (rel.sps_key >= 0).all(dim=1))]
    seen = {n: set() for n in REL_FILTERS}
    for j_state, p_state in random_states(ref, rng, 3, bind=True, aux_seed=seed):
        pods = picks + rng.choice(ref.n_pods, size=3, replace=False).tolist()
        for p in pods:
            for name, jk, pk in filters:
                want = jk(ref.arrays, j_state, p)
                assert_equal((name, p), want, pk(got.arrays, p_state, p))
                seen[name] |= set(np.asarray(want).tolist())
            node_mask = np.asarray(ref.arrays.node_mask)
            for feas in (rng.random(N) < 0.6, np.zeros(N, bool), np.ones(N, bool)):
                feas = feas & node_mask
                jf, pf = jnp.asarray(feas), torch.as_tensor(feas)
                for name, jk, jnorm, pk in scores:
                    raw_j = jk(ref.arrays, j_state, p, jf)
                    raw_p = pk(got.arrays, p_state, p, pf)
                    assert_equal((name, p, "raw"), raw_j, raw_p)
                    if jnorm is not None:
                        assert_equal((name, p, "normalize"),
                                     jnorm(ref.arrays, j_state, p, raw_j, jf),
                                     pk._normalize(got.arrays, p_state, p, raw_p, pf))
    # every failure code of the four filters was reached
    assert seen == {"NodeAffinity": {0, 1}, "NodePorts": {0, 1},
                    "PodTopologySpread": {0, 1, 2}, "InterPodAffinity": {0, 1, 2, 3}}


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_custom_normalizes_with_no_feasible_node(policy):
    """The interpod normalize's sentinels meet when no node is feasible:
    int32 max minus int32 min wraps to 2 under TPU32, so every node gets
    100 * (raw - BIG) // 2 (floored, wrapped), and 0 under EXACT."""
    ref, got = reference_pair(policy, kp.affinity_config().to_dict(), seed=2, rel=True)
    jk = JK.SCORE_KERNELS["InterPodAffinity"][0](ref)
    pk = PK.SCORE_KERNELS["InterPodAffinity"][0](got)
    none = np.zeros(got.N, bool)
    raw = torch.arange(-3, got.N - 3, dtype=got.policy.score)
    want = jk._normalize(ref.arrays, ref.state0, 0, jnp.asarray(raw.numpy()), jnp.asarray(none))
    have = pk._normalize(got.arrays, got.state0, 0, raw, torch.as_tensor(none))
    assert_equal("interpod normalize", want, have)
    assert bool((have != 0).any()) == (policy == "i32")


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_slice_attempt_matches_reference(policy):
    """attempt_fn under affinity_config(): every filter, score and normalize
    of the default profile without volumes and preemption, at random
    bindings."""
    ref, got = reference_pair(policy, kp.affinity_config().to_dict(), seed=3, rel=True)
    j_eng = JBatchedScheduler(ref)
    p_eng = kp.BatchedScheduler(got, device="cpu")
    rng = np.random.default_rng(5)
    for j_state, p_state in random_states(ref, rng, 2, bind=True):
        for p in rng.choice(ref.n_pods, size=4, replace=False).tolist():
            want = j_eng.attempt_fn(ref.arrays, j_state, j_eng.weights, p)
            have = p_eng.attempt_fn(got.arrays, p_state, p_eng.weights, p)
            for name, w, h in zip(("pf_codes", "codes", "raw", "final", "sel"), want, have):
                assert_equal((name, p), w, h)
