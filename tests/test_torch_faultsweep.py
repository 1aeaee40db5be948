"""The port's FaultSweep against the reference's (lifecycle/faultsweep.py).

The same cluster and the same [S, N] failure masks go through the JAX
package's `FaultSweep` (on the CPU, as its own tests run it) and the port's
(plain versions, CPU). Compared: the baseline state field by field, the
whole disruption profile (assignments, evicted, rescheduled, stranded,
rounds, totals, failedNodes, worstScenario) and the decoded placements of
every scenario; the port's `run_one` against its own `run`. The masks are
compared bit for bit with `jax.random.bernoulli`, with `jax_enable_x64` off
and on. Cases: every case of tests/test_faultsweep.py, rebuilt; a
default-profile cluster with an inline disk, a ReadWriteOncePod claim and a
zone spread constraint whose lone-node zone leaves the spread domains when
its node fails; an affinity-profile cluster. Tolerance: exact equality.

Each reference sweep is built once per cluster (module fixtures) and every
sweep of one cluster has the same scenario count, so each cluster compiles
the reference's vmapped program once.
"""

import jax
import numpy as np
import pytest
import torch

from kube_scheduler_simulator_tpu.engine import encode_cluster as j_encode_cluster
from kube_scheduler_simulator_tpu.lifecycle.faultsweep import FaultSweep as JFaultSweep
from kube_scheduler_simulator_tpu.sched.config import SchedulerConfiguration as JConfig

import kube_scheduler_simulator_tpu_torch as kp
from kube_scheduler_simulator_tpu_torch.engine.encode import SchedState
from kube_scheduler_simulator_tpu_torch.lifecycle import FaultSweep
from kube_scheduler_simulator_tpu_torch.sched.config import SchedulerConfiguration as PConfig
from kube_scheduler_simulator_tpu_torch.utils import prng

from helpers import node, pod
from test_engine_parity import restricted_config
from test_torch_cuda import fault_cluster

S = 8  # scenarios a sweep: one reference compile a cluster

# (seed, S, N, p): the key's high word, seed 0, odd S*N, p at both ends, a
# numpy float32 p (a float32 draw under x64 too)
MASK_CASES = [(7, 4, 10, 0.05), (0, 3, 5, 0.5), (2**32 + 5, 16, 9, 0.3), (42, 3, 7, 0.0),
              (5, 5, 3, 1.0), (11, 256, 33, 0.05), (9, 3, 3, np.float32(0.3))]


@pytest.mark.parametrize("x64", [False, True], ids=["x32", "x64"])
@pytest.mark.parametrize("seed,n,width,p", MASK_CASES)
def test_masks_bit_equal_to_jax(seed, n, width, p, x64):
    before = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", x64)
    try:
        want = np.asarray(jax.random.bernoulli(jax.random.PRNGKey(seed), p, (n, width)))
    finally:
        jax.config.update("jax_enable_x64", before)
    got = prng.bernoulli(seed, p, (n, width), x64=x64)
    assert got.dtype == np.bool_ and np.array_equal(got, want)


# -- clusters ------------------------------------------------------------------


def basic():
    """tests/test_faultsweep.py's: 4 nodes of 8 CPUs, 10 bound pods, 2 pending."""
    nodes = [node(f"n{i}", cpu="8") for i in range(4)]
    pods = ([pod(f"b{i}", cpu="1", node_name=f"n{i % 4}") for i in range(10)]
            + [pod(f"q{i}", cpu="1") for i in range(2)])
    return nodes, pods, {}


def full():
    """Two nodes exactly full: failing n1 strands its pod."""
    nodes = [node("n0", cpu="2"), node("n1", cpu="2")]
    pods = [pod("a0", cpu="2", node_name="n0"), pod("a1", cpu="2", node_name="n1")]
    return nodes, pods, {}


def affinity():
    """`synthetic_affinity_cluster(10, 30)` under the affinity profile, its
    first 20 pods bound where the port's gang pass placed them."""
    nodes, pods = kp.synthetic_affinity_cluster(10, 30, seed=3)
    enc = kp.encode_cluster(nodes, pods, kp.affinity_config(), device="cpu")
    placed = enc.decode_assignment(kp.GangScheduler(enc, device="cpu").run()[0].assignment)
    out = []
    for i, p in enumerate(pods):
        key = (p["metadata"].get("namespace", "default"), p["metadata"]["name"])
        if i < 20 and placed.get(key):
            p = {**p, "spec": {**p["spec"], "nodeName": placed[key]}}
        out.append(p)
    return nodes, out, {}


CLUSTERS = {
    "basic": (basic, restricted_config),
    "full": (full, restricted_config),
    "spread": (fault_cluster, kp.supported_config),
    "affinity": (affinity, kp.affinity_config),
}


class Pair:
    """One cluster's reference and port sweeps."""

    def __init__(self, name):
        make, config = CLUSTERS[name]
        self.nodes, self.pods, self.objects = make()
        cfg = config().to_dict()
        self.ref = JFaultSweep.from_cluster(self.nodes, self.pods, JConfig.from_dict(cfg),
                                            **self.objects)
        self.port = FaultSweep.from_cluster(self.nodes, self.pods, PConfig.from_dict(cfg),
                                            device="cpu", **self.objects)

    def masks(self, seed, p):
        """The reference's masks (this suite runs JAX with x64), and the
        port's same draw."""
        want = np.array(self.ref.sample_masks(S, seed=seed, fail_prob=p))
        got = self.port.sample_masks(S, seed=seed, fail_prob=p, x64=True)
        assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)
        return want

    def run(self, masks):
        """Both sweeps over the masks: profiles, baseline and placements
        equal. Returns the port's profile."""
        want = self.ref.run(masks)
        got = self.port.run(masks)
        assert got.keys() == want.keys()
        for k in want:
            if k == "assignments":
                assert got[k].dtype == np.int32
                np.testing.assert_array_equal(got[k], np.asarray(want[k]))
            else:
                assert got[k] == want[k], k
        for f in SchedState.__dataclass_fields__:
            np.testing.assert_array_equal(getattr(self.port._state_bound, f).numpy(),
                                          np.asarray(getattr(self.ref._state_bound, f)), f)
        assert self.port.placements(got["assignments"]) == self.ref.placements(
            want["assignments"])
        return got

    def check_run_one(self, masks, profile, scenarios):
        """The port's S = 1 form equals its rows of `run`."""
        for s in scenarios:
            a, ev, re, st, rounds = self.port.run_one(masks[s])
            np.testing.assert_array_equal(a.numpy(), profile["assignments"][s])
            assert [int(ev), int(re), int(st), int(rounds)] == [
                profile[k][s] for k in ("evicted", "rescheduled", "stranded", "rounds")], s


@pytest.fixture(scope="module")
def basic_pair():
    return Pair("basic")


@pytest.fixture(scope="module")
def spread_pair():
    return Pair("spread")


@pytest.fixture(scope="module")
def affinity_pair():
    return Pair("affinity")


# -- the cases of tests/test_faultsweep.py ---------------------------------------


def test_vmapped_matches_sequential(basic_pair):
    masks = basic_pair.masks(42, 0.3)
    profile = basic_pair.run(masks)
    assert profile["scenarios"] == S
    basic_pair.check_run_one(masks, profile, range(S))


def test_failed_nodes_take_no_pods_and_eviction_counts(basic_pair):
    masks = basic_pair.masks(7, 0.4)
    profile = basic_pair.run(masks)
    baseline = basic_pair.port._state_bound.assignment.numpy()
    for s in range(S):
        failed = np.nonzero(masks[s])[0]
        a = profile["assignments"][s]
        assert not np.isin(a[a >= 0], failed).any(), s
        assert profile["evicted"][s] == int(np.isin(baseline[baseline >= 0], failed).sum()), s
        assert profile["rescheduled"][s] + profile["stranded"][s] == profile["evicted"][s], s


def test_no_failures_is_a_no_op_for_bound_pods(basic_pair):
    masks = basic_pair.masks(1, 0.0)
    profile = basic_pair.run(masks)
    assert profile["totals"]["evicted"] == 0
    baseline = basic_pair.port._state_bound.assignment.numpy()
    keep = baseline >= 0
    for s in range(S):
        a = profile["assignments"][s]
        np.testing.assert_array_equal(a[keep], baseline[keep])
        assert (a >= 0).sum() >= keep.sum()  # the two queued pods placed too
    assert profile["rounds"] == [2] * S  # one round commits them, one finds nothing


def test_stranded_when_capacity_lost():
    pair = Pair("full")
    mask = np.zeros((1, pair.port.enc.N), bool)
    mask[0, pair.port.enc.node_names.index("n1")] = True
    profile = pair.run(mask)
    assert profile["evicted"] == [1] and profile["stranded"] == [1]
    assert profile["worstScenario"] == 0
    (placements,) = pair.port.placements(profile["assignments"])
    assert placements[("default", "a1")] == "" and placements[("default", "a0")] == "n0"
    pair.check_run_one(mask, profile, [0])


def test_masks_deterministic_and_validated():
    """Deterministic in (seed, S, p), equal to the reference's, and only
    real nodes fail: three nodes padded to five."""
    nodes, pods, _ = basic()
    nodes, pods = nodes[:3], [pod(f"b{i}", cpu="1") for i in range(3)]
    cfg = restricted_config().to_dict()
    ref = JFaultSweep(j_encode_cluster(nodes, pods, JConfig.from_dict(cfg), node_capacity=5))
    port = FaultSweep(kp.encode_cluster(nodes, pods, PConfig.from_dict(cfg), node_capacity=5,
                                        device="cpu"), device="cpu")
    for seed, p in ((5, 0.5), (2**32 + 5, 1.0)):
        m1 = port.sample_masks(16, seed=seed, fail_prob=p, x64=True).numpy()
        m2 = port.sample_masks(16, seed=seed, fail_prob=p, x64=True).numpy()
        assert np.array_equal(m1, m2) and m1.shape == (16, 5)
        assert np.array_equal(m1, np.asarray(ref.sample_masks(16, seed=seed, fail_prob=p)))
        assert not m1[:, 3:].any()
    assert port.sample_masks(16, seed=5, fail_prob=1.0).numpy()[:, :3].all()
    np.testing.assert_array_equal(
        port.sample_masks(4, seed=5, fail_prob=0.5).numpy(),
        prng.bernoulli(5, 0.5, (4, 5)) & np.array([True] * 3 + [False] * 2))
    for sweep in (ref, port):
        with pytest.raises(ValueError, match="fail_prob"):
            sweep.sample_masks(4, seed=0, fail_prob=1.5)
        with pytest.raises(ValueError, match="n_scenarios"):
            sweep.sample_masks(0, seed=0, fail_prob=0.5)
        with pytest.raises(ValueError, match="masks must be"):
            sweep.run(np.zeros((2, 6), bool))


def test_unknown_baseline_node_rejected():
    nodes, pods = [node("n0")], [pod("a0", cpu="1", node_name="ghost")]
    cfg = restricted_config().to_dict()
    with pytest.raises(ValueError, match="unknown node"):
        JFaultSweep.from_cluster(nodes, pods, JConfig.from_dict(cfg))
    with pytest.raises(ValueError, match="unknown node"):
        FaultSweep.from_cluster(nodes, pods, PConfig.from_dict(cfg), device="cpu")


def test_mesh_and_static_loop_are_not_ported():
    """In place of the reference's sharded case: a mesh raises
    NotImplementedError. (The counted loop is ported:
    tests/test_torch_gang_static.py.)"""
    nodes, pods, _ = basic()
    cfg = PConfig.from_dict(restricted_config().to_dict())
    with pytest.raises(NotImplementedError, match="mesh"):
        FaultSweep.from_cluster(nodes, pods, cfg, device="cpu", mesh=object())
    sweep = FaultSweep.from_cluster(nodes, pods, cfg, device="cpu", loop="static")
    assert sweep.gang.loop == "static"


# -- beyond the reference's tests --------------------------------------------------


def test_default_profile_spread_domain_and_claims(spread_pair):
    """Five sampled scenarios and three built by hand: none failed, n7 alone
    (zone d leaves the spread domains; `db` leaves with its claim and disk)
    and n0 with n7."""
    enc = spread_pair.port.enc
    n7 = enc.node_names.index("n7")
    masks = spread_pair.masks(3, 0.25)
    masks[5:] = False
    masks[6:, n7] = True
    masks[7, 0] = True
    profile = spread_pair.run(masks)
    spread_pair.check_run_one(masks, profile, [6, profile["worstScenario"]])
    node_of = [spread_pair.port.placements(profile["assignments"][s:s + 1])[0]
               for s in range(S)]
    for s in range(S):
        # db takes its claim again wherever it lands; db2 never gets it
        assert node_of[s][("default", "db")] and not node_of[s][("default", "db2")], s
    spread = [("default", f"web-{i}") for i in range(8, 12)]
    assert node_of[5][spread[0]] == "n7"  # zone d holds the spread minimum
    assert profile["evicted"][6] == profile["rescheduled"][6] == 2
    zone = {f"n{i}": z for i, z in enumerate("aaabbccd")}
    assert {zone[node_of[6][k]] for k in spread} == {"b", "c"}  # without d: b and c


def test_affinity_profile_sweep(affinity_pair):
    masks = affinity_pair.masks(4, 0.3)
    profile = affinity_pair.run(masks)
    assert profile["totals"]["evicted"] > 0
    affinity_pair.check_run_one(masks, profile, [0, profile["worstScenario"]])
