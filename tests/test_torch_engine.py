"""The PyTorch port's sequential pass against the reference engine.

`BatchedScheduler(..., device="cpu").run()` (the plain PyTorch versions of
the kernels) and the reference's JAX `BatchedScheduler.run()` run the same
clusters under the same configurations — the first slice's plugin set
(`fit_config()`), the default profile without volumes and preemption
(`affinity_config()`) and the reference tests' restricted set; placements,
every trace tensor of TRACE_SLOTS_PLAIN (bucket-padding rows included), the
final state and every pod's `to_annotations()` must be equal. Tolerance:
exact equality.
"""

import dataclasses

import numpy as np
import pytest

from kube_scheduler_simulator_tpu.engine import BatchedScheduler as JBatchedScheduler
from kube_scheduler_simulator_tpu.engine import encode_cluster as j_encode_cluster
from kube_scheduler_simulator_tpu.sched.config import SchedulerConfiguration as JConfig

import kube_scheduler_simulator_tpu_torch as kp
from kube_scheduler_simulator_tpu_torch.engine import cuda
from kube_scheduler_simulator_tpu_torch.engine.encode import SchedState
from kube_scheduler_simulator_tpu_torch.engine.engine import (
    TRACE_SLOTS_PLAIN,
    UnsupportedPluginError,
)
from kube_scheduler_simulator_tpu_torch.sched.config import SchedulerConfiguration as PConfig

from test_engine_parity import restricted_config
from test_torch_clusters import NAMESPACES, rel_cluster
from test_torch_encode import POLICIES, port_cluster
from test_torch_kernels import reference_pair

CONFIGS = {
    "fit": lambda: kp.fit_config().to_dict(),
    "slice": lambda: kp.affinity_config().to_dict(),
    "restricted": lambda: restricted_config().to_dict(),
}
PORT_CONFIGS = ("fit", "slice")


def assert_same(name, ref, got):
    ref = np.asarray(ref)
    got = got.cpu().numpy()
    assert got.dtype == ref.dtype, (name, got.dtype, ref.dtype)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    assert np.array_equal(got, ref), (name, np.argwhere(got != ref)[:5])


def assert_engines_agree(j_eng, p_eng):
    j_state, j_trace = j_eng.run()
    p_state, p_trace = p_eng.run()
    assert len(j_trace) == len(p_trace) == len(TRACE_SLOTS_PLAIN)
    for name, w, h in zip(TRACE_SLOTS_PLAIN, j_trace, p_trace):
        assert_same(name, w, h)
    for f in dataclasses.fields(SchedState):
        assert_same(f.name, getattr(j_state, f.name), getattr(p_state, f.name))
    assert p_eng.placements() == j_eng.placements()
    want, got = j_eng.results(), p_eng.results()
    assert [(r.pod_namespace, r.pod_name) for r in got] == [
        (r.pod_namespace, r.pod_name) for r in want
    ]
    for w, g in zip(want, got):
        assert g.status == w.status, (w.pod_name, g.status, w.status)
        assert g.to_annotations() == w.to_annotations(), w.pod_name
    return want


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("seed", [0, 5])
def test_sequential_pass_matches_reference(config, policy, seed):
    nodes, pods = port_cluster(seed)
    cfg = CONFIGS[config]()
    j_pol, p_pol = POLICIES[policy]
    # padded capacities: masked node rows, and a pending queue short of its
    # bucket so the pass runs padding steps
    kw = {"node_capacity": 32, "pod_capacity": 128}
    j_eng = JBatchedScheduler(j_encode_cluster(nodes, pods, JConfig.from_dict(cfg),
                                               policy=j_pol, **kw))
    p_enc = kp.encode_cluster(nodes, pods, PConfig.from_dict(cfg), policy=p_pol,
                              device="cpu", **kw)
    p_eng = kp.BatchedScheduler(p_enc, device="cpu")
    assert p_eng.queue_bucket(len(p_enc.queue)) > len(p_enc.queue)
    results = assert_engines_agree(j_eng, p_eng)
    statuses = {r.status for r in results}
    assert statuses == {"Scheduled", "Unschedulable"}


@pytest.mark.parametrize("config", PORT_CONFIGS)
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_pass_on_reference_arrays(policy, config):
    """The port's engine on the very tensors the reference engine ran on,
    so an engine fault is told apart from an encoder fault."""
    ref, got = reference_pair(policy, CONFIGS[config](), seed=4, rel=config == "slice")
    assert_engines_agree(JBatchedScheduler(ref), kp.BatchedScheduler(got, device="cpu"))


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("seed", [1, 2])
def test_relational_pass_matches_reference(policy, seed):
    """The default profile without volumes and preemption on the dressed
    relational cluster: every filter code and both custom normalizes."""
    nodes, pods = rel_cluster(seed)
    cfg = kp.affinity_config().to_dict()
    j_pol, p_pol = POLICIES[policy]
    kw = {"node_capacity": 28, "namespaces": NAMESPACES}
    j_eng = JBatchedScheduler(j_encode_cluster(nodes, pods, JConfig.from_dict(cfg),
                                               policy=j_pol, **kw))
    p_eng = kp.BatchedScheduler(
        kp.encode_cluster(nodes, pods, PConfig.from_dict(cfg), policy=p_pol, device="cpu", **kw),
        device="cpu",
    )
    results = assert_engines_agree(j_eng, p_eng)
    codes = p_eng.run()[1][1][: len(p_eng.enc.queue)]
    # NodeAffinity, NodePorts, PodTopologySpread and InterPodAffinity all fail somewhere
    assert [sorted(set(codes[:, :, f].flatten().tolist())) for f in (3, 4, 6, 7)] == [
        [0, 1], [0, 1], [0, 1, 2], [0, 1, 2, 3]]
    assert {r.status for r in results} == {"Scheduled", "Unschedulable"}


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_affinity_cluster_matches_reference(policy):
    """BASELINE config #3's workload (anti-affinity chains and zone
    co-location chains), cut to 8 nodes × 120 pods: more replicas than
    nodes, so some replicas find no node."""
    nodes, pods = kp.synthetic_affinity_cluster(8, 120, seed=11)
    cfg = kp.affinity_config().to_dict()
    j_pol, p_pol = POLICIES[policy]
    j_eng = JBatchedScheduler(j_encode_cluster(nodes, pods, JConfig.from_dict(cfg), policy=j_pol))
    p_eng = kp.BatchedScheduler(
        kp.encode_cluster(nodes, pods, PConfig.from_dict(cfg), policy=p_pol, device="cpu"),
        device="cpu",
    )
    results = assert_engines_agree(j_eng, p_eng)
    assert {r.status for r in results} == {"Scheduled", "Unschedulable"}


@pytest.mark.parametrize("config", PORT_CONFIGS)
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_empty_queue(policy, config):
    """Every pod pre-bound: a zero-length pass with empty trace tensors."""
    nodes, pods = port_cluster(2, n_nodes=6, n_pods=10)
    for i, pd in enumerate(pods):
        pd["spec"]["nodeName"] = nodes[i % len(nodes)]["metadata"]["name"]
    cfg = CONFIGS[config]()
    j_pol, p_pol = POLICIES[policy]
    j_eng = JBatchedScheduler(j_encode_cluster(nodes, pods, JConfig.from_dict(cfg), policy=j_pol))
    p_eng = kp.BatchedScheduler(
        kp.encode_cluster(nodes, pods, PConfig.from_dict(cfg), policy=p_pol, device="cpu"),
        device="cpu",
    )
    assert assert_engines_agree(j_eng, p_eng) == []


@pytest.mark.parametrize("config", PORT_CONFIGS)
def test_single_pod_step_matches_the_pass(config):
    """attempt_bind_fn walked over the queue reproduces run()'s trace rows
    and final state (the per-pod path the extender loop drives)."""
    nodes, pods = (rel_cluster(1, 12, 40) if config == "slice"
                   else port_cluster(1, n_nodes=12, n_pods=40))
    cfg = PConfig.from_dict(CONFIGS[config]())
    eng = kp.BatchedScheduler(
        kp.encode_cluster(nodes, pods, cfg, namespaces=NAMESPACES, device="cpu"), device="cpu"
    )
    state, trace = eng.run()
    step_state = eng.enc.state0.clone()
    for qi, p in enumerate(eng.enc.queue):
        _, codes, raw, final, sel, _, step_state = eng.attempt_bind_fn(
            eng.enc.arrays, step_state, eng.weights, int(p), qi
        )
        for name, row, got in zip(TRACE_SLOTS_PLAIN[1:], trace[1:], (codes, raw, final, sel)):
            assert_same((name, qi), row[qi].numpy(), got)
    for f in dataclasses.fields(SchedState):
        assert_same(f.name, getattr(state, f.name).numpy(), getattr(step_state, f.name))


def test_schedule_entry_point():
    nodes, pods = port_cluster(3, n_nodes=10, n_pods=30)
    cuda.reset_counts()
    placements, results = kp.schedule(nodes, pods, device="cpu")
    assert cuda.PLAIN_CALLS["seq_run"] == 1 and cuda.LAUNCHES["seq_run"] == 0
    eng = kp.BatchedScheduler(
        kp.encode_cluster(nodes, pods, kp.supported_config(), device="cpu"), device="cpu"
    )
    assert placements == eng.placements()
    want = {(r.pod_namespace, r.pod_name): r.to_annotations() for r in eng.results()}
    assert {(r.pod_namespace, r.pod_name): r.to_annotations() for r in results} == want
    some = set(list(want)[:3])
    _, sub = kp.schedule(nodes, pods, device="cpu", decode=some)
    assert {(r.pod_namespace, r.pod_name) for r in sub} == some


def test_strict_mode_refuses_plugins_outside_the_slice():
    nodes, pods = port_cluster(0, n_nodes=4, n_pods=4)
    # a plugin the port has no filter for is refused: NodeNumber (the
    # simulator's example) enabled as a *filter*, which it is not even once
    # plugins/nodenumber.py registers its score
    cfg = PConfig.default().to_dict()
    cfg["profiles"][0]["plugins"]["filter"]["enabled"].append({"name": "NodeNumber"})
    enc = kp.encode_cluster(nodes, pods, PConfig.from_dict(cfg), device="cpu")
    with pytest.raises(UnsupportedPluginError):
        kp.BatchedScheduler(enc, device="cpu")
