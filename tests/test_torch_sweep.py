"""The port's WeightSweep against the reference's.

The same cluster and the same [V, S] weight matrix (numpy, shared) go
through the JAX package's `parallel.WeightSweep` and the port's (plain
versions, CPU) under EXACT and TPU32. Compared: every `SchedState` field of
every variant, the selections [V, Q], the decoded placements and, with
`record=True`, each variant's trace slot for slot (the port's CSR victim
records against the reference's dense masks). The reference runs its two
preemption strategies, the two-phase event loop ("phase", the default) and
the masked scan ("masked"); the port runs one kernel for every mode, so both
must equal it. Clusters: test_parallel.py's contended four nodes under its
small preemption configuration (every variant preempts), a small
`preemption_cluster` under the whole default profile (held against the
reference in test_torch_sweep_default.py) and a fit-only configuration
without DefaultPreemption. Each reference sweep is built and run once per
module. Tolerance: exact equality.
"""

import dataclasses

import numpy as np
import pytest
import torch

from kube_scheduler_simulator_tpu.engine import encode_cluster as j_encode_cluster
from kube_scheduler_simulator_tpu.parallel import WeightSweep as JWeightSweep
from kube_scheduler_simulator_tpu.sched.config import SchedulerConfiguration as JConfig

import kube_scheduler_simulator_tpu_torch as kp
from kube_scheduler_simulator_tpu_torch.engine import cuda
from kube_scheduler_simulator_tpu_torch.engine.encode import SchedState
from kube_scheduler_simulator_tpu_torch.parallel import WeightSweep, weights_for
from kube_scheduler_simulator_tpu_torch.sched.config import SchedulerConfiguration as PConfig

from helpers import node, pod
from test_engine_parity import restricted_config
from test_engine_parity_preempt import preempt_config
from test_torch_encode import POLICIES
from test_torch_preempt import assert_preempt_traces_agree, assert_same


def contended():
    """Four full nodes and three high-priority pods that must preempt."""
    nodes = [node(f"n{i}", cpu="2", pods="8") for i in range(4)]
    pods = [pod(f"low-{i}", cpu="1500m", priority=1, node_name=f"n{i}") for i in range(4)]
    pods += [pod(f"high-{i}", cpu="1200m", priority=100) for i in range(3)]
    return nodes, pods, {}


def default_cluster():
    return kp.preemption_cluster(6, 30, seed=1)


def one_hots(b, at=(0, 3, 5)):
    """The base weights, then each chosen plugin alone at weight 10."""
    return [b] + [np.eye(len(b), dtype=np.int32)[i] * 10 for i in at]


def fit_cluster():
    nodes, pods = kp.synthetic_cluster(8, 16, seed=5)
    return nodes, pods, {}


# name -> (cluster, configuration dict, weight matrix from the base weights)
CASES = {
    "contended": (contended, preempt_config().to_dict(), lambda b: [b + 3 * i for i in range(3)]),
    "default": (default_cluster, kp.supported_config().to_dict(), one_hots),
    "fit": (fit_cluster, restricted_config().to_dict(), lambda b: [b + i for i in range(4)]),
}
_CLUSTERS: dict = {}


def cluster(case):
    if case not in _CLUSTERS:
        _CLUSTERS[case] = CASES[case][0]()
    return _CLUSTERS[case]


def encodings(case, policy):
    nodes, pods, objects = cluster(case)
    cfg = CASES[case][1]
    j_pol, p_pol = POLICIES[policy]
    j_enc = j_encode_cluster(nodes, pods, JConfig.from_dict(cfg), policy=j_pol, **objects)
    p_enc = kp.encode_cluster(nodes, pods, PConfig.from_dict(cfg), policy=p_pol, device="cpu",
                              **objects)
    return j_enc, p_enc


def weight_matrix(p_enc, case):
    base = weights_for(p_enc, {})
    return np.stack(CASES[case][2](base)).astype(np.int32)


@pytest.fixture(scope="module")
def reference():
    """(case, policy, mode, record) -> the reference sweep's (encoding,
    states, output, placements), each run once."""
    runs = {}

    def get(case, policy, mode, record=False):
        key = (case, policy, mode, record)
        if key not in runs:
            j_enc, p_enc = encodings(case, policy)
            sweep = JWeightSweep(j_enc, preempt=mode, record=record)
            states, out = sweep.run(weight_matrix(p_enc, case))
            placements = None if record else sweep.placements(out)
            runs[key] = (sweep, states, out, placements)
        return runs[key]

    return get


def assert_states_equal(j_states, p_states, V):
    for f in dataclasses.fields(SchedState):
        want = np.asarray(getattr(j_states, f.name))
        got = getattr(p_states, f.name)
        assert tuple(got.shape[:1]) == (V,), f.name
        assert_same(f.name, want, got)


_PORT_RUNS: dict = {}


def port_sweep(case, policy, **kw):
    """The port's sweep of a case (sweep, weights, run()), run once."""
    key = (case, policy, tuple(sorted(kw.items())))
    if key not in _PORT_RUNS:
        _, p_enc = encodings(case, policy)
        sweep = WeightSweep(p_enc, device="cpu", **kw)
        w = weight_matrix(p_enc, case)
        _PORT_RUNS[key] = (sweep, w, sweep.run(w))
    return _PORT_RUNS[key]


def evicted(sweep, states):
    """Per variant: some pod bound before the pass was evicted."""
    pre = sweep.enc.state0.assignment >= 0
    return [bool((states.assignment[v][pre] < 0).any()) for v in range(len(states.assignment))]


@pytest.mark.parametrize("mode", ["phase", "masked"])
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_contended_sweep_matches_reference(reference, policy, mode):
    """Every variant preempts: the reference's phase event loop and its
    masked scan both equal the port's one kernel."""
    j_sweep, j_states, j_sels, j_place = reference("contended", policy, mode)
    assert j_sweep.preempt == mode
    sweep, w, (states, sels) = port_sweep("contended", policy, preempt=mode)
    assert sweep.preempt == mode
    assert_states_equal(j_states, states, len(w))
    assert_same("sels", j_sels, sels)
    assert sweep.placements(sels) == j_place
    # each variant's high pods evicted a low one
    assert all(evicted(sweep, states))


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_sweep_without_preemption_matches_reference(reference, policy):
    _, j_states, j_sels, j_place = reference("fit", policy, "off")
    sweep, w, (states, sels) = port_sweep("fit", policy, preempt="off")
    assert sweep.preempt == "off"
    assert_states_equal(j_states, states, len(w))
    assert_same("sels", j_sels, sels)
    assert sweep.placements(sels) == j_place


def variant_trace(trace, v):
    """Variant v's trace in a single pass's layout (its victim list cut to
    its own length)."""
    row = [x[v] for x in trace]
    voff = row[cuda.TRACE_SLOTS_PREEMPT.index("voff")]
    n = int(voff[-1, -1, -1]) if len(voff) else 0
    row[-1] = row[-1][:n]
    assert bool((trace[-1][v, n:] == -1).all())
    return row


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_recorded_sweep_matches_reference_trace(reference, policy):
    """record=True: the reference's vmapped masked trace, variant by
    variant and slot for slot; the selections equal the unrecorded run's."""
    j_sweep, j_states, j_trace, _ = reference("contended", policy, "masked", record=True)
    assert j_sweep.preempt == "masked"
    sweep, w, (states, trace) = port_sweep("contended", policy, record=True)
    assert sweep.preempt == "masked"
    assert len(trace) == len(cuda.TRACE_SLOTS_PREEMPT)
    assert_states_equal(j_states, states, len(w))
    P = sweep.enc.P
    for v in range(len(w)):
        assert_preempt_traces_agree([np.asarray(x)[v] for x in j_trace], variant_trace(trace, v),
                                    P)
    _, _, (_, sels) = port_sweep("contended", policy)
    assert torch.equal(trace[cuda.TRACE_SLOTS_PREEMPT.index("final_sel")], sels)
    assert bool(trace[cuda.TRACE_SLOTS_PREEMPT.index("did")].any())


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_recorded_sweep_without_preemption(reference, policy):
    _, j_states, j_trace, _ = reference("fit", policy, "off", record=True)
    sweep, w, (states, trace) = port_sweep("fit", policy, record=True)
    assert len(trace) == len(cuda.TRACE_SLOTS_PLAIN)
    assert_states_equal(j_states, states, len(w))
    for name, want, got in zip(cuda.TRACE_SLOTS_PLAIN, j_trace, trace):
        assert_same(name, want, got)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_each_variant_is_the_sequential_pass(case, policy):
    """Variant v equals the port's single pass with weights w[v]."""
    sweep, w, (states, sels) = port_sweep(case, policy)
    for v in range(len(w)):
        eng = kp.BatchedScheduler(sweep.enc, record=False, device="cpu")
        st, out = eng.run(weights=torch.as_tensor(w[v]).to(sweep.enc.policy.score))
        for f in dataclasses.fields(SchedState):
            assert torch.equal(getattr(st, f.name), getattr(states, f.name)[v]), (v, f.name)
        assert torch.equal(out[: len(sweep.enc.queue)], sels[v]), v


def test_sweep_goes_through_the_wrapper():
    """One sweep is one call of the sweep_run wrapper (its plain version
    on CPU tensors), whatever the mode."""
    _, p_enc = encodings("contended", "i32")
    w = weight_matrix(p_enc, "contended")
    for mode in ("phase", "masked"):
        cuda.reset_counts()
        WeightSweep(p_enc, preempt=mode, device="cpu").run(w)
        assert cuda.PLAIN_CALLS["sweep_run"] == 1 and cuda.PLAIN_CALLS["seq_run"] == 0


# -- the mode rules and errors (test_parallel.py's, plus the port's own) -----


def test_weights_for():
    nodes, pods = kp.synthetic_cluster(4, 4, seed=4)
    enc = kp.encode_cluster(nodes, pods, kp.supported_config(), policy=kp.TPU32, device="cpu")
    w = weights_for(enc, {"TaintToleration": 9})
    specs = dict(enc.config.score_plugins())
    assert len(w) == len(specs) and w.dtype == np.int32
    assert w[list(specs).index("TaintToleration")] == 9
    with pytest.raises(KeyError):
        weights_for(enc, {"NotAPlugin": 1})


def one_pod_encodings(cfg):
    nodes, pods = [node("n0", cpu="2", pods="8")], [pod("p0", cpu="1")]
    return (j_encode_cluster(nodes, pods, JConfig.from_dict(cfg.to_dict())),
            kp.encode_cluster(nodes, pods, cfg, device="cpu"))


@pytest.mark.parametrize("mode", ["auto", "phase", "masked", "off"])
@pytest.mark.parametrize("record", [False, True])
@pytest.mark.parametrize("preempts", [True, False])
def test_mode_rules_match_reference(mode, record, preempts):
    """The resolved strategy, or the ValueError, is the reference's."""
    cfg = PConfig.from_dict((preempt_config() if preempts else restricted_config()).to_dict())
    j_enc, p_enc = one_pod_encodings(cfg)
    try:
        want = JWeightSweep(j_enc, preempt=mode, record=record).preempt
    except ValueError:
        with pytest.raises(ValueError):
            WeightSweep(p_enc, preempt=mode, record=record, device="cpu")
        return
    assert WeightSweep(p_enc, preempt=mode, record=record, device="cpu").preempt == want


def test_record_mode_falls_back_to_masked():
    _, p_enc = one_pod_encodings(PConfig.from_dict(preempt_config().to_dict()))
    assert WeightSweep(p_enc, record=True, device="cpu").preempt == "masked"


def test_preempt_off_rejects_preemption_config():
    _, p_enc = one_pod_encodings(PConfig.from_dict(preempt_config().to_dict()))
    with pytest.raises(ValueError):
        WeightSweep(p_enc, preempt="off", device="cpu")
    with pytest.raises(ValueError, match="auto\\|phase"):
        WeightSweep(p_enc, preempt="sometimes", device="cpu")


@pytest.mark.parametrize("shape", [(3,), (2, 1), (2, 3, 1)])
def test_wrong_weight_matrix_shape_raises(shape):
    _, p_enc = one_pod_encodings(PConfig.from_dict(preempt_config().to_dict()))
    sweep = WeightSweep(p_enc, device="cpu")
    assert len(sweep.sched.weights) == 2
    with pytest.raises(ValueError, match="weight matrix"):
        sweep.run(np.ones(shape, np.int32))


def test_mesh_is_not_ported():
    _, p_enc = one_pod_encodings(PConfig.from_dict(preempt_config().to_dict()))
    with pytest.raises(NotImplementedError, match="mesh"):
        WeightSweep(p_enc, mesh=object(), device="cpu")


def test_masked_engine_and_its_mode_check():
    """WeightSweep builds its engine masked; BatchedScheduler validates
    preempt_mode as the reference does."""
    _, p_enc = one_pod_encodings(PConfig.from_dict(preempt_config().to_dict()))
    assert WeightSweep(p_enc, device="cpu").sched.preempt_mode == "masked"
    assert kp.BatchedScheduler(p_enc, device="cpu").preempt_mode == "cond"
    with pytest.raises(ValueError, match="cond\\|masked"):
        kp.BatchedScheduler(p_enc, preempt_mode="vmap", device="cpu")
