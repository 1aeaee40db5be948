"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA card and the CUDA toolkit (the kernels build at first use);
skipped where `torch.cuda.is_available()` is False. On the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(`--noconftest`: the suite's conftest configures JAX, which the port and
this file do not use). Tolerance: exact equality. Each test runs under the
first slice's plugin set (`fit_config()`) and the default profile without
volumes and preemption (`affinity_config()`); `rel_cluster` (test_torch_clusters)
reaches the relational plugins. The default profile's kernels (the volume
family, `seq_preempt`, `seq_evict`, `seq_run`'s preemption branch) run on
`synth.dressed_default_cluster`. The gang kernels and `sweep_run` also run
with a leading variant axis (the gang weight sweep, `GangSweep`) and in their
tenant forms (the batch plane's `batch.seq.run`/`batch.gang.run`: B = 3
tenants with equal shapes and their own values, one of them with nothing to
do). The fault sweep's kernels (`fault_evict`, `fault_tally`) run on S
failure scenarios of one cluster, with one gang round of the scenarios
through the tenant forms over the scenario table between them, and a whole
`FaultSweep` runs against the same sweep on the CPU. The demo out-of-tree
plugins (NetworkBandwidth, NodeNumber) run on the annotated default cluster
under `kp.demo_config()` (`plugin_engine`): the steps, the dry run with
NetworkBandwidth's row and the whole pass.
"""

import contextlib
import copy

import numpy as np
import pytest
import torch

import kube_scheduler_simulator_tpu_torch as kp
from kube_scheduler_simulator_tpu_torch.engine import cuda, packing
from kube_scheduler_simulator_tpu_torch.engine.gang import (
    _ScenarioRounds,
    _TenantRounds,
    batch_fixpoint,
)
from kube_scheduler_simulator_tpu_torch.synth import HOST, ZONE
from kube_scheduler_simulator_tpu_torch.utils.quantity import parse_quantity

from test_torch_clusters import NAMESPACES, claim_cluster, rel_cluster

pytestmark = pytest.mark.cuda

STATE_FIELDS = ("requested", "s_requested", "n_pods", "assignment", "used_pair",
                "used_wild", "used_trip", "used_claims", "node_disk_any", "node_disk_rw",
                "node_vol3", "bound_seq")
POLICIES = {"exact": kp.EXACT, "i32": kp.TPU32}
CONFIGS = {"fit": kp.fit_config, "slice": kp.affinity_config}

# K10 (engine/scatter.py): random retained planes of every dtype the delta
# encoder scatters into, rows of rank 0 to 3 and a zero-width plane
K10_DTYPES = (torch.bool, torch.int32, torch.int64, torch.int16)  # int16: PACKED's planes
K10_ADD_DTYPES = (torch.int32, torch.int64)
K10_ROW_SHAPES = ((), (3,), (2, 5), (2, 3, 4), (0,))


def k10_cases(seed=0, P=300, k=64):
    """(label, plane, set indices, set rows, add indices, add rows, vector)
    on the CPU. Set indices are distinct; add indices repeat (several rows
    into one node); int32 values sit at the type's edges, so sums wrap.
    Bool and int16 planes have no add (None)."""
    rng = np.random.default_rng(seed)

    def rand(dtype, shape):
        if dtype == torch.bool:
            return torch.as_tensor(rng.random(shape) < 0.5)
        info = torch.iinfo(dtype)
        edge = rng.integers(info.min, info.max, shape, dtype=np.int64, endpoint=True)
        small = rng.integers(-5, 6, shape)
        pick = rng.random(shape) < 0.5
        return torch.as_tensor(np.where(pick, edge, small)).to(dtype)

    for dtype in K10_DTYPES:
        for shape in K10_ROW_SHAPES:
            arr = rand(dtype, (P, *shape))
            idx = torch.as_tensor(rng.choice(P, k, replace=False).astype(np.int32))
            rows = rand(dtype, (k, *shape))
            add = vec = None
            if dtype in K10_ADD_DTYPES:
                add_idx = torch.as_tensor(rng.integers(0, 8, 3 * k).astype(np.int32))
                add = (add_idx, rand(dtype, (3 * k, *shape)))
                vec = rand(dtype, (P, *shape))
            yield f"{str(dtype)[6:]} rows{shape}", arr, idx, rows, add, vec


def check_k10(device, scatter, seed=0):
    """Each K10 wrapper on `device` against its plain version on the CPU,
    exact. Returns the number of comparisons."""
    n = 0
    for label, arr, idx, rows, add, vec in k10_cases(seed):
        got = scatter.scatter_set(arr.to(device, copy=True), idx, rows).cpu()
        want = scatter.scatter_set_plain(arr.clone(), idx, rows)
        assert got.dtype == want.dtype and torch.equal(got, want), ("set", label)
        n += 1
        if add is not None:
            got = scatter.scatter_add(arr.to(device, copy=True), *add).cpu()
            want = scatter.scatter_add_plain(arr.clone(), *add)
            assert torch.equal(got, want), ("add", label)
            got = scatter.vec_add(arr.to(device, copy=True), vec).cpu()
            want = scatter.vec_add_plain(arr.clone(), vec)
            assert torch.equal(got, want), ("vec", label)
            n += 2
    return n


def widen_leaves(enc):
    """(leaves, lane counts) of every packed (lanes n > 0) or narrow (0)
    plane of a PACKED encoding: what `packing.widen` hands K8."""
    picked = packing.widen_leaves(enc.arrays, enc.aux["packed_dims"])
    return [t for _, _, t, _ in picked], [n for _, _, _, n in picked]


def pack_cases(seed=0):
    """(leaves, lane counts) on the CPU: random words (bit 31 and the tail
    word's padding bits set in many) of 2-, 3- and 4-D planes at odd lane
    counts, int8 and int16 planes at their types' edges, and empty ones."""
    rng = np.random.default_rng(seed)
    leaves, lanes = [], []
    for shape, n in (((3, 1), 8), ((5, 2), 33), ((2, 4, 2), 40), ((7, 2), 64),
                     ((2, 3, 2, 1), 17), ((0, 2), 40), ((6, 1), 32)):
        w = rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)
        leaves.append(torch.as_tensor(w))
        lanes.append(n)
    for dtype, shape in ((np.int8, (4, 5)), (np.int16, (3, 7)), (np.int16, (9,)),
                         (np.int8, (2, 3, 4)), (np.int16, (0, 3))):
        info = np.iinfo(dtype)
        leaves.append(torch.as_tensor(rng.integers(info.min, info.max, shape, dtype=np.int64,
                                                   endpoint=True).astype(dtype)))
        lanes.append(0)
    return leaves, lanes


def check_pack_widen(device, cuda, encs=(), seed=0):
    """K8 on `device` against its plain version on the CPU, bit for bit,
    over `pack_cases` and every packed or narrow leaf of each PACKED
    encoding of `encs`, one call each. Returns the leaves compared."""
    n = 0
    for leaves, lanes in [pack_cases(seed)] + [widen_leaves(e) for e in encs]:
        assert leaves
        got = cuda.pack_widen([t.to(device) for t in leaves], lanes)
        want = cuda.pack_widen_plain(leaves, lanes)
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.dtype == w.dtype and g.shape == w.shape, i
            assert g.device.type == device.type and torch.equal(g.cpu(), w), i
        n += len(leaves)
    return n


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def cluster(n_nodes, n_pods, seed):
    """Taints of all three effects, tolerations, a cordoned node, pinned
    pods (existing and missing node) and one pod too large for any node."""
    nodes, pods = kp.synthetic_cluster(n_nodes, n_pods, seed=seed, priorities=True)
    for i, nd in enumerate(nodes):
        taints = [{"key": "k", "value": "v", "effect": e}
                  for e, m in (("NoSchedule", 5), ("PreferNoSchedule", 3), ("NoExecute", 7))
                  if i % m == 1]
        nd["spec"] = {"taints": taints, "unschedulable": i % 9 == 4}
    for j, pd in enumerate(pods):
        spec = pd["spec"]
        if j % 4 == 0:
            spec["tolerations"] = [{"key": "k", "operator": "Exists"}]
        if j % 11 == 2:
            spec["tolerations"] = [{"key": "k", "value": "v", "effect": "NoSchedule"}]
        if j % 13 == 3:
            spec["nodeName"] = nodes[j % n_nodes]["metadata"]["name"]
        if j % 17 == 5:
            spec["nodeName"] = "missing"
        if j == 6:
            spec["containers"][0]["resources"]["requests"] = {"cpu": "999", "memory": "1Ti"}
    return nodes, pods


def random_state(enc, rng):
    """Usage up to 130% of capacity, port counters of 0..2 users and about
    half the pending pods bound, mostly to the first third of the nodes."""
    st = enc.state0.clone()
    alloc = enc.arrays.node_alloc
    for f in ("requested", "s_requested"):
        frac = torch.as_tensor(rng.uniform(0.0, 1.3, tuple(alloc.shape)))
        setattr(st, f, torch.floor(alloc * frac).to(alloc.dtype))
    st.n_pods = torch.as_tensor(rng.integers(0, 112, enc.N), dtype=torch.int32)
    for f in ("used_pair", "used_wild", "used_trip"):
        shape = tuple(getattr(st, f).shape)
        setattr(st, f, torch.as_tensor(rng.integers(0, 3, shape), dtype=torch.int32))
    asg = st.assignment.numpy().copy()
    free = (asg < 0) & (rng.random(asg.shape) < 0.5)
    free[enc.n_pods:] = False
    hi = np.where(rng.random(int(free.sum())) < 0.8, max(1, enc.n_nodes // 3), enc.n_nodes)
    asg[free] = rng.integers(0, hi)
    st.assignment = torch.as_tensor(asg)
    return st


def engine(policy, n_nodes=40, n_pods=300, seed=0, config="slice", rel=False):
    if rel:
        nodes, pods = rel_cluster(seed, n_nodes, n_pods)
    else:
        nodes, pods = cluster(n_nodes, n_pods, seed)
    enc = kp.encode_cluster(nodes, pods, CONFIGS[config](), policy=POLICIES[policy],
                            namespaces=NAMESPACES)
    return kp.BatchedScheduler(enc)


def padded_queue(eng):
    q = eng.enc.queue
    pad = np.full(eng.queue_bucket(len(q)) - len(q), -1)
    return torch.as_tensor(np.concatenate([q, pad]).astype(np.int32), device=eng.device)


CASES = [("fit", False), ("slice", False), ("slice", True)]


@pytest.mark.parametrize("config,rel", CASES, ids=["fit", "slice", "slice-rel"])
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_attempt_and_bind_match_plain(card, policy, config, rel):
    eng = engine(policy, config=config, rel=rel)
    enc, prog, w = eng.enc, eng.program, eng.weights
    state = enc.state0.clone()
    for qi, p in enumerate(enc.queue[:60].tolist()):
        got = cuda.seq_attempt(prog, enc.arrays, state, w, p)
        want = cuda.seq_attempt_plain(prog, enc.arrays, state, w, p)
        for g, h in zip(got, want):
            assert g.dtype == h.dtype and torch.equal(g, h), (qi, p)
        other = state.clone()
        cuda.seq_bind(prog, enc.arrays, state, p, got[3], qi)
        cuda.seq_bind_plain(prog, enc.arrays, other, p, want[3], qi)
        for f in STATE_FIELDS:
            assert torch.equal(getattr(state, f), getattr(other, f)), (qi, f)


@pytest.mark.parametrize("config,rel", CASES, ids=["fit", "slice", "slice-rel"])
@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("record", [True, False])
def test_run_matches_plain(card, policy, record, config, rel):
    eng = engine(policy, seed=1, config=config, rel=rel)
    enc, q = eng.enc, padded_queue(eng)
    s_k, t_k = cuda.seq_run(eng.program, enc.arrays, enc.state0, q, eng.weights, record=record)
    s_p, t_p = cuda.seq_run_plain(eng.program, enc.arrays, enc.state0, q, eng.weights,
                                  record=record)
    for g, h in zip(t_k if record else [t_k], t_p if record else [t_p]):
        assert g.dtype == h.dtype and torch.equal(g, h)
    for f in STATE_FIELDS:
        assert torch.equal(getattr(s_k, f), getattr(s_p, f)), f


@pytest.mark.parametrize("rel", [False, True], ids=["fit-cluster", "rel-cluster"])
def test_schedule_on_the_card_launches_seq_run(card, rel):
    nodes, pods = rel_cluster(2) if rel else cluster(24, 120, seed=2)
    cuda.reset_counts()
    placements, results = kp.schedule(nodes, pods)
    assert cuda.LAUNCHES["seq_run"] == 1 and not any(cuda.PLAIN_CALLS.values())
    want_pl, want_res = kp.schedule(nodes, pods, device="cpu")
    assert placements == want_pl
    assert [r.to_annotations() for r in results] == [r.to_annotations() for r in want_res]


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    eng = engine("i32", n_nodes=8, n_pods=16)
    enc, prog, w = eng.enc, eng.program, eng.weights
    with pytest.raises(ValueError, match="weights"):
        cuda.seq_attempt(prog, enc.arrays, enc.state0, w.to(torch.int64), 0)
    bad = enc.state0.clone()
    bad.requested = bad.requested.t().contiguous().t()
    with pytest.raises(ValueError, match="contiguous"):
        cuda.seq_attempt(prog, enc.arrays, bad, w, 0)
    with pytest.raises(ValueError, match="pod index"):
        cuda.seq_attempt(prog, enc.arrays, enc.state0, w, enc.P)


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("prescore", ["on", "off"])
def test_custom_normalizes_with_no_feasible_node(card, policy, prescore):
    """A pod no node can take: the custom normalizes meet their sentinels
    (int32 wrap under TPU32), and with PreScore disabled both scores are 0."""
    from kube_scheduler_simulator_tpu_torch.sched.config import SchedulerConfiguration

    nodes, pods = rel_cluster(3, 16, 40)
    pods[7]["spec"]["containers"][0]["resources"]["requests"] = {"cpu": "999"}
    cfg = kp.affinity_config().to_dict()
    if prescore == "off":
        cfg["profiles"][0]["plugins"]["preScore"]["enabled"] = []
    enc = kp.encode_cluster(nodes, pods, SchedulerConfiguration.from_dict(cfg),
                            policy=POLICIES[policy], namespaces=NAMESPACES)
    eng = kp.BatchedScheduler(enc)
    got = cuda.seq_attempt(eng.program, enc.arrays, enc.state0, eng.weights, 7)
    want = cuda.seq_attempt_plain(eng.program, enc.arrays, enc.state0, eng.weights, 7)
    assert int(got[3]) == -1
    for g, h in zip(got, want):
        assert g.dtype == h.dtype and torch.equal(g, h)


def default_engine(policy, seed=3):
    nodes, pods, objects = kp.synth.dressed_default_cluster(48, 200, seed=seed)
    enc = kp.encode_cluster(nodes, pods, kp.supported_config(), policy=POLICIES[policy],
                            **objects)
    return kp.BatchedScheduler(enc)


def plugin_engine(policy, device=None, seed=3, n_nodes=48, n_pods=200, reverse=False):
    """The default profile plus the demo out-of-tree plugins (16 filters, 9
    scores; `kp.demo_config`) on the dressed default cluster, annotated for
    NetworkBandwidth (`synth.annotate_bandwidth`): its filter rejects
    nodes, its score's min-max normalize and its dry-run row decide."""
    import kube_scheduler_simulator_tpu_torch.plugins.networkbandwidth  # noqa: F401
    import kube_scheduler_simulator_tpu_torch.plugins.nodenumber  # noqa: F401

    nodes, pods, objects = kp.synth.dressed_default_cluster(n_nodes, n_pods, seed=seed)
    kp.synth.annotate_bandwidth(nodes, pods, seed=7)
    enc = kp.encode_cluster(nodes, pods, kp.demo_config(reverse=reverse),
                            policy=POLICIES[policy], device=device, **objects)
    return kp.BatchedScheduler(enc, device=device)


def same(got, want, what):
    assert got.dtype == want.dtype and torch.equal(got.cpu(), want.cpu()), what


def check_plugin_steps(eng, rng, states=3, pods=6):
    """seq_attempt, seq_bind, seq_preempt and seq_evict of a plugin engine
    against their plain versions at random states (on the encoding's
    device); returns the nominations seen."""
    enc, prog, a, w = eng.enc, eng.program, eng.enc.arrays, eng.weights
    cpu = torch.device("cpu")
    nominated = 0
    for k in range(states):
        st = random_state(enc.to(cpu), rng).to(enc.device)
        for qi, p in enumerate(rng.choice(enc.n_pods, pods, replace=False).tolist()):
            got = cuda.seq_attempt(prog, a, st, w, p)
            want = cuda.seq_attempt_plain(prog, a, st, w, p)
            for name, g, h in zip(("codes", "raw", "final", "sel", "pf"), got, want):
                same(g, h, (k, p, name))
            s1 = cuda.seq_bind(prog, a, st.clone(), p, got[3], qi)
            s2 = cuda.seq_bind_plain(prog, a, st.clone(), p, want[3], qi)
            for f in STATE_FIELDS:
                same(getattr(s1, f), getattr(s2, f), (k, p, f))
            got = cuda.seq_preempt(prog, a, st, p)
            want = cuda.seq_preempt_plain(prog, a, st, p)
            for name, g, h in zip(("pcode", "voff", "vidx", "nominated"), got, want):
                same(g, h, (k, p, name))
            nominated += int(got[3]) >= 0
        mask = (st.assignment >= 0) & torch.as_tensor(rng.random(enc.P) < 0.3,
                                                      device=enc.device)
        s1 = cuda.seq_evict(prog, a, st.clone(), mask)
        s2 = cuda.seq_evict_plain(prog, a, st.clone(), mask)
        for f in STATE_FIELDS:
            same(getattr(s1, f), getattr(s2, f), (k, "evict", f))
    return nominated


def check_plugin_run(eng):
    """The whole recorded pass (preemption branch included) of a plugin
    engine against its plain version; returns (trace, the records'
    NetworkBandwidth filter messages)."""
    enc, q = eng.enc, padded_queue(eng)
    args = (eng.program, enc.arrays, enc.state0, q, eng.weights)
    s_k, t_k = cuda.seq_run(*args, record=True)
    s_p, t_p = cuda.seq_run_plain(*args, record=True)
    for name, g, h in zip(cuda.TRACE_SLOTS_PREEMPT, t_k, t_p):
        same(g, h, name)
    for f in STATE_FIELDS:
        same(getattr(s_k, f), getattr(s_p, f), f)
    nb = eng.program.filter_names.index("NetworkBandwidth")
    return t_k, int((t_k[1][..., nb] != 0).any(dim=1).sum())


def check_plugin_no_feasible(policy, device=None):
    """A pod no node can take under both plugins: NetworkBandwidth's
    normalize meets its sentinels (int32 wrap under TPU32)."""
    import kube_scheduler_simulator_tpu_torch.plugins.networkbandwidth  # noqa: F401
    import kube_scheduler_simulator_tpu_torch.plugins.nodenumber  # noqa: F401

    nodes, pods = rel_cluster(3, 16, 40)
    kp.synth.annotate_bandwidth(nodes, pods, seed=7)
    pods[7]["spec"]["containers"][0]["resources"]["requests"] = {"cpu": "999"}
    enc = kp.encode_cluster(nodes, pods, kp.demo_config(), policy=POLICIES[policy],
                            namespaces=NAMESPACES, device=device)
    eng = kp.BatchedScheduler(enc, device=device)
    got = cuda.seq_attempt(eng.program, enc.arrays, enc.state0, eng.weights, 7)
    want = cuda.seq_attempt_plain(eng.program, enc.arrays, enc.state0, eng.weights, 7)
    assert int(got[3]) == -1
    for name, g, h in zip(("codes", "raw", "final", "sel", "pf"), got, want):
        same(g, h, name)


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_plugin_steps_match_plain(card, policy):
    eng = plugin_engine(policy, card)
    assert (len(eng.program.filter_names), len(eng.program.score_names)) == (16, 9)
    assert check_plugin_steps(eng, np.random.default_rng(9)) > 0


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_plugin_run_matches_plain(card, policy):
    trace, nb_rejects = check_plugin_run(plugin_engine(policy, card, seed=4, reverse=True))
    assert int(trace[5].sum()) > 0 and nb_rejects > 0


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_plugin_normalize_with_no_feasible_node(card, policy):
    check_plugin_no_feasible(policy, card)


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_preempt_and_evict_match_plain(card, policy):
    eng = default_engine(policy)
    enc, prog, a = eng.enc, eng.program, eng.enc.arrays
    enc_cpu = enc.to(torch.device("cpu"))
    rng = np.random.default_rng(9)
    for k in range(4):
        st = random_state(enc_cpu, rng).to(card)
        for p in rng.choice(enc.n_pods, 8, replace=False).tolist():
            got = cuda.seq_preempt(prog, a, st, p)
            want = cuda.seq_preempt_plain(prog, a, st, p)
            for g, h in zip(got, want):
                assert g.dtype == h.dtype and torch.equal(g, h), (k, p)
        mask = (st.assignment >= 0) & torch.as_tensor(rng.random(enc.P) < 0.3, device=card)
        s1 = cuda.seq_evict(prog, a, st.clone(), mask)
        s2 = cuda.seq_evict_plain(prog, a, st.clone(), mask)
        for f in STATE_FIELDS:
            assert torch.equal(getattr(s1, f), getattr(s2, f)), (k, f)


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_run_with_preemption_matches_plain(card, policy):
    eng = default_engine(policy, seed=4)
    enc, q = eng.enc, padded_queue(eng)
    args = (eng.program, enc.arrays, enc.state0, q, eng.weights)
    s_k, t_k = cuda.seq_run(*args, record=True)
    s_p, t_p = cuda.seq_run_plain(*args, record=True)
    for name, g, h in zip(cuda.TRACE_SLOTS_PREEMPT, t_k, t_p):
        assert g.dtype == h.dtype and torch.equal(g, h), name
    for f in STATE_FIELDS:
        assert torch.equal(getattr(s_k, f), getattr(s_p, f)), f
    assert int(t_k[5].sum()) > 0


def test_k10_kernels_match_plain(card):
    from kube_scheduler_simulator_tpu_torch.engine import scatter

    scatter.reset_counts()
    assert check_k10(card, scatter) == 40
    # a zero-width plane launches nothing: 4 dtypes x 4 shapes of set (the
    # 2-byte rows of int16 among them), 2 x 4 of add and vec
    assert scatter.LAUNCHES == {"delta_scatter_set": 16, "delta_scatter_add": 8,
                                "delta_vec_add": 8}
    assert not any(scatter.PLAIN_CALLS.values())


def packed_encodings(device=None):
    """PACKED encodings of the affinity cluster and of the small default
    cluster whose `pod_claim` bit-packs."""
    nodes, pods = kp.synthetic_affinity_cluster(32, 96, seed=5)
    aff = kp.encode_cluster(nodes, pods, kp.supported_config(), policy=kp.PACKED, device=device)
    nodes, pods, objects = claim_cluster()
    dflt = kp.encode_cluster(nodes, pods, kp.supported_config(), policy=kp.PACKED,
                             device=device, **objects)
    return aff, dflt


def test_pack_widen_matches_plain(card):
    """K8 (csrc/pack_kernels.cu): odd lane counts, words with bit 31 and
    padding bits set, 3-D and 4-D planes, int8 and int16 at their edges,
    empty planes, and every packed or narrow leaf of two PACKED encodings,
    each call one launch."""
    cuda.reset_counts()
    encs = packed_encodings("cpu")
    assert check_pack_widen(card, cuda, encs) > 12
    assert cuda.LAUNCHES["pack_widen"] == 3 and cuda.PLAIN_CALLS["pack_widen"] == 0


def test_packed_pass_matches_tpu32(card):
    """The default profile's pass under PACKED on the card: one K8 launch,
    then the trace, final state and placements of the TPU32 pass."""
    nodes, pods, objects = claim_cluster()
    runs = []
    for policy in (kp.TPU32, kp.PACKED):
        enc = kp.encode_cluster(nodes, pods, kp.supported_config(), policy=policy, **objects)
        eng = kp.BatchedScheduler(enc)
        cuda.reset_counts()
        runs.append(eng.run() + (eng.placements(), dict(cuda.LAUNCHES)))
    (st_a, tr_a, pl_a, n_a), (st_b, tr_b, pl_b, n_b) = runs
    assert n_a["pack_widen"] == 0 and n_b["pack_widen"] == 1 and n_b["seq_run"] == 1
    for g, h in zip(tr_b, tr_a):
        assert g.dtype == h.dtype and torch.equal(g, h)
    for f in STATE_FIELDS:
        assert torch.equal(getattr(st_b, f), getattr(st_a, f)), f
    assert pl_a == pl_b


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_delta_passes_on_the_card_match_the_cpu(card, policy, monkeypatch):
    """A dressed store's delta passes: the encoder on the card (K10
    kernels) and on the CPU (plain versions) keep equal encodings, and the
    service's records on the card equal the CPU service's."""
    from kube_scheduler_simulator_tpu_torch.engine import scatter
    from kube_scheduler_simulator_tpu_torch.server.service import SimulatorService

    nodes, pods = rel_cluster(5, 24, 160)
    monkeypatch.setenv("KSS_DTYPE_POLICY", policy)
    sims = [SimulatorService(device=card), SimulatorService(device="cpu")]
    for sim in sims:
        sim.import_({"nodes": nodes, "pods": pods[:120], "namespaces": NAMESPACES})
    modes = []
    for k in range(4):
        for sim in sims:
            for pd in pods[120 + 10 * k:130 + 10 * k]:
                pd = {**pd, "spec": {**pd["spec"]}}
                pd["spec"].pop("affinity", None)
                sim.store.apply("pods", pd)
            sim.store.apply("nodes", {"metadata": {"name": nodes[k]["metadata"]["name"]},
                                      "spec": {"unschedulable": True}})
        scatter.reset_counts()
        got = sims[0].scheduler.schedule()
        launches = dict(scatter.LAUNCHES)
        want = sims[1].scheduler.schedule()
        info = sims[0].scheduler.last_encode_info
        assert info == sims[1].scheduler.last_encode_info
        modes.append(info["mode"])
        assert (sum(launches.values()) > 0) == (info["mode"] == "delta"), (k, info, launches)
        assert [r.to_annotations() for r in got] == [r.to_annotations() for r in want]
        enc_k, enc_p = (s.scheduler._delta._st.enc for s in sims)
        for obj_k, obj_p in ((enc_k.arrays, enc_p.arrays), (enc_k.arrays.rel, enc_p.arrays.rel),
                             (enc_k.state0, enc_p.state0)):
            for f in obj_k.__dataclass_fields__:
                x = getattr(obj_k, f)
                if isinstance(x, torch.Tensor):
                    assert torch.equal(x.cpu(), getattr(obj_p, f)), (k, f)
    assert "delta" in modes, modes


# -- K9: the gang kernels ------------------------------------------------------


def gang_engines(policy, n_pods=300):
    """Gang engines on the card over the relational cluster (carriers of
    required anti-affinity) and the dressed default cluster."""
    rel = engine(policy, n_nodes=40, n_pods=n_pods, config="slice", rel=True).enc
    return [kp.GangScheduler(rel, match_width=8), kp.GangScheduler(default_engine(policy).enc)]


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_gang_kernels_match_plain(card, policy):
    for g in gang_engines(policy):
        g._prep()
        enc, prog, a, w = g.enc, g._base.program, g.enc.arrays, g.weights
        N, C = enc.N, a.pod_claim.shape[1]
        rng = np.random.default_rng(13)
        enc_cpu = enc.to(torch.device("cpu"))
        for k in range(3):
            st = random_state(enc_cpu, rng).to(card)
            rows = torch.as_tensor(rng.permutation(np.asarray(enc.queue))[:64].astype(np.int32),
                                   device=card)
            live = torch.tensor([60], dtype=torch.int32, device=card)
            got = cuda.gang_eval(prog, a, st, w, rows, live, g._order)
            want = cuda.gang_eval_plain(prog, a, st, w, rows, live, g._order)
            assert torch.equal(got[:60], want[:60]), k
            for mw in (4, N):
                vals, idx = cuda.gang_topk(got, live, mw) if mw < N else (got, None)
                pv, pi = cuda.gang_topk_plain(want, live, mw) if mw < N else (want, None)
                if idx is not None:
                    assert torch.equal(vals[:60], pv[:60]) and torch.equal(idx[:60], pi[:60])
                args = (rows, live, g._order, g._claims, g._carrier, N, C, 64)
                sel, stat = cuda.gang_match(vals, idx, *args)
                psel, pstat = cuda.gang_match_plain(pv, pi, *args)
                assert torch.equal(sel, psel) and torch.equal(stat, pstat), (k, mw)
                s1 = cuda.gang_bind(prog, a, st.clone(), rows, live, sel, g._order)
                s2 = cuda.gang_bind_plain(prog, a, st.clone(), rows, live, sel, g._order)
                for f in STATE_FIELDS:
                    assert torch.equal(getattr(s1, f), getattr(s2, f)), (k, mw, f)


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_gang_pass_on_the_card_matches_the_cpu(card, policy):
    """run_recorded() + results() through the K9 kernels (and seq_run's
    preempt phases) against the plain versions on the CPU."""
    for g in gang_engines(policy, n_pods=100):
        cuda.reset_counts()
        got = g.results()
        assert cuda.LAUNCHES["gang_eval"] > 0 and not any(cuda.PLAIN_CALLS.values())
        p = kp.GangScheduler(g.enc.to(torch.device("cpu")), device="cpu",
                             match_width=g.match_width)
        want = p.results()
        assert g._rounds == p._rounds
        for f in STATE_FIELDS:
            assert torch.equal(getattr(g._final_state, f).cpu(), getattr(p._final_state, f)), f
        assert [r.to_annotations() for r in got] == [r.to_annotations() for r in want]


@pytest.mark.parametrize("record", [True, False], ids=["record", "no-record"])
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_sweep_matches_plain(card, policy, record):
    """K11 sweep_run: four weight variants through WeightSweep (one launch)
    against the plain sweep on the CPU; then a launch with fewer blocks than
    variants (the grid-stride walk) against the first."""
    eng = default_engine(policy)
    base = eng.weights.cpu()
    w = torch.stack([base, torch.ones_like(base), base * 3 + 1, base.flip(0)]).numpy()
    sweep = kp.WeightSweep(eng.enc, record=record)
    cuda.reset_counts()
    states, out = sweep.run(w)
    assert cuda.LAUNCHES["sweep_run"] == 1 and not any(cuda.PLAIN_CALLS.values())
    cpu = kp.WeightSweep(eng.enc.to(torch.device("cpu")), record=record, device="cpu")
    want_states, want = cpu.run(w)
    for f in STATE_FIELDS:
        assert torch.equal(getattr(states, f).cpu(), getattr(want_states, f)), f
    outs = out if record else (out,)
    for g, h in zip(outs, want if record else (want,)):
        assert g.dtype == h.dtype and torch.equal(g.cpu(), h)
    enc = sweep.enc
    q = torch.as_tensor(np.asarray(enc.queue, np.int32), device=enc.device)
    wt = torch.as_tensor(w, device=enc.device).to(enc.policy.score)
    s2, out2 = cuda.sweep_run(sweep.sched.program, enc.arrays,
                              cuda.stack_states([enc.state0] * len(w)), q, wt, record=record,
                              grid=2)
    for f in STATE_FIELDS:
        assert torch.equal(getattr(s2, f), getattr(states, f)), f
    for g, h in zip(out2 if record else (out2,), outs):
        assert torch.equal(g, h)


# -- the variant axis: K9 stacked, sweep_run over per-variant segments ---------


def stacked_inputs(g, rng, device, K=24):
    """Three variants' random states (stacked), weights [3, S] and row lists
    [3, K], with live counts K - 4, 0 (a frozen variant) and K."""
    enc = g.enc
    enc_cpu = enc.to(torch.device("cpu"))
    states = cuda.stack_states([random_state(enc_cpu, rng) for _ in range(3)]).to(device)
    w = g.weights
    weights = torch.stack([w, torch.ones_like(w), w * 3 + 1]).contiguous()
    K = min(K, len(enc.queue))
    rows = torch.as_tensor(np.stack([rng.permutation(np.asarray(enc.queue))[:K]
                                     for _ in range(3)]).astype(np.int32), device=device)
    live = torch.tensor([max(0, K - 4), 0, K], dtype=torch.int32, device=device)
    return states, weights, rows, live


def check_stacked_gang(g, rng, device, widths=(3,), counted=False):
    """gang_eval, gang_topk, gang_match and gang_bind at V = 3 (one launch
    each) against their plain versions, which run each variant alone.
    `counted`: the counted matching (gang_match_counted) at 1, 2 and 64
    iterations, its sel also equal to the while-loop matching's. Returns
    the number of comparisons."""
    g._prep()
    enc, prog, a = g.enc, g._base.program, g.enc.arrays
    N, C = enc.N, a.pod_claim.shape[1]
    states, w, rows, live = stacked_inputs(g, rng, device)
    n_live = live.tolist()
    got = cuda.gang_eval(prog, a, states, w, rows, live, g._order)
    want = cuda.gang_eval_plain(prog, a, states, w, rows, live, g._order)
    n = 0
    for v, lv in enumerate(n_live):
        assert torch.equal(got[v, :lv], want[v, :lv]), ("eval", v)
        n += 1
    assert bool((want[0, :n_live[0]] > cuda._neg(want.dtype)).any()), "no feasible row"
    for mw in tuple(x for x in widths if x < N) + (N,):
        if mw < N:
            vals, idx = cuda.gang_topk(got, live, mw)
            pv, pi = cuda.gang_topk_plain(want, live, mw)
            for v, lv in enumerate(n_live):
                assert torch.equal(vals[v, :lv], pv[v, :lv]), ("topk vals", mw, v)
                assert torch.equal(idx[v, :lv], pi[v, :lv]), ("topk idx", mw, v)
                n += 2
        else:
            vals, idx, pv, pi = got, None, want, None
        for carrier in (None, g._carrier):
            for iters in ((1, 2, 64) if counted else (64,)):
                args = (rows, live, g._order, g._claims, carrier, N, C, iters)
                sel, stat = cuda.gang_match(vals, idx, *args, counted=counted)
                psel, pstat = cuda.gang_match_plain(pv, pi, *args, counted=counted)
                assert torch.equal(sel, psel) and torch.equal(stat, pstat), ("match", mw)
                assert stat[1].tolist() == [0, 0], "the frozen variant matched"
                if counted:
                    assert torch.equal(sel, cuda.gang_match_plain(pv, pi, *args)[0]), iters
                n += 1
        s1 = cuda.gang_bind(prog, a, states.clone(), rows, live, sel, g._order)
        s2 = cuda.gang_bind_plain(prog, a, states.clone(), rows, live, sel, g._order)
        for f in STATE_FIELDS:
            assert torch.equal(getattr(s1, f), getattr(s2, f)), ("bind", mw, f)
            assert torch.equal(getattr(s1, f)[1], getattr(states, f)[1]), ("frozen", f)
        n += 1
    return n


def segment_inputs(enc, order, device):
    """Three variants' preempt segments [3, K] (each pending pod list in
    queue order, -1 padded): the whole queue, none at all (every step
    padding) and every other queued pod; their queue positions [3, K]."""
    q = np.asarray(enc.queue, np.int32)
    K = len(q)
    segs = np.full((3, K), -1, np.int32)
    segs[0] = q
    segs[2, :len(q[::2])] = q[::2]
    segs = torch.as_tensor(segs, device=device)
    qpos = torch.where(segs >= 0, order[segs.clamp(min=0).long()], 0).contiguous()
    return segs, qpos


def check_segments(eng, device):
    """sweep_run over per-variant segments with queue positions (the gang
    sweep's preempt phase) against its plain version and against each
    variant's own unpadded seq_run_plain segment. Returns the final
    selections [3, K]."""
    enc, prog, a = eng.enc, eng.program, eng.enc.arrays
    order, _ = kp.GangScheduler(enc, device=enc.device).order_arrays()
    segs, qpos = segment_inputs(enc, order, device)
    w = torch.stack([eng.weights, torch.ones_like(eng.weights), eng.weights * 3 + 1])
    states0 = cuda.stack_states([enc.state0] * 3)
    before = states0.clone()
    s_k, sel_k = cuda.sweep_run(prog, a, states0, segs, w, record=False, qpos=qpos)
    s_p, sel_p = cuda.sweep_run_plain(prog, a, states0, segs, w, record=False, qpos=qpos)
    assert torch.equal(sel_k, sel_p), "segment selections"
    for f in STATE_FIELDS:
        assert torch.equal(getattr(s_k, f), getattr(s_p, f)), f
        assert torch.equal(getattr(states0, f), getattr(before, f)), ("left as it was", f)
    for v in range(3):
        n = int((segs[v] >= 0).sum())
        st, sel = cuda.seq_run_plain(prog, a, enc.state0, segs[v, :n].contiguous(), w[v],
                                     record=False, qpos=qpos[v, :n].contiguous())
        assert torch.equal(sel_k[v, :n], sel) and bool((sel_k[v, n:] == -1).all()), v
        for f in STATE_FIELDS:
            assert torch.equal(getattr(s_k, f)[v], getattr(st, f)), (v, f)
    return sel_k


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_stacked_gang_kernels_match_plain(card, policy):
    for g in gang_engines(policy):
        cuda.reset_counts()
        assert check_stacked_gang(g, np.random.default_rng(17), card, widths=(4,)) > 0
        assert not any(cuda.PLAIN_CALLS[k] for k in ("gang_eval", "gang_topk", "gang_match",
                                                      "gang_bind"))


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_segmented_sweep_matches_plain(card, policy):
    eng = default_engine(policy)
    cuda.reset_counts()
    sel = check_segments(eng, card)
    assert cuda.LAUNCHES["sweep_run"] == 1
    assert bool((sel[0] >= 0).any()) and bool((sel[1] == -1).all())


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_gang_sweep_on_the_card_matches_the_cpu(card, policy):
    """GangSweep of three variants on the dressed default cluster: each
    round one launch of each K9 kernel, each phase one sweep_run launch;
    assignments, rounds and the sweep's counts equal the CPU's."""
    eng = default_engine(policy)
    base = eng.weights.cpu()
    w = torch.stack([base, torch.ones_like(base), base * 3 + 1]).numpy()
    sweep = kp.GangSweep(eng.enc, chunk=16)
    cuda.reset_counts()
    asg, rounds = sweep.run(w)
    st = sweep.last_stats
    assert cuda.LAUNCHES["gang_eval"] == cuda.LAUNCHES["gang_match"] == st["host_syncs"] - st[
        "phases"]
    assert cuda.LAUNCHES["sweep_run"] == st["phases"] and not any(cuda.PLAIN_CALLS.values())
    cpu = kp.GangSweep(eng.enc.to(torch.device("cpu")), chunk=16, device="cpu")
    want, want_rounds = cpu.run(w)
    assert torch.equal(asg.cpu(), want) and torch.equal(rounds.cpu(), want_rounds)
    assert cpu.last_stats == st


# -- the tenant axis: K11 batch.seq.run / batch.gang.run ------------------------


def scaled_pods(pods, f):
    """The pods with every pending pod's CPU request scaled by f (a tenant's
    own values at its neighbours' shapes, as the reference's batch-plane
    tests vary their tenants)."""
    out = copy.deepcopy(pods)
    for pd in out:
        if pd["spec"].get("nodeName"):
            continue
        for c in pd["spec"].get("containers", []):
            req = (c.get("resources") or {}).get("requests") or {}
            if "cpu" in req:
                req["cpu"] = f"{max(1, round(parse_quantity(req['cpu']).milli * f))}m"
    return out


def tenant_encodings(policy, device, kind="default", B=3, seed=3, size=(48, 200)):
    """B tenants' encodings on `device` with equal shapes and their own
    values: tenant b's pending CPU requests scaled by 1 + b / 4. "default":
    the whole default profile on `dressed_default_cluster(*size)`; "rel":
    `affinity_config()` on the relational cluster of that size (carriers)."""
    objects = {}
    if kind == "default":
        nodes, pods, objects = kp.synth.dressed_default_cluster(*size, seed=seed)
        cfg = kp.supported_config()
    else:
        nodes, pods = rel_cluster(seed, *size)
        cfg = kp.affinity_config()
        objects = {"namespaces": NAMESPACES}
    return [kp.encode_cluster(nodes, scaled_pods(pods, 1 + b / 4), cfg,
                              policy=POLICIES[policy], device=device, **objects)
            for b in range(B)]


def check_batch_run(encs, device, record):
    """batch_run over B tenants (the last one's queue all padding, each at
    its own weights) against batch_run_plain, and each tenant's slice
    against its own seq_run_plain. Returns the final selections [B, Q]."""
    engs = [kp.BatchedScheduler(e, device=device) for e in encs]
    progs, arrays = [e.program for e in engs], [e.enc.arrays for e in engs]
    q = np.stack([e.padded_queue() for e in engs])
    q[-1] = -1
    q = torch.as_tensor(q, device=device)
    w0 = engs[0].weights
    w = torch.stack([w0, torch.ones_like(w0), w0 * 3 + 1][:len(engs)]).contiguous()
    states0 = cuda.stack_states([e.enc.state0 for e in engs])
    before = states0.clone()
    s_k, out_k = cuda.batch_run(progs, arrays, states0, q, w, record=record)
    s_p, out_p = cuda.batch_run_plain(progs, arrays, states0, q, w, record=record)
    for f in STATE_FIELDS:
        assert torch.equal(getattr(s_k, f), getattr(s_p, f)), f
        assert torch.equal(getattr(states0, f), getattr(before, f)), ("left as it was", f)
    for i, (g, h) in enumerate(zip(out_k if record else (out_k,), out_p if record else (out_p,))):
        assert g.dtype == h.dtype and torch.equal(g, h), i
    st, tr = cuda.seq_run_plain(progs[1], arrays[1], encs[1].state0, q[1], w[1], record=record)
    for f in STATE_FIELDS:
        assert torch.equal(getattr(s_k, f)[1], getattr(st, f)), ("tenant 1", f)
    for f in STATE_FIELDS:
        assert torch.equal(getattr(s_k, f)[-1], getattr(encs[-1].state0, f)), ("idle", f)
    sel = out_k[4] if record else out_k
    if record and engs[0].preempts:
        sel = out_k[cuda.TRACE_SLOTS_PREEMPT.index("final_sel")]
    return sel


def check_batch_seg(encs, device):
    """batch_seg (the tenants' preempt phases) over per-tenant segments —
    tenant 0 its whole queue, tenant 1 none (every step padding), tenant 2
    every other queued pod — at their queue positions, against
    batch_seg_plain. Returns the bound selections [3, K]."""
    gangs = [kp.GangScheduler(e, device=device) for e in encs]
    t = _TenantRounds(gangs)
    q = t._queue
    segs = torch.full_like(q, -1)
    segs[0] = q[0]
    n2 = int((q[2] >= 0).sum())
    every_other = q[2, :n2:2]
    segs[2, :len(every_other)] = every_other
    qpos = torch.where(segs >= 0, t._orders.gather(1, segs.clamp(min=0).long()), 0).contiguous()
    w = torch.stack([g.weights for g in gangs]).contiguous()
    states0 = cuda.stack_states([e.state0 for e in encs])
    s_k, sel_k = cuda.batch_seg(t._progs, t._arrays, states0, segs, w, qpos)
    s_p, sel_p = cuda.batch_seg_plain(t._progs, t._arrays, states0, segs, w, qpos)
    assert torch.equal(sel_k, sel_p), "segment selections"
    for f in STATE_FIELDS:
        assert torch.equal(getattr(s_k, f), getattr(s_p, f)), f
        assert torch.equal(getattr(s_k, f)[1], getattr(encs[1].state0, f)), ("idle", f)
    return sel_k


def check_batch_gang(encs, rng, device, widths=(3,), counted=False, **opts):
    """batch_eval, gang_topk, batch_match and batch_bind over B = 3 tenants
    at random states (live counts K - 4, 0 and K), each tenant with its own
    planes, order, claims and carriers, against their plain versions.
    `counted`: the counted matching (batch_match_counted) at 1, 2 and 64
    iterations, its sel also the while-loop matching's. Returns the number
    of comparisons."""
    gangs = [kp.GangScheduler(e, device=device, **opts) for e in encs]
    t = _TenantRounds(gangs)
    N, C = t.enc.N, t.enc.arrays.pod_claim.shape[1]
    cpu = torch.device("cpu")
    states = cuda.stack_states([random_state(e.to(cpu), rng) for e in encs]).to(device)
    w0 = gangs[0].weights
    weights = torch.stack([w0, torch.ones_like(w0), w0 * 3 + 1]).contiguous()
    K = min(24, t._queue.shape[1])
    rows = torch.as_tensor(np.stack([rng.permutation(np.asarray(e.queue))[:K] for e in encs])
                           .astype(np.int32), device=device)
    live = torch.tensor([max(0, K - 4), 0, K], dtype=torch.int32, device=device)
    n_live = live.tolist()
    got = cuda.batch_eval(t._progs, t._arrays, states, weights, rows, live, t._orders)
    want = cuda.batch_eval_plain(t._progs, t._arrays, states, weights, rows, live, t._orders)
    n = 0
    for b, lv in enumerate(n_live):
        assert torch.equal(got[b, :lv], want[b, :lv]), ("eval", b)
        n += 1
    assert bool((want[0, :n_live[0]] > cuda._neg(want.dtype)).any()), "no feasible row"
    for mw in tuple(x for x in widths if x < N) + (N,):
        if mw < N:
            vals, idx = cuda.gang_topk(got, live, mw)
            pv, pi = cuda.gang_topk_plain(want, live, mw)
        else:
            vals, idx, pv, pi = got, None, want, None
        for carriers in (None, t._carriers):
            for iters in ((1, 2, 64) if counted else (64,)):
                args = (rows, live, t._orders, t._claims, carriers, N, C, iters)
                sel, stat = cuda.batch_match(vals, idx, *args, counted=counted)
                psel, pstat = cuda.batch_match_plain(pv, pi, *args, counted=counted)
                assert torch.equal(sel, psel) and torch.equal(stat, pstat), ("match", mw)
                assert stat[1].tolist() == [0, 0], "the idle tenant matched"
                if counted:
                    assert torch.equal(sel, cuda.batch_match_plain(pv, pi, *args)[0]), iters
                n += 1
        s1 = cuda.batch_bind(t._progs, t._arrays, states.clone(), rows, live, sel, t._orders)
        s2 = cuda.batch_bind_plain(t._progs, t._arrays, states.clone(), rows, live, sel,
                                   t._orders)
        for f in STATE_FIELDS:
            assert torch.equal(getattr(s1, f), getattr(s2, f)), ("bind", mw, f)
            assert torch.equal(getattr(s1, f)[1], getattr(states, f)[1]), ("idle", f)
        n += 1
    return n


def check_batch_fixpoint(encs, device, plain=contextlib.nullcontext, **opts):
    """A whole batched gang pass (`batch_fixpoint`) against each tenant's
    solo GangScheduler.run() on the CPU's plain versions (inside `plain()`):
    state and rounds. Returns the tenants' rounds."""
    got = batch_fixpoint([kp.GangScheduler(e, device=device, **opts) for e in encs])
    rounds = []
    for e, (st, r) in zip(encs, got):
        with plain():
            solo = kp.GangScheduler(e.to(torch.device("cpu")), device="cpu", **opts)
            want, want_r = solo.run()
        assert r == want_r, (r, want_r)
        for f in STATE_FIELDS:
            assert torch.equal(getattr(st, f).cpu(), getattr(want, f)), f
        rounds.append(r)
    return rounds


@pytest.mark.parametrize("record", [True, False], ids=["record", "no-record"])
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_batch_run_matches_plain(card, policy, record):
    cuda.reset_counts()
    sel = check_batch_run(tenant_encodings(policy, card), card, record)
    assert cuda.LAUNCHES["batch_run"] == 1 and not any(cuda.PLAIN_CALLS.values())
    assert bool((sel[0] >= 0).any()) and bool((sel[-1] == -1).all())


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_batch_seg_matches_plain(card, policy):
    cuda.reset_counts()
    sel = check_batch_seg(tenant_encodings(policy, card), card)
    assert cuda.LAUNCHES["batch_seg"] == 1
    assert bool((sel[0] >= 0).any()) and bool((sel[1] == -1).all())


@pytest.mark.parametrize("kind", ["default", "rel"])
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_batch_gang_kernels_match_plain(card, policy, kind):
    cuda.reset_counts()
    opts = {"match_width": 8} if kind == "rel" else {}
    assert check_batch_gang(tenant_encodings(policy, card, kind), np.random.default_rng(23),
                            card, widths=(4,), **opts) > 0
    assert not any(cuda.PLAIN_CALLS[k] for k in ("batch_eval", "batch_match", "batch_bind"))


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_batch_fixpoint_on_the_card_matches_solo(card, policy):
    encs = tenant_encodings(policy, card)
    cuda.reset_counts()
    rounds = check_batch_fixpoint(encs, card, chunk=16)
    assert cuda.LAUNCHES["batch_eval"] > 0 and cuda.LAUNCHES["batch_seg"] > 0
    assert len(rounds) == 3


def test_concurrent_windows_of_different_keys(card):
    """Two windows of different keys launching at once from two threads, as
    two leaders of the batch plane do (a sequential window's `run_batch`, a
    gang window's `batch_fixpoint` on other shapes), each several times:
    every launch gives what the same window gives alone."""
    import threading

    from kube_scheduler_simulator_tpu_torch.engine.engine import run_batch

    seq_encs = tenant_encodings("i32", card)
    gang_encs = tenant_encodings("i32", card, "rel", size=(24, 60))

    def seq():
        return run_batch([kp.BatchedScheduler(e, device=card) for e in seq_encs])

    def gang():
        return batch_fixpoint([kp.GangScheduler(e, device=card, chunk=16) for e in gang_encs])

    def same(got, want):
        for (s, x), (ws, wx) in zip(got, want):
            for f in STATE_FIELDS:
                assert torch.equal(getattr(s, f), getattr(ws, f)), f
            for a, b in zip(*((x, wx) if isinstance(x, tuple) else ((x,), (wx,)))):
                assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b

    want = {seq: seq(), gang: gang()}
    cuda.reset_counts()
    errors = []
    barrier = threading.Barrier(2)

    def loop(fn):
        try:
            barrier.wait(timeout=60)
            for _ in range(6):
                same(fn(), want[fn])
        except Exception as e:  # noqa: BLE001 — surfaced by the assert
            errors.append(repr(e))

    threads = [threading.Thread(target=loop, args=(fn,)) for fn in (seq, gang)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors, errors
    assert cuda.LAUNCHES["batch_run"] == 6 and cuda.LAUNCHES["batch_eval"] >= 6
    assert not any(cuda.PLAIN_CALLS.values())


# -- the fault sweep (lifecycle/faultsweep.py, K11 `faultsweep.*`) --------------


def fault_cluster():
    """The default profile over 8 nodes in zones a (3 nodes), b (2), c (2)
    and d (n7 alone). Bound: a `web` pod on every node, `db` on n7 with a
    ReadWriteOncePod claim and an inline EBS disk. Pending: four `web` pods
    under a hard zone spread (maxSkew 1) — while n7 stands, zone d holds the
    minimum; when it fails its domain leaves the count — `db2` on the same
    claim and `ebs` on the same disk. Returns (nodes, pods, objects)."""
    nodes = [{"metadata": {"name": f"n{i}", "labels": {HOST: f"n{i}", ZONE: z}}, "spec": {},
              "status": {"allocatable": {"cpu": "4", "memory": "8Gi", "pods": "110"}}}
             for i, z in enumerate("aaabbccd")]
    spread = [{"maxSkew": 1, "topologyKey": ZONE, "whenUnsatisfiable": "DoNotSchedule",
               "labelSelector": {"matchLabels": {"app": "web"}}}]
    claim = [{"name": "data", "persistentVolumeClaim": {"claimName": "claim-0"}}]
    disk = [{"name": "ebs", "awsElasticBlockStore": {"volumeID": "vol-1"}}]

    def pod(name, labels=None, node=None, **spec):
        spec["containers"] = [{"name": "c", "resources": {"requests": {"cpu": "1",
                                                                       "memory": "128Mi"}}}]
        if node:
            spec["nodeName"] = node
        return {"metadata": {"name": name, "namespace": "default", "labels": labels or {}},
                "spec": spec}

    web = {"app": "web"}
    pods = ([pod(f"web-{i}", web, f"n{i}") for i in range(8)]
            + [pod("db", node="n7", volumes=claim + disk)]
            + [pod(f"web-{i}", web, topologySpreadConstraints=spread) for i in range(8, 12)]
            + [pod("db2", volumes=claim), pod("ebs", volumes=disk)])
    objects = {
        "pvcs": [{"metadata": {"name": "claim-0", "namespace": "default"},
                  "spec": {"volumeName": "pv-0", "accessModes": ["ReadWriteOncePod"],
                           "resources": {"requests": {"storage": "1Gi"}}}}],
        "pvs": [{"metadata": {"name": "pv-0"},
                 "spec": {"capacity": {"storage": "10Gi"},
                          "accessModes": ["ReadWriteOncePod"]}}],
        "storageclasses": [],
    }
    return nodes, pods, objects


def fault_masks(enc, S, seed, p=0.3):
    """S failure masks of enc's real nodes: scenario 0 none failed, 1 all of
    them, the others each node at p."""
    m = np.random.default_rng(seed).random((S, enc.N)) < p
    m[0], m[1] = False, True
    return torch.as_tensor(m, device=enc.device) & enc.arrays.node_mask[None, :]


def check_fault_kernels(enc, rng, device, S=5, K=8, widths=(3,)):
    """fault_evict of S scenarios of one random baseline state against
    fault_evict_plain; one gang round of every scenario through the tenant
    forms over the scenario table (each scenario its own node mask row)
    against the plain tenant forms over each scenario's own arrays, at
    every match width; fault_tally at the round's end against
    fault_tally_plain. Returns the pods evicted."""
    g = kp.GangScheduler(enc, device=device)
    g._prep()
    prog, a, N, C = g._base.program, enc.arrays, enc.N, enc.arrays.pod_claim.shape[1]
    base = random_state(enc.to(torch.device("cpu")), rng).to(device)
    fail = fault_masks(enc, S, int(rng.integers(1 << 30)))
    states = cuda.stack_states([base] * S)
    plain = states.clone()
    ev, n, masks = cuda.fault_evict(prog, a, states, fail)
    ev_p, n_p, masks_p = cuda.fault_evict_plain(prog, a, plain, fail)
    assert torch.equal(ev, ev_p) and torch.equal(n, n_p) and torch.equal(masks, masks_p)
    for f in STATE_FIELDS:
        assert torch.equal(getattr(states, f), getattr(plain, f)), ("evict", f)
    assert int(n[0]) == 0 and torch.equal(ev[1], base.assignment >= 0)
    t = _ScenarioRounds(g, masks)
    w = g.weights[None].expand(S, -1).contiguous()
    rows, count = t._pending(states, sort=True)
    rows = rows[:, :K].contiguous()
    live = count.clamp(max=K)
    got = cuda.batch_eval(t._progs, t._arrays, states, w, rows, live, t._orders, table=t._table)
    want = cuda.batch_eval_plain(t._progs, t._arrays, states, w, rows, live, t._orders)
    for s, lv in enumerate(live.tolist()):
        assert torch.equal(got[s, :lv], want[s, :lv]), ("eval", s)
    assert bool((got[1, :int(live[1])] == cuda._neg(got.dtype)).all()), "a failed node fits"
    for mw in tuple(x for x in widths if x < N) + (N,):
        vals, idx = cuda.gang_topk(got, live, mw) if mw < N else (got, None)
        pv, pi = cuda.gang_topk_plain(want, live, mw) if mw < N else (want, None)
        args = (rows, live, t._orders, t._claims, t._carriers, N, C, 64)
        sel, stat = cuda.batch_match(vals, idx, *args)
        psel, pstat = cuda.batch_match_plain(pv, pi, *args)
        assert torch.equal(sel, psel) and torch.equal(stat, pstat), ("match", mw)
        s1 = cuda.batch_bind(t._progs, t._arrays, states.clone(), rows, live, sel, t._orders,
                             table=t._table)
        s2 = cuda.batch_bind_plain(t._progs, t._arrays, states.clone(), rows, live, sel,
                                   t._orders)
        for f in STATE_FIELDS:
            assert torch.equal(getattr(s1, f), getattr(s2, f)), ("bind", mw, f)
        re, st = cuda.fault_tally(s1.assignment, ev, n)
        re_p, st_p = cuda.fault_tally_plain(s1.assignment, ev, n)
        assert torch.equal(re, re_p) and torch.equal(st, st_p), ("tally", mw)
        assert torch.equal(re + st, n)
    return int(n.sum())


def check_fault_sweep(nodes, pods, objects, cfg, device, plain=contextlib.nullcontext, S=5,
                      **opts):
    """A whole FaultSweep on `device` against the same sweep on the CPU's
    plain versions (inside `plain()`): baseline state, profile, every
    scenario's final state. Returns the profile."""
    sw = kp.FaultSweep.from_cluster(nodes, pods, cfg, device=device, **objects, **opts)
    masks = sw.sample_masks(S, seed=5, fail_prob=0.3)
    got = sw.run(masks)
    with plain():
        ref = kp.FaultSweep.from_cluster(nodes, pods, cfg, device="cpu", **objects, **opts)
        want = ref.run(masks.cpu())
    for f in STATE_FIELDS:
        assert torch.equal(getattr(sw._state_bound, f).cpu(), getattr(ref._state_bound, f)), f
        assert torch.equal(getattr(sw._states, f).cpu(), getattr(ref._states, f)), f
    for k, x in want.items():
        assert (np.array_equal(got[k], x) if k == "assignments" else got[k] == x), k
    return got


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_fault_kernels_match_plain(card, policy):
    cuda.reset_counts()
    rng = np.random.default_rng(31)
    assert check_fault_kernels(default_engine(policy).enc, rng, card, S=6, K=24) > 0
    rel = engine(policy, n_nodes=40, n_pods=200, config="slice", rel=True).enc
    assert check_fault_kernels(rel, rng, card, S=6, K=24, widths=(8,)) > 0
    assert cuda.LAUNCHES["fault_evict"] == 2 and not any(cuda.PLAIN_CALLS.values())


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_fault_sweep_on_the_card_matches_the_cpu(card, policy):
    nodes, pods, objects = fault_cluster()
    cuda.reset_counts()
    got = check_fault_sweep(nodes, pods, objects, kp.supported_config(), card,
                            policy=POLICIES[policy])
    assert got["totals"]["evicted"] > 0
    assert cuda.LAUNCHES["fault_evict"] == 1 and cuda.LAUNCHES["batch_eval"] > 0


# -- the counted loops: gang_match's counted form, gang_advance ----------------


def check_advance(rng, device, V=7, P=20):
    """gang_advance against its plain version over random round accounting
    (some variants done, window index past the last window, pending counts
    from 0), without a window and with one of 3 rows, four slots in turn.
    Returns the number of comparisons."""
    n = 0
    for wp in (0, 3):
        acc = torch.zeros((len(cuda.ADVANCE_ROWS), V), dtype=torch.int32)
        acc[1] = torch.as_tensor(rng.integers(0, 9, V))
        acc[2] = torch.as_tensor(rng.random(V) < 0.25)
        acc[3] = torch.as_tensor(rng.integers(0, P + 1, V))
        acc, plain = acc.to(device), acc.clone().to(device)
        for _ in range(4):
            committed = torch.as_tensor(rng.integers(0, 3, V), device=device).minimum(acc[3])
            stat = torch.stack([committed, acc[5]], dim=1).to(torch.int32).contiguous()
            cuda.gang_advance(stat, acc, wp, P)
            cuda.gang_advance_plain(stat, plain, wp, P)
            assert torch.equal(acc, plain), (wp, acc, plain)
            n += 1
    return n


def check_counted_pass(enc, device, plain=contextlib.nullcontext, **opts):
    """A counted GangScheduler pass (`loop="static"`; records replayed) on
    `device` against the same on the CPU's plain versions (inside
    `plain()`): state, rounds, readbacks and records. Returns the engine on
    `device`."""
    g = kp.GangScheduler(enc, device=device, loop="static", **opts)
    got = g.results()
    with plain():
        p = kp.GangScheduler(enc.to(torch.device("cpu")), device="cpu", loop="static", **opts)
        want = p.results()
    assert g._rounds == p._rounds and g.last_stats == p.last_stats
    for f in STATE_FIELDS:
        assert torch.equal(getattr(g._final_state, f).cpu(), getattr(p._final_state, f)), f
    assert [r.to_annotations() for r in got] == [r.to_annotations() for r in want]
    return g


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_counted_kernels_match_plain(card, policy):
    """gang_match's counted form, stacked and TEN, and gang_advance against
    their plain versions."""
    cuda.reset_counts()
    rng = np.random.default_rng(41)
    for g in gang_engines(policy):
        assert check_stacked_gang(g, rng, card, widths=(4,), counted=True) > 0
    encs = tenant_encodings(policy, card)
    assert check_batch_gang(encs, rng, card, counted=True) > 0
    assert check_advance(rng, card) == 8
    assert cuda.LAUNCHES["gang_match_counted"] > 0 and cuda.LAUNCHES["batch_match_counted"] > 0
    assert cuda.LAUNCHES["gang_advance"] == 8 and not any(cuda.PLAIN_CALLS.values())


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_counted_passes_on_the_card_match_the_cpu(card, policy):
    """A counted GangScheduler (the default cluster's preempt phases, the
    relational cluster's carriers in a window) and a counted FaultSweep on
    the card against the CPU."""
    cuda.reset_counts()
    g = check_counted_pass(default_engine(policy).enc, card, static_rounds=3)  # it resumes
    assert g.last_stats["phases"] > 0
    rel = engine(policy, n_nodes=40, n_pods=100, config="slice", rel=True).enc
    check_counted_pass(rel, card, match_width=8, chunk=16, eval_window=16, inner_loop="dynamic")
    nodes, pods, objects = fault_cluster()
    check_fault_sweep(nodes, pods, objects, kp.supported_config(), card,
                      policy=POLICIES[policy], loop="static")
    assert cuda.LAUNCHES["gang_advance"] > 0 and cuda.LAUNCHES["batch_match_counted"] > 0
    assert cuda.LAUNCHES["gang_match_counted"] > 0 and not cuda.LAUNCHES["batch_match"]
