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
with a leading variant axis (the gang weight sweep, `GangSweep`).
"""

import numpy as np
import pytest
import torch

import kube_scheduler_simulator_tpu_torch as kp
from kube_scheduler_simulator_tpu_torch.engine import cuda

from test_torch_clusters import NAMESPACES, rel_cluster

pytestmark = pytest.mark.cuda

STATE_FIELDS = ("requested", "s_requested", "n_pods", "assignment", "used_pair",
                "used_wild", "used_trip", "used_claims", "node_disk_any", "node_disk_rw",
                "node_vol3", "bound_seq")
POLICIES = {"exact": kp.EXACT, "i32": kp.TPU32}
CONFIGS = {"fit": kp.fit_config, "slice": kp.affinity_config}

# K10 (engine/scatter.py): random retained planes of every dtype the delta
# encoder scatters into, rows of rank 0 to 3 and a zero-width plane
K10_DTYPES = (torch.bool, torch.int32, torch.int64)
K10_ROW_SHAPES = ((), (3,), (2, 5), (2, 3, 4), (0,))


def k10_cases(seed=0, P=300, k=64):
    """(label, plane, set indices, set rows, add indices, add rows, vector)
    on the CPU. Set indices are distinct; add indices repeat (several rows
    into one node); int32 values sit at the type's edges, so sums wrap.
    Bool planes have no add (None)."""
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
            if dtype != torch.bool:
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
    assert check_k10(card, scatter) == 35
    # a zero-width plane launches nothing: 3 dtypes x 4 shapes of set, 2 x 4
    # of add and vec
    assert scatter.LAUNCHES == {"delta_scatter_set": 12, "delta_scatter_add": 8,
                                "delta_vec_add": 8}
    assert not any(scatter.PLAIN_CALLS.values())


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


def check_stacked_gang(g, rng, device, widths=(3,)):
    """gang_eval, gang_topk, gang_match and gang_bind at V = 3 (one launch
    each) against their plain versions, which run each variant alone.
    Returns the number of comparisons."""
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
            args = (rows, live, g._order, g._claims, carrier, N, C, 64)
            sel, stat = cuda.gang_match(vals, idx, *args)
            psel, pstat = cuda.gang_match_plain(pv, pi, *args)
            assert torch.equal(sel, psel) and torch.equal(stat, pstat), ("match", mw)
            assert stat[1].tolist() == [0, 0], "the frozen variant matched"
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
