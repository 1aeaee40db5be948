"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA card and the CUDA toolkit (the kernels build at first use);
skipped where `torch.cuda.is_available()` is False. On the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(`--noconftest`: the suite's conftest configures JAX, which the port and
this file do not use). Tolerance: exact equality.
"""

import numpy as np
import pytest
import torch

import kube_scheduler_simulator_tpu_torch as kp
from kube_scheduler_simulator_tpu_torch.engine import cuda

pytestmark = pytest.mark.cuda

STATE_FIELDS = ("requested", "s_requested", "n_pods", "assignment", "bound_seq")
POLICIES = {"exact": kp.EXACT, "i32": kp.TPU32}


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


def engine(policy, n_nodes=40, n_pods=300, seed=0):
    nodes, pods = cluster(n_nodes, n_pods, seed)
    enc = kp.encode_cluster(nodes, pods, kp.slice_config(), policy=POLICIES[policy])
    return kp.BatchedScheduler(enc)


def padded_queue(eng):
    q = eng.enc.queue
    pad = np.full(eng.queue_bucket(len(q)) - len(q), -1)
    return torch.as_tensor(np.concatenate([q, pad]).astype(np.int32), device=eng.device)


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_attempt_and_bind_match_plain(card, policy):
    eng = engine(policy)
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


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("record", [True, False])
def test_run_matches_plain(card, policy, record):
    eng = engine(policy, seed=1)
    enc, q = eng.enc, padded_queue(eng)
    s_k, t_k = cuda.seq_run(eng.program, enc.arrays, enc.state0, q, eng.weights, record=record)
    s_p, t_p = cuda.seq_run_plain(eng.program, enc.arrays, enc.state0, q, eng.weights,
                                  record=record)
    for g, h in zip(t_k if record else [t_k], t_p if record else [t_p]):
        assert g.dtype == h.dtype and torch.equal(g, h)
    for f in STATE_FIELDS:
        assert torch.equal(getattr(s_k, f), getattr(s_p, f)), f


def test_schedule_on_the_card_launches_seq_run(card):
    nodes, pods = cluster(24, 120, seed=2)
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
