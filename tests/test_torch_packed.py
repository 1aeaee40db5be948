"""The PACKED dtype policy (``KSS_DTYPE_POLICY=packed``) of the port against
the reference package's, and against the port's own TPU32.

* Primitives: the port's bit packing, its narrowing rule and the plain
  version of K8 (`cuda.pack_widen_plain`) against the reference's
  `pack_bits_np`, `unpack_bits` and `narrow_int_np`, words with bit 31 set
  among them.
* Encodings: the port's PACKED `encode_cluster` against the reference's,
  leaf for leaf (dtype, shape, bits; the reference's uint32 words are the
  port's int32 with the same bits) with equal `packed_dims`, on an affinity
  cluster and on a small default cluster whose `pod_claim` bit-packs; and
  `from_reference_arrays` of the reference's PACKED encoding against the
  port's own.
* Passes: the sequential pass (trace, state, placements, records) and the
  gang pass (dynamic and `loop="static"`) of the JAX engine and the port
  under PACKED, the sequential pass also against the port's TPU32 pass.
  The reference's own tests pin its PACKED runs to its TPU32 runs, so the
  weight sweep, the gang sweep, a batch window and a fault sweep run the
  port's PACKED against the port's TPU32 with no JAX compile, on the small
  default cluster whose `pod_claim` and `pair_present` bit-pack.
* Serving: the delta encoder under PACKED equals a full PACKED encode after
  every pass, a row that overflows a narrowed plane falls back
  (`packed-overflow`), a policy flip falls back (`dtype-policy-change`) and
  counts in `encodePolicyMisses`; the compile signature keys the policy and
  the logical lane counts; the bf16 score lane is the identity on [0, 256].

Each reference program is compiled once (the gang clusters and options are
the reference's own PACKED tests', so a warm compile cache shares them).
Tolerance: exact equality.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_scheduler_simulator_tpu.engine import BatchedScheduler as JBatchedScheduler
from kube_scheduler_simulator_tpu.engine.encode import PACKED as J_PACKED
from kube_scheduler_simulator_tpu.engine.encode import encode_cluster as j_encode_cluster
from kube_scheduler_simulator_tpu.engine.gang import GangScheduler as JGang
from kube_scheduler_simulator_tpu.engine.packing import narrow_int_np as j_narrow
from kube_scheduler_simulator_tpu.engine.packing import pack_bits_np as j_pack
from kube_scheduler_simulator_tpu.engine.packing import unpack_bits as j_unpack
from kube_scheduler_simulator_tpu.sched.config import SchedulerConfiguration as JConfig

import kube_scheduler_simulator_tpu_torch as kp
from kube_scheduler_simulator_tpu_torch.engine import cuda, packing, scatter
from kube_scheduler_simulator_tpu_torch.engine.delta import DeltaEncoder
from kube_scheduler_simulator_tpu_torch.engine.encode import ClusterArrays, SchedState
from kube_scheduler_simulator_tpu_torch.engine.encode_rel import PodRelArrays
from kube_scheduler_simulator_tpu_torch.engine.engine import run_batch
from kube_scheduler_simulator_tpu_torch.engine.gang import batch_fixpoint
from kube_scheduler_simulator_tpu_torch.models.store import ResourceStore
from kube_scheduler_simulator_tpu_torch.sched.config import SchedulerConfiguration as PConfig
from kube_scheduler_simulator_tpu_torch.server.service import SimulatorService
from kube_scheduler_simulator_tpu_torch.utils.metrics import render_prometheus

from helpers import node, pod
from test_torch_clusters import claim_cluster
from test_torch_delta import TEMPLATES, assert_port_equal, from_template, full_encode
from test_torch_preempt import assert_full_engines_agree

CPU = torch.device("cpu")
CLUSTERS = {
    "affinity": lambda: kp.synthetic_affinity_cluster(32, 96, seed=5) + ({},),
    "claims": claim_cluster,
}


def encode_pair(nodes, pods, objects, policy=kp.PACKED):
    """(the reference's PACKED encoding, the port's under `policy`)."""
    cfg = kp.supported_config().to_dict()
    j_enc = j_encode_cluster(nodes, pods, JConfig.from_dict(cfg), policy=J_PACKED, **objects)
    p_enc = kp.encode_cluster(nodes, pods, PConfig.from_dict(cfg), policy=policy, device=CPU,
                              **objects)
    return j_enc, p_enc


def array_leaves(a):
    """(name, leaf) of every tensor of cluster planes, the nested ones too."""
    for cls, obj in ((ClusterArrays, a), (PodRelArrays, a.rel)):
        for f in dataclasses.fields(cls):
            if f.name != "rel":
                yield f.name, getattr(obj, f.name)


def leaves(enc):
    """(name, leaf) of every tensor of an encoding's planes and state."""
    yield from array_leaves(enc.arrays)
    for f in dataclasses.fields(SchedState):
        yield f.name, getattr(enc.state0, f.name)


def assert_packed_leaves_equal(ref, got):
    """The port's leaves equal the reference's: the same dtype (uint32
    words as int32 with the same bits), shape and bits."""
    for (name, w), (name2, g) in zip(leaves(ref), leaves(got), strict=True):
        assert name == name2
        w, g = np.asarray(w), g.numpy()
        if w.dtype == np.uint32:
            assert g.dtype == np.int32, name
            g = g.view(np.uint32)
        assert g.dtype == w.dtype and g.shape == w.shape, (name, g.dtype, w.dtype)
        assert np.array_equal(g, w), name


# -- primitives ---------------------------------------------------------------


@pytest.mark.parametrize("shape", [(3, 8), (5, 33), (2, 4, 40), (7, 64)])
def test_bit_packing_matches_reference(shape):
    rng = np.random.default_rng(sum(shape))
    m = rng.random(shape) < 0.5
    words = packing.pack_bits_np(m)
    assert words.dtype == np.uint32 and np.array_equal(words, j_pack(m))
    assert np.array_equal(packing.unpack_bits_np(words, shape[-1]), m)
    # random words: bit 31 and the tail word's padding bits set in many
    w = rng.integers(0, 2**32, words.shape, dtype=np.uint64).astype(np.uint32)
    w[..., -1] |= np.uint32(1 << 31)
    want = np.asarray(j_unpack(jnp.asarray(w), shape[-1]))
    t = torch.from_numpy(w.view(np.int32))
    assert bool((t < 0).any())
    got = cuda.pack_widen_plain([t], [shape[-1]])[0]
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)
    assert np.array_equal(packing.unpack_bits_np(w.view(np.int32), shape[-1]), want)


def test_narrow_rule_matches_reference():
    cases = [[-3, 0], [0, 127], [0, 128], [-128, 5], [-129, 5], [0, 32767], [0, 32768],
             [-32768, 1], [-32769, 1], []]
    for v in cases:
        for enum8 in (False, True):
            a = np.asarray(v, np.int32)
            got, want = packing.narrow_int_np(a, enum8=enum8), j_narrow(a, enum8=enum8)
            assert got.dtype == want.dtype and np.array_equal(got, want), (v, enum8)
    assert packing.narrow_int_np(np.zeros(0, np.int32)).dtype == np.int16
    assert packing.narrow_int_np(np.zeros(0, np.int32), enum8=True).dtype == np.int8
    assert packing.rows_fit([np.array([-128, 127])], torch.int8)
    assert not packing.rows_fit([np.array([300])], torch.int8)
    assert not packing.rows_fit([np.array([-32769])], torch.int16)


# -- encodings ----------------------------------------------------------------


@pytest.mark.parametrize("cluster", sorted(CLUSTERS))
def test_packed_encoding_matches_reference(cluster):
    nodes, pods, objects = CLUSTERS[cluster]()
    j_enc, p_enc = encode_pair(nodes, pods, objects)
    pd = p_enc.aux["packed_dims"]
    assert pd == j_enc.aux["packed_dims"]
    assert "pair_present" in pd and (cluster != "claims" or pd["pod_claim"] >= 8)
    assert_packed_leaves_equal(j_enc, p_enc)
    assert any(t.dtype == torch.int8 for _, t in leaves(p_enc))
    wide = kp.encode_cluster(nodes, pods, kp.supported_config(), device=CPU, **objects)
    assert (packing.encoded_device_bytes(p_enc)["arrays"]
            < packing.encoded_device_bytes(wide)["arrays"])
    # the reference's PACKED leaves carried across equal the port's own
    arrays = {f.name: np.asarray(getattr(j_enc.arrays, f.name))
              for f in dataclasses.fields(j_enc.arrays) if f.name != "rel"}
    arrays["rel"] = {f.name: np.asarray(getattr(j_enc.arrays.rel, f.name))
                     for f in dataclasses.fields(j_enc.arrays.rel)}
    state = {f.name: np.asarray(getattr(j_enc.state0, f.name))
             for f in dataclasses.fields(j_enc.state0)}
    meta = {"node_names": j_enc.node_names, "pod_keys": j_enc.pod_keys,
            "resource_names": j_enc.resource_names, "policy": "packed",
            "packed_dims": j_enc.aux["packed_dims"], "config": j_enc.config.to_dict()}
    got = kp.from_reference_arrays(arrays, state, j_enc.queue, meta, device=CPU)
    assert got.policy is kp.PACKED and got.aux["packed_dims"] == pd
    for (name, g), (_, w) in zip(leaves(got), leaves(p_enc), strict=True):
        assert g.dtype == w.dtype and torch.equal(g, w), name


# -- passes against the JAX engine -------------------------------------------

SEQ_CLUSTERS = {
    "affinity": lambda: kp.synthetic_affinity_cluster(24, 72, seed=9) + ({},),
    "claims": claim_cluster,
}


@pytest.mark.parametrize("cluster", sorted(SEQ_CLUSTERS))
def test_packed_pass_matches_reference_and_tpu32(cluster):
    nodes, pods, objects = SEQ_CLUSTERS[cluster]()
    j_enc, p_enc = encode_pair(nodes, pods, objects)
    cuda.reset_counts()
    p_eng = kp.BatchedScheduler(p_enc, device=CPU)
    assert_full_engines_agree(JBatchedScheduler(j_enc), p_eng)
    assert cuda.PLAIN_CALLS["pack_widen"] >= 1
    wide = kp.BatchedScheduler(kp.encode_cluster(nodes, pods, kp.supported_config(),
                                                 device=CPU, **objects), device=CPU)
    w_state, w_trace = wide.run()
    for g, w in zip(p_eng._trace, w_trace, strict=True):
        assert g.dtype == w.dtype and torch.equal(g, w)
    for f in dataclasses.fields(SchedState):
        assert torch.equal(getattr(p_eng._final_state, f.name), getattr(w_state, f.name))
    assert p_eng.results() and [r.to_annotations() for r in p_eng.results()] == [
        r.to_annotations() for r in wide.results()]


@pytest.mark.parametrize("loop", ["dynamic", "static"])
def test_packed_gang_matches_reference_and_tpu32(loop):
    nodes, pods = kp.synthetic_affinity_cluster(16, 48, seed=13)
    j_enc, p_enc = encode_pair(nodes, pods, {})
    j = JGang(j_enc, chunk=16, loop=loop)
    j_state, j_rounds = j.run()
    p = kp.GangScheduler(p_enc, chunk=16, loop=loop, device=CPU)
    p_state, p_rounds = p.run()
    assert p_rounds == int(np.asarray(j_rounds))
    for f in dataclasses.fields(SchedState):
        want = np.asarray(getattr(j_state, f.name))
        assert np.array_equal(getattr(p_state, f.name).numpy(), want), f.name
    assert p.placements() == j.placements() and p._a is None


# -- the other paths, port against port ---------------------------------------


def both_policies(nodes, pods, objects=None, cfg=None):
    cfg = cfg or kp.supported_config()
    return [kp.encode_cluster(nodes, pods, cfg, policy=pol, device=CPU, **(objects or {}))
            for pol in (kp.TPU32, kp.PACKED)]


def test_logical_dims_read_lanes_not_words():
    """The claim cluster (`pod_claim` 11 lanes in one word, `pair_present` 16
    lanes in one word): the gang's claim count and the delta encoder's label
    rows read the lane counts (`packing.logical_dim`), not the stored word
    counts (`test_packed_paths_match_tpu32[batch]` holds the tenant form's)."""
    nodes, pods, objects = claim_cluster()
    wide, packed = both_policies(nodes, pods, objects)
    assert tuple(packed.arrays.pod_claim.shape) == (packed.P, 1)
    assert tuple(packed.arrays.rel.pair_present.shape) == (packed.P, 1)
    assert packing.logical_dim(packed, "pod_claim") == wide.arrays.pod_claim.shape[1] >= 8
    assert packing.logical_dim(packed, "pair_present") == wide.arrays.rel.pair_present.shape[1]
    runs = []
    for enc in (wide, packed):
        g = kp.GangScheduler(enc, chunk=16, device=CPU)
        g.run()
        runs.append(g.placements())
    assert runs[0] == runs[1]
    # a labelled arrival through the delta encoder under PACKED
    store = ResourceStore()
    for n in nodes:
        store.apply("nodes", n)
    for p in pods:
        store.apply("pods", p)
    for kind in ("pvcs", "pvs", "storageclasses"):
        for obj in objects[kind]:
            store.apply(kind, obj)
    delta = DeltaEncoder(policy=kp.PACKED, device=CPU)
    cfg = kp.supported_config()
    assert delta.encode(store, cfg)[1]["mode"] == "full"
    assert delta._st.enc.arrays.rel.pair_present.shape[1] == 1
    labelled = from_template(TEMPLATES[2], "late")
    labelled["metadata"]["labels"] = dict(pods[0]["metadata"].get("labels") or {"app": "x"})
    store.apply("pods", labelled)
    enc, info = delta.encode(store, cfg)
    assert info["mode"] == "delta", info
    assert_port_equal(enc, full_encode(store, cfg, kp.PACKED))


@pytest.mark.parametrize("kind", ["weight", "gang", "batch", "fault"])
def test_packed_paths_match_tpu32(kind):
    """A 2-variant `WeightSweep`, a 2-variant `GangSweep` and one batch
    window (the sequential and the gang tenant forms) with PACKED tenants on
    the claim cluster, and a 4-scenario `FaultSweep` of an affinity cluster:
    each equal to the same run under TPU32."""
    nodes, pods, objects = claim_cluster()
    out = []
    cuda.reset_counts()
    for enc in both_policies(nodes, pods, objects):
        if kind == "weight":
            w = np.stack([kp.weights_for(enc, {}), kp.weights_for(enc, {}) * 2])
            states, sels = kp.WeightSweep(enc, device=CPU).run(w)
            out.append((sels, states.assignment))
        elif kind == "gang":
            w = np.stack([kp.weights_for(enc, {}), kp.weights_for(enc, {}) + 1])
            asg, rounds = kp.GangSweep(enc, chunk=16, device=CPU).run(w)
            out.append((asg, rounds))
        elif kind == "batch":
            engines = [kp.BatchedScheduler(enc, device=CPU) for _ in range(2)]
            engines[1].weights = engines[1].weights * 2
            res = run_batch(engines)
            gangs = [kp.GangScheduler(enc, chunk=16, device=CPU) for _ in range(2)]
            gangs[1].weights = gangs[1].weights + 1
            g_res = batch_fixpoint(gangs)
            out.append(tuple(x[0].assignment for x in res) + tuple(x[1] for x in res)
                       + tuple(x[0].assignment for x in g_res))
        else:
            # the fit profile over the affinity cluster, whose label pairs bit-pack
            f_nodes, f_pods = kp.synthetic_affinity_cluster(32, 96, seed=5)
            fs = kp.FaultSweep.from_cluster(f_nodes, f_pods, kp.fit_config(), policy=enc.policy,
                                            device=CPU)
            prof = fs.run(fs.sample_masks(4, seed=1, fail_prob=0.25))
            out.append((torch.as_tensor(prof.pop("assignments")), prof))
    for g, w in zip(out[1], out[0], strict=True):
        if isinstance(g, torch.Tensor):
            assert g.dtype == w.dtype and torch.equal(g, w)
        elif isinstance(g, tuple):
            for x, y in zip(g, w, strict=True):
                assert torch.equal(x, y)
        else:
            assert g == w
    assert cuda.PLAIN_CALLS["pack_widen"] >= 1


# -- serving --------------------------------------------------------------------


def test_packed_delta_replays_templates_and_falls_back():
    """Arrivals from every delta template and write-back binds: each PACKED
    delta pass equals a full PACKED encode (the int16 planes' rows and the
    bit-packed label words go through the K10 set); a pod with more
    containers of a node's image than int8 holds overflows `pod_img`
    (`packed-overflow`); a policy flip re-encodes (`dtype-policy-change`)."""
    store = ResourceStore()
    cfg = PConfig.default()
    for i in range(5):
        store.apply("nodes", node(f"n{i}", cpu="8", mem="16Gi", labels={
            "zone": "a" if i % 2 else "b", "kubernetes.io/hostname": f"n{i}"},
            images=[{"names": ["registry/app:1"], "sizeBytes": 300 << 20}]))
    for j, t in enumerate(TEMPLATES * 2):  # 10 pods: the 16-pod bucket holds the arrivals
        store.apply("pods", from_template(t, f"{t['metadata']['name']}-seed{j}"))
    delta = DeltaEncoder(policy=kp.PACKED, device=CPU)
    assert delta.encode(store, cfg)[1]["mode"] == "full"
    assert delta._st.enc.arrays.pod_img.dtype == torch.int8
    for k, t in enumerate(TEMPLATES):
        store.apply("pods", from_template(t, f"a{k}"))
        if k % 3 == 0:
            store.apply("pods", {"metadata": {"name": f"a{k}"}, "spec": {"nodeName": f"n{k % 5}"}})
        scatter.reset_counts()
        enc, info = delta.encode(store, cfg)
        assert info["mode"] == "delta", (k, info)
        assert scatter.PLAIN_CALLS["delta_scatter_set"] > 0
        assert_port_equal(delta._st.enc, full_encode(store, cfg, kp.PACKED), k)
    big = from_template(TEMPLATES[0], "many-containers")
    big["spec"]["containers"] = [{"name": f"c{j}", "image": "registry/app:1"}
                                 for j in range(130)]
    store.apply("pods", big)
    assert delta.encode(store, cfg)[1] == {"mode": "full", "reason": "packed-overflow"}
    assert delta._st.enc.arrays.pod_img.dtype == torch.int16  # the full encode widened it
    store.apply("pods", {"metadata": {"name": "plain-seed0"}, "spec": {"nodeName": "n1"}})
    assert delta.encode(store, cfg)[1]["mode"] == "delta"
    delta.policy = kp.TPU32
    assert delta.encode(store, cfg)[1] == {"mode": "full", "reason": "dtype-policy-change"}


def test_policy_flip_counts_one_miss(monkeypatch):
    sim = SimulatorService(device=CPU)
    sim.import_({"nodes": [node(f"n{i}", cpu="4") for i in range(4)],
                 "pods": [pod(f"b{j}", cpu="500m", node_name=f"n{j % 4}") for j in range(12)]
                 + [pod(f"p{j}", cpu="500m") for j in range(2)]})
    monkeypatch.setenv("KSS_DTYPE_POLICY", "packed")
    placed = {r.pod_name: r.selected_node for r in sim.scheduler.schedule()}
    sim.store.apply("pods", pod("q0", cpu="500m"))
    sim.scheduler.schedule()
    assert sim.scheduler.last_encode_info["mode"] == "delta"
    monkeypatch.setenv("KSS_DTYPE_POLICY", "i32")
    sim.store.apply("pods", pod("q1", cpu="500m"))
    sim.scheduler.schedule()
    assert sim.scheduler.last_encode_info == {"mode": "full", "reason": "dtype-policy-change"}
    phases = sim.scheduler.metrics.phases()
    assert phases["encodePolicyMisses"] == 1 and len(placed) == 2 and all(placed.values())
    assert "kss_encode_policy_misses_total 1\n" in render_prometheus(sim.scheduler.metrics)


def test_compile_signature_and_bf16_lane():
    nodes, pods = kp.synthetic_affinity_cluster(32, 96, seed=5)
    wide, packed = both_policies(nodes, pods)
    sig_w, sig_p = (kp.BatchedScheduler.compile_signature(e) for e in (wide, packed))
    assert sig_w != sig_p
    pd = tuple(sorted(packed.aux["packed_dims"].items()))
    assert pd and pd in sig_p and kp.GangScheduler.compile_signature(packed)[-1] == pd
    # the logical lane count keys the signature: 9 lanes and 16 lanes are one word each
    other = kp.encode_cluster(nodes, pods, kp.supported_config(), policy=kp.PACKED, device=CPU)
    other.aux = {**other.aux, "packed_dims": {**other.aux["packed_dims"], "pair_present": 31}}
    assert kp.BatchedScheduler.compile_signature(other) != sig_p
    # the bf16 score lane: the identity on [0, 256], every other value rides through
    v = torch.arange(-300, 300, dtype=torch.int32)
    assert torch.equal(cuda.bf16_lane(v), v)
    assert not torch.equal(v[(v > 256)].to(torch.bfloat16).to(torch.int32), v[v > 256])
    assert kp.BatchedScheduler(packed, device=CPU).program.bf16_lane
    assert not kp.BatchedScheduler(wide, device=CPU).program.bf16_lane


def test_widen_is_idempotent_and_never_reaches_the_kernels_planes():
    nodes, pods, objects = claim_cluster()
    wide, packed = both_policies(nodes, pods, objects)
    cuda.reset_counts()
    a = packing.widen(packed)
    assert cuda.PLAIN_CALLS["pack_widen"] == 1
    assert packing.widen(a, packed.aux["packed_dims"]) is a and packing.widen(wide) is wide.arrays
    assert cuda.PLAIN_CALLS["pack_widen"] == 1
    for (name, g), (_, w) in zip(array_leaves(a), array_leaves(wide.arrays), strict=True):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    # the kernels' plane check refuses a packed or narrow plane
    eng = kp.BatchedScheduler(packed, device=CPU)
    with pytest.raises(ValueError, match="pod_claim|int16|int8"):
        cuda._check_tensor("pod_claim", packed.arrays.pod_claim, {}, CPU, torch.int32)
    with pytest.raises(ValueError, match="int16|int8"):
        cuda._check_tensor("taint_key", packed.arrays.taint_key, {}, CPU, torch.int32)
    assert eng.program.bf16_lane
