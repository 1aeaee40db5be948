"""The port's DeltaEncoder against the reference package's, and the K10
plain versions against the reference's scatter programs.

Each case drives one seeded event script into a reference store and a port
store at once (the reference's delta cases, rebuilt without its lifecycle
engine), and after every step runs the reference's `DeltaEncoder` and the
port's, under EXACT and TPU32. Both must take the same path (mode, reason,
appended/rebound/touched counts), ship the same `last_transfer_bytes`, and
the port's retained encoding must equal both the port's from-scratch
encode of the same store (leaf by leaf, at the same capacity buckets) and
the reference's retained encoding. Tolerance: exact equality.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_scheduler_simulator_tpu.engine.delta import DeltaEncoder as JDelta
from kube_scheduler_simulator_tpu.engine.encode import EXACT as J_EXACT
from kube_scheduler_simulator_tpu.engine.encode import TPU32 as J_TPU32
from kube_scheduler_simulator_tpu.models.store import ResourceStore as JStore
from kube_scheduler_simulator_tpu.sched.config import SchedulerConfiguration as JConfig

import kube_scheduler_simulator_tpu_torch as kp
from kube_scheduler_simulator_tpu_torch.engine import scatter
from kube_scheduler_simulator_tpu_torch.engine.delta import DeltaEncoder
from kube_scheduler_simulator_tpu_torch.engine.encode import ClusterArrays, SchedState
from kube_scheduler_simulator_tpu_torch.engine.encode_rel import PodRelArrays
from kube_scheduler_simulator_tpu_torch.models.store import ResourceStore
from kube_scheduler_simulator_tpu_torch.sched.config import SchedulerConfiguration as PConfig
from kube_scheduler_simulator_tpu_torch.utils.compilecache import capacity_buckets

from helpers import node, pod
from test_torch_encode import assert_encodings_equal

POLICIES = {"exact": (J_EXACT, kp.EXACT), "i32": (J_TPU32, kp.TPU32)}


def full_encode(store, config, policy):
    """The port's from-scratch encode of a store, at the delta encoder's
    capacity buckets."""
    nodes, pods = store.list("nodes"), store.list("pods")
    ncap, pcap = capacity_buckets(len(nodes), len(pods))
    return kp.encode_cluster(
        nodes, pods, config, policy=policy,
        priorityclasses=store.list("priorityclasses"), namespaces=store.list("namespaces"),
        pvcs=store.list("pvcs"), pvs=store.list("pvs"),
        storageclasses=store.list("storageclasses"),
        node_capacity=ncap, pod_capacity=pcap, device="cpu",
    )


def assert_port_equal(got, want, ctx=""):
    for cls, g, w in ((ClusterArrays, got.arrays, want.arrays),
                      (PodRelArrays, got.arrays.rel, want.arrays.rel),
                      (SchedState, got.state0, want.state0)):
        for f in dataclasses.fields(cls):
            if f.name == "rel":
                continue
            gx, wx = getattr(g, f.name), getattr(w, f.name)
            assert gx.dtype == wx.dtype and gx.shape == wx.shape, (f.name, ctx)
            assert torch.equal(gx, wx), (f.name, ctx)
    assert np.array_equal(np.asarray(got.queue), np.asarray(want.queue)), ctx
    assert got.node_names == want.node_names, ctx
    assert got.pod_keys == want.pod_keys, ctx
    assert got.pods == want.pods, ctx
    assert got.resource_names == want.resource_names, ctx
    assert (got.n_nodes, got.n_pods) == (want.n_nodes, want.n_pods), ctx


class Pair:
    """A reference store and a port store fed the same operations, each
    with its delta encoder and configuration."""

    def __init__(self, policy, event_log_capacity=100_000, **delta_kw):
        jpol, ppol = POLICIES[policy]
        self.j_store = JStore(event_log_capacity=event_log_capacity)
        self.p_store = ResourceStore(event_log_capacity=event_log_capacity)
        self.j_delta = JDelta(policy=jpol, **delta_kw)
        self.p_delta = DeltaEncoder(policy=ppol, device="cpu", **delta_kw)
        self.j_cfg, self.p_cfg = JConfig.default(), PConfig.default()
        self.infos = []

    def __getattr__(self, method):
        if method not in ("apply", "replace", "delete"):
            raise AttributeError(method)

        def both(*args):
            getattr(self.j_store, method)(*args)
            getattr(self.p_store, method)(*args)

        return both

    def swap_config(self):
        self.j_cfg, self.p_cfg = JConfig.default(), PConfig.default()

    def check(self, ctx=""):
        j_enc, j_info = self.j_delta.encode(self.j_store, self.j_cfg)
        scatter.reset_counts()
        p_enc, p_info = self.p_delta.encode(self.p_store, self.p_cfg)
        assert p_info == j_info, ctx
        assert self.p_delta.last_transfer_bytes == self.j_delta.last_transfer_bytes, (
            ctx, p_info)
        if p_info["mode"] == "delta":
            assert sum(scatter.PLAIN_CALLS.values()) > 0, ctx
        else:
            assert sum(scatter.PLAIN_CALLS.values()) == 0, ctx
        assert (p_enc is None) == (j_enc is None), ctx
        st = self.p_delta._st
        assert (st is None) == (self.j_delta._st is None), ctx
        if st is not None:
            if p_enc is not None:
                assert st.enc is p_enc
            assert_port_equal(st.enc, full_encode(self.p_store, self.p_cfg, self.p_delta.policy),
                              ctx)
            assert_encodings_equal(self.j_delta._st.enc, st.enc)
        self.infos.append(p_info)
        return p_info


@pytest.fixture(params=sorted(POLICIES))
def policy(request):
    return request.param


def test_pure_arrival_churn_stays_incremental(policy):
    s = Pair(policy)
    for i in range(4):
        s.apply("nodes", node(f"n{i}", cpu="16"))
    for i in range(17):
        s.apply("pods", pod(f"seed-{i}", cpu="100m", node_name=f"n{i % 4}"))
    s.apply("pods", pod("seed-pending", cpu="100m"))
    assert s.check("warmup")["mode"] == "full"
    modes = []
    for i in range(8):
        s.apply("pods", pod(f"churn-{i}", cpu="100m"))
        modes.append(s.check(f"arrival {i}")["mode"])
        s.apply("pods", {"metadata": {"name": f"churn-{i}"}, "spec": {"nodeName": f"n{i % 4}"}})
        modes.append(s.check(f"bind {i}")["mode"])
    assert set(modes) == {"delta"}, modes


def test_unbind_via_replace_is_incremental(policy):
    s = Pair(policy)
    s.apply("nodes", node("n0"))
    s.apply("pods", pod("a", node_name="n0"))
    s.apply("pods", pod("b"))
    s.check("warm")
    a = s.p_store.get("pods", "a")
    a["spec"].pop("nodeName")
    a.pop("status", None)
    s.replace("pods", a)
    assert s.check("unbind")["mode"] == "delta"


def test_transient_readd_appends_in_store_order(policy):
    s = Pair(policy)
    s.apply("nodes", node("n0", cpu="16"))
    s.apply("pods", pod("seed"))
    s.check("warm")
    s.apply("pods", pod("a"))
    s.apply("pods", pod("b"))
    s.delete("pods", "a")
    s.apply("pods", pod("a"))
    assert s.check("transient re-add")["mode"] == "delta"
    assert s.p_delta._st.enc.pod_keys[-2:] == [("default", "b"), ("default", "a")]


def test_stale_rv_falls_back_to_full(policy):
    s = Pair(policy, event_log_capacity=8)
    s.apply("nodes", node("n0"))
    s.apply("pods", pod("p0"))
    s.check("warm")
    for i in range(32):
        s.apply("pods", pod(f"flood-{i}"))
    info = s.check("stale")
    assert info["mode"] == "full" and info["reason"] == "stale-rv"


def test_bucket_crossing_falls_back_and_grows_shapes(policy):
    s = Pair(policy)
    s.apply("nodes", node("n0", cpu="64", pods="200"))
    for i in range(7):
        s.apply("pods", pod(f"p{i}"))
    s.check("warm")
    assert s.p_delta._st.enc.P == 8
    s.apply("pods", pod("p7"))
    assert s.check("fills bucket")["mode"] == "delta"
    s.apply("pods", pod("p8"))
    info = s.check("crossing")
    assert info["mode"] == "full" and "bucket" in info["reason"]
    assert s.p_delta._st.enc.P == 16


def test_config_identity_change_falls_back(policy):
    s = Pair(policy)
    s.apply("nodes", node("n0"))
    s.apply("pods", pod("p0"))
    s.check("warm")
    s.apply("pods", pod("p1"))
    s.swap_config()  # equal value, new identity
    info = s.check("config swap")
    assert info["mode"] == "full" and info["reason"] == "config-change"
    assert s.check("again")["mode"] == "cached"


@pytest.mark.parametrize(
    "manifest, why",
    [
        (pod("novel-label", labels={"brand-new-key": "x"}), "label vocab"),
        (pod("novel-res") | {"spec": {"containers": [{"name": "c", "resources": {
            "requests": {"example.com/fpga": "1"}}}]}}, "resource vocab"),
        (pod("claims", volumes=[{"name": "v", "persistentVolumeClaim": {
            "claimName": "c0"}}]), "pvc pod"),
        (pod("affine", affinity={"podAffinity": {
            "requiredDuringSchedulingIgnoredDuringExecution": [{
                "topologyKey": "kubernetes.io/hostname",
                "labelSelector": {"matchLabels": {"app": "web"}}}]}}),
         "inter-pod affinity"),
    ],
    ids=["label-vocab", "resource-vocab", "pvc-pod", "inter-pod-affinity"],
)
def test_ineligible_pods_fall_back_but_stay_exact(manifest, why, policy):
    s = Pair(policy)
    s.apply("nodes", node("n0", labels={"kubernetes.io/hostname": "n0"}))
    s.apply("pods", pod("p0"))
    s.check("warm")
    s.apply("pods", manifest)
    assert s.check(why)["mode"] == "full", why


def test_taint_flap_and_node_delete_fall_back(policy):
    s = Pair(policy)
    for i in range(2):
        s.apply("nodes", node(f"n{i}"))
    s.apply("pods", pod("p0"))
    s.check("warm")
    s.apply("nodes", {"metadata": {"name": "n1"},
                      "spec": {"taints": [{"key": "k", "effect": "NoSchedule"}]}})
    assert s.check("taint")["mode"] == "full"
    s.apply("pods", pod("p1"))
    assert s.check("arrival")["mode"] == "delta"
    s.delete("nodes", "n1")
    assert s.check("node delete")["mode"] == "full"


def test_cordon_uncordon_is_incremental(policy):
    s = Pair(policy)
    for i in range(2):
        s.apply("nodes", node(f"n{i}"))
    s.apply("pods", pod("p0"))
    s.check("warm")
    s.apply("nodes", {"metadata": {"name": "n1"}, "spec": {"unschedulable": True}})
    assert s.check("cordon")["mode"] == "delta"
    s.apply("nodes", {"metadata": {"name": "n1"}, "spec": {"unschedulable": False}})
    assert s.check("uncordon")["mode"] == "delta"


def test_dirty_fraction_threshold_falls_back(policy):
    s = Pair(policy, max_dirty_frac=0.25)
    for i in range(2):
        s.apply("nodes", node(f"n{i}", cpu="64", pods="200"))
    for i in range(20):
        s.apply("pods", pod(f"p{i}"))
    s.check("warm")
    for i in range(12):
        s.apply("pods", {"metadata": {"name": f"p{i}"}, "spec": {"nodeName": "n0"}})
    info = s.check("bulk rebind")
    assert info["mode"] == "full" and "dirty fraction" in info["reason"]


def test_priorityclass_event_falls_back(policy):
    s = Pair(policy)
    s.apply("nodes", node("n0"))
    s.apply("pods", pod("p0"))
    s.check("warm")
    s.apply("priorityclasses", {"metadata": {"name": "high"}, "value": 1000})
    info = s.check("pc event")
    assert info["mode"] == "full" and "priorityclasses" in info["reason"]


# The reference's delta templates: every append field gets a row.
TEMPLATES = [
    {"metadata": {"name": "plain"}, "spec": {"containers": [
        {"name": "c", "resources": {"requests": {"cpu": "100m", "memory": "64Mi"}}}]}},
    {"metadata": {"name": "tol"}, "spec": {
        "tolerations": [{"key": "flaky", "operator": "Exists", "effect": "NoSchedule"}],
        "containers": [{"name": "c", "resources": {"requests": {"cpu": "50m"}}}]}},
    {"metadata": {"name": "lab", "labels": {"app": "web", "tier": "fe"}}, "spec": {
        "containers": [{"name": "c", "resources": {"requests": {"memory": "32Mi"}}}]}},
    {"metadata": {"name": "sel"}, "spec": {
        "nodeSelector": {"zone": "a"},
        "containers": [{"name": "c", "resources": {"requests": {"cpu": "25m"}}}]}},
    {"metadata": {"name": "spread", "labels": {"app": "web"}}, "spec": {
        "topologySpreadConstraints": [{
            "maxSkew": 1, "topologyKey": "kubernetes.io/hostname",
            "whenUnsatisfiable": "DoNotSchedule",
            "labelSelector": {"matchLabels": {"app": "web"}}}],
        "containers": [{"name": "c", "resources": {"requests": {"cpu": "10m"}}}]}},
]


def from_template(t, name):
    return {"metadata": {**t["metadata"], "name": name}, "spec": dict(t["spec"])}


@pytest.mark.parametrize("seed", [0, 1])
def test_seeded_churn_script(seed, policy):
    """Arrivals from every template, write-back binds, unbinds through
    replace, deletes, cordons and taint flaps, drawn from `seed`; the two
    encoders checked after every batch."""
    rng = np.random.default_rng(seed)
    s = Pair(policy)
    names = [f"n{i}" for i in range(5)]
    for i, n in enumerate(names):
        s.apply("nodes", node(n, cpu="8", mem="16Gi", labels={
            "zone": "a" if i % 2 else "b", "kubernetes.io/hostname": n}))
    for t in TEMPLATES:
        s.apply("pods", from_template(t, t["metadata"]["name"] + "-seed"))
    s.check("warm")
    k = 0
    for step in range(10):
        for _ in range(int(rng.integers(1, 4))):
            s.apply("pods", from_template(TEMPLATES[int(rng.integers(len(TEMPLATES)))], f"a{k}"))
            k += 1
        for p in s.p_store.list("pods"):
            meta = p["metadata"]
            bound = (p.get("spec") or {}).get("nodeName")
            r = rng.random()
            if not bound and r < 0.5:
                s.apply("pods", {"metadata": {"name": meta["name"],
                                              "annotations": {"kss/result": "Scheduled"}},
                                 "spec": {"nodeName": names[int(rng.integers(5))]}})
            elif bound and r < 0.05:
                q = {k2: v for k2, v in p.items() if k2 != "status"}
                q["spec"] = {k2: v for k2, v in p["spec"].items() if k2 != "nodeName"}
                s.replace("pods", q)
        r = rng.random()
        n = names[int(rng.integers(5))]
        if r < 0.3:
            s.apply("nodes", {"metadata": {"name": n},
                              "spec": {"unschedulable": bool(rng.random() < 0.5)}})
        elif r < 0.4:
            s.apply("nodes", {"metadata": {"name": n},
                              "spec": {"taints": [{"key": "flaky", "effect": "NoSchedule"}]}})
        elif r < 0.45:
            victim = s.p_store.list("pods")[int(rng.integers(k))]["metadata"]["name"]
            s.delete("pods", victim)
        s.check(f"step {step}")
    modes = [i["mode"] for i in s.infos]
    assert "delta" in modes and "full" in modes, modes


# -- K10 plain versions against the reference's scatter programs -------------

DTYPES = {"bool": (np.bool_, torch.bool), "i32": (np.int32, torch.int32),
          "i64": (np.int64, torch.int64)}


def random_rows(rng, dt, shape):
    if dt is np.bool_:
        return rng.random(shape) < 0.5
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, shape, dtype=dt, endpoint=True)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("row_shape", [(), (3,), (2, 5), (2, 3, 4), (0,)],
                         ids=["0d", "1d", "2d", "3d", "zero-width"])
def test_scatter_plain_matches_reference(dtype, row_shape):
    np_dt, t_dt = DTYPES[dtype]
    rng = np.random.default_rng(len(row_shape) * 7 + len(dtype))
    P = 37
    arr = random_rows(rng, np_dt, (P, *row_shape))
    k = 19
    idx = rng.choice(P, k, replace=False).astype(np.int32)
    rows = random_rows(rng, np_dt, (k, *row_shape))
    want = np.asarray(jnp.asarray(arr).at[idx].set(jnp.asarray(rows)))
    got = scatter.scatter_set(torch.from_numpy(arr.copy()), torch.from_numpy(idx),
                              torch.from_numpy(rows))
    assert np.array_equal(got.numpy(), want)
    if dtype == "bool":
        return
    # repeated indices sum, int32 wraps
    idx = rng.integers(0, 5, 40).astype(np.int32)
    rows = random_rows(rng, np_dt, (40, *row_shape))
    want = np.asarray(jnp.asarray(arr).at[idx].add(jnp.asarray(rows)))
    got = scatter.scatter_add(torch.from_numpy(arr.copy()), torch.from_numpy(idx),
                              torch.from_numpy(rows))
    assert np.array_equal(got.numpy(), want)
    vec = random_rows(rng, np_dt, arr.shape[1:] or (P,))
    base = arr[0] if row_shape else arr
    want = np.asarray(jnp.asarray(base) + jnp.asarray(vec))
    got = scatter.vec_add(torch.from_numpy(base.copy()), torch.from_numpy(vec))
    assert np.array_equal(got.numpy(), want)


def test_scatter_wrappers_refuse_bad_updates():
    arr = torch.zeros((6, 2), dtype=torch.int32)
    rows = torch.ones((2, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="repeated"):
        scatter.scatter_set(arr, torch.tensor([1, 1], dtype=torch.int32), rows)
    with pytest.raises(ValueError, match="outside"):
        scatter.scatter_add(arr, torch.tensor([0, 6], dtype=torch.int32), rows)
    with pytest.raises(ValueError, match="rows"):
        scatter.scatter_add(arr, torch.tensor([0, 1], dtype=torch.int32), rows.long())
    with pytest.raises(ValueError, match="CUDA"):
        scatter.launch_set(arr, torch.tensor([0, 1], dtype=torch.int32), rows)
    # an empty update changes nothing and launches nothing
    scatter.reset_counts()
    scatter.scatter_set(arr, torch.zeros(0, dtype=torch.int32),
                        torch.zeros((0, 2), dtype=torch.int32))
    assert not arr.any()


def test_inline_disk_arrivals(policy):
    """An arrival mounting a disk the encoding already knows takes the delta
    path (its disk and volume-count rows scatter); a new disk identity
    would grow the disk vocabulary and falls back."""
    s = Pair(policy)
    s.apply("nodes", node("n0", cpu="16"))
    ebs = [{"name": "v", "awsElasticBlockStore": {"volumeID": "vol-1"}}]
    s.apply("pods", pod("p0", node_name="n0", volumes=ebs))
    s.apply("pods", pod("p1"))
    s.check("warm")
    ro = [{"name": "v", "awsElasticBlockStore": {"volumeID": "vol-1", "readOnly": True}}]
    s.apply("pods", pod("known", volumes=ro))
    assert s.check("known disk")["mode"] == "delta"
    s.apply("pods", pod("novel", volumes=[{"name": "v", "gcePersistentDisk": {"pdName": "x"}}]))
    info = s.check("new disk")
    assert info["mode"] == "full" and info["reason"] == "disk vocab would grow", info
