"""Incremental (delta) cluster encoding: O(Δ) host work for a steady-state
pass. The reference package's `engine/delta.py` under EXACT and TPU32.

`DeltaEncoder` retains the last pass's `EncodedCluster` (its tensors on the
device) and, on the next pass, replays `ResourceStore.dirty_since(rv)`:
the dirty pod and node rows are re-encoded against the retained
vocabularies and written into the retained tensors in place by the K10
kernels (`engine/scatter.py`: row set, row add, vector add). Capacities
come from `utils/compilecache.capacity_buckets`, so the updated encoding
keeps the retained one's padded shapes.

The contract: for any event sequence, the retained encoding equals a
from-scratch `encode_cluster` of the same store at the same capacities,
leaf for leaf. So the delta path takes only the mutations whose
from-scratch encoding provably reuses the retained vocabularies and dims:

  * pod ADDED — appended at the end of iteration order, where its novel
    strings would intern from scratch too. Its resources, label keys and
    values, port and disk identities and selector clauses must already be
    interned, its term counts must fit the retained dims, it must carry no
    inter-pod affinity and reference no PVCs, and its spread topology keys
    must already be topology keys. Toleration strings may grow their
    vocabulary (no dim depends on its size);
  * pod MODIFIED in `spec.nodeName`, annotations, server stamps or status
    only (the write-back and eviction shapes): binding-state scatters;
  * node MODIFIED in `spec.unschedulable` only (cordon): one element.

Everything else (deletions, node adds, taint flaps, PVC/PV/StorageClass/
PriorityClass/Namespace events, a configuration swap, a stale
resourceVersion, a dirty fraction past the threshold, a capacity-bucket
crossing) raises `_Fallback` inside the attempt, and the pass re-encodes
from scratch, which re-arms the retained state. Only `_Fallback` turns a
delta pass into a full one: a device error inside the attempt propagates.

Aliasing: the retained tensors are updated in place, so an encoding this
encoder returned earlier shares them. The engines the serving layer keeps
`retarget` onto the newest encoding before they run, and every pass clones
`state0` before it changes it (`engine/cuda.py` `seq_run`).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ..models.objects import (
    PodView,
    pod_effective_requests,
    pod_scoring_requests,
    resolve_pod_priority,
    tolerations_tolerate_taint,
)
from ..models.store import ResourceStore, StaleResourceVersion
from ..sched.oracle_plugins import _preferred_terms, _required_terms, resolve_spread_constraints
from ..sched.resources import to_int_resources
from ..utils.compilecache import capacity_buckets
from . import scatter
from .encode import (
    MISSING_NODE,
    NO_NODE,
    TPU32,
    UNSCHED_TAINT,
    EncodedCluster,
    _fill_nsel_rows,
    _fill_pod_image_rows,
    _fill_port_rows,
    _fill_terms,
    _fill_tol_rows,
    _parse_pod_terms,
    encode_cluster,
    resolve_device,
)
from .encode_rel import CL_PAD, _ClauseBuilder, _pack_spread, parse_pod_spread
from .encode_vol import pod_disk_vol_rows
from .packing import encoded_device_bytes, rows_fit

_NP_DTYPES = {torch.bool: np.bool_, torch.int32: np.int32, torch.int64: np.int64}


class _Fallback(Exception):
    """Raised anywhere inside the delta attempt to bail to a full encode."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


class _NoGrow:
    """Vocabulary view whose `intern` refuses new entries: a novel string
    means a from-scratch encode would assign other ids (or grow a padded
    dim), so the delta attempt falls back."""

    __slots__ = ("_v", "_what")

    def __init__(self, vocab, what: str):
        self._v = vocab
        self._what = what

    def intern(self, s: str) -> int:
        i = self._v.get(s)
        if i < 0:
            raise _Fallback(f"{self._what} vocab would grow ({s!r})")
        return i


class _NoGrowClauses:
    """A `_ClauseBuilder`-shaped façade over the retained clause vocabularies."""

    def __init__(self, cb):
        self.key_vocab = _NoGrow(cb.key_vocab, "selector key")
        self._pair = _NoGrow(cb.pair_vocab, "selector pair")

    def pair_id(self, k: str, v: str) -> int:
        return self._pair.intern(f"{k}\x00{v}")

    def compile(self, selector):
        return _ClauseBuilder.compile(self, selector)


def _host_rows(arr: torch.Tensor, idx: list, rows: list):
    """The dirty rows as CPU tensors in the target's dtype: the host's int64
    rows cast with numpy's wraparound, as the reference's `jnp.asarray`."""
    return (torch.from_numpy(np.asarray(idx, np.int32)),
            torch.from_numpy(np.ascontiguousarray(np.stack(rows).astype(_NP_DTYPES[arr.dtype]))))


def _apply_set(arr: torch.Tensor, idx: list, rows: list) -> None:
    scatter.scatter_set(arr, *_host_rows(arr, idx, rows))


def _apply_add(arr: torch.Tensor, idx: list, rows: list) -> None:
    scatter.scatter_add(arr, *_host_rows(arr, idx, rows))


# -- manifest diff classification -------------------------------------------


def _strip_pod(p: dict) -> dict:
    """A pod manifest minus what the delta path absorbs without re-encoding
    its rows: binding, result annotations, server stamps, status."""
    q = copy.deepcopy(p)
    meta = q.get("metadata") or {}
    for f in ("resourceVersion", "uid", "annotations"):
        meta.pop(f, None)
    q.pop("status", None)
    spec = q.get("spec")
    if isinstance(spec, dict):
        spec.pop("nodeName", None)
        if not spec:
            q.pop("spec", None)
    return q


def _strip_node(n: dict) -> dict:
    """A node manifest minus server stamps and `spec.unschedulable`; a spec
    left empty is dropped (a cordon merge materialises `spec` on nodes that
    had none, a difference no encoder reads)."""
    q = copy.deepcopy(n)
    meta = q.get("metadata") or {}
    for f in ("resourceVersion", "uid", "annotations"):
        meta.pop(f, None)
    spec = q.get("spec")
    if isinstance(spec, dict):
        spec.pop("unschedulable", None)
        if not spec:
            q.pop("spec", None)
    return q


_MIRRORED = (
    "pod_req", "pod_sreq", "want_pair", "want_wild", "want_trip",
    "pod_claim", "pod_disk_any", "pod_disk_rw", "pod_vol3",
    "pod_node_name", "pod_priority",
)


class _Retained:
    """The delta encoder's carry-over between passes."""

    def __init__(self, enc: EncodedCluster, rv: int, config):
        self.enc = enc
        self.rv = rv
        self.config = config
        self.node_idx = {name: i for i, name in enumerate(enc.node_names)}
        self.pods_by_key = {key: i for i, key in enumerate(enc.pod_keys)}
        self.pcs = {
            (pc.get("metadata", {}) or {}).get("name", ""): pc
            for pc in enc.objects.get("priorityclasses", [])
        }
        # host mirrors of the pod-axis planes the binding math reads, in the
        # tensors' dtypes. Copies: a CPU tensor's numpy() shares its storage,
        # which the in-place scatters write
        a = enc.arrays
        self.m = {name: getattr(a, name).cpu().numpy().copy() for name in _MIRRORED}


class DeltaEncoder:
    """Retains the last encoding and replays store events into it.

    One per (store, configuration at a time) consumer; the `SchedulerService`
    owns one. `encode(store, config)` returns `(enc | None, info)`: None when
    nothing is schedulable (no nodes, no pods or no pending pod);
    `info["mode"]` is ``cached``, ``delta``, ``full`` or ``empty``, with
    `info["reason"]` naming a full pass's trigger. Encodings live on `device`
    (the CUDA card unless the caller names another)."""

    def __init__(
        self,
        *,
        policy=TPU32,
        max_dirty_frac: float = 0.25,
        device: "str | torch.device | None" = None,
    ):
        self.device = resolve_device(device)
        self.policy = policy
        self.max_dirty_frac = max_dirty_frac
        self._st: "_Retained | None" = None
        # host-to-device bytes the last encode() shipped: the whole encoding
        # on a full pass, the dirty rows (and 4 bytes an index) on a delta
        # pass, 0 on cached and empty passes
        self.last_transfer_bytes = 0

    # -- entry point --------------------------------------------------------

    def encode(self, store: ResourceStore, config):
        rv = store.latest_rv()
        self.last_transfer_bytes = 0
        st = self._st
        if st is None:
            return self._full(store, config, rv, "cold-start")
        if st.config is not config:
            return self._full(store, config, rv, "config-change")
        if st.enc.policy is not self.policy:
            return self._full(store, config, rv, "dtype-policy-change")
        if rv == st.rv:
            enc = st.enc
            return (enc if len(enc.queue) else None), {"mode": "cached"}
        try:
            dirty = store.dirty_since(st.rv)
        except StaleResourceVersion:
            return self._full(store, config, rv, "stale-rv")
        try:
            return self._delta(store, st, dirty, rv)
        except _Fallback as f:
            return self._full(store, config, rv, f.reason)

    # -- full (from-scratch) path -------------------------------------------

    def _full(self, store, config, rv, reason: str):
        self._st = None
        nodes = store.list("nodes")
        pods = store.list("pods")
        if not nodes or not pods:
            return None, {"mode": "empty", "reason": reason}
        if not any(not (p.get("spec", {}) or {}).get("nodeName") for p in pods):
            # nothing pending: no encode (retention starts at the first pass
            # that encodes)
            return None, {"mode": "empty", "reason": reason}
        ncap, pcap = capacity_buckets(len(nodes), len(pods))
        enc = encode_cluster(
            nodes,
            pods,
            config,
            policy=self.policy,
            priorityclasses=store.list("priorityclasses"),
            namespaces=store.list("namespaces"),
            pvcs=store.list("pvcs"),
            pvs=store.list("pvs"),
            storageclasses=store.list("storageclasses"),
            node_capacity=ncap,
            pod_capacity=pcap,
            device=self.device,
        )
        self._st = _Retained(enc, rv, config)
        self.last_transfer_bytes = encoded_device_bytes(enc)["total"]
        return enc, {"mode": "full", "reason": reason}

    # -- delta path ----------------------------------------------------------

    def _delta(self, store, st: _Retained, dirty: dict, rv: int):
        enc = st.enc
        # kinds that feed the encoding with no row-update story
        for kind in ("pvcs", "pvs", "storageclasses", "priorityclasses", "namespaces"):
            if dirty.get(kind):
                raise _Fallback(f"{kind} events")
        appends: list[tuple[str, str]] = []
        binding: list[tuple[str, str]] = []
        for key, status in dirty.get("pods", {}).items():
            if status == "TRANSIENT":
                continue
            if status in ("DELETED", "REPLACED"):
                raise _Fallback(f"pod {status.lower()}")
            ns, _, name = key.partition("/")
            if status == "ADDED":
                if (ns, name) in st.pods_by_key:
                    raise _Fallback("pod re-added under a live key")
                appends.append((ns, name))
            else:
                binding.append((ns, name))
        node_mods: list[str] = []
        for key, status in dirty.get("nodes", {}).items():
            if status == "TRANSIENT":
                continue
            if status != "MODIFIED":
                raise _Fallback(f"node {status.lower()}")
            node_mods.append(key)

        dirty_n = len(appends) + len(binding) + len(node_mods)
        if dirty_n == 0:
            # only kinds the encoding does not read moved
            st.rv = rv
            return (enc if len(enc.queue) else None), {"mode": "cached"}
        live = enc.n_pods + enc.n_nodes
        if dirty_n > 4 and dirty_n > self.max_dirty_frac * live:
            raise _Fallback(f"dirty fraction {dirty_n}/{live}")
        if enc.n_pods + len(appends) > enc.P:
            raise _Fallback("pod capacity bucket crossing")

        arr_set: dict = {}  # field -> ([idx], [row])
        st0_set: dict = {}
        st0_add: dict = {}
        claims_delta = np.zeros(enc.state0.used_claims.shape[0], np.int64)
        claims_dirty = False

        def add_set(field, i, row):
            arr_set.setdefault(field, ([], []))[0].append(i)
            arr_set[field][1].append(np.asarray(row))

        def add_st0(table, field, i, row):
            table.setdefault(field, ([], []))[0].append(i)
            table[field][1].append(np.asarray(row))

        # -- node cordon/uncordon ------------------------------------------
        for name in node_mods:
            obj = store.get("nodes", name)
            i = st.node_idx.get(name)
            if obj is None or i is None:
                raise _Fallback("modified node not resolvable")
            old = enc.objects["nodes"][i]
            if _strip_node(old) != _strip_node(obj):
                raise _Fallback("node spec change beyond unschedulable")
            new_u = bool((obj.get("spec") or {}).get("unschedulable"))
            old_u = bool((old.get("spec") or {}).get("unschedulable"))
            enc.objects["nodes"][i] = obj
            if new_u != old_u:
                add_set("node_unsched", i, np.bool_(new_u))

        # -- pod binding transitions ----------------------------------------
        def bind_delta(row_src, sign, tgt):
            add_st0(st0_add, "requested", tgt, sign * row_src["pod_req"])
            add_st0(st0_add, "s_requested", tgt, sign * row_src["pod_sreq"])
            add_st0(st0_add, "n_pods", tgt, np.int64(sign))
            add_st0(st0_add, "used_pair", tgt, sign * row_src["want_pair"])
            add_st0(st0_add, "used_wild", tgt, sign * row_src["want_wild"])
            add_st0(st0_add, "used_trip", tgt, sign * row_src["want_trip"])
            add_st0(st0_add, "node_disk_any", tgt, sign * row_src["pod_disk_any"])
            add_st0(st0_add, "node_disk_rw", tgt, sign * row_src["pod_disk_rw"])
            add_st0(st0_add, "node_vol3", tgt, sign * row_src["pod_vol3"])

        for ns, name in binding:
            i = st.pods_by_key.get((ns, name))
            obj = store.get("pods", name, ns)
            if i is None or obj is None:
                raise _Fallback("modified pod not resolvable")
            old = enc.pods[i]
            if _strip_pod(old) != _strip_pod(obj):
                raise _Fallback("pod spec change beyond binding")
            enc.pods[i] = obj
            node_name = (obj.get("spec") or {}).get("nodeName") or ""
            new_t = st.node_idx.get(node_name, MISSING_NODE) if node_name else NO_NODE
            old_t = int(st.m["pod_node_name"][i])
            if new_t == old_t:
                continue
            row_src = {
                k: st.m[k][i].astype(np.int64)
                for k in (
                    "pod_req", "pod_sreq", "want_pair", "want_wild",
                    "want_trip", "pod_disk_any", "pod_disk_rw", "pod_vol3",
                )
            }
            if old_t >= 0:
                bind_delta(row_src, -1, old_t)
                claims_delta -= st.m["pod_claim"][i].astype(np.int64)
                claims_dirty = claims_dirty or st.m["pod_claim"][i].any()
            if new_t >= 0:
                bind_delta(row_src, +1, new_t)
                claims_delta += st.m["pod_claim"][i].astype(np.int64)
                claims_dirty = claims_dirty or st.m["pod_claim"][i].any()
            add_set("pod_node_name", i, np.int32(new_t))
            add_st0(st0_set, "assignment", i, np.int32(new_t if new_t >= 0 else -1))
            add_st0(st0_set, "bound_seq", i, np.int32(i if new_t >= 0 else -1))
            st.m["pod_node_name"][i] = new_t

        # -- appended pods -----------------------------------------------------
        if appends:
            # claim pods fall back, so appended pods add nothing to used_claims
            self._append_pods(store, st, appends, add_set, add_st0, st0_set, bind_delta)

        # -- apply on the device, in place -------------------------------------
        a = enc.arrays
        rel_fields = set(type(a.rel).__dataclass_fields__)
        xfer = 0

        def row_bytes(arr, idx, rows):
            return (arr.element_size() * int(np.prod(np.shape(rows[0]), dtype=np.int64))
                    + 4) * len(idx)

        for field, (idx, rows) in arr_set.items():
            arr = getattr(a.rel if field in rel_fields else a, field)
            if not rows_fit(rows, arr.dtype):
                # a cast would wrap silently; the full encode re-runs the
                # width rules
                raise _Fallback("packed-overflow")
            xfer += row_bytes(arr, idx, rows)
            _apply_set(arr, idx, rows)
        s0 = enc.state0
        for field, (idx, rows) in st0_add.items():
            arr = getattr(s0, field)
            xfer += row_bytes(arr, idx, rows)
            _apply_add(arr, idx, rows)
        for field, (idx, rows) in st0_set.items():
            arr = getattr(s0, field)
            xfer += row_bytes(arr, idx, rows)
            _apply_set(arr, idx, rows)
        if claims_dirty:
            vec = torch.from_numpy(claims_delta.astype(_NP_DTYPES[s0.used_claims.dtype]))
            scatter.vec_add(s0.used_claims, vec)
            xfer += s0.used_claims.numel() * s0.used_claims.element_size()
        self.last_transfer_bytes = xfer

        # -- the host-side view ------------------------------------------------
        n_pods = enc.n_pods + len(appends)
        pnn = st.m["pod_node_name"]
        prio = st.m["pod_priority"]
        pending = [i for i in range(n_pods) if pnn[i] < 0]
        pending.sort(key=lambda i: (-int(prio[i]), i))
        queue = np.asarray(pending, np.int32)

        # a new encoding object over the same (updated) tensors, so that
        # what is memoised on the old one (its compile signature) stays its own
        new_enc = EncodedCluster(
            a,
            s0,
            node_names=enc.node_names,
            pod_keys=enc.pod_keys,
            pods=enc.pods,
            resource_names=enc.resource_names,
            queue=queue,
            policy=enc.policy,
            config=enc.config,
            n_nodes=enc.n_nodes,
            n_pods=n_pods,
            aux=enc.aux,
        )
        new_enc.objects = enc.objects
        st.enc = new_enc
        st.rv = rv
        info = {
            "mode": "delta",
            "appended": len(appends),
            "rebound": len(binding),
            "nodesTouched": len(node_mods),
        }
        return (new_enc if len(queue) else None), info

    # -- appended-pod rows ----------------------------------------------------

    def _append_pods(self, store, st: _Retained, appends, add_set, add_st0, st0_set,
                     bind_delta):
        enc = st.enc
        a = enc.arrays
        rel = a.rel
        aux = enc.aux
        policy = enc.policy
        res_vocab = aux["res_vocab"]
        R = enc.R
        keys_ng = _NoGrow(aux["label_keys"], "label key")
        vals_ng = _NoGrow(aux["label_vals"], "label value")
        cb_ng = _NoGrowClauses(aux["clause_builder"])
        ns_ng = _NoGrow(aux["ns_vocab"], "namespace")
        kv = aux["taint_vocab"]  # growth allowed: see the module docstring
        spread_args = enc.config.plugin_args("PodTopologySpread")

        for k_off, (ns, name) in enumerate(appends):
            i = enc.n_pods + k_off
            pod = store.get("pods", name, ns)
            if pod is None:
                raise _Fallback("added pod vanished before encode")
            pv = PodView(pod)

            # resources
            ri = to_int_resources(pod_effective_requests(pod))
            si = to_int_resources(pod_scoring_requests(pod))
            req_row = np.zeros(R, np.int64)
            sreq_row = np.zeros(R, np.int64)
            rank_row = np.full(R, R, np.int32)
            for rank, (r, v) in enumerate(ri.items()):
                j = res_vocab.get(r)
                if j < 0:
                    raise _Fallback(f"resource vocab would grow ({r!r})")
                req_row[j] = policy.to_units(r, v, up=True)
                rank_row[j] = rank
            for r, v in si.items():
                j = res_vocab.get(r)
                if j < 0:
                    raise _Fallback(f"resource vocab would grow ({r!r})")
                sreq_row[j] = policy.to_units(r, v, up=True)
            add_set("pod_req", i, req_row)
            add_set("pod_sreq", i, sreq_row)
            add_set("pod_req_rank", i, rank_row)
            add_set("pod_mask", i, np.bool_(True))

            # binding / priority / unschedulable toleration
            tgt = st.node_idx.get(pv.node_name, MISSING_NODE) if pv.node_name else NO_NODE
            add_set("pod_node_name", i, np.int32(tgt))
            priority = resolve_pod_priority(pv, st.pcs)
            if priority:
                add_set("pod_priority", i, np.int32(priority))
            if tolerations_tolerate_taint(pv.tolerations, UNSCHED_TAINT):
                add_set("pod_tol_unsched", i, np.bool_(True))

            # tolerations (vocabulary growth allowed: new ids append at the
            # end, where pod-order interning puts them from scratch)
            L = a.tol_key.shape[1]
            if len(pv.tolerations) > L:
                raise _Fallback("toleration slots exceed retained dim")
            tol = _fill_tol_rows([pv.tolerations], kv, L)
            for f, v in tol.items():
                if not (v[0] == -1).all():
                    add_set(f, i, v[0])

            # nodeSelector / node affinity
            nsel, req_terms, pref_terms = _parse_pod_terms(pv, keys_ng, vals_ng, policy)
            NS = a.nsel_key.shape[1]
            TM, E = a.raff_key.shape[1], a.raff_key.shape[2]
            VV = a.raff_vals.shape[3]
            PR = a.paff_key.shape[1]
            if len(nsel) > NS:
                raise _Fallback("nodeSelector slots exceed retained dim")
            if len(req_terms) > TM or len(pref_terms) > PR:
                raise _Fallback("affinity terms exceed retained dim")
            for terms in (req_terms, [e for _, e in pref_terms]):
                for exprs in terms:
                    if len(exprs) > E or any(len(vv) > VV for _, _, vv, _ in exprs):
                        raise _Fallback("affinity exprs exceed retained dim")
            if nsel:
                nk, nv = _fill_nsel_rows([nsel], 1, NS)
                add_set("nsel_key", i, nk[0])
                add_set("nsel_val", i, nv[0])
            if req_terms:
                rk, ro, rvv, rn, rno, rtv = _fill_terms([req_terms], 1, TM, E, VV)
                add_set("raff_key", i, rk[0])
                add_set("raff_op", i, ro[0])
                add_set("raff_vals", i, rvv[0])
                add_set("raff_num", i, rn[0])
                add_set("raff_num_ok", i, rno[0])
                add_set("raff_term_valid", i, rtv[0])
                add_set("pod_has_raff", i, np.bool_(True))
            if pref_terms:
                pk, po, pvv, pn, pno, ptv = _fill_terms(
                    [[e for _, e in pref_terms]], 1, PR, E, VV
                )
                weight_row = np.zeros(PR, np.int32)
                for j, (w, _) in enumerate(pref_terms):
                    weight_row[j] = w
                add_set("paff_key", i, pk[0])
                add_set("paff_op", i, po[0])
                add_set("paff_vals", i, pvv[0])
                add_set("paff_num", i, pn[0])
                add_set("paff_num_ok", i, pno[0])
                add_set("paff_weight", i, weight_row)
                add_set("paff_term_valid", i, ptv[0])

            # host ports
            Q, V2 = a.want_pair.shape[1], a.want_trip.shape[1]
            port_rows = None
            if pv.host_ports:
                try:
                    ww, wt, wp = _fill_port_rows(
                        [pv.host_ports], aux["port_pair_ids"], aux["port_trip_ids"], Q, V2
                    )
                except KeyError:
                    raise _Fallback("host-port vocab would grow") from None
                port_rows = (ww[0], wt[0], wp[0])
                add_set("want_wild", i, ww[0])
                add_set("want_trip", i, wt[0])
                add_set("want_pair", i, wp[0])

            # images
            I = a.pod_img.shape[1]
            pi, pc = _fill_pod_image_rows([pv], aux["img_ids"], I)
            if pi[0].any():
                add_set("pod_img", i, pi[0])
            if pc[0]:
                add_set("pod_ncont", i, pc[0])

            # volumes
            if pv.pvc_names:
                raise _Fallback("pod references PVCs")
            D = a.pod_disk_any.shape[1]
            try:
                da, dr, v3 = pod_disk_vol_rows(pv, aux["disk_ids"], D)
            except KeyError:
                raise _Fallback("disk vocab would grow") from None
            if da.any():
                add_set("pod_disk_any", i, da)
            if dr.any():
                add_set("pod_disk_rw", i, dr)
            if v3.any():
                add_set("pod_vol3", i, v3)

            # pod relations: labels, namespace, spread. Inter-pod terms fall
            # back (their topology keys and clauses intern mid-vocabulary
            # from scratch)
            if (
                _required_terms(pv.pod_affinity)
                or _required_terms(pv.pod_anti_affinity)
                or _preferred_terms(pv.pod_affinity)
                or _preferred_terms(pv.pod_anti_affinity)
            ):
                raise _Fallback("pod carries inter-pod affinity")
            pair_row = np.zeros(rel.pair_present.shape[1], bool)
            key_row = np.zeros(rel.key_present.shape[1], bool)
            for k, v in pv.labels.items():
                key_row[cb_ng.key_vocab.intern(k)] = True
                pair_row[cb_ng.pair_id(k, str(v))] = True
            if key_row.any():
                add_set("key_present", i, key_row)
                add_set("pair_present", i, pair_row)
            nsid = ns_ng.intern(pv.namespace)
            if nsid:
                add_set("ns_id", i, np.int32(nsid))
            if (pod.get("metadata", {}) or {}).get("deletionTimestamp"):
                add_set("deleted", i, np.bool_(True))

            constraints = resolve_spread_constraints(pv.topology_spread_constraints, spread_args)
            topo = aux["topo_keys"]
            for c in constraints[0] + constraints[1]:
                if c["topologyKey"] not in topo:
                    raise _Fallback("spread topology key outside retained set")
            hard_terms, soft_terms, explicit = parse_pod_spread(
                pv, constraints, _NoGrow(aux["label_keys"], "topology key"), cb_ng
            )
            if explicit:
                add_set("req_all", i, np.bool_(True))

            def spread_rows(terms, prefix, key_a, ctype_a, cpairs_a):
                TC = key_a.shape[1]
                C = ctype_a.shape[2]
                VP = cpairs_a.shape[3]
                if len(terms) > TC:
                    raise _Fallback("spread terms exceed retained dim")
                for (_, _, _, cl, _) in terms:
                    if len(cl) > C or any(len(pr) > VP for _, _, pr in cl):
                        raise _Fallback("spread clauses exceed retained dim")
                k_, s_, m_, h_, ct_, ck_, cp_ = _pack_spread([terms], 1, TC, C, VP)
                if (k_[0] == -1).all() and (s_[0] == 1).all() and not m_[0].any() \
                        and not h_[0].any() and (ct_[0] == CL_PAD).all():
                    return  # the padding row: no update
                add_set(f"{prefix}_key", i, k_[0])
                add_set(f"{prefix}_skew", i, s_[0])
                add_set(
                    f"{prefix}_self" if prefix == "sph" else f"{prefix}_host",
                    i,
                    m_[0] if prefix == "sph" else h_[0],
                )
                add_set(f"{prefix}_ctype", i, ct_[0])
                add_set(f"{prefix}_ckey", i, ck_[0])
                add_set(f"{prefix}_cpairs", i, cp_[0])

            spread_rows(hard_terms, "sph", rel.sph_key, rel.sph_ctype, rel.sph_cpairs)
            spread_rows(soft_terms, "sps", rel.sps_key, rel.sps_ctype, rel.sps_cpairs)

            # host-side bookkeeping for the appended pod
            enc.pod_keys.append((ns, name))
            enc.pods.append(pod)
            st.pods_by_key[(ns, name)] = i
            self._grow_mirrors(st, i, req_row, sreq_row, port_rows, tgt, priority, da, dr, v3)
            if tgt >= 0:
                row_src = {
                    "pod_req": req_row,
                    "pod_sreq": sreq_row,
                    "want_pair": st.m["want_pair"][i].astype(np.int64),
                    "want_wild": st.m["want_wild"][i].astype(np.int64),
                    "want_trip": st.m["want_trip"][i].astype(np.int64),
                    "pod_disk_any": da.astype(np.int64),
                    "pod_disk_rw": dr.astype(np.int64),
                    "pod_vol3": v3.astype(np.int64),
                }
                bind_delta(row_src, +1, tgt)
                add_st0(st0_set, "assignment", i, np.int32(tgt))
                add_st0(st0_set, "bound_seq", i, np.int32(i))

    def _grow_mirrors(self, st, i, req_row, sreq_row, port_rows, tgt, priority, da, dr, v3):
        """Write the appended pod's rows into the host mirrors (full-capacity
        arrays, so row i exists): the same rows the device got."""
        m = st.m
        m["pod_req"][i] = req_row
        m["pod_sreq"][i] = sreq_row
        if port_rows is not None:
            ww, wt, wp = port_rows
            m["want_wild"][i] = ww
            m["want_trip"][i] = wt
            m["want_pair"][i] = wp
        m["pod_disk_any"][i] = da
        m["pod_disk_rw"][i] = dr
        m["pod_vol3"][i] = v3
        m["pod_node_name"][i] = tgt
        m["pod_priority"][i] = priority
