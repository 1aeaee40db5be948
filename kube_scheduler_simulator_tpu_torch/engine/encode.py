"""Cluster state → tensors (the featurizer).

The reference package encodes the whole cluster once into padded,
statically-shaped arrays; the port does the same into torch tensors on the
caller's device, with the same padding, the same vocabularies and the same
PrioritySort queue, so a test can hold every shared leaf against the
reference encoder byte for byte.

  * resources become a `[*, R]` axis over an interned resource vocabulary
    (cpu in millicores, bytes-like resources optionally scaled to Mi so
    they fit int32);
  * every string the scheduling semantics compare for equality is interned
    through `models.vocab.Vocab` — tensors only hold int32 ids;
  * pods and nodes beyond the live counts are padding rows behind masks.

Two dtype policies:
  * EXACT — int64/float64: the pure-Python oracle's integer semantics for
    arbitrary quantities;
  * TPU32 — int32/float32 with per-resource unit scaling (memory in Mi);
    exact whenever quantities are Mi-granular, which real manifests are.

Every plane is encoded whatever the configuration, as the reference does
(the spread kernels read the NodeAffinity filter body even where
NodeAffinity is disabled); the volume planes come from
`engine/encode_vol.py`.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass

import numpy as np
import torch

from ..models.objects import (
    NodeView,
    PodView,
    pod_effective_requests,
    pod_scoring_requests,
    resolve_pod_priority,
    tolerations_tolerate_taint,
)
from ..models.vocab import Vocab
from ..sched.config import SchedulerConfiguration
from ..sched.oracle_plugins import (
    _IMG_MAX_CONTAINERS,
    _normalized_image_name,
    resolve_spread_constraints,
)
from ..sched.resources import to_int_resources
from .encode_rel import PodRelArrays, encode_pod_relations
from .encode_vol import encode_volumes

# Node index sentinels in pod_node_name: -1 = no nodeName requested,
# -2 = names a node that does not exist (fails NodeName everywhere,
# matching the oracle which leaves such pods pending).
NO_NODE = -1
MISSING_NODE = -2

# Fixed low ids in the resource vocabulary.
BASE_RESOURCES = ("cpu", "memory", "ephemeral-storage", "pods")
PODS_RES = 3  # index of "pods" in BASE_RESOURCES


def resolve_device(device: "str | torch.device | None") -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    names another. There is no quiet fallback to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


@dataclass(frozen=True)
class DTypePolicy:
    """Dtype + unit-scaling choices for the encoded tensors."""

    name: str
    res: torch.dtype
    score: torch.dtype
    flt: torch.dtype
    scale_bytes: bool = False  # divide bytes-like resources by 2**20 (Mi)

    def divisor(self, resource: str) -> int:
        if self.scale_bytes and (
            resource in ("memory", "ephemeral-storage")
            or resource.startswith("hugepages-")
        ):
            return 1 << 20
        return 1

    def to_units(self, resource: str, v: int, *, up: bool) -> int:
        """Scale an integer base-unit quantity into device units. Requests
        round up (conservative: never under-reserve), capacities round
        down (never overcommit vs the exact semantics). In the 32-bit
        policy, quantities clamp to 2^23-1 device units (8 TiB of memory,
        8388 cores) so int32 kernel intermediates cannot overflow."""
        d = self.divisor(resource)
        scaled = v if d == 1 else (-((-v) // d) if up else v // d)
        if self.scale_bytes:  # 32-bit policy
            return min(scaled, (1 << 23) - 1)
        return scaled


EXACT = DTypePolicy("exact", torch.int64, torch.int64, torch.float64)
TPU32 = DTypePolicy("i32", torch.int32, torch.int32, torch.float32, scale_bytes=True)

POLICIES = {"exact": EXACT, "i32": TPU32}


def policy_from_env() -> DTypePolicy:
    """The dtype policy KSS_DTYPE_POLICY selects (default TPU32; unknown
    spellings give TPU32, as the reference's). "packed" raises: the PACKED
    policy's unpack kernels are not ported yet, and serving TPU32 under
    its name would hide that."""
    raw = os.environ.get("KSS_DTYPE_POLICY", "").strip().lower()
    if raw == "packed":
        raise NotImplementedError(
            "KSS_DTYPE_POLICY=packed is not ported yet (its unpack kernels, K8)"
        )
    return {"exact": EXACT, "i32": TPU32, "tpu32": TPU32}.get(raw, TPU32)

# Taint/toleration effect ids.
EFFECTS = {"NoSchedule": 0, "PreferNoSchedule": 1, "NoExecute": 2}
# The taint every unschedulable node implicitly carries (oracle
# taint_toleration semantics).
UNSCHED_TAINT = {"key": "node.kubernetes.io/unschedulable", "effect": "NoSchedule"}
# node-selector expression operator ids.
OPS = {"In": 0, "NotIn": 1, "Exists": 2, "DoesNotExist": 3, "Gt": 4, "Lt": 5}
OP_NEVER = 6  # unknown operator: matches nothing
# Pseudo label key carrying the node name for matchFields (kept out of the
# real label-key namespace by the NUL prefix).
FIELD_NAME_KEY = "\x00metadata.name"
VAL_PAD = -3  # padding slot in expression value lists; matches no value id


def _to(t, device: torch.device):
    """`t` (a tensor or a nested tensor dataclass) on `device`."""
    if isinstance(t, torch.Tensor):
        return t.to(device) if t.device != device else t
    return t.to(device)


@dataclass
class ClusterArrays:
    """Static per-problem tensors. Axes: N = padded nodes, P = padded pods,
    R = resource kinds, T = taint slots, L = toleration slots, K = label
    keys, NS = nodeSelector slots, TM/PR = required/preferred affinity
    terms, E = expressions per term, VV = values per expression, Q =
    (proto,port) pairs, V2 = (proto,ip,port) triples, I = images."""

    node_alloc: torch.Tensor  # [N, R] allocatable, device units
    node_unsched: torch.Tensor  # [N] bool
    node_mask: torch.Tensor  # [N] bool — real node
    pod_req: torch.Tensor  # [P, R] effective requests (Filter path)
    pod_sreq: torch.Tensor  # [P, R] scoring requests w/ nonzero defaults
    pod_req_rank: torch.Tensor  # [P, R] rank of r in pod's request-dict order; R if absent
    pod_node_name: torch.Tensor  # [P] int32 node idx | NO_NODE | MISSING_NODE
    pod_tol_unsched: torch.Tensor  # [P] bool — tolerates the unschedulable taint
    pod_priority: torch.Tensor  # [P] int32 resolved priority
    pod_mask: torch.Tensor  # [P] bool — real pod
    # taints / tolerations (TaintToleration, oracle_plugins.py:207-236)
    taint_key: torch.Tensor  # [N, T] int32 | -1 pad
    taint_val: torch.Tensor  # [N, T] int32
    taint_effect: torch.Tensor  # [N, T] int32 effect id | -1
    tol_key: torch.Tensor  # [P, L] int32 | -1 = any key
    tol_val: torch.Tensor  # [P, L] int32
    tol_effect: torch.Tensor  # [P, L] int32 effect id | -1 = any effect
    tol_op: torch.Tensor  # [P, L] int32 0=Equal 1=Exists | -1 pad
    # node labels (NodeAffinity / nodeSelector)
    label_val: torch.Tensor  # [N, K] int32 value id | -1 absent
    label_num: torch.Tensor  # [N, K] numeric value (Gt/Lt), res dtype
    label_num_ok: torch.Tensor  # [N, K] bool parseable
    nsel_key: torch.Tensor  # [P, NS] int32 key col | -1 pad
    nsel_val: torch.Tensor  # [P, NS] int32
    raff_key: torch.Tensor  # [P, TM, E] int32 key col | -1 pad
    raff_op: torch.Tensor  # [P, TM, E] int32 op id
    raff_vals: torch.Tensor  # [P, TM, E, VV] int32 | VAL_PAD
    raff_num: torch.Tensor  # [P, TM, E] numeric rhs, res dtype
    raff_num_ok: torch.Tensor  # [P, TM, E] bool
    raff_term_valid: torch.Tensor  # [P, TM] bool — term has >=1 expr
    pod_has_raff: torch.Tensor  # [P] bool — required terms present
    paff_key: torch.Tensor  # [P, PR, E] int32 | -1 pad
    paff_op: torch.Tensor  # [P, PR, E] int32
    paff_vals: torch.Tensor  # [P, PR, E, VV] int32
    paff_num: torch.Tensor  # [P, PR, E] res dtype
    paff_num_ok: torch.Tensor  # [P, PR, E] bool
    paff_weight: torch.Tensor  # [P, PR] int32
    paff_term_valid: torch.Tensor  # [P, PR] bool
    # host ports (NodePorts)
    want_wild: torch.Tensor  # [P, Q] int32 wildcard-ip port counts
    want_trip: torch.Tensor  # [P, V2] int32 specific-ip port counts
    want_pair: torch.Tensor  # [P, Q] int32 all users of (proto,port)
    trip_pair: torch.Tensor  # [V2] int32 triple -> pair index
    # images (ImageLocality)
    img_contrib: torch.Tensor  # [N, I] size*have//total per node-image (Ki), res dtype
    pod_img: torch.Tensor  # [P, I] int32 image occurrence counts
    pod_ncont: torch.Tensor  # [P] int32 container count
    # volume family (encode_vol.py). VB = claim pods, C = RWOP claims,
    # D = exclusive-disk identities, V3 = limit plugin count.
    vb_row: torch.Tensor  # [P] int32 row into vb/vz code tables | -1 no claims
    vb_code: torch.Tensor  # [N, VB] int32 VolumeBinding message id (0 = pass)
    vz_code: torch.Tensor  # [N, VB] int32 VolumeZone message id
    vb_pf: torch.Tensor  # [P] int32 VolumeBinding prefilter message id
    pod_claim: torch.Tensor  # [P, C] bool — pod references RWOP claim c
    pod_disk_any: torch.Tensor  # [P, D] int32 mounts of disk d
    pod_disk_rw: torch.Tensor  # [P, D] int32 non-read-only mounts
    pod_vol3: torch.Tensor  # [P, V3] int32 per-type volume counts
    # pod-relational encodings (PodTopologySpread, InterPodAffinity)
    rel: PodRelArrays

    def to(self, device: torch.device) -> "ClusterArrays":
        return ClusterArrays(
            **{f.name: _to(getattr(self, f.name), device) for f in dataclasses.fields(self)}
        )


@dataclass
class SchedState:
    """Per-step state of the sequential pass."""

    requested: torch.Tensor  # [N, R] sum of effective requests of bound pods
    s_requested: torch.Tensor  # [N, R] sum of scoring requests
    n_pods: torch.Tensor  # [N] int32 bound-pod count
    assignment: torch.Tensor  # [P] int32 node idx | -1
    used_pair: torch.Tensor  # [N, Q] int32 users of (proto,port), any ip
    used_wild: torch.Tensor  # [N, Q] int32 wildcard-ip users of (proto,port)
    used_trip: torch.Tensor  # [N, V2] int32 users of (proto,ip,port)
    # volume counters (VolumeRestrictions and the volume-count limits)
    used_claims: torch.Tensor  # [C] int32 bound pods using RWOP claim c
    node_disk_any: torch.Tensor  # [N, D] int32 mounts of disk d on the node
    node_disk_rw: torch.Tensor  # [N, D] int32 non-read-only mounts on the node
    node_vol3: torch.Tensor  # [N, V3] int32 per-type volume counts on the node
    # bind chronology: pre-bound pods get their input index, pass-bound
    # pods get P + step, unschedulable pods -1
    bound_seq: torch.Tensor  # [P] int32 | -1 unbound

    def clone(self) -> "SchedState":
        return SchedState(
            **{f.name: getattr(self, f.name).clone() for f in dataclasses.fields(self)}
        )

    def to(self, device: torch.device) -> "SchedState":
        return SchedState(
            **{f.name: _to(getattr(self, f.name), device) for f in dataclasses.fields(self)}
        )


class EncodedCluster:
    """Tensors + the host-side metadata needed to decode results."""

    def __init__(
        self,
        arrays: ClusterArrays,
        state0: SchedState,
        *,
        node_names: list[str],
        pod_keys: list[tuple[str, str]],
        resource_names: list[str],
        queue: np.ndarray,
        policy: DTypePolicy,
        config: SchedulerConfiguration,
        n_nodes: int,
        n_pods: int,
        aux: "dict | None" = None,
        pods: "list[dict] | None" = None,
    ):
        self.arrays = arrays
        self.state0 = state0
        self.node_names = node_names
        self.pod_keys = pod_keys
        self.pods = pods if pods is not None else []  # raw manifests, pod-index order
        self.resource_names = resource_names
        self.queue = queue  # pending pod indices, scheduling order
        self.policy = policy
        self.config = config
        self.n_nodes = n_nodes  # real (unpadded) counts
        self.n_pods = n_pods
        # decode tables (node_taints), n_node_pairs, and the vocabularies the
        # delta encoder (engine/delta.py) replays events against
        self.aux = aux or {}
        # the non-pod objects the encoding was made from, by kind
        self.objects: dict[str, list[dict]] = {}

    @property
    def N(self) -> int:
        return int(self.arrays.node_mask.shape[0])

    @property
    def P(self) -> int:
        return int(self.arrays.pod_mask.shape[0])

    @property
    def R(self) -> int:
        return len(self.resource_names)

    @property
    def device(self) -> torch.device:
        return self.arrays.node_mask.device

    def to(self, device: torch.device) -> "EncodedCluster":
        """This encoding with its tensors on `device` (self if already there)."""
        if self.device == device:
            return self
        out = EncodedCluster(
            self.arrays.to(device),
            self.state0.to(device),
            node_names=self.node_names,
            pod_keys=self.pod_keys,
            pods=self.pods,
            resource_names=self.resource_names,
            queue=self.queue,
            policy=self.policy,
            config=self.config,
            n_nodes=self.n_nodes,
            n_pods=self.n_pods,
            aux=self.aux,
        )
        out.objects = self.objects
        return out

    def decode_assignment(self, assignment) -> dict:
        """[P] pod-indexed node assignments → {(ns, name): node | ""} over
        the queued pods."""
        assignment = np.asarray(torch.as_tensor(assignment).cpu())
        out = {}
        for p in self.queue:
            s = int(assignment[p])
            out[self.pod_keys[p]] = self.node_names[s] if s >= 0 else ""
        return out

    def decode_selection(self, sels) -> dict:
        """[Q] queue-position-indexed selections → {(ns, name): node | ""}
        (a pass's per-step selections)."""
        sels = np.asarray(torch.as_tensor(sels).cpu())
        out = {}
        for qi, p in enumerate(self.queue):
            s = int(sels[qi])
            out[self.pod_keys[p]] = self.node_names[s] if s >= 0 else ""
        return out


def _fill_tol_rows(pod_tols, kv, L):
    """Toleration rows for a list of pods' toleration lists, interning
    through `kv`."""
    n = len(pod_tols)
    tol_key = np.full((n, L), -1, np.int32)
    tol_val = np.full((n, L), -1, np.int32)
    tol_effect = np.full((n, L), -1, np.int32)
    tol_op = np.full((n, L), -1, np.int32)
    for i, tols in enumerate(pod_tols):
        for j, t in enumerate(tols):
            k = t.get("key") or ""
            tol_key[i, j] = kv.intern(k) if k else -1  # empty key = any
            tol_val[i, j] = kv.intern(t.get("value") or "")
            eff = t.get("effect") or ""
            tol_effect[i, j] = EFFECTS.get(eff, -2) if eff else -1  # -1 = any
            # 0 = Equal, 1 = Exists, 2 = unknown operator (tolerates
            # nothing, oracle toleration_tolerates_taint fallthrough)
            op = t.get("operator") or "Equal"
            tol_op[i, j] = {"Equal": 0, "Exists": 1}.get(op, 2)
    return dict(
        tol_key=tol_key, tol_val=tol_val, tol_effect=tol_effect, tol_op=tol_op
    )


def _encode_taints(node_views, pod_views, N, P):
    """TaintToleration encodings (oracle: taint_toleration_filter/score,
    models/objects.py toleration_tolerates_taint)."""
    kv = Vocab()
    node_taints = [nv.taints for nv in node_views]
    pod_tols = [pv.tolerations for pv in pod_views]
    T = max(1, max((len(t) for t in node_taints), default=0))
    L = max(1, max((len(t) for t in pod_tols), default=0))
    taint_key = np.full((N, T), -1, np.int32)
    taint_val = np.full((N, T), -1, np.int32)
    taint_effect = np.full((N, T), -1, np.int32)
    for i, taints in enumerate(node_taints):
        for j, t in enumerate(taints):
            taint_key[i, j] = kv.intern(t.get("key") or "")
            taint_val[i, j] = kv.intern(t.get("value") or "")
            taint_effect[i, j] = EFFECTS.get(t.get("effect") or "", -1)
    tol = _fill_tol_rows(pod_tols, kv, L)
    padded = {
        k: np.concatenate([v, np.full((P - len(pod_views), L), -1, np.int32)])
        if len(pod_views) < P
        else v
        for k, v in tol.items()
    }
    return dict(
        taint_key=taint_key,
        taint_val=taint_val,
        taint_effect=taint_effect,
        **padded,
    ), {"node_taints": node_taints, "taint_vocab": kv}


# Fields that hold the policy's integer type (`DTypePolicy.res`).
RES_TYPED = frozenset({
    "node_alloc", "pod_req", "pod_sreq", "requested", "s_requested",
    "label_num", "raff_num", "paff_num", "img_contrib",
})


def _num_or_none(s, policy: DTypePolicy):
    """Parse an int for Gt/Lt; values outside the policy's integer range
    count as unparseable (they could not be compared exactly)."""
    try:
        v = int(s)
    except (TypeError, ValueError):
        return None
    lim = 2**62 if policy.name == "exact" else 2**31 - 1
    if not -lim <= v <= lim:
        return None
    return v


def _parse_pod_terms(pv, keys, vals, policy: DTypePolicy):
    """Parse ONE pod's nodeSelector and node-affinity terms against the
    key/value vocabularies. Returns (nsel_pairs, req_terms, pref_terms) in
    the shapes `_fill_terms`/`_fill_nsel_rows` pack."""

    def parse_expr(e, is_field):
        if is_field:
            # matchFields evaluate against {"metadata.name": node.name}
            # only; any other field key is a never-populated pseudo key, so
            # Exists/In miss and DoesNotExist matches
            raw = e.get("key") or ""
            key = FIELD_NAME_KEY if raw == "metadata.name" else "\x00" + raw
        else:
            key = e.get("key") or ""
        op = OPS.get(e.get("operator") or "", OP_NEVER)
        values = [str(v) for v in (e.get("values") or [])]
        num = _num_or_none(values[0], policy) if values else None
        return (keys.intern(key), op, [vals.intern(v) for v in values], num)

    def parse_term(term):
        exprs = [parse_expr(e, False) for e in term.get("matchExpressions") or []]
        exprs += [parse_expr(e, True) for e in term.get("matchFields") or []]
        return exprs

    nsel = [(keys.intern(k), vals.intern(str(v))) for k, v in pv.node_selector.items()]
    req = pv.node_affinity.get("requiredDuringSchedulingIgnoredDuringExecution") or {}
    req_terms = [parse_term(t) for t in req.get("nodeSelectorTerms") or []]
    prefs = pv.node_affinity.get("preferredDuringSchedulingIgnoredDuringExecution") or []
    pref_terms = [
        (int(pr.get("weight", 0)), parse_term(pr.get("preference") or {})) for pr in prefs
    ]
    return nsel, req_terms, pref_terms


def _fill_nsel_rows(pod_nsel, n, NS):
    nsel_key = np.full((n, NS), -1, np.int32)
    nsel_val = np.full((n, NS), -1, np.int32)
    for i, sel in enumerate(pod_nsel):
        for j, (k, v) in enumerate(sel):
            nsel_key[i, j] = k
            nsel_val[i, j] = v
    return nsel_key, nsel_val


def _fill_terms(all_terms, n, TM, E, VV):
    """Pack parsed (key, op, value-ids, num) term lists into dense rows for
    `n` pods at fixed dims."""
    key = np.full((n, TM, E), -1, np.int32)
    op = np.full((n, TM, E), OP_NEVER, np.int32)
    vvals = np.full((n, TM, E, VV), VAL_PAD, np.int32)
    num = np.zeros((n, TM, E), np.int64)
    num_ok = np.zeros((n, TM, E), bool)
    term_valid = np.zeros((n, TM), bool)
    for i, terms in enumerate(all_terms):
        for ti, exprs in enumerate(terms):
            term_valid[i, ti] = len(exprs) > 0
            for ei, (k, o, vv, nnum) in enumerate(exprs):
                key[i, ti, ei] = k
                op[i, ti, ei] = o
                for vi, v in enumerate(vv):
                    vvals[i, ti, ei, vi] = v
                if nnum is not None:
                    num[i, ti, ei] = nnum
                    num_ok[i, ti, ei] = True
    return key, op, vvals, num, num_ok, term_valid


def _encode_labels_affinity(node_views, pod_views, N, P, policy: DTypePolicy, extra_keys=()):
    """NodeAffinity / nodeSelector encodings. `extra_keys` are interned up
    front so the other readers of the key vocabulary (spread and
    inter-pod topology keys) index the same label_val columns."""
    keys, vals = Vocab(), Vocab()
    for k in extra_keys:
        keys.intern(k)

    # parse every pod-side term first so the vocabularies are final before
    # the arrays are sized
    pod_nsel, pod_req_terms, pod_pref_terms = [], [], []
    for pv in pod_views:
        nsel, req_terms, pref_terms = _parse_pod_terms(pv, keys, vals, policy)
        pod_nsel.append(nsel)
        pod_req_terms.append(req_terms)
        pod_pref_terms.append(pref_terms)
    field_col = keys.intern(FIELD_NAME_KEY)
    for nv in node_views:
        for k in nv.labels:
            keys.intern(k)
        vals.intern(nv.name)
    K = len(keys)
    label_val = np.full((N, K), -1, np.int32)
    label_num = np.zeros((N, K), np.int64)
    label_num_ok = np.zeros((N, K), bool)
    for i, nv in enumerate(node_views):
        for k, v in list(nv.labels.items()) + [(FIELD_NAME_KEY, nv.name)]:
            col = field_col if k == FIELD_NAME_KEY else keys.get(k)
            label_val[i, col] = vals.intern(str(v))
            num = _num_or_none(v, policy)
            if num is not None:
                label_num[i, col] = num
                label_num_ok[i, col] = True

    NS = max(1, max((len(s) for s in pod_nsel), default=0))
    nsel_key, nsel_val = _fill_nsel_rows(pod_nsel, P, NS)

    pref_exprs = [[e for _, e in t] for t in pod_pref_terms]
    TM = max(1, max((len(t) for t in pod_req_terms), default=0))
    all_terms = pod_req_terms + pref_exprs
    E = max((len(e) for terms in all_terms for e in terms), default=1) or 1
    VV = max((len(x[2]) for terms in all_terms for e in terms for x in e), default=1) or 1
    rk, ro, rv, rn, rno, rtv = _fill_terms(pod_req_terms, P, TM, E, VV)
    PR = max(1, max((len(t) for t in pod_pref_terms), default=0))
    pk, po, pvv, pn, pno, ptv = _fill_terms(pref_exprs, P, PR, E, VV)
    paff_weight = np.zeros((P, PR), np.int32)
    for i, prefs in enumerate(pod_pref_terms):
        for j, (w, _) in enumerate(prefs):
            paff_weight[i, j] = w
    pod_has_raff = np.zeros(P, bool)
    pod_has_raff[: len(pod_req_terms)] = [len(t) > 0 for t in pod_req_terms]
    return dict(
        label_val=label_val,
        label_num=label_num,
        label_num_ok=label_num_ok,
        nsel_key=nsel_key,
        nsel_val=nsel_val,
        raff_key=rk,
        raff_op=ro,
        raff_vals=rv,
        raff_num=rn,
        raff_num_ok=rno,
        raff_term_valid=rtv,
        pod_has_raff=pod_has_raff,
        paff_key=pk,
        paff_op=po,
        paff_vals=pvv,
        paff_num=pn,
        paff_num_ok=pno,
        paff_weight=paff_weight,
        paff_term_valid=ptv,
    ), keys, vals


def _fill_port_rows(wants, pair_ids, trip_ids, Q, V2):
    """Port-demand rows for pods' host-port lists against fixed pair /
    triple vocabularies."""
    n = len(wants)
    want_wild = np.zeros((n, Q), np.int32)
    want_trip = np.zeros((n, V2), np.int32)
    want_pair = np.zeros((n, Q), np.int32)
    for i, ports in enumerate(wants):
        for proto, ip, port in ports:
            q = pair_ids[(proto, port)]
            want_pair[i, q] += 1
            if ip == "0.0.0.0":
                want_wild[i, q] += 1
            else:
                want_trip[i, trip_ids[(proto, ip, port)]] += 1
    return want_wild, want_trip, want_pair


def _encode_ports(pod_views, N, P):
    """NodePorts encodings. (proto, port) pairs index Q; specific-ip
    (proto, ip, port) triples index V2; hostIP defaults to the wildcard
    0.0.0.0 (PodView.host_ports)."""
    pair_ids: dict[tuple[str, int], int] = {}
    trip_ids: dict[tuple[str, str, int], int] = {}
    wants = [pv.host_ports for pv in pod_views]
    for ports in wants:
        for proto, ip, port in ports:
            pair_ids.setdefault((proto, port), len(pair_ids))
            if ip != "0.0.0.0":
                trip_ids.setdefault((proto, ip, port), len(trip_ids))
    Q = max(1, len(pair_ids))
    V2 = max(1, len(trip_ids))
    trip_pair = np.zeros(V2, np.int32)
    for (proto, ip, port), v in trip_ids.items():
        trip_pair[v] = pair_ids[(proto, port)]
    ww, wt, wp = _fill_port_rows(wants, pair_ids, trip_ids, Q, V2)
    pad = P - len(wants)
    return dict(
        want_wild=np.concatenate([ww, np.zeros((pad, Q), np.int32)]),
        want_trip=np.concatenate([wt, np.zeros((pad, V2), np.int32)]),
        want_pair=np.concatenate([wp, np.zeros((pad, Q), np.int32)]),
        trip_pair=trip_pair,
    ), {"port_pair_ids": pair_ids, "port_trip_ids": trip_ids}


def _fill_pod_image_rows(pod_views, img_ids, I):
    """pod_img/pod_ncont rows against a fixed node-image vocabulary (images
    no node holds do not count)."""
    n = len(pod_views)
    pod_img = np.zeros((n, I), np.int32)
    pod_ncont = np.zeros(n, np.int32)
    for p, pv in enumerate(pod_views):
        pod_ncont[p] = min(pv.num_containers, _IMG_MAX_CONTAINERS)
        for name in pv.container_images:
            i = img_ids.get(_normalized_image_name(name))
            if i is not None:
                pod_img[p, i] += 1
    return pod_img, pod_ncont


def _encode_images(node_views, pod_views, N, P, n_real_nodes):
    """ImageLocality encodings: per node-image, size × (share of nodes
    holding it), in Ki."""
    img_ids: dict[str, int] = {}
    node_imgs = []  # per node: {img_id: size}
    for nv in node_views:
        m = {}
        for names, size in nv.images:
            for name in names:
                i = img_ids.setdefault(_normalized_image_name(name), len(img_ids))
                m[i] = size
        node_imgs.append(m)
    I = max(1, len(img_ids))
    have = np.zeros(I, np.int64)
    for m in node_imgs:
        for i in m:
            have[i] += 1
    img_contrib = np.zeros((N, I), np.int64)
    total = max(1, n_real_nodes)
    for n, m in enumerate(node_imgs):
        for i, size in m.items():
            img_contrib[n, i] = (size * int(have[i]) // total) >> 10  # Ki
    pi, pc = _fill_pod_image_rows(pod_views, img_ids, I)
    pad = P - len(pod_views)
    return dict(
        img_contrib=img_contrib,
        pod_img=np.concatenate([pi, np.zeros((pad, I), np.int32)]),
        pod_ncont=np.concatenate([pc, np.zeros(pad, np.int32)]),
    ), {"img_ids": img_ids}


def _topology_keys(pod_views, pod_constraints) -> list[str]:
    """Every topology key a spread constraint or an inter-pod term names,
    in encounter order (they index the same label_val columns)."""
    keys = [c["topologyKey"] for h, s, _ in pod_constraints for c in h + s]
    for pv in pod_views:
        for aff in (pv.pod_affinity, pv.pod_anti_affinity):
            for t in aff.get("requiredDuringSchedulingIgnoredDuringExecution") or []:
                keys.append(t.get("topologyKey", ""))
            for pr in aff.get("preferredDuringSchedulingIgnoredDuringExecution") or []:
                keys.append((pr.get("podAffinityTerm") or {}).get("topologyKey", ""))
    return keys


def encode_cluster(
    nodes: list[dict],
    pods: list[dict],
    config: "SchedulerConfiguration | None" = None,
    *,
    policy: DTypePolicy = TPU32,
    priorityclasses: "list[dict] | None" = None,
    namespaces: "list[dict] | None" = None,
    pvcs: "list[dict] | None" = None,
    pvs: "list[dict] | None" = None,
    storageclasses: "list[dict] | None" = None,
    node_capacity: "int | None" = None,
    pod_capacity: "int | None" = None,
    device: "str | torch.device | None" = None,
) -> EncodedCluster:
    """Build the padded tensor encoding of a cluster on `device` (the CUDA
    card unless the caller names another).

    `namespaces` are the Namespace objects inter-pod terms with a
    namespaceSelector resolve against; `pvcs`, `pvs` and `storageclasses`
    the objects the volume plugins consult. `node_capacity`/`pod_capacity`
    fix the padded shapes (masked rows)."""
    device = resolve_device(device)
    config = config or SchedulerConfiguration.default()
    N = node_capacity or max(len(nodes), 1)
    if N < len(nodes):
        raise ValueError(f"node_capacity {N} < {len(nodes)} nodes")
    P = pod_capacity or max(len(pods), 1)
    if P < len(pods):
        raise ValueError(f"pod_capacity {P} < {len(pods)} pods")

    res_vocab = Vocab(list(BASE_RESOURCES))
    node_views = [NodeView(n) for n in nodes]
    pod_views = [PodView(p) for p in pods]
    node_idx = {nv.name: i for i, nv in enumerate(node_views)}
    pcs = {
        (pc.get("metadata", {}) or {}).get("name", ""): pc
        for pc in priorityclasses or []
    }

    # First pass interns every resource name so R is final before filling.
    node_alloc_ints = []
    for nv in node_views:
        ai = to_int_resources(nv.allocatable)
        for r in ai:
            res_vocab.intern(r)
        node_alloc_ints.append(ai)
    pod_req_ints, pod_sreq_ints = [], []
    for p in pods:
        ri = to_int_resources(pod_effective_requests(p))
        si = to_int_resources(pod_scoring_requests(p))
        for r in list(ri) + list(si):
            res_vocab.intern(r)
        pod_req_ints.append(ri)
        pod_sreq_ints.append(si)
    R = len(res_vocab)
    resource_names = [s for s, _ in res_vocab.items()]

    res_np = np.int64  # fill in numpy int64, cast when the tensor is made
    node_alloc = np.zeros((N, R), res_np)
    node_unsched = np.zeros(N, bool)
    node_mask = np.zeros(N, bool)
    for i, (nv, ai) in enumerate(zip(node_views, node_alloc_ints)):
        node_mask[i] = True
        node_unsched[i] = nv.unschedulable
        for r, v in ai.items():
            node_alloc[i, res_vocab.get(r)] = policy.to_units(r, v, up=False)

    pod_req = np.zeros((P, R), res_np)
    pod_sreq = np.zeros((P, R), res_np)
    pod_req_rank = np.full((P, R), R, np.int32)
    pod_node_name = np.full(P, NO_NODE, np.int32)
    pod_tol_unsched = np.zeros(P, bool)
    pod_priority = np.zeros(P, np.int32)
    pod_mask = np.zeros(P, bool)
    for i, (pv, ri, si) in enumerate(zip(pod_views, pod_req_ints, pod_sreq_ints)):
        pod_mask[i] = True
        for rank, (r, v) in enumerate(ri.items()):
            j = res_vocab.get(r)
            pod_req[i, j] = policy.to_units(r, v, up=True)
            pod_req_rank[i, j] = rank
        for r, v in si.items():
            pod_sreq[i, res_vocab.get(r)] = policy.to_units(r, v, up=True)
        if pv.node_name:
            pod_node_name[i] = node_idx.get(pv.node_name, MISSING_NODE)
        pod_tol_unsched[i] = tolerations_tolerate_taint(pv.tolerations, UNSCHED_TAINT)
        pod_priority[i] = resolve_pod_priority(pv, pcs)

    spread_args = config.plugin_args("PodTopologySpread")
    pod_constraints = [
        resolve_spread_constraints(pv.topology_spread_constraints, spread_args)
        for pv in pod_views
    ]
    topo_keys = _topology_keys(pod_views, pod_constraints)
    taint_arrays, taint_aux = _encode_taints(node_views, pod_views, N, P)
    label_arrays, label_keys, label_vals = _encode_labels_affinity(
        node_views, pod_views, N, P, policy, extra_keys=topo_keys,
    )
    port_arrays, port_aux = _encode_ports(pod_views, N, P)
    img_arrays, img_aux = _encode_images(node_views, pod_views, N, P, len(nodes))
    rel, rel_aux = encode_pod_relations(
        node_views, pod_views, N, P,
        label_keys=label_keys, constraints=pod_constraints,
        namespaces=namespaces, device=device,
    )
    vol_arrays, vol_aux = encode_volumes(
        pod_views, nodes, N, P, pvcs or [], pvs or [], storageclasses or [], config
    )
    Q = port_arrays["want_pair"].shape[1]
    V2 = port_arrays["want_trip"].shape[1]

    # Initial binding state: pods whose nodeName names an existing node are
    # already bound (oracle: sched/oracle.py Oracle.__init__); the rest are
    # pending, scheduled in PrioritySort order (priority desc, arrival FIFO).
    requested = np.zeros((N, R), res_np)
    s_requested = np.zeros((N, R), res_np)
    n_pods = np.zeros(N, np.int32)
    assignment = np.full(P, -1, np.int32)
    used_pair = np.zeros((N, Q), np.int32)
    used_wild = np.zeros((N, Q), np.int32)
    used_trip = np.zeros((N, V2), np.int32)
    used_claims = np.zeros(vol_arrays["pod_claim"].shape[1], np.int32)
    node_disk_any = np.zeros((N, vol_arrays["pod_disk_any"].shape[1]), np.int32)
    node_disk_rw = np.zeros_like(node_disk_any)
    node_vol3 = np.zeros((N, vol_arrays["pod_vol3"].shape[1]), np.int32)
    bound_seq = np.full(P, -1, np.int32)
    pending: list[int] = []
    for i in range(len(pods)):
        tgt = pod_node_name[i]
        if tgt >= 0:
            assignment[i] = tgt
            requested[tgt] += pod_req[i]
            s_requested[tgt] += pod_sreq[i]
            n_pods[tgt] += 1
            used_pair[tgt] += port_arrays["want_pair"][i]
            used_wild[tgt] += port_arrays["want_wild"][i]
            used_trip[tgt] += port_arrays["want_trip"][i]
            used_claims += vol_arrays["pod_claim"][i]
            node_disk_any[tgt] += vol_arrays["pod_disk_any"][i]
            node_disk_rw[tgt] += vol_arrays["pod_disk_rw"][i]
            node_vol3[tgt] += vol_arrays["pod_vol3"][i]
            bound_seq[i] = i
        else:
            pending.append(i)
    pending.sort(key=lambda i: (-int(pod_priority[i]), i))
    queue = np.asarray(pending, np.int32)

    def put(v, dtype=None):
        return torch.as_tensor(v, dtype=dtype, device=device)

    arrays = ClusterArrays(
        node_alloc=put(node_alloc, policy.res),
        node_unsched=put(node_unsched),
        node_mask=put(node_mask),
        pod_req=put(pod_req, policy.res),
        pod_sreq=put(pod_sreq, policy.res),
        pod_req_rank=put(pod_req_rank),
        pod_node_name=put(pod_node_name),
        pod_tol_unsched=put(pod_tol_unsched),
        pod_priority=put(pod_priority),
        pod_mask=put(pod_mask),
        **{k: put(v) for k, v in taint_arrays.items()},
        # Gt/Lt numerics and image sums carry the policy's integer type
        **{k: put(v, policy.res if k in RES_TYPED else None)
           for k, v in {**label_arrays, **port_arrays, **img_arrays}.items()},
        **{k: put(v) for k, v in vol_arrays.items()},
        rel=rel,
    )
    state0 = SchedState(
        requested=put(requested, policy.res),
        s_requested=put(s_requested, policy.res),
        n_pods=put(n_pods),
        assignment=put(assignment),
        used_pair=put(used_pair),
        used_wild=put(used_wild),
        used_trip=put(used_trip),
        used_claims=put(used_claims),
        node_disk_any=put(node_disk_any),
        node_disk_rw=put(node_disk_rw),
        node_vol3=put(node_vol3),
        bound_seq=put(bound_seq),
    )
    enc = EncodedCluster(
        arrays,
        state0,
        node_names=[nv.name for nv in node_views],
        pod_keys=[(pv.namespace, pv.name) for pv in pod_views],
        pods=list(pods),
        resource_names=resource_names,
        queue=queue,
        policy=policy,
        config=config,
        n_nodes=len(nodes),
        n_pods=len(pods),
        aux={
            **taint_aux, **rel_aux, **vol_aux, **port_aux, **img_aux,
            # the vocabularies the delta encoder (engine/delta.py) replays
            # events against
            "label_keys": label_keys,
            "label_vals": label_vals,
            "res_vocab": res_vocab,
            "topo_keys": set(topo_keys),
        },
    )
    enc.objects = {
        "nodes": list(nodes),
        "pvcs": list(pvcs or []),
        "pvs": list(pvs or []),
        "storageclasses": list(storageclasses or []),
        "priorityclasses": list(priorityclasses or []),
        "namespaces": list(namespaces or []),
    }
    return enc


# encodings an EncodingCache keeps (least recently used dropped first)
ENCODING_CACHE_CAP = 8


class EncodingCache:
    """A bounded LRU of recent encodings keyed by (store key, configuration
    identity): a pass over a store that has not changed since a recent
    pass under the same configuration reuses that pass's encoding.

    The store key holds the store's latest resourceVersion, which every
    mutation bumps, so it is monotonic: `put` drops the entries at any
    other key. The configuration is compared by identity (a restart swaps
    the object). `MISS` keeps None cacheable ("nothing schedulable")."""

    MISS = object()

    def __init__(self):
        # (key, id(config)) -> (config, enc); the config rides in the value
        # so its id cannot be recycled while the entry lives
        self._entries: "dict[tuple, tuple]" = {}

    def get(self, key: tuple, config: object):
        """The cached encoding for (key, config), or `EncodingCache.MISS`."""
        k = (key, id(config))
        hit = self._entries.get(k)
        if hit is None or hit[0] is not config:
            return EncodingCache.MISS
        self._entries[k] = self._entries.pop(k)  # refresh recency
        return hit[1]

    def put(self, key: tuple, config: object, enc: object) -> None:
        if any(k[0] != key for k in self._entries):
            self._entries = {k: v for k, v in self._entries.items() if k[0] == key}
        k = (key, id(config))
        self._entries.pop(k, None)
        self._entries[k] = (config, enc)
        while len(self._entries) > ENCODING_CACHE_CAP:
            self._entries.pop(next(iter(self._entries)))


def from_reference_arrays(
    arrays: "dict",
    state: "dict[str, np.ndarray]",
    queue,
    meta: dict,
    *,
    device: "str | torch.device | None" = None,
) -> EncodedCluster:
    """Build the port's encoding from the reference encoder's leaves.

    `arrays` and `state` map field names to numpy arrays (the reference's
    `ClusterArrays` and `SchedState` leaves); `arrays["rel"]` maps the
    nested `PodRelArrays` leaves the same way. `queue` is the reference's
    pending queue. `meta` carries `node_names`, `pod_keys`,
    `resource_names`, `policy` (the policy name, "exact" or "i32"),
    `config` (the configuration dict, as `SchedulerConfiguration.to_dict()`
    gives it), for the TaintToleration messages `node_taints` (each node's
    taint list) and for the volume messages `vol_messages` (the interned
    message table).

    Raises KeyError on a missing field.
    """
    device = resolve_device(device)
    policy = POLICIES[meta["policy"]]

    def put(name, src):
        if name not in src:
            raise KeyError(f"reference encoding lacks field {name!r}")
        dtype = policy.res if name in RES_TYPED else None
        return torch.tensor(np.asarray(src[name]), dtype=dtype, device=device)

    if "rel" not in arrays:
        raise KeyError("reference encoding lacks field 'rel'")
    rel = PodRelArrays(
        **{f.name: put(f.name, arrays["rel"]) for f in dataclasses.fields(PodRelArrays)}
    )
    ca = ClusterArrays(
        **{f.name: put(f.name, arrays) for f in dataclasses.fields(ClusterArrays)
           if f.name != "rel"},
        rel=rel,
    )
    st = SchedState(
        **{f.name: put(f.name, state) for f in dataclasses.fields(SchedState)}
    )
    for key in ("node_names", "pod_keys", "resource_names", "config"):
        if key not in meta:
            raise KeyError(f"meta lacks {key!r}")
    node_names = list(meta["node_names"])
    pod_keys = [tuple(k) for k in meta["pod_keys"]]
    return EncodedCluster(
        ca,
        st,
        node_names=node_names,
        pod_keys=pod_keys,
        resource_names=list(meta["resource_names"]),
        queue=np.asarray(queue, np.int32),
        policy=policy,
        config=SchedulerConfiguration.from_dict(meta["config"]),
        n_nodes=len(node_names),
        n_pods=len(pod_keys),
        aux={
            "node_taints": list(meta.get("node_taints") or [[] for _ in node_names]),
            "vol_messages": list(meta.get("vol_messages") or [""]),
            # node-pair ids run 1..n_node_pairs
            "n_node_pairs": int(rel.node_pair.max()) if rel.node_pair.numel() else 0,
        },
    )
