"""Cluster state → tensors (the featurizer), cut to this slice's planes.

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

Planes of plugins outside this slice (node labels and affinity terms, host
ports, images, volumes, pod relations) are not encoded yet.
"""

from __future__ import annotations

import dataclasses
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
from ..sched.resources import to_int_resources

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

# Taint/toleration effect ids.
EFFECTS = {"NoSchedule": 0, "PreferNoSchedule": 1, "NoExecute": 2}
# The taint every unschedulable node implicitly carries (oracle
# taint_toleration semantics).
UNSCHED_TAINT = {"key": "node.kubernetes.io/unschedulable", "effect": "NoSchedule"}


def _to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    return t.to(device) if t.device != device else t


@dataclass
class ClusterArrays:
    """Static per-problem tensors. Axes: N = padded nodes, P = padded pods,
    R = resource kinds, T = taint slots, L = toleration slots."""

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

    def to(self, device: torch.device) -> "ClusterArrays":
        return ClusterArrays(
            **{f.name: _to(getattr(self, f.name), device) for f in dataclasses.fields(self)}
        )


@dataclass
class SchedState:
    """Per-step state of the sequential pass (the slice's fields)."""

    requested: torch.Tensor  # [N, R] sum of effective requests of bound pods
    s_requested: torch.Tensor  # [N, R] sum of scoring requests
    n_pods: torch.Tensor  # [N] int32 bound-pod count
    assignment: torch.Tensor  # [P] int32 node idx | -1
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
    ):
        self.arrays = arrays
        self.state0 = state0
        self.node_names = node_names
        self.pod_keys = pod_keys
        self.resource_names = resource_names
        self.queue = queue  # pending pod indices, scheduling order
        self.policy = policy
        self.config = config
        self.n_nodes = n_nodes  # real (unpadded) counts
        self.n_pods = n_pods
        self.aux = aux or {}  # decode tables (node_taints)

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
        return EncodedCluster(
            self.arrays.to(device),
            self.state0.to(device),
            node_names=self.node_names,
            pod_keys=self.pod_keys,
            resource_names=self.resource_names,
            queue=self.queue,
            policy=self.policy,
            config=self.config,
            n_nodes=self.n_nodes,
            n_pods=self.n_pods,
            aux=self.aux,
        )

    def decode_assignment(self, assignment) -> dict:
        """[P] pod-indexed node assignments → {(ns, name): node | ""} over
        the queued pods."""
        assignment = np.asarray(torch.as_tensor(assignment).cpu())
        out = {}
        for p in self.queue:
            s = int(assignment[p])
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
    ), {"node_taints": node_taints}


def encode_cluster(
    nodes: list[dict],
    pods: list[dict],
    config: "SchedulerConfiguration | None" = None,
    *,
    policy: DTypePolicy = TPU32,
    priorityclasses: "list[dict] | None" = None,
    node_capacity: "int | None" = None,
    pod_capacity: "int | None" = None,
    device: "str | torch.device | None" = None,
) -> EncodedCluster:
    """Build the padded tensor encoding of a cluster on `device` (the CUDA
    card unless the caller names another).

    `node_capacity`/`pod_capacity` fix the padded shapes (masked rows)."""
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

    taint_arrays, taint_aux = _encode_taints(node_views, pod_views, N, P)

    # Initial binding state: pods whose nodeName names an existing node are
    # already bound (oracle: sched/oracle.py Oracle.__init__); the rest are
    # pending, scheduled in PrioritySort order (priority desc, arrival FIFO).
    requested = np.zeros((N, R), res_np)
    s_requested = np.zeros((N, R), res_np)
    n_pods = np.zeros(N, np.int32)
    assignment = np.full(P, -1, np.int32)
    bound_seq = np.full(P, -1, np.int32)
    pending: list[int] = []
    for i in range(len(pods)):
        tgt = pod_node_name[i]
        if tgt >= 0:
            assignment[i] = tgt
            requested[tgt] += pod_req[i]
            s_requested[tgt] += pod_sreq[i]
            n_pods[tgt] += 1
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
    )
    state0 = SchedState(
        requested=put(requested, policy.res),
        s_requested=put(s_requested, policy.res),
        n_pods=put(n_pods),
        assignment=put(assignment),
        bound_seq=put(bound_seq),
    )
    return EncodedCluster(
        arrays,
        state0,
        node_names=[nv.name for nv in node_views],
        pod_keys=[(pv.namespace, pv.name) for pv in pod_views],
        resource_names=resource_names,
        queue=queue,
        policy=policy,
        config=config,
        n_nodes=len(nodes),
        n_pods=len(pods),
        aux=taint_aux,
    )


def from_reference_arrays(
    arrays: "dict[str, np.ndarray]",
    state: "dict[str, np.ndarray]",
    queue,
    meta: dict,
    *,
    device: "str | torch.device | None" = None,
) -> EncodedCluster:
    """Build the port's encoding from the reference encoder's leaves.

    `arrays` and `state` map field names to numpy arrays (the reference's
    `ClusterArrays` and `SchedState` leaves); `queue` is its pending queue.
    `meta` carries `node_names`, `pod_keys`, `resource_names`, `policy`
    (the policy name, "exact" or "i32"), `config` (the configuration
    dict, as `SchedulerConfiguration.to_dict()` gives it) and, for the
    TaintToleration messages, `node_taints` (each node's taint list).

    Raises KeyError on a missing field. The planes of plugins outside this
    slice are ignored: label_val, label_num, label_num_ok, nsel_key,
    nsel_val, raff_*, pod_has_raff, paff_*, want_wild, want_trip,
    want_pair, trip_pair, img_contrib, pod_img, pod_ncont, vb_row,
    vb_code, vz_code, vb_pf, pod_claim, pod_disk_any, pod_disk_rw,
    pod_vol3 and rel, and in the state used_pair, used_wild, used_trip,
    used_claims, node_disk_any, node_disk_rw and node_vol3.
    """
    device = resolve_device(device)
    policy = POLICIES[meta["policy"]]
    exact = {"node_alloc", "pod_req", "pod_sreq", "requested", "s_requested"}

    def put(name, src):
        if name not in src:
            raise KeyError(f"reference encoding lacks field {name!r}")
        dtype = policy.res if name in exact else None
        return torch.tensor(np.asarray(src[name]), dtype=dtype, device=device)

    ca = ClusterArrays(
        **{f.name: put(f.name, arrays) for f in dataclasses.fields(ClusterArrays)}
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
        aux={"node_taints": list(meta.get("node_taints") or [[] for _ in node_names])},
    )
