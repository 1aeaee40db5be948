"""NetworkBandwidth — the demo out-of-tree plugin, on the card.

Re-derivation of the reference's example custom plugin
(simulator/scheduler/plugin/networkbandwidth/plugin.go:52-186): nodes
carry a bandwidth capacity annotation, pods request ingress/egress
bandwidth via annotations; Filter rejects nodes whose remaining capacity
can't fit the request, Score is the remaining capacity min-max normalized
(plugin.go:159-186).

Importing this module registers

  * the plain filter and score bodies into `engine.kernels` registries,
    with the ids of their bodies in `csrc/seq_kernels.cu` (`F_NETBW`,
    `S_NETBW`: the filter, the score and its normalize);
  * the featurized annotations the kernels read (`DEVICE_INPUTS`: the
    `nb_*` planes) and the statics that key a compiled engine
    (`COMPILE_STATICS`);
  * a preemption row into `engine.preempt.ROW_FILTERS` (the kernels' dry
    run keeps the same counter, `row_*` in `csrc/seq_kernels.cu`),

after which any configuration may enable "NetworkBandwidth" by name. The
builders featurize the *raw manifests* themselves (annotations → arrays)
at build time — custom plugins need no changes to the core featurizer;
each node's allocated bandwidth is a sum over the bound pods of the state,
taken again every step (on the card: one strided pass of integer atomics).

Integer semantics: bandwidth quantities are taken in Mi units (value >>
20) — requests under 1Mi round to zero and count as "no request" (upstream
is byte-granular). Sums wrap in the policy's type, as the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..engine.kernels import minmax_normalize
from ..engine.preempt import _per_node, _take
from ..utils.quantity import parse_quantity

NODE_LIMIT_ANNOTATION = "node.kubernetes.io/network-limit"
INGRESS_ANNOTATION = "kubernetes.io/ingress-request"
EGRESS_ANNOTATION = "kubernetes.io/egress-request"

FILTER_MESSAGE = (
    "node does not have enough network bandwidth capacity to schedule pod"
)

# the bodies' ids in csrc/seq_kernels.cu (its F_* and S_* enums)
F_NETBW = 15
S_NETBW = 7


def _annotations(obj: dict) -> dict:
    return (obj.get("metadata", {}) or {}).get("annotations") or {}


def _mi(quantity_str: "str | None") -> "int | None":
    if not quantity_str:
        return None
    try:
        return parse_quantity(quantity_str).units >> 20
    except (ValueError, TypeError):
        return None


def pod_bandwidth_mi(pod_obj: dict) -> int:
    ann = _annotations(pod_obj)
    total = 0
    for key in (INGRESS_ANNOTATION, EGRESS_ANNOTATION):
        v = _mi(ann.get(key))
        if v:
            total += v
    return total


def node_limit_mi(node_obj: dict) -> "int | None":
    return _mi(_annotations(node_obj).get(NODE_LIMIT_ANNOTATION))


def _featurize(enc):
    """Annotations → arrays, computed by the builder itself: each node's
    limit and whether it has one ([N]), each pod's request ([P]), in Mi."""
    N, P = enc.N, enc.P
    node_limit = np.zeros(N, np.int64)
    node_has = np.zeros(N, bool)
    for i, n in enumerate(enc.objects.get("nodes", [])):
        lim = node_limit_mi(n)
        if lim is not None:
            node_limit[i] = lim
            node_has[i] = True
    pod_bw = np.zeros(P, np.int64)
    for i, p in enumerate(enc.pods):
        pod_bw[i] = pod_bandwidth_mi(p)
    return node_limit, node_has, pod_bw


def _inputs(enc):
    """(limit [N], has [N] bool, bw [P]) on the encoding's device, the
    integers in the policy's type."""
    limit_np, has_np, bw_np = _featurize(enc)
    dt, dev = enc.policy.res, enc.device
    return (torch.as_tensor(limit_np).to(dt).to(dev), torch.as_tensor(has_np).to(dev),
            torch.as_tensor(bw_np).to(dt).to(dev))


def allocated(a, s, bw: torch.Tensor) -> torch.Tensor:
    """[N] each node's allocated bandwidth: the requests of the bound pods
    of state s summed onto their nodes."""
    bound = (s.assignment >= 0) & a.pod_mask
    tgt = torch.clamp(s.assignment, min=0).long()
    N = a.node_mask.shape[0]
    return torch.zeros(N, dtype=bw.dtype, device=bw.device).index_add_(
        0, tgt, bw * bound.to(bw.dtype))


# -- plain bodies (the CPU's; csrc/seq_kernels.cu F_NETBW / S_NETBW on the card)


def build_nb_filter(enc):
    limit, has, bw = _inputs(enc)

    def kernel(a, s, p):
        want = bw[p]
        fail = has & (want > 0) & (allocated(a, s, bw) + want > limit)
        return fail.to(torch.int32)

    return kernel


def decode_nb(code: int, enc, node_idx: int) -> str:
    return FILTER_MESSAGE


def build_nb_score(enc):
    limit, has, bw = _inputs(enc)
    score_dt = enc.policy.score

    def kernel(a, s, p, feasible=None):
        free = limit - allocated(a, s, bw)
        return torch.where(has, free, torch.zeros_like(free)).to(score_dt)

    kernel._normalize = minmax_normalize  # plugin.go:159-186
    return kernel


class _NBRow:
    """Preemption row (engine/preempt.py's interface): each node's
    allocated bandwidth under victim removal."""

    def __init__(self, enc):
        self.limit, self.has, self.bw = _inputs(enc)

    def prepare(self, a, s, p):
        return {"allocated": allocated(a, s, self.bw)}

    def node_init(self, a, ctx, s, vm, tgt, lower):
        return {"alloc": ctx["allocated"] - _per_node(self.bw[lower], tgt, a.node_mask.shape[0])}

    def add_back(self, a, ctx, cnt, v):
        return {"alloc": cnt["alloc"] + _take(self.bw, v)}

    def active(self, a, ctx, p):
        return bool(self.bw[p] > 0)  # no request: every node passes

    def check(self, a, ctx, cnt, p):
        want = self.bw[p]
        return ~(self.has & (want > 0) & (cnt["alloc"] + want > self.limit))


# -- registration -----------------------------------------------------------


def _compile_statics(enc) -> tuple:
    """The content this plugin's builders bake into a program — folded into
    BatchedScheduler.compile_signature so a cached engine is never reused
    after the annotations change."""
    limit_np, has_np, bw_np = _featurize(enc)
    return (limit_np.tobytes(), has_np.tobytes(), bw_np.tobytes())


def _device_inputs(enc) -> dict:
    limit, has, bw = _inputs(enc)
    return {"nb_limit": limit, "nb_has": has, "nb_bw": bw}


def register() -> None:
    """Idempotently register the bodies, inputs, statics and preemption row."""
    from ..engine import kernels as K
    from ..engine import preempt

    K.FILTER_KERNELS["NetworkBandwidth"] = (build_nb_filter, decode_nb, F_NETBW)
    K.SCORE_KERNELS["NetworkBandwidth"] = (build_nb_score, "custom", S_NETBW)
    K.COMPILE_STATICS["NetworkBandwidth"] = _compile_statics
    K.DEVICE_INPUTS["NetworkBandwidth"] = _device_inputs
    preempt.ROW_FILTERS["NetworkBandwidth"] = _NBRow


register()
