"""Per-plugin filter/score bodies over the `[nodes]` axis — the plain
PyTorch versions.

Each body replaces one upstream scheduler-framework plugin's per-node
callback (reference: the wrapped plugins' Filter/Score delegation,
simulator/scheduler/plugin/wrappedplugin.go:491-516 and :388-413) with one
vectorized pass over every node at once. They are line-by-line renderings
of the reference package's `engine/kernels.py` closures, and they are what
the CPU runs. On the card the same arithmetic runs inside the hand-written
kernels of `csrc/seq_kernels.cu`, which read each plugin's static
arguments from the config block `engine/cuda.py` packs with the helpers
below (`fit_score_args`, `balanced_resources`).

Contracts:
  * filter body: `fn(arrays, state, p) -> codes[N] int32`, 0 = pass,
    >0 = plugin-specific reason code, decoded host-side by
    `decode(code, enc, node_idx)` into the upstream failure message;
  * score body: `fn(arrays, state, p, feasible) -> raw[N]` in the score
    dtype, plus a normalize mode: None (raw is final), "default"
    (helper.DefaultNormalizeScore) or "default_reverse" (reverse=True).

Integer `//` is `torch.div(..., rounding_mode="floor")`, as jnp's `//`
floors; every intermediate keeps the policy's dtype.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..sched.config import MAX_NODE_SCORE
from ..sched.oracle_plugins import BALANCED_SCALE, rtcr_shape
from .encode import PODS_RES, ClusterArrays, EncodedCluster, SchedState


def fdiv(a, b):
    """jnp `a // b` on integers: floor division."""
    return torch.div(a, b, rounding_mode="floor")


# ---------------------------------------------------------------------------
# NodeResourcesFit  (oracle: sched/oracle_plugins.py fit_filter/fit_score;
# upstream NodeResourcesFit with all three scoringStrategies —
# LeastAllocated (default), MostAllocated, RequestedToCapacityRatio)
# ---------------------------------------------------------------------------


def build_fit_filter(enc: EncodedCluster):
    R = enc.R

    def kernel(a: ClusterArrays, s: SchedState, p) -> torch.Tensor:
        req = a.pod_req[p]  # [R]
        free = a.node_alloc - s.requested  # [N, R]
        insuff = (req > 0)[None, :] & (req[None, :] > free)  # [N, R]
        too_many = s.n_pods + 1 > a.node_alloc[:, PODS_RES]
        # first violating resource in the pod's request-dict order
        rank = torch.where(
            insuff, a.pod_req_rank[p][None, :], torch.full_like(insuff, R + 1, dtype=torch.int32)
        )
        first_r = torch.argmin(rank, dim=1).to(torch.int32)
        any_insuff = insuff.any(dim=1)
        zero = torch.zeros_like(first_r)
        return torch.where(
            too_many, zero + 1, torch.where(any_insuff, 2 + first_r, zero)
        ).to(torch.int32)

    return kernel


def decode_fit(code: int, enc: EncodedCluster, node_idx: int) -> str:
    if code == 1:
        return "Too many pods"
    return f"Insufficient {enc.resource_names[code - 2]}"


# scoring-strategy type ids, shared with the kernel's config block
FIT_LEAST, FIT_MOST, FIT_RTCR = 0, 1, 2


def fit_score_args(enc: EncodedCluster):
    """NodeResourcesFit's static score arguments: (strategy id,
    [(resource index, weight)], weight sum, RequestedToCapacityRatio shape
    or None). Resources never seen in the cluster still contribute weight
    with score 0 (capacity 0), as in the oracle's loop over configured
    specs."""
    args = enc.config.plugin_args("NodeResourcesFit")
    strategy = args.get("scoringStrategy") or {}
    resources = strategy.get("resources") or [
        {"name": "cpu", "weight": 1},
        {"name": "memory", "weight": 1},
    ]
    stype = {"MostAllocated": FIT_MOST, "RequestedToCapacityRatio": FIT_RTCR}.get(
        strategy.get("type", "LeastAllocated"), FIT_LEAST
    )
    specs = [
        (enc.resource_names.index(r["name"]), int(r.get("weight", 1)))
        for r in resources
        if r["name"] in enc.resource_names
    ]
    zero_weight = sum(
        int(r.get("weight", 1)) for r in resources if r["name"] not in enc.resource_names
    )
    wsum = sum(w for _, w in specs) + zero_weight
    shape = rtcr_shape(strategy) if stype == FIT_RTCR else None
    return stype, specs, wsum, shape


def broken_linear_vec(shape, u: torch.Tensor) -> torch.Tensor:
    """helper.BuildBrokenLinearFunction over a [N] utilization vector:
    ascending segments overwrite where u >= x1, ends clamp — integer math
    with Go's trunc-toward-zero division (floor division needs the sign
    fixup)."""
    y = torch.full_like(u, shape[0][1])
    for (x1, y1), (x2, y2) in zip(shape, shape[1:]):
        prod = (u - x1) * (y2 - y1)
        dx = max(x2 - x1, 1)
        seg = torch.sign(prod) * fdiv(torch.abs(prod), dx) + y1
        y = torch.where(u >= x1, seg.to(y.dtype), y)
    return torch.where(u >= shape[-1][0], torch.full_like(y, shape[-1][1]), y)


def build_fit_score(enc: EncodedCluster):
    stype, specs, wsum, shape = fit_score_args(enc)
    score_dt = enc.policy.score

    def kernel(a: ClusterArrays, s: SchedState, p, feasible=None) -> torch.Tensor:
        total = torch.zeros(a.node_mask.shape[0], dtype=score_dt, device=a.node_mask.device)
        for r_idx, w in specs:
            cap = a.node_alloc[:, r_idx]
            req = s.s_requested[:, r_idx] + a.pod_sreq[p, r_idx]
            over = (cap == 0) | (req > cap)
            cap1 = torch.clamp(cap, min=1)
            if stype == FIT_RTCR:
                # over-capacity / zero-capacity evaluates the shape at
                # max utilization (upstream resourceScoringFunction)
                u = torch.where(
                    over, torch.full_like(req, 100), fdiv(req * 100, cap1)
                ).to(score_dt)
                r_score = broken_linear_vec(shape, u)
            elif stype == FIT_MOST:
                r_score = fdiv(req * MAX_NODE_SCORE, cap1)
                r_score = torch.where(over, torch.zeros_like(r_score), r_score)
            else:  # LeastAllocated
                r_score = fdiv((cap - req) * MAX_NODE_SCORE, cap1)
                r_score = torch.where(over, torch.zeros_like(r_score), r_score)
            total = total + r_score.to(score_dt) * w
        if wsum == 0:
            return total
        return fdiv(total, wsum)

    return kernel


# ---------------------------------------------------------------------------
# NodeResourcesBalancedAllocation  (oracle: balanced_allocation_score;
# upstream balancedResourceScorer: 100 * (1 - std of usage fractions))
# ---------------------------------------------------------------------------


def _exact_isqrt64(x: torch.Tensor) -> torch.Tensor:
    """floor(sqrt(x)) for int64 x < 2^52, exact: the float64 sqrt of an
    exactly-representable int is correctly rounded, then one-step adjusted."""
    s = torch.floor(torch.sqrt(x.to(torch.float64))).to(x.dtype)
    s = torch.where(s * s > x, s - 1, s)
    s = torch.where((s + 1) * (s + 1) <= x, s + 1, s)
    return s


def _div_scale_exact(num: torch.Tensor, den: torch.Tensor, scale_bits: int) -> torch.Tensor:
    """floor(num * 2^scale_bits / den) without widening past the input
    dtype: base-256 long division, exact as long as den < 2^(31-8). This
    keeps the int32 policy overflow-free — the encoder clamps device
    quantities to 2^23-1 for exactly this reason."""
    den = torch.clamp(den, min=1)
    acc = fdiv(num, den)
    rem = torch.remainder(num, den)
    for shift in range(0, scale_bits, 8):
        bits = min(8, scale_bits - shift)
        acc = acc * (1 << bits) + fdiv(rem * (1 << bits), den)
        rem = torch.remainder(rem * (1 << bits), den)
    return acc


def balanced_resources(enc: EncodedCluster) -> list[int]:
    """BalancedAllocation's resource indices, in configured order."""
    args = enc.config.plugin_args("NodeResourcesBalancedAllocation")
    resources = args.get("resources") or [
        {"name": "cpu", "weight": 1},
        {"name": "memory", "weight": 1},
    ]
    return [
        enc.resource_names.index(r["name"])
        for r in resources
        if r["name"] in enc.resource_names
    ]


def build_balanced_score(enc: EncodedCluster):
    """Quantized-integer balanced allocation (see the reference's
    oracle_plugins.py balanced_allocation_score): usage fractions in units
    of 1/2^16, std decided by integer arithmetic. The two-resource default
    config is exact in both dtype policies; the >2-resource variance branch
    is exact under EXACT (int64 + isqrt) and float32 under TPU32."""
    idxs = balanced_resources(enc)
    S = BALANCED_SCALE
    S_BITS = S.bit_length() - 1
    exact64 = enc.policy.name == "exact"
    score_dt = enc.policy.score

    def kernel(a: ClusterArrays, s: SchedState, p, feasible=None) -> torch.Tensor:
        N = a.node_mask.shape[0]
        if not idxs:
            return torch.full((N,), MAX_NODE_SCORE, dtype=score_dt, device=a.node_mask.device)
        caps = torch.stack([a.node_alloc[:, i] for i in idxs], dim=1)  # [N, K]
        reqs = torch.stack(
            [s.s_requested[:, i] + a.pod_sreq[p, i] for i in idxs], dim=1
        )
        incl = caps > 0
        # Clamp requested to capacity BEFORE the long division (fractions
        # cap at 1 anyway); keeps _div_scale_exact's no-overflow
        # precondition when usage wildly exceeds a tiny capacity.
        q = _div_scale_exact(torch.minimum(reqs, caps), caps, S_BITS)  # [N, K]
        nf = incl.sum(dim=1).to(q.dtype)
        # nf == 2 branch: std = |q0 - q1| / (2S); ints stay under 2^24.
        info = torch.iinfo(q.dtype)
        qmax = torch.where(incl, q, torch.full_like(q, info.min)).amax(dim=1)
        qmin = torch.where(incl, q, torch.full_like(q, info.max)).amin(dim=1)
        d = qmax - qmin
        score2 = fdiv(200 * S - 100 * d, 2 * S)
        # general branch: A = nf*Σq² - (Σq)², std = sqrt(A)/(nf*S),
        # score = 100 - ceil(100*sqrt(A)/(nf*S)).
        if exact64:
            zero = torch.zeros_like(q)
            sum_q = torch.where(incl, q, zero).sum(dim=1)
            sum_q2 = torch.where(incl, q * q, zero).sum(dim=1)
            A = nf * sum_q2 - sum_q * sum_q
            x2 = 10000 * A
            D = torch.clamp(nf, min=1) * S
            # ceil(sqrt(x2)/D) == isqrt(x2-1)//D + 1 for x2 > 0
            k = torch.where(
                x2 == 0,
                torch.zeros_like(x2),
                fdiv(_exact_isqrt64(torch.clamp(x2 - 1, min=0)), D) + 1,
            )
            score_n = (MAX_NODE_SCORE - k).to(q.dtype)
        else:
            # float32, summed over the K resources left to right (the
            # kernel sums in the same order, so the roundings agree)
            f = q.to(torch.float32) / S
            nff = torch.clamp(nf, min=1).to(torch.float32)
            fz = torch.where(incl, f, torch.zeros_like(f))
            mean = fz[:, 0]
            for j in range(1, fz.shape[1]):
                mean = mean + fz[:, j]
            mean = mean / nff
            dev = f - mean[:, None]
            sq = torch.where(incl, dev * dev, torch.zeros_like(f))
            var = sq[:, 0]
            for j in range(1, sq.shape[1]):
                var = var + sq[:, j]
            var = var / nff
            std = torch.sqrt(var)
            score_n = torch.floor((1 - std) * MAX_NODE_SCORE).to(q.dtype)
        score = torch.where(nf == 2, score2, score_n)
        score = torch.where(nf < 2, torch.full_like(score, MAX_NODE_SCORE), score)
        return score.to(score_dt)

    return kernel


# ---------------------------------------------------------------------------
# NodeName / NodeUnschedulable  (oracle: node_name_filter,
# node_unschedulable_filter)
# ---------------------------------------------------------------------------


def build_node_name_filter(enc: EncodedCluster):
    def kernel(a: ClusterArrays, s: SchedState, p) -> torch.Tensor:
        want = a.pod_node_name[p]
        node_ids = torch.arange(a.node_mask.shape[0], dtype=torch.int32, device=want.device)
        fail = (want != -1) & (node_ids != want)
        return fail.to(torch.int32)

    return kernel


def decode_node_name(code: int, enc: EncodedCluster, node_idx: int) -> str:
    return "node(s) didn't match the requested node name"


def build_node_unschedulable_filter(enc: EncodedCluster):
    def kernel(a: ClusterArrays, s: SchedState, p) -> torch.Tensor:
        fail = a.node_unsched & ~a.pod_tol_unsched[p]
        return fail.to(torch.int32)

    return kernel


def decode_node_unschedulable(code: int, enc: EncodedCluster, node_idx: int) -> str:
    return "node(s) were unschedulable"


# ---------------------------------------------------------------------------
# TaintToleration  (oracle: taint_toleration_filter/score/normalize;
# models/objects.py toleration_tolerates_taint)
# ---------------------------------------------------------------------------


def _tolerated(a: ClusterArrays, p) -> torch.Tensor:
    """[N, T] — is each node taint tolerated by pod p's tolerations?"""
    tk = a.tol_key[p][:, None, None]  # [L, 1, 1]
    tv = a.tol_val[p][:, None, None]
    te = a.tol_effect[p][:, None, None]
    to = a.tol_op[p][:, None, None]
    nk = a.taint_key[None, :, :]  # [1, N, T]
    nv = a.taint_val[None, :, :]
    ne = a.taint_effect[None, :, :]
    valid = to >= 0
    eff_ok = (te == -1) | (te == ne)
    key_ok = (tk == -1) | (tk == nk)
    # Exists always matches; Equal needs the value; unknown ops (2) never
    val_ok = (to == 1) | ((to == 0) & (tv == nv))
    return (valid & eff_ok & key_ok & val_ok).any(dim=0)  # [N, T]


def build_taint_filter(enc: EncodedCluster):
    def kernel(a: ClusterArrays, s: SchedState, p) -> torch.Tensor:
        tolerated = _tolerated(a, p)
        intolerable = (a.taint_effect == 0) | (a.taint_effect == 2)  # NoSchedule|NoExecute
        bad = intolerable & ~tolerated  # [N, T]
        first_bad = torch.argmax(bad.to(torch.int32), dim=1).to(torch.int32)  # first True slot
        return torch.where(
            bad.any(dim=1), first_bad + 1, torch.zeros_like(first_bad)
        ).to(torch.int32)

    return kernel


def decode_taint(code: int, enc: EncodedCluster, node_idx: int) -> str:
    taint = enc.aux["node_taints"][node_idx][code - 1]
    return (
        "node(s) had untolerated taint "
        f"{{{taint.get('key', '')}: {taint.get('value', '')}}}"
    )


def build_taint_score(enc: EncodedCluster):
    score_dt = enc.policy.score

    def kernel(a: ClusterArrays, s: SchedState, p, feasible=None) -> torch.Tensor:
        tolerated = _tolerated(a, p)
        prefer = a.taint_effect == 1  # PreferNoSchedule
        return (prefer & ~tolerated).sum(dim=1).to(score_dt)

    return kernel


# ---------------------------------------------------------------------------
# registries: the slice's plugins. Each entry also names the plugin's id in
# the kernel's config block (csrc/seq_kernels.cu FILTER_* / SCORE_*).
# ---------------------------------------------------------------------------

# name -> (builder(enc) -> filter body, decode(code, enc, node) -> message, kernel id)
FILTER_KERNELS: dict[str, tuple[Callable, Callable, int]] = {
    "NodeUnschedulable": (build_node_unschedulable_filter, decode_node_unschedulable, 0),
    "NodeName": (build_node_name_filter, decode_node_name, 1),
    "TaintToleration": (build_taint_filter, decode_taint, 2),
    "NodeResourcesFit": (build_fit_filter, decode_fit, 3),
}

# name -> (builder(enc) -> score body, normalize mode, kernel id)
SCORE_KERNELS: dict[str, tuple[Callable, "str | None", int]] = {
    "NodeResourcesFit": (build_fit_score, None, 0),
    "NodeResourcesBalancedAllocation": (build_balanced_score, None, 1),
    "TaintToleration": (build_taint_score, "default_reverse", 2),
}

# preFilter plugins that can veto a pod before the per-node loop: none in
# this slice (NodePorts' self-conflict, VolumeBinding come later).
PREFILTER_KERNELS: dict[str, tuple[Callable, Callable]] = {}

# preFilter plugins whose oracle implementation only caches state and can
# never fail — the engine just records "success" for them.
TRIVIAL_PREFILTER: set[str] = {"NodeResourcesFit"}

# preScore plugins that can fail/skip: none in this slice.
PRESCORE_KERNELS: dict[str, tuple[Callable, Callable]] = {}

TRIVIAL_PRESCORE: set[str] = {
    "TaintToleration",
    "NodeAffinity",
    "NodeResourcesFit",
    "NodeResourcesBalancedAllocation",
}

# postFilter (preemption) kernels: none in this slice.
POSTFILTER_KERNELS: dict[str, Callable] = {}
