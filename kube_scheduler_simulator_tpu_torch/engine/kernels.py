"""Per-plugin filter/score bodies over the `[nodes]` axis — the plain
PyTorch versions.

Each body replaces one upstream scheduler-framework plugin's per-node
callback (reference: the wrapped plugins' Filter/Score delegation,
simulator/scheduler/plugin/wrappedplugin.go:491-516 and :388-413) with one
vectorized pass over every node at once. They are line-by-line renderings
of the reference package's `engine/kernels.py` and `engine/kernels_vol.py`
closures, and they are what the CPU runs. On the card the same arithmetic runs inside the hand-written
kernels of `csrc/seq_kernels.cu`, which read each plugin's static
arguments from the config block `engine/cuda.py` packs with the helpers
below (`fit_score_args`, `balanced_resources`).

Contracts:
  * filter body: `fn(arrays, state, p) -> codes[N] int32`, 0 = pass,
    >0 = plugin-specific reason code, decoded host-side by
    `decode(code, enc, node_idx)` into the upstream failure message;
  * score body: `fn(arrays, state, p, feasible) -> raw[N]` in the score
    dtype, plus a normalize mode: None (raw is final), "default"
    (helper.DefaultNormalizeScore), "default_reverse" (reverse=True) or
    "custom" (the body's own `_normalize(a, s, p, raw, feasible)`:
    PodTopologySpread, InterPodAffinity).

Integer `//` is `torch.div(..., rounding_mode="floor")`, as jnp's `//`
floors; every intermediate keeps the reference's dtype. Sums over an axis
widen to int64 (the reference runs with 64-bit types enabled, where
`jnp.sum` of int32 gives int64) and are cast back where the reference casts.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..sched.config import MAX_NODE_SCORE
from ..sched.oracle_plugins import (
    _IMG_MAX_CONTAINER_KI,
    _IMG_MIN_KI,
    _VOLUME_LIMITS,
    BALANCED_SCALE,
    SPREAD_SCALE,
    rtcr_shape,
)
from .encode import PODS_RES, ClusterArrays, EncodedCluster, SchedState
from .encode_rel import match_clauses, match_clauses_rev
from .encode_vol import VOL_LIMIT_PLUGINS

# int32 max: the reference's sentinel in the custom normalizes' min/max
BIG = (1 << 31) - 1


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
# NodeAffinity / nodeSelector  (oracle: node_affinity_filter/score)
# ---------------------------------------------------------------------------


def _terms_match(a: ClusterArrays, key, op, vals, num, num_ok, term_valid):
    """Per term: AND over its expressions, against every node.

    key/op/num/num_ok: [TM, E]; vals: [TM, E, VV]; term_valid: [TM].
    Returns match[TM, N]."""
    key_safe = torch.clamp(key, min=0)
    nval = a.label_val.T[key_safe]  # [TM, E, N]
    nnum = a.label_num.T[key_safe]
    nnum_ok = a.label_num_ok.T[key_safe]
    present = nval >= 0
    eq_any = (nval[..., None, :] == vals[..., :, None]).any(dim=-2)  # [TM, E, N]
    is_in = present & eq_any
    # NotIn matches an absent key too (value padding is VAL_PAD = -3, never
    # the absent sentinel -1, so eq_any is False for absent keys)
    not_in = ~is_in
    num_cmp_ok = present & nnum_ok & num_ok[..., None]
    gt = num_cmp_ok & (nnum > num[..., None])
    lt = num_cmp_ok & (nnum < num[..., None])
    opx = op[..., None]
    never = torch.zeros_like(present)
    m = torch.where(
        opx == 0, is_in,
        torch.where(opx == 1, not_in,
        torch.where(opx == 2, present,
        torch.where(opx == 3, ~present,
        torch.where(opx == 4, gt,
        torch.where(opx == 5, lt, never))))))
    # padded expression slots (key == -1) are neutral for the AND
    m = m | (key == -1)[..., None]
    return m.all(dim=-2) & term_valid[:, None]  # [TM, N]


def node_affinity_ok(a: ClusterArrays, p) -> torch.Tensor:
    """[N] bool: pod p's nodeSelector and required node-affinity terms
    hold on each node (the NodeAffinity filter, also read by the spread
    kernels whether or not NodeAffinity is enabled)."""
    k = a.nsel_key[p]  # [NS]
    nval = a.label_val.T[torch.clamp(k, min=0)]  # [NS, N]
    sel_ok = ((nval == a.nsel_val[p][:, None]) | (k == -1)[:, None]).all(dim=0)
    tmatch = _terms_match(
        a, a.raff_key[p], a.raff_op[p], a.raff_vals[p], a.raff_num[p],
        a.raff_num_ok[p], a.raff_term_valid[p],
    )
    req_ok = tmatch.any(dim=0) | ~a.pod_has_raff[p]  # no terms: pass
    return sel_ok & req_ok


def build_node_affinity_filter(enc: EncodedCluster):
    def kernel(a: ClusterArrays, s: SchedState, p) -> torch.Tensor:
        return (~node_affinity_ok(a, p)).to(torch.int32)

    return kernel


def decode_node_affinity(code: int, enc: EncodedCluster, node_idx: int) -> str:
    return "node(s) didn't match Pod's node affinity/selector"


def build_node_affinity_score(enc: EncodedCluster):
    score_dt = enc.policy.score

    def kernel(a: ClusterArrays, s: SchedState, p, feasible=None) -> torch.Tensor:
        tmatch = _terms_match(
            a, a.paff_key[p], a.paff_op[p], a.paff_vals[p], a.paff_num[p],
            a.paff_num_ok[p], a.paff_term_valid[p],
        )  # [PR, N]
        w = a.paff_weight[p][:, None]
        return torch.where(tmatch, w, torch.zeros_like(w)).sum(dim=0).to(score_dt)

    return kernel


# ---------------------------------------------------------------------------
# NodePorts  (oracle: node_ports_filter; the prefilter only caches state)
# ---------------------------------------------------------------------------


def build_node_ports_filter(enc: EncodedCluster):
    def kernel(a: ClusterArrays, s: SchedState, p) -> torch.Tensor:
        wild = a.want_wild[p] > 0  # [Q]
        trip = a.want_trip[p] > 0  # [V2]
        wild_conflict = (wild[None, :] & (s.used_pair > 0)).any(dim=1)
        trip_conflict = (
            trip[None, :] & ((s.used_trip > 0) | (s.used_wild[:, a.trip_pair.long()] > 0))
        ).any(dim=1)
        return (wild_conflict | trip_conflict).to(torch.int32)

    return kernel


def decode_node_ports(code: int, enc: EncodedCluster, node_idx: int) -> str:
    return "node(s) didn't have free ports for the requested pod ports"


# ---------------------------------------------------------------------------
# ImageLocality  (oracle: image_locality_score, in Ki units)
# ---------------------------------------------------------------------------


def build_image_locality_score(enc: EncodedCluster):
    score_dt = enc.policy.score

    def kernel(a: ClusterArrays, s: SchedState, p, feasible=None) -> torch.Tensor:
        dt = a.img_contrib.dtype
        counts = a.pod_img[p].to(dt)  # [I]
        ss = (a.img_contrib * counts[None, :]).sum(dim=1)  # [N] int64
        ncont = a.pod_ncont[p].to(dt)
        maxth = _IMG_MAX_CONTAINER_KI * ncont
        hi = torch.clamp(maxth, min=_IMG_MIN_KI + 1)
        ss = torch.minimum(torch.clamp(ss, min=_IMG_MIN_KI), hi)
        x = ss - _IMG_MIN_KI
        den = torch.clamp(maxth - _IMG_MIN_KI, min=1)
        # (100*x)//den as two base-10 digits, so int32 never overflows
        a1 = fdiv(x, den)
        r = torch.remainder(x, den)
        d1 = fdiv(r * 10, den)
        r2 = torch.remainder(r * 10, den)
        d2 = fdiv(r2 * 10, den)
        score = a1 * 100 + d1 * 10 + d2
        # zero-container pods score 0 (the oracle guards the same way)
        return torch.where(ncont == 0, torch.zeros_like(score), score).to(score_dt)

    return kernel


# ---------------------------------------------------------------------------
# PodTopologySpread  (oracle: spread_pre_filter/spread_filter/
# spread_pre_score/spread_score/spread_normalize). The per-topology-value
# match counts are reduced each step by scatter-adds keyed on
# state.assignment.
# ---------------------------------------------------------------------------


def _spread_counts(a: ClusterArrays, s: SchedState, p, ctype, ckey, cpairs):
    """[T, N]: per constraint, the matching bound pods on each node (same
    namespace as pod p, not being deleted)."""
    rel = a.rel
    m = match_clauses(rel, ctype, ckey, cpairs)  # [T, P]
    live = (
        (rel.ns_id == rel.ns_id[p])
        & ~rel.deleted
        & a.pod_mask
        & (s.assignment >= 0)
    )
    mm = (m & live[None, :]).to(torch.int32)  # [T, P]
    out = torch.zeros((ctype.shape[0], a.node_mask.shape[0]), dtype=torch.int32,
                      device=mm.device)
    return out.index_add_(1, torch.clamp(s.assignment, min=0).long(), mm)


def _pairs_at(rel, keys):
    """[N, C] int64: each node's topology pair at each constraint's key
    column (0 = key absent)."""
    return rel.node_pair[:, torch.clamp(keys, min=0).long()].long()


def _pair_sums(src_nc, pairs, NP1):
    """[C, NP1]: per constraint, src [N, C] summed by each node's pair."""
    out = torch.zeros((pairs.shape[1], NP1), dtype=torch.int32, device=pairs.device)
    return out.scatter_add_(1, pairs.T.contiguous(), src_nc.T.to(torch.int32).contiguous())


def build_spread_filter(enc: EncodedCluster):
    NP1 = enc.aux["n_node_pairs"] + 1

    def kernel(a: ClusterArrays, s: SchedState, p) -> torch.Tensor:
        rel = a.rel
        N = a.node_mask.shape[0]
        keys = rel.sph_key[p]  # [HC]
        valid = keys >= 0
        pairs = _pairs_at(rel, keys)  # [N, HC]
        has_key = pairs > 0
        has_all = (has_key | ~valid[None, :]).all(dim=1)  # [N]
        elig = node_affinity_ok(a, p) & has_all & a.node_mask
        cnt_node = _spread_counts(a, s, p, rel.sph_ctype[p], rel.sph_ckey[p],
                                  rel.sph_cpairs[p])  # [HC, N]
        val_cnt = _pair_sums(cnt_node.T * elig[:, None], pairs, NP1)
        present = _pair_sums(elig[:, None] & has_key, pairs, NP1)
        pmask = (present > 0) & (torch.arange(NP1, device=pairs.device) > 0)[None, :]
        min_c = torch.where(pmask, val_cnt, torch.full_like(val_cnt, BIG)).amin(dim=1)
        min_c = torch.where(pmask.any(dim=1), min_c, torch.zeros_like(min_c))  # [HC]
        node_cnt = val_cnt.gather(1, pairs.T).T  # [N, HC]
        skew = node_cnt + rel.sph_self[p][None, :].to(torch.int32) - min_c[None, :]
        fail_skew = skew > rel.sph_skew[p][None, :]
        zero = torch.zeros_like(skew)
        code_c = torch.where(
            ~valid[None, :], zero,
            torch.where(~has_key, zero + 1, torch.where(fail_skew, zero + 2, zero)),
        )  # [N, HC]
        first = torch.argmax((code_c != 0).to(torch.int32), dim=1)
        first_code = code_c[torch.arange(N, device=first.device), first]
        return torch.where((code_c != 0).any(dim=1), first_code, torch.zeros_like(first_code))

    return kernel


def decode_spread(code: int, enc: EncodedCluster, node_idx: int) -> str:
    if code == 1:
        return (
            "node(s) didn't match pod topology spread constraints "
            "(missing required label)"
        )
    return "node(s) didn't match pod topology spread constraints"


def _zero_score(enc: EncodedCluster):
    """A score body (and custom normalize) that is 0 everywhere: the
    oracle's result when the plugin's PreScore is disabled, since its
    score consumes PreScore state."""
    score_dt = enc.policy.score

    def kernel(a, s, p, feasible=None):
        return torch.zeros(a.node_mask.shape[0], dtype=score_dt, device=a.node_mask.device)

    kernel._normalize = lambda a, s, p, raw, feasible: torch.zeros_like(raw)
    return kernel


def build_spread_score(enc: EncodedCluster):
    """Raw score: Σ_c count(c) * log-weight(c) in SPREAD_SCALE fixed point,
    plus Σ(maxSkew-1), banker's-rounded."""
    if "PodTopologySpread" not in enc.config.enabled("preScore"):
        return _zero_score(enc)
    NP1 = enc.aux["n_node_pairs"] + 1
    score_dt = enc.policy.score

    def soft_ignored(a: ClusterArrays, p, feasible):
        rel = a.rel
        keys = rel.sps_key[p]
        valid = keys >= 0
        pairs = _pairs_at(rel, keys)
        has_key = pairs > 0
        has_all = (has_key | ~valid[None, :]).all(dim=1)
        ignored = feasible & rel.req_all[p] & ~has_all
        return keys, valid, pairs, has_key, has_all, ignored

    def kernel(a: ClusterArrays, s: SchedState, p, feasible) -> torch.Tensor:
        rel = a.rel
        keys, valid, pairs, has_key, has_all, ignored = soft_ignored(a, p, feasible)
        scored = feasible & ~ignored
        n_scored = scored.sum().to(torch.int32)
        count_mask = (
            node_affinity_ok(a, p)
            & torch.where(rel.req_all[p], has_all, torch.ones_like(has_all))
            & a.node_mask
        )
        cnt_node = _spread_counts(a, s, p, rel.sps_ctype[p], rel.sps_ckey[p],
                                  rel.sps_cpairs[p])  # [SC, N]
        val_cnt = _pair_sums(cnt_node.T * count_mask[:, None], pairs, NP1)
        present = _pair_sums(scored[:, None] & has_key, pairs, NP1)
        arange = torch.arange(NP1, device=pairs.device)
        topo_size = ((present > 0) & (arange > 0)[None, :]).sum(dim=1)
        host = rel.sps_host[p]  # [SC]
        w_m = torch.where(host, n_scored.to(topo_size.dtype), topo_size)
        lut = rel.spread_lut
        w_q = lut[torch.clamp(w_m, 0, lut.shape[0] - 1)]  # [SC] int32
        node_cnt = val_cnt.gather(1, pairs.T).T  # [N, SC]
        val_ok = present.gather(1, pairs.T).T > 0
        cnt = torch.where(host[None, :], cnt_node.T, node_cnt)
        apply = valid[None, :] & has_key & (host[None, :] | val_ok)
        zero = torch.zeros_like(cnt)
        totq = (torch.where(apply, cnt, zero) * w_q[None, :]).sum(dim=1)  # int64
        mssum = torch.where(apply, rel.sps_skew[p][None, :] - 1, zero).sum(dim=1)
        q, r = fdiv(totq, SPREAD_SCALE), torch.remainder(totq, SPREAD_SCALE)
        up = (2 * r > SPREAD_SCALE) | ((2 * r == SPREAD_SCALE) & (torch.remainder(q, 2) == 1))
        raw = mssum + q + up.to(q.dtype)
        return torch.where(ignored, torch.zeros_like(raw), raw).to(score_dt)

    def normalize(a: ClusterArrays, s: SchedState, p, raw, feasible):
        keys, *_, ignored = soft_ignored(a, p, feasible)
        live = feasible & ~ignored
        minv = torch.where(live, raw, torch.full_like(raw, BIG)).min()
        maxv = torch.where(live, raw, torch.full_like(raw, -BIG)).max()
        normed = torch.where(
            maxv == 0,
            torch.full_like(raw, MAX_NODE_SCORE),
            fdiv(MAX_NODE_SCORE * (maxv + minv - raw), torch.clamp(maxv, min=1)),
        )
        normed = torch.where(ignored, torch.zeros_like(normed), normed)
        active = (keys >= 0).any() & live.any()
        return torch.where(active, normed, torch.zeros_like(normed)).to(raw.dtype)

    kernel._normalize = normalize
    return kernel


# ---------------------------------------------------------------------------
# InterPodAffinity  (oracle: interpod_pre_filter/interpod_filter/
# interpod_pre_score/interpod_score/interpod_normalize). Both matching
# directions: the incoming pod's terms against every pod (match_clauses)
# and every pod's terms against the incoming pod (match_clauses_rev);
# topology reduces through the node (key,value)-pair vocabulary with
# scatter-adds keyed on state.assignment.
# ---------------------------------------------------------------------------


def _ipa_forward_live(a: ClusterArrays, s: SchedState, p, nsall, nsmh):
    """[T, P]: liveness and namespace mask of the incoming pod's terms
    against every candidate target pod (bound, real, in the term's
    namespaces)."""
    rel = a.rel
    bound = (s.assignment >= 0) & a.pod_mask
    ns_ok = nsall[p][:, None] | nsmh[p][:, rel.ns_id.long()]  # [T, P]
    return ns_ok & bound[None, :]


def _pair_of_assigned(a: ClusterArrays, s: SchedState, key_cols):
    """[T, P] int64: each pod's node-pair id at each term's key column; 0
    where the pod is unbound or the term has no key."""
    rel = a.rel
    np_assigned = rel.node_pair[torch.clamp(s.assignment, min=0).long()]  # [P, K]
    pair = np_assigned[:, torch.clamp(key_cols, min=0).long()].T  # [T, P]
    ok = (key_cols >= 0)[:, None] & (s.assignment >= 0)[None, :]
    return torch.where(ok, pair, torch.zeros_like(pair)).long()


def _forward_match(a, s, p, key_cols, ctype, ckey, cpairs, nsall, nsmh):
    """(m [T, P], pair_tp [T, P]): per incoming term, which bound pods
    match, and the (topologyKey, value) pair id of each pod's node."""
    m = match_clauses(a.rel, ctype[p], ckey[p], cpairs[p])  # [T, P]
    m = m & _ipa_forward_live(a, s, p, nsall, nsmh)
    return m, _pair_of_assigned(a, s, key_cols[p])


def _forward_pair_counts(a, s, p, key_cols, ctype, ckey, cpairs, nsall, nsmh, NP1):
    """[T, NP1]: per incoming term, matching bound pods grouped by the
    (topologyKey, value) pair of their node."""
    m, pair_tp = _forward_match(a, s, p, key_cols, ctype, ckey, cpairs, nsall, nsmh)
    out = torch.zeros((pair_tp.shape[0], NP1), dtype=torch.int32, device=m.device)
    return out.scatter_add_(1, pair_tp, m.to(torch.int32))


def _reverse_pairs(a: ClusterArrays, s: SchedState, p, key, ctype, ckey, cpairs, nsall, nsmh):
    """(contrib [P, T], pair_ot [P, T]): which existing pods' terms select
    the incoming pod p, and the pair of each such pod's node at the term's
    key."""
    rel = a.rel
    bound = (s.assignment >= 0) & a.pod_mask
    rev = match_clauses_rev(rel, ctype, ckey, cpairs, p)  # [P, T]
    ns_ok = nsall | nsmh[:, :, rel.ns_id[p].long()]  # [P, T]
    np_assigned = rel.node_pair[torch.clamp(s.assignment, min=0).long()]  # [P, K]
    pair_ot = torch.gather(np_assigned, 1, torch.clamp(key, min=0).long()).long()  # [P, T]
    contrib = rev & ns_ok & (key >= 0) & bound[:, None] & (pair_ot > 0)
    return contrib, pair_ot


def build_interpod_filter(enc: EncodedCluster):
    NP1 = enc.aux["n_node_pairs"] + 1

    def kernel(a: ClusterArrays, s: SchedState, p) -> torch.Tensor:
        rel = a.rel
        dev = a.node_mask.device
        node_pair = rel.node_pair.long()
        # (1) existing pods' required anti-affinity against the incoming pod
        contrib, pair_ot = _reverse_pairs(a, s, p, rel.ian_key, rel.ian_ctype, rel.ian_ckey,
                                          rel.ian_cpairs, rel.ian_nsall, rel.ian_ns)
        ea_cnt = torch.zeros(NP1, dtype=torch.int32, device=dev).index_add_(
            0, pair_ot.flatten(), contrib.flatten().to(torch.int32))
        ea_node = ea_cnt[node_pair]  # [N, K]
        fail1 = ((ea_node > 0) & (node_pair > 0)).any(dim=1)
        # (2) the incoming pod's required anti-affinity
        anti_cnt = _forward_pair_counts(
            a, s, p, rel.ian_key, rel.ian_ctype, rel.ian_ckey, rel.ian_cpairs,
            rel.ian_nsall, rel.ian_ns, NP1,
        )  # [T, NP1]
        key2 = rel.ian_key[p]  # [T]
        npair2 = _pairs_at(rel, key2)  # [N, T]
        cnt2 = anti_cnt.gather(1, npair2.T).T  # [N, T]
        fail2 = ((npair2 > 0) & (cnt2 > 0) & (key2 >= 0)[None, :]).any(dim=1)
        # (3) the incoming pod's required affinity
        aff_cnt = _forward_pair_counts(
            a, s, p, rel.ia_key, rel.ia_ctype, rel.ia_ckey, rel.ia_cpairs,
            rel.ia_nsall, rel.ia_ns, NP1,
        )
        key3 = rel.ia_key[p]
        tvalid3 = key3 >= 0
        npair3 = _pairs_at(rel, key3)
        cnt3 = aff_cnt.gather(1, npair3.T).T
        satisfied = (((npair3 > 0) & (cnt3 > 0)) | ~tvalid3[None, :]).all(dim=1)
        # first pod in a series: no term matched anything anywhere AND the
        # pod matches all of its own terms, on nodes that carry every
        # requested topology key (upstream satisfyPodAffinity)
        total_matches = aff_cnt[:, 1:].sum()
        self_all = (rel.ia_self[p] | ~tvalid3).all()
        has_all_keys = ((npair3 > 0) | ~tvalid3[None, :]).all(dim=1)  # [N]
        pass3 = satisfied | (has_all_keys & (total_matches == 0) & self_all)
        fail3 = tvalid3.any() & ~pass3
        zero = torch.zeros_like(fail1, dtype=torch.int32)
        return torch.where(fail1, zero + 1,
                           torch.where(fail2, zero + 2, torch.where(fail3, zero + 3, zero)))

    return kernel


def decode_interpod(code: int, enc: EncodedCluster, node_idx: int) -> str:
    return {
        1: "node(s) didn't satisfy existing pods anti-affinity rules",
        2: "node(s) didn't match pod anti-affinity rules",
        3: "node(s) didn't match pod affinity rules",
    }[code]


def interpod_hard_weight(enc: EncodedCluster) -> int:
    """InterPodAffinityArgs.hardPodAffinityWeight (0 drops the existing
    pods' required affinity from the score)."""
    return int(enc.config.plugin_args("InterPodAffinity").get("hardPodAffinityWeight", 1))


def build_interpod_score(enc: EncodedCluster):
    """Per (topologyKey, value) pair, the weight of every matching term in
    both directions, summed over each node's pairs."""
    if "InterPodAffinity" not in enc.config.enabled("preScore"):
        return _zero_score(enc)
    NP1 = enc.aux["n_node_pairs"] + 1
    hard_w = interpod_hard_weight(enc)
    score_dt = enc.policy.score

    def kernel(a: ClusterArrays, s: SchedState, p, feasible) -> torch.Tensor:
        rel = a.rel
        wsum = torch.zeros(NP1, dtype=score_dt, device=a.node_mask.device)
        # the incoming pod's preferred terms against existing pods (±w)
        for key, ct, ck, cp, na, nm, w, sign in (
            (rel.ipa_key, rel.ipa_ctype, rel.ipa_ckey, rel.ipa_cpairs,
             rel.ipa_nsall, rel.ipa_ns, rel.ipa_weight, 1),
            (rel.ipan_key, rel.ipan_ctype, rel.ipan_ckey, rel.ipan_cpairs,
             rel.ipan_nsall, rel.ipan_ns, rel.ipan_weight, -1),
        ):
            m, pair_tp = _forward_match(a, s, p, key, ct, ck, cp, na, nm)
            wt = (sign * w[p]).to(score_dt)[:, None]  # [T, 1]
            wsum.index_add_(0, pair_tp.flatten(),
                            torch.where(m, wt, torch.zeros_like(wt)).flatten())
        # existing pods' terms against the incoming pod: preferred ±w, and
        # required affinity at hardPodAffinityWeight
        rev_domains = [
            (rel.ipa_key, rel.ipa_ctype, rel.ipa_ckey, rel.ipa_cpairs,
             rel.ipa_nsall, rel.ipa_ns, rel.ipa_weight, 1),
            (rel.ipan_key, rel.ipan_ctype, rel.ipan_ckey, rel.ipan_cpairs,
             rel.ipan_nsall, rel.ipan_ns, rel.ipan_weight, -1),
        ]
        if hard_w > 0:
            rev_domains.append(
                (rel.ia_key, rel.ia_ctype, rel.ia_ckey, rel.ia_cpairs,
                 rel.ia_nsall, rel.ia_ns, None, hard_w)
            )
        for key, ct, ck, cp, na, nm, w, sign in rev_domains:
            contrib, pair_ot = _reverse_pairs(a, s, p, key, ct, ck, cp, na, nm)
            wt = (sign * w).to(score_dt) if w is not None else torch.full(
                key.shape, sign, dtype=score_dt, device=key.device)
            wsum.index_add_(0, pair_ot.flatten(),
                            torch.where(contrib, wt, torch.zeros_like(wt)).flatten())
        node_pair = rel.node_pair.long()
        g = wsum[node_pair]  # [N, K]
        return torch.where(node_pair > 0, g, torch.zeros_like(g)).sum(dim=1).to(score_dt)

    def normalize(a, s, p, raw, feasible):
        minv = torch.where(feasible, raw, torch.full_like(raw, BIG)).min()
        maxv = torch.where(feasible, raw, torch.full_like(raw, -BIG)).max()
        diff = maxv - minv
        return torch.where(
            diff > 0,
            fdiv(MAX_NODE_SCORE * (raw - minv), torch.clamp(diff, min=1)),
            torch.zeros_like(raw),
        ).to(raw.dtype)

    kernel._normalize = normalize
    return kernel


# ---------------------------------------------------------------------------
# Volume family  (reference: engine/kernels_vol.py; oracle volume plugins).
# VolumeBinding and VolumeZone gather host-precomputed verdict tables
# (engine/encode_vol.py); VolumeRestrictions and the limits read the volume
# counters of SchedState.
# ---------------------------------------------------------------------------

# VolumeRestrictions reason codes
VR_RWOP, VR_DISK = 1, 2
_VR_MESSAGES = {
    VR_RWOP: (
        "node has pod using PersistentVolumeClaim with the same name and "
        "ReadWriteOncePod access mode"
    ),
    VR_DISK: "node(s) conflicted with the pod's volumes",
}


def vol_message(code: int, enc: EncodedCluster, node_idx: int = -1) -> str:
    return enc.aux["vol_messages"][code]


def build_volume_binding_prefilter(enc: EncodedCluster):
    def kernel(a: ClusterArrays, s: SchedState, p) -> torch.Tensor:
        return a.vb_pf[p]

    return kernel


def decode_volume_binding_prefilter(code: int, enc: EncodedCluster) -> str:
    return enc.aux["vol_messages"][code]


def _build_static_table_filter(field: str):
    def build(enc: EncodedCluster):
        def kernel(a: ClusterArrays, s: SchedState, p) -> torch.Tensor:
            row = a.vb_row[p]
            codes = getattr(a, field)[:, torch.clamp(row, min=0)]  # [N]
            return torch.where(row >= 0, codes, torch.zeros_like(codes)).to(torch.int32)

        return kernel

    return build


def build_volume_restrictions_filter(enc: EncodedCluster):
    def kernel(a: ClusterArrays, s: SchedState, p) -> torch.Tensor:
        # ReadWriteOncePod: any bound pod anywhere using one of p's RWOP
        # claims fails every node
        rwop = (a.pod_claim[p] & (s.used_claims > 0)).any()
        # exclusive disks: a conflict unless both mounts are read-only
        mine_any = a.pod_disk_any[p] > 0  # [D]
        mine_rw = a.pod_disk_rw[p] > 0
        disk = (
            (mine_any[None, :] & (s.node_disk_rw > 0))
            | (mine_rw[None, :] & (s.node_disk_any > 0))
        ).any(dim=1)  # [N]
        zero = torch.zeros(disk.shape, dtype=torch.int32, device=disk.device)
        return torch.where(rwop, zero + VR_RWOP, torch.where(disk, zero + VR_DISK, zero))

    return kernel


def decode_volume_restrictions(code: int, enc: EncodedCluster, node_idx: int) -> str:
    return _VR_MESSAGES[code]


def volume_limit(plugin: str) -> tuple[int, int]:
    """(column of the per-type volume counts, the per-node limit)."""
    return VOL_LIMIT_PLUGINS.index(plugin), _VOLUME_LIMITS[plugin][1]


def _build_volume_limits_filter(plugin: str):
    idx, limit = volume_limit(plugin)

    def build(enc: EncodedCluster):
        def kernel(a: ClusterArrays, s: SchedState, p) -> torch.Tensor:
            want = a.pod_vol3[p, idx]
            return ((want > 0) & (s.node_vol3[:, idx] + want > limit)).to(torch.int32)

        return kernel

    return build


def decode_volume_limits(code: int, enc: EncodedCluster, node_idx: int) -> str:
    return "node(s) exceed max volume count"


def build_node_volume_limits_filter(enc: EncodedCluster):
    # CSI limits need CSINode objects, which the simulator's store does not
    # model: a pass-through, as the oracle's node_volume_limits_filter
    def kernel(a: ClusterArrays, s: SchedState, p) -> torch.Tensor:
        return torch.zeros(a.node_mask.shape[0], dtype=torch.int32, device=a.node_mask.device)

    return kernel


def decode_never(code: int, enc: EncodedCluster, node_idx: int) -> str:
    raise AssertionError("NodeVolumeLimits never fails")


# ---------------------------------------------------------------------------
# registries. Each entry also names the plugin's id in the kernel's config
# block (csrc/seq_kernels.cu F_* / S_*). Each entry also names the plugin's id in
# the kernel's config block (csrc/seq_kernels.cu FILTER_* / SCORE_*).
# ---------------------------------------------------------------------------

# name -> (builder(enc) -> filter body, decode(code, enc, node) -> message, kernel id)
FILTER_KERNELS: dict[str, tuple[Callable, Callable, int]] = {
    "NodeUnschedulable": (build_node_unschedulable_filter, decode_node_unschedulable, 0),
    "NodeName": (build_node_name_filter, decode_node_name, 1),
    "TaintToleration": (build_taint_filter, decode_taint, 2),
    "NodeResourcesFit": (build_fit_filter, decode_fit, 3),
    "NodeAffinity": (build_node_affinity_filter, decode_node_affinity, 4),
    "NodePorts": (build_node_ports_filter, decode_node_ports, 5),
    "PodTopologySpread": (build_spread_filter, decode_spread, 6),
    "InterPodAffinity": (build_interpod_filter, decode_interpod, 7),
    "VolumeRestrictions": (build_volume_restrictions_filter, decode_volume_restrictions, 8),
    "EBSLimits": (_build_volume_limits_filter("EBSLimits"), decode_volume_limits, 9),
    "GCEPDLimits": (_build_volume_limits_filter("GCEPDLimits"), decode_volume_limits, 10),
    "AzureDiskLimits": (_build_volume_limits_filter("AzureDiskLimits"), decode_volume_limits,
                        11),
    "NodeVolumeLimits": (build_node_volume_limits_filter, decode_never, 12),
    "VolumeBinding": (_build_static_table_filter("vb_code"), vol_message, 13),
    "VolumeZone": (_build_static_table_filter("vz_code"), vol_message, 14),
}

# name -> (builder(enc) -> score body, normalize mode, kernel id)
SCORE_KERNELS: dict[str, tuple[Callable, "str | None", int]] = {
    "NodeResourcesFit": (build_fit_score, None, 0),
    "NodeResourcesBalancedAllocation": (build_balanced_score, None, 1),
    "TaintToleration": (build_taint_score, "default_reverse", 2),
    "NodeAffinity": (build_node_affinity_score, "default", 3),
    "ImageLocality": (build_image_locality_score, None, 4),
    "PodTopologySpread": (build_spread_score, "custom", 5),
    "InterPodAffinity": (build_interpod_score, "custom", 6),
}

# preFilter plugins that can veto a pod before the per-node loop:
# name -> (builder(enc) -> body(a, s, p) -> code [] int32, decode(code, enc))
PREFILTER_KERNELS: dict[str, tuple[Callable, Callable]] = {
    "VolumeBinding": (build_volume_binding_prefilter, decode_volume_binding_prefilter),
}

# preFilter plugins whose oracle implementation only caches state and can
# never fail — the engine just records "success" for them.
TRIVIAL_PREFILTER: set[str] = {
    "NodeResourcesFit",
    "NodeAffinity",
    "NodePorts",
    "PodTopologySpread",
    "InterPodAffinity",
    "VolumeRestrictions",
    "VolumeZone",
}

# preScore plugins that can fail or skip: none in the default profile.
PRESCORE_KERNELS: dict[str, tuple[Callable, Callable]] = {}

TRIVIAL_PRESCORE: set[str] = {
    "InterPodAffinity",
    "PodTopologySpread",
    "TaintToleration",
    "NodeAffinity",
    "NodeResourcesFit",
    "NodeResourcesBalancedAllocation",
}

# postFilter kernels: DefaultPreemption (engine/preempt.py), a builder
# (enc, filter_names) -> the plain dry run.
POSTFILTER_KERNELS: dict[str, Callable] = {}


from .preempt import build_preemption  # noqa: E402  (preempt reads the registries)

POSTFILTER_KERNELS["DefaultPreemption"] = build_preemption
