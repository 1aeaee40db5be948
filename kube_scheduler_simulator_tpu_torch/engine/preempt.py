"""DefaultPreemption (PostFilter): the dry run as incremental counters — the
plain PyTorch version of the reference package's `engine/preempt.py`.

Semantics (upstream dry-run preemption, as the reference's oracle
`default_preemption` re-derives it): on each candidate node, remove every
bound pod of lower priority, check that the preemptor then fits, and add
the victims back highest priority first (then earliest bound), keeping each
one whose return leaves the pod feasible. Candidate nodes rank by the
lowest highest-victim priority, then the lowest priority sum, then the
fewest victims, then the lowest index.

Every state-dependent filter has a row class that keeps its counters for
one node under victim removal:

  * `prepare(a, s, p)`  — per dry run: match tables and base counters from
    the current state;
  * `node_init(a, ctx, s, vm, tgt, lower)` — the counters of every node with
    all its lower-priority pods removed ([N, ...] tensors);
  * `add_back(a, ctx, cnt, v)` — every node's counters with its pod `v[n]`
    returned;
  * `check(a, ctx, cnt, p)` — [N] bool, the pod passes the filter on each
    node from its counters alone;
  * `active(a, ctx, p)` — False where `check` holds on every node whatever
    the counters (the pod asks for no port, no volume, no term...), so the
    dry run may leave the row out.

The reference maps one node's dry run over the node axis (`jax.vmap`); this
version keeps the node axis in every tensor and walks the reprieve slots in
a Python loop, the same arithmetic node by node. Filters that read no state
(`STATELESS_FILTERS`) are evaluated once per call. On the card the dry run
is `csrc/seq_kernels.cu`'s `dry_run` (engine/cuda.py `seq_preempt`).
"""

from __future__ import annotations

import numpy as np
import torch

from .encode import PODS_RES, ClusterArrays, EncodedCluster, SchedState

PREEMPT_NO_LOWER = 0  # "no lower-priority pods to preempt"
PREEMPT_NO_FIT = 1  # "preemption would not make pod schedulable"
PREEMPT_CANDIDATE = 2  # "can preempt k victim(s): ..."
PREEMPT_SELECTED = 3  # "preemption victim(s): ..."
PREEMPT_SILENT = 4  # fits with zero victims: no message is recorded

# int32 max: the reference's sentinel in the ranking and the sort keys
BIG = (1 << 31) - 1

# Filters whose codes do not read SchedState: evaluated once per dry run on
# the unmodified state. Every other enabled filter needs a row class below.
# (The VolumeBinding/VolumeZone verdicts are static tables; NodeVolumeLimits
# is a pass-through.)
STATELESS_FILTERS = frozenset({
    "NodeName",
    "NodeUnschedulable",
    "TaintToleration",
    "NodeAffinity",
    "VolumeBinding",
    "VolumeZone",
    "NodeVolumeLimits",
})


def _per_node(src, tgt, N):
    """[N, ...]: the rows of `src` ([L, ...], one per lower-priority pod)
    summed onto each pod's node `tgt` ([L])."""
    out = torch.zeros((N,) + tuple(src.shape[1:]), dtype=src.dtype, device=src.device)
    return out.index_add_(0, tgt, src)


def _take(x, v):
    """x[v] for an [N] index vector that may hold -1 (an empty slot)."""
    return x[torch.clamp(v, min=0)]


class _FitRow:
    """NodeResourcesFit under victim removal."""

    def prepare(self, a, s, p):
        return None

    def node_init(self, a, ctx, s, vm, tgt, lower):
        N = a.node_mask.shape[0]
        return {
            "requested": s.requested - _per_node(a.pod_req[lower], tgt, N),
            "n_pods": s.n_pods - vm.sum(dim=1, dtype=torch.int32),
        }

    def add_back(self, a, ctx, cnt, v):
        return {
            "requested": cnt["requested"] + _take(a.pod_req, v),
            "n_pods": cnt["n_pods"] + 1,
        }

    def active(self, a, ctx, p):
        return True

    def check(self, a, ctx, cnt, p):
        req = a.pod_req[p]
        free = a.node_alloc - cnt["requested"]
        fits = ~((req > 0)[None, :] & (req[None, :] > free)).any(dim=1)
        return fits & (cnt["n_pods"] + 1 <= a.node_alloc[:, PODS_RES])


class _PortsRow:
    """NodePorts under victim removal."""

    def prepare(self, a, s, p):
        return None

    def node_init(self, a, ctx, s, vm, tgt, lower):
        N = a.node_mask.shape[0]
        return {
            "used_pair": s.used_pair - _per_node(a.want_pair[lower], tgt, N),
            "used_wild": s.used_wild - _per_node(a.want_wild[lower], tgt, N),
            "used_trip": s.used_trip - _per_node(a.want_trip[lower], tgt, N),
        }

    def add_back(self, a, ctx, cnt, v):
        return {
            "used_pair": cnt["used_pair"] + _take(a.want_pair, v),
            "used_wild": cnt["used_wild"] + _take(a.want_wild, v),
            "used_trip": cnt["used_trip"] + _take(a.want_trip, v),
        }

    def active(self, a, ctx, p):
        return bool(a.want_wild[p].any() or a.want_trip[p].any())

    def check(self, a, ctx, cnt, p):
        wild = a.want_wild[p] > 0
        trip = a.want_trip[p] > 0
        wild_conflict = (wild[None, :] & (cnt["used_pair"] > 0)).any(dim=1)
        trip_conflict = (
            trip[None, :]
            & ((cnt["used_trip"] > 0) | (cnt["used_wild"][:, a.trip_pair.long()] > 0))
        ).any(dim=1)
        return ~(wild_conflict | trip_conflict)


class _SpreadRow:
    """PodTopologySpread hard constraints under victim removal. Counters:
    matching bound pods per (constraint, topology pair) over eligible
    nodes; victim removal on node n moves only the entries at n's pairs,
    so each node keeps those HC entries (`cur`) beside the shared base."""

    def __init__(self, enc: EncodedCluster):
        self.NP1 = enc.aux["n_node_pairs"] + 1

    def prepare(self, a, s, p):
        from .encode_rel import match_clauses
        from .kernels import node_affinity_ok

        rel = a.rel
        keys = rel.sph_key[p]  # [HC]
        valid = keys >= 0
        m_live = (
            match_clauses(rel, rel.sph_ctype[p], rel.sph_ckey[p], rel.sph_cpairs[p])
            & (rel.ns_id == rel.ns_id[p])[None, :]
            & ~rel.deleted[None, :]
            & a.pod_mask[None, :]
        )  # [HC, P]
        pairs_all = rel.node_pair[:, torch.clamp(keys, min=0).long()].long()  # [N, HC]
        has_key_all = pairs_all > 0
        has_all = (has_key_all | ~valid[None, :]).all(dim=1)
        elig = node_affinity_ok(a, p) & has_all & a.node_mask  # [N]
        HC = keys.shape[0]
        dev = keys.device
        present = torch.zeros((HC, self.NP1), dtype=torch.int32, device=dev)
        present.scatter_add_(1, pairs_all.T.contiguous(),
                             (elig[None, :] & has_key_all.T).to(torch.int32).contiguous())
        pmask = (present > 0) & (torch.arange(self.NP1, device=dev) > 0)[None, :]
        bound = s.assignment >= 0
        tgt = torch.clamp(s.assignment, min=0).long()
        w = (m_live & bound[None, :] & elig[tgt][None, :]).to(torch.int32)
        pair_q = pairs_all[tgt].T.contiguous()  # [HC, P]
        base = torch.zeros((HC, self.NP1), dtype=torch.int32, device=dev)
        base.scatter_add_(1, pair_q, w)
        return {"valid": valid, "m_live": m_live, "pairs_all": pairs_all,
                "has_key_all": has_key_all, "elig": elig, "pmask": pmask, "base": base,
                "self_add": rel.sph_self[p].to(torch.int32), "maxskew": rel.sph_skew[p]}

    def node_init(self, a, ctx, s, vm, tgt, lower):
        N = a.node_mask.shape[0]
        # the victims all sit on their node: per node and constraint, the
        # matching victims leave the count at the node's own pair
        delta = _per_node(ctx["m_live"][:, lower].T.to(torch.int32), tgt, N)  # [N, HC]
        delta = delta * ctx["elig"].to(torch.int32)[:, None]
        at_node = ctx["base"].gather(1, ctx["pairs_all"].T).T  # [N, HC]
        return {"cur": at_node - delta}

    def add_back(self, a, ctx, cnt, v):
        d = _take(ctx["m_live"].T, v).to(torch.int32) * ctx["elig"].to(torch.int32)[:, None]
        return {"cur": cnt["cur"] + d}

    def active(self, a, ctx, p):
        return bool(ctx["valid"].any())

    def check(self, a, ctx, cnt, p):
        N, HC = cnt["cur"].shape
        full = ctx["base"][None].expand(N, HC, self.NP1).clone()
        full.scatter_(2, ctx["pairs_all"][:, :, None], cnt["cur"][:, :, None])
        pmask = ctx["pmask"][None]
        min_c = torch.where(pmask, full, torch.full_like(full, BIG)).amin(dim=2)
        min_c = torch.where(pmask.any(dim=2), min_c, torch.zeros_like(min_c))  # [N, HC]
        skew = cnt["cur"] + ctx["self_add"][None, :] - min_c
        fail = ctx["valid"][None, :] & (~ctx["has_key_all"] | (skew > ctx["maxskew"][None, :]))
        return ~fail.any(dim=1)


class _InterpodRow:
    """InterPodAffinity under victim removal. Three counter families:
    existing pods' required anti-affinity against the incoming pod (by
    topology pair), and the incoming pod's required anti-affinity and
    affinity matches per term. Removing victims of node n moves only
    entries at n's own pairs."""

    def __init__(self, enc: EncodedCluster):
        self.NP1 = enc.aux["n_node_pairs"] + 1

    def prepare(self, a, s, p):
        from .encode_rel import match_clauses, match_clauses_rev

        rel = a.rel
        bound = (s.assignment >= 0) & a.pod_mask
        np_assigned = rel.node_pair[torch.clamp(s.assignment, min=0).long()].long()  # [P, K]
        dev = a.node_mask.device
        # (1) existing pods' required anti-affinity against the incoming pod
        rev = match_clauses_rev(rel, rel.ian_ctype, rel.ian_ckey, rel.ian_cpairs, p)
        ns_ok1 = rel.ian_nsall | rel.ian_ns[:, :, rel.ns_id[p].long()]
        contrib1 = rev & ns_ok1 & (rel.ian_key >= 0)  # [P, T1]
        pair_ot = torch.gather(np_assigned, 1, torch.clamp(rel.ian_key, min=0).long())
        pair_ot = torch.where((rel.ian_key >= 0) & bound[:, None], pair_ot,
                              torch.zeros_like(pair_ot))
        w1 = (contrib1 & bound[:, None] & (pair_ot > 0)).to(torch.int32)
        ea_base = torch.zeros(self.NP1, dtype=torch.int32, device=dev)
        ea_base.index_add_(0, pair_ot.flatten(), w1.flatten())

        def forward(key_all, ctype, ckey, cpairs, nsall, nsmh):
            key = key_all[p]  # [T]
            valid = key >= 0
            m = (
                match_clauses(rel, ctype[p], ckey[p], cpairs[p])
                & (nsall[p][:, None] | nsmh[p][:, rel.ns_id.long()])
                & a.pod_mask[None, :]
            )  # [T, P]
            pair_tp = np_assigned[:, torch.clamp(key, min=0).long()].T  # [T, P]
            pair_tp = torch.where(valid[:, None] & bound[None, :], pair_tp,
                                  torch.zeros_like(pair_tp))
            base = torch.zeros((key.shape[0], self.NP1), dtype=torch.int32, device=dev)
            base.scatter_add_(1, pair_tp.contiguous(), (m & bound[None, :]).to(torch.int32))
            npair_n = rel.node_pair[:, torch.clamp(key, min=0).long()].long()  # [N, T]
            npair_n = torch.where(valid[None, :], npair_n, torch.zeros_like(npair_n))
            return {"valid": valid, "m": m, "base": base, "npair_n": npair_n}

        f2 = forward(rel.ian_key, rel.ian_ctype, rel.ian_ckey, rel.ian_cpairs,
                     rel.ian_nsall, rel.ian_ns)
        f3 = forward(rel.ia_key, rel.ia_ctype, rel.ia_ckey, rel.ia_cpairs,
                     rel.ia_nsall, rel.ia_ns)
        total3 = f3["base"][:, 1:].sum()  # int64, as the reference's sum
        self_all = (rel.ia_self[p] | ~f3["valid"]).all()
        return {"contrib1": contrib1, "pair_ot": pair_ot, "ea_base": ea_base, "f2": f2,
                "f3": f3, "total3": total3, "self_all": self_all,
                "has_terms": f3["valid"].any()}

    def _w1(self, ctx, v):
        """[N, T1] the anti-affinity hits pods v[n] carry, and their pairs."""
        w = (_take(ctx["contrib1"], v) & (_take(ctx["pair_ot"], v) > 0)).to(torch.int32)
        return w, _take(ctx["pair_ot"], v)

    def _ea_add(self, ea, w, pairs):
        N = ea.shape[0]
        rows = torch.arange(N, device=ea.device)[:, None].expand_as(pairs)
        flat = (rows * self.NP1 + pairs).flatten()
        return ea.flatten().index_add(0, flat, w.flatten()).view(N, self.NP1)

    def node_init(self, a, ctx, s, vm, tgt, lower):
        N = a.node_mask.shape[0]
        ea = ctx["ea_base"][None].repeat(N, 1)
        w1 = (ctx["contrib1"][lower] & (ctx["pair_ot"][lower] > 0)).to(torch.int32)
        rows = tgt[:, None].expand_as(w1)
        flat = (rows * self.NP1 + ctx["pair_ot"][lower]).flatten()
        ea = ea.flatten().index_add(0, flat, -w1.flatten()).view(N, self.NP1)
        out = {"ea": ea}
        total = ctx["total3"]
        for fk in ("f2", "f3"):
            f = ctx[fk]
            on = (f["npair_n"] > 0).to(torch.int32)  # [N, T]
            delta = _per_node(f["m"][:, lower].T.to(torch.int32), tgt, N) * on
            out[fk] = f["base"].gather(1, f["npair_n"].T).T - delta  # [N, T]
            if fk == "f3":
                total = total - delta.sum(dim=1)
        out["total3"] = total
        return out

    def add_back(self, a, ctx, cnt, v):
        w, pairs = self._w1(ctx, v)
        out = {"ea": self._ea_add(cnt["ea"], w, pairs)}
        total = cnt["total3"]
        for fk in ("f2", "f3"):
            f = ctx[fk]
            d = _take(f["m"].T, v).to(torch.int32) * (f["npair_n"] > 0).to(torch.int32)
            out[fk] = cnt[fk] + d
            if fk == "f3":
                total = total + d.sum(dim=1)
        out["total3"] = total
        return out

    def active(self, a, ctx, p):
        # no existing pod's anti-affinity selects p (victims' hits are part
        # of the base) and p has no required term: every node passes
        return bool(ctx["ea_base"].any() or ctx["f2"]["valid"].any() or ctx["has_terms"])

    def check(self, a, ctx, cnt, p):
        np_n = a.rel.node_pair.long()  # [N, K]
        fail1 = ((cnt["ea"].gather(1, np_n) > 0) & (np_n > 0)).any(dim=1)
        f2 = ctx["f2"]
        fail2 = (f2["valid"][None, :] & (f2["npair_n"] > 0) & (cnt["f2"] > 0)).any(dim=1)
        f3 = ctx["f3"]
        on3 = f3["npair_n"] > 0
        invalid3 = ~f3["valid"][None, :]
        satisfied = ((on3 & (cnt["f3"] > 0)) | invalid3).all(dim=1)
        has_all_keys = (on3 | invalid3).all(dim=1)
        pass3 = satisfied | (has_all_keys & (cnt["total3"] == 0) & ctx["self_all"])
        fail3 = ctx["has_terms"] & ~pass3
        return ~(fail1 | fail2 | fail3)


class _VolRestrictionsRow:
    """VolumeRestrictions under victim removal."""

    def prepare(self, a, s, p):
        return None

    def node_init(self, a, ctx, s, vm, tgt, lower):
        N = a.node_mask.shape[0]
        claims = _per_node(a.pod_claim[lower].to(torch.int32), tgt, N)
        return {
            "used_claims": s.used_claims[None, :] - claims,
            "disk_any": s.node_disk_any - _per_node(a.pod_disk_any[lower], tgt, N),
            "disk_rw": s.node_disk_rw - _per_node(a.pod_disk_rw[lower], tgt, N),
        }

    def add_back(self, a, ctx, cnt, v):
        return {
            "used_claims": cnt["used_claims"] + _take(a.pod_claim, v).to(torch.int32),
            "disk_any": cnt["disk_any"] + _take(a.pod_disk_any, v),
            "disk_rw": cnt["disk_rw"] + _take(a.pod_disk_rw, v),
        }

    def active(self, a, ctx, p):
        return bool(a.pod_claim[p].any() or a.pod_disk_any[p].any())

    def check(self, a, ctx, cnt, p):
        rwop = (a.pod_claim[p][None, :] & (cnt["used_claims"] > 0)).any(dim=1)
        mine_any = a.pod_disk_any[p] > 0
        mine_rw = a.pod_disk_rw[p] > 0
        disk = ((mine_any[None, :] & (cnt["disk_rw"] > 0))
                | (mine_rw[None, :] & (cnt["disk_any"] > 0))).any(dim=1)
        return ~(rwop | disk)


class _VolLimitsRow:
    """One volume-count limit (EBS, GCE PD or Azure disk) under victim
    removal."""

    def __init__(self, plugin: str):
        from .kernels import volume_limit

        self.idx, self.limit = volume_limit(plugin)

    def prepare(self, a, s, p):
        return None

    def node_init(self, a, ctx, s, vm, tgt, lower):
        N = a.node_mask.shape[0]
        col = a.pod_vol3[:, self.idx]
        return {"cnt": s.node_vol3[:, self.idx] - _per_node(col[lower], tgt, N)}

    def add_back(self, a, ctx, cnt, v):
        return {"cnt": cnt["cnt"] + _take(a.pod_vol3[:, self.idx], v)}

    def active(self, a, ctx, p):
        return bool(a.pod_vol3[p, self.idx] > 0)

    def check(self, a, ctx, cnt, p):
        want = a.pod_vol3[p, self.idx]
        return ~((want > 0) & (cnt["cnt"] + want > self.limit))


ROW_FILTERS = {
    "NodeResourcesFit": lambda enc: _FitRow(),
    "NodePorts": lambda enc: _PortsRow(),
    "PodTopologySpread": _SpreadRow,
    "InterPodAffinity": _InterpodRow,
    "VolumeRestrictions": lambda enc: _VolRestrictionsRow(),
    "EBSLimits": lambda enc: _VolLimitsRow("EBSLimits"),
    "GCEPDLimits": lambda enc: _VolLimitsRow("GCEPDLimits"),
    "AzureDiskLimits": lambda enc: _VolLimitsRow("AzureDiskLimits"),
}


def victim_bound(enc: EncodedCluster, filter_names) -> int:
    """The bound on victims per node (the reference's `_victim_bound`):
    with NodeResourcesFit enabled no node ever holds more pods than
    max(pods capacity, its initial load); rounded up to its shape bucket.
    A node with more lower-priority pods than this is processed only up to
    the bound, as the reference's reprieve scan is."""
    from ..utils.compilecache import shape_bucket

    P = enc.P
    if "NodeResourcesFit" not in filter_names:
        return P
    caps = enc.arrays.node_alloc[:, PODS_RES].cpu().numpy()
    mask = enc.arrays.node_mask.cpu().numpy()
    cap_max = int(caps[mask].max()) if mask.any() else 0
    assign0 = enc.state0.assignment.cpu().numpy()
    bound0 = assign0[assign0 >= 0]
    init_max = int(np.bincount(bound0).max()) if bound0.size else 0
    raw = max(1, min(P, max(cap_max, init_max)))
    return min(P, shape_bucket(raw, lo=1))


def wrap_neg32(x: torch.Tensor) -> torch.Tensor:
    """-x in int32 with two's-complement wrap (the reference negates the
    int32 priority row; -INT32_MIN stays INT32_MIN)."""
    y = -x.to(torch.int64)
    return torch.where(y > BIG, y - (1 << 32), y)


def reprieve_order(a: ClusterArrays, s: SchedState, vm: torch.Tensor) -> torch.Tensor:
    """[N, P] pod indices of each node's victims first, in reprieve order:
    priority descending (its int32 negation ascending), then bind order
    ascending; the rest of each row is the other pods (never valid)."""
    neg = wrap_neg32(a.pod_priority)[None, :]  # [1, P]
    k1 = torch.where(vm, neg, torch.full_like(neg, BIG))
    k2 = torch.where(vm, s.bound_seq.to(torch.int64)[None, :], torch.full_like(k1, BIG))
    key = k1 * (1 << 32) + (k2 + (1 << 31))
    return torch.argsort(key, dim=1, stable=True)


def build_preemption(enc: EncodedCluster, filter_names):
    """Returns preempt(a, s, p) -> (pcode [N] int32, victim mask [N, P]
    bool, nominated [] int32)."""
    from . import kernels as K

    rows, statics = [], []
    for name in filter_names:
        if name in ROW_FILTERS:
            rows.append(ROW_FILTERS[name](enc))
        elif name in STATELESS_FILTERS:
            statics.append(K.FILTER_KERNELS[name][0](enc))
        else:
            raise NotImplementedError(
                f"filter {name!r} has no preemption row and is not declared "
                "state-independent (preempt.STATELESS_FILTERS)"
            )
    V = victim_bound(enc, filter_names)

    def preempt(a: ClusterArrays, s: SchedState, p: int):
        N, P = a.node_mask.shape[0], a.pod_mask.shape[0]
        dev = a.node_mask.device
        prio = a.pod_priority
        lower_all = (s.assignment >= 0) & a.pod_mask & (prio < prio[p])  # [P]
        lower = torch.nonzero(lower_all).flatten()
        tgt = s.assignment[lower].long()
        vm = torch.zeros((N, P), dtype=torch.bool, device=dev)
        vm[tgt, lower] = True
        any_lower = vm.any(dim=1)
        static_ok = a.node_mask.clone()
        for k in statics:
            static_ok &= k(a, s, p) == 0
        ctxs = [r.prepare(a, s, p) for r in rows]
        on = [(r, c) for r, c in zip(rows, ctxs) if r.active(a, c, p)]
        cnts = [r.node_init(a, c, s, vm, tgt, lower) for r, c in on]

        def feasible(cs):
            ok = static_ok
            for (r, c), cnt in zip(on, cs):
                ok = ok & r.check(a, c, cnt, p)
            return ok

        fits = feasible(cnts)
        order = reprieve_order(a, s, vm)
        # the reprieve decides victims only where the pod fits at all
        n_vict = torch.where(fits, vm.sum(dim=1), torch.zeros_like(fits, dtype=torch.int64))
        depth = min(V, int(n_vict.max())) if N else 0
        victims = torch.zeros((N, P), dtype=torch.bool, device=dev)
        arange = torch.arange(N, device=dev)
        for k in range(depth):
            v = order[:, k]
            valid = vm[arange, v]
            tries = [r.add_back(a, c, cnt, v) for (r, c), cnt in zip(on, cnts)]
            ok = feasible(tries)
            keep = valid & ok
            cnts = [{f: torch.where(keep.view((N,) + (1,) * (x.dim() - 1)), x, cnt[f])
                     for f, x in t.items()} for t, cnt in zip(tries, cnts)]
            victims[arange, v] = valid & ~ok
        has_victims = victims.any(dim=1)
        zero = torch.zeros(N, dtype=torch.int32, device=dev)
        code = torch.where(
            ~any_lower, zero + PREEMPT_NO_LOWER,
            torch.where(~fits, zero + PREEMPT_NO_FIT,
                        torch.where(has_victims, zero + PREEMPT_CANDIDATE,
                                    zero + PREEMPT_SILENT)))
        victims &= (code == PREEMPT_CANDIDATE)[:, None]
        # node choice: min highest victim priority, then min priority sum
        # (int64, as the reference's sum of the int32 row), then fewest
        # victims, then the lowest index; each key minimised against BIG
        pr = prio[None, :]
        maxp = torch.where(victims, pr, torch.full_like(pr, -BIG)).amax(dim=1)
        sump = torch.where(victims, pr, torch.zeros_like(pr)).sum(dim=1)
        cnt = victims.sum(dim=1)
        alive = code == PREEMPT_CANDIDATE
        for key in (maxp, sump, cnt):
            best = torch.where(alive, key, torch.full_like(key, BIG)).amin()
            alive = alive & (key == best)
        nominated = torch.where(alive.any(), torch.argmax(alive.to(torch.int32)),
                                torch.tensor(-1, device=dev)).to(torch.int32)
        code = torch.where((arange == nominated) & (nominated >= 0),
                           zero + PREEMPT_SELECTED, code)
        return code, victims, nominated

    return preempt


def decode_preemption(code: int, enc: EncodedCluster, node_idx: int,
                      victims: "list[str]") -> str:
    if code == PREEMPT_NO_LOWER:
        return "no lower-priority pods to preempt"
    if code == PREEMPT_NO_FIT:
        return "preemption would not make pod schedulable"
    if code == PREEMPT_CANDIDATE:
        return f"can preempt {len(victims)} victim(s): " + ", ".join(victims)
    return "preemption victim(s): " + ", ".join(victims)
