"""Pod-relational encodings: label-selector clause tensors and topology pairs.

PodTopologySpread and InterPodAffinity aggregate over the set of currently
bound pods, which changes at every step of the pass. The encoder compiles
every label selector into fixed clause tensors once; each step evaluates
them against static pod-label bitsets and reduces the counts by
scatter-adds keyed on `state.assignment` — no P×P matrix is ever built.
This is the reference package's `engine/encode_rel.py` without the PACKED
storage.

Selector → clauses (upstream metav1.LabelSelector semantics):
  * matchLabels k=v and In(k, vs)  → PAIR_ANY over the (k,v) pair ids
  * NotIn(k, vs)                   → no pair hit (an absent key MATCHES)
  * Exists(k) / DoesNotExist(k)    → key-presence bit
  * nil selector                   → NEVER (matches nothing)
  * empty selector                 → zero clauses (matches everything)
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np
import torch

from ..models.objects import match_label_selector
from ..models.vocab import Vocab
from ..sched.oracle_plugins import (
    _namespaces_for_term,
    _preferred_terms,
    _required_terms,
    _term_matches_pod,
    spread_log_weight,
)

PAIR_ANY, NOTIN, EXISTS, DNE, NEVER = 0, 1, 2, 3, 4
CL_PAD = -1

# The relational term domains, in the order the kernel's config names
# them: spread hard (DoNotSchedule) and soft (ScheduleAnyway) constraints,
# then InterPodAffinity's required affinity, required anti-affinity,
# preferred affinity and preferred anti-affinity terms.
DOMAINS = ("sph", "sps", "ia", "ian", "ipa", "ipan")


@dataclass
class PodRelArrays:
    """Pod-relational tensors (nested in ClusterArrays.rel). Axes: LP =
    pod-label (key,value) pairs, KK = pod-label keys, K = node-label keys,
    HC/SC = hard/soft spread constraints, T = terms of a domain, C =
    clauses per term, VP = pair ids per clause, NSV = namespaces."""

    # pod label bitsets
    pair_present: torch.Tensor  # [P, LP] bool — pod has (key,value) pair
    key_present: torch.Tensor  # [P, KK] bool — pod has label key
    ns_id: torch.Tensor  # [P] int32 namespace id
    deleted: torch.Tensor  # [P] bool — metadata.deletionTimestamp set
    # node topology pairs: id+1 into the node-pair vocab (0 = key absent)
    node_pair: torch.Tensor  # [N, K] int32
    # PodTopologySpread hard (DoNotSchedule) constraints
    sph_key: torch.Tensor  # [P, HC] int32 node-label key col | -1 pad
    sph_skew: torch.Tensor  # [P, HC] int32 maxSkew
    sph_self: torch.Tensor  # [P, HC] bool — selector matches the pod itself
    sph_ctype: torch.Tensor  # [P, HC, C] int32 clause type | CL_PAD
    sph_ckey: torch.Tensor  # [P, HC, C] int32 pod-label key id | -1
    sph_cpairs: torch.Tensor  # [P, HC, C, VP] int32 pod-label pair id | -1
    # PodTopologySpread soft (ScheduleAnyway) constraints
    sps_key: torch.Tensor  # [P, SC]
    sps_skew: torch.Tensor  # [P, SC]
    sps_host: torch.Tensor  # [P, SC] bool — topologyKey == kubernetes.io/hostname
    sps_ctype: torch.Tensor  # [P, SC, C]
    sps_ckey: torch.Tensor  # [P, SC, C]
    sps_cpairs: torch.Tensor  # [P, SC, C, VP]
    req_all: torch.Tensor  # [P] bool — pod has explicit constraints
    spread_lut: torch.Tensor  # [N+2] int32 fixed-point log weights
    # InterPodAffinity term domains. Each domain d has d_key [P, T] (node
    # label key col | -1), d_ctype/d_ckey [P, T, C], d_cpairs [P, T, C, VP],
    # d_nsall [P, T] bool, d_ns [P, T, NSV] bool; the same tensors serve
    # both directions (the incoming pod's terms against every pod, and
    # every pod's terms against the incoming pod).
    ia_key: torch.Tensor  # required affinity
    ia_ctype: torch.Tensor
    ia_ckey: torch.Tensor
    ia_cpairs: torch.Tensor
    ia_nsall: torch.Tensor
    ia_ns: torch.Tensor
    ia_self: torch.Tensor  # [P, T] bool — term matches its own pod
    ian_key: torch.Tensor  # required anti-affinity
    ian_ctype: torch.Tensor
    ian_ckey: torch.Tensor
    ian_cpairs: torch.Tensor
    ian_nsall: torch.Tensor
    ian_ns: torch.Tensor
    ipa_key: torch.Tensor  # preferred affinity
    ipa_ctype: torch.Tensor
    ipa_ckey: torch.Tensor
    ipa_cpairs: torch.Tensor
    ipa_nsall: torch.Tensor
    ipa_ns: torch.Tensor
    ipa_weight: torch.Tensor  # [P, T] int32
    ipan_key: torch.Tensor  # preferred anti-affinity
    ipan_ctype: torch.Tensor
    ipan_ckey: torch.Tensor
    ipan_cpairs: torch.Tensor
    ipan_nsall: torch.Tensor
    ipan_ns: torch.Tensor
    ipan_weight: torch.Tensor  # [P, T] int32

    def to(self, device: torch.device) -> "PodRelArrays":
        return PodRelArrays(
            **{
                f.name: getattr(self, f.name).to(device)
                for f in dataclasses.fields(self)
            }
        )


class _ClauseBuilder:
    """Compiles label selectors against shared pod-label vocabularies."""

    def __init__(self):
        self.pair_vocab = Vocab()  # "key\x00value"
        self.key_vocab = Vocab()

    def pair_id(self, k: str, v: str) -> int:
        return self.pair_vocab.intern(f"{k}\x00{v}")

    def compile(self, selector: "dict | None") -> "list[tuple[int, int, list[int]]]":
        """selector -> [(ctype, key_id, pair_ids)]"""
        if selector is None:
            return [(NEVER, -1, [])]
        clauses = []
        for k, v in (selector.get("matchLabels") or {}).items():
            clauses.append((PAIR_ANY, self.key_vocab.intern(k), [self.pair_id(k, str(v))]))
        for req in selector.get("matchExpressions") or []:
            k = req.get("key") or ""
            op = req.get("operator") or ""
            vals = [str(x) for x in (req.get("values") or [])]
            kid = self.key_vocab.intern(k)
            if op == "In":
                clauses.append((PAIR_ANY, kid, [self.pair_id(k, v) for v in vals]))
            elif op == "NotIn":
                clauses.append((NOTIN, kid, [self.pair_id(k, v) for v in vals]))
            elif op == "Exists":
                clauses.append((EXISTS, kid, []))
            elif op == "DoesNotExist":
                clauses.append((DNE, kid, []))
            else:
                # Gt/Lt or unknown in a metav1.LabelSelector: matches nothing
                clauses.append((NEVER, -1, []))
        return clauses


def _fill_clauses(slots, dims, P):
    """Pack per-(pod, term) clause lists into dense arrays."""
    TC, C, VP = dims
    ctype = np.full((P, TC, C), CL_PAD, np.int32)
    ckey = np.full((P, TC, C), -1, np.int32)
    cpairs = np.full((P, TC, C, VP), -1, np.int32)
    for p, terms in enumerate(slots):
        for t, clauses in enumerate(terms):
            for c, (ct, k, pairs) in enumerate(clauses):
                ctype[p, t, c] = ct
                ckey[p, t, c] = k
                for vi, pid in enumerate(pairs):
                    cpairs[p, t, c, vi] = pid
    return ctype, ckey, cpairs


def parse_pod_spread(pv, constraint_triple, label_keys, cb):
    """ONE pod's resolved spread constraints → the (hard_terms,
    soft_terms, explicit) triple `_pack_spread` packs. Each term is
    (key column, maxSkew, selector matches the pod itself, clauses,
    topologyKey is the hostname)."""
    hard, soft, explicit = constraint_triple
    hard_terms = [
        (
            label_keys.intern(c["topologyKey"]),
            int(c.get("maxSkew", 1)),
            match_label_selector(c.get("labelSelector"), pv.labels),
            cb.compile(c.get("labelSelector")),
            False,
        )
        for c in hard
    ]
    soft_terms = [
        (
            label_keys.intern(c["topologyKey"]),
            int(c.get("maxSkew", 1)),
            False,
            cb.compile(c.get("labelSelector")),
            c["topologyKey"] == "kubernetes.io/hostname",
        )
        for c in soft
    ]
    return hard_terms, soft_terms, explicit


def _pack_spread(all_terms, n, TC, C, VP):
    """Dense spread-constraint rows for `n` pods at fixed dims."""
    key = np.full((n, TC), -1, np.int32)
    skew = np.ones((n, TC), np.int32)
    selfm = np.zeros((n, TC), bool)
    host = np.zeros((n, TC), bool)
    for p, terms in enumerate(all_terms):
        for t, (k, ms, sm, _cl, hh) in enumerate(terms):
            key[p, t] = k
            skew[p, t] = ms
            selfm[p, t] = sm
            host[p, t] = hh
    ctype, ckey, cpairs = _fill_clauses(
        [[cl for (_, _, _, cl, _) in t] for t in all_terms], (TC, C, VP), n
    )
    return key, skew, selfm, host, ctype, ckey, cpairs


def _pack_ia(parsed, n, T, C, VP, NSV):
    """Dense InterPodAffinity term rows for `n` pods at fixed dims."""
    key = np.full((n, T), -1, np.int32)
    nsall = np.zeros((n, T), bool)
    nsmh = np.zeros((n, T, NSV), bool)
    weight = np.zeros((n, T), np.int32)
    selfm = np.zeros((n, T), bool)
    for p, terms in enumerate(parsed):
        for t, term in enumerate(terms):
            key[p, t] = term["kcol"]
            nsall[p, t] = term["nsall"]
            for nid in term["nsids"]:
                nsmh[p, t, nid] = True
            weight[p, t] = term.get("weight", 0)
            selfm[p, t] = term.get("selfm", False)
    ctype, ckey, cpairs = _fill_clauses(
        [[t["clauses"] for t in x] for x in parsed], (T, C, VP), n
    )
    return key, ctype, ckey, cpairs, nsall, nsmh, weight, selfm


def encode_pod_relations(
    node_views,
    pod_views,
    N: int,
    P: int,
    *,
    label_keys: Vocab,
    constraints,
    namespaces: "list[dict] | None" = None,
    device: "torch.device | None" = None,
) -> tuple[PodRelArrays, dict]:
    """Build PodRelArrays on `device`.

    `label_keys` is the node-label key vocabulary of the affinity encoder
    (topology keys are interned there first, so they index the same
    label_val columns). `constraints[i] = (hard, soft, explicit)` is each
    pod's resolved spread-constraint split."""
    cb = _ClauseBuilder()
    ns_vocab = Vocab()
    ns_objs = {
        (ns.get("metadata", {}) or {}).get("name", ""): ns for ns in namespaces or []
    }
    # the shape _namespaces_for_term expects
    snapshot = SimpleNamespace(namespaces=ns_objs)

    # -- per-pod spread constraints, compiled --------------------------------
    hard_all, soft_all = [], []
    req_all = np.zeros(P, bool)
    for i, pv in enumerate(pod_views):
        hard_terms, soft_terms, explicit = parse_pod_spread(
            pv, constraints[i], label_keys, cb
        )
        req_all[i] = explicit
        hard_all.append(hard_terms)
        soft_all.append(soft_terms)

    # -- InterPodAffinity terms, parsed ---------------------------------------
    def parse_term(term, owner_ns):
        key = term.get("topologyKey", "")
        kcol = label_keys.get(key)  # interned up front by encode.py
        ns_set = _namespaces_for_term(term, owner_ns, snapshot)
        return {
            "kcol": kcol,
            "clauses": cb.compile(term.get("labelSelector")),
            "nsall": ns_set is None,
            "nsids": [ns_vocab.intern(n) for n in (ns_set or [])],
        }

    def parse_preferred(aff, owner_ns):
        return [
            dict(
                parse_term(pr.get("podAffinityTerm") or {}, owner_ns),
                weight=int(pr.get("weight", 0)),
            )
            for pr in _preferred_terms(aff)
        ]

    ia_parsed, ian_parsed, ipa_parsed, ipan_parsed = [], [], [], []
    for pv in pod_views:
        ia_parsed.append(
            [
                dict(
                    parse_term(t, pv.namespace),
                    selfm=_term_matches_pod(t, pv.namespace, pv, snapshot),
                )
                for t in _required_terms(pv.pod_affinity)
            ]
        )
        ian_parsed.append(
            [parse_term(t, pv.namespace) for t in _required_terms(pv.pod_anti_affinity)]
        )
        ipa_parsed.append(parse_preferred(pv.pod_affinity, pv.namespace))
        ipan_parsed.append(parse_preferred(pv.pod_anti_affinity, pv.namespace))

    # -- pod label bitsets (vocabularies now final) ---------------------------
    for pv in pod_views:
        for k, v in pv.labels.items():
            cb.key_vocab.intern(k)
            cb.pair_id(k, str(v))
        ns_vocab.intern(pv.namespace)
    LP = max(1, len(cb.pair_vocab))
    KK = max(1, len(cb.key_vocab))
    pair_present = np.zeros((P, LP), bool)
    key_present = np.zeros((P, KK), bool)
    ns_id = np.zeros(P, np.int32)
    deleted = np.zeros(P, bool)
    for i, pv in enumerate(pod_views):
        for k, v in pv.labels.items():
            key_present[i, cb.key_vocab.get(k)] = True
            pair_present[i, cb.pair_id(k, str(v))] = True
        ns_id[i] = ns_vocab.get(pv.namespace)
        deleted[i] = pv.deleted

    # -- node topology pairs ---------------------------------------------------
    K = len(label_keys)
    node_pair_vocab = Vocab()
    node_pair = np.zeros((N, K), np.int32)  # 0 = absent
    for n, nv in enumerate(node_views):
        for k, v in nv.labels.items():
            col = label_keys.get(k)
            if col >= 0:
                node_pair[n, col] = node_pair_vocab.intern(f"{k}\x00{v}") + 1

    # -- pack constraint tensors -----------------------------------------------
    def spread_dims(all_terms):
        TC = max(1, max((len(t) for t in all_terms), default=0))
        C = max(1, max((len(cl) for t in all_terms for (_, _, _, cl, _) in t), default=0))
        VP = max(
            1,
            max(
                (len(pr) for t in all_terms for (_, _, _, cl, _) in t for (_, _, pr) in cl),
                default=0,
            ),
        )
        return TC, C, VP

    hk, hs, hself, _, hct, hck, hcp = _pack_spread(hard_all, P, *spread_dims(hard_all))
    sk, ss_, _, shost, sct, sck, scp = _pack_spread(soft_all, P, *spread_dims(soft_all))

    NSV = max(1, len(ns_vocab))

    def pack_terms(parsed):
        T = max(1, max((len(x) for x in parsed), default=0))
        C = max(1, max((len(t["clauses"]) for x in parsed for t in x), default=0))
        VP = max(
            1,
            max(
                (len(pr) for x in parsed for t in x for (_, _, pr) in t["clauses"]),
                default=0,
            ),
        )
        return _pack_ia(parsed, P, T, C, VP, NSV)

    iak, iact, iack, iacp, iana, ians_, _, iaself = pack_terms(ia_parsed)
    nk, nct, nck, ncp, nna, nns, _, _ = pack_terms(ian_parsed)
    pak, pact, pack_, pacp, pana, pans, paw, _ = pack_terms(ipa_parsed)
    qk, qct, qck, qcp, qna, qns, qw, _ = pack_terms(ipan_parsed)

    lut = np.asarray([spread_log_weight(m) for m in range(N + 2)], np.int32)

    host = dict(
        pair_present=pair_present,
        key_present=key_present,
        ns_id=ns_id,
        deleted=deleted,
        node_pair=node_pair,
        sph_key=hk,
        sph_skew=hs,
        sph_self=hself,
        sph_ctype=hct,
        sph_ckey=hck,
        sph_cpairs=hcp,
        sps_key=sk,
        sps_skew=ss_,
        sps_host=shost,
        sps_ctype=sct,
        sps_ckey=sck,
        sps_cpairs=scp,
        req_all=req_all,
        spread_lut=lut,
        ia_key=iak,
        ia_ctype=iact,
        ia_ckey=iack,
        ia_cpairs=iacp,
        ia_nsall=iana,
        ia_ns=ians_,
        ia_self=iaself,
        ian_key=nk,
        ian_ctype=nct,
        ian_ckey=nck,
        ian_cpairs=ncp,
        ian_nsall=nna,
        ian_ns=nns,
        ipa_key=pak,
        ipa_ctype=pact,
        ipa_ckey=pack_,
        ipa_cpairs=pacp,
        ipa_nsall=pana,
        ipa_ns=pans,
        ipa_weight=paw,
        ipan_key=qk,
        ipan_ctype=qct,
        ipan_ckey=qck,
        ipan_cpairs=qcp,
        ipan_nsall=qna,
        ipan_ns=qns,
        ipan_weight=qw,
    )
    rel = PodRelArrays(**{k: torch.as_tensor(v, device=device) for k, v in host.items()})
    # the clause builder and namespace vocabulary stay for the delta
    # encoder, which compiles an appended pod's selectors against them
    return rel, {"n_node_pairs": len(node_pair_vocab), "clause_builder": cb,
                 "ns_vocab": ns_vocab}


# ---------------------------------------------------------------------------
# clause evaluation (the plain bodies' half; csrc/seq_kernels.cu
# `clauses_match` is the kernel's)
# ---------------------------------------------------------------------------


def _eval_clauses(t, pair_hit, key_hit) -> torch.Tensor:
    """The selector-semantics decision table, shared by both matching
    directions. CL_PAD clauses are neutral for the enclosing AND; NotIn
    matches an absent key (no key bit → no pair bit → ~pair_hit)."""
    false = torch.zeros_like(pair_hit)
    m = torch.where(
        t == PAIR_ANY, pair_hit,
        torch.where(t == NOTIN, ~pair_hit,
        torch.where(t == EXISTS, key_hit,
        torch.where(t == DNE, ~key_hit, false))))
    return m | (t == CL_PAD)


def match_clauses(rel: PodRelArrays, ctype, ckey, cpairs) -> torch.Tensor:
    """Evaluate ONE pod's term clauses against EVERY pod.

    ctype/ckey: [T, C]; cpairs: [T, C, VP]. Returns match[T, P] (the label
    part only — callers add namespace, mask and liveness conditions)."""
    pp = rel.pair_present  # [P, LP]
    kp = rel.key_present  # [P, KK]
    pair_hit = (
        pp.T[torch.clamp(cpairs, min=0)] & (cpairs >= 0)[..., None]
    ).any(dim=-2)  # [T, C, P]
    key_hit = kp.T[torch.clamp(ckey, min=0)] & (ckey >= 0)[..., None]  # [T, C, P]
    return _eval_clauses(ctype[..., None], pair_hit, key_hit).all(dim=-2)  # [T, P]


def match_clauses_rev(rel: PodRelArrays, ctype, ckey, cpairs, b) -> torch.Tensor:
    """Evaluate EVERY pod's term clauses against ONE pod `b` (existing
    pods' terms against the incoming pod). ctype/ckey: [P, T, C]; cpairs:
    [P, T, C, VP]. Returns [P, T]."""
    pp = rel.pair_present[b]  # [LP]
    kp = rel.key_present[b]  # [KK]
    pair_hit = (pp[torch.clamp(cpairs, min=0)] & (cpairs >= 0)).any(dim=-1)  # [P, T, C]
    key_hit = kp[torch.clamp(ckey, min=0)] & (ckey >= 0)
    return _eval_clauses(ctype, pair_hit, key_hit).all(dim=-1)  # [P, T]
