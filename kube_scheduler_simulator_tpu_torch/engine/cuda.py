"""The sequential pass's kernels: build, load and launch, beside their plain
PyTorch versions.

Six hand-written CUDA kernels (`csrc/seq_kernels.cu`) carry the pass on
the card, each replacing one device program of the reference package:

  * `seq_attempt` — K1, `engine.py` `_build_run.attempt` (`seq.attempt`):
    one pod's prefilter, filters, scores, normalize, weights and masked
    argmax over all nodes;
  * `seq_bind` — K2, `_build_run.bind` (`seq.bind`): the pod's scatter
    into per-node state;
  * `seq_evict` — K2, `_build_run.evict_all`: the masked scatter-subtract
    of preemption victims;
  * `seq_preempt` — K7, `preempt.py` `build_preemption`: the
    DefaultPreemption dry run for one pod (victims, reprieve, ranking);
  * `seq_run` — K3, `_build_run.step`/`run` (`seq.run`): the whole
    bucket-padded queue in one persistent launch, the preemption branch
    (dry run, eviction, retry, second dry run) inside its step;
  * `sweep_run` — K11, `parallel/sweep.py` `WeightSweep` (`sweep.vrun`,
    `sweep.until0`/`until`/`preempt1`): `seq_run`'s pass for each row of a
    [V, S] weight matrix in one launch, a block per variant at a time, each
    variant with its own stacked state and trace.

Four more (`csrc/gang_kernels.cu`, compiled with seq_kernels.cu so they
share its device functions) carry the gang engine's rounds, K9 of
`gang.py` `_build_run` (engine/gang.py drives them):

  * `gang_eval` — `pod_score_row`/`eval_all`/`eval_rows`: the attempt of
    every pod of a device list against one state, as rows of masked totals
    (or, with trace rows, the record path's per-pod evaluation);
  * `gang_topk` — `lax.top_k` of each row (ties to the lower node);
  * `gang_match` — one round's one-commit-per-node matching;
  * `gang_bind` — `bind_all`, the round's commits scattered into state.

Each wrapper takes its plain version (`*_plain`, a line-by-line PyTorch
rendering of the reference's closure) only for tensors that lie on the CPU;
for CUDA tensors it launches the kernel or raises. The kernels are built
with `nvcc` for sm_90a into `build/kernels/` at first use, in one library
with the delta encoder's K10 kernels (`csrc/delta_kernels.cu`, wrapped by
`engine/scatter.py`), and bound through a plain C interface with ctypes. Module state is the library handle and the
per-wrapper counters `LAUNCHES` (kernel launches) and `PLAIN_CALLS`.

`seq_bind` and `seq_evict` (both versions) update the state they are given
in place, where the reference returns a new state; `seq_run` clones its
initial state first.

The victims of a dry run are a CSR record, not the reference's dense
[N, P] mask: node offsets [N+1] into a list of victim pod indices, each
node's victims in reprieve order (priority descending, then bind order).
`seq_run` keeps every dry run's victims in one such list
(`TRACE_SLOTS_PREEMPT`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import operator
import os
import shutil
import subprocess
import time
import weakref
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from ..sched.config import MAX_NODE_SCORE
from . import kernels as K
from . import encode_rel
from . import preempt as PR
from .encode import RES_TYPED, ClusterArrays, EncodedCluster, SchedState
from .encode_vol import VOL_LIMIT_PLUGINS

CSRC = Path(__file__).resolve().parent.parent / "csrc" / "seq_kernels.cu"
LAYOUT_H = CSRC.with_name("seq_layout.h")  # the structs, included by CSRC
DELTA_CSRC = CSRC.with_name("delta_kernels.cu")  # K10, wrapped by engine/scatter.py
GANG_CSRC = CSRC.with_name("gang_kernels.cu")  # K9, included by CSRC
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

KERNELS = ("seq_attempt", "seq_bind", "seq_run", "seq_preempt", "seq_evict",
           "gang_eval", "gang_topk", "gang_match", "gang_bind", "sweep_run")
LAUNCHES = dict.fromkeys(KERNELS, 0)
PLAIN_CALLS = dict.fromkeys(KERNELS, 0)
_LIB = None
_LAYOUT = None  # the struct mirror, with the library
# the device types whose tensors the library's launchers take
KERNEL_DEVICE_TYPES = ("cuda",)

# Capacities of the kernel's config block (csrc/seq_layout.h `Cfg`; the
# library's own are checked against these when it loads).
MAX_F, MAX_S, MAX_SPEC, MAX_PTS, MAX_BAL = 16, 8, 16, 16, 16
N_VOL3 = len(VOL_LIMIT_PLUGINS)
_CFG_FIELDS = (
    ("n_filters", 1), ("filter", MAX_F),
    ("n_scores", 1), ("score", MAX_S), ("mode", MAX_S),
    ("fit_type", 1), ("fit_wsum", 1), ("fit_n", 1),
    ("fit_r", MAX_SPEC), ("fit_w", MAX_SPEC),
    ("rtcr_n", 1), ("rtcr_x", MAX_PTS), ("rtcr_y", MAX_PTS),
    ("bal_n", 1), ("bal_r", MAX_BAL),
    ("spread_on", 1), ("interpod_on", 1), ("hard_w", 1),
    ("pf_vb", 1), ("preempt", 1), ("vbound", 1), ("vol_limit", N_VOL3),
)
CFG_INTS = sum(n for _, n in _CFG_FIELDS)
_NORM_IDS = {None: 0, "default": 1, "default_reverse": 2, "custom": 3}


def reset_counts() -> None:
    """Set every launch and plain-call counter to 0."""
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


# ---------------------------------------------------------------------------
# the program: one engine's plugins, in the forms the two versions read
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SeqProgram:
    """The enabled prefilter, filter, score and postFilter plugins of one
    engine: the plain bodies the CPU version calls, and the packed config
    block the kernels read."""

    filter_names: tuple[str, ...]
    score_names: tuple[str, ...]
    filters: tuple[Callable, ...]
    scores: tuple[Callable, ...]
    normalize: tuple["str | None", ...]
    cfg: np.ndarray  # int32 [CFG_INTS]
    score_dtype: torch.dtype
    np1: int  # topology pairs + 1 (the pair axis of the relational counts)
    prefilters: tuple[Callable, ...] = ()  # VolumeBinding's, when enabled
    preempt: "Callable | None" = None  # the plain dry run (preempt.py)
    vbound: int = 0  # victims per node the dry run keeps (0: no preemption)
    # the cluster planes checked for this program's launches, by id(arrays)
    # (`_planes`); the newest _BOUND_MAX
    bound: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)


def pack_config(enc: EncodedCluster, filter_names, score_names, prefilter_names=(),
                vbound: int = 0) -> np.ndarray:
    """The kernel's config block for these plugins (field order of `Cfg`).
    Raises ValueError where the block cannot hold the configuration."""
    vals: dict[str, list[int]] = {}

    def put(name, xs, cap):
        xs = [int(x) for x in xs]
        if len(xs) > cap:
            raise ValueError(f"kernel config holds at most {cap} {name} entries, got {len(xs)}")
        vals[name] = xs

    put("filter", [K.FILTER_KERNELS[n][2] for n in filter_names], MAX_F)
    vals["n_filters"] = [len(filter_names)]
    put("score", [K.SCORE_KERNELS[n][2] for n in score_names], MAX_S)
    put("mode", [_NORM_IDS[K.SCORE_KERNELS[n][1]] for n in score_names], MAX_S)
    vals["n_scores"] = [len(score_names)]
    stype, specs, wsum, shape = K.fit_score_args(enc)
    vals["fit_type"], vals["fit_wsum"], vals["fit_n"] = [stype], [wsum], [len(specs)]
    put("fit_r", [r for r, _ in specs], MAX_SPEC)
    put("fit_w", [w for _, w in specs], MAX_SPEC)
    shape = shape or []
    vals["rtcr_n"] = [len(shape)]
    put("rtcr_x", [x for x, _ in shape], MAX_PTS)
    put("rtcr_y", [y for _, y in shape], MAX_PTS)
    bal = K.balanced_resources(enc)
    vals["bal_n"] = [len(bal)]
    put("bal_r", bal, MAX_BAL)
    prescore = enc.config.enabled("preScore")
    vals["spread_on"] = [int("PodTopologySpread" in prescore)]
    vals["interpod_on"] = [int("InterPodAffinity" in prescore)]
    vals["hard_w"] = [K.interpod_hard_weight(enc)]
    vals["pf_vb"] = [int("VolumeBinding" in prefilter_names)]
    vals["preempt"] = [int(vbound > 0)]
    vals["vbound"] = [vbound]
    vals["vol_limit"] = [K.volume_limit(n)[1] for n in VOL_LIMIT_PLUGINS]
    out: list[int] = []
    for name, n in _CFG_FIELDS:
        xs = vals[name]
        out += xs + [0] * (n - len(xs))
    lim = np.iinfo(np.int32)
    if any(not lim.min <= x <= lim.max for x in out):
        raise ValueError("kernel config values must fit int32")
    return np.asarray(out, np.int32)


def build_program(enc: EncodedCluster, filter_names, score_names, prefilter_names=(),
                  preempt: bool = False) -> SeqProgram:
    """The program of these plugins. `prefilter_names`: the enabled
    prefilters with a body (PREFILTER_KERNELS); `preempt`: DefaultPreemption
    is enabled."""
    np1 = enc.aux["n_node_pairs"] + 1
    if enc.arrays.rel.node_pair.numel() and int(enc.arrays.rel.node_pair.max()) >= np1:
        raise ValueError("node_pair holds pair ids beyond n_node_pairs")
    vbound = PR.victim_bound(enc, filter_names) if preempt else 0
    return SeqProgram(
        filter_names=tuple(filter_names),
        score_names=tuple(score_names),
        filters=tuple(K.FILTER_KERNELS[n][0](enc) for n in filter_names),
        scores=tuple(K.SCORE_KERNELS[n][0](enc) for n in score_names),
        normalize=tuple(K.SCORE_KERNELS[n][1] for n in score_names),
        cfg=pack_config(enc, filter_names, score_names, prefilter_names, vbound),
        score_dtype=enc.policy.score,
        np1=np1,
        prefilters=tuple(K.PREFILTER_KERNELS[n][0](enc) for n in prefilter_names),
        preempt=PR.build_preemption(enc, filter_names) if preempt else None,
        vbound=vbound,
    )


# ---------------------------------------------------------------------------
# plain PyTorch versions (engine.py attempt / bind / step+run, line by line)
# ---------------------------------------------------------------------------


def seq_attempt_plain(prog: SeqProgram, a: ClusterArrays, s: SchedState, weights, p: int):
    """One full PreFilter→Filter→Score→Normalize→select pass for pod p.
    Returns (codes [N,F] int32, raw [N,S], final [N,S], sel [] int32,
    pf_codes [n_pf] int32)."""
    N = a.node_mask.shape[0]
    dev = a.node_mask.device
    score_dt = prog.score_dtype
    if prog.prefilters:
        pf_codes = torch.stack([k(a, s, p) for k in prog.prefilters]).to(torch.int32)
    else:
        pf_codes = torch.zeros((0,), dtype=torch.int32, device=dev)
    pf_ok = (pf_codes == 0).all()
    if prog.filters:
        codes = torch.stack([k(a, s, p) for k in prog.filters], dim=1)  # [N,F]
    else:
        codes = torch.zeros((N, 0), dtype=torch.int32, device=dev)
    feasible = (codes == 0).all(dim=1) & a.node_mask & pf_ok
    if prog.scores:
        raw = torch.stack([k(a, s, p, feasible) for k in prog.scores], dim=1)  # [N,S]
        finals = []
        for j, mode in enumerate(prog.normalize):
            r = raw[:, j]
            if mode in ("default", "default_reverse"):
                mx = torch.max(torch.where(feasible, r, torch.zeros_like(r)))
                scaled = K.fdiv(r * MAX_NODE_SCORE, torch.clamp(mx, min=1))
                if mode == "default_reverse":
                    normed = torch.where(
                        mx == 0, torch.full_like(scaled, MAX_NODE_SCORE), MAX_NODE_SCORE - scaled
                    )
                else:
                    normed = torch.where(mx == 0, r, scaled)
            elif mode == "custom":
                normed = prog.scores[j]._normalize(a, s, p, r, feasible)
            else:
                normed = r
            finals.append(normed.to(score_dt) * weights[j])
        final = torch.stack(finals, dim=1)  # [N,S]
        total = final.sum(dim=1, dtype=score_dt)
    else:
        raw = torch.zeros((N, 0), dtype=score_dt, device=dev)
        final = raw
        total = torch.zeros((N,), dtype=score_dt, device=dev)
    neg = torch.iinfo(score_dt).min // 2
    masked = torch.where(feasible, total, torch.full_like(total, neg))
    sel = torch.argmax(masked).to(torch.int32)  # first occurrence: lowest index
    sel = torch.where(feasible.any(), sel, torch.full_like(sel, -1))
    return codes, raw, final, sel, pf_codes


def seq_bind_plain(prog: SeqProgram, a: ClusterArrays, s: SchedState, p: int,
                   sel: torch.Tensor, qi: int):
    """Bind pod p to node `sel` (a 0-dim int32 tensor, -1 = unschedulable)
    at queue position qi, in place. p < 0 marks a queue-bucket padding step:
    an exact no-op. Returns `s`."""
    if p < 0:
        return s
    P = a.pod_mask.shape[0]
    tgt = torch.clamp(sel, min=0).reshape(1)
    valid = sel >= 0
    s.requested.index_add_(0, tgt, (a.pod_req[p] * valid.to(a.pod_req.dtype))[None])
    s.s_requested.index_add_(0, tgt, (a.pod_sreq[p] * valid.to(a.pod_sreq.dtype))[None])
    vi = valid.to(torch.int32)
    s.n_pods.index_add_(0, tgt, vi.reshape(1))
    s.used_pair.index_add_(0, tgt, (a.want_pair[p] * vi)[None])
    s.used_wild.index_add_(0, tgt, (a.want_wild[p] * vi)[None])
    s.used_trip.index_add_(0, tgt, (a.want_trip[p] * vi)[None])
    s.used_claims += a.pod_claim[p].to(torch.int32) * vi
    s.node_disk_any.index_add_(0, tgt, (a.pod_disk_any[p] * vi)[None])
    s.node_disk_rw.index_add_(0, tgt, (a.pod_disk_rw[p] * vi)[None])
    s.node_vol3.index_add_(0, tgt, (a.pod_vol3[p] * vi)[None])
    s.assignment[p] = sel
    s.bound_seq[p] = torch.where(valid, sel.new_tensor(P + qi), sel.new_tensor(-1))
    return s


def seq_evict_plain(prog: SeqProgram, a: ClusterArrays, s: SchedState, mask: torch.Tensor):
    """Remove every pod of `mask` ([P] bool; bound pods) from its node, in
    place (the reference's evict_all): its rows leave every per-node
    counter, its claims leave `used_claims`, and its assignment and bind
    order become -1. Returns `s`."""
    tgt = torch.clamp(s.assignment, min=0).long()
    mf = mask.to(a.pod_req.dtype)[:, None]
    mi = mask.to(torch.int32)
    s.requested.index_add_(0, tgt, -(a.pod_req * mf))
    s.s_requested.index_add_(0, tgt, -(a.pod_sreq * mf))
    s.n_pods.index_add_(0, tgt, -mi)
    s.used_pair.index_add_(0, tgt, -(a.want_pair * mi[:, None]))
    s.used_wild.index_add_(0, tgt, -(a.want_wild * mi[:, None]))
    s.used_trip.index_add_(0, tgt, -(a.want_trip * mi[:, None]))
    s.used_claims -= (a.pod_claim.to(torch.int32) * mi[:, None]).sum(dim=0, dtype=torch.int32)
    s.node_disk_any.index_add_(0, tgt, -(a.pod_disk_any * mi[:, None]))
    s.node_disk_rw.index_add_(0, tgt, -(a.pod_disk_rw * mi[:, None]))
    s.node_vol3.index_add_(0, tgt, -(a.pod_vol3 * mi[:, None]))
    s.assignment.masked_fill_(mask, -1)
    s.bound_seq.masked_fill_(mask, -1)
    return s


def victims_csr(a: ClusterArrays, s: SchedState, vmask: torch.Tensor):
    """A dense [N, P] victim mask as the kernels record it: (node offsets
    [N+1] int32, victim pod indices int32), each node's victims in
    reprieve order (`preempt.reprieve_order` at state s)."""
    counts = vmask.sum(dim=1)
    order = PR.reprieve_order(a, s, vmask)
    take = torch.arange(vmask.shape[1], device=vmask.device)[None, :] < counts[:, None]
    idx = order[take].to(torch.int32)
    off = torch.zeros(vmask.shape[0] + 1, dtype=torch.int32, device=vmask.device)
    off[1:] = torch.cumsum(counts, 0).to(torch.int32)
    return off, idx


def csr_mask(off: torch.Tensor, idx: torch.Tensor, P: int) -> torch.Tensor:
    """The dense [N, P] bool mask of a CSR victim record."""
    N = off.shape[0] - 1
    rows = torch.repeat_interleave(torch.arange(N, device=off.device),
                                   (off[1:] - off[:-1]).long())
    m = torch.zeros((N, P), dtype=torch.bool, device=off.device)
    m[rows, (idx[off[0]:off[-1]]).long()] = True
    return m


def seq_preempt_plain(prog: SeqProgram, a: ClusterArrays, s: SchedState, p: int):
    """K7 for pod p at state s: (pcode [N] int32, victim offsets [N+1]
    int32, victim pod indices [M] int32, nominated [] int32)."""
    pcode, vmask, nominated = prog.preempt(a, s, p)
    off, idx = victims_csr(a, s, vmask)
    return pcode, off, idx, nominated


# Trace slots of `seq_run` with record=True, by tuple position: the
# reference's TRACE_SLOTS_PLAIN, and with DefaultPreemption enabled its
# TRACE_SLOTS_PREEMPT with the two [Q, N, P] victim masks replaced by a
# victim record: `voff` [Q, 2, N+1] (offsets into `vidx` of the step's
# first and second dry run's victims, by node; empty ranges where the step
# did not fire) and `vidx` [M] (victim pod indices, each node's in reprieve
# order). Rows of steps that did not fire are zero (-1 for node indices),
# as the reference's.
TRACE_SLOTS_PLAIN = ("pf_codes", "codes", "raw", "final", "sel")
TRACE_SLOTS_PREEMPT = TRACE_SLOTS_PLAIN + (
    "did", "pcode", "nominated", "sel2", "pcode2", "nominated2", "final_sel",
    "codes2", "raw2", "final2", "voff", "vidx",
)


def _stack(rows, empty):
    return torch.stack(rows) if rows else empty


def seq_run_plain(prog: SeqProgram, a: ClusterArrays, state0: SchedState, queue, weights,
                  *, record: bool, step0: int = 0, qpos=None):
    """The sequential pass: for each queue position, attempt then bind (pod
    i sees pod i-1's bind), with the preemption branch when the program
    has one. Padding steps (pod -1) evaluate pod 0 and discard the result;
    they bind nothing, so a run of them sees one state and shares one row.
    `step0`: the pass-wide step of the queue's first pod (a segment of a
    longer pass, as the reference's run_segment; bind order is P + step).
    `qpos`: each step's queue position (int32 [Q]) in place of step0 + i,
    for a segment whose pods keep their own positions (the gang engine's
    preempt phase, bind order P + order[p]).
    Returns (final state, trace): the trace is TRACE_SLOTS_PLAIN (or
    TRACE_SLOTS_PREEMPT) when `record`, else the bound selection [Q]."""
    s = state0.clone()
    N, P = a.node_mask.shape[0], a.pod_mask.shape[0]
    F, S = len(prog.filters), len(prog.scores)
    dev, dt = a.node_mask.device, prog.score_dtype
    i32 = dict(dtype=torch.int32, device=dev)
    rows = []
    pos = torch.as_tensor(qpos).tolist() if qpos is not None else None
    pad_row = None
    for qi, p in enumerate(torch.as_tensor(queue).tolist()):
        if p < 0 and pad_row is not None:
            rows.append(pad_row)
            continue
        ps = max(p, 0)
        codes, raw, final, sel, pf = seq_attempt_plain(prog, a, s, weights, ps)
        if p < 0:
            sel = torch.full_like(sel, -1)
        final_sel = sel
        extra = None
        if prog.preempt is not None:
            do = int(sel) < 0 and bool((pf == 0).all()) and bool(a.pod_mask[ps]) and p >= 0
            zero_n = torch.zeros(N, **i32)
            none = torch.tensor(-1, **i32)
            extra = (torch.tensor(do, device=dev), zero_n, none, none, zero_n, none, None)
            if do:
                pcode, vmask, nom = prog.preempt(a, s, ps)
                rec1 = victims_csr(a, s, vmask)
                if int(nom) >= 0:
                    seq_evict_plain(prog, a, s, vmask[int(nom)])
                codes2, raw2, final2, sel2, _ = seq_attempt_plain(prog, a, s, weights, ps)
                pcode2, vmask2, nom2 = prog.preempt(a, s, ps)
                rec2 = victims_csr(a, s, vmask2)
                final_sel = sel2 if int(nom) >= 0 else sel
                extra = (extra[0], pcode, nom, sel2, pcode2, nom2,
                         (codes2, raw2, final2, rec1, rec2))
        seq_bind_plain(prog, a, s, p, final_sel, pos[qi] if pos is not None else step0 + qi)
        rows.append((pf, codes, raw, final, sel, final_sel, extra))
        pad_row = rows[-1] if p < 0 else None
    Q = len(rows)
    if not record:
        return s, _stack([r[5] for r in rows], torch.zeros((0,), **i32))
    n_pf = len(prog.prefilters)
    trace = (
        _stack([r[0] for r in rows], torch.zeros((0, n_pf), **i32)),
        _stack([r[1] for r in rows], torch.zeros((0, N, F), **i32)),
        _stack([r[2] for r in rows], torch.zeros((0, N, S), dtype=dt, device=dev)),
        _stack([r[3] for r in rows], torch.zeros((0, N, S), dtype=dt, device=dev)),
        _stack([r[4] for r in rows], torch.zeros((0,), **i32)),
    )
    if prog.preempt is None:
        return s, trace
    ex = [r[6] for r in rows]
    did = _stack([e[0] for e in ex], torch.zeros((0,), dtype=torch.bool, device=dev))
    dense = [_stack([e[j] for e in ex], torch.zeros((0, N) if j in (1, 4) else (0,), **i32))
             for j in range(1, 6)]
    off_rows, idx_parts, base = [], [], 0
    retry = {"codes2": [], "raw2": [], "final2": []}
    for e, (_, codes, raw, final, *_) in zip(ex, rows):
        if e[6] is None:  # no dry run: zero rows, empty victim records
            off_rows.append(torch.full((2, N + 1), base, **i32))
            for k, t in zip(retry, (codes, raw, final)):
                retry[k].append(torch.zeros_like(t))
            continue
        *fired, rec1, rec2 = e[6]
        for k, t in zip(retry, fired):
            retry[k].append(t)
        pair = []
        for off, idx in (rec1, rec2):
            pair.append(off + base)
            idx_parts.append(idx)
            base += len(idx)
        off_rows.append(torch.stack(pair))
    codes2 = _stack(retry["codes2"], torch.zeros((0, N, F), **i32))
    raw2 = _stack(retry["raw2"], torch.zeros((0, N, S), dtype=dt, device=dev))
    final2 = _stack(retry["final2"], torch.zeros((0, N, S), dtype=dt, device=dev))
    voff = _stack(off_rows, torch.zeros((0, 2, N + 1), **i32))
    vidx = torch.cat(idx_parts) if idx_parts else torch.zeros((0,), **i32)
    final_sel = _stack([r[5] for r in rows], torch.zeros((0,), **i32))
    pcode, nominated, sel2, pcode2, nominated2 = dense
    return s, trace + (did, pcode, nominated, sel2, pcode2, nominated2, final_sel,
                       codes2, raw2, final2, voff, vidx)


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------


def build() -> tuple[Path, float]:
    """Compile the kernel sources for sm_90a into one library in
    build/kernels/ unless these sources' library is there already: three
    `nvcc` processes started together, csrc/seq_kernels.cu (with the gang
    kernels it includes) once per integer type (SEQ_ONLY=32, 64) and
    csrc/delta_kernels.cu, then one link. Returns (library path, build seconds; 0 when it was there). The
    compiler's report (registers, shared memory, spills) is kept beside the
    library as a .log file."""
    src = (CSRC.read_bytes() + LAYOUT_H.read_bytes() + GANG_CSRC.read_bytes()
           + DELTA_CSRC.read_bytes())
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libkernels_{tag}.so"
    if out.exists():
        return out, 0.0
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    units = [(CSRC, ["-DSEQ_ONLY=32"], "seq32"), (CSRC, ["-DSEQ_ONLY=64"], "seq64"),
             (DELTA_CSRC, [], "delta")]
    objs = [out.with_name(f"{out.stem}_{u}.{os.getpid()}.o") for _, _, u in units]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, *defs, "-c", "-o", str(o), str(path)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for (path, defs, _), o in zip(units, objs)]
    logs = [p.communicate()[0] for p in procs]
    if any(p.returncode for p in procs):
        raise RuntimeError("nvcc failed:\n" + "\n".join(logs))
    res = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                         capture_output=True, text=True)
    secs = time.perf_counter() - t0
    for o in objs:
        o.unlink()
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    out.with_suffix(".log").write_text("".join(logs) + res.stdout + res.stderr)
    os.replace(tmp, out)
    return out, secs


# Every tensor the kernels read: its dims and its element type ("b": bool;
# "i": an integer — the policy's type for encode.RES_TYPED fields, int32 for
# the rest). Dim names ending in _T, _C, _VP belong to one relational term
# domain (encode_rel.DOMAINS). The order of the kernels' struct members is
# the library's own (`_Layout`).
_SPEC = {
    "node_alloc": "N R i", "node_unsched": "N b", "node_mask": "N b",
    "pod_req": "P R i", "pod_sreq": "P R i", "pod_req_rank": "P R i",
    "pod_node_name": "P i", "pod_tol_unsched": "P b", "pod_priority": "P i",
    "pod_mask": "P b",
    "taint_key": "N T i", "taint_val": "N T i", "taint_effect": "N T i",
    "tol_key": "P L i", "tol_val": "P L i", "tol_effect": "P L i", "tol_op": "P L i",
    "label_val": "N K i", "label_num": "N K i", "label_num_ok": "N K b",
    "nsel_key": "P NS i", "nsel_val": "P NS i",
    "raff_key": "P TM E i", "raff_op": "P TM E i", "raff_vals": "P TM E VV i",
    "raff_num": "P TM E i", "raff_num_ok": "P TM E b", "raff_term_valid": "P TM b",
    "pod_has_raff": "P b",
    "paff_key": "P PR E i", "paff_op": "P PR E i", "paff_vals": "P PR E VV i",
    "paff_num": "P PR E i", "paff_num_ok": "P PR E b", "paff_weight": "P PR i",
    "paff_term_valid": "P PR b",
    "want_wild": "P Q i", "want_trip": "P V2 i", "want_pair": "P Q i", "trip_pair": "V2 i",
    "img_contrib": "N I i", "pod_img": "P I i", "pod_ncont": "P i",
    "vb_row": "P i", "vb_code": "N VB i", "vz_code": "N VB i", "vb_pf": "P i",
    "pod_claim": "P CL b", "pod_disk_any": "P D i", "pod_disk_rw": "P D i",
    "pod_vol3": "P V3 i",
    # PodRelArrays
    "pair_present": "P LP b", "key_present": "P KK b", "ns_id": "P i", "deleted": "P b",
    "node_pair": "N K i", "req_all": "P b", "spread_lut": "LUT i",
    "sph_skew": "P sph_T i", "sph_self": "P sph_T b",
    "sps_skew": "P sps_T i", "sps_host": "P sps_T b",
    "ia_self": "P ia_T b", "ipa_weight": "P ipa_T i", "ipan_weight": "P ipan_T i",
    **{k: v for d in encode_rel.DOMAINS for k, v in {
        f"{d}_key": f"P {d}_T i",
        f"{d}_ctype": f"P {d}_T {d}_C i",
        f"{d}_ckey": f"P {d}_T {d}_C i",
        f"{d}_cpairs": f"P {d}_T {d}_C {d}_VP i",
    }.items()},
    **{k: v for d in ("ia", "ian", "ipa", "ipan") for k, v in {
        f"{d}_nsall": f"P {d}_T b",
        f"{d}_ns": f"P {d}_T NSV b",
    }.items()},
    # SchedState
    "requested": "N R i", "s_requested": "N R i", "n_pods": "N i",
    "assignment": "P i", "used_pair": "N Q i", "used_wild": "N Q i",
    "used_trip": "N V2 i", "used_claims": "CL i", "node_disk_any": "N D i",
    "node_disk_rw": "N D i", "node_vol3": "N V3 i", "bound_seq": "P i",
}

# name -> (dim names, element kind)
_SPEC_DIMS = {k: (tuple(v.split()[:-1]), v.split()[-1]) for k, v in _SPEC.items()}
# the flag plane of each term domain that has one
_TERM_FLAG = {"sph": "sph_self", "sps": "sps_host", "ia": "ia_self"}
_A_FIELDS = tuple(f.name for f in dataclasses.fields(ClusterArrays) if f.name != "rel")
_REL_FIELDS = tuple(f.name for f in dataclasses.fields(encode_rel.PodRelArrays))
_STATE_FIELDS = tuple(f.name for f in dataclasses.fields(SchedState))


def _struct(name: str, fields: list) -> type:
    return type(name, (ctypes.Structure,), {"_fields_": fields})


class _Layout:
    """The ctypes mirror of the kernels' structs, built from the member
    lists the library reports (`seq_layout`), so their order is the C
    declaration's."""

    def __init__(self, report: str):
        lists = dict(part.split("=", 1) for part in report.split(";") if part)
        self.names = {k: tuple(n for n in v.split(",") if n) for k, v in lists.items()}
        n = self.names
        if n["cfg"] != tuple(name for name, _ in _CFG_FIELDS):
            raise RuntimeError(f"kernel Cfg fields {n['cfg']} differ from engine/cuda.py's")
        if n["state_ptrs"] != _STATE_FIELDS:
            raise RuntimeError(f"kernel State {n['state_ptrs']} differs from SchedState")
        if n["term_domains"] != encode_rel.DOMAINS:
            raise RuntimeError(f"kernel term domains {n['term_domains']} differ")
        if set(_SPEC) - set(_A_FIELDS + _REL_FIELDS + _STATE_FIELDS):
            raise RuntimeError("_SPEC names a tensor the arrays and state do not hold")
        unknown = [x for x in n["plane_ptrs"] if x not in _SPEC]
        if unknown:
            raise RuntimeError(f"kernel planes {unknown} are not in engine/cuda.py's _SPEC")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        self.NodeTerms = _struct("NodeTerms", [(x, vp) for x in n["node_term_ptrs"]]
                                 + [(x, ci) for x in n["node_term_dims"]])
        self.Terms = _struct("Terms", [(x, vp) for x in n["term_ptrs"]]
                             + [(x, ci) for x in n["term_dims"]])
        self.Planes = _struct(
            "Planes", [(x, vp) for x in n["plane_ptrs"]]
            + [(x, self.NodeTerms) for x in n["node_term_sets"]]
            + [(x, self.Terms) for x in n["term_domains"]]
            + [(x, ci) for x in n["plane_dims"]])
        self.State = _struct("State", [(x, vp) for x in n["state_ptrs"]])
        self.Trace = _struct("Trace", [(x, vp) for x in n["trace_ptrs"]]
                             + [(x, ci) for x in n["trace_dims"]])
        ll = ctypes.c_longlong
        self.StateStride = _struct("StateStride", [(x, ll) for x in n["state_ptrs"]])
        self.TraceStride = _struct("TraceStride", [(x, ll) for x in n["trace_ptrs"]])


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _LIB, _LAYOUT
    if _LIB is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.seq_layout.argtypes, lib.seq_layout.restype = [], ctypes.c_char_p
        lib.seq_cfg_counts.argtypes, lib.seq_cfg_counts.restype = [vp], ci
        for fn in (lib.seq_planes_bytes, lib.seq_state_bytes, lib.seq_trace_bytes,
                   lib.seq_stride_bytes):
            fn.argtypes, fn.restype = [], ci
        lib.seq_workspace_bytes.argtypes = [vp, ci, ci]
        lib.seq_workspace_bytes.restype = ctypes.c_longlong
        for t in ("i32", "i64"):
            for name, args in (
                ("seq_attempt", [vp, vp, vp, vp, ci] + [vp] * 8),
                ("seq_bind", [vp, vp, ci, vp, ci, vp]),
                ("seq_evict", [vp, vp, vp, vp]),
                ("seq_preempt", [vp, vp, vp, ci] + [vp] * 7),
                ("seq_run", [vp, vp, vp, vp, vp, vp, ci, ci] + [vp] * 6),
                ("gang_eval", [vp] * 5 + [ci, vp, ci, vp, vp, ci] + [vp] * 6 + [ci]
                 + [vp] * 4 + [ctypes.c_longlong, vp]),
                ("gang_topk", [vp, ci, ci, ci, vp, ci, vp, vp, vp]),
                ("gang_match", [vp, vp, ci, ci, ci, vp, vp, vp, vp, ci, vp, ci, ci, ci]
                 + [vp] * 8),
                ("gang_bind", [vp, vp, vp, ci, vp, ci, vp, vp, vp, vp]),
                ("sweep_run", [vp] * 5 + [ci, vp, ci, vp, vp, ci] + [vp] * 4
                 + [ctypes.c_longlong, vp]),
                ("sweep_seg", [vp] * 5 + [ci, vp, vp, ci, vp, vp, ci] + [vp] * 4
                 + [ctypes.c_longlong, vp]),
                ("sweep_run_grid", [ci, ci]),
                ("sweep_seg_grid", [ci]),
            ):
                f = getattr(lib, f"{name}_{t}")
                f.argtypes, f.restype = args, ci
            f = getattr(lib, f"gang_eval_grid_{t}")
            f.argtypes, f.restype = [ci, ci], ci
        cl = ctypes.c_longlong
        for name in ("delta_scatter_set", "delta_scatter_add"):
            f = getattr(lib, name)
            f.argtypes, f.restype = [vp, vp, vp, cl, cl, ci, vp], ci
        lib.delta_vec_add.argtypes, lib.delta_vec_add.restype = [vp, vp, cl, ci, vp], ci
        layout = _Layout(lib.seq_layout().decode())
        counts = (ctypes.c_int * len(_CFG_FIELDS))()
        if (lib.seq_cfg_counts(counts) != len(_CFG_FIELDS)
                or list(counts) != [c for _, c in _CFG_FIELDS]):
            raise RuntimeError("kernel Cfg capacities differ from engine/cuda.py's")
        if (lib.seq_planes_bytes(), lib.seq_state_bytes(), lib.seq_trace_bytes(),
                lib.seq_stride_bytes()) != (
            ctypes.sizeof(layout.Planes), ctypes.sizeof(layout.State),
            ctypes.sizeof(layout.Trace),
            ctypes.sizeof(layout.StateStride) + ctypes.sizeof(layout.TraceStride),
        ):
            raise RuntimeError("kernel library's struct sizes differ from engine/cuda.py's")
        _LIB, _LAYOUT = lib, layout
    return _LIB


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _on_cpu(x: "ClusterArrays | torch.Tensor") -> bool:
    t = x if isinstance(x, torch.Tensor) else x.node_mask
    return t.device.type == "cpu"


_get_a = operator.attrgetter(*_A_FIELDS)
_get_rel = operator.attrgetter(*_REL_FIELDS)
_get_state = operator.attrgetter(*_STATE_FIELDS)


def _leaves(a: ClusterArrays) -> tuple:
    return _get_a(a) + _get_rel(a.rel)


def _same(refs: list, objs: tuple) -> bool:
    """Each weak reference still points at the object beside it."""
    return len(refs) == len(objs) and all(map(operator.is_, [r() for r in refs], objs))


def _check_tensor(name: str, t: torch.Tensor, dims: dict, dev, res_dt) -> None:
    names, kind = _SPEC_DIMS[name]
    want = torch.bool if kind == "b" else (res_dt if name in RES_TYPED else torch.int32)
    if t.device != dev or t.dtype != want or t.dim() != len(names):
        raise ValueError(
            f"{name}: want {want} [{' '.join(names)}] on {dev}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
        )
    for d, size in zip(names, t.shape):
        if dims.setdefault(d, size) != size:
            raise ValueError(f"{name}: dim {d} is {size}, elsewhere {dims[d]}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


@dataclass
class _Bound:
    """The checked planes of one (program, arrays) pair, and the last state
    checked against them. The weak references pin what was checked: a hit
    needs the arrays and every tensor to be the same objects."""

    refs: list
    planes: ctypes.Structure
    dims: dict
    ws_bytes: int
    suffix: str
    state_refs: list
    state: "ctypes.Structure | None" = None
    stack_refs: list = dataclasses.field(default_factory=list)
    stack: "tuple | None" = None  # (State, StateStride) of the last stacked state


_BOUND_MAX = 4


def _planes(prog: SeqProgram, a: ClusterArrays) -> _Bound:
    """The cluster planes of (prog, a), validated against `_SPEC` (device,
    element type, contiguity, consistent dims) and packed into the kernels'
    Planes struct once per pair; later calls with the same program, arrays
    and tensors reuse it. A tensor whose storage is swapped in place
    (`.data =`, `resize_`) is not seen."""
    dev = a.node_mask.device
    objs = (a,) + _leaves(a)
    hit = prog.bound.get(id(a))
    if hit is not None and _same(hit.refs, objs):
        return hit
    res_dt = prog.score_dtype
    if res_dt not in (torch.int32, torch.int64):
        raise ValueError(f"unsupported score dtype {res_dt}")
    lib = library()
    tensors = dict(zip(_A_FIELDS + _REL_FIELDS, objs[1:]))
    dims: dict[str, int] = {"NP1": prog.np1, "V3": N_VOL3}
    for name in _SPEC:
        if name in tensors:
            _check_tensor(name, tensors[name], dims, dev, res_dt)
    names = _LAYOUT.names

    def ptr(name):
        return tensors[name].data_ptr() if name in tensors else None

    def node_terms(pre):
        tm = "TM" if pre == "raff" else "PR"
        return _LAYOUT.NodeTerms(*(ptr(f"{pre}_{m}") for m in names["node_term_ptrs"]),
                                 *(dims[{"TM": tm}.get(x, x)] for x in names["node_term_dims"]))

    def terms(d):
        ptrs = (ptr(_TERM_FLAG.get(d) if m == "flag" else f"{d}_{m}")
                for m in names["term_ptrs"])
        return _LAYOUT.Terms(*ptrs, *(dims[f"{d}_{x}"] for x in names["term_dims"]))

    planes = _LAYOUT.Planes(
        *map(ptr, names["plane_ptrs"]), *map(node_terms, names["node_term_sets"]),
        *map(terms, names["term_domains"]), *(dims[d] for d in names["plane_dims"]),
    )
    t = "i32" if res_dt == torch.int32 else "i64"
    ws_bytes = int(lib.seq_workspace_bytes(ctypes.addressof(planes), 4 if t == "i32" else 8,
                                           prog.vbound))
    prog.bound.pop(id(a), None)
    hit = prog.bound[id(a)] = _Bound([weakref.ref(x) for x in objs], planes, dims,
                                     max(ws_bytes, 8), t, [])
    if len(prog.bound) > _BOUND_MAX:
        del prog.bound[next(iter(prog.bound))]
    return hit


def _state(b: _Bound, s: SchedState, dev, res_dt) -> ctypes.Structure:
    """The kernels' State struct for s, checked against the planes of b
    (again only when its tensors are not the ones checked last)."""
    leaves = _get_state(s)
    if b.state is None or not _same(b.state_refs, leaves):
        dims = dict(b.dims)
        for name, t in zip(_STATE_FIELDS, leaves):
            _check_tensor(name, t, dims, dev, res_dt)
        by_name = dict(zip(_STATE_FIELDS, leaves))
        b.state = _LAYOUT.State(*(by_name[n].data_ptr() for n in _LAYOUT.names["state_ptrs"]))
        b.state_refs = [weakref.ref(x) for x in leaves]
    return b.state


def _vstride(x: torch.Tensor) -> int:
    """Bytes from one variant's slice of a stacked tensor to the next."""
    return x.stride(0) * x.element_size() if x.numel() else 0


def _stacked(b: _Bound, states: SchedState, V: int, dev, res_dt) -> tuple:
    """The kernels' (State, StateStride) for a stack of V variants' states,
    each field contiguous with a leading [V], checked against the planes of
    b (again only when its tensors are not the ones checked last)."""
    leaves = _get_state(states)
    if b.stack is None or not _same(b.stack_refs, leaves):
        dims = dict(b.dims)
        for name, x in zip(_STATE_FIELDS, leaves):
            if x.dim() < 1 or x.shape[0] != V or not x.is_contiguous():
                raise ValueError(f"{name}: want a contiguous stack of {V} variants")
            _check_tensor(name, x[0], dims, dev, res_dt)
        by_name = dict(zip(_STATE_FIELDS, leaves))
        names = _LAYOUT.names["state_ptrs"]
        b.stack = (_LAYOUT.State(*(by_name[n].data_ptr() for n in names)),
                   _LAYOUT.StateStride(*(_vstride(by_name[n]) for n in names)))
        b.stack_refs = [weakref.ref(x) for x in leaves]
    return b.stack


def _check(prog: SeqProgram, a: ClusterArrays, s: SchedState, weights=None) -> tuple:
    """What a launch reads: CUDA tensors, the cluster planes (`_planes`) and
    the state (`_state`); returns (Planes, State, workspace bytes, type
    suffix)."""
    dev, res_dt = a.node_mask.device, prog.score_dtype
    if dev.type not in KERNEL_DEVICE_TYPES:
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {dev}")
    b = _planes(prog, a)
    state = _state(b, s, dev, res_dt)
    S = len(prog.scores)
    if weights is not None and (weights.device != dev or weights.dtype != res_dt
                                or tuple(weights.shape) != (S,) or not weights.is_contiguous()):
        raise ValueError(f"weights: want contiguous {res_dt} ({S},) on {dev}")
    return b.planes, state, b.ws_bytes, b.suffix


def _workspace(n_bytes: int, dev) -> torch.Tensor:
    """The relational counters' scratch for one launch (the kernel clears
    it each step)."""
    return torch.empty((n_bytes,), dtype=torch.uint8, device=dev)


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def seq_attempt(prog: SeqProgram, a: ClusterArrays, s: SchedState, weights, p: int):
    """K1 for pod p: (codes [N,F] int32, raw [N,S], final [N,S], sel [],
    pf_codes [n_pf] int32)."""
    if _on_cpu(a):
        PLAIN_CALLS["seq_attempt"] += 1
        return seq_attempt_plain(prog, a, s, weights, p)
    planes, state, ws_bytes, t = _check(prog, a, s, weights)
    if not 0 <= p < planes.P:
        raise ValueError(f"pod index {p} outside [0, {planes.P})")
    lib = library()
    dev, N = a.node_mask.device, planes.N
    F, S = len(prog.filters), len(prog.scores)
    codes = torch.empty((N, F), dtype=torch.int32, device=dev)
    raw = torch.empty((N, S), dtype=prog.score_dtype, device=dev)
    final = torch.empty((N, S), dtype=prog.score_dtype, device=dev)
    sel = torch.empty((), dtype=torch.int32, device=dev)
    pf = torch.empty((len(prog.prefilters),), dtype=torch.int32, device=dev)
    feas = torch.empty((N,), dtype=torch.uint8, device=dev)
    ws = _workspace(ws_bytes, dev)
    cfg = np.ascontiguousarray(prog.cfg)
    rc = getattr(lib, f"seq_attempt_{t}")(
        cfg.ctypes.data, ctypes.addressof(planes), ctypes.addressof(state),
        weights.data_ptr(), p, codes.data_ptr(), raw.data_ptr(), final.data_ptr(),
        sel.data_ptr(), pf.data_ptr(), feas.data_ptr(), ws.data_ptr(), _stream(),
    )
    _raise_on(rc, "seq_attempt")
    LAUNCHES["seq_attempt"] += 1
    return codes, raw, final, sel, pf


def seq_bind(prog: SeqProgram, a: ClusterArrays, s: SchedState, p: int, sel: torch.Tensor,
             qi: int):
    """K2: bind pod p to node `sel` (0-dim int32 tensor) at queue position
    qi, in place; p < 0 is a no-op. Returns `s`."""
    if _on_cpu(a):
        PLAIN_CALLS["seq_bind"] += 1
        return seq_bind_plain(prog, a, s, p, sel, qi)
    planes, state, _, t = _check(prog, a, s)
    if p >= planes.P:
        raise ValueError(f"pod index {p} outside [0, {planes.P})")
    if sel.device != a.node_mask.device or sel.dtype != torch.int32 or sel.numel() != 1:
        raise ValueError("sel must be one int32 on the planes' device")
    sel = sel.contiguous()
    rc = getattr(library(), f"seq_bind_{t}")(
        ctypes.addressof(planes), ctypes.addressof(state), p, sel.data_ptr(), qi, _stream()
    )
    _raise_on(rc, "seq_bind")
    LAUNCHES["seq_bind"] += 1
    return s


def seq_evict(prog: SeqProgram, a: ClusterArrays, s: SchedState, mask: torch.Tensor):
    """K2 evict_all: remove every pod of `mask` ([P] bool) from its node,
    in place. Returns `s`."""
    if _on_cpu(a):
        PLAIN_CALLS["seq_evict"] += 1
        return seq_evict_plain(prog, a, s, mask)
    planes, state, _, t = _check(prog, a, s)
    if mask.device != a.node_mask.device or mask.dtype != torch.bool or tuple(mask.shape) != (
            planes.P,):
        raise ValueError(f"mask must be a bool ({planes.P},) tensor on the planes' device")
    mask = mask.contiguous()
    rc = getattr(library(), f"seq_evict_{t}")(
        ctypes.addressof(planes), ctypes.addressof(state), mask.data_ptr(), _stream()
    )
    _raise_on(rc, "seq_evict")
    LAUNCHES["seq_evict"] += 1
    return s


_OVERFLOW = {
    1: "more victims than the victim capacity",
    2: "a node holds more lower-priority pods than the victim bound",
}


def _raise_overflow(bits: int, name: str) -> None:
    if bits:
        why = "; ".join(m for b, m in _OVERFLOW.items() if bits & b)
        raise RuntimeError(f"{name}: the preemption record overflowed ({why})")


def _need_preempt(prog: SeqProgram) -> None:
    if prog.preempt is None:
        raise ValueError("the program has no DefaultPreemption")


def preempt_launch(prog: SeqProgram, a: ClusterArrays, s: SchedState, p: int):
    """Launch K7 for pod p at state s on CUDA tensors, without waiting:
    returns (pcode [N], offsets [N+1], the victim buffer [P], nominated [],
    status [2]: victims, overflow bits); `seq_preempt` reads the status and
    trims the victims."""
    _need_preempt(prog)
    planes, state, ws_bytes, t = _check(prog, a, s)
    if not 0 <= p < planes.P:
        raise ValueError(f"pod index {p} outside [0, {planes.P})")
    dev, N = a.node_mask.device, planes.N
    i32 = dict(dtype=torch.int32, device=dev)
    pcode = torch.empty((N,), **i32)
    off = torch.empty((N + 1,), **i32)
    idx = torch.empty((planes.P,), **i32)
    nominated = torch.empty((), **i32)
    status = torch.zeros((2,), **i32)
    ws = _workspace(ws_bytes, dev)
    cfg = np.ascontiguousarray(prog.cfg)
    rc = getattr(library(), f"seq_preempt_{t}")(
        cfg.ctypes.data, ctypes.addressof(planes), ctypes.addressof(state), p,
        pcode.data_ptr(), off.data_ptr(), idx.data_ptr(), nominated.data_ptr(),
        status.data_ptr(), ws.data_ptr(), _stream(),
    )
    _raise_on(rc, "seq_preempt")
    LAUNCHES["seq_preempt"] += 1
    return pcode, off, idx, nominated, status


def seq_preempt(prog: SeqProgram, a: ClusterArrays, s: SchedState, p: int):
    """K7, the dry run for pod p at state s: (pcode [N] int32, victim
    offsets [N+1] int32, victim pod indices [M] int32, nominated [] int32),
    as `seq_preempt_plain`."""
    _need_preempt(prog)
    if _on_cpu(a):
        PLAIN_CALLS["seq_preempt"] += 1
        return seq_preempt_plain(prog, a, s, p)
    pcode, off, idx, nominated, status = preempt_launch(prog, a, s, p)
    n_victims, bits = status.tolist()
    _raise_overflow(bits, "seq_preempt")
    return pcode, off, idx[:n_victims], nominated


# The most victim entries a `seq_run` records (512 MiB of int32): a pass
# whose dry runs name more raises.
VICTIM_CAP = 1 << 27


def seq_run(prog: SeqProgram, a: ClusterArrays, state0: SchedState, queue, weights,
            *, record: bool, step0: int = 0, qpos=None):
    """K3: the whole sequential pass over `queue` (int32 pod indices, -1 =
    padding) in one launch, the preemption branch inside its step. Returns
    (final state, trace) as `seq_run_plain` does; `state0` is left as it
    was. `step0` and `qpos` as `seq_run_plain`'s. The victim record holds at most
    min(2 Q P, VICTIM_CAP) entries (each dry run names at most every bound
    pod); a pass that needs more raises."""
    if _on_cpu(a):
        PLAIN_CALLS["seq_run"] += 1
        return seq_run_plain(prog, a, state0, queue, weights, record=record, step0=step0,
                             qpos=qpos)
    s = state0.clone()
    planes, state, ws_bytes, t = _check(prog, a, s, weights)
    dev, N = a.node_mask.device, planes.N
    queue = _checked_queue(queue, planes, dev)
    Q = queue.shape[0]
    if qpos is not None:
        if qpos.device != dev or qpos.dtype != torch.int32 or tuple(qpos.shape) != (Q,):
            raise ValueError(f"qpos must be an int32 ({Q},) tensor on the planes' device")
        qpos = qpos.contiguous()
    F, S = len(prog.filters), len(prog.scores)
    dt = prog.score_dtype
    pre = prog.preempt is not None
    i32 = dict(dtype=torch.int32, device=dev)
    victim_cap = min(2 * Q * planes.P, VICTIM_CAP) if record and pre else 0
    out = _run_outputs(prog, (), Q, N, record, victim_cap, dev)
    if Q:
        feas = torch.empty((N,), dtype=torch.uint8, device=dev)
        codes_s = torch.empty((N, F), **i32)
        raw_s = torch.empty((N, S), dtype=dt, device=dev)
        ws = _workspace(ws_bytes, dev)
        cfg = np.ascontiguousarray(prog.cfg)
        tr = _trace_struct(out, victim_cap)
        rc = getattr(library(), f"seq_run_{t}")(
            cfg.ctypes.data, ctypes.addressof(planes), ctypes.addressof(state),
            weights.data_ptr(), queue.data_ptr(), None if qpos is None else qpos.data_ptr(), Q,
            step0, ctypes.addressof(tr), feas.data_ptr(),
            codes_s.data_ptr(), raw_s.data_ptr(), ws.data_ptr(), _stream(),
        )
        _raise_on(rc, "seq_run")
        LAUNCHES["seq_run"] += 1
    if pre:
        n_victims, bits = out["status"].tolist()
        _raise_overflow(bits, "seq_run")
    return s, _run_result(out, pre, record, lambda: out["vidx"][:n_victims].clone())


def _checked_queue(queue, planes, dev) -> torch.Tensor:
    """The queue as the run kernels read it: 1-d int32 pod indices (-1:
    padding) on the planes' device, contiguous."""
    if queue.device != dev or queue.dtype != torch.int32 or queue.dim() != 1:
        raise ValueError("queue must be a 1-d int32 tensor on the planes' device")
    queue = queue.contiguous()
    if queue.shape[0] and (int(queue.max()) >= planes.P or int(queue.min()) < -1):
        raise ValueError(f"queue holds pod indices outside [-1, {planes.P})")
    return queue


def _run_outputs(prog: SeqProgram, lead: tuple, Q: int, N: int, record: bool,
                 victim_cap: int, dev) -> dict:
    """The tensors a run launch writes, by their Trace member names, each
    with the leading dims `lead` (`sweep_run`'s variants): the selections
    and status, and with `record` the trace (TRACE_SLOTS_PLAIN, or
    TRACE_SLOTS_PREEMPT with a victim buffer of `victim_cap`)."""
    F, S, dt = len(prog.filters), len(prog.scores), prog.score_dtype
    pre = prog.preempt is not None
    i32 = dict(dtype=torch.int32, device=dev)

    def new(shape, zero=False, **kw):
        return (torch.zeros if zero else torch.empty)((*lead, *shape), **(kw or i32))

    out = {"sel": new((Q,)), "status": new((2,), zero=True)}
    if pre:
        out["final_sel"] = new((Q,))
    if record:
        out.update(pf_codes=new((Q, len(prog.prefilters)), zero=True), codes=new((Q, N, F)),
                   raw=new((Q, N, S), dtype=dt, device=dev),
                   fin=new((Q, N, S), dtype=dt, device=dev))
        if pre:
            out.update(
                did=new((Q,), dtype=torch.bool, device=dev), pcode=new((Q, N)),
                nominated=new((Q,)), sel2=new((Q,)), pcode2=new((Q, N)), nominated2=new((Q,)),
                # the kernel writes the retry rows of the steps that fired only
                codes2=new((Q, N, F), zero=True),
                raw2=new((Q, N, S), zero=True, dtype=dt, device=dev),
                fin2=new((Q, N, S), zero=True, dtype=dt, device=dev),
                voff=new((Q, 2, N + 1)), vidx=new((victim_cap,)),
            )
    return out


def _trace_struct(out: dict, victim_cap: int) -> ctypes.Structure:
    """The kernels' Trace struct over a launch's outputs (`_run_outputs`)."""
    names = _LAYOUT.names
    return _LAYOUT.Trace(*(out[x].data_ptr() if x in out else None
                           for x in names["trace_ptrs"]),
                         *({"victim_cap": victim_cap}[x] for x in names["trace_dims"]))


def _run_result(out: dict, pre: bool, record: bool, victims):
    """A run launch's result from its outputs: the selections (the bound
    ones, `final_sel`, with preemption), or with `record` the trace slots,
    the victim list from `victims()`."""
    if not record:
        return out["final_sel" if pre else "sel"]
    trace = (out["pf_codes"], out["codes"], out["raw"], out["fin"], out["sel"])
    if not pre:
        return trace
    return trace + (out["did"], out["pcode"], out["nominated"], out["sel2"], out["pcode2"],
                    out["nominated2"], out["final_sel"], out["codes2"], out["raw2"],
                    out["fin2"], out["voff"], victims())


# ---------------------------------------------------------------------------
# K9: the gang engine's round kernels (csrc/gang_kernels.cu), each beside its
# plain version. Rows [0, live) of a row list are processed; `live` is an
# int32 tensor on the rows' device (read there, so a round's pending count
# never crosses to the host), or None for every row. Each kernel takes one
# variant (a state, weights [S], rows [K], live [1]) or a stack of V (states
# stacked [V, ...], weights [V, S], rows [V, K], live [V]: the gang sweep's
# round, one launch for every variant); the single form is the stacked one
# at V = 1.
# ---------------------------------------------------------------------------

NO_ORDER = int(np.iinfo(np.int32).max)  # the queue position of a pod not queued


def _n_live(live, K: int) -> int:
    return K if live is None else max(0, min(int(live.reshape(-1)[0]), K))


def _neg(dtype: torch.dtype) -> int:
    return torch.iinfo(dtype).min // 2


def as_variants(s: SchedState) -> SchedState:
    """A single state as a stack of one variant (views of its tensors)."""
    return SchedState(**{f: getattr(s, f).unsqueeze(0) for f in _STATE_FIELDS})


def _one(live):
    """A single variant's live count as the stacked form's [1]."""
    return None if live is None else live.reshape(1)


def _live_of(live, v: int):
    """Variant v's live count (a one-element view), or None."""
    return None if live is None else live[v:v + 1]


def _check_rows(rows, live, dev, V: int = 1) -> None:
    """`rows` (None: not taken; [V, K]) and `live` ([V]) as the stacked
    K9 kernels read them."""
    if rows is not None and (rows.device != dev or rows.dtype != torch.int32
                             or rows.dim() != 2 or rows.shape[0] != V):
        raise ValueError(f"rows must be an int32 [{V}, K] tensor on the planes' device")
    if live is not None and (live.device != dev or live.dtype != torch.int32
                             or tuple(live.shape) != (V,)):
        raise ValueError(f"live must be an int32 ({V},) tensor on the planes' device")


def _ptr(t) -> "int | None":
    return None if t is None else t.data_ptr()


def _check_order(order, planes, dev) -> None:
    if order.device != dev or order.dtype != torch.int32 or tuple(order.shape) != (planes.P,):
        raise ValueError(f"order must be an int32 ({planes.P},) tensor on the planes' device")


def _launch_state(prog: SeqProgram, a: ClusterArrays, s: SchedState, weights, V: int,
                  single: bool = False):
    """What a K9 launch reads: (Planes, State, StateStride, type suffix),
    the weights (None, or [V, S] in the score type) checked. `single`: `s`
    is one state (V = 1), checked and packed as the sequential kernels'
    (`_state`, cached by its tensors), with zero strides."""
    dev, dt = a.node_mask.device, prog.score_dtype
    if dev.type not in KERNEL_DEVICE_TYPES:
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {dev}")
    b = _planes(prog, a)
    if single:
        state, ss = _state(b, s, dev, dt), _LAYOUT.StateStride()
    else:
        state, ss = _stacked(b, s, V, dev, dt)
    S = len(prog.scores)
    if weights is not None and (weights.device != dev or weights.dtype != dt
                                or tuple(weights.shape) != (V, S) or not weights.is_contiguous()):
        raise ValueError(f"weights: want contiguous {dt} ({V}, {S}) on {dev}")
    return b.planes, state, ss, b.suffix


def _gang_eval_one(prog, a, s, weights, rows, live, order, check_pending, slot, trace):
    K, N = rows.shape[0], a.node_mask.shape[0]
    dt = prog.score_dtype
    neg = _neg(dt)
    scores = None if slot is not None else torch.full((K, N), neg, dtype=dt,
                                                      device=a.node_mask.device)
    for i, p in enumerate(rows[:_n_live(live, K)].tolist()):
        if p < 0 or (check_pending and not (int(s.assignment[p]) < 0 and int(order[p]) != NO_ORDER
                                            and bool(a.pod_mask[p]))):
            continue
        codes, raw, final, _, pf = seq_attempt_plain(prog, a, s, weights, p)
        if slot is not None:
            q = int(slot[i])
            for dst, src in zip(trace, (pf, codes, raw, final)):
                dst[q] = src
            continue
        feasible = (codes == 0).all(dim=1) & a.node_mask & (pf == 0).all()
        total = final.sum(dim=1, dtype=dt)
        scores[i] = torch.where(feasible, total, torch.full_like(total, neg))
    return scores


def gang_eval_plain(prog: SeqProgram, a: ClusterArrays, s: SchedState, weights, rows, live,
                    order, *, check_pending: bool = True, slot=None, trace=None):
    """The gang round's evaluation (gang.py pod_score_row over a row list):
    for rows i < live, the masked totals of pod rows[i] against s — the
    weighted score sum where the node is feasible, NEG (the score type's
    minimum // 2) where not, and NEG everywhere for a pod that is -1 or,
    with `check_pending`, not pending (bound, not queued — order NO_ORDER —
    or padding). Returns scores [K, N] (rows from live on: NEG). With
    `slot` ([K] trace rows) and `trace` ((pf [Q, n_pf], codes [Q, N, F],
    raw [Q, N, S], final [Q, N, S]), written in place) it records each
    evaluated pod's rows instead and returns None. The stacked form (rows
    [V, K]) evaluates each variant at its own state and weights row and
    returns [V, K, N]; its trace form takes V = 1."""
    if rows.dim() == 1:
        return _gang_eval_one(prog, a, s, weights, rows, live, order, check_pending, slot, trace)
    if slot is not None and rows.shape[0] != 1:
        raise ValueError("trace rows are written for one variant")
    outs = [_gang_eval_one(prog, a, variant_state(s, v), weights[v], rows[v], _live_of(live, v),
                           order, check_pending, None if slot is None else slot[v], trace)
            for v in range(rows.shape[0])]
    return None if slot is not None else torch.stack(outs)


def gang_eval(prog: SeqProgram, a: ClusterArrays, s: SchedState, weights, rows, live, order,
              *, check_pending: bool = True, slot=None, trace=None):
    """K9 eval, as `gang_eval_plain` (rows from live on are left unwritten).
    A grid of blocks strides over the (row, variant) pairs, each block with
    its own workspace slice."""
    if _on_cpu(a):
        PLAIN_CALLS["gang_eval"] += 1
        return gang_eval_plain(prog, a, s, weights, rows, live, order,
                               check_pending=check_pending, slot=slot, trace=trace)
    single = rows.dim() == 1
    if single:
        weights, rows, live = weights[None], rows[None], _one(live)
        slot = None if slot is None else slot[None]
    V = rows.shape[0]
    planes, state, ss, t = _launch_state(prog, a, s, weights, V, single)
    dev, N, K = a.node_mask.device, planes.N, rows.shape[1]
    _check_rows(rows, live, dev, V)
    _check_order(order, planes, dev)
    F, S, dt = len(prog.filters), len(prog.scores), prog.score_dtype
    scores = tr = None
    if slot is None:
        scores = torch.empty((V, K, N), dtype=dt, device=dev)
    else:
        if V != 1:
            raise ValueError("trace rows are written for one variant")
        tr = tuple(trace)
        want = ((torch.int32, (len(prog.prefilters),)), (torch.int32, (N, F)), (dt, (N, S)),
                (dt, (N, S)))
        Q = tr[0].shape[0]
        for x, (xdt, shape) in zip(tr, want):
            if (x.device != dev or x.dtype != xdt or tuple(x.shape) != (Q, *shape)
                    or not x.is_contiguous()):
                raise ValueError(f"trace rows: want contiguous {xdt} ({Q}, {shape}) on {dev}")
        if slot.device != dev or slot.dtype != torch.int32 or tuple(slot.shape) != (1, K):
            raise ValueError(f"slot must be an int32 ({K},) tensor on the planes' device")
        slot = slot.contiguous()
    lib = library()
    grid = int(getattr(lib, f"gang_eval_grid_{t}")(N, int(V > 1)))
    if grid < 1:
        raise RuntimeError("gang_eval: the occupancy query failed")
    ws_bytes = int(lib.seq_workspace_bytes(ctypes.addressof(planes), 4 if t == "i32" else 8, 0))
    ws_bytes = max(8, ws_bytes)
    feas = torch.empty((grid, N), dtype=torch.uint8, device=dev)
    codes_s = torch.empty((grid, N * F), dtype=torch.int32, device=dev)
    raw_s = torch.empty((grid, N * S), dtype=dt, device=dev)
    ws = _workspace(grid * ws_bytes, dev)
    cfg = np.ascontiguousarray(prog.cfg)
    rc = getattr(lib, f"gang_eval_{t}")(
        cfg.ctypes.data, ctypes.addressof(planes), ctypes.addressof(state),
        ctypes.addressof(ss), weights.data_ptr(), V, rows.contiguous().data_ptr(), K,
        _ptr(live), order.contiguous().data_ptr(), int(check_pending), _ptr(scores),
        _ptr(slot), *(_ptr(x) for x in (tr if tr is not None else (None,) * 4)),
        grid, feas.data_ptr(), codes_s.data_ptr(), raw_s.data_ptr(), ws.data_ptr(), ws_bytes,
        _stream(),
    )
    _raise_on(rc, "gang_eval")
    LAUNCHES["gang_eval"] += 1
    if scores is None:
        return None
    return scores[0] if single else scores


def gang_eval_scratch_bytes(prog: SeqProgram, a: ClusterArrays) -> tuple[int, int, int]:
    """(blocks, workspace bytes a block, scratch bytes a launch allocates)
    of a one-variant launch: per block one workspace slice and the
    feasibility, codes and raw-score rows."""
    b = _planes(prog, a)
    lib = library()
    grid = int(getattr(lib, f"gang_eval_grid_{b.suffix}")(b.planes.N, 0))
    isz = 4 if b.suffix == "i32" else 8
    ws = max(8, int(lib.seq_workspace_bytes(ctypes.addressof(b.planes), isz, 0)))
    N, F, S = b.planes.N, len(prog.filters), len(prog.scores)
    return grid, ws, grid * (ws + N + 4 * N * F + isz * N * S)


def _gang_topk_one(scores, live, mw):
    K = scores.shape[0]
    n = _n_live(live, K)
    vals = torch.full((K, mw), _neg(scores.dtype), dtype=scores.dtype, device=scores.device)
    idx = torch.zeros((K, mw), dtype=torch.int32, device=scores.device)
    if n:
        v, i = torch.sort(scores[:n], dim=1, descending=True, stable=True)
        vals[:n], idx[:n] = v[:, :mw], i[:, :mw].to(torch.int32)
    return vals, idx


def gang_topk_plain(scores, live, mw: int):
    """`lax.top_k(scores, mw)` over rows [0, live): (vals [K, mw], idx [K,
    mw] int32), each row's values descending, ties to the lower index.
    Rows from live on are NEG and 0. Stacked scores [V, K, N] give [V, K,
    mw], variant v's rows cut at live[v]."""
    if scores.dim() == 2:
        return _gang_topk_one(scores, live, mw)
    outs = [_gang_topk_one(scores[v], _live_of(live, v), mw) for v in range(scores.shape[0])]
    return torch.stack([x for x, _ in outs]), torch.stack([x for _, x in outs])


def gang_topk(scores, live, mw: int):
    """K9 top-k, as `gang_topk_plain` (rows from live on are left
    unwritten). Launched only where mw < N."""
    if _on_cpu(scores):
        PLAIN_CALLS["gang_topk"] += 1
        return gang_topk_plain(scores, live, mw)
    dev = scores.device
    if dev.type not in KERNEL_DEVICE_TYPES:
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {dev}")
    if scores.dtype not in (torch.int32, torch.int64) or scores.dim() not in (2, 3):
        raise ValueError("scores must be an int32 or int64 [K, N] or [V, K, N] tensor")
    single = scores.dim() == 2
    sc, live = (scores[None], _one(live)) if single else (scores, live)
    V, K, N = sc.shape
    if not 1 <= mw <= N:
        raise ValueError(f"match width {mw} outside [1, {N}]")
    _check_rows(None, live, dev, V)
    vals = torch.empty((V, K, mw), dtype=scores.dtype, device=dev)
    idx = torch.empty((V, K, mw), dtype=torch.int32, device=dev)
    t = "i32" if scores.dtype == torch.int32 else "i64"
    rc = getattr(library(), f"gang_topk_{t}")(sc.contiguous().data_ptr(), N, V, K, _ptr(live),
                                              mw, vals.data_ptr(), idx.data_ptr(), _stream())
    _raise_on(rc, "gang_topk")
    LAUNCHES["gang_topk"] += 1
    return (vals[0], idx[0]) if single else (vals, idx)


def _gang_match_one(vals, idx, rows, live, order, claims, carrier, n_nodes, n_claims, iters):
    K = rows.shape[0]
    n = _n_live(live, K)
    dev = vals.device
    sel = torch.full((K,), -1, dtype=torch.int32, device=dev)
    if n == 0:
        return sel, torch.tensor([0, 0], dtype=torch.int32, device=dev)
    neg = _neg(vals.dtype)
    v = vals[:n]
    ix = None if idx is None else idx[:n].long()
    pods = rows[:n].long()
    o = order[pods]
    cl = claims[pods].long()
    pc = torch.zeros((n, n_claims + 1), dtype=torch.bool, device=dev)
    pc.scatter_(1, torch.where(cl >= 0, cl, n_claims), True)
    pc = pc[:, :n_claims]
    car = None if carrier is None else carrier[pods].bool()
    no = torch.tensor(NO_ORDER, dtype=torch.int32, device=dev)
    c_min = no
    if car is not None:
        row_ok = v.max(dim=1).values > neg
        c_min = torch.where(car & row_ok, o, no).min()
        prefix = (row_ok & (o < c_min)).any()
        if not bool(prefix) and int(c_min) != NO_ORDER:
            is_pick = car & row_ok & (o == c_min)
            col = torch.argmax(v, dim=1)
            cand = col if ix is None else ix.gather(1, col[:, None])[:, 0]
            sel[:n] = torch.where(is_pick, cand.to(torch.int32), -1)
            return sel, torch.tensor([int(is_pick.sum()), n], dtype=torch.int32, device=dev)
    taken = torch.zeros((n_nodes,), dtype=torch.bool, device=dev)
    claim_taken = torch.zeros((n_claims,), dtype=torch.bool, device=dev)
    sel_acc = torch.full((n,), -1, dtype=torch.int32, device=dev)
    for _ in range(iters):
        node_taken = taken[ix] if ix is not None else taken[None, :].expand(n, -1)
        m = torch.where(node_taken, neg, v)
        m = torch.where((sel_acc >= 0)[:, None], neg, m)
        blocked = (pc & claim_taken[None, :]).any(dim=1)
        m = torch.where(blocked[:, None], neg, m)
        if car is not None:
            m = torch.where((o >= c_min)[:, None], neg, m)
        col = torch.argmax(m, dim=1)  # the first column among ties
        has = m.gather(1, col[:, None])[:, 0] > neg
        cand = col if ix is None else ix.gather(1, col[:, None])[:, 0]
        tgt = torch.where(has, cand, n_nodes)
        winner = torch.full((n_nodes + 1,), NO_ORDER, dtype=torch.int32, device=dev)
        winner.scatter_reduce_(0, tgt, o, reduce="amin")
        commit = has & (winner[cand.clamp(min=0)] == o)
        claim_order = torch.where(commit[:, None] & pc, o[:, None], no)
        claim_min = (claim_order.min(dim=0).values if n_claims
                     else torch.zeros((0,), dtype=torch.int32, device=dev))
        claim_ok = torch.where(pc, claim_min[None, :] == o[:, None], True).all(dim=1)
        commit = commit & claim_ok
        sel_acc = torch.where(commit, cand.to(torch.int32), sel_acc)
        taken[cand[commit]] = True
        claim_taken |= (pc & commit[:, None]).any(dim=0)
        if not bool(commit.any()):
            break
    sel[:n] = sel_acc
    return sel, torch.tensor([int((sel_acc >= 0).sum()), n], dtype=torch.int32, device=dev)


def gang_match_plain(vals, idx, rows, live, order, claims, carrier, n_nodes: int,
                     n_claims: int, iters: int):
    """One round's matching (gang.py make_match_step/match) over rows
    [0, live): `vals` [K, W] candidate scores, `idx` [K, W] their nodes
    (None: column j is node j), `rows` the rows' pods, `order` [P] queue
    positions, `claims` [P, MC] each pod's ReadWriteOncePod claims (-1
    padded), `carrier` [P] bool (None without rel_serialize). Returns (sel
    [K] int32, the committed node or -1; stat [2] int32: rows committed,
    live). The stacked form (vals [V, K, W], rows [V, K], live [V]) matches
    each variant alone: sel [V, K], stat [V, 2]."""
    if rows.dim() == 1:
        return _gang_match_one(vals, idx, rows, live, order, claims, carrier, n_nodes,
                               n_claims, iters)
    outs = [_gang_match_one(vals[v], None if idx is None else idx[v], rows[v],
                            _live_of(live, v), order, claims, carrier, n_nodes, n_claims, iters)
            for v in range(rows.shape[0])]
    return torch.stack([x for x, _ in outs]), torch.stack([x for _, x in outs])


def gang_match(vals, idx, rows, live, order, claims, carrier, n_nodes: int, n_claims: int,
               iters: int):
    """K9 match, as `gang_match_plain`: one block a variant runs the round's
    whole matching loop."""
    if _on_cpu(vals):
        PLAIN_CALLS["gang_match"] += 1
        return gang_match_plain(vals, idx, rows, live, order, claims, carrier, n_nodes,
                                n_claims, iters)
    dev = vals.device
    if dev.type not in KERNEL_DEVICE_TYPES:
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {dev}")
    single = rows.dim() == 1
    if single:
        vals, rows, live = vals[None], rows[None], _one(live)
        idx = None if idx is None else idx[None]
    V = rows.shape[0]
    _check_rows(rows, live, dev, V)
    K = rows.shape[1]
    if (vals.dim() != 3 or tuple(vals.shape[:2]) != (V, K)
            or vals.dtype not in (torch.int32, torch.int64)):
        raise ValueError("vals must be int32 or int64 [V, K, W] with rows [V, K]")
    W = vals.shape[2]
    if idx is not None and (idx.dtype != torch.int32 or tuple(idx.shape) != (V, K, W)):
        raise ValueError("idx must be int32 like vals")
    if idx is None and W != n_nodes:
        raise ValueError("full-width vals need one column a node")
    for name, x, xdt in (("order", order, torch.int32), ("claims", claims, torch.int32),
                         ("carrier", carrier, torch.bool)):
        if x is not None and (x.device != dev or x.dtype != xdt):
            raise ValueError(f"{name} must be {xdt} on {dev}")
    i32 = dict(dtype=torch.int32, device=dev)
    sel, cand = torch.empty((V, K), **i32), torch.empty((V, K), **i32)
    taken, winner = torch.empty((V, n_nodes), **i32), torch.empty((V, n_nodes + 1), **i32)
    cmin, ctaken = torch.empty((V, n_claims), **i32), torch.empty((V, n_claims), **i32)
    stat = torch.empty((V, 2), **i32)
    claims = claims.contiguous()
    t = "i32" if vals.dtype == torch.int32 else "i64"
    rc = getattr(library(), f"gang_match_{t}")(
        vals.contiguous().data_ptr(), _ptr(None if idx is None else idx.contiguous()), W, V, K,
        _ptr(live), rows.contiguous().data_ptr(), order.contiguous().data_ptr(),
        claims.data_ptr(), claims.shape[1], _ptr(None if carrier is None else carrier.contiguous()),
        n_nodes, n_claims, iters, sel.data_ptr(), cand.data_ptr(), taken.data_ptr(),
        winner.data_ptr(), cmin.data_ptr(), ctaken.data_ptr(), stat.data_ptr(), _stream(),
    )
    _raise_on(rc, "gang_match")
    LAUNCHES["gang_match"] += 1
    return (sel[0], stat[0]) if single else (sel, stat)


def _gang_bind_one(a, s, rows, live, sel, order):
    n = _n_live(live, rows.shape[0])
    keep = sel[:n] >= 0
    p = rows[:n][keep].long()
    tgt = sel[:n][keep].long()
    s.requested.index_add_(0, tgt, a.pod_req[p])
    s.s_requested.index_add_(0, tgt, a.pod_sreq[p])
    s.n_pods.index_add_(0, tgt, torch.ones_like(tgt, dtype=torch.int32))
    s.used_pair.index_add_(0, tgt, a.want_pair[p])
    s.used_wild.index_add_(0, tgt, a.want_wild[p])
    s.used_trip.index_add_(0, tgt, a.want_trip[p])
    s.used_claims += a.pod_claim[p].to(torch.int32).sum(dim=0, dtype=torch.int32)
    s.node_disk_any.index_add_(0, tgt, a.pod_disk_any[p])
    s.node_disk_rw.index_add_(0, tgt, a.pod_disk_rw[p])
    s.node_vol3.index_add_(0, tgt, a.pod_vol3[p])
    s.assignment[p] = tgt.to(torch.int32)
    s.bound_seq[p] = order[p] + a.pod_mask.shape[0]
    return s


def gang_bind_plain(prog: SeqProgram, a: ClusterArrays, s: SchedState, rows, live, sel, order):
    """bind_all over rows [0, live): each row with sel >= 0 binds pod
    rows[i] to node sel[i] at bind order P + order[pod], in place; other
    rows are no-ops. The stacked form (states [V, ...], rows and sel [V,
    K], live [V]) binds each variant's rows into its own state. Returns
    `s`."""
    if rows.dim() == 1:
        return _gang_bind_one(a, s, rows, live, sel, order)
    for v in range(rows.shape[0]):
        _gang_bind_one(a, variant_state(s, v), rows[v], _live_of(live, v), sel[v], order)
    return s


def gang_bind(prog: SeqProgram, a: ClusterArrays, s: SchedState, rows, live, sel, order):
    """K9 bind, as `gang_bind_plain`, in place. Returns `s`."""
    if _on_cpu(a):
        PLAIN_CALLS["gang_bind"] += 1
        return gang_bind_plain(prog, a, s, rows, live, sel, order)
    single = rows.dim() == 1
    if single:
        rows, sel, live = rows[None], sel[None], _one(live)
    V = rows.shape[0]
    planes, state, ss, t = _launch_state(prog, a, s, None, V, single)
    dev, K = a.node_mask.device, rows.shape[1]
    _check_rows(rows, live, dev, V)
    if sel.device != dev or sel.dtype != torch.int32 or tuple(sel.shape) != (V, K):
        raise ValueError(f"sel must be an int32 ({V}, {K}) tensor on the planes' device")
    _check_order(order, planes, dev)
    rc = getattr(library(), f"gang_bind_{t}")(
        ctypes.addressof(planes), ctypes.addressof(state), ctypes.addressof(ss), V,
        rows.contiguous().data_ptr(), K, _ptr(live), sel.contiguous().data_ptr(),
        order.contiguous().data_ptr(), _stream(),
    )
    _raise_on(rc, "gang_bind")
    LAUNCHES["gang_bind"] += 1
    return s


# ---------------------------------------------------------------------------
# K11: the weight sweep (parallel/sweep.py drives it). States stack V variants
# on a leading axis of every SchedState field; the cluster planes and the
# queue are shared.
# ---------------------------------------------------------------------------


def variant_state(states: SchedState, v: int) -> SchedState:
    """Variant v of a stacked state (views)."""
    return SchedState(**{f: getattr(states, f)[v] for f in _STATE_FIELDS})


def variant_slice(states: SchedState, lo: int, hi: int) -> SchedState:
    """Variants [lo, hi) of a stacked state (views, each field contiguous)."""
    return SchedState(**{f: getattr(states, f)[lo:hi] for f in _STATE_FIELDS})


def stack_states(states: "list[SchedState]") -> SchedState:
    """Single states stacked on a new leading variant axis."""
    return SchedState(**{f: torch.stack([getattr(s, f) for s in states])
                         for f in _STATE_FIELDS})


def _stack_traces(traces: list, preempts: bool) -> tuple:
    """Per-variant traces stacked slot by slot; each variant's victim list
    (the last slot with preemption) padded with -1 to the longest."""
    slots = list(zip(*traces))
    if not preempts:
        return tuple(torch.stack(x) for x in slots)
    vidx = slots[-1]
    m = max(len(x) for x in vidx)
    padded = [torch.cat([x, x.new_full((m - len(x),), -1)]) for x in vidx]
    return tuple(torch.stack(x) for x in slots[:-1]) + (torch.stack(padded),)


def sweep_run_plain(prog: SeqProgram, a: ClusterArrays, states0: SchedState, queue, weights,
                    *, record: bool, qpos=None):
    """The pass of each weight variant: `seq_run_plain` (step0 = 0) on
    variant v's state and weights row, for every v. Returns (final states
    [V, ...], and the selections [V, Q] (`final_sel` with preemption) or,
    with `record`, the trace with every slot stacked [V, ...]: each
    variant's victim offsets index its own victim row, padded with -1).
    A [V, K] `queue` gives each variant its own segment (-1 padded; the
    gang sweep's preempt phase), with `qpos` [V, K] its pods' queue
    positions (None: step i's); that form records no trace."""
    per_variant = queue.dim() == 2
    if per_variant:
        _check_segment_form(prog, record)
    if qpos is not None and not per_variant:
        raise ValueError("queue positions go with per-variant segments")
    outs = [seq_run_plain(prog, a, variant_state(states0, v), queue[v] if per_variant else queue,
                          weights[v], record=record,
                          qpos=None if qpos is None else qpos[v])
            for v in range(weights.shape[0])]
    states = stack_states([s for s, _ in outs])
    if not record:
        return states, torch.stack([x for _, x in outs])
    return states, _stack_traces([t for _, t in outs], prog.preempt is not None)


def _check_segment_form(prog: SeqProgram, record: bool) -> None:
    if record or prog.preempt is None:
        raise ValueError("per-variant segments are a preempt phase's: DefaultPreemption, "
                         "no trace")


def _checked_segments(segs, qpos, V: int, planes, dev) -> tuple:
    """Per-variant segments [V, K] (int32 pod indices, -1 = padding) and
    their queue positions ([V, K] int32, or None) as `sweep_seg` reads them."""
    if (segs.device != dev or segs.dtype != torch.int32 or segs.dim() != 2
            or segs.shape[0] != V):
        raise ValueError(f"segments must be an int32 [{V}, K] tensor on the planes' device")
    segs = segs.contiguous()
    if segs.numel() and (int(segs.max()) >= planes.P or int(segs.min()) < -1):
        raise ValueError(f"segments hold pod indices outside [-1, {planes.P})")
    if qpos is not None:
        if qpos.device != dev or qpos.dtype != torch.int32 or qpos.shape != segs.shape:
            raise ValueError(f"qpos must be an int32 {tuple(segs.shape)} tensor on the "
                             "planes' device")
        qpos = qpos.contiguous()
    return segs, qpos


def sweep_run(prog: SeqProgram, a: ClusterArrays, states0: SchedState, queue, weights,
              *, record: bool, grid: "int | None" = None, qpos=None):
    """K11: the pass of V weight variants in one launch, as
    `sweep_run_plain`. `weights` [V, S] in the program's score type;
    `states0` stacked [V, ...], each field contiguous (left as it was);
    `queue` [Q] int32, shared, or [V, K] per variant with `qpos` (the gang
    sweep's preempt phase, `gangsweep.vphase`: the `sweep_seg` kernel, whose
    padding steps are skipped; no trace). `grid`: at most this many blocks
    (default: as many as are resident at once on the card). Each variant's
    victim record holds at most min(2 Q P, VICTIM_CAP // V) entries; a
    variant that needs more raises."""
    if _on_cpu(a):
        PLAIN_CALLS["sweep_run"] += 1
        return sweep_run_plain(prog, a, states0, queue, weights, record=record, qpos=qpos)
    dev, dt = a.node_mask.device, prog.score_dtype
    if dev.type not in KERNEL_DEVICE_TYPES:
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {dev}")
    b = _planes(prog, a)
    planes, t = b.planes, b.suffix
    F, S, N = len(prog.filters), len(prog.scores), planes.N
    if (weights.device != dev or weights.dtype != dt or weights.dim() != 2
            or weights.shape[1] != S or weights.shape[0] < 1 or not weights.is_contiguous()):
        raise ValueError(f"weights: want contiguous {dt} (V >= 1, {S}) on {dev}")
    V = weights.shape[0]
    dims = dict(b.dims)
    for name in _STATE_FIELDS:
        x = getattr(states0, name)
        if x.dim() < 1 or x.shape[0] != V or not x.is_contiguous():
            raise ValueError(f"{name}: want a contiguous stack of {V} variants")
        _check_tensor(name, x[0], dims, dev, dt)
    per_variant = queue.dim() == 2
    if per_variant:
        _check_segment_form(prog, record)
        queue, qpos = _checked_segments(queue, qpos, V, planes, dev)
    elif qpos is not None:
        raise ValueError("queue positions go with per-variant segments")
    else:
        queue = _checked_queue(queue, planes, dev)
    Q = queue.shape[-1]
    s = states0.clone()
    pre = prog.preempt is not None
    i32 = dict(dtype=torch.int32, device=dev)
    victim_cap = min(2 * Q * planes.P, VICTIM_CAP // V) if record and pre else 0
    out = _run_outputs(prog, (V,), Q, N, record, victim_cap, dev)
    if Q:
        lib = library()
        most = int(getattr(lib, f"sweep_seg_grid_{t}")(N) if per_variant
                   else getattr(lib, f"sweep_run_grid_{t}")(N, int(pre)))
        if most < 1:
            raise RuntimeError("sweep_run: the occupancy query failed")
        blocks = min(V, most if grid is None else max(1, min(int(grid), most)))
        names = _LAYOUT.names
        state = _LAYOUT.State(*(getattr(s, x).data_ptr() for x in names["state_ptrs"]))
        ss = _LAYOUT.StateStride(*(_vstride(getattr(s, x)) for x in names["state_ptrs"]))
        tr = _trace_struct(out, victim_cap)
        ts = _LAYOUT.TraceStride(*(_vstride(out[x]) if x in out else 0
                                   for x in names["trace_ptrs"]))
        feas = torch.empty((blocks, N), dtype=torch.uint8, device=dev)
        codes_s = torch.empty((blocks, N * F), **i32)
        raw_s = torch.empty((blocks, N * S), dtype=dt, device=dev)
        ws = _workspace(blocks * b.ws_bytes, dev)
        cfg = np.ascontiguousarray(prog.cfg)
        scratch = (ctypes.addressof(tr), ctypes.addressof(ts), blocks, feas.data_ptr(),
                   codes_s.data_ptr(), raw_s.data_ptr(), ws.data_ptr(), b.ws_bytes, _stream())
        head = (cfg.ctypes.data, ctypes.addressof(planes), ctypes.addressof(state),
                ctypes.addressof(ss), weights.data_ptr(), V)
        if per_variant:
            rc = getattr(lib, f"sweep_seg_{t}")(*head, queue.data_ptr(), _ptr(qpos), Q,
                                                *scratch)
        else:
            rc = getattr(lib, f"sweep_run_{t}")(*head, queue.data_ptr(), Q, *scratch)
        _raise_on(rc, "sweep_run")
        LAUNCHES["sweep_run"] += 1
    if pre:
        status = out["status"].cpu()
        bits = 0
        for x in status[:, 1].tolist():
            bits |= x
        _raise_overflow(bits, "sweep_run")

    def victims():
        """Each variant's victim row, cut to the longest and padded with -1."""
        m = int(status[:, 0].max())
        vidx = out["vidx"][:, :m].clone()
        vidx[torch.arange(m, device=dev)[None, :] >= status[:, :1].to(dev)] = -1
        return vidx

    return s, _run_result(out, pre, record, victims)
