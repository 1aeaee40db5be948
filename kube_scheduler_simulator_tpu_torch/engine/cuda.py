"""The sequential pass's kernels: build, load and launch, beside their plain
PyTorch versions.

Three hand-written CUDA kernels (`csrc/seq_kernels.cu`) carry the pass on
the card, each replacing one device program of the reference package's
`engine/engine.py`:

  * `seq_attempt` — K1, `_build_run.attempt` (`seq.attempt`): one pod's
    filters, scores, normalize, weights and masked argmax over all nodes;
  * `seq_bind` — K2, `_build_run.bind` (`seq.bind`): the pod's scatter
    into per-node state;
  * `seq_run` — K3, `_build_run.step`/`run` (`seq.run`): the whole
    bucket-padded queue in one persistent launch.

Each wrapper takes its plain version (`*_plain`, a line-by-line PyTorch
rendering of the reference's closure) only for tensors that lie on the CPU;
for CUDA tensors it launches the kernel or raises. The kernels are built
with `nvcc` for sm_90a into `build/kernels/` at first use and bound through
a plain C interface with ctypes. Module state is the library handle and the
per-wrapper counters `LAUNCHES` (kernel launches) and `PLAIN_CALLS`.

`seq_bind` (both versions) updates the state it is given in place, where
the reference returns a new state; `seq_run` clones its initial state first.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from ..sched.config import MAX_NODE_SCORE
from . import kernels as K
from .encode import ClusterArrays, EncodedCluster, SchedState

CSRC = Path(__file__).resolve().parent.parent / "csrc" / "seq_kernels.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

KERNELS = ("seq_attempt", "seq_bind", "seq_run")
LAUNCHES = dict.fromkeys(KERNELS, 0)
PLAIN_CALLS = dict.fromkeys(KERNELS, 0)
_LIB = None

# Capacities of the kernel's config block (csrc/seq_kernels.cu `Cfg`).
MAX_F, MAX_S, MAX_SPEC, MAX_PTS, MAX_BAL = 8, 8, 16, 16, 16
_CFG_FIELDS = (
    ("n_filters", 1), ("filter", MAX_F),
    ("n_scores", 1), ("score", MAX_S), ("mode", MAX_S),
    ("fit_type", 1), ("fit_wsum", 1), ("fit_n", 1),
    ("fit_r", MAX_SPEC), ("fit_w", MAX_SPEC),
    ("rtcr_n", 1), ("rtcr_x", MAX_PTS), ("rtcr_y", MAX_PTS),
    ("bal_n", 1), ("bal_r", MAX_BAL),
)
CFG_INTS = sum(n for _, n in _CFG_FIELDS)
_NORM_IDS = {None: 0, "default": 1, "default_reverse": 2}


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
    """The enabled filter and score plugins of one engine: the plain bodies
    the CPU version calls, and the packed config block the kernels read."""

    filter_names: tuple[str, ...]
    score_names: tuple[str, ...]
    filters: tuple[Callable, ...]
    scores: tuple[Callable, ...]
    normalize: tuple["str | None", ...]
    cfg: np.ndarray  # int32 [CFG_INTS]
    score_dtype: torch.dtype


def pack_config(enc: EncodedCluster, filter_names, score_names) -> np.ndarray:
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
    out: list[int] = []
    for name, n in _CFG_FIELDS:
        xs = vals[name]
        out += xs + [0] * (n - len(xs))
    lim = np.iinfo(np.int32)
    if any(not lim.min <= x <= lim.max for x in out):
        raise ValueError("kernel config values must fit int32")
    return np.asarray(out, np.int32)


def build_program(enc: EncodedCluster, filter_names, score_names) -> SeqProgram:
    return SeqProgram(
        filter_names=tuple(filter_names),
        score_names=tuple(score_names),
        filters=tuple(K.FILTER_KERNELS[n][0](enc) for n in filter_names),
        scores=tuple(K.SCORE_KERNELS[n][0](enc) for n in score_names),
        normalize=tuple(K.SCORE_KERNELS[n][1] for n in score_names),
        cfg=pack_config(enc, filter_names, score_names),
        score_dtype=enc.policy.score,
    )


# ---------------------------------------------------------------------------
# plain PyTorch versions (engine.py attempt / bind / step+run, line by line)
# ---------------------------------------------------------------------------


def seq_attempt_plain(prog: SeqProgram, a: ClusterArrays, s: SchedState, weights, p: int):
    """One full Filter→Score→Normalize→select pass for pod p. Returns
    (codes [N,F] int32, raw [N,S], final [N,S], sel [] int32)."""
    N = a.node_mask.shape[0]
    dev = a.node_mask.device
    score_dt = prog.score_dtype
    if prog.filters:
        codes = torch.stack([k(a, s, p) for k in prog.filters], dim=1)  # [N,F]
    else:
        codes = torch.zeros((N, 0), dtype=torch.int32, device=dev)
    feasible = (codes == 0).all(dim=1) & a.node_mask
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
    return codes, raw, final, sel


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
    s.n_pods.index_add_(0, tgt, valid.to(torch.int32).reshape(1))
    s.assignment[p] = sel
    s.bound_seq[p] = torch.where(valid, sel.new_tensor(P + qi), sel.new_tensor(-1))
    return s


def _trace(rows, record, N, F, S, score_dt, dev):
    """Stack per-step outputs into the TRACE_SLOTS_PLAIN layout."""
    Q = len(rows)
    if not record:
        return torch.stack(rows) if Q else torch.zeros((0,), dtype=torch.int32, device=dev)
    if Q:
        codes, raw, final, sel = (torch.stack(x) for x in zip(*rows))
    else:
        codes = torch.zeros((0, N, F), dtype=torch.int32, device=dev)
        raw = torch.zeros((0, N, S), dtype=score_dt, device=dev)
        final = raw.clone()
        sel = torch.zeros((0,), dtype=torch.int32, device=dev)
    pf_codes = torch.zeros((Q, 0), dtype=torch.int32, device=dev)
    return pf_codes, codes, raw, final, sel


def seq_run_plain(prog: SeqProgram, a: ClusterArrays, state0: SchedState, queue, weights,
                  *, record: bool):
    """The sequential pass: for each queue position, attempt then bind (pod
    i sees pod i-1's bind). Padding steps (pod -1) evaluate pod 0 and
    discard the result. Returns (final state, trace): the trace is
    (pf_codes, codes, raw, final, sel) when `record`, else sel."""
    s = state0.clone()
    rows = []
    for qi, p in enumerate(torch.as_tensor(queue).tolist()):
        codes, raw, final, sel = seq_attempt_plain(prog, a, s, weights, max(p, 0))
        if p < 0:
            sel = torch.full_like(sel, -1)
        seq_bind_plain(prog, a, s, p, sel, qi)
        rows.append((codes, raw, final, sel) if record else sel)
    N = a.node_mask.shape[0]
    return s, _trace(rows, record, N, len(prog.filters), len(prog.scores),
                     prog.score_dtype, a.node_mask.device)


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------


def build() -> tuple[Path, float]:
    """Compile csrc/seq_kernels.cu for sm_90a into build/kernels/ unless
    this source's library is there already. Returns (library path, build
    seconds; 0 when it was there). The compiler's report (registers,
    shared memory, spills) is kept beside the library as a .log file."""
    src = CSRC.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libseq_kernels_{tag}.so"
    if out.exists():
        return out, 0.0
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    res = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC)], capture_output=True, text=True
    )
    secs = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    out.with_suffix(".log").write_text(res.stdout + res.stderr)
    os.replace(tmp, out)
    return out, secs


_PLANE_PTRS = tuple(f.name for f in dataclasses.fields(ClusterArrays)
                    if f.name not in ("pod_priority", "pod_mask"))
_STATE_PTRS = tuple(f.name for f in dataclasses.fields(SchedState))


class _Planes(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in _PLANE_PTRS] + [
        (n, ctypes.c_int) for n in ("N", "P", "R", "T", "L")
    ]


class _State(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in _STATE_PTRS]


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _LIB
    if _LIB is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.seq_cfg_ints, lib.seq_planes_bytes, lib.seq_state_bytes):
            fn.argtypes, fn.restype = [], ci
        for t in ("i32", "i64"):
            f = getattr(lib, f"seq_attempt_{t}")
            f.argtypes, f.restype = [vp, vp, vp, vp, ci, vp, vp, vp, vp, vp, vp], ci
            f = getattr(lib, f"seq_bind_{t}")
            f.argtypes, f.restype = [vp, vp, ci, vp, ci, vp], ci
            f = getattr(lib, f"seq_run_{t}")
            f.argtypes, f.restype = [vp, vp, vp, vp, vp, ci, ci, vp, vp, vp, vp, vp, vp, vp, vp], ci
        if (lib.seq_cfg_ints(), lib.seq_planes_bytes(), lib.seq_state_bytes()) != (
            CFG_INTS, ctypes.sizeof(_Planes), ctypes.sizeof(_State)
        ):
            raise RuntimeError("kernel library's struct layout differs from engine/cuda.py")
        _LIB = lib
    return _LIB


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

_RES_FIELDS = {"node_alloc", "pod_req", "pod_sreq", "requested", "s_requested"}
_BOOL_FIELDS = {"node_unsched", "node_mask", "pod_tol_unsched", "pod_mask"}


def _on_cpu(a: ClusterArrays) -> bool:
    return a.node_mask.device.type == "cpu"


def _check(prog: SeqProgram, a: ClusterArrays, s: SchedState, weights=None) -> tuple:
    """Validate what the kernels read; returns (Planes, State, suffix)."""
    dev = a.node_mask.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {dev}")
    res_dt = prog.score_dtype
    if res_dt not in (torch.int32, torch.int64):
        raise ValueError(f"unsupported score dtype {res_dt}")
    N, R = a.node_alloc.shape
    P = a.pod_mask.shape[0]
    T = a.taint_key.shape[1]
    L = a.tol_key.shape[1]
    shapes = {
        "node_alloc": (N, R), "node_unsched": (N,), "node_mask": (N,),
        "pod_req": (P, R), "pod_sreq": (P, R), "pod_req_rank": (P, R),
        "pod_node_name": (P,), "pod_tol_unsched": (P,), "pod_priority": (P,),
        "pod_mask": (P,), "taint_key": (N, T), "taint_val": (N, T),
        "taint_effect": (N, T), "tol_key": (P, L), "tol_val": (P, L),
        "tol_effect": (P, L), "tol_op": (P, L),
        "requested": (N, R), "s_requested": (N, R), "n_pods": (N,),
        "assignment": (P,), "bound_seq": (P,),
    }
    tensors = {f.name: getattr(a, f.name) for f in dataclasses.fields(a)}
    tensors.update({f.name: getattr(s, f.name) for f in dataclasses.fields(s)})
    for name, t in tensors.items():
        want = res_dt if name in _RES_FIELDS else (
            torch.bool if name in _BOOL_FIELDS else torch.int32
        )
        if t.device != dev or t.dtype != want or tuple(t.shape) != shapes[name]:
            raise ValueError(
                f"{name}: want {want} {shapes[name]} on {dev}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    S = len(prog.scores)
    if weights is not None and (weights.device != dev or weights.dtype != res_dt or tuple(weights.shape) != (S,) \
            or not weights.is_contiguous()):
        raise ValueError(f"weights: want contiguous {res_dt} ({S},) on {dev}")
    planes = _Planes(
        *[tensors[n].data_ptr() for n in _PLANE_PTRS], N, P, R, T, L
    )
    state = _State(*[tensors[n].data_ptr() for n in _STATE_PTRS])
    return planes, state, "i32" if res_dt == torch.int32 else "i64"


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def seq_attempt(prog: SeqProgram, a: ClusterArrays, s: SchedState, weights, p: int):
    """K1 for pod p: (codes [N,F] int32, raw [N,S], final [N,S], sel [])."""
    if _on_cpu(a):
        PLAIN_CALLS["seq_attempt"] += 1
        return seq_attempt_plain(prog, a, s, weights, p)
    planes, state, t = _check(prog, a, s, weights)
    if not 0 <= p < planes.P:
        raise ValueError(f"pod index {p} outside [0, {planes.P})")
    lib = library()
    dev, N = a.node_mask.device, planes.N
    F, S = len(prog.filters), len(prog.scores)
    codes = torch.empty((N, F), dtype=torch.int32, device=dev)
    raw = torch.empty((N, S), dtype=prog.score_dtype, device=dev)
    final = torch.empty((N, S), dtype=prog.score_dtype, device=dev)
    sel = torch.empty((), dtype=torch.int32, device=dev)
    feas = torch.empty((N,), dtype=torch.uint8, device=dev)
    cfg = np.ascontiguousarray(prog.cfg)
    rc = getattr(lib, f"seq_attempt_{t}")(
        cfg.ctypes.data, ctypes.addressof(planes), ctypes.addressof(state),
        weights.data_ptr(), p, codes.data_ptr(), raw.data_ptr(), final.data_ptr(),
        sel.data_ptr(), feas.data_ptr(), _stream(),
    )
    _raise_on(rc, "seq_attempt")
    LAUNCHES["seq_attempt"] += 1
    return codes, raw, final, sel


def seq_bind(prog: SeqProgram, a: ClusterArrays, s: SchedState, p: int, sel: torch.Tensor,
             qi: int):
    """K2: bind pod p to node `sel` (0-dim int32 tensor) at queue position
    qi, in place; p < 0 is a no-op. Returns `s`."""
    if _on_cpu(a):
        PLAIN_CALLS["seq_bind"] += 1
        return seq_bind_plain(prog, a, s, p, sel, qi)
    planes, state, t = _check(prog, a, s)
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


def seq_run(prog: SeqProgram, a: ClusterArrays, state0: SchedState, queue, weights,
            *, record: bool):
    """K3: the whole sequential pass over `queue` (int32 pod indices, -1 =
    padding) in one launch. Returns (final state, trace) as
    `seq_run_plain` does; `state0` is left as it was."""
    if _on_cpu(a):
        PLAIN_CALLS["seq_run"] += 1
        return seq_run_plain(prog, a, state0, queue, weights, record=record)
    s = state0.clone()
    planes, state, t = _check(prog, a, s, weights)
    dev, N = a.node_mask.device, planes.N
    if queue.device != dev or queue.dtype != torch.int32 or queue.dim() != 1:
        raise ValueError("queue must be a 1-d int32 tensor on the planes' device")
    queue = queue.contiguous()
    Q = queue.shape[0]
    if Q and (int(queue.max()) >= planes.P or int(queue.min()) < -1):
        raise ValueError(f"queue holds pod indices outside [-1, {planes.P})")
    F, S = len(prog.filters), len(prog.scores)
    dt = prog.score_dtype
    sel = torch.empty((Q,), dtype=torch.int32, device=dev)
    if record:
        codes = torch.empty((Q, N, F), dtype=torch.int32, device=dev)
        raw = torch.empty((Q, N, S), dtype=dt, device=dev)
        final = torch.empty((Q, N, S), dtype=dt, device=dev)
        codes_s = raw_s = None
    else:
        codes = raw = final = None
        codes_s = torch.empty((N, F), dtype=torch.int32, device=dev)
        raw_s = torch.empty((N, S), dtype=dt, device=dev)
    if Q:
        feas = torch.empty((N,), dtype=torch.uint8, device=dev)
        cfg = np.ascontiguousarray(prog.cfg)

        def ptr(x):
            return None if x is None else x.data_ptr()

        rc = getattr(library(), f"seq_run_{t}")(
            cfg.ctypes.data, ctypes.addressof(planes), ctypes.addressof(state),
            weights.data_ptr(), queue.data_ptr(), Q, int(record), ptr(codes), ptr(raw),
            ptr(final), sel.data_ptr(), feas.data_ptr(), ptr(codes_s), ptr(raw_s), _stream(),
        )
        _raise_on(rc, "seq_run")
        LAUNCHES["seq_run"] += 1
    if not record:
        return s, sel
    pf_codes = torch.zeros((Q, 0), dtype=torch.int32, device=dev)
    return s, (pf_codes, codes, raw, final, sel)
