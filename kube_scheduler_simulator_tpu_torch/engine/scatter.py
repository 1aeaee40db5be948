"""K10: the delta encoder's row scatters, beside their plain PyTorch versions.

Three hand-written CUDA kernels (`csrc/delta_kernels.cu`) update a retained
encoding's tensors in place on the card, each replacing one device program
of the reference package's `engine/delta.py` `_scatter_fns`:

  * `scatter_set` — `delta.scatter_set`: `arr[idx[j]] = rows[j]`;
  * `scatter_add` — `delta.scatter_add`: `arr[idx[j]] += rows[j]`, repeated
    indices summing (int32 wraps mod 2^32, as XLA's scatter-add);
  * `vec_add` — `delta.vec_add`: `arr += vec`.

The wrappers take the dirty rows on the host (CPU tensors, built by the
encoder with numpy), check them there (a repeated `set` index raises: its
winner would be unspecified), copy them to the tensor's device and launch
the kernel; an empty update launches nothing. For a tensor on the CPU they
run the plain version instead. `launch_set`/`launch_add`/`launch_vec` are
the launches alone, on device tensors (what `chip_smoke.py` times). The
kernels live in the library `engine/cuda.py` builds and binds;
`LAUNCHES` and `PLAIN_CALLS` count per kernel.
"""

from __future__ import annotations

import torch

from . import cuda

KERNELS = ("delta_scatter_set", "delta_scatter_add", "delta_vec_add")
LAUNCHES = dict.fromkeys(KERNELS, 0)
PLAIN_CALLS = dict.fromkeys(KERNELS, 0)
_ADD_TYPES = (torch.int32, torch.int64)


def reset_counts() -> None:
    """Set every launch and plain-call counter to 0."""
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


# ---------------------------------------------------------------------------
# plain PyTorch versions (the reference's `.at[idx].set` / `.at[idx].add` /
# `arr + vec`, in place)
# ---------------------------------------------------------------------------


def _wrap_into(arr: torch.Tensor, wide: torch.Tensor) -> None:
    """Write int64 `wide` into int32 `arr` modulo 2^32 (two's complement)."""
    arr.copy_((((wide + (1 << 31)) % (1 << 32)) - (1 << 31)).to(arr.dtype))


def scatter_set_plain(arr: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """arr[idx[j]] = rows[j], in place. Returns arr."""
    arr[idx.long()] = rows
    return arr


def scatter_add_plain(arr: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """arr[idx[j]] += rows[j], in place; repeated indices sum. Returns arr."""
    if arr.dtype == torch.int32:
        wide = arr.to(torch.int64)
        wide.index_add_(0, idx.long(), rows.to(torch.int64))
        _wrap_into(arr, wide)
    else:
        arr.index_add_(0, idx.long(), rows)
    return arr


def vec_add_plain(arr: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """arr += vec, in place. Returns arr."""
    if arr.dtype == torch.int32:
        _wrap_into(arr, arr.to(torch.int64) + vec.to(torch.int64))
    else:
        arr += vec
    return arr


# ---------------------------------------------------------------------------
# launches (device tensors) and wrappers (host rows)
# ---------------------------------------------------------------------------


def _on_cpu(arr: torch.Tensor) -> bool:
    return arr.device.type == "cpu"


def _check_target(arr: torch.Tensor) -> None:
    if arr.device.type not in cuda.KERNEL_DEVICE_TYPES:
        raise ValueError(f"the K10 kernels take CUDA tensors, got {arr.device}")
    if not arr.is_contiguous():
        raise ValueError("the retained tensor is not contiguous")


def _check_rows(arr: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor) -> None:
    k = idx.shape[0] if idx.dim() == 1 else -1
    if idx.dtype != torch.int32 or k < 0:
        raise ValueError(f"idx must be a 1-d int32 tensor, got {idx.dtype} {tuple(idx.shape)}")
    if rows.dtype != arr.dtype or tuple(rows.shape) != (k, *arr.shape[1:]):
        raise ValueError(f"rows: want {arr.dtype} {(k, *arr.shape[1:])}, "
                         f"got {rows.dtype} {tuple(rows.shape)}")
    if arr.dim() == 0:
        raise ValueError("a row scatter needs a target with a leading axis")


def _launch_rows(name: str, arr, idx, rows) -> torch.Tensor:
    _check_target(arr)
    _check_rows(arr, idx, rows)
    if idx.device != arr.device or rows.device != arr.device:
        raise ValueError("idx and rows must lie on the target's device")
    if not (idx.is_contiguous() and rows.is_contiguous()):
        raise ValueError("idx and rows must be contiguous")
    k, w = idx.shape[0], rows[0].numel() if idx.shape[0] else 0
    if k == 0 or w == 0:
        return arr
    rc = getattr(cuda.library(), name)(arr.data_ptr(), idx.data_ptr(), rows.data_ptr(), k, w,
                                       arr.element_size(), cuda._stream())
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    LAUNCHES[name] += 1
    return arr


def launch_set(arr: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """The set kernel on device tensors: arr[idx[j]] = rows[j], in place.
    The indices must be distinct and in range (`scatter_set` checks them)."""
    return _launch_rows("delta_scatter_set", arr, idx, rows)


def launch_add(arr: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """The add kernel on device tensors: arr[idx[j]] += rows[j], in place.
    The indices must be in range (`scatter_add` checks them)."""
    if arr.dtype not in _ADD_TYPES:
        raise ValueError(f"delta_scatter_add takes int32 or int64 targets, got {arr.dtype}")
    return _launch_rows("delta_scatter_add", arr, idx, rows)


def launch_vec(arr: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """The vector add kernel on device tensors: arr += vec, in place."""
    _check_target(arr)
    if arr.dtype not in _ADD_TYPES:
        raise ValueError(f"delta_vec_add takes int32 or int64 targets, got {arr.dtype}")
    if (vec.dtype != arr.dtype or vec.shape != arr.shape or vec.device != arr.device
            or not vec.is_contiguous()):
        raise ValueError(f"vec: want contiguous {arr.dtype} {tuple(arr.shape)} on {arr.device}")
    if arr.numel() == 0:
        return arr
    rc = cuda.library().delta_vec_add(arr.data_ptr(), vec.data_ptr(), arr.numel(),
                                      arr.element_size(), cuda._stream())
    if rc != 0:
        raise RuntimeError(f"delta_vec_add launch failed: cudaError {rc}")
    LAUNCHES["delta_vec_add"] += 1
    return arr


def _host_checks(arr: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor, unique: bool):
    if idx.device.type != "cpu" or rows.device.type != "cpu":
        raise ValueError("the dirty rows come from the host: idx and rows must be CPU tensors")
    _check_rows(arr, idx, rows)
    if idx.numel():
        lo, hi = int(idx.min()), int(idx.max())
        if lo < 0 or hi >= arr.shape[0]:
            raise ValueError(f"row indices outside [0, {arr.shape[0]}): {lo}..{hi}")
        if unique and torch.unique(idx).numel() != idx.numel():
            raise ValueError("scatter_set got a repeated row index")


def scatter_set(arr: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """K10 set: arr[idx[j]] = rows[j], in place. `idx` (int32 [k], distinct)
    and `rows` ([k, *arr.shape[1:]], arr's dtype) are CPU tensors. Returns
    arr."""
    _host_checks(arr, idx, rows, unique=True)
    if _on_cpu(arr):
        PLAIN_CALLS["delta_scatter_set"] += 1
        return scatter_set_plain(arr, idx, rows)
    return launch_set(arr, idx.to(arr.device), rows.to(arr.device))


def scatter_add(arr: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """K10 add: arr[idx[j]] += rows[j], in place (int32 or int64; repeated
    indices sum). `idx` and `rows` are CPU tensors. Returns arr."""
    _host_checks(arr, idx, rows, unique=False)
    if _on_cpu(arr):
        PLAIN_CALLS["delta_scatter_add"] += 1
        return scatter_add_plain(arr, idx, rows)
    return launch_add(arr, idx.to(arr.device), rows.to(arr.device))


def vec_add(arr: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """K10 vector add: arr += vec, in place. `vec` is a CPU tensor of arr's
    dtype and shape. Returns arr."""
    if vec.device.type != "cpu" or vec.dtype != arr.dtype or vec.shape != arr.shape:
        raise ValueError(f"vec: want a CPU {arr.dtype} {tuple(arr.shape)} tensor")
    if _on_cpu(arr):
        PLAIN_CALLS["delta_vec_add"] += 1
        return vec_add_plain(arr, vec)
    return launch_vec(arr, vec.to(arr.device))
