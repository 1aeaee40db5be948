"""The PACKED dtype policy's storage: bit-packing, narrowing, widening, and
the byte counts of an encoding. The reference package's `engine/packing.py`.

Under PACKED (engine/encode.py) each field's width class picks how it is
stored at rest:

  * ``exact`` — dtype unchanged (capacities, requests, priorities);
  * ``id``    — vocab ids and node indices narrow to int16 (int8 for the
                closed enum families) when every value fits, else stay
                int32;
  * ``count`` — small counters narrow to int8 or int16 under the same rule;
  * ``mask``  — bool planes of 2 or more dims whose last axis has at least
                PACK_MIN_DIM lanes bit-pack that axis into 32-bit words
                (1-D masks stay bool: the delta encoder sets single
                elements, and `EncodedCluster.N`/`P` read their shapes).

The kernels never see the narrow forms. `widen` gives an encoding's logical
int32/bool planes once at the entry of a pass, in one launch of the K8
kernel (`cuda.pack_widen`, csrc/pack_kernels.cu), as the reference widens
once before its scan and its gang loop; the existing kernels run on those
planes unchanged, so placements and trace bytes are TPU32's. The widened
copy lives while the pass runs. A caller of the single-pod step functions
widens at each call (a launch a call); nothing caches the copy on the
encoding.

Bit layout (the host packer, the host unpacker and the kernel): bit j of
word w holds lane 32 w + j; the tail word's padding bits are zero. The
words are stored as int32 tensors with the reference's uint32 bits (torch
has no CPU shift for uint32).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Bit-pack a bool plane only when its last axis has at least this many
# lanes: below it a 4-byte word costs more than the bool bytes.
PACK_MIN_DIM = 8

_I8 = np.iinfo(np.int8)
_I16 = np.iinfo(np.int16)
NARROW = (torch.int8, torch.int16)


# -- host packing (the encoder and the delta encoder) ------------------------


def pack_bits_np(b: np.ndarray) -> np.ndarray:
    """Bit-pack a bool array's last axis into uint32 words."""
    b = np.asarray(b, bool)
    n = b.shape[-1]
    w = -(-n // 32)
    pad = w * 32 - n
    if pad:
        b = np.concatenate([b, np.zeros(b.shape[:-1] + (pad,), bool)], axis=-1)
    b = b.reshape(b.shape[:-1] + (w, 32)).astype(np.uint32)
    return (b << np.arange(32, dtype=np.uint32)).sum(axis=-1, dtype=np.uint32)


def unpack_bits_np(a: np.ndarray, n: int) -> np.ndarray:
    """The inverse of `pack_bits_np`: 32-bit words [..., W] (uint32 or their
    int32 view) → bool [..., n]."""
    a = np.asarray(a).view(np.uint32)
    bits = (a[..., None] >> np.arange(32, dtype=np.uint32)) & np.uint32(1)
    flat = bits.reshape(a.shape[:-1] + (a.shape[-1] * 32,))
    return flat[..., :n].astype(bool)


def narrow_int_np(v: np.ndarray, *, enum8: bool = False) -> np.ndarray:
    """Narrow an integer array to int16 (int8 for enum and count planes)
    when every value fits; return it unchanged when one does not (the
    field's wide fallback). An empty plane takes the narrow type."""
    v = np.asarray(v)
    if v.dtype.kind not in "iu":
        return v
    if v.size == 0:
        return v.astype(np.int8 if enum8 else np.int16)
    lo, hi = int(v.min()), int(v.max())
    if enum8 and _I8.min <= lo and hi <= _I8.max:
        return v.astype(np.int8)
    if _I16.min <= lo and hi <= _I16.max:
        return v.astype(np.int16)
    return v


def rows_fit(rows, dtype: torch.dtype) -> bool:
    """True when every (numpy) row's values fit `dtype`: the delta
    encoder's guard before it casts dirty rows into a tensor."""
    if dtype == torch.bool or dtype.is_floating_point:
        return True
    info = torch.iinfo(dtype)
    for r in rows:
        r = np.asarray(r)
        if r.size and (int(r.min()) < info.min or int(r.max()) > info.max):
            return False
    return True


def put_field(name: str, v, cls: str, *, policy, enum8: "frozenset[str]",
              packed_dims: "dict[str, int]", device, dtype=None) -> torch.Tensor:
    """One encoded field on `device` under its width class. Under the
    unpacked policies this is `torch.as_tensor` (the encodings are
    unchanged). Under PACKED a mask plane bit-packs (its logical last dim
    goes into `packed_dims`) and an id or count plane narrows when its
    values fit."""
    if dtype is not None or not getattr(policy, "packed", False):
        return torch.as_tensor(v, dtype=dtype, device=device)
    v = np.asarray(v)
    if cls == "mask":
        if v.dtype == bool and v.ndim >= 2 and v.shape[-1] >= PACK_MIN_DIM:
            packed_dims[name] = int(v.shape[-1])
            v = pack_bits_np(v).view(np.int32)
    elif cls in ("id", "count"):
        # counts (ranks, port, volume and image tallies, weights) may drop
        # to int8; general ids keep an int16 floor (vocabularies routinely
        # pass 127) unless the field is a closed enum
        v = narrow_int_np(v, enum8=name in enum8 or cls == "count")
    return torch.as_tensor(v, device=device)


# -- widening (K8) ------------------------------------------------------------


def _packed_dims(x) -> "tuple[object, dict]":
    """(arrays, packed_dims) of an encoding, or of arrays given alone."""
    if hasattr(x, "arrays"):  # an EncodedCluster
        return x.arrays, (x.aux.get("packed_dims") or {}) if x.policy.packed else None
    return x, {}


def logical_dim(x, name: str) -> int:
    """The logical last dim of field `name` of an encoding (or of arrays):
    its lane count where PACKED bit-packed it, else its stored last dim."""
    arrays, pd = _packed_dims(x)
    n = (pd or {}).get(name)
    if n is not None:
        return int(n)
    t = getattr(arrays, name, None)
    if t is None:
        t = getattr(arrays.rel, name)
    return int(t.shape[-1])


def widen(x, packed_dims: "dict[str, int] | None" = None):
    """The logical `ClusterArrays` of an encoding (or of `x`, arrays whose
    bit-packed fields `packed_dims` names): every bit-packed plane as bool
    [..., n], every int8/int16 plane as int32, in one K8 launch
    (`cuda.pack_widen`); exact planes are the same tensors. The identity
    for EXACT and TPU32 encodings, and idempotent: a widened plane carries
    no packed or narrow dtype."""
    from . import cuda

    arrays, pd = _packed_dims(x)
    if pd is None:
        return arrays
    picked = widen_leaves(arrays, pd if packed_dims is None else packed_dims)
    if not picked:
        return arrays
    out = cuda.pack_widen([t for _, _, t, _ in picked], [n for _, _, _, n in picked])
    top = {name: w for (in_rel, name, _, _), w in zip(picked, out) if not in_rel}
    rel = {name: w for (in_rel, name, _, _), w in zip(picked, out) if in_rel}
    return dataclasses.replace(arrays, rel=dataclasses.replace(arrays.rel, **rel), **top)


def widen_leaves(arrays, packed_dims: "dict[str, int]") -> list:
    """The planes `widen` hands K8: (in rel, name, tensor, lanes) of every
    bit-packed plane (int32 words; lanes its logical last dim) and every
    narrow one (int8 or int16; lanes 0)."""
    picked = []
    for in_rel, obj in ((False, arrays), (True, arrays.rel)):
        for f in dataclasses.fields(obj):
            t = getattr(obj, f.name)
            if not isinstance(t, torch.Tensor):
                continue
            n = packed_dims.get(f.name)
            if n is not None and t.dtype == torch.int32:
                picked.append((in_rel, f.name, t, int(n)))
            elif t.dtype in NARROW:
                picked.append((in_rel, f.name, t, 0))
    return picked


# -- measurement --------------------------------------------------------------


def _tensor_bytes(obj) -> int:
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    return sum(_tensor_bytes(getattr(obj, f.name)) for f in dataclasses.fields(obj))


def encoded_device_bytes(enc) -> "dict[str, int]":
    """Device bytes an encoding holds: the cluster planes (`arrays`, the
    nested relational planes included; what PACKED shrinks) and the
    initial state (`state0`, always wide)."""
    arrays = _tensor_bytes(enc.arrays)
    state0 = _tensor_bytes(enc.state0)
    return {"arrays": arrays, "state0": state0, "total": arrays + state0}
