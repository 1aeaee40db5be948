"""Width checks and byte counts of an encoding: the parts of the reference
package's `engine/packing.py` that the TPU32 and EXACT policies use.

The PACKED policy's bit-packing and narrowing (and their unpack, K8) are
not ported yet; `encode.policy_from_env` refuses that policy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


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


def _tensor_bytes(obj) -> int:
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    return sum(_tensor_bytes(getattr(obj, f.name)) for f in dataclasses.fields(obj))


def encoded_device_bytes(enc) -> "dict[str, int]":
    """Device bytes an encoding holds: the cluster planes (`arrays`, the
    nested relational planes included) and the initial state (`state0`)."""
    arrays = _tensor_bytes(enc.arrays)
    state0 = _tensor_bytes(enc.state0)
    return {"arrays": arrays, "state0": state0, "total": arrays + state0}
