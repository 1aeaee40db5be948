"""Integer resource-unit conversion shared by the oracle and the encoder."""

from __future__ import annotations

import math
from fractions import Fraction


def to_int_resources(req: dict[str, Fraction]) -> dict[str, int]:
    """Fractions → the integer units upstream uses internally:
    cpu in millicores (ceil), everything else in base units (ceil)."""
    out = {}
    for name, v in req.items():
        if name == "cpu":
            out[name] = math.ceil(v * 1000)
        else:
            out[name] = math.ceil(v)
    return out
