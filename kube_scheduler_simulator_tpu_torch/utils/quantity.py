"""Kubernetes `resource.Quantity` parsing.

Implements the quantity grammar used throughout the reference's manifests
(requests/limits/allocatable; e.g. "100m", "1.5Gi", "2e3"): a signed decimal
number with an optional binary-SI (Ki..Ei), decimal-SI (n..E) or
decimal-exponent (e/E) suffix. Values are held exactly as
`fractions.Fraction` and exposed as integer base units (ceil, the direction
kubernetes rounds when converting to a coarser scale) and milli-units.

This is a semantic re-implementation of the behavior relied on by the
reference simulator's resource handling (see SURVEY.md §2 #15); no kubernetes
code is copied.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from fractions import Fraction
from functools import lru_cache

_BINARY_SUFFIXES: "dict[str, int]" = {
    "Ki": 1024,
    "Mi": 1024**2,
    "Gi": 1024**3,
    "Ti": 1024**4,
    "Pi": 1024**5,
    "Ei": 1024**6,
}

_DECIMAL_SUFFIXES: "dict[str, Fraction]" = {
    "n": Fraction(1, 10**9),
    "u": Fraction(1, 10**6),
    "m": Fraction(1, 10**3),
    "": Fraction(1),
    "k": Fraction(10**3),
    "M": Fraction(10**6),
    "G": Fraction(10**9),
    "T": Fraction(10**12),
    "P": Fraction(10**15),
    "E": Fraction(10**18),
}

_QUANTITY_RE = re.compile(
    r"^(?P<sign>[+-]?)(?P<digits>\d+(?:\.\d*)?|\.\d+)"
    r"(?:(?P<exp>[eE][+-]?\d+)|(?P<suffix>Ki|Mi|Gi|Ti|Pi|Ei|[numkMGTPE]?))$"
)


@dataclass(frozen=True)
class Quantity:
    """An exact resource quantity."""

    value: Fraction
    original: str = field(compare=False)

    @property
    def units(self) -> int:
        """Integer base units, rounded up (kubernetes rounds up on scale loss)."""
        return math.ceil(self.value)

    @property
    def milli(self) -> int:
        """Integer milli-units, rounded up."""
        return math.ceil(self.value * 1000)

    def __int__(self) -> int:
        return self.units

    def __float__(self) -> float:
        return float(self.value)


def parse_quantity(s: "str | int | float") -> Quantity:
    """Parse a kubernetes quantity string (or bare number) exactly.

    String parses are memoized: manifests repeat a handful of distinct
    quantities ("100m", "128Mi", ...) tens of thousands of times in a
    large encode, and `Quantity` is a frozen dataclass over an immutable
    Fraction, so shared instances are safe. ~40% of the 10k-pod encode's
    host time was quantity parsing before the cache."""
    if isinstance(s, (int, float)):
        return Quantity(Fraction(s).limit_denominator(10**9), str(s))
    return _parse_quantity_str(s.strip())


@lru_cache(maxsize=4096)
def _parse_quantity_str(text: str) -> Quantity:
    m = _QUANTITY_RE.match(text)
    if m is None:
        raise ValueError(f"invalid quantity: {text!r}")
    digits = m.group("digits")
    value = Fraction(digits)
    if m.group("exp"):
        exp = int(m.group("exp")[1:])
        value *= Fraction(10) ** exp
    else:
        suffix = m.group("suffix") or ""
        if suffix in _BINARY_SUFFIXES:
            value *= _BINARY_SUFFIXES[suffix]
        else:
            value *= _DECIMAL_SUFFIXES[suffix]
    if m.group("sign") == "-":
        value = -value
    return Quantity(value, text)

