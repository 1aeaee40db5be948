"""String interning vocabularies.

The device state (models/state.py) is purely numeric: every string that the
scheduling semantics compare for equality — label keys, label values,
namespaces, node names, taint keys, topology keys, image names, resource
names — is interned into an int32 id through a `Vocab`. Host-side code keeps
the dictionaries; device arrays only ever hold ids. Id -1 is reserved for
"absent".
"""

from __future__ import annotations

from typing import Iterator

ABSENT = -1


class Vocab:
    """A monotone string→int32 interning table."""

    def __init__(self, initial: "list[str] | None" = None) -> None:
        self._to_id: dict[str, int] = {}
        self._to_str: list[str] = []
        for s in initial or []:
            self.intern(s)

    def intern(self, s: str) -> int:
        i = self._to_id.get(s)
        if i is None:
            i = len(self._to_str)
            self._to_id[s] = i
            self._to_str.append(s)
        return i

    def get(self, s: str) -> int:
        """Return the id for `s`, or ABSENT (-1) without interning."""
        return self._to_id.get(s, ABSENT)

    def lookup(self, i: int) -> str:
        if i < 0:
            raise KeyError(f"invalid vocab id {i}")
        return self._to_str[i]

    def __len__(self) -> int:
        return len(self._to_str)

    def __contains__(self, s: str) -> bool:
        return s in self._to_id

    def items(self) -> "Iterator[tuple[str, int]]":
        return ((s, i) for i, s in enumerate(self._to_str))
