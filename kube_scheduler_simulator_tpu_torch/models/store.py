"""In-memory typed resource store: the simulator's cluster state.

The reference package's `models/store.py`, cut to what the serving path
reads: per-object resourceVersion and uid stamps, server-side-apply
upserts, wholesale replacement, cascading deletes, a bounded event log
with `events_since`/`dirty_since` (the delta encoder's dirty feed) and a
boot snapshot for reset. Two stores fed the same operations hold equal
objects, in the same order, with the same stamps as the reference's.

Not ported: watch subscribers, checkpoint dumps (`dump_state`/
`load_state`) and the lock-order witness (a plain re-entrant lock guards
the state).
"""

from __future__ import annotations

import bisect
import copy
import itertools
import threading
from dataclasses import dataclass

# The seven watched kinds in the reference's order, plus the workload kinds
# its controller subset manages.
KINDS = (
    "pods",
    "nodes",
    "pvs",
    "pvcs",
    "storageclasses",
    "priorityclasses",
    "namespaces",
    "deployments",
    "replicasets",
)

NAMESPACED = {"pods": True, "pvcs": True, "deployments": True, "replicasets": True}


class StaleResourceVersion(Exception):
    """The requested resourceVersion predates the retained event log."""


@dataclass(frozen=True)
class WatchEvent:
    event_type: str  # ADDED | MODIFIED | DELETED
    kind: str
    obj: dict
    resource_version: int


class ResourceStore:
    """Typed collections with list/watch semantics."""

    def __init__(self, event_log_capacity: int = 100_000):
        self._lock = threading.RLock()
        self._rv = itertools.count(1)
        self._objs: dict[str, dict[str, dict]] = {k: {} for k in KINDS}
        self._events: list[WatchEvent] = []
        # the resourceVersion of each logged event, for bisection
        self._event_rvs: list[int] = []
        # past capacity the older half is dropped; readers behind it get
        # StaleResourceVersion (the apiserver's 410 Gone)
        self._event_log_capacity = max(2, int(event_log_capacity))
        self._pruned_through = 0  # highest resourceVersion dropped from the log
        self._initial_snapshot: "dict | None" = None

    # -- keys ---------------------------------------------------------------

    @staticmethod
    def key(kind: str, obj: dict) -> str:
        meta = obj.get("metadata", {}) or {}
        if NAMESPACED.get(kind):
            return f"{meta.get('namespace', 'default')}/{meta.get('name', '')}"
        return meta.get("name", "")

    @staticmethod
    def obj_key(kind: str, name: str, namespace: str = "default") -> str:
        return f"{namespace}/{name}" if NAMESPACED.get(kind) else name

    # -- CRUD ---------------------------------------------------------------

    def apply(self, kind: str, obj: dict) -> dict:
        """Upsert, bumping resourceVersion: the manifest is merged over the
        existing object field by field (server-side apply)."""
        if kind not in KINDS:
            raise KeyError(f"unknown kind {kind}")
        with self._lock:
            return copy.deepcopy(self._apply_locked(kind, obj))

    def replace(self, kind: str, obj: dict) -> dict:
        """Wholesale replacement: the manifest becomes the stored object, so
        fields absent from it are removed (unlike `apply`)."""
        if kind not in KINDS:
            raise KeyError(f"unknown kind {kind}")
        with self._lock:
            obj = copy.deepcopy(obj)
            if not (obj.get("metadata", {}) or {}).get("name"):
                raise ValueError("object has no metadata.name")
            k = self.key(kind, obj)
            existing = self._objs[kind].get(k)
            event_type = "MODIFIED" if existing is not None else "ADDED"
            rv = next(self._rv)
            meta = obj.setdefault("metadata", {})
            meta["resourceVersion"] = str(rv)
            if existing is not None:
                meta.setdefault("uid", existing.get("metadata", {}).get("uid"))
            meta.setdefault("uid", f"uid-{kind}-{k}-{rv}")
            if NAMESPACED.get(kind):
                meta.setdefault("namespace", "default")
            self._objs[kind][k] = obj
            self._emit(WatchEvent(event_type, kind, copy.deepcopy(obj), rv))
            return copy.deepcopy(obj)

    def _apply_locked(self, kind: str, obj: dict) -> dict:
        obj = copy.deepcopy(obj)
        meta0 = obj.get("metadata", {}) or {}
        if not meta0.get("name") and meta0.get("generateName"):
            # the apiserver's generateName contract: a random 5-character
            # suffix, redrawn until the key is free
            import random
            import string

            alphabet = string.ascii_lowercase + string.digits
            prefix = meta0.pop("generateName")
            ns = meta0.get("namespace", "default")
            for _ in range(100):
                name = prefix + "".join(random.choices(alphabet, k=5))
                probe_key = f"{ns}/{name}" if NAMESPACED.get(kind) else name
                if probe_key not in self._objs[kind]:
                    break
            else:
                raise ValueError(f"generateName {prefix!r}: no free name after 100 draws")
            meta0["name"] = name
            obj["metadata"] = meta0
        if not (obj.get("metadata", {}) or {}).get("name"):
            raise ValueError("object has no metadata.name")
        k = self.key(kind, obj)
        existing = self._objs[kind].get(k)
        if existing is not None:
            merged = _merge(copy.deepcopy(existing), obj)
            event_type = "MODIFIED"
        else:
            merged = obj
            event_type = "ADDED"
        rv = next(self._rv)
        meta = merged.setdefault("metadata", {})
        meta["resourceVersion"] = str(rv)
        meta.setdefault("uid", f"uid-{kind}-{k}-{rv}")
        if NAMESPACED.get(kind):
            meta.setdefault("namespace", "default")
        self._objs[kind][k] = merged
        self._emit(WatchEvent(event_type, kind, copy.deepcopy(merged), rv))
        return merged

    def get(self, kind: str, name: str, namespace: str = "default") -> "dict | None":
        with self._lock:
            obj = self._objs[kind].get(self.obj_key(kind, name, namespace))
            return copy.deepcopy(obj) if obj is not None else None

    def list(self, kind: str) -> list[dict]:
        with self._lock:
            return [copy.deepcopy(o) for o in self._objs[kind].values()]

    def count(self, kind: str) -> int:
        """Object count without the deep copies `list` makes."""
        if kind not in KINDS:
            raise KeyError(f"unknown kind {kind}")
        with self._lock:
            return len(self._objs[kind])

    def delete(self, kind: str, name: str, namespace: str = "default") -> bool:
        with self._lock:
            return self._delete_locked(kind, name, namespace)

    def _delete_locked(self, kind: str, name: str, namespace: str) -> bool:
        k = self.obj_key(kind, name, namespace)
        obj = self._objs[kind].pop(k, None)
        if obj is None:
            return False
        rv = next(self._rv)
        self._emit(WatchEvent("DELETED", kind, copy.deepcopy(obj), rv))
        if kind == "nodes":
            # deleting a node deletes the pods bound to it
            doomed = [
                p
                for p in self._objs["pods"].values()
                if (p.get("spec", {}) or {}).get("nodeName") == name
            ]
            for p in doomed:
                meta = p.get("metadata", {})
                self._delete_locked("pods", meta.get("name", ""), meta.get("namespace", "default"))
        elif kind in ("deployments", "replicasets"):
            # deleting a workload deletes what it owns (deployment → its
            # ReplicaSets → their pods), in the object's namespace
            child_kind = "replicasets" if kind == "deployments" else "pods"
            owner_kind = "Deployment" if kind == "deployments" else "ReplicaSet"
            doomed = [
                c
                for c in self._objs[child_kind].values()
                if any(
                    ref.get("kind") == owner_kind and ref.get("name") == name
                    for ref in (c.get("metadata", {}) or {}).get("ownerReferences") or []
                )
                and (c.get("metadata", {}) or {}).get("namespace", "default") == namespace
            ]
            for c in doomed:
                meta = c.get("metadata", {})
                self._delete_locked(child_kind, meta.get("name", ""),
                                    meta.get("namespace", "default"))
        return True

    # -- watch --------------------------------------------------------------

    def _check_window(self, last_rv: int) -> None:
        if last_rv < self._pruned_through:
            raise StaleResourceVersion(
                f"resourceVersion {last_rv} is too old (oldest retained: "
                f"{self._pruned_through + 1}); relist required"
            )

    def events_since(self, kind: str, last_rv: int) -> list[WatchEvent]:
        """Events for `kind` after `last_rv`. Raises StaleResourceVersion
        when `last_rv` predates the retained log."""
        with self._lock:
            self._check_window(last_rv)
            start = bisect.bisect_right(self._event_rvs, last_rv)
            return [e for e in self._events[start:] if e.kind == kind]

    def dirty_since(self, last_rv: int) -> dict[str, dict[str, str]]:
        """Net per-object change after `last_rv`, {kind: {key: status}}:

          * ``ADDED``     — absent at last_rv, present now; ADDED keys come
            in the store's (re-)insertion order, the order their rows
            append in;
          * ``MODIFIED``  — present then and now, changed;
          * ``DELETED``   — present at last_rv, gone now;
          * ``REPLACED``  — deleted and re-added: the key moved to the end
            of iteration order;
          * ``TRANSIENT`` — added and deleted within the window.

        O(log E + events in the window). Raises StaleResourceVersion as
        `events_since` does."""
        with self._lock:
            self._check_window(last_rv)
            start = bisect.bisect_right(self._event_rvs, last_rv)
            out: dict[str, dict[str, str]] = {}
            for e in self._events[start:]:
                per = out.setdefault(e.kind, {})
                key = self.key(e.kind, e.obj)
                prev = per.get(key)
                if e.event_type == "ADDED":
                    # an ADDED event (re-)inserts the key at the end of the
                    # kind's iteration order: its slot moves to the end too
                    per.pop(key, None)
                    if prev == "DELETED":
                        per[key] = "REPLACED"
                    elif prev in (None, "TRANSIENT"):
                        per[key] = "ADDED"
                    else:  # impossible from a consistent log; keep status
                        per[key] = prev
                elif e.event_type == "MODIFIED":
                    if prev is None:
                        per[key] = "MODIFIED"
                elif e.event_type == "DELETED":
                    per[key] = "TRANSIENT" if prev == "ADDED" else "DELETED"
            return out

    def latest_rv(self) -> int:
        with self._lock:
            return self._events[-1].resource_version if self._events else self._pruned_through

    def _emit(self, ev: WatchEvent) -> None:
        self._events.append(ev)
        self._event_rvs.append(ev.resource_version)
        if len(self._events) > self._event_log_capacity:
            drop = self._event_log_capacity // 2
            self._pruned_through = self._events[drop - 1].resource_version
            del self._events[:drop]
            del self._event_rvs[:drop]

    # -- reset --------------------------------------------------------------

    def snapshot_initial(self) -> None:
        """Capture the current keyspace as the reset target."""
        with self._lock:
            self._initial_snapshot = {
                kind: copy.deepcopy(objs) for kind, objs in self._objs.items()
            }

    def reset(self) -> None:
        """Delete everything and restore the boot snapshot."""
        with self._lock:
            for kind in KINDS:
                for obj in list(self._objs[kind].values()):
                    meta = obj.get("metadata", {})
                    self._delete_locked(kind, meta.get("name", ""),
                                        meta.get("namespace", "default"))
            for kind, objs in (self._initial_snapshot or {}).items():
                for obj in objs.values():
                    self._apply_locked(kind, copy.deepcopy(obj))


def _merge(base: dict, patch: dict) -> dict:
    """Structural merge: dicts merge recursively, everything else replaces."""
    for k, v in patch.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            base[k] = _merge(base[k], v)
        else:
            base[k] = v
    return base
