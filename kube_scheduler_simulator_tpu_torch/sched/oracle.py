"""The cluster snapshot the volume plugins consult, cut from the reference
package's pure-Python oracle (`sched/oracle.py`).

The VolumeBinding and VolumeZone verdicts depend only on static objects
(PVCs, PVs, StorageClasses and node labels), so the encoder evaluates them
once per (claim, node) with the plugin functions of `oracle_plugins.py`
against this snapshot. Only what those functions read is kept: each node's
view, the objects indexed by key, and the per-cycle context that carries
the snapshot and the configuration. The oracle scheduler itself is not
part of the port.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from ..models.objects import NodeView
from .config import SchedulerConfiguration


class NodeInfo:
    """One node of the snapshot (upstream framework.NodeInfo, cut to the
    node's view)."""

    def __init__(self, node: dict):
        self.node = NodeView(node)


@dataclass
class ClusterSnapshot:
    """Indexed view of the objects the volume plugins consult."""

    nodes: dict[str, NodeInfo] = field(default_factory=dict)
    pvcs: dict[str, dict] = field(default_factory=dict)  # ns/name → obj
    pvs: dict[str, dict] = field(default_factory=dict)
    storageclasses: dict[str, dict] = field(default_factory=dict)

    @classmethod
    def build(
        cls,
        nodes: list[dict],
        pvcs: "list[dict] | None" = None,
        pvs: "list[dict] | None" = None,
        storageclasses: "list[dict] | None" = None,
    ) -> "ClusterSnapshot":
        """Index raw manifests: PVCs key as "ns/name", the rest by name."""
        snap = cls()
        for n in nodes:
            snap.nodes[NodeView(n).name] = NodeInfo(n)
        for objs, store in ((pvcs, snap.pvcs), (pvs, snap.pvs),
                            (storageclasses, snap.storageclasses)):
            for o in objs or []:
                meta = o.get("metadata", {})
                if store is snap.pvcs:
                    store[f"{meta.get('namespace', 'default')}/{meta['name']}"] = o
                else:
                    store[meta["name"]] = o
        return snap

    def node_list(self) -> list[NodeInfo]:
        return list(self.nodes.values())


class CycleContext:
    """Per-scheduling-cycle state (upstream CycleState): the snapshot and
    the configuration whose plugin args the plugins resolve."""

    def __init__(self, snapshot: ClusterSnapshot, config: SchedulerConfiguration):
        self.snapshot = snapshot
        self.config = config
        self.state: dict[str, Any] = {}

    def args(self, plugin: str) -> dict:
        return self.config.plugin_args(plugin)
