"""KubeSchedulerConfiguration handling.

Parses the same v1beta2 KubeSchedulerConfiguration YAML the reference accepts
(reference: simulator/config/config.go:212-228) and applies the reference's
conversion semantics (reference: simulator/scheduler/scheduler.go:199-249):

  (1) only `.profiles` (and `.extenders`) are honored — every other field is
      forced back to its default;
  (2) each profile's plugin sets are merged over the in-tree defaults with
      the upstream merge algorithm (reference:
      simulator/scheduler/plugin/plugins.go:185-288 — enable the merged set,
      disable "*");
  (3) user PluginConfig entries override the default args per plugin
      (reference: plugins.go:103-179).

The default plugin sets and args below are the kubernetes v1.26 / v1beta2
scheme defaults, pinned by the reference's golden test
(simulator/scheduler/plugin/plugins_test.go:852-884 and :903-...).
"""

from __future__ import annotations

import copy
import json
from dataclasses import dataclass, field

MAX_NODE_SCORE = 100
MAX_TOTAL_SCORE = (1 << 63) - 1

EXTENSION_POINTS = (
    "queueSort",
    "preFilter",
    "filter",
    "postFilter",
    "preScore",
    "score",
    "reserve",
    "permit",
    "preBind",
    "bind",
    "postBind",
)


def default_plugins() -> dict[str, list[dict]]:
    """The v1.26 v1beta2 default plugin sets per extension point."""
    return {
        "queueSort": [{"name": "PrioritySort"}],
        "preFilter": [
            {"name": "NodeResourcesFit"},
            {"name": "NodePorts"},
            {"name": "VolumeRestrictions"},
            {"name": "PodTopologySpread"},
            {"name": "InterPodAffinity"},
            {"name": "VolumeBinding"},
            {"name": "VolumeZone"},
            {"name": "NodeAffinity"},
        ],
        "filter": [
            {"name": "NodeUnschedulable"},
            {"name": "NodeName"},
            {"name": "TaintToleration"},
            {"name": "NodeAffinity"},
            {"name": "NodePorts"},
            {"name": "NodeResourcesFit"},
            {"name": "VolumeRestrictions"},
            {"name": "EBSLimits"},
            {"name": "GCEPDLimits"},
            {"name": "NodeVolumeLimits"},
            {"name": "AzureDiskLimits"},
            {"name": "VolumeBinding"},
            {"name": "VolumeZone"},
            {"name": "PodTopologySpread"},
            {"name": "InterPodAffinity"},
        ],
        "postFilter": [{"name": "DefaultPreemption"}],
        "preScore": [
            {"name": "InterPodAffinity"},
            {"name": "PodTopologySpread"},
            {"name": "TaintToleration"},
            {"name": "NodeAffinity"},
            {"name": "NodeResourcesFit"},
            {"name": "NodeResourcesBalancedAllocation"},
        ],
        "score": [
            {"name": "NodeResourcesBalancedAllocation", "weight": 1},
            {"name": "ImageLocality", "weight": 1},
            {"name": "InterPodAffinity", "weight": 1},
            {"name": "NodeResourcesFit", "weight": 1},
            {"name": "NodeAffinity", "weight": 1},
            {"name": "PodTopologySpread", "weight": 2},
            {"name": "TaintToleration", "weight": 1},
        ],
        "reserve": [{"name": "VolumeBinding"}],
        "permit": [],
        "preBind": [{"name": "VolumeBinding"}],
        "bind": [{"name": "DefaultBinder"}],
        "postBind": [],
    }


def default_plugin_config() -> list[dict]:
    """Default per-plugin args (pinned by the reference's
    plugins_test.go defaultPluginConfig fixture)."""
    return [
        {
            "name": "DefaultPreemption",
            "args": {
                "kind": "DefaultPreemptionArgs",
                "apiVersion": "kubescheduler.config.k8s.io/v1beta2",
                "minCandidateNodesPercentage": 10,
                "minCandidateNodesAbsolute": 100,
            },
        },
        {
            "name": "InterPodAffinity",
            "args": {
                "kind": "InterPodAffinityArgs",
                "apiVersion": "kubescheduler.config.k8s.io/v1beta2",
                "hardPodAffinityWeight": 1,
            },
        },
        {
            "name": "NodeAffinity",
            "args": {
                "kind": "NodeAffinityArgs",
                "apiVersion": "kubescheduler.config.k8s.io/v1beta2",
            },
        },
        {
            "name": "NodeResourcesBalancedAllocation",
            "args": {
                "kind": "NodeResourcesBalancedAllocationArgs",
                "apiVersion": "kubescheduler.config.k8s.io/v1beta2",
                "resources": [{"name": "cpu", "weight": 1}, {"name": "memory", "weight": 1}],
            },
        },
        {
            "name": "NodeResourcesFit",
            "args": {
                "kind": "NodeResourcesFitArgs",
                "apiVersion": "kubescheduler.config.k8s.io/v1beta2",
                "scoringStrategy": {
                    "type": "LeastAllocated",
                    "resources": [{"name": "cpu", "weight": 1}, {"name": "memory", "weight": 1}],
                },
            },
        },
        {
            "name": "PodTopologySpread",
            "args": {
                "kind": "PodTopologySpreadArgs",
                "apiVersion": "kubescheduler.config.k8s.io/v1beta2",
                "defaultingType": "System",
            },
        },
        {
            "name": "VolumeBinding",
            "args": {
                "kind": "VolumeBindingArgs",
                "apiVersion": "kubescheduler.config.k8s.io/v1beta2",
                "bindTimeoutSeconds": 600,
            },
        },
    ]


def default_configuration() -> dict:
    """A full default KubeSchedulerConfiguration (v1beta2-shaped dict)."""
    return {
        "apiVersion": "kubescheduler.config.k8s.io/v1beta2",
        "kind": "KubeSchedulerConfiguration",
        "parallelism": 16,
        "percentageOfNodesToScore": 0,
        "podInitialBackoffSeconds": 1,
        "podMaxBackoffSeconds": 10,
        "profiles": [
            {
                "schedulerName": "default-scheduler",
                "plugins": default_plugins(),
                "pluginConfig": default_plugin_config(),
            }
        ],
        "extenders": [],
    }


def merge_plugin_set(in_tree: list[dict], out_of_tree: dict) -> list[dict]:
    """Merge a user plugin set over the defaults.

    Mirror of the upstream algorithm the reference copies
    (plugins.go:246-288 mergePluginSet): explicit disables remove defaults
    ("*" removes all); a user entry naming a default replaces it in place
    (preserving default order); remaining user entries append in order.
    """
    disabled = {p["name"] for p in out_of_tree.get("disabled") or []}
    enabled_custom = {p["name"]: (i, p) for i, p in enumerate(out_of_tree.get("enabled") or [])}
    replaced: set[int] = set()
    merged: list[dict] = []
    if "*" not in disabled:
        for dflt in in_tree:
            if dflt["name"] in disabled:
                continue
            if dflt["name"] in enabled_custom:
                idx, custom = enabled_custom[dflt["name"]]
                replaced.add(idx)
                dflt = custom
            merged.append(copy.deepcopy(dflt))
    for i, p in enumerate(out_of_tree.get("enabled") or []):
        if i not in replaced:
            merged.append(copy.deepcopy(p))
    return merged


def convert_plugins_for_simulator(user_plugins: "dict | None") -> dict[str, dict]:
    """Produce the effective plugin sets: for every extension point, merge the
    user's set over the in-tree defaults, enable the result, disable "*"
    (plugins.go:185-242 ConvertForSimulator/applyPluingSet)."""
    user_plugins = user_plugins or {}
    defaults = default_plugins()
    out: dict[str, dict] = {}
    for ep in EXTENSION_POINTS:
        user_set = user_plugins.get(ep) or {}
        merged = merge_plugin_set(defaults[ep], user_set)
        out[ep] = {"enabled": merged, "disabled": [{"name": "*"}]}
    return out


def new_plugin_config(user_pc: "list[dict] | None") -> list[dict]:
    """Default plugin args overridden by user-supplied args, per plugin;
    unknown (out-of-tree) plugin configs pass through (plugins.go:103-179)."""
    merged: dict[str, dict] = {}
    order: list[str] = []
    for pc in default_plugin_config():
        merged[pc["name"]] = copy.deepcopy(pc["args"])
        order.append(pc["name"])
    for pc in user_pc or []:
        name = pc.get("name", "")
        args = pc.get("args") or {}
        if name not in merged:
            merged[name] = copy.deepcopy(args)
            order.append(name)
        else:
            base = merged[name]
            for k, v in args.items():
                base[k] = copy.deepcopy(v)
    return [{"name": n, "args": merged[n]} for n in order]


@dataclass
class SchedulerConfiguration:
    """The effective, resolved scheduler configuration."""

    raw: dict = field(default_factory=default_configuration)
    profiles: list[dict] = field(default_factory=list)
    extenders: list[dict] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: "dict | None") -> "SchedulerConfiguration":
        """Apply the reference's conversion: honor only .profiles and
        .extenders, force defaults elsewhere (scheduler.go:199-249)."""
        d = copy.deepcopy(d) or {}
        base = default_configuration()
        profiles = d.get("profiles") or []
        if not profiles:
            profiles = [{"schedulerName": "default-scheduler", "plugins": {}}]
        resolved = []
        for p in profiles:
            resolved.append(
                {
                    "schedulerName": p.get("schedulerName") or "default-scheduler",
                    "plugins": convert_plugins_for_simulator(p.get("plugins")),
                    "pluginConfig": new_plugin_config(p.get("pluginConfig")),
                }
            )
        base["profiles"] = resolved
        base["extenders"] = copy.deepcopy(d.get("extenders") or [])
        return cls(raw=base, profiles=resolved, extenders=base["extenders"])

    @classmethod
    def from_yaml(cls, text: str) -> "SchedulerConfiguration":
        # PyYAML is imported here only: the package loads without it
        import yaml

        d = yaml.safe_load(text)
        if d is not None and not isinstance(d, dict):
            raise ValueError("KubeSchedulerConfiguration YAML must be a mapping")
        if d is not None:
            kind = d.get("kind", "KubeSchedulerConfiguration")
            if kind != "KubeSchedulerConfiguration":
                raise ValueError(f"unexpected kind {kind!r}")
        return cls.from_dict(d)

    @classmethod
    def default(cls) -> "SchedulerConfiguration":
        return cls.from_dict(None)

    def to_dict(self) -> dict:
        return copy.deepcopy(self.raw)

    # -- resolved views for the engine -------------------------------------

    def profile(self, scheduler_name: str = "default-scheduler") -> dict:
        for p in self.profiles:
            if p["schedulerName"] == scheduler_name:
                return p
        return self.profiles[0]

    def enabled(self, extension_point: str, scheduler_name: str = "default-scheduler") -> list[str]:
        prof = self.profile(scheduler_name)
        return [p["name"] for p in prof["plugins"][extension_point]["enabled"]]

    def score_plugins(self, scheduler_name: str = "default-scheduler") -> list[tuple[str, int]]:
        """(name, weight) in order; a missing/zero weight runs as 1."""
        prof = self.profile(scheduler_name)
        return [
            (p["name"], int(p.get("weight") or 1))
            for p in prof["plugins"]["score"]["enabled"]
        ]

    def plugin_args(self, name: str, scheduler_name: str = "default-scheduler") -> dict:
        prof = self.profile(scheduler_name)
        for pc in prof["pluginConfig"]:
            if pc["name"] == name:
                return pc["args"]
        return {}

    def fingerprint(self) -> str:
        """Stable hash key for jit-cache invalidation on config changes."""
        return json.dumps(self.raw, sort_keys=True)
