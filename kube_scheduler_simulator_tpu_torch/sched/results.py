"""Per-pod scheduling result records — the decision trace.

The reference's core product is the per-pod, per-node, per-plugin record of
every framework phase, serialized onto 13 pod annotations (reference:
simulator/scheduler/plugin/resultstore/store.go:39-86 for the shapes,
simulator/scheduler/plugin/annotation/annotation.go:3-30 for the keys). Here
the record is a first-class object emitted by the engine itself — there is no
informer/reflector race to work around (SURVEY.md §2 #10) — and
`to_annotations()` reproduces the reference's exact annotation wire format so
the reference web UI can render our traces.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

PASSED_FILTER_MESSAGE = "passed"
SUCCESS_MESSAGE = "success"
WAIT_MESSAGE = "wait"


def go_duration(seconds: float) -> str:
    """`time.Duration.String()` for the permit-timeout annotation
    (resultstore store.go:544-555 records `timeout.String()`): "0s",
    sub-second values in ns/µs/ms, otherwise "[Xh][Ym]Zs" with the
    fraction's trailing zeros trimmed."""
    ns = round(seconds * 1e9)
    if ns == 0:
        return "0s"

    def frac(value: float) -> str:
        s = f"{value:.9f}".rstrip("0").rstrip(".")
        return s

    if ns < 1_000:
        return f"{ns}ns"
    if ns < 1_000_000:
        return f"{frac(ns / 1_000)}µs"
    if ns < 1_000_000_000:
        return f"{frac(ns / 1_000_000)}ms"
    total_s = ns / 1e9
    h = int(total_s // 3600)
    m = int((total_s - h * 3600) // 60)
    s = total_s - h * 3600 - m * 60
    out = ""
    if h:
        out += f"{h}h"
    if m or h:
        out += f"{m}m"
    out += f"{frac(s)}s"
    return out


def record_bind_points(
    config,
    res: "PodSchedulingResult",
    permit: "dict[str, tuple[str, float]] | None" = None,
) -> None:
    """Record the post-selection extension points for a scheduled pod —
    one status per *enabled* plugin at each point, as the reference's
    wrapped plugins do (wrappedplugin.go:549-695: Reserve/Permit/PreBind/
    Bind/PostBind each record per registered plugin). None of the
    simulator-supported plugins can fail these points in-process (no real
    volume provisioning), so statuses default to "success".

    `permit`: optional {plugin name: (message, timeout_seconds)} from
    custom permit kernels (kernels.PERMIT_PLUGINS) — the reference's
    AddPermitResult records BOTH the status ("success" / "wait" / error
    message) and the timeout as a Go duration string
    (wrappedplugin.go:549-575, store.go:544-555); plugins without an
    entry record success with timeout 0."""
    for name in config.enabled("reserve"):
        res.reserve[name] = SUCCESS_MESSAGE
    for name in config.enabled("permit"):
        msg, timeout_s = (permit or {}).get(name, (SUCCESS_MESSAGE, 0.0))
        res.permit[name] = msg
        res.permit_timeout[name] = go_duration(timeout_s)
    for name in config.enabled("preBind"):
        res.prebind[name] = SUCCESS_MESSAGE
    for name in config.enabled("bind"):
        res.bind[name] = SUCCESS_MESSAGE

ANNOTATION_KEYS = {
    "pre_filter_status": "scheduler-simulator/prefilter-result-status",
    "pre_filter_result": "scheduler-simulator/prefilter-result",
    "filter": "scheduler-simulator/filter-result",
    "post_filter": "scheduler-simulator/postfilter-result",
    "pre_score": "scheduler-simulator/prescore-result",
    "score": "scheduler-simulator/score-result",
    "final_score": "scheduler-simulator/finalscore-result",
    "reserve": "scheduler-simulator/reserve-result",
    "permit": "scheduler-simulator/permit-result",
    "permit_timeout": "scheduler-simulator/permit-result-timeout",
    "prebind": "scheduler-simulator/prebind-result",
    "bind": "scheduler-simulator/bind-result",
    "selected_node": "scheduler-simulator/selected-node",
}


@dataclass
class PodSchedulingResult:
    """Everything recorded while scheduling one pod."""

    pod_namespace: str = "default"
    pod_name: str = ""
    selected_node: str = ""
    # plugin → status message
    pre_filter_status: dict[str, str] = field(default_factory=dict)
    # plugin → surviving node names (framework.PreFilterResult)
    pre_filter_result: dict[str, list[str]] = field(default_factory=dict)
    # plugin → status message
    pre_score: dict[str, str] = field(default_factory=dict)
    # node → plugin → "passed" | reason
    filter: dict[str, dict[str, str]] = field(default_factory=dict)
    # node → plugin → message
    post_filter: dict[str, dict[str, str]] = field(default_factory=dict)
    # node → plugin → raw score (stringified int)
    score: dict[str, dict[str, str]] = field(default_factory=dict)
    # node → plugin → normalized×weighted score (stringified int)
    final_score: dict[str, dict[str, str]] = field(default_factory=dict)
    # plugin → message
    permit: dict[str, str] = field(default_factory=dict)
    permit_timeout: dict[str, str] = field(default_factory=dict)
    reserve: dict[str, str] = field(default_factory=dict)
    prebind: dict[str, str] = field(default_factory=dict)
    bind: dict[str, str] = field(default_factory=dict)
    # engine-level outcome (not an annotation): Scheduled | Unschedulable | Nominated
    status: str = ""
    nominated_node: str = ""
    preemption_victims: list[str] = field(default_factory=list)

    def add_filter(self, node: str, plugin: str, msg: str):
        self.filter.setdefault(node, {})[plugin] = msg

    def add_score(self, node: str, plugin: str, value: int):
        self.score.setdefault(node, {})[plugin] = str(value)

    def add_final_score(self, node: str, plugin: str, value: int):
        self.final_score.setdefault(node, {})[plugin] = str(value)

    def to_annotations(self) -> dict[str, str]:
        """The 13 reference annotation payloads (JSON-in-string values)."""
        return {
            ANNOTATION_KEYS["pre_filter_status"]: json.dumps(self.pre_filter_status),
            ANNOTATION_KEYS["pre_filter_result"]: json.dumps(self.pre_filter_result),
            ANNOTATION_KEYS["filter"]: json.dumps(self.filter),
            ANNOTATION_KEYS["post_filter"]: json.dumps(self.post_filter),
            ANNOTATION_KEYS["pre_score"]: json.dumps(self.pre_score),
            ANNOTATION_KEYS["score"]: json.dumps(self.score),
            ANNOTATION_KEYS["final_score"]: json.dumps(self.final_score),
            ANNOTATION_KEYS["reserve"]: json.dumps(self.reserve),
            ANNOTATION_KEYS["permit"]: json.dumps(self.permit),
            ANNOTATION_KEYS["permit_timeout"]: json.dumps(self.permit_timeout),
            ANNOTATION_KEYS["prebind"]: json.dumps(self.prebind),
            ANNOTATION_KEYS["bind"]: json.dumps(self.bind),
            ANNOTATION_KEYS["selected_node"]: self.selected_node,
        }
