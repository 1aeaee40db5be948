"""NodeNumber — the documentation example custom plugin, on the card.

Re-derivation of the reference's tutorial plugin
(simulator/docs/how-to-use-custom-plugins/nodenumber/plugin.go:1-146):
score 10 for a node whose name's trailing digit equals the pod name's
trailing digit, else 0; a typed `reverse` arg flips the match. It teaches
the registration pattern at its minimum: one score body (the plain one
here, `S_NODENUM` in csrc/seq_kernels.cu on the card), no extra state,
featurization done by the builder from the raw manifests (see
plugins/networkbandwidth.py for the full pattern with filter + preemption
row).
"""

from __future__ import annotations

import numpy as np
import torch

SCORE_MATCH = 10

# the score body's id in csrc/seq_kernels.cu (its S_* enum)
S_NODENUM = 8


def _trailing_digit(name: str) -> "int | None":
    return int(name[-1]) if name and name[-1].isdigit() else None


def _reverse_from_config(config) -> bool:
    """The typed plugin arg (plugin.go NodeNumberArgs.Reverse), read from
    the profile's pluginConfig like any in-tree args object."""
    args = config.plugin_args("NodeNumber") if config is not None else None
    return bool((args or {}).get("reverse", False))


def _digits(enc):
    """(node digits [N] int32, -1: none; pod digits [P] int32, -2: none) on
    the encoding's device."""
    node_digit = np.full(enc.N, -1, np.int32)
    for i, name in enumerate(enc.node_names[: enc.n_nodes]):
        d = _trailing_digit(name)
        if d is not None:
            node_digit[i] = d
    pod_digit = np.full(enc.P, -2, np.int32)
    for i, p in enumerate(enc.pods):
        d = _trailing_digit(p["metadata"]["name"])
        if d is not None:
            pod_digit[i] = d
    return torch.as_tensor(node_digit).to(enc.device), torch.as_tensor(pod_digit).to(enc.device)


def build_nn_score(enc):
    """The plain score body (the CPU's)."""
    score_dt = enc.policy.score
    nd, pd = _digits(enc)
    reverse = _reverse_from_config(enc.config)

    def kernel(a, s, p, feasible=None):
        both = (nd >= 0) & (pd[p] >= 0)
        matched = nd == pd[p]
        if reverse:
            matched = ~matched
        return (both & matched).to(score_dt) * SCORE_MATCH

    return kernel


def _compile_statics(enc) -> tuple:
    node_digits = tuple(
        _trailing_digit(n) for n in enc.node_names[: enc.n_nodes]
    )
    pod_digits = tuple(
        _trailing_digit(p["metadata"]["name"]) for p in enc.pods
    )
    return (node_digits, pod_digits, _reverse_from_config(enc.config))


def _device_inputs(enc) -> dict:
    nd, pd = _digits(enc)
    return {"nn_node": nd, "nn_pod": pd, "nn_reverse": int(_reverse_from_config(enc.config))}


def register() -> None:
    """Idempotently register the score body, its inputs and statics."""
    from ..engine import kernels as K

    K.SCORE_KERNELS["NodeNumber"] = (build_nn_score, None, S_NODENUM)
    K.COMPILE_STATICS["NodeNumber"] = _compile_statics
    K.DEVICE_INPUTS["NodeNumber"] = _device_inputs


register()
