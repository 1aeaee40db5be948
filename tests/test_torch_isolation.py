"""The PyTorch port stands alone: it imports neither JAX nor the reference
package, it runs on the card unless told otherwise, and its kernel wrappers
take their plain versions only for tensors on the CPU."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

import kube_scheduler_simulator_tpu_torch as kp
from kube_scheduler_simulator_tpu_torch.engine import cuda

from test_torch_encode import port_cluster

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "kube_scheduler_simulator_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "chex", "kube_scheduler_simulator_tpu")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def test_import_leaves_jax_and_reference_out():
    code = (
        "import importlib, pkgutil, sys\n"
        "import kube_scheduler_simulator_tpu_torch as kp\n"
        "for m in pkgutil.walk_packages(kp.__path__, kp.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'chex', 'kube_scheduler_simulator_tpu', 'yaml', 'triton'))\n"
        "print(','.join(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_no_module_imports_jax_or_the_reference():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad = [n for n in names if _forbidden(n)]
            assert not bad, f"{path.relative_to(REPO)}:{node.lineno} imports {bad}"


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    nodes, pods = port_cluster(0, n_nodes=3, n_pods=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        kp.schedule(nodes, pods)
    with pytest.raises(RuntimeError, match="CUDA"):
        kp.encode_cluster(nodes, pods)
    enc = kp.encode_cluster(nodes, pods, kp.slice_config(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        kp.BatchedScheduler(enc)


def test_wrappers_take_plain_versions_on_cpu_tensors(monkeypatch):
    def no_library():
        raise AssertionError("the kernel library was asked for on CPU tensors")

    monkeypatch.setattr(cuda, "library", no_library)
    nodes, pods = port_cluster(1, n_nodes=8, n_pods=12)
    eng = kp.BatchedScheduler(
        kp.encode_cluster(nodes, pods, kp.slice_config(), device="cpu"), device="cpu"
    )
    cuda.reset_counts()
    a, state, p = eng.enc.arrays, eng.enc.state0.clone(), int(eng.enc.queue[0])
    _, _, _, _, sel, _ = eng.attempt_fn(a, state, eng.weights, p)
    eng.bind_fn(a, state, p, sel, 0)
    eng.run()
    assert cuda.PLAIN_CALLS == {"seq_attempt": 1, "seq_bind": 1, "seq_run": 1}
    assert cuda.LAUNCHES == {"seq_attempt": 0, "seq_bind": 0, "seq_run": 0}


def test_wrappers_refuse_tensors_they_cannot_take():
    nodes, pods = port_cluster(1, n_nodes=8, n_pods=12)
    eng = kp.BatchedScheduler(
        kp.encode_cluster(nodes, pods, kp.slice_config(), device="cpu"), device="cpu"
    )
    meta = eng.enc.arrays.to(torch.device("meta"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda.seq_attempt(eng.program, meta, eng.enc.state0.to(torch.device("meta")),
                         eng.weights.to("meta"), 0)
