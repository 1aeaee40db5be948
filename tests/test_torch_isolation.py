"""The PyTorch port stands alone: it imports neither JAX nor the reference
package, it runs on the card unless told otherwise, and its kernel wrappers
take their plain versions only for tensors on the CPU."""

import ast
import pathlib
import re
import pkgutil
import subprocess
import sys

import pytest
import torch

import kube_scheduler_simulator_tpu_torch as kp
from kube_scheduler_simulator_tpu_torch.engine import cuda
from kube_scheduler_simulator_tpu_torch.engine.gang import _TenantRounds

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
    # the walk reaches every module: the sweep's, the batch runner's, the
    # session plane's, the batch plane's and the fault sweep's too
    names = {m.name for m in pkgutil.walk_packages(kp.__path__, kp.__name__ + ".")}
    assert {"kube_scheduler_simulator_tpu_torch.parallel.sweep",
            "kube_scheduler_simulator_tpu_torch.scenario.batch",
            "kube_scheduler_simulator_tpu_torch.server.sessions",
            "kube_scheduler_simulator_tpu_torch.server.batchplane",
            "kube_scheduler_simulator_tpu_torch.lifecycle.faultsweep",
            "kube_scheduler_simulator_tpu_torch.utils.prng",
            "kube_scheduler_simulator_tpu_torch.plugins.networkbandwidth",
            "kube_scheduler_simulator_tpu_torch.plugins.nodenumber"} <= names


def test_no_module_imports_jax_or_the_reference():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for new in ("parallel/sweep.py", "scenario/batch.py",  # the sixth slice's
                "server/sessions.py", "server/batchplane.py",  # the session and batch planes
                "lifecycle/faultsweep.py", "utils/prng.py",  # the fault sweep's
                "engine/packing.py",  # the PACKED policy's
                "plugins/__init__.py", "plugins/networkbandwidth.py",  # the demo plugins'
                "plugins/nodenumber.py"):
        assert PORT / new in files, new
    # the CUDA sources include the toolkit's headers and their own only
    for src in sorted((PORT / "csrc").glob("*.cu")):
        for inc in re.findall(r'#include [<"]([^>"]+)[>"]', src.read_text()):
            assert inc in ("cuda_runtime.h", "stdint.h", "climits", "type_traits") or (
                PORT / "csrc" / inc).exists(), (src.name, inc)
    assert cuda.PACK_CSRC.exists() and cuda.PACK_CSRC.parent == PORT / "csrc"
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
    enc = kp.encode_cluster(nodes, pods, kp.affinity_config(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        kp.BatchedScheduler(enc)
    for engine in (kp.GangScheduler, kp.GangSweep, kp.WeightSweep, kp.FaultSweep):
        with pytest.raises(RuntimeError, match="CUDA"):
            engine(enc)
    for plane in (kp.SessionManager, kp.SimulatorService):
        with pytest.raises(RuntimeError, match="CUDA"):
            plane()


def test_wrappers_take_plain_versions_on_cpu_tensors(monkeypatch):
    def no_library():
        raise AssertionError("the kernel library was asked for on CPU tensors")

    monkeypatch.setattr(cuda, "library", no_library)
    nodes, pods = port_cluster(1, n_nodes=8, n_pods=12)
    eng = kp.BatchedScheduler(
        kp.encode_cluster(nodes, pods, kp.supported_config(), device="cpu"), device="cpu"
    )
    cuda.reset_counts()
    a, state, p = eng.enc.arrays, eng.enc.state0.clone(), int(eng.enc.queue[0])
    _, _, _, _, sel, _ = eng.attempt_fn(a, state, eng.weights, p)
    eng.bind_fn(a, state, p, sel, 0)
    eng.preempt_fn(a, state, p)
    eng.evict_fn(a, state, state.assignment >= 0)
    eng.run()
    # the gang engine's four (K9), once each
    g = kp.GangScheduler(eng.enc, device="cpu")
    g._prep()
    rows = torch.as_tensor(eng.enc.queue[:4], dtype=torch.int32)
    live = torch.tensor([4], dtype=torch.int32)
    scores = cuda.gang_eval(eng.program, a, state, eng.weights, rows, live, g._order)
    vals, idx = cuda.gang_topk(scores, live, 2)
    sel, stat = cuda.gang_match(vals, idx, rows, live, g._order, g._claims, g._carrier,
                                eng.enc.N, a.pod_claim.shape[1], 8)
    cuda.gang_bind(eng.program, a, state, rows, live, sel, g._order)
    # the counted loops' two (the counted matching, the round accounting)
    cuda.gang_match(vals, idx, rows, live, g._order, g._claims, g._carrier, eng.enc.N,
                    a.pod_claim.shape[1], 8, counted=True)
    cuda.gang_advance(stat[None], torch.zeros((len(cuda.ADVANCE_ROWS), 1), dtype=torch.int32),
                      0, eng.enc.P)
    # the weight sweep's (K11), once
    kp.WeightSweep(eng.enc, device="cpu").run([eng.weights.numpy()] * 2)
    # the batch plane's tenant forms (K11 batch.seq.run / batch.gang.run), once
    t = _TenantRounds([g, kp.GangScheduler(eng.enc, device="cpu")])
    states = cuda.stack_states([eng.enc.state0] * 2)
    w2 = torch.stack([eng.weights] * 2)
    rows2, live2 = torch.stack([rows] * 2), torch.tensor([4, 2], dtype=torch.int32)
    cuda.batch_run(t._progs, t._arrays, states, torch.stack([t._queue[0]] * 2), w2,
                   record=False)
    cuda.batch_seg(t._progs, t._arrays, states, rows2, w2, t._orders.gather(1, rows2.long()))
    scores = cuda.batch_eval(t._progs, t._arrays, states, w2, rows2, live2, t._orders)
    sel, _ = cuda.batch_match(scores, None, rows2, live2, t._orders, t._claims, t._carriers,
                              eng.enc.N, a.pod_claim.shape[1], 8)
    cuda.batch_match(scores, None, rows2, live2, t._orders, t._claims, t._carriers, eng.enc.N,
                     a.pod_claim.shape[1], 8, counted=True)
    cuda.batch_bind(t._progs, t._arrays, states, rows2, live2, sel, t._orders)
    # the fault sweep's prologue and counters (K11 faultsweep.*), once
    fail = torch.ones((2, eng.enc.N), dtype=torch.bool)
    evict, evicted, _ = cuda.fault_evict(eng.program, a, states, fail)
    cuda.fault_tally(states.assignment, evict, evicted)
    # the PACKED policy's widening (K8), once
    cuda.pack_widen([torch.zeros((3, 1), dtype=torch.int32), torch.zeros(4, dtype=torch.int16)],
                    [9, 0])
    assert cuda.PLAIN_CALLS == dict.fromkeys(cuda.KERNELS, 1)
    assert cuda.LAUNCHES == dict.fromkeys(cuda.KERNELS, 0)


def test_wrappers_refuse_tensors_they_cannot_take():
    nodes, pods = port_cluster(1, n_nodes=8, n_pods=12)
    eng = kp.BatchedScheduler(
        kp.encode_cluster(nodes, pods, kp.affinity_config(), device="cpu"), device="cpu"
    )
    meta = eng.enc.arrays.to(torch.device("meta"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda.seq_attempt(eng.program, meta, eng.enc.state0.to(torch.device("meta")),
                         eng.weights.to("meta"), 0)


def test_supported_config_is_the_references():
    """The port's whole set equals the reference's: the default profile,
    every plugin of it with a kernel; the earlier slices' sets stay."""
    from kube_scheduler_simulator_tpu.engine.engine import supported_config as ref_supported
    from kube_scheduler_simulator_tpu.engine.engine import unsupported_plugins as ref_missing
    from kube_scheduler_simulator_tpu.sched.config import SchedulerConfiguration as JConfig

    from kube_scheduler_simulator_tpu_torch.engine.engine import unsupported_plugins
    from kube_scheduler_simulator_tpu_torch.sched.config import SchedulerConfiguration

    assert kp.supported_config().to_dict() == ref_supported().to_dict()
    assert kp.slice_config().to_dict() == kp.supported_config().to_dict()
    assert unsupported_plugins(SchedulerConfiguration.default()) == []
    assert ref_missing(JConfig.default()) == []
    dflt = SchedulerConfiguration.default()
    for point in ("preFilter", "filter", "postFilter", "preScore", "score"):
        assert kp.supported_config().enabled(point) == dflt.enabled(point), point
    # the affinity path: the default profile without volumes and preemption
    aff = kp.affinity_config()
    assert aff.enabled("postFilter") == [] and "VolumeBinding" not in aff.enabled("filter")
    assert len(aff.enabled("filter")) == 8 and len(aff.score_plugins()) == 7


def test_gang_sweep_takes_plain_versions_on_cpu(monkeypatch):
    """GangSweep on CPU tensors: the stacked K9 wrappers and the segmented
    sweep_run take their plain versions, one call a round or phase for
    every variant, and the library is never asked for."""
    def no_library():
        raise AssertionError("the kernel library was asked for on CPU tensors")

    monkeypatch.setattr(cuda, "library", no_library)
    nodes, pods, objects = kp.preemption_cluster(4, 12, seed=2)
    enc = kp.encode_cluster(nodes, pods, kp.supported_config(), device="cpu", **objects)
    base = kp.weights_for(enc, {})
    cuda.reset_counts()
    sweep = kp.GangSweep(enc, device="cpu")
    sweep.run([base, base + 1, base * 2])
    st = sweep.last_stats
    assert cuda.PLAIN_CALLS["gang_eval"] == cuda.PLAIN_CALLS["gang_bind"] == (
        st["host_syncs"] - st["phases"])
    assert cuda.PLAIN_CALLS["sweep_run"] == st["phases"] > 0
    assert cuda.LAUNCHES == dict.fromkeys(cuda.KERNELS, 0)
