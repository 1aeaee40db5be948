"""Same-process A/B of two builds of the PyTorch port's kernel library.

Usage, on a machine with a CUDA card, from the root of a checkout:

    python3 tools/torch_kernel_ab.py OTHER_CHECKOUT [PAIRS]

Builds this checkout's kernel library and OTHER_CHECKOUT's (each with its
own `engine/cuda.py` `build()`, in two processes started together), then
times the kernels whose C interface the two share, through this
checkout's wrappers on the same inputs, switching the library between the
two: PAIRS pairs (default 8), the order alternating (A B, B A, ...), each
time the median over 3 repetitions of the mean of a few launches, from
CUDA events (chip_smoke.py's `events_ms`). The inputs are chip_smoke.py's
phase 5d and 5e shapes, TPU32:

  * round 1 of GangScheduler(chunk=64) on preemption_cluster(1024, 10000,
    seed=7) with supported_config(): gang_eval over the first 64 pending
    rows (one variant), gang_topk, gang_match and gang_bind at the round's
    shapes, and gang_eval stacked over 16 variants of every pending row;
  * sweep_run over phase 4g's first variants (config #4's weights, one
    variant a streaming multiprocessor) for the first 1,000 pods of
    synthetic_cluster(1024, 10000, seed=42).

Prints a line a kernel (A = this checkout, B = the other: their medians
over the pairs, the spread of each, the change B -> A), the card's name
and power limit, and, last, one JSON object with every time.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

BUILD = ("import sys; sys.path.insert(0, '.'); "
         "from kube_scheduler_simulator_tpu_torch.engine import cuda; print(cuda.build()[0])")


class Other:
    """The other checkout's library, each entry point typed as this
    checkout's is (the C interfaces are the same)."""

    def __init__(self, lib, mine):
        self._lib, self._mine = lib, mine

    def __getattr__(self, name):
        f, g = getattr(self._lib, name), getattr(self._mine, name)
        f.argtypes, f.restype = g.argtypes, g.restype
        return f


def build_both(other: Path) -> tuple:
    """Both libraries' paths, built at once."""
    procs = [subprocess.Popen([sys.executable, "-c", BUILD], cwd=d, stdout=subprocess.PIPE,
                              text=True) for d in (ROOT, other)]
    paths = []
    for p in procs:
        out, _ = p.communicate(timeout=900)
        if p.returncode:
            raise RuntimeError(f"a build failed ({p.returncode})")
        paths.append(Path(out.strip().splitlines()[-1]))
    return paths


def gang_inputs(kp, cuda):
    """Phase 5d's round-1 inputs, and 16 variants of it for the stacked form."""
    nodes, pods, objects = kp.preemption_cluster(1024, 10000, seed=7)
    enc = kp.encode_cluster(nodes, pods, kp.supported_config(), policy=kp.TPU32, **objects)
    g = kp.GangScheduler(enc, chunk=64)
    g._prep()  # the round inputs a run() prepares: queue, order, claims, carriers
    prog, a, w, st0 = g._base.program, enc.arrays, g.weights, enc.state0
    rows, count = g._pending(cuda.as_variants(st0), sort=True)
    rows, count = rows[0], count[:1]
    live64 = torch.tensor([64], dtype=torch.int32, device=enc.device)
    scores = cuda.gang_eval(prog, a, st0, w, rows, count, g._order)
    mw, C = g.match_width, a.pod_claim.shape[1]
    vals, idx = cuda.gang_topk(scores, count, mw)
    margs = (rows, count, g._order, g._claims, g._carrier, enc.N, C, g.inner_iters)
    sel, _ = cuda.gang_match(vals, idx, *margs)
    V = 16
    states = cuda.stack_states([st0] * V)
    rows_v, count_v = g._pending(states, sort=True)
    w_v = torch.stack([w * (1 + v % 3) for v in range(V)]).contiguous()
    st_b = st0.clone()
    return {
        "gang_eval (64 rows)": (lambda: cuda.gang_eval(prog, a, st0, w, rows, live64, g._order),
                                20),
        "gang_topk": (lambda: cuda.gang_topk(scores, count, mw), 5),
        "gang_match": (lambda: cuda.gang_match(vals, idx, *margs), 5),
        "gang_bind": (lambda: cuda.gang_bind(prog, a, st_b, rows, count, sel, g._order), 20),
        f"gang_eval ({V} variants x {rows_v.shape[1]} rows)": (
            lambda: cuda.gang_eval(prog, a, states, w_v, rows_v.contiguous(), count_v,
                                   g._order), 1),
    }


def sweep_inputs(kp, cuda, cs):
    """sweep_run over phase 4g's first variants, one a streaming
    multiprocessor, for the first 1,000 steps of config #4's queue."""
    enc = cs.config4_encoding(kp)
    prog = kp.WeightSweep(enc).sched.program
    V = torch.cuda.get_device_properties(0).multi_processor_count
    w = torch.as_tensor(cs.sweep_weights(kp, enc, V, seed=cs.SWEEP_SEED),
                        device=enc.device).to(prog.score_dtype).contiguous()
    states = cuda.stack_states([enc.state0] * V)
    q = torch.as_tensor(np.asarray(enc.queue[:1000], np.int32), device=enc.device)
    return {f"sweep_run ({V} variants x 1000 steps)": (
        lambda: cuda.sweep_run(prog, enc.arrays, states, q, w, record=False), 1)}


def main() -> int:
    if len(sys.argv) not in (2, 3) or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(sys.argv[1]).resolve()
    pairs = int(sys.argv[2]) if len(sys.argv) == 3 else 8
    import chip_smoke as cs
    import kube_scheduler_simulator_tpu_torch as kp
    from kube_scheduler_simulator_tpu_torch.engine import cuda

    mine_path, other_path = build_both(other)
    cuda.build = lambda: (mine_path, 0.0)
    mine = cuda.library()
    libs = {"A": mine, "B": Other(ctypes.CDLL(str(other_path)), mine)}
    cases = {**gang_inputs(kp, cuda), **sweep_inputs(kp, cuda, cs)}
    times = {name: {"A": [], "B": []} for name in cases}
    for i in range(pairs):
        for side in ("AB" if i % 2 == 0 else "BA"):
            cuda._LIB = libs[side]
            for name, (fn, iters) in cases.items():
                times[name][side].append(cs.events_ms(fn, iters, reps=3))
    cuda._LIB = mine
    smi = cs.nvidia_smi()
    for name, t in times.items():
        a, b = statistics.median(t["A"]), statistics.median(t["B"])
        spread = {s: (max(v) - min(v)) / statistics.median(v) * 100 for s, v in t.items()}
        print(f"{name:40s} A {a:.6f} ms (spread {spread['A']:.2f}%)  B {b:.6f} ms (spread "
              f"{spread['B']:.2f}%)  A/B {a / b:.4f} [{smi}]")
    print(smi)
    print(json.dumps({"pairs": pairs, "a": str(ROOT), "b": str(other), "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
