"""Time one path of two checkouts of the port on one card, A B B A.

    python -m kube_scheduler_simulator_tpu_torch.abtime OTHER_ROOT [fit|affinity|default]

runs, in a fresh process for each and in the order this checkout, OTHER,
OTHER, this checkout, the same measurement against each checkout's own
package, TPU32, trace recorded, on the path named (fit by default):

  * fit: `synthetic_cluster(1024, 10000, seed=7)` under `fit_config()`
    (`slice_config()` where a checkout has no `fit_config`);
  * affinity: BASELINE config #3, `synthetic_affinity_cluster(500, 5000,
    seed=11)`, under `affinity_config()` (`slice_config()` where a
    checkout has no `affinity_config`: the second slice's set);
  * default: `preemption_cluster(1024, 10000, seed=7)` under
    `supported_config()`, the reference's whole default profile (both
    checkouts need `preemption_cluster`) —


  * `run_ms`: `seq_run` over the bucket-padded queue, CUDA events around
    one launch, median of 5 after one warm-up;
  * `schedule_s`: `schedule()` wall time (encode, pass, decode of 100
    pods), median of 3 after one warm-up;
  * `step_s`: the single-pod step path (`attempt_bind_fn`, one
    `seq_attempt` and one `seq_bind` launch a pod) over the whole queue,
    host wall time to the last synchronize; not on the default path, whose
    steps also preempt (null there).

Each process builds its checkout's kernels into that checkout's
build/kernels/. One JSON line per run, then one with the medians of each
checkout and the card's name and power limit from `nvidia-smi`. Needs one
CUDA card and imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# run in each checkout's root, importing that checkout's package
MEASURE = r"""
import json, statistics, time
import numpy as np, torch
import kube_scheduler_simulator_tpu_torch as kp

objects = {}
if PATH == "fit":
    cfg = kp.fit_config() if hasattr(kp, "fit_config") else kp.slice_config()
    n_pods, seed = 10000, 7
    nodes, pods = kp.synthetic_cluster(1024, n_pods, seed=seed)
elif PATH == "default":
    cfg = kp.supported_config()
    n_pods, seed = 10000, 7
    nodes, pods, objects = kp.preemption_cluster(1024, n_pods, seed=seed)
else:
    cfg = kp.affinity_config() if hasattr(kp, "affinity_config") else kp.slice_config()
    n_pods, seed = 5000, 11
    nodes, pods = kp.synthetic_affinity_cluster(500, n_pods, seed=seed)
rng = np.random.default_rng(seed)
sample = {("default", f"pod-{i}") for i in rng.choice(n_pods, 100, replace=False)}

def wall(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0

run = lambda: kp.schedule(nodes, pods, config=cfg, policy=kp.TPU32, decode=sample, **objects)
run()
schedule_s = statistics.median(wall(run) for _ in range(3))
enc = kp.encode_cluster(nodes, pods, cfg, policy=kp.TPU32, **objects)
eng = kp.BatchedScheduler(enc)
q = enc.queue
queue = torch.as_tensor(np.concatenate([q, np.full(eng.queue_bucket(len(q)) - len(q), -1)])
                        .astype(np.int32), device=eng.device)
seq_run = eng.run_fn
seq_run(enc.arrays, enc.state0, queue, eng.weights)
times = []
for _ in range(5):
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    seq_run(enc.arrays, enc.state0, queue, eng.weights)
    e1.record()
    torch.cuda.synchronize()
    times.append(e0.elapsed_time(e1))

def steps():
    st = enc.state0.clone()
    for qi, p in enumerate(q.tolist()):
        st = eng.attempt_bind_fn(enc.arrays, st, eng.weights, p, qi)[-1]

print(json.dumps({"run_ms": statistics.median(times), "schedule_s": schedule_s,
                  "step_s": None if PATH == "default" else wall(steps), "steps": len(q)}))
"""


def measure(root: Path, path: str) -> dict:
    code = f"PATH = {path!r}\n" + MEASURE
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"measurement in {root} failed ({out.returncode}):\n{out.stderr}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv: list[str]) -> int:
    if len(argv) not in (1, 2) or argv[1:] not in ([], ["fit"], ["affinity"], ["default"]):
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(argv[0]).resolve()
    path = argv[1] if len(argv) == 2 else "fit"
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    runs: dict[str, list[dict]] = {"this": [], "other": []}
    for name in ("this", "other", "other", "this"):
        r = measure(ROOT if name == "this" else other, path)
        runs[name].append(r)
        print(json.dumps({"checkout": name, "path": path, **r, "card": card}), flush=True)
    print(json.dumps({
        "card": card, "path": path, "this": str(ROOT), "other": str(other),
        **{f"{name}_{k}": statistics.median(r[k] for r in rs) if rs[0][k] is not None else None
           for name, rs in runs.items() for k in ("run_ms", "schedule_s", "step_s")},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
