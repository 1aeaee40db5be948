"""Synthetic cluster generator for benchmarks and `chip_smoke.py`.

Mirrors the workload shapes in BASELINE.json's configs (100 pods × 10
nodes … 100k pods × 10k nodes): heterogeneous node capacities, mixed pod
sizes, optional priorities — all Mi-granular so the 32-bit dtype policy is
exact (engine/encode.py TPU32). Same generator, same seed, same cluster as
the reference package's `synth.synthetic_cluster`.
"""

from __future__ import annotations

import random


def synthetic_cluster(
    n_nodes: int,
    n_pods: int,
    seed: int = 0,
    *,
    priorities: bool = False,
) -> tuple[list[dict], list[dict]]:
    rng = random.Random(seed)
    nodes = []
    for i in range(n_nodes):
        cores = rng.choice([4, 8, 16, 32, 64])
        nodes.append(
            {
                "metadata": {"name": f"node-{i}"},
                "status": {
                    "allocatable": {
                        "cpu": str(cores),
                        "memory": f"{cores * 4}Gi",
                        "pods": "110",
                    }
                },
            }
        )
    pods = []
    for i in range(n_pods):
        cpu_m = rng.choice([100, 250, 500, 1000, 2000])
        mem_mi = rng.choice([128, 256, 512, 1024, 2048])
        spec: dict = {
            "containers": [
                {
                    "name": "c",
                    "resources": {
                        "requests": {"cpu": f"{cpu_m}m", "memory": f"{mem_mi}Mi"}
                    },
                }
            ]
        }
        if priorities and rng.random() < 0.3:
            spec["priority"] = rng.randint(0, 100)
        pods.append(
            {
                "metadata": {"name": f"pod-{i}", "namespace": "default"},
                "spec": spec,
            }
        )
    return nodes, pods

