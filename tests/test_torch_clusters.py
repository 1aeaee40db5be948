"""Clusters for the port's tests, and a check that they reach every path.

`rel_cluster` is the port's `synth.dressed_affinity_cluster` at a test's
size: `synthetic_affinity_cluster` dressed with every feature the slice's
plugins read (see its docstring). `chip_smoke.py` draws its affinity
cluster from the same generator, so the card's checks and these tests cover
the same features. This module imports no JAX, so the card's tests
(test_torch_cuda.py) use it too.
"""

import kube_scheduler_simulator_tpu_torch as kp
from kube_scheduler_simulator_tpu_torch.synth import DRESSED_NAMESPACES as NAMESPACES
from kube_scheduler_simulator_tpu_torch.synth import dressed_affinity_cluster


def rel_cluster(seed, n_nodes=24, n_pods=120):
    return dressed_affinity_cluster(n_nodes, n_pods, seed=seed)


def test_rel_cluster_reaches_every_path():
    nodes, pods = rel_cluster(1)
    enc = kp.encode_cluster(nodes, pods, kp.affinity_config(), namespaces=NAMESPACES,
                            device="cpu")
    a, rel = enc.arrays, enc.arrays.rel
    assert set(a.raff_op[a.raff_key >= 0].tolist()) >= {0, 1, 2, 3, 4, 5}
    assert bool(a.pod_has_raff.any()) and bool((a.nsel_key >= 0).any())
    assert bool((a.paff_weight > 0).any()) and bool(a.label_num_ok.any())
    assert bool((a.want_wild > 0).any()) and bool((a.want_trip > 0).any())
    assert bool(((a.img_contrib > 0).any(dim=0) & (a.pod_img > 0).any(dim=0)).any())
    assert int(a.pod_ncont.max()) == 2
    assert bool((rel.sph_key >= 0).any()) and bool((rel.sps_key >= 0).any())
    assert bool(rel.sps_host.any()) and bool(rel.req_all.any()) and not bool(rel.req_all.all())
    assert rel.sph_ctype.shape[2] >= 2 and rel.sph_cpairs.shape[3] >= 2
    assert bool((rel.sps_ctype == 4).any())  # a nil selector
    for d in ("ia", "ian", "ipa", "ipan"):
        assert bool((getattr(rel, f"{d}_key") >= 0).any()), d
        assert bool(getattr(rel, f"{d}_nsall").any()) or d == "ia", d
    assert bool((rel.ian_ctype == 4).any())  # Gt in a label selector
    assert rel.ia_ns.shape[2] == 2 and bool(rel.deleted.any())
    assert int((enc.state0.assignment >= 0).sum()) > 1
