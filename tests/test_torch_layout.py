"""The kernels' structs (csrc/seq_layout.h) against engine/cuda.py's ctypes
mirror, on the CPU.

The header holds no device code, so the host's C++ compiler builds it into
a small library here; the tests read its layout report the way
`cuda.library()` does on the card and fill the structs from CPU tensors.
Skipped where no `g++` is found. Tolerance: exact (pointers, sizes, names).
"""

import ctypes
import shutil
import subprocess

import pytest
import torch

import kube_scheduler_simulator_tpu_torch as kp
from kube_scheduler_simulator_tpu_torch.engine import cuda, encode_rel

from test_torch_clusters import NAMESPACES, rel_cluster


@pytest.fixture(scope="module")
def layout_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build csrc/seq_layout.h on the host")
    d = tmp_path_factory.mktemp("layout")
    src = d / "layout.cpp"
    src.write_text(f'#include "{cuda.LAYOUT_H}"\n')
    lib_path = d / "liblayout.so"
    subprocess.run([gxx, "-std=c++17", "-shared", "-fPIC", "-o", str(lib_path), str(src)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.seq_layout.restype = ctypes.c_char_p
    lib.seq_cfg_counts.argtypes = [ctypes.c_void_p]
    return lib


@pytest.fixture
def mirror(layout_lib, monkeypatch):
    """cuda's struct mirror from the host-built report, with a library
    whose workspace is 8 bytes (the workspace layout is device code)."""
    layout = cuda._Layout(layout_lib.seq_layout().decode())

    class Lib:
        @staticmethod
        def seq_workspace_bytes(planes, int_bytes, vbound):
            return 8

    monkeypatch.setattr(cuda, "_LAYOUT", layout)
    monkeypatch.setattr(cuda, "_LIB", Lib())
    return layout


def test_layout_report_matches_mirror(layout_lib, mirror):
    counts = (ctypes.c_int * len(cuda._CFG_FIELDS))()
    assert layout_lib.seq_cfg_counts(counts) == len(cuda._CFG_FIELDS)
    assert list(counts) == [c for _, c in cuda._CFG_FIELDS]
    assert layout_lib.seq_planes_bytes() == ctypes.sizeof(mirror.Planes)
    assert layout_lib.seq_state_bytes() == ctypes.sizeof(mirror.State)
    assert layout_lib.seq_trace_bytes() == ctypes.sizeof(mirror.Trace)
    assert layout_lib.seq_stride_bytes() == (ctypes.sizeof(mirror.StateStride)
                                             + ctypes.sizeof(mirror.TraceStride))
    assert mirror.names["term_domains"] == encode_rel.DOMAINS
    assert mirror.names["state_ptrs"] == cuda._STATE_FIELDS
    assert set(mirror.names["plane_ptrs"]) <= set(cuda._SPEC)


@pytest.mark.parametrize("policy", ["i32", "exact"])
def test_planes_point_at_their_tensors(mirror, policy):
    pol = {"i32": kp.TPU32, "exact": kp.EXACT}[policy]
    nodes, pods = rel_cluster(2, 16, 48)
    enc = kp.encode_cluster(nodes, pods, kp.affinity_config(), policy=pol, namespaces=NAMESPACES,
                            device="cpu")
    prog = kp.BatchedScheduler(enc, device="cpu").program
    a, rel = enc.arrays, enc.arrays.rel
    b = cuda._planes(prog, a)
    pl = b.planes
    for name in mirror.names["plane_ptrs"]:
        t = getattr(a, name, None)
        t = getattr(rel, name) if t is None else t
        assert getattr(pl, name) == t.data_ptr(), name
    assert pl.raff.term_valid == a.raff_term_valid.data_ptr()
    assert pl.paff.weight == a.paff_weight.data_ptr() and pl.raff.weight is None
    assert (pl.raff.TM, pl.paff.TM, pl.raff.E, pl.raff.VV) == (
        a.raff_key.shape[1], a.paff_key.shape[1], a.raff_key.shape[2], a.raff_vals.shape[3])
    for d in encode_rel.DOMAINS:
        terms = getattr(pl, d)
        assert terms.key == getattr(rel, f"{d}_key").data_ptr(), d
        assert terms.cpairs == getattr(rel, f"{d}_cpairs").data_ptr(), d
        assert (terms.T, terms.C, terms.VP) == tuple(getattr(rel, f"{d}_cpairs").shape[1:]), d
    assert pl.ia.flag == rel.ia_self.data_ptr() and pl.sps.flag == rel.sps_host.data_ptr()
    assert pl.ipa.weight == rel.ipa_weight.data_ptr() and pl.ia.weight is None
    assert pl.sph.nsall is None and pl.ian.nsall == rel.ian_nsall.data_ptr()
    assert (pl.N, pl.P, pl.NP1) == (enc.N, enc.P, prog.np1)
    assert b.suffix == ("i32" if policy == "i32" else "i64")


def test_planes_checked_once_per_pair(mirror):
    nodes, pods = rel_cluster(3, 16, 40)
    enc = kp.encode_cluster(nodes, pods, kp.affinity_config(), namespaces=NAMESPACES,
                            device="cpu")
    prog = kp.BatchedScheduler(enc, device="cpu").program
    a = enc.arrays
    b = cuda._planes(prog, a)
    assert cuda._planes(prog, a) is b and list(prog.bound.values()) == [b]
    a.node_alloc = a.node_alloc.clone()  # a new tensor: checked and packed again
    b2 = cuda._planes(prog, a)
    assert b2 is not b and b2.planes.node_alloc == a.node_alloc.data_ptr()
    assert list(prog.bound.values()) == [b2]
    a.rel.sph_key = a.rel.sph_key[:, :0]
    with pytest.raises(ValueError, match="sph_key"):
        cuda._planes(prog, a)


def test_check_refuses_cpu_and_checks_state(mirror):
    nodes, pods = rel_cluster(3, 16, 40)
    enc = kp.encode_cluster(nodes, pods, kp.affinity_config(), namespaces=NAMESPACES,
                            device="cpu")
    prog = kp.BatchedScheduler(enc, device="cpu").program
    a, dt = enc.arrays, prog.score_dtype
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda._check(prog, a, enc.state0)
    b = cuda._planes(prog, a)
    st = enc.state0.clone()
    state = cuda._state(b, st, a.node_mask.device, dt)
    assert state.assignment == st.assignment.data_ptr()
    assert state.requested == st.requested.data_ptr()
    assert cuda._state(b, st, a.node_mask.device, dt) is state
    st.n_pods = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="n_pods"):
        cuda._state(b, st, a.node_mask.device, dt)
