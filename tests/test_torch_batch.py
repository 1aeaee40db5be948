"""The port's batch runner (KEP-159/184, cut to sweep jobs) against the
reference's.

The same job specs go through the JAX package's `scenario.batch` and the
port's (`device="cpu"`): sweep jobs must give result JSON equal key for key
(per variant: weights, scheduled and unschedulable counts, every
placement), in memory and in the result files; `load_jobs` must read the
same jobs and parse errors from a directory; `main()` must exit as the
reference's does. Sweep specs: test_batch.py's fit-only three-node sweep,
and the contended four nodes under the default profile (no
schedulerConfig: every variant preempts), each also with `engine: gang`
(the gang weight sweep, `GangSweep`). The port's own outcome: a scenario
job is a `Failed` result naming NotImplementedError while the rest of the
batch runs. Tolerance: exact equality.
"""

import json

import pytest

from kube_scheduler_simulator_tpu.scenario import batch as jbatch

from kube_scheduler_simulator_tpu_torch.scenario import batch as pbatch

from helpers import node, pod
from test_batch import _scenario_spec, _sweep_spec


def default_sweep_spec():
    """The default profile (no schedulerConfig) on four full nodes: the
    high-priority pods preempt in every variant."""
    nodes = [node(f"n{i}", cpu="2", pods="8") for i in range(4)]
    pods = [pod(f"low-{i}", cpu="1500m", priority=1, node_name=f"n{i}") for i in range(4)]
    pods += [pod(f"high-{i}", cpu="1200m", priority=100) for i in range(3)]
    return {
        "kind": "sweep",
        "snapshot": {"nodes": nodes, "pods": pods},
        "weightVariants": [{}, {"NodeResourcesFit": 10}, {"TaintToleration": 3,
                                                          "NodeResourcesBalancedAllocation": 7}],
    }


def gang_spec(spec):
    """`spec` through the gang engine (`engine: gang`)."""
    def make():
        out = spec()
        out["engine"] = "gang"
        return out
    return make


SPECS = {"fit": _sweep_spec, "default": default_sweep_spec}
GANG_SPECS = {"gang-fit": gang_spec(_sweep_spec)}
_REFERENCE: dict = {}


def reference_result(name):
    """The reference's run_batch result of one sweep spec, run once."""
    if name not in _REFERENCE:
        spec = {**SPECS, **GANG_SPECS}[name]()
        _REFERENCE[name] = jbatch.run_batch([jbatch.BatchJob.from_spec(name, spec)])
    return _REFERENCE[name][name]


def port_batch(jobs, **kw):
    return pbatch.run_batch(jobs, device="cpu", **kw)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_sweep_job_matches_reference(name):
    want = reference_result(name)
    got = port_batch([pbatch.BatchJob.from_spec(name, SPECS[name]())])[name]
    assert want["phase"] == "Succeeded"
    assert got == want
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    if name == "default":  # every node is full: each high pod placed by preempting
        for v in got["variants"]:
            assert v["scheduled"] == 3 and v["unschedulable"] == 0


def test_file_based_in_out_matches_reference(tmp_path):
    indir = tmp_path / "in"
    indir.mkdir()
    for name, spec in SPECS.items():
        (indir / f"{name}.json").write_text(json.dumps(spec()))
    (indir / "ignored.txt").write_text("not a spec")
    jobs = pbatch.load_jobs(str(indir))
    assert [j.name for j in jobs] == [j.name for j in jbatch.load_jobs(str(indir))]
    results = port_batch(jobs, out_dir=str(tmp_path / "out"))
    for name in SPECS:
        on_disk = json.loads((tmp_path / "out" / f"{name}.result.json").read_text())
        assert on_disk == results[name] == reference_result(name), name


@pytest.mark.parametrize("broken", [False, True])
def test_main_exit_code_matches_reference(tmp_path, broken, capsys):
    indir = tmp_path / "in"
    indir.mkdir()
    (indir / "fit.json").write_text(json.dumps(_sweep_spec()))
    if broken:
        (indir / "broken.json").write_text("{not json")
    args = ["--input-dir", str(indir), "--out-dir", str(tmp_path / "out")]
    rc = pbatch.main(args + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == jbatch.main(args)
    assert rc == (1 if broken else 0)
    assert out == capsys.readouterr().out  # the same summary line
    on_disk = json.loads((tmp_path / "out" / "fit.result.json").read_text())
    assert on_disk == reference_result("fit")


def test_malformed_specs_match_reference(tmp_path):
    """Unparsable, empty, non-mapping and invalid specs become jobs that
    fail at run time, with the reference's messages."""
    indir = tmp_path / "in"
    indir.mkdir()
    (indir / "broken.json").write_text("{not json")
    (indir / "empty.yaml").write_text("")
    (indir / "list.json").write_text("[1, 2]")
    (indir / "kind.json").write_text(json.dumps({"kind": "replay"}))
    (indir / "nosnap.json").write_text(json.dumps({"kind": "sweep"}))
    bad_engine = _sweep_spec()
    bad_engine["engine"] = "warp"
    (indir / "engine.json").write_text(json.dumps(bad_engine))
    bad_config = _sweep_spec()
    bad_config["schedulerConfig"] = {"profiles": ["default-scheduler"]}
    (indir / "config.json").write_text(json.dumps(bad_config))
    (indir / "fit.json").write_text(json.dumps(_sweep_spec()))
    (indir / "fit.yaml").write_text("kind: sweep\n")  # same stem: told apart
    want_jobs = jbatch.load_jobs(str(indir))
    jobs = pbatch.load_jobs(str(indir))
    assert [(j.name, j.kind, j.parse_error) for j in jobs] == [
        (j.name, j.kind, j.parse_error) for j in want_jobs]
    results = port_batch(jobs)
    bad = [j for j in want_jobs if j.parse_error]
    assert len(bad) == 8  # fit.yaml is a sweep without a snapshot
    want = jbatch.run_batch(bad)
    for j in bad:
        assert results[j.name] == want[j.name] == {
            "phase": "Failed", "message": f"ValueError: {j.parse_error}"}
    assert results["fit"] == reference_result("fit")


def test_bad_engine_and_duplicate_names_rejected():
    spec = _sweep_spec()
    spec["engine"] = "warp"
    with pytest.raises(ValueError, match="unknown engine"):
        pbatch.BatchJob.from_spec("bad", spec)
    jobs = [pbatch.BatchJob.from_spec("same", _sweep_spec()) for _ in range(2)]
    with pytest.raises(ValueError, match="duplicate job names"):
        port_batch(jobs)
    with pytest.raises(ValueError, match="duplicate job names"):
        jbatch.run_batch([jbatch.BatchJob.from_spec("same", _sweep_spec()) for _ in range(2)])


def test_unported_jobs_fail_and_the_batch_runs_on():
    """A scenario job is a Failed result naming NotImplementedError; the
    sweep and the gang sweep beside it succeed, each equal to the
    reference's result."""
    jobs = [pbatch.BatchJob.from_spec("scn", _scenario_spec()),
            pbatch.BatchJob.from_spec("gang-fit", GANG_SPECS["gang-fit"]()),
            pbatch.BatchJob.from_spec("fit", _sweep_spec())]
    results = port_batch(jobs)
    assert results["scn"]["phase"] == "Failed"
    assert results["scn"]["message"].startswith("NotImplementedError: "), results["scn"]
    assert results["gang-fit"] == reference_result("gang-fit")
    assert results["gang-fit"]["phase"] == "Succeeded"
    assert results["fit"] == reference_result("fit")


def test_gang_sweep_job_matches_reference():
    """An `engine: gang` sweep job on the default profile (every variant
    preempts): the result dict and its JSON equal the reference's."""
    spec = gang_spec(default_sweep_spec)
    want = jbatch.run_batch([jbatch.BatchJob.from_spec("gang", spec())])["gang"]
    got = port_batch([pbatch.BatchJob.from_spec("gang", spec())])["gang"]
    assert want["phase"] == "Succeeded"
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    for v in got["variants"]:
        assert v["scheduled"] == 3 and v["unschedulable"] == 0


def test_sweep_job_runs_on_the_card_by_default(monkeypatch):
    """Without a device the job asks for the CUDA card: with none, it is a
    Failed result saying so."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    got = pbatch.run_batch([pbatch.BatchJob.from_spec("fit", _sweep_spec())])["fit"]
    assert got["phase"] == "Failed" and "CUDA" in got["message"]
