"""The port's experiment runner held against the reference on the CPU.

Each package builds its observation registry through its own code; the
registries must agree entry for entry and sweep point for sweep point
(specs, latency profiles, seeds and built traces bit-equal).  The
port's ``event`` runner must equal the reference's metrics and the
fixtures in ``results/experiments/`` exactly, its ``vectorized`` runner
on ``device="cpu"`` the reference's vectorized run to rtol 1e-12 (the
float64 contract; ``oracle_max_rel_diff`` is itself a relative
difference and is held absolutely, to 1e-9 as obs14's check holds it),
and every check's name and verdict must be the reference's.  The
behaviours of ``tests/test_experiments.py`` are held against the port.
"""
import dataclasses
import glob
import json
import os
import warnings

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as P
from repro.experiments import ExperimentRunner as RRunner
from repro.experiments import all_experiments as r_all
from repro.experiments.__main__ import main as r_cli
from repro_torch.experiments import (
    DEFAULT_OUT_DIR, Check, Experiment, ExperimentRunner, SweepPoint,
    all_experiments, get_experiment, register_experiment, render_report,
    unregister_experiment,
)
from repro_torch.experiments.__main__ import main as cli_main

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACE_FIELDS = ("op", "zone", "size", "issue", "thread", "qd", "occupancy",
                "was_finished", "io_ctx")
#: The float64 contract between the port's and the reference's
#: vectorized solves.
RTOL = 1e-12
#: ``oracle_max_rel_diff`` is compared absolutely (obs14's own bound).
ORACLE_ATOL = 1e-9
NAMES = [e.name for e in r_all()]
POINTS = [(e.name, p.label) for e in r_all() for p in e.points]


def _fixtures():
    out = {}
    for path in glob.glob(os.path.join(ROOT, "results", "experiments",
                                       "obs*.json")):
        with open(path) as f:
            data = json.load(f)
        out[data["name"]] = data
    return out


def _verdicts(res):
    return [(c.name, bool(c.ok)) for c in res.checks]


@pytest.fixture(scope="module")
def runs():
    """Both packages' full runs on both backends (the port on the CPU)."""
    port_vec = ExperimentRunner(backend="vectorized", device="cpu")
    out = {
        "ref_event": {r.name: r for r in RRunner(backend="event").run()},
        "ref_vec": {r.name: r for r in RRunner(backend="vectorized").run()},
        "port_event": {r.name: r for r in ExperimentRunner(
            backend="event", device="cpu").run()},
        "port_vec": {r.name: r for r in port_vec.run()},
        "fleet": port_vec.last_fleet,
        "fixtures": _fixtures(),
    }
    return out


# -- the registries --------------------------------------------------------------
def test_registry_lists_the_same_15_experiments():
    got = [(e.name, e.obs) for e in all_experiments()]
    assert got == [(e.name, e.obs) for e in r_all()]
    assert [obs for _, obs in got] == list(range(1, 16))
    assert len(POINTS) == 46


@pytest.mark.parametrize("name", NAMES)
def test_experiment_metadata_equal(name):
    got, want = get_experiment(name), next(e for e in r_all()
                                           if e.name == name)
    for field in ("obs", "title", "claim", "figure", "knobs", "tests"):
        assert getattr(got, field) == getattr(want, field), field
    assert [p.label for p in got.points] == [p.label for p in want.points]


@pytest.mark.parametrize("name,label", POINTS)
def test_sweep_point_equal(name, label):
    got = next(p for p in get_experiment(name).points if p.label == label)
    want = next(p for e in r_all() if e.name == name
                for p in e.points if p.label == label)
    assert dataclasses.asdict(got.spec) == dataclasses.asdict(want.spec)
    assert got.seed == want.seed
    assert (got.params is None) == (want.params is None)
    if want.params is not None:
        for f in dataclasses.fields(want.params):
            np.testing.assert_array_equal(getattr(got.params, f.name),
                                          getattr(want.params, f.name))
    tg, tw = got.workload.build(), want.workload.build()
    assert (int(tg.stack), int(tg.fmt)) == (int(tw.stack), int(tw.fmt))
    for f in TRACE_FIELDS:
        a, b = getattr(tg, f), getattr(tw, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


# -- the runs --------------------------------------------------------------------
@pytest.mark.parametrize("name", NAMES)
def test_event_runner_equals_reference_and_fixture(runs, name):
    got, want = runs["port_event"][name], runs["ref_event"][name]
    fixture = runs["fixtures"][name]
    assert got.metrics == want.metrics
    assert got.to_json() == want.to_json()
    assert fixture["backend"] == "event"
    assert got.to_json()["metrics"] == fixture["metrics"]
    assert [(c["name"], c["ok"]) for c in fixture["checks"]] \
        == _verdicts(got)
    assert got.passed and got.converged


@pytest.mark.parametrize("name", NAMES)
def test_vectorized_runner_matches_reference(runs, name):
    got, want = runs["port_vec"][name], runs["ref_vec"][name]
    assert got.backend == "vectorized" and got.passed and got.converged
    assert set(got.metrics) == set(want.metrics)
    for k, v in got.metrics.items():
        if k == "oracle_max_rel_diff":
            assert abs(v) <= ORACLE_ATOL
            continue
        np.testing.assert_allclose(v, want.metrics[k], rtol=RTOL, atol=0,
                                   err_msg=k)
    assert _verdicts(got) == _verdicts(want) \
        == _verdicts(runs["port_event"][name])
    assert got.n_requests == want.n_requests


def test_vectorized_run_is_one_fleet_solve(runs):
    fres = runs["fleet"]
    assert fres.backend == "vectorized" and fres.converged
    assert len(fres) == 46
    assert sum(len(r) for r in fres) == 108_924      # requests
    assert (fres.compile_stats.n_devices, fres.compile_stats.n_unique) \
        == (46, 39)
    stats = fres.solve_stats
    assert stats.driver == "torch" and stats.converged
    assert (stats.n_blocks, stats.sweeps) == (14, 2)


def test_jittered_event_runner_equals_reference():
    keys = ["obs4", "obs9", "obs11", "obs15"]
    got = ExperimentRunner(keys, backend="event", jitter=True, seed=3,
                           device="cpu").run()
    want = RRunner(keys, backend="event", jitter=True, seed=3).run()
    for g, w in zip(got, want):
        assert g.metrics == w.metrics, g.name
        assert _verdicts(g) == _verdicts(w)


def test_fleet_program_equals_reference():
    fleet, workloads, seeds = ExperimentRunner(device="cpu").fleet()
    points = [p for e in r_all() for p in e.points]
    rfleet = R.DeviceFleet([(p.spec, p.params) if p.params is not None
                            else p.spec for p in points])
    want = R.compile_fleet_program(
        [p.workload.build() for p in points], rfleet.specs,
        [d.lat for d in rfleet.devices], seeds=[p.seed for p in points],
        cache=False)
    rstats = R.last_compile_stats()
    got = P.compile_fleet_program(
        [w.build() for w in workloads], fleet.specs,
        [d.lat for d in fleet.devices], seeds=seeds, cache=False)
    stats = P.last_compile_stats()
    assert (stats.n_devices, stats.n_unique) == (rstats.n_devices,
                                                 rstats.n_unique) == (46, 39)
    assert (got.n_flat, got.exact, got.order_stable, got.offsets) \
        == (want.n_flat, want.exact, want.order_stable, want.offsets)
    assert got.n_flat == 108_924                     # one event a request
    for f in ("issue_flat", "svc0_flat"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    for a, b in zip(got.orders + got.invs, want.orders + want.invs):
        assert np.array_equal(a, b)
    assert len(got.families) == len(want.families) == 14
    for g, w in zip(got.families, want.families):
        assert (g.label, g.layout) == (w.label, w.layout)
        assert np.array_equal(g.gidx, w.gidx)
        assert np.array_equal(g.heads, w.heads)
    np.testing.assert_array_equal(P.block_adjacency(got),
                                  R.block_adjacency(want))


# -- the behaviours of tests/test_experiments.py, on the port ---------------------
def test_get_experiment_lookup_forms():
    e = get_experiment("obs04_append_vs_write")
    assert get_experiment(4) is e
    assert get_experiment("obs4") is e
    assert get_experiment("obs04") is e
    assert get_experiment("append_vs_write") is e
    with pytest.raises(KeyError, match="unknown experiment"):
        get_experiment("obs_nope")
    with pytest.raises(KeyError, match="no experiment"):
        get_experiment(99)


def _dummy_experiment(name="dummy_exp", obs=1):
    return Experiment(
        name=name, obs=obs, title="t", claim="c", figure="f",
        points=(SweepPoint("p", P.WorkloadSpec().writes(n=4,
                                                        size=4 * P.KiB)),),
        extract=lambda ctx: {"n": float(len(ctx["p"]))},
        check=lambda m: (Check("has_requests", m["n"] == 4.0,
                               f"n={m['n']}"),))


def test_register_experiment_collision_warns_and_unregister_roundtrip():
    register_experiment(_dummy_experiment())
    try:
        with pytest.warns(RuntimeWarning, match="already registered"):
            register_experiment(_dummy_experiment())
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            current = register_experiment(_dummy_experiment(), replace=True)
            register_experiment(current)
        # the registries of the two packages are separate
        assert all(e.name != "dummy_exp" for e in r_all())
    finally:
        unregister_experiment("dummy_exp")
    with pytest.raises(KeyError):
        get_experiment("dummy_exp")
    unregister_experiment("dummy_exp")


def test_experiment_validation():
    with pytest.raises(ValueError, match="obs must be"):
        _dummy_experiment(obs=0)
    bad = _dummy_experiment()
    with pytest.raises(ValueError, match="duplicate sweep-point labels"):
        Experiment(name="x", obs=1, title="t", claim="c", figure="f",
                   points=bad.points + bad.points,
                   extract=bad.extract, check=bad.check)


def test_runner_subset_and_custom_seed():
    got = ExperimentRunner(["obs4", 9], backend="event", seed=3,
                           device="cpu").run()
    want = RRunner(["obs4", 9], backend="event", seed=3).run()
    assert [r.obs for r in got] == [4, 9]
    assert all(r.passed for r in got)
    assert [r.metrics for r in got] == [r.metrics for r in want]


def test_artifacts_json_and_report(tmp_path):
    runner = ExperimentRunner(["obs4", "obs13"], device="cpu")
    results = runner.run()
    paths = runner.write_artifacts(results, out_dir=str(tmp_path))
    want = {r.name: r for r in RRunner(["obs4", "obs13"]).run()}
    for r in results:
        data = json.loads((tmp_path / f"{r.name}.json").read_text())
        ref = want[r.name].to_json()
        assert data["metrics"].keys() == ref["metrics"].keys()
        for k, v in data["metrics"].items():
            np.testing.assert_allclose(v, ref["metrics"][k], rtol=RTOL)
        assert {k: v for k, v in data.items() if k != "metrics"} \
            == {k: v for k, v in ref.items() if k != "metrics"}
    report = (tmp_path / "report.md").read_text()
    assert "observations.md" in report
    assert "obs13_reset_inflation" in report
    assert paths["report"].endswith("report.md")


def test_report_links_docs_tree_relative(tmp_path):
    out = tmp_path / "repo" / "build" / "experiments"
    out.mkdir(parents=True)
    docs = tmp_path / "repo" / "docs"
    docs.mkdir()
    (docs / "observations.md").write_text("# map\n")
    results = ExperimentRunner(["obs4"], device="cpu").run()
    assert "../../docs/observations.md" in render_report(results,
                                                         out_dir=str(out))


def test_default_out_dir_is_untracked_and_links_docs(tmp_path,
                                                     monkeypatch, capsys):
    assert DEFAULT_OUT_DIR == os.path.join("build", "experiments")
    # from the repository's root the default finds docs/observations.md
    results = ExperimentRunner(["obs4"], backend="event",
                               device="cpu").run()
    assert "(../../docs/observations.md)" in render_report(
        results, out_dir=os.path.join(ROOT, DEFAULT_OUT_DIR))
    monkeypatch.chdir(tmp_path)
    assert cli_main(["run", "--only", "obs4", "--backend", "event",
                     "--device", "cpu"]) == 0
    capsys.readouterr()
    assert (tmp_path / "build" / "experiments" / "report.md").exists()
    assert not (tmp_path / "results").exists()


def test_cli_list_equals_reference(capsys):
    assert r_cli(["list"]) == 0
    want = capsys.readouterr().out
    assert cli_main(["list"]) == 0
    assert capsys.readouterr().out == want
    assert "obs15_diurnal_reclaim" in want


def test_cli_run(tmp_path, capsys):
    rc = cli_main(["run", "--only", "obs4,obs9", "--backend", "event",
                   "--device", "cpu", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0
    assert "2/2 experiments passed" in out
    assert (tmp_path / "report.md").exists()
    assert (tmp_path / "obs09_transitions.json").exists()


def test_cli_requires_selection(capsys):
    assert cli_main(["run", "--device", "cpu"]) == 2
    assert cli_main(["run", "--only", ",", "--device", "cpu"]) == 2


def test_cli_unknown_key_clean_error(capsys):
    assert cli_main(["run", "--only", "obs99", "--device", "cpu"]) == 2
    assert "no experiment" in capsys.readouterr().err
    assert cli_main(["run", "--only", "obs_nope", "--device", "cpu"]) == 2
    assert "unknown experiment" in capsys.readouterr().err


def test_cli_reports_failure_nonzero(tmp_path):
    bad = Experiment(
        name="always_fails", obs=1, title="t", claim="c", figure="f",
        points=(SweepPoint("p", P.WorkloadSpec().writes(n=4,
                                                        size=4 * P.KiB)),),
        extract=lambda ctx: {"n": float(len(ctx["p"]))},
        check=lambda m: (Check("nope", False, "forced failure"),))
    register_experiment(bad)
    try:
        assert cli_main(["run", "--only", "always_fails", "--device", "cpu",
                         "--out", str(tmp_path)]) == 1
        data = json.loads((tmp_path / "always_fails.json").read_text())
        assert data["passed"] is False
    finally:
        unregister_experiment("always_fails")


@pytest.mark.parametrize("cmd", [["host"], ["host", "--scenarios", "lsm"],
                                 ["cluster"], ["cluster", "--list"]])
def test_cli_unported_subcommands_exit_2(cmd, capsys):
    assert cli_main(cmd) == 2
    assert "not ported yet" in capsys.readouterr().err


def test_obs12_points_share_seed_in_batched_run():
    res = ExperimentRunner(["obs12"], device="cpu").run()[0]
    assert res.metrics["max_read_shift_us"] == 0.0


def test_length_buckets_bound_padding_waste():
    from repro.core.fleet import length_buckets as r_buckets
    from repro_torch.core.fleet import length_buckets
    for lens in ([40, 45, 30_000, 90, 24_000, 120], [], [0, 0, 3],
                 [0, 0, 5]):
        assert length_buckets(lens) == r_buckets(lens)
    lens = [40, 45, 30_000, 90, 24_000, 120]
    for b in length_buckets(lens):
        vals = [lens[i] for i in b]
        assert max(vals) <= 4.0 * max(min(vals), 1)


# -- the device rule -------------------------------------------------------------
@pytest.mark.parametrize("backend", ["vectorized", "event"])
def test_default_device_raises_without_cuda(monkeypatch, backend):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ExperimentRunner(["obs4"], backend=backend).run()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_main(["run", "--only", "obs4", "--backend", backend])
