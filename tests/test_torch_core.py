"""The port's device model held against the reference on the CPU.

The same workloads, built through each package's own ``WorkloadSpec``,
go through the reference (``repro``) and the port (``repro_torch`` with
``device="cpu"``): traces and service times must be byte-equal, compiled
blocks identical, and completions equal to rtol 1e-12 (the float64
contract with the reference's ``fixpoint="loop"`` driver).
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core as R
import repro_torch.core as P
from repro.core import calibration as r_cal
from repro.core import chain_program as r_cp
from repro.core.emulator_models import EMULATOR_PROFILES as R_PROFILES
from repro.core.state_machine import transition_array as r_transition
from repro_torch.core import calibration as p_cal
from repro_torch.core import chain_program as p_cp
from repro_torch.core.emulator_models import EMULATOR_PROFILES as P_PROFILES

KiB = R.KiB
F64 = dict(rtol=1e-12, atol=1e-9)
TRACE_FIELDS = ("op", "zone", "size", "issue", "thread", "qd", "occupancy",
                "was_finished", "io_ctx")


def _workload(M, case: str):
    """One workload, built with package ``M`` (``repro.core`` or
    ``repro_torch.core``)."""
    wl = M.WorkloadSpec()
    if case == "readme-mix":
        return (wl.writes(n=1500, size=4 * KiB, qd=4, zone=0)
                .reads(n=1500, size=4 * KiB, qd=16, zone=100, nzones=64)
                .resets(n=20, occupancy=1.0, io_ctx=M.OpType.WRITE))
    if case == "append-pool-resets":
        for t in range(4):
            wl = wl.appends(n=150, size=8 * KiB, qd=4, zone=t * 4, nzones=4)
            wl = wl.appends(n=150, size=64 * KiB, qd=4, zone=t * 4,
                            nzones=4)
        return wl.resets(n=20, occupancy=1.0, nzones=20,
                         io_ctx=M.OpType.APPEND, zone=500)
    if case == "open-loop":
        return (wl.reads(n=800, size=4 * KiB, qd=0,
                         arrival=M.PoissonArrivals(rate_per_s=80_000,
                                                   seed=1))
                .writes(n=400, size=16 * KiB, qd=0, zone=3,
                        arrival=M.MarkovModulated(rate_on_per_s=40_000,
                                                  rate_off_per_s=2_000,
                                                  mean_on_us=500.0,
                                                  mean_off_us=800.0,
                                                  seed=2))
                .appends(n=300, size=8 * KiB, qd=2, zone=10, nzones=3,
                         every_us=15.0))
    if case == "mgmt":
        return (wl.on_stack(M.Stack.KERNEL_MQ_DEADLINE)
                .writes(n=400, size=8 * KiB, qd=8, zone=0)
                .reset_sweep([0.0, 0.5, 1.0], n_per_level=3, zone=200)
                .finish_sweep([0.25, 0.75], n_per_level=2, zone=300)
                .opens(n=4, zone=400).closes(n=4, zone=400))
    if case == "large":
        # above the 8192-request ``auto`` threshold
        return (wl.writes(n=4200, size=4 * KiB, qd=4, zone=0)
                .reads(n=4200, size=4 * KiB, qd=16, zone=100, nzones=64))
    raise KeyError(case)


CASES = ("readme-mix", "append-pool-resets", "open-loop", "mgmt")


def _port_lat(ref_lat):
    """The reference's latency parameters carried into the port."""
    params = P.latency_params_from_arrays(dataclasses.asdict(ref_lat.params))
    spec = P.spec_from_dict(dataclasses.asdict(ref_lat.spec))
    return P.LatencyModel(spec, params)


# -- parameters ----------------------------------------------------------------
def test_spec_tables_equal():
    assert dataclasses.asdict(P.ZN540) == dataclasses.asdict(R.ZN540)
    assert P.spec_from_dict(dataclasses.asdict(R.ZN540)) == P.ZN540
    assert dataclasses.asdict(P.SN640) == dataclasses.asdict(R.SN640)
    for enum_name in ("OpType", "Stack", "LBAFormat", "ZoneState"):
        assert {e.name: int(e) for e in getattr(P, enum_name)} == \
            {e.name: int(e) for e in getattr(R, enum_name)}
    consts = {k for k in vars(r_cal) if k.isupper()}
    assert consts == {k for k in vars(p_cal) if k.isupper()}
    for k in consts:
        assert repr(getattr(p_cal, k)) == repr(getattr(r_cal, k)), k


@pytest.mark.parametrize("name", ["ours", "nvmevirt", "femu"])
def test_latency_params_equal_and_carried(name):
    ref, port = R_PROFILES[name], P_PROFILES[name]
    for f in dataclasses.fields(ref):
        np.testing.assert_array_equal(getattr(port, f.name),
                                      getattr(ref, f.name))
    carried = P.latency_params_from_arrays(dataclasses.asdict(ref))
    assert carried == port and hash(carried) == hash(port)
    stacked = P.stack_latency_params([port, carried])
    assert P.unstack_latency_params(stacked, 1) == port


def test_latency_params_from_arrays_rejects_bad_keys():
    d = dataclasses.asdict(R.DEFAULT_LATENCY_PARAMS)
    with pytest.raises(ValueError, match="missing"):
        P.latency_params_from_arrays({k: v for k, v in d.items()
                                      if k != "io_svc_us"})
    with pytest.raises(ValueError, match="unexpected"):
        P.latency_params_from_arrays(dict(d, bogus=np.zeros(1)))
    with pytest.raises(ValueError):
        P.spec_from_dict({"name": "x"})


@pytest.mark.parametrize("name", ["ours", "nvmevirt", "femu"])
def test_simulated_fidelity_matches_paper_table(name):
    from repro_torch.core.emulator_models import (FIDELITY_MATRIX,
                                                  simulated_fidelity)
    assert simulated_fidelity(name, device="cpu") == FIDELITY_MATRIX[name]


def test_transition_array_matches_reference():
    states, ops = np.meshgrid(np.arange(len(R.ZoneState)),
                              np.arange(len(R.OpType)), indexing="ij")
    want_s, want_ok = r_transition(jnp.asarray(states.ravel()),
                                   jnp.asarray(ops.ravel()))
    got_s, got_ok = P.transition_array(torch.as_tensor(states.ravel()),
                                       torch.as_tensor(ops.ravel()))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))


# -- lowering ------------------------------------------------------------------
@pytest.mark.parametrize("case", CASES + ("large",))
def test_trace_build_byte_equal(case):
    want = _workload(R, case).build()
    got = _workload(P, case).build()
    for f in TRACE_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (int(got.stack), int(got.fmt)) == (int(want.stack), int(want.fmt))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("jitter,seed", [(False, 0), (True, 0), (True, 11)])
def test_service_times_byte_equal(case, jitter, seed):
    lat = R.LatencyModel()
    want = R.compute_service_times(_workload(R, case).build(), lat,
                                   seed=seed, jitter=jitter)
    got = P.compute_service_times(_workload(P, case).build(), _port_lat(lat),
                                  seed=seed, jitter=jitter)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("jitter", [False, True])
def test_compiled_blocks_identical(case, jitter):
    rdev = R.ZnsDevice()
    want = R.compile_program(_workload(R, case).build(), rdev.spec,
                             rdev.lat, cache=False, jitter=jitter, seed=5)
    got = P.compile_program(_workload(P, case).build(), P.ZN540,
                            _port_lat(rdev.lat), cache=False,
                            jitter=jitter, seed=5)
    assert (got.n_flat, got.exact, got.order_stable, got.multiclass_pools) \
        == (want.n_flat, want.exact, want.order_stable,
            want.multiclass_pools)
    assert np.array_equal(got.issue_flat, want.issue_flat)
    assert np.array_equal(got.svc0_flat, want.svc0_flat)
    assert len(got.families) == len(want.families)
    for g, w in zip(got.families, want.families):
        assert (g.label, g.layout) == (w.label, w.layout)
        assert np.array_equal(g.gidx, w.gidx)
        assert np.array_equal(g.heads, w.heads)
    np.testing.assert_array_equal(P.block_adjacency(got),
                                  R.block_adjacency(want))


# -- the vectorized run ----------------------------------------------------------
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("jitter", [False, True])
def test_zns_device_run_matches_reference(case, jitter):
    rdev = R.ZnsDevice()
    want = rdev.run(_workload(R, case), backend="vectorized", jitter=jitter,
                    seed=3)
    pdev = P.ZnsDevice(lat=_port_lat(rdev.lat), device="cpu")
    got = pdev.run(_workload(P, case), backend="vectorized", jitter=jitter,
                   seed=3)
    assert got.solve_stats.driver == "torch"
    assert got.converged and got.exact == want.exact
    assert np.array_equal(got.sim.service, want.sim.service)
    np.testing.assert_allclose(got.sim.complete, want.sim.complete, **F64)
    np.testing.assert_allclose(got.sim.start, want.sim.start, **F64)
    assert got.latency_stats().n == want.latency_stats().n
    np.testing.assert_allclose(got.iops, want.iops, rtol=1e-9)


@pytest.mark.parametrize("case,backend", [("readme-mix", "event"),
                                          ("large", "vectorized")])
def test_auto_threshold_both_sides(case, backend):
    want = R.ZnsDevice().run(_workload(R, case), backend="auto", seed=1)
    got = P.ZnsDevice(device="cpu").run(_workload(P, case), backend="auto",
                                        seed=1)
    assert got.backend == want.backend == backend
    np.testing.assert_allclose(got.sim.complete, want.sim.complete, **F64)


@pytest.mark.parametrize("fixpoint", ["loop", "torch"])
def test_port_drivers_match_event_oracle(fixpoint):
    """The port's own event engine is its oracle: the fused solve of an
    exact program reproduces it (exactness-matrix tolerance)."""
    dev = P.ZnsDevice(device="cpu")
    tr = _workload(P, "append-pool-resets").build()
    ev = dev.run(tr, backend="event", seed=2)
    vc = dev.run(tr, backend="vectorized", seed=2, fixpoint=fixpoint)
    want = R.ZnsDevice().run(_workload(R, "append-pool-resets").build(),
                             backend="event", seed=2)
    assert np.array_equal(ev.sim.complete, want.sim.complete)
    assert vc.exact
    np.testing.assert_allclose(vc.sim.complete, ev.sim.complete, rtol=1e-8,
                               atol=1e-6)
    prog = p_cp.compile_program(tr, dev.spec, dev.lat, jitter=True, seed=2)
    svc = P.compute_service_times(tr, dev.lat, seed=2)[prog.orders[0]]
    comp, _, _ = P.solve_program(prog, svc, fixpoint=fixpoint, device="cpu")
    assert P.verify_fixpoint(prog, svc, comp)
    assert len(P.unjustified_slots(prog, svc, comp)) == 0


@pytest.mark.parametrize("policy", ["replicate", "split"])
def test_fleet_run_matches_reference(policy):
    profiles = ("ours", "nvmevirt", "femu")
    want = R.DeviceFleet.from_profiles(profiles).run(
        _workload(R, "append-pool-resets"), policy=policy,
        backend="vectorized", seed=4)
    got = P.DeviceFleet.from_profiles(profiles, device="cpu").run(
        _workload(P, "append-pool-resets"), policy=policy,
        backend="vectorized", seed=4)
    assert len(got) == len(want) == 3
    assert got.exact == want.exact and got.converged
    assert got.solve_stats.driver == "torch"
    for g, w in zip(got, want):
        assert np.array_equal(g.sim.service, w.sim.service)
        np.testing.assert_allclose(g.sim.complete, w.sim.complete, **F64)
    np.testing.assert_allclose(got.completion_us, want.completion_us, **F64)


def test_sequential_completions_match_reference():
    rng = np.random.default_rng(9)
    issue = np.sort(rng.uniform(0, 1e5, 3000))
    svc = rng.uniform(1, 40, 3000)
    seg = rng.uniform(size=3000) < 0.02
    seg[0] = True
    want = R.ZnsDevice().sequential_completions(issue, svc, seg)
    got = P.ZnsDevice(device="cpu").sequential_completions(issue, svc, seg)
    np.testing.assert_allclose(got, want, **F64)
    lens = [700, 3000, 1]
    issues = [issue[:k] for k in lens]
    svcs = [svc[:k] for k in lens]
    segs = [seg[:k] for k in lens]
    want = R.DeviceFleet.homogeneous(3).sequential_completions(
        issues, svcs, segs)
    got = P.DeviceFleet.homogeneous(3, device="cpu").sequential_completions(
        issues, svcs, segs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **F64)


def test_solve_program_driver_names():
    dev = P.ZnsDevice(device="cpu")
    prog = P.compile_program(_workload(P, "mgmt").build(), dev.spec, dev.lat)
    want, _, _ = P.solve_program(prog, prog.svc0_flat, fixpoint="loop",
                                 device="cpu")
    for name, driver in (("sharded", "sharded/host"),
                         ("windowed", "windowed")):
        got, _, conv = P.solve_program(prog, prog.svc0_flat, fixpoint=name,
                                       device="cpu")
        assert conv and P.last_solve_stats().driver == driver
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0.0)
    with pytest.raises(ValueError, match="unknown fixpoint"):
        P.solve_program(prog, prog.svc0_flat, fixpoint="pallas",
                        device="cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        P.solve_program(prog, prog.svc0_flat, fixpoint="cuda", device="cpu")


def test_program_disk_cache_is_the_ports_own(tmp_path):
    key = ((b"d",), ("spec",), ("params",), 4, None)
    prev_r = r_cp.set_program_cache_dir(str(tmp_path))
    prev_p = p_cp.set_program_cache_dir(str(tmp_path))
    try:
        assert r_cp._disk_cache_path(key) != p_cp._disk_cache_path(key)
    finally:
        r_cp.set_program_cache_dir(prev_r)
        p_cp.set_program_cache_dir(prev_p)
    src = open(p_cp.__file__).read()
    assert "REPRO_TORCH_PROGRAM_CACHE_DIR" in src
    assert '"REPRO_PROGRAM_CACHE_DIR"' not in src


@pytest.mark.parametrize("module", ["arrival", "chain_program", "device",
                                    "latency", "metrics", "workload"])
def test_port_docstring_examples_run(module):
    import doctest
    import importlib
    mod = importlib.import_module(f"repro_torch.core.{module}")
    result = doctest.testmod(mod, optionflags=doctest.ELLIPSIS)
    assert result.attempted > 0 and result.failed == 0


# -- device and import rules ----------------------------------------------------
def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wl = P.WorkloadSpec().writes(n=16, size=4 * KiB)
    for run in (lambda: P.ZnsDevice().run(wl),
                lambda: P.ZnsDevice().run(wl, backend="vectorized"),
                lambda: P.DeviceFleet.homogeneous(2).run(wl),
                lambda: P.ZnsDevice().sequential_completions(
                    np.zeros(2), np.ones(2), np.ones(2, bool)),
                lambda: P.zone_sequential_completions(
                    np.zeros(2), np.ones(2), np.ones(2, bool))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run()
    prog = P.compile_program(wl.build(), P.ZN540, P.LatencyModel())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.solve_program(prog, prog.svc0_flat)
    # an explicit CPU device runs
    assert len(P.ZnsDevice(device="cpu").run(wl)) == 16


def test_import_loads_neither_jax_nor_reference():
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.kernels\n"
            "import repro_torch.models, repro_torch.serve\n"
            "import repro_torch.launch.serve, repro_torch.configs\n"
            "import repro_torch.host, repro_torch.experiments\n"
            "import repro_torch.experiments.__main__\n"
            "import repro_torch.cluster as C\n"
            "import torch\n"
            "assert not torch.cuda.is_available()\n"
            # run the cluster tier: a warm rate ladder reaches the
            # warm-start repair, whose imports are function-local in
            # the reference
            "spec = C.ClusterSpec(n_gateways=1, n_servers=4, "
            "scheme=C.erasure(2, 1))\n"
            "wl = C.ClusterWorkload(n_users=2, ops_per_user=2, "
            "object_bytes=1 << 20)\n"
            "rep = C.plan_capacity([C.ClusterConfig(spec.scheme, "
            "'hashed')], [], base_spec=spec, workload=wl, "
            "rate_ladder=[4000.0, 16000.0], warm_ladder=True, "
            "device='cpu')\n"
            "assert rep.converged and rep.warm_attempts > 0, rep\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')]\n"
            "print(bad)\n"
            "assert not bad, bad\n")
    # a host without CUDA: importing needs no device
    env = dict(os.environ, PYTHONPATH=src, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
