"""The port's entry-sharded and windowed solves (``repro_torch.core.shard``)
held against the reference's on the CPU.

Shard plans and window partitions are host numpy and must be identical to
the reference's (devices, ``perm``, blocks, ``bnd_local``, ``bnd_pred``).
The ``host`` executor (the ``loop`` driver a shard) and the ``mesh``
executor (every shard in one stacked fixpoint; on the CPU its plain
version) equal the reference's ``executor="host"`` to rtol 1e-12, with and
without a ``comp0`` warm start, and the windowed pipeline the reference's
windowed solve.  The plain stacked solve equals the reference's
``zns_fixpoint_sharded`` (``lax.map`` inside ``shard_map``, one CPU
device) in float32 at the reference kernel tests' tolerance, with equal
per-shard sweeps and convergence; its float64 mode needs ``enable_x64``,
which this JAX lacks, so float64 is held against the host executor.
"""
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as P
from repro.core import shard as rshard
from repro_torch.core import chain_program as pcp
from repro_torch.core import shard as pshard
from repro_torch.kernels import ops
from repro_torch.kernels import zns_fixpoint as pfix

F64 = dict(rtol=1e-12, atol=0.0)
F32 = dict(rtol=2e-5, atol=1e-2)


def _pool(core, threads=4, qd=2, n=80):
    wl = core.WorkloadSpec()
    for t in range(threads):
        wl = wl.appends(n=n, size=8 * core.KiB, qd=qd, zone=t * 4, nzones=4)
    return wl


def _tier_workloads(core):
    """Three heterogeneity tiers x two replicas each
    (``tests/test_sharded_solver.py``)."""
    hard = _pool(core, threads=4, qd=2, n=60)
    med = core.WorkloadSpec().writes(n=200, qd=4, zone=7)
    easy = core.WorkloadSpec().reads(n=300, size=4 * core.KiB, qd=4,
                                     nzones=64)
    return [hard, hard, med, med, easy, easy]


def _fleet_program(core, workloads):
    traces = [wl.build() for wl in workloads]
    spec = core.ZNSDeviceSpec()
    lat = core.LatencyModel(spec)
    return core.compile_fleet_program(traces, [spec] * len(traces),
                                      [lat] * len(traces), cache=False)


def _runner_programs():
    """The experiment runner's one fleet program (all 15 observations),
    built by the port's runner and from the reference's registry."""
    from repro.experiments.registry import all_experiments
    from repro_torch.experiments import ExperimentRunner
    fleet, workloads, seeds = ExperimentRunner(device="cpu").fleet()
    got = P.compile_fleet_program(
        [w.build() for w in workloads], fleet.specs,
        [d.lat for d in fleet.devices], seeds=seeds, cache=False)
    points = [p for e in all_experiments() for p in e.points]
    rfleet = R.DeviceFleet([(p.spec, p.params) if p.params is not None
                            else p.spec for p in points])
    want = R.compile_fleet_program(
        [p.workload.build() for p in points], rfleet.specs,
        [d.lat for d in rfleet.devices], seeds=[p.seed for p in points],
        cache=False)
    return got, want


@pytest.fixture(scope="module")
def tiers():
    return _fleet_program(P, _tier_workloads(P)), \
        _fleet_program(R, _tier_workloads(R))


@pytest.fixture(scope="module")
def runner_programs():
    return _runner_programs()


def _assert_blocks_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.label, a.layout) == (b.label, b.layout)
        np.testing.assert_array_equal(a.gidx, b.gidx)
        np.testing.assert_array_equal(a.heads, b.heads)


def _assert_plans_equal(got, want):
    assert got.n_shards == want.n_shards
    for a, b in zip(got.shards, want.shards):
        assert a.devices == b.devices
        np.testing.assert_array_equal(a.perm, b.perm)
        np.testing.assert_array_equal(a.program.issue_flat,
                                      b.program.issue_flat)
        _assert_blocks_equal(a.program.families, b.program.families)


# -- plans and window partitions ----------------------------------------------
@pytest.mark.parametrize("n_shards", [None, 2, 3])
def test_shard_plans_equal_reference_on_the_tier_fleet(tiers, n_shards):
    pp, rp = tiers
    _assert_plans_equal(pshard.shard_program(pp, n_shards=n_shards),
                        rshard.shard_program(rp, n_shards=n_shards))


def test_shard_plan_equals_reference_on_the_runner_program(runner_programs):
    pp, rp = runner_programs
    plan = pshard.shard_program(pp)
    _assert_plans_equal(plan, rshard.shard_program(rp))
    assert plan.n_shards == 16 == pshard.HOST_MAX_SHARDS
    assert sorted(sh.n_events for sh in plan.shards)[0] == 3000
    assert max(len(sh.program.families) for sh in plan.shards) == 7


@pytest.mark.parametrize("k", [2, 3, 5])
def test_window_partitions_equal_reference(tiers, k):
    pp, rp = tiers
    got = pshard.window_program(pp, n_windows=k)
    want = rshard.window_program(rp, n_windows=k)
    assert got.n_windows == want.n_windows
    for a, b in zip(got.windows, want.windows):
        for f in ("perm", "bnd_local", "bnd_pred"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        _assert_blocks_equal(a.program.families, b.program.families)
    assert pshard.window_program(pp, n_windows=k) is got      # memoized


def test_window_partition_is_exact_and_bounded():
    prog = _fleet_program(P, [_pool(P, threads=5, n=100)])
    wp = pshard.window_program(prog, n_windows=4)
    allp = np.concatenate([w.perm for w in wp.windows])
    assert len(allp) == prog.n_flat == len(np.unique(allp))
    for j, w in enumerate(wp.windows):
        assert (w.bnd_pred < prog.n_flat).all()
        for pred in w.bnd_pred:
            upstream = next(i for i, ww in enumerate(wp.windows)
                            if pred in set(ww.perm.tolist()))
            assert upstream < j


# -- the executors against the reference's host executor ----------------------
def _comp0s(prog, ref):
    return (None, ref, prog.issue_flat + prog.svc0_flat)


@pytest.mark.parametrize("executor", ["host", "mesh"])
def test_executors_equal_reference_host_executor(tiers, executor):
    pp, rp = tiers
    ref, _, cv = R.solve_program_sharded(rp, rp.svc0_flat, sweeps=64,
                                         executor="host")
    assert cv
    for comp0 in _comp0s(rp, ref):
        want, _, _ = R.solve_program_sharded(rp, rp.svc0_flat, sweeps=64,
                                             executor="host", comp0=comp0)
        got, _, conv = pshard.solve_program_sharded(
            pp, pp.svc0_flat, sweeps=64, executor=executor, comp0=comp0,
            device="cpu")
        assert conv
        np.testing.assert_allclose(got, want, **F64)
        assert P.last_solve_stats().driver == f"sharded/{executor}"


@pytest.mark.parametrize("executor", ["host", "mesh"])
def test_executors_equal_reference_on_the_runner_program(runner_programs,
                                                         executor):
    pp, rp = runner_programs
    want, wu, _ = R.solve_program_sharded(rp, rp.svc0_flat, sweeps=8,
                                          executor="host")
    got, used, conv = pshard.solve_program_sharded(
        pp, pp.svc0_flat, sweeps=8, executor=executor, device="cpu")
    assert conv and used == wu == 2
    np.testing.assert_allclose(got, want, **F64)


@pytest.mark.parametrize("layout", ["rows", "cols"])
def test_sharded_matches_on_forced_layout(layout, monkeypatch):
    if layout == "cols":
        monkeypatch.setattr(pcp, "POSLOOP_MIN_CHAINS", 1)
        monkeypatch.setattr(pcp, "POSLOOP_COST_CUTOVER", 0.0)
    else:
        monkeypatch.setattr(pcp, "POSLOOP_MIN_CHAINS", 10**9)
    prog = _fleet_program(P, _tier_workloads(P))
    assert {b.layout for b in prog.families} == {layout}
    ref, _, _ = P.solve_program(prog, prog.svc0_flat, sweeps=64,
                                fixpoint="loop", device="cpu")
    for executor in ("host", "mesh"):
        got, _, cv = pshard.solve_program_sharded(
            prog, prog.svc0_flat, sweeps=64, executor=executor, device="cpu")
        assert cv
        np.testing.assert_allclose(got, ref, **F64)


def test_one_shard_plan_is_bit_identical():
    """A replicated fleet is one signature group: host falls back to the
    ``loop`` driver and mesh to the single-program fixpoint, bit for
    bit."""
    wl = _pool(P, threads=3, qd=2, n=60)
    prog = _fleet_program(P, [wl, wl, wl])
    assert pshard.shard_program(prog).n_shards == 1
    for executor, driver in (("host", "loop"), ("mesh", "torch")):
        ref, u_ref, _ = P.solve_program(prog, prog.svc0_flat, sweeps=32,
                                        fixpoint=driver, device="cpu")
        got, u_got, _ = pshard.solve_program_sharded(
            prog, prog.svc0_flat, sweeps=32, executor=executor, device="cpu")
        assert np.array_equal(got, ref) and u_got == u_ref


def test_solve_program_routes_sharded_fixpoint(tiers):
    pp, _ = tiers
    ref, _, _ = P.solve_program(pp, pp.svc0_flat, sweeps=64,
                                fixpoint="loop", device="cpu")
    got, _, cv = P.solve_program(pp, pp.svc0_flat, sweeps=64,
                                 fixpoint="sharded", device="cpu")
    assert cv and P.last_solve_stats().driver == "sharded/host"
    np.testing.assert_allclose(got, ref, **F64)


def test_sharded_validates_inputs():
    prog = _fleet_program(P, [_pool(P, threads=2, qd=1, n=30)])
    with pytest.raises(ValueError):
        pshard.solve_program_sharded(prog, np.zeros(3), device="cpu")
    with pytest.raises(ValueError):
        pshard.solve_program_sharded(prog, prog.svc0_flat,
                                     comp0=np.zeros(3), device="cpu")
    with pytest.raises(ValueError):
        pshard.solve_program_sharded(prog, prog.svc0_flat,
                                     executor="warp-drive", device="cpu")
    with pytest.raises(ValueError):
        pshard.solve_program_windowed(prog, np.zeros(3), device="cpu")
    with pytest.raises(ValueError, match="window driver"):
        pshard.solve_program_windowed(prog, prog.svc0_flat, driver="xla",
                                      device="cpu")


def test_cross_entry_chain_fuses_shards():
    prog = _fleet_program(P, [_pool(P, threads=2, qd=1, n=30),
                              P.WorkloadSpec().reads(n=40, qd=2)])
    n0 = len(prog.orders[0])
    coupled = P.extend_program(
        prog, [("net_link", [np.asarray([n0 - 1, n0], dtype=np.int64)])])
    plan = pshard.shard_program(coupled, n_shards=2)
    assert plan.n_shards == 1                # union-find fused the entries
    assert plan.shards[0].devices == (0, 1)
    ref, _, _ = P.solve_program(coupled, coupled.svc0_flat, sweeps=64,
                                fixpoint="loop", device="cpu")
    for executor in ("host", "mesh"):
        got, _, cv = pshard.solve_program_sharded(
            coupled, coupled.svc0_flat, sweeps=64, executor=executor,
            device="cpu")
        assert cv
        np.testing.assert_allclose(got, ref, **F64)


def test_shard_plan_cache_hits_on_equal_content_distinct_objects():
    pshard.clear_shard_plans()
    wl = _pool(P, threads=3, n=40)
    prog_a = _fleet_program(P, [wl])
    prog_b = _fleet_program(P, [wl])
    assert prog_a is not prog_b
    assert pshard._program_digest(prog_a) == pshard._program_digest(prog_b)
    plan_a = pshard._plan(prog_a, 2)
    assert pshard._plan(prog_b, 2) is plan_a
    assert pshard._plan(prog_a, 2) is plan_a
    pshard.clear_shard_plans()


# -- the windowed pipeline ----------------------------------------------------
@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("driver", ["torch", "loop"])
def test_windowed_equals_reference(driver, warm):
    pp = _fleet_program(P, [_pool(P, threads=4, qd=2, n=60)])
    rp = _fleet_program(R, [_pool(R, threads=4, qd=2, n=60)])
    full, _, _ = R.solve_program(rp, rp.svc0_flat, sweeps=512,
                                 fixpoint="loop")
    comp0 = None
    if warm:
        comp0 = np.full(rp.n_flat, -np.inf)
        comp0[:rp.n_flat // 2] = full[:rp.n_flat // 2]
    for k in (2, 3, 7):
        want, wu, _ = R.solve_program_windowed(rp, rp.svc0_flat, sweeps=512,
                                               n_windows=k, comp0=comp0)
        got, used, conv = pshard.solve_program_windowed(
            pp, pp.svc0_flat, sweeps=512, n_windows=k, comp0=comp0,
            driver=driver, device="cpu")
        assert conv and P.last_solve_stats().driver == "windowed"
        np.testing.assert_allclose(got, want, **F64)
        np.testing.assert_allclose(got, full, rtol=1e-12, atol=1e-9)


def test_windowed_solve_matches_sharded_host_executor(tiers):
    pp, _ = tiers
    hosted, _, ch = pshard.solve_program_sharded(pp, pp.svc0_flat,
                                                 sweeps=512, executor="host",
                                                 device="cpu")
    assert ch
    for k in (2, 5):
        gw, _, cw = P.solve_program_windowed(pp, pp.svc0_flat, sweeps=512,
                                             n_windows=k, device="cpu")
        assert cw
        np.testing.assert_allclose(gw, hosted, rtol=1e-12, atol=1e-9)


def test_host_executor_windows_a_mega_entry(monkeypatch):
    """A one-shard plan of at least ``WINDOW_AUTO_MIN`` events goes to the
    windowed pipeline, as the reference's host executor does."""
    prog = _fleet_program(P, [_pool(P, threads=2, n=600)])
    monkeypatch.setattr(pshard, "WINDOW_AUTO_MIN", prog.n_flat)
    monkeypatch.setattr(pshard, "WINDOW_TARGET_EVENTS", prog.n_flat // 3)
    ref, _, _ = P.solve_program(prog, prog.svc0_flat, sweeps=64,
                                fixpoint="loop", device="cpu")
    got, _, cv = pshard.solve_program_sharded(prog, prog.svc0_flat,
                                              sweeps=64, executor="host",
                                              device="cpu")
    assert cv and P.last_solve_stats().driver == "sharded/host"
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-9)


def test_mesh_executor_keeps_a_single_entry_program_on_its_kernel(
        monkeypatch):
    """A one-entry program on the mesh executor is a 1-shard plan: it runs
    the single-program fixpoint (here its plain version), bit-identical to
    fixpoint="torch", and never the host executor's loop."""
    prog = _fleet_program(P, [_pool(P, threads=3, n=200)])
    assert prog.n_devices == 1

    def no_host(*a, **k):
        raise AssertionError("the mesh executor went to the host loop")

    monkeypatch.setattr(pshard, "_solve_host", no_host)
    want, u_want, _ = P.solve_program(prog, prog.svc0_flat, sweeps=64,
                                      fixpoint="torch", device="cpu")
    got, u_got, cv = pshard.solve_program_sharded(
        prog, prog.svc0_flat, sweeps=64, executor="mesh", device="cpu")
    assert cv and u_got == u_want and np.array_equal(got, want)
    ref, _, _ = P.solve_program(prog, prog.svc0_flat, sweeps=64,
                                fixpoint="loop", device="cpu")
    np.testing.assert_allclose(got, ref, **F64)


def test_mesh_executor_windows_a_mega_entry_on_its_kernel(monkeypatch):
    """A one-shard plan of at least ``WINDOW_AUTO_MIN`` events on the mesh
    executor is windowed with the kernel's driver (its plain version on
    the CPU), not the host loop."""
    prog = _fleet_program(P, [_pool(P, threads=2, n=600)])
    monkeypatch.setattr(pshard, "WINDOW_AUTO_MIN", prog.n_flat)
    monkeypatch.setattr(pshard, "WINDOW_TARGET_EVENTS", prog.n_flat // 3)
    drivers = []
    windowed = pshard.solve_program_windowed

    def spy(*a, **k):
        drivers.append(k.get("driver"))
        return windowed(*a, **k)

    monkeypatch.setattr(pshard, "solve_program_windowed", spy)
    ref, _, _ = P.solve_program(prog, prog.svc0_flat, sweeps=64,
                                fixpoint="loop", device="cpu")
    got, _, cv = pshard.solve_program_sharded(prog, prog.svc0_flat,
                                              sweeps=64, executor="mesh",
                                              device="cpu")
    assert cv and drivers == ["torch"]
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-9)


# -- the stacked fixpoint against the reference's zns_fixpoint_sharded --------
def _reference_stack(rp, sweeps):
    """The reference's stacked mesh inputs for its signature plan on one
    device, and its ``zns_fixpoint_sharded`` solve in float32."""
    import jax
    from repro.kernels.zns_fixpoint import zns_fixpoint_sharded
    plan = rshard._plan(rp, None)
    st = rshard._mesh_static(plan, 1)
    init = np.full((st["S"], st["n_max"] + 1), -np.inf)
    svc = np.zeros_like(init)
    for s, sh in enumerate(plan.shards):
        v = rp.svc0_flat[sh.perm]
        init[s, :len(v)] = rp.issue_flat[sh.perm] + v
        svc[s, :len(v)] = v
    comp, used, conv = zns_fixpoint_sharded(
        init.astype(np.float32), svc.astype(np.float32), st["blocks"],
        sweeps=sweeps, devices=jax.local_devices()[:1], adj=st["adj"])
    return plan, st, init, svc, (np.asarray(comp), np.asarray(used),
                                 np.asarray(conv))


@pytest.mark.parametrize("sweeps", [64, 1])
def test_plain_stacked_equals_reference_sharded_kernel_float32(tiers,
                                                               sweeps):
    _, rp = tiers
    plan, st, init, svc, (rc, ru, rk) = _reference_stack(rp, sweeps)
    got, used, conv = ops.zns_fixpoint_sharded(
        torch.as_tensor(init, dtype=torch.float32),
        torch.as_tensor(svc, dtype=torch.float32), st["blocks"],
        sweeps=sweeps, impl="torch", adj=st["adj"])
    assert got.shape == init.shape
    np.testing.assert_array_equal(used, ru)
    np.testing.assert_array_equal(conv, rk)
    assert conv.all() == (sweeps > 1)
    for s, sh in enumerate(plan.shards):
        n = len(sh.perm)
        np.testing.assert_allclose(got[s, :n].numpy(), rc[s, :n], **F32)


def test_plain_stacked_float64_equals_host_executor(tiers):
    _, rp = tiers
    plan, st, init, svc, _ = _reference_stack(rp, 64)
    got, used, conv = ops.zns_fixpoint_sharded(
        torch.as_tensor(init), torch.as_tensor(svc), st["blocks"],
        sweeps=64, impl="torch", adj=st["adj"])
    assert conv.all()
    comp = np.empty(rp.n_flat)
    for s, sh in enumerate(plan.shards):
        comp[sh.perm] = got[s, :len(sh.perm)].numpy()
    want, wu, _ = R.solve_program_sharded(rp, rp.svc0_flat, sweeps=64,
                                          executor="host")
    np.testing.assert_allclose(comp, want, **F64)
    assert used.max() == wu


def test_pack_stacked_keeps_each_shards_own_blocks(tiers):
    """The stacked signature's padding is cut shard by shard: each
    shard's blocks are its own program's."""
    pp, rp = tiers
    plan = rshard._plan(rp, None)
    st = rshard._mesh_static(plan, 1)
    packed = pfix.pack_stacked(st["blocks"], st["n_max"], "cpu", st["adj"])
    mine = pshard.shard_program(pp)
    assert packed.S == mine.n_shards == 3
    for s, sh in enumerate(mine.shards):
        own = [blk.rows_view() for blk in sh.program.families]
        views = packed.shard(s).views()
        assert len(views) == packed.F
        for f, (g, h) in enumerate(own):
            np.testing.assert_array_equal(views[f][0].numpy(), g)
            np.testing.assert_array_equal(views[f][1].numpy(), h)


def test_pack_shards_refuses_what_one_launch_cannot_hold():
    block = (np.zeros((1, 2), np.int32), np.ones((1, 2), bool))
    with pytest.raises(ValueError, match="one launch takes"):
        pfix.pack_shards([([block], 2, None)] * (pfix.MAX_SHARDS + 1), "cpu")
    wide = [block] * (pfix.MAX_FLAGS // 2 + 1)
    with pytest.raises(ValueError, match="one launch takes"):
        pfix.pack_shards([(wide, 2, None)] * 2, "cpu")
    with pytest.raises(ValueError, match="out of range"):
        pfix.pack_shards([([(np.full((1, 2), 5, np.int32),
                             np.ones((1, 2), bool))], 2, None)], "cpu")


# -- executors, environment and the device rule -------------------------------
def test_executor_environment_is_the_ports_own(tiers, monkeypatch):
    pp, _ = tiers
    monkeypatch.setenv("REPRO_SHARD_EXECUTOR", "mesh")
    pshard.solve_program_sharded(pp, pp.svc0_flat, sweeps=64, device="cpu")
    assert P.last_solve_stats().driver == "sharded/host"
    monkeypatch.setenv(pshard.EXECUTOR_ENV, "mesh")
    pshard.solve_program_sharded(pp, pp.svc0_flat, sweeps=64, device="cpu")
    assert P.last_solve_stats().driver == "sharded/mesh"
    assert pshard.EXECUTOR_ENV != rshard.EXECUTOR_ENV


def test_default_device_raises_without_cuda(tiers, monkeypatch):
    pp, _ = tiers
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (
            lambda: P.solve_program(pp, pp.svc0_flat, fixpoint="sharded"),
            lambda: P.solve_program(pp, pp.svc0_flat, fixpoint="windowed"),
            lambda: pshard.solve_program_sharded(pp, pp.svc0_flat),
            lambda: pshard.solve_program_windowed(pp, pp.svc0_flat)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
