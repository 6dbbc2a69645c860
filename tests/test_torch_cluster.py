"""The port's cluster tier held against the reference on the CPU.

The same inputs go through ``repro.cluster`` and ``repro_torch.cluster``
(``device="cpu"``: the fixpoint's plain PyTorch version in float64).
Tolerances:

* exact for integer arrays, chains, pop orders, labels and plans (the
  host lowering is the same numpy code in both packages);
* exact for event issue and service times (the same float64 numpy sums);
* rtol 1e-12 for float64 completions, latencies and every number of a
  :class:`CapacityReport` (the port's fixpoint and the reference's host
  loop associate their max-plus additions differently);
* ``TOL_US`` (1e-6 us) for the compiled program against the greedy
  event-engine oracle, as in ``tests/test_cluster.py``.

The behaviours of ``tests/test_cluster.py`` are asserted on the port
with fixed parametrised cases.
"""
import dataclasses
import warnings

import numpy as np
import pytest

import repro.cluster as R
import repro_torch.cluster as P
from repro.cluster.capacity import CapacityPoint as RCapacityPoint
from repro.core.metrics import LatencyStats as RLatencyStats
from repro_torch.cluster.capacity import CapacityPoint
from repro_torch.core.metrics import LatencyStats

RTOL = 1e-12
TOL_US = 1e-6
CPU = "cpu"

SMALL = dict(n_users=3, ops_per_user=4, get_fraction=0.5,
             object_bytes=1 << 20, seed=3)
CONTENDED = dict(n_users=16, ops_per_user=2, get_fraction=0.5,
                 object_bytes=1 << 20, seed=7)


def _scheme(pkg, kind, k, m):
    return pkg.erasure(k, m) if kind == "ec" else \
        pkg.replication(k, copies=m + 1)


def _specs(kind="ec", k=3, m=1, **kw):
    kw.setdefault("n_gateways", 2)
    kw.setdefault("n_servers", 6)
    return (P.ClusterSpec(scheme=_scheme(P, kind, k, m), **kw),
            R.ClusterSpec(scheme=_scheme(R, kind, k, m), **kw))


def _workloads(**kw):
    return P.ClusterWorkload(**kw), R.ClusterWorkload(**kw)


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64),
                               rtol=RTOL, atol=0.0, err_msg=what)


def _same_json(got, want, path="report"):
    """Equal structure; floats to RTOL, everything else exactly."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _same_json(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same_json(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert isinstance(got, float), path
        assert got == pytest.approx(want, rel=RTOL, abs=0.0), path
    else:
        assert got == want and type(got) is type(want), path


def _same_graph(got, want):
    assert got.n == want.n
    assert np.array_equal(got.issue, want.issue)
    assert np.array_equal(got.svc, want.svc)
    assert got.labels == want.labels
    assert [lbl for lbl, _ in got.paths] == [lbl for lbl, _ in want.paths]
    for (_, gc), (_, wc) in zip(got.paths, want.paths):
        assert gc == wc
    assert got.edges == want.edges
    assert [(r.label, r.cap, r.members, r.ordered) for r in got.resources] \
        == [(r.label, r.cap, r.members, r.ordered) for r in want.resources]
    for f in ("op_head", "op_tail", "op_slices"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert got.op_keys == want.op_keys
    assert [dataclasses.astuple(p) for p in got.plans] \
        == [dataclasses.astuple(p) for p in want.plans]
    for gs, ws in zip(got.servers, want.servers):
        assert (gs.sid, gs.cum, gs.inserts, gs.n_flush) \
            == (ws.sid, ws.cum, ws.inserts, ws.n_flush)
        assert gs.append_svc() == ws.append_svc()
    np.testing.assert_array_equal(got.dag_edges(), want.dag_edges())


def _same_program(got, want):
    for f in ("n_flat", "offsets", "exact", "multiclass_pools",
              "refine_used", "order_stable", "unstable_pools"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("issue_flat", "svc0_flat"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    for a, b in zip(got.orders + got.invs, want.orders + want.invs):
        assert np.array_equal(a, b)
    assert len(got.families) == len(want.families)
    for g, w in zip(got.families, want.families):
        assert (g.label, g.layout) == (w.label, w.layout)
        assert np.array_equal(g.gidx, w.gidx), g.label
        assert np.array_equal(g.heads, w.heads), g.label


def _same_chains(got, want):
    assert len(got) == len(want)
    for gc, wc in zip(got, want):
        assert len(gc) == len(wc)
        for a, b in zip(gc, wc):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def _same_compiled(got, want):
    _same_graph(got.graph, want.graph)
    _same_program(got.program, want.program)
    _same_chains(got.fifo_chains, want.fifo_chains)
    assert (got.converged, got.warm_start_used) \
        == (want.converged, want.warm_start_used)
    _close(got.comp, want.comp, "completions")
    _close(got.op_latencies(), want.op_latencies(), "op latencies")


def _same_report(got, want):
    _same_json(got.to_json(), want.to_json())
    assert (got.n_programs, got.n_events, got.converged,
            got.order_unstable, got.warm_hits, got.warm_attempts) \
        == (want.n_programs, want.n_events, want.converged,
            want.order_unstable, want.warm_hits, want.warm_attempts)
    assert [c.config.name for c in got.ranking()] \
        == [c.config.name for c in want.ranking()]
    for gc, wc in zip(got.curves, want.curves):
        for gp, wp in zip(gc.points, wc.points):
            _close(dataclasses.astuple(gp.lat), dataclasses.astuple(wp.lat),
                   f"{wc.config.name} latency stats")


# ---------------------------------------------------------------------------
# spec, codec, placement
# ---------------------------------------------------------------------------
SCHEMES = [("ec", 1, 0), ("ec", 4, 2), ("rep", 2, 2)]


@pytest.mark.parametrize("scheme", SCHEMES, ids=str)
@pytest.mark.parametrize("nbytes", [1, 7, 4096, (1 << 20) + 13])
def test_every_byte_in_exactly_one_data_shard(scheme, nbytes):
    ps, rs = _scheme(P, *scheme), _scheme(R, *scheme)
    ranges = ps.shard_ranges(nbytes)
    assert ranges == rs.shard_ranges(nbytes)
    assert len(ranges) == ps.k
    pos = 0
    for lo, hi in ranges:                # contiguous, disjoint, complete
        assert lo == pos and hi >= lo
        pos = hi
    assert pos == nbytes
    for off in {0, nbytes // 2, nbytes - 1} | ({1} if nbytes > 1 else set()):
        j = ps.shard_of_byte(nbytes, off)
        assert j == rs.shard_of_byte(nbytes, off)
        lo, hi = ranges[j]
        assert lo <= off < hi
    assert ps.shard_bytes(nbytes) == rs.shard_bytes(nbytes)


@pytest.mark.parametrize("name", ["ec4+2", "ec2+0", "rep2-k3", "rep3-k1"])
def test_scheme_names_roundtrip(name):
    ps, rs = P.parse_scheme(name), R.parse_scheme(name)
    assert dataclasses.astuple(ps) == dataclasses.astuple(rs)
    assert (ps.name, ps.n_shards) == (rs.name, rs.n_shards)
    assert P.parse_scheme(ps.name) == ps


def test_bad_schemes_raise_alike():
    for bad in ("raid6", "ec4", "rep-k2"):
        with pytest.raises(ValueError, match="unknown scheme"):
            P.parse_scheme(bad)
        with pytest.raises(ValueError, match="unknown scheme"):
            R.parse_scheme(bad)
    with pytest.raises(ValueError):
        P.replication(2, copies=0)
    with pytest.raises(ValueError, match="cannot reconstruct"):
        P.erasure(2, 0).read_slots([0, 1], down=0)


@pytest.mark.parametrize("scheme", [("ec", 3, 1), ("ec", 4, 2),
                                    ("rep", 2, 1), ("rep", 1, 2)], ids=str)
@pytest.mark.parametrize("down", [None, 0, 1, 2])
def test_degraded_slots_match_reference(scheme, down):
    ps, rs = _scheme(P, *scheme), _scheme(R, *scheme)
    servers = list(range(ps.n_shards))
    assert ps.write_slots(servers, down) == rs.write_slots(servers, down)
    assert ps.read_slots(servers, down) == rs.read_slots(servers, down)
    for s in range(ps.n_shards):
        assert ps.slot_is_data(s) == rs.slot_is_data(s)
    for j in range(ps.k):
        assert ps.copy_slots(j) == rs.copy_slots(j)


def test_rep_failover_and_ec_reconstruction_slots():
    rep = P.replication(2, copies=2)
    assert rep.read_slots([0, 1, 2, 3], down=None) == ([0, 2], False)
    assert rep.read_slots([0, 1, 2, 3], down=0) == ([1, 2], False)
    ec = P.erasure(3, 1)
    assert ec.read_slots([0, 1, 2, 3], down=1) == ([0, 2, 3], True)
    assert ec.write_slots([0, 1, 2, 3], down=1) == [0, 2, 3]


@pytest.mark.parametrize("policy", ["round-robin", "strided", "grouped",
                                    "hashed"])
@pytest.mark.parametrize("seed", [0, 5])
def test_placement_maps_match_reference(policy, seed):
    objects = np.arange(17)
    rows = P.placement_map(objects, n_shards=4, n_servers=9, policy=policy,
                           seed=seed)
    assert np.array_equal(rows, R.placement_map(
        objects, n_shards=4, n_servers=9, policy=policy, seed=seed))
    assert rows.shape == (17, 4) and rows.min() >= 0 and rows.max() < 9
    for r in rows:                       # distinct servers per object
        assert len(set(r.tolist())) == 4


def test_placement_registry_extensible():
    assert set(P.available_placements()) == set(R.available_placements())

    @P.register_placement("test-reversed")
    def _reversed(obj, n_shards, n_servers, seed):
        return (obj + np.arange(n_shards)[::-1]) % n_servers
    try:
        rows = P.placement_map(np.arange(3), 2, 5, policy="test-reversed")
        assert rows[0].tolist() == [1, 0]
        assert "test-reversed" not in R.available_placements()
    finally:
        P.PLACEMENTS.unregister("test-reversed")
    P.register_placement("test-dup", lambda o, n, s, seed: [0, 0])
    try:
        with pytest.raises(ValueError, match="co-located"):
            P.placement_map([0], 2, 4, policy="test-dup")
    finally:
        P.PLACEMENTS.unregister("test-dup")


@pytest.mark.parametrize("kw", [
    SMALL, dict(SMALL, qd=2, delete_fraction=0.2),
    dict(CONTENDED, get_fraction=0.3, delete_fraction=0.3)], ids=str)
def test_workload_build_matches_reference(kw):
    pw, rw = _workloads(**kw)
    for n_gateways in (1, 2, 4):
        assert [dataclasses.astuple(o) for o in pw.build(n_gateways)] \
            == [dataclasses.astuple(o) for o in rw.build(n_gateways)]


def test_open_loop_workload_matches_reference():
    from repro.core import PoissonArrivals as RPoisson
    from repro_torch.core import PoissonArrivals
    pw, rw = _workloads(**dict(SMALL, qd=4))
    pw = dataclasses.replace(pw, arrival=PoissonArrivals(8000.0, seed=3))
    rw = dataclasses.replace(rw, arrival=RPoisson(8000.0, seed=3))
    got, want = pw.build(2), rw.build(2)
    assert [dataclasses.astuple(o) for o in got] \
        == [dataclasses.astuple(o) for o in want]
    assert max(o.issue for o in got) > 0.0


def test_spec_validation_raises():
    with pytest.raises(ValueError, match="only 4 servers"):
        _specs("ec", 4, 2, n_servers=4)
    with pytest.raises(ValueError, match="durability"):
        _specs(durability="sync")
    with pytest.raises(ValueError, match="qd"):
        P.ClusterWorkload(qd=0)


# ---------------------------------------------------------------------------
# gateway planning and degraded mode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("down", [None, 0, 3])
@pytest.mark.parametrize("scheme,policy", [(("ec", 2, 1), "hashed"),
                                           (("rep", 2, 1), "grouped")],
                         ids=str)
def test_plan_workload_matches_reference(scheme, policy, down):
    ps, rs = _specs(*scheme, n_servers=8, placement=policy)
    pw, rw = _workloads(**SMALL)
    got = P.plan_workload(ps, pw.build(2), seed=3, down=down)
    want = R.plan_workload(rs, rw.build(2), seed=3, down=down)
    assert [dataclasses.astuple(p) for p in got] \
        == [dataclasses.astuple(p) for p in want]
    with pytest.raises(ValueError, match="down server"):
        P.plan_workload(ps, pw.build(2), down=8)


@pytest.mark.parametrize("scheme", [("ec", 2, 1), ("ec", 4, 2)], ids=str)
def test_ec_degraded_reconstruction_touches_exactly_m_extra(scheme):
    ps, rs = _specs(*scheme, n_servers=8, placement="hashed")
    pw, rw = _workloads(**SMALL)
    ops, rops = pw.build(2), rw.build(2)
    normal = P.build_graph(ps, ops, qd=1, seed=3, device=CPU)
    gets = [op for op in ops if op.kind == P.OP_GET]
    assert gets
    checked = 0
    for down in range(ps.n_servers):
        degraded = P.build_graph(ps, ops, qd=1, down=down, seed=3,
                                 device=CPU)
        rdeg = R.build_graph(rs, rops, qd=1, down=down, seed=3)
        for op in gets:
            after = P.touched_servers(degraded, op.seq)
            assert after == R.touched_servers(rdeg, op.seq)
            before = P.touched_servers(normal, op.seq)
            if down not in before:
                continue
            assert down not in after
            assert len(after - before) == ps.scheme.m
            checked += 1
        assert P.oracle.per_server_event_counts(degraded) \
            == R.oracle.per_server_event_counts(rdeg)
    assert checked > 0


def test_rep_degraded_failover_touches_one_replacement():
    ps, _ = _specs("rep", 2, 1, n_servers=8)
    pw, _ = _workloads(**SMALL)
    ops = pw.build(2)
    degraded = P.build_graph(ps, ops, qd=1, down=0, seed=3, device=CPU)
    normal = P.build_graph(ps, ops, qd=1, seed=3, device=CPU)
    for op in ops:
        if op.kind != P.OP_GET:
            continue
        before = P.touched_servers(normal, op.seq)
        after = P.touched_servers(degraded, op.seq)
        if 0 in before:
            assert 0 not in after and len(after - before) <= 1


# ---------------------------------------------------------------------------
# build_graph and compile_graph against the reference
# ---------------------------------------------------------------------------
#: tests/test_cluster.py's DIFF_CASES: (scheme, policy, durability, down,
#: qd), the scheme as (kind, k, m).
DIFF_CASES = [
    (("ec", 3, 1), "round-robin", "writeback", None, 1),
    (("ec", 4, 2), "hashed", "writeback", None, 2),
    (("ec", 2, 1), "strided", "write-through", 0, 1),
    (("rep", 2, 1), "grouped", "writeback", 0, 2),
    (("rep", 1, 2), "round-robin", "write-through", None, 2),
    (("ec", 3, 0), "hashed", "writeback", None, 1),
]


def _diff_case(scheme, policy, durability, down, qd):
    ps, rs = _specs(*scheme, n_servers=8, placement=policy,
                    durability=durability)
    pw, rw = _workloads(**dict(SMALL, qd=qd))
    return ps, rs, pw, rw


@pytest.mark.parametrize("case", DIFF_CASES, ids=str)
def test_build_graph_matches_reference(case):
    ps, rs, pw, rw = _diff_case(*case)
    down, qd = case[3], case[4]
    got = P.build_graph(ps, pw.build(2), qd=qd, down=down, seed=3,
                        device=CPU)
    want = R.build_graph(rs, rw.build(2), qd=qd, down=down, seed=3)
    _same_graph(got, want)
    for (gn, gc), (wn, wc) in zip(P.edge_families(got.edges),
                                  R.edge_families(want.edges)):
        assert gn == wn and len(gc) == len(wc)
        assert all(np.array_equal(a, b) for a, b in zip(gc, wc))


@pytest.mark.parametrize("case", DIFF_CASES, ids=str)
def test_compile_graph_matches_reference_and_oracle(case):
    ps, rs, pw, rw = _diff_case(*case)
    down = case[3]
    got = P.Cluster(ps, device=CPU).run(pw, down=down)
    want = R.Cluster(rs).run(rw, down=down)
    assert got.converged and got.compiled.program.order_stable
    _same_compiled(got.compiled, want.compiled)
    summ, rsumm = got.summary(), want.summary()
    assert set(summ) == set(rsumm)
    for k in rsumm:
        assert summ[k] == pytest.approx(rsumm[k], rel=RTOL, abs=0.0), k
    # the oracle: bit-equal to the reference's on the same graph, and the
    # port's program within TOL_US of it
    oracle = P.simulate_graph(got.compiled.graph)
    assert np.array_equal(oracle, R.simulate_graph(want.compiled.graph))
    assert float(np.max(np.abs(got.comp - oracle))) < TOL_US
    lat_o = P.oracle_op_latencies(got.compiled.graph)
    np.testing.assert_allclose(got.op_latencies(), lat_o, atol=TOL_US)
    assert np.all(got.op_latencies() > 0)


def test_helpers_match_reference():
    from repro.cluster import compiler as rc
    from repro_torch.cluster import compiler as pc
    assert (pc.MAX_REFINE, pc.READY_QUANTUM_US) \
        == (rc.MAX_REFINE, rc.READY_QUANTUM_US)
    members = np.arange(11, dtype=np.int64) * 3
    for cap in (1, 2, 4, 16):
        _same_chains([pc._lag_chains(members, cap)],
                     [rc._lag_chains(members, cap)])
    ps, rs, pw, rw = _diff_case(*DIFF_CASES[0])
    g = P.build_graph(ps, pw.build(2), seed=3, device=CPU)
    w = R.build_graph(rs, rw.build(2), seed=3)
    ready = np.random.default_rng(0).uniform(0, 1e4, g.n)
    # genuine ties on the quantum grid break by issue, then index
    ready[::3] = ready[0]
    for rp, rr in zip(g.resources, w.resources):
        if not rp.ordered:
            _same_chains([pc._fifo_replay_chains(rp, g, ready)],
                         [rc._fifo_replay_chains(rr, w, ready)])
    dag = g.dag_edges()
    assert np.array_equal(pc._graph_ready(g, dag, ready),
                          rc._graph_ready(w, dag, ready))


def test_multiclass_pools_stay_exact():
    ps, rs = _specs(durability="write-through")
    ps = dataclasses.replace(ps, device_spec=dataclasses.replace(
        ps.device_spec, read_parallelism=2))
    rs = dataclasses.replace(rs, device_spec=dataclasses.replace(
        rs.device_spec, read_parallelism=2))
    pw, rw = _workloads(**dict(SMALL, n_users=4, ops_per_user=6,
                               get_fraction=0.7))

    def halve(ops):
        return [dataclasses.replace(op, nbytes=op.nbytes // (1 + op.obj % 2))
                for op in ops]
    got = P.compile_graph(P.build_graph(ps, halve(pw.build(2)), seed=0,
                                        device=CPU), device=CPU)
    want = R.compile_graph(R.build_graph(rs, halve(rw.build(2)), seed=0))
    _same_compiled(got, want)
    assert got.program.exact and got.program.order_stable
    assert got.program.multiclass_pools
    np.testing.assert_allclose(got.comp, P.simulate_graph(got.graph),
                               rtol=1e-9, atol=1e-6)


def test_loop_driver_matches_auto():
    ps, _ = _specs()
    pw, _ = _workloads(**SMALL)
    auto = P.Cluster(ps, device=CPU).run(pw)
    loop = P.Cluster(ps, device=CPU).run(pw, fixpoint="loop")
    _same_chains(loop.compiled.fifo_chains, auto.compiled.fifo_chains)
    _same_program(loop.compiled.program, auto.compiled.program)
    _close(loop.comp, auto.comp, "loop against auto")


def test_run_oracle_matches_reference():
    ps, rs = _specs()
    pw, rw = _workloads(**SMALL)
    got = P.Cluster(ps, device=CPU).run_oracle(pw, down=1)
    want = R.Cluster(rs).run_oracle(rw, down=1)
    assert got.engine == "oracle" and got.compiled.program is None
    assert np.array_equal(got.comp, want.comp)
    assert got.summary() == want.summary()


def test_oracle_rejects_cyclic_graph():
    ps, _ = _specs()
    pw, _ = _workloads(**SMALL)
    graph = P.build_graph(ps, pw.build(2), seed=3, device=CPU)
    bad = dataclasses.replace(
        graph, edges=graph.edges + [("cycle", graph.n - 1, 0)])
    with pytest.raises(ValueError, match="cycle"):
        P.simulate_graph(bad)


def test_writeback_shard_too_large_for_buffer_raises():
    ps, _ = _specs("ec", 1, 0)
    pw, _ = _workloads(**dict(SMALL, object_bytes=64 << 20))
    with pytest.raises(ValueError, match="writeback"):
        P.Cluster(ps, device=CPU).compile(pw)


def test_default_device_is_cuda_and_raises_without_it():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ps, _ = _specs()
    pw, _ = _workloads(**SMALL)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.Cluster(ps).run(pw)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.plan_capacity([P.ClusterConfig(P.erasure(2, 1), "round-robin")],
                        [2], base_spec=ps, workload=pw)


# ---------------------------------------------------------------------------
# refinement budget exhaustion
# ---------------------------------------------------------------------------
def test_exhausted_refine_budget_warns_like_reference():
    ps, rs = _specs()
    pw, rw = _workloads(**CONTENDED)
    with pytest.warns(RuntimeWarning,
                      match=r"max_refine=0.*unstable FIFO pools: \S"):
        got = P.Cluster(ps, device=CPU).run(pw, max_refine=0)
    with pytest.warns(RuntimeWarning, match=r"max_refine=0"):
        want = R.Cluster(rs).run(rw, max_refine=0)
    prog = got.compiled.program
    assert prog.order_stable is False and prog.exact is False
    assert prog.refine_used == 1
    assert prog.unstable_pools == want.compiled.program.unstable_pools
    assert prog.unstable_pools
    _same_compiled(got.compiled, want.compiled)
    assert np.all(np.isfinite(got.comp))
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*order refinement.*")
        stable = P.Cluster(ps, device=CPU).run(pw)
    assert stable.compiled.program.order_stable and stable.converged


def test_plan_capacity_reports_order_unstable_configs():
    ps, rs = _specs()
    pw, rw = _workloads(**dict(CONTENDED, ops_per_user=1))
    kw = dict(slo_us=20e3, degraded=False, max_refine=0)
    with pytest.warns(RuntimeWarning, match="order refinement"):
        got = P.plan_capacity(
            [P.ClusterConfig(P.erasure(2, 1), "round-robin")], [16],
            workload=pw, base_spec=ps, device=CPU, **kw)
    with pytest.warns(RuntimeWarning, match="order refinement"):
        want = R.plan_capacity(
            [R.ClusterConfig(R.erasure(2, 1), "round-robin")], [16],
            workload=rw, base_spec=rs, **kw)
    assert got.order_unstable == ("ec2+1/round-robin",)
    _same_report(got, want)


# ---------------------------------------------------------------------------
# capacity planning
# ---------------------------------------------------------------------------
def _configs(pkg):
    return [pkg.ClusterConfig(pkg.erasure(2, 1), "round-robin"),
            pkg.ClusterConfig(pkg.replication(2, copies=2), "hashed")]


@pytest.mark.parametrize("mode", ["users", "users-warm", "rate",
                                  "rate-warm"])
def test_plan_capacity_matches_reference(mode):
    ps, rs = _specs()
    pw, rw = _workloads(**dict(SMALL, ops_per_user=3))
    # 64 sweeps: a warm users-ladder rung's seeded pop orders can make a
    # refinement solve diverge (in both packages); it then stops at the
    # budget and falls back cold, so the budget bounds the test's time
    kw = dict(slo_us=20e3, warm_ladder=mode.endswith("warm"), sweeps=64)
    if mode.startswith("rate"):
        kw["rate_ladder"] = [2000.0, 8000.0, 32000.0]
    got = P.plan_capacity(_configs(P), [2, 4], workload=pw, base_spec=ps,
                          device=CPU, **kw)
    want = R.plan_capacity(_configs(R), [2, 4], workload=rw, base_spec=rs,
                           **kw)
    _same_report(got, want)
    n_rungs = 3 if mode.startswith("rate") else 2
    assert got.converged and got.n_programs == 2 * n_rungs * 2
    assert {c.degraded for c in got.curves} == {False, True}
    for cfg in _configs(P):
        normal = next(c for c in got.curves
                      if c.config == cfg and not c.degraded)
        assert got.degraded_curve(cfg) is not None
        assert normal.load_at_slo >= 0.0
    if kw["warm_ladder"]:
        assert 0 < got.warm_attempts
    else:
        assert (got.warm_hits, got.warm_attempts) == (0, 0)


def test_warm_ladder_curves_equal_cold():
    ps, _ = _specs()
    pw, _ = _workloads(**dict(SMALL, ops_per_user=3))
    kw = dict(slo_us=20e3, rate_ladder=[2000.0, 8000.0, 32000.0],
              degraded=False, device=CPU)
    cold = P.plan_capacity(_configs(P)[:1], [], workload=pw, base_spec=ps,
                           **kw)
    warm = P.plan_capacity(_configs(P)[:1], [], workload=pw, base_spec=ps,
                           warm_ladder=True, **kw)
    assert [c.to_json() for c in warm.curves] \
        == [c.to_json() for c in cold.curves]
    assert warm.warm_hits <= warm.warm_attempts == 2


def test_plan_capacity_one_call_matches_per_config_run():
    ps, _ = _specs()
    pw, _ = _workloads(**dict(SMALL, ops_per_user=3))
    cfg = _configs(P)[0]
    report = P.plan_capacity([cfg], [2, 4], workload=pw, base_spec=ps,
                             slo_us=20e3, device=CPU)
    spec = dataclasses.replace(ps, scheme=cfg.scheme,
                               placement=cfg.placement)
    solo = P.Cluster(spec, device=CPU).run(dataclasses.replace(pw,
                                                               n_users=2))
    curve = next(c for c in report.curves if not c.degraded)
    point = next(p for p in curve.points if p.users == 2)
    assert point.lat.p99_us == pytest.approx(
        solo.latency_stats().p99_us, abs=TOL_US)


@pytest.mark.parametrize("pts,slo", [
    ([], 100.0), ([(2, 500.0)], 100.0), ([(2, 50.0), (8, 90.0)], 100.0),
    ([(2, 50.0), (8, 200.0)], 100.0), ([(2, 50.0), (4, 50.0)], 10.0)])
def test_load_at_slo_matches_reference(pts, slo):
    def points(point_cls, stats_cls, rate):
        return [point_cls(users=u, objects_per_sec=1.0,
                          lat=stats_cls(mean_us=p, p50_us=p, p95_us=p,
                                        p99_us=p, p999_us=p, n=10),
                          slo_violation_rate=0.0, converged=True,
                          offered_rate=1e3 * u if rate else None)
                for u, p in pts]
    for rate in (False, True):
        got = points(CapacityPoint, LatencyStats, rate)
        want = points(RCapacityPoint, RLatencyStats, rate)
        assert P.users_at_slo(got, slo) == R.users_at_slo(want, slo)
        assert P.rate_at_slo(got, slo) == R.rate_at_slo(want, slo)
    mid = P.users_at_slo(points(CapacityPoint, LatencyStats, False), slo)
    if len(pts) == 2 and pts[1][1] > slo > pts[0][1]:
        assert pts[0][0] < mid < pts[1][0]


@pytest.mark.parametrize("module", ["repro_torch.cluster.codec",
                                    "repro_torch.cluster.placement",
                                    "repro_torch.cluster.cluster"])
def test_docstring_examples_run(module):
    import doctest
    import importlib
    res = doctest.testmod(importlib.import_module(module), verbose=False,
                          optionflags=doctest.NORMALIZE_WHITESPACE)
    assert res.attempted > 0 and res.failed == 0, res
