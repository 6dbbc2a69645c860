"""The conformance suite of ``tests/test_zns_conformance.py`` on the
port: the zone state machine's ``ZoneError`` taxonomy, the vectorized
transition table, and the differential harness of
``repro_torch.host.conformance``, whose reports must equal the
reference's on the same op sequences; the legal flows simulate on both
backends (``device="cpu"``)."""
import dataclasses

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as P
from repro.host import conformance as rconf
from repro_torch.core import (
    KiB, OpType, Trace, WorkloadSpec, ZnsDevice, ZoneError, ZoneManager,
    ZoneState, spec_from_dict,
)
from repro_torch.core.state_machine import TRANSITION_TABLE, transition_array
from repro_torch.host.conformance import (Violation, differential_check,
                                          replay_trace, table_ok)
from strategies import SMALL_SPEC as R_SMALL_SPEC

SMALL_SPEC = spec_from_dict(dataclasses.asdict(R_SMALL_SPEC))
BACKENDS = ("event", "vectorized")


def _full_zone(zm, z):
    zm.write(z, SMALL_SPEC.zone_cap_bytes)
    assert zm.state(z) == ZoneState.FULL


# ---------------------------------------------------------------------------
# Write / append addressing and capacity
# ---------------------------------------------------------------------------
def test_write_at_non_wp_offset_rejected():
    zm = ZoneManager(SMALL_SPEC)
    zm.write(1, 8 * KiB, at=0)                      # at == wp: fine
    with pytest.raises(ZoneError, match="invalid write"):
        zm.write(1, 4 * KiB, at=0)                  # stale offset
    with pytest.raises(ZoneError, match="invalid write"):
        zm.write(1, 4 * KiB, at=64 * KiB)           # ahead of wp
    zm.write(1, 4 * KiB, at=8 * KiB)                # exact wp again


def test_append_ignores_offset_and_returns_lba():
    zm = ZoneManager(SMALL_SPEC)
    lba = zm.write(2, 4 * KiB, append=True, at=999)   # offset ignored
    assert lba == SMALL_SPEC.zone_start(2)


def test_append_beyond_zone_capacity_rejected():
    zm = ZoneManager(SMALL_SPEC)
    cap = SMALL_SPEC.zone_cap_bytes
    zm.write(0, cap - 4 * KiB, append=True)
    with pytest.raises(ZoneError, match="overflow"):
        zm.write(0, 8 * KiB, append=True)
    zm.write(0, 4 * KiB, append=True)               # exact fill is legal
    assert zm.state(0) == ZoneState.FULL
    with pytest.raises(ZoneError, match="FULL"):
        zm.write(0, 4 * KiB, append=True)


def test_open_limit_exceeded_taxonomy():
    zm = ZoneManager(SMALL_SPEC)
    for z in range(SMALL_SPEC.max_open_zones):
        zm.open(z)
    with pytest.raises(ZoneError, match="max open zone limit"):
        zm.open(SMALL_SPEC.max_open_zones)
    with pytest.raises(ZoneError, match="max open zone limit"):
        zm.write(SMALL_SPEC.max_open_zones, 4 * KiB)   # implicit open too
    for z in range(SMALL_SPEC.max_open_zones):
        zm.close(z)
    for z in range(SMALL_SPEC.max_open_zones, SMALL_SPEC.max_active_zones):
        zm.open(z)
    with pytest.raises(ZoneError, match="max active zone limit"):
        zm.write(SMALL_SPEC.max_active_zones + 1, 4 * KiB)


def test_read_across_zone_boundary_rejected():
    zm = ZoneManager(SMALL_SPEC)
    zm.read(0, 0, SMALL_SPEC.zone_size_bytes)           # whole zone: fine
    with pytest.raises(ZoneError, match="boundary"):
        zm.read(0, SMALL_SPEC.zone_size_bytes - 4 * KiB, 8 * KiB)
    with pytest.raises(ZoneError, match="boundary"):
        zm.read(0, -1, 4 * KiB)
    with pytest.raises(ZoneError, match="<= 0"):
        zm.read(0, 0, 0)


# ---------------------------------------------------------------------------
# Reset / finish from every state (manager vs vectorized table agree)
# ---------------------------------------------------------------------------
def _zone_in_state(state: ZoneState) -> ZoneManager:
    zm = ZoneManager(SMALL_SPEC)
    if state == ZoneState.IMPLICIT_OPEN:
        zm.write(0, 4 * KiB)
    elif state == ZoneState.EXPLICIT_OPEN:
        zm.open(0)
    elif state == ZoneState.CLOSED:
        zm.write(0, 4 * KiB)
        zm.close(0)
    elif state == ZoneState.FULL:
        _full_zone(zm, 0)
    assert zm.state(0) == state
    return zm


_REACHABLE = (ZoneState.EMPTY, ZoneState.IMPLICIT_OPEN,
              ZoneState.EXPLICIT_OPEN, ZoneState.CLOSED, ZoneState.FULL)


@pytest.mark.parametrize("state", _REACHABLE, ids=lambda s: s.name)
def test_reset_from_every_state(state):
    zm = _zone_in_state(state)
    zm.reset(0)                                  # legal from all of these
    assert zm.state(0) == ZoneState.EMPTY
    assert zm.write_pointer(0) == 0
    nxt, ok = transition_array(np.array([int(state)]),
                               np.array([int(OpType.RESET)]))
    assert bool(np.asarray(ok)[0])
    assert int(np.asarray(nxt)[0]) == int(ZoneState.EMPTY)


@pytest.mark.parametrize("state", _REACHABLE, ids=lambda s: s.name)
def test_finish_from_every_state(state):
    zm = _zone_in_state(state)
    legal = state in (ZoneState.IMPLICIT_OPEN, ZoneState.EXPLICIT_OPEN,
                      ZoneState.CLOSED)
    nxt, ok = transition_array(np.array([int(state)]),
                               np.array([int(OpType.FINISH)]))
    assert bool(np.asarray(ok)[0]) == legal      # table matches manager
    if legal:
        zm.finish(0)
        assert zm.state(0) == ZoneState.FULL
        assert zm.write_pointer(0) == SMALL_SPEC.zone_cap_bytes
        assert int(np.asarray(nxt)[0]) == int(ZoneState.FULL)
    else:
        with pytest.raises(ZoneError, match="not permitted"):
            zm.finish(0)


def test_transition_table_rejects_offline_everything():
    off = int(ZoneState.OFFLINE)
    assert (TRANSITION_TABLE[off] == -1).all()


# ---------------------------------------------------------------------------
# Trace-level conformance: differential harness + both backends
# ---------------------------------------------------------------------------
def _conformance_workload(core, spec) -> WorkloadSpec:
    """A legality gauntlet: fills, overflow attempt, open-limit breach,
    finish/reset cycling, mixed reads."""
    cap = spec.zone_cap_bytes
    return (core.WorkloadSpec()
            .appends(n=3, size=cap // 2, qd=1, zone=0)
            .writes(n=2, size=4 * KiB, qd=1, zone=1)
            .opens(n=spec.max_open_zones + 2, zone=2,
                   nzones=spec.max_open_zones + 2)
            .finishes(n=1, occupancy=0.1, zone=1)
            .resets(n=2, occupancy=1.0, zone=1)
            .reads(n=6, size=4 * KiB, qd=2, zone=0, nzones=3))


def _assert_reports_equal(got, want):
    """Two differential_check reports: equal verdicts, masks, and
    violations (index, op, zone and error text)."""
    assert set(got) == set(want)
    for key in ("ok_manager", "ok_table", "table_only_rejections"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in ("violations", "unexplained_manager_rejections"):
        assert [(v.index, int(v.op), v.zone, v.error) for v in got[key]] \
            == [(v.index, int(v.op), v.zone, v.error) for v in want[key]], key
    assert got["consistent"] == want["consistent"]


def test_differential_manager_vs_table_consistent():
    rep = differential_check(_conformance_workload(P, SMALL_SPEC),
                             SMALL_SPEC)
    assert rep["consistent"], rep["unexplained_manager_rejections"]
    assert len(rep["violations"]) > 0           # the gauntlet does violate
    kinds = " ".join(v.error for v in rep["violations"])
    assert "limit" in kinds                     # open-limit breach seen
    assert all(isinstance(v, Violation) for v in rep["violations"])
    want = rconf.differential_check(
        _conformance_workload(R, R_SMALL_SPEC), R_SMALL_SPEC)
    _assert_reports_equal(rep, want)


def test_replay_collects_taxonomy_not_exceptions():
    ok, violations = replay_trace(_conformance_workload(P, SMALL_SPEC),
                                  SMALL_SPEC)
    assert ok.dtype == bool and (~ok).sum() == len(violations)
    for v in violations:
        assert isinstance(v.op, OpType) and v.error
        assert str(v).startswith(f"[{v.index}] {v.op.name}")
    rok, rviol = rconf.replay_trace(_conformance_workload(R, R_SMALL_SPEC),
                                    R_SMALL_SPEC)
    np.testing.assert_array_equal(ok, rok)
    assert [str(v) for v in violations] == [str(v) for v in rviol]


def test_zero_size_write_rejected_by_both_semantics():
    tr = Trace.build(op=[int(OpType.WRITE)], zone=[0], size=[0],
                     issue=[0.0])
    ok_zm, violations = replay_trace(tr, SMALL_SPEC)
    assert not ok_zm[0] and "<= 0 bytes" in violations[0].error
    assert not table_ok(tr, SMALL_SPEC)[0]
    rep = differential_check(tr, SMALL_SPEC)
    assert rep["consistent"]
    rtr = R.Trace.build(op=[int(OpType.WRITE)], zone=[0], size=[0],
                        issue=[0.0])
    _assert_reports_equal(rep, rconf.differential_check(rtr, R_SMALL_SPEC))


def test_table_ok_tracks_capacity_fill():
    cap = SMALL_SPEC.zone_cap_bytes
    wl = WorkloadSpec().appends(n=3, size=cap // 2, qd=1, zone=0)
    ok = table_ok(wl, SMALL_SPEC)
    assert ok.tolist() == [True, True, False]
    ok_pure = table_ok(wl, SMALL_SPEC, track_capacity=False)
    assert ok_pure.all()                        # pure table can't see wp


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_differential_reports_equal_reference_on_random_sequences(seed):
    """Random op sequences over a few zones, every op kind and size 0 to
    past the zone capacity: the port's replay, table and report equal the
    reference's."""
    rng = np.random.default_rng(seed)
    n = 400
    ops = rng.choice([int(o) for o in (OpType.READ, OpType.WRITE,
                                       OpType.APPEND, OpType.RESET,
                                       OpType.FINISH, OpType.OPEN,
                                       OpType.CLOSE)], size=n)
    zone = rng.integers(0, SMALL_SPEC.max_active_zones + 3, size=n)
    size = rng.choice([0, 4 * KiB, 64 * KiB,
                       SMALL_SPEC.zone_cap_bytes // 3], size=n)
    issue = np.sort(rng.uniform(0, 1e4, n))
    kw = dict(op=ops, zone=zone, size=size, issue=issue)
    rep = differential_check(Trace.build(**kw), SMALL_SPEC)
    want = rconf.differential_check(R.Trace.build(**kw), R_SMALL_SPEC)
    _assert_reports_equal(rep, want)
    assert len(rep["violations"]) > 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_legal_conformance_flows_simulate_on_both_backends(backend):
    wl = (WorkloadSpec()
          .appends(n=8, size=64 * KiB, qd=2, zone=0)
          .writes(n=8, size=4 * KiB, qd=1, zone=1)
          .finishes(n=1, occupancy=0.5, zone=1)
          .resets(n=4, occupancy=1.0, zone=0, nzones=4)
          .reads(n=12, size=4 * KiB, qd=4, zone=0, nzones=4))
    ok, violations = replay_trace(wl, SMALL_SPEC)
    assert ok.all(), violations                 # flow is fully legal
    res = ZnsDevice(SMALL_SPEC, device="cpu").run(wl, backend=backend,
                                                  jitter=False)
    assert res.backend == backend
    assert (res.sim.complete >= res.sim.start).all()
    assert len(res) == len(wl.build())


def test_both_backends_agree_on_conformance_flow():
    wl = (WorkloadSpec()
          .appends(n=16, size=64 * KiB, qd=2, zone=0)
          .resets(n=4, occupancy=1.0, zone=0, nzones=4,
                  io_ctx=OpType.APPEND)
          .reads(n=16, size=4 * KiB, qd=4, zone=0, nzones=4))
    dev = ZnsDevice(SMALL_SPEC, device="cpu")
    ev = dev.run(wl, backend="event", jitter=False)
    vec = dev.run(wl, backend="vectorized", jitter=False)
    np.testing.assert_allclose(ev.sim.complete, vec.sim.complete,
                               rtol=1e-9, atol=1e-6)
