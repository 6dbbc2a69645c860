"""The port's host layer (zone allocator and reclaim scheduler) held
against the reference on the CPU.

The behaviours of the allocator and reclaim sections of
``tests/test_host.py`` are asserted on the port, and the same sequences
of calls go through both packages: extents, reports and compiled
reclaim traces must be equal.  The spec is the reference's small test
geometry, carried into the port with ``spec_from_dict``.
"""
import dataclasses
import warnings

import numpy as np
import pytest

import repro.core as R
import repro.host as RH
import repro_torch.core as P
import repro_torch.host as PH
from repro_torch.core import KiB, OpType, ZoneError, ZoneState, ZnsDevice
from repro_torch.host import (
    Extent, ReclaimScheduler, ZoneAllocator, available_placement_policies,
    register_placement_policy, unregister_placement_policy,
)
from strategies import SMALL_SPEC as R_SMALL_SPEC

POLICIES = ("greedy-open", "striped", "lifetime-binned")
SMALL_SPEC = P.spec_from_dict(dataclasses.asdict(R_SMALL_SPEC))
TRACE_FIELDS = ("op", "zone", "size", "issue", "thread", "qd", "occupancy",
                "was_finished", "io_ctx")


def _spec(**kw):
    return P.ZNSDeviceSpec(**kw), R.ZNSDeviceSpec(**kw)


def _extents(extents):
    return [(e.zone, e.offset, e.nbytes) for e in extents]


# ---------------------------------------------------------------------------
# ZoneAllocator
# ---------------------------------------------------------------------------
def test_builtin_policies_registered():
    assert set(POLICIES) <= set(available_placement_policies())
    assert set(available_placement_policies()) \
        == set(RH.available_placement_policies())


@pytest.mark.parametrize("policy", POLICIES)
def test_bytes_placed_equals_bytes_requested(policy):
    alloc = ZoneAllocator(SMALL_SPEC, policy=policy)
    for nbytes in (1, 4 * KiB, SMALL_SPEC.zone_cap_bytes,
                   int(2.5 * SMALL_SPEC.zone_cap_bytes)):
        extents = alloc.allocate(nbytes, stream=1, lifetime=0)
        assert sum(e.nbytes for e in extents) == nbytes
        for e in extents:
            assert 0 <= e.offset and e.end <= SMALL_SPEC.zone_cap_bytes
    assert alloc.bytes_placed == 1 + 4 * KiB + int(
        3.5 * SMALL_SPEC.zone_cap_bytes)


@pytest.mark.parametrize("policy", POLICIES)
def test_limits_never_exceeded(policy):
    alloc = ZoneAllocator(SMALL_SPEC, policy=policy, stripe_width=8,
                          lifetime_bins=8)
    for i in range(40):
        alloc.allocate(96 * KiB, stream=i % 5, lifetime=i % 8)
        assert alloc.open_count <= SMALL_SPEC.max_open_zones
        assert alloc.active_count <= SMALL_SPEC.max_active_zones


@pytest.mark.parametrize("policy", POLICIES)
def test_placements_equal_reference(policy):
    kw = dict(policy=policy, stripe_width=3, stripe_bytes=64 * KiB,
              lifetime_bins=3, reserved=(1,))
    got = ZoneAllocator(SMALL_SPEC, **kw)
    want = RH.ZoneAllocator(R_SMALL_SPEC, **kw)
    for i in range(30):
        nbytes = (i % 7 + 1) * 40 * KiB
        a = got.allocate(nbytes, stream=i % 4, lifetime=i % 5)
        b = want.allocate(nbytes, stream=i % 4, lifetime=i % 5)
        assert _extents(a) == _extents(b), i
    assert (got.bytes_placed, got.zones_opened, got.open_count,
            got.active_count) == (want.bytes_placed, want.zones_opened,
                                  want.open_count, want.active_count)
    assert repr(got) == repr(want)


def test_greedy_open_fills_partial_zone_first():
    alloc = ZoneAllocator(SMALL_SPEC, policy="greedy-open")
    first = alloc.allocate(SMALL_SPEC.zone_cap_bytes // 2)
    second = alloc.allocate(SMALL_SPEC.zone_cap_bytes // 4)
    assert second[0].zone == first[0].zone
    assert second[0].offset == first[0].end
    alloc.allocate(SMALL_SPEC.zone_cap_bytes)
    assert alloc.zm.state(first[0].zone) == ZoneState.FULL
    assert not alloc.zm.zones[first[0].zone].was_finished


def test_striped_policy_rotates_zones():
    alloc = ZoneAllocator(SMALL_SPEC, policy="striped",
                          stripe_bytes=16 * KiB, stripe_width=3)
    extents = alloc.allocate(96 * KiB)
    assert len({e.zone for e in extents}) == 3
    assert all(e.nbytes <= 16 * KiB for e in extents)


def test_lifetime_binned_separates_lifetimes():
    alloc = ZoneAllocator(SMALL_SPEC, policy="lifetime-binned",
                          lifetime_bins=4)
    a = alloc.allocate(64 * KiB, lifetime=0)
    b = alloc.allocate(64 * KiB, lifetime=1)
    a2 = alloc.allocate(64 * KiB, lifetime=0)
    assert a[0].zone != b[0].zone
    assert a2[0].zone == a[0].zone


def test_lifetime_binned_respects_limits_with_many_bins():
    spec, _ = _spec(zone_size_bytes=1 << 20, zone_cap_bytes=1 << 19,
                    num_zones=32, max_open_zones=2, max_active_zones=2)
    alloc = ZoneAllocator(spec, policy="lifetime-binned", lifetime_bins=8)
    for lt in range(8):
        alloc.allocate(32 * KiB, lifetime=lt)
        assert alloc.open_count <= spec.max_open_zones
        assert alloc.active_count <= spec.max_active_zones


def test_reserved_zones_never_used():
    alloc = ZoneAllocator(SMALL_SPEC, policy="greedy-open", reserved=(0, 1))
    extents = alloc.allocate(3 * SMALL_SPEC.zone_cap_bytes)
    assert all(e.zone >= 2 for e in extents)


def test_device_full_raises_zone_error():
    spec, _ = _spec(zone_size_bytes=1 << 20, zone_cap_bytes=1 << 19,
                    num_zones=4, max_open_zones=2, max_active_zones=2)
    alloc = ZoneAllocator(spec, policy="greedy-open")
    alloc.allocate(4 * spec.zone_cap_bytes)
    with pytest.raises(ZoneError, match="device full"):
        alloc.allocate(4 * KiB)
    with pytest.raises(ZoneError, match="allocation of 0 bytes"):
        alloc.plan(0)


def test_commit_rejects_stale_plans():
    alloc = ZoneAllocator(SMALL_SPEC)
    plan = alloc.plan(8 * KiB)
    alloc.allocate(4 * KiB)
    with pytest.raises(ZoneError, match="stale plan"):
        alloc.commit(plan)


def test_register_placement_policy_collision_warns():
    def fake(alloc, view, hint, remaining):
        raise AssertionError("never called")
    try:
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            register_placement_policy("collide-pol", fake)
            assert not w
            register_placement_policy("collide-pol", lambda *a, **k: None)
            assert len(w) == 1 and "already registered" in str(w[0].message)
        # the registries of the two packages are separate
        assert "collide-pol" not in RH.available_placement_policies()
    finally:
        unregister_placement_policy("collide-pol")
    assert "collide-pol" not in available_placement_policies()
    with pytest.raises(KeyError, match="unknown placement policy"):
        ZoneAllocator(SMALL_SPEC, policy="collide-pol")


# ---------------------------------------------------------------------------
# ReclaimScheduler
# ---------------------------------------------------------------------------
def _device():
    return ZnsDevice(SMALL_SPEC)


def test_reclaim_charges_obs13_inflation():
    dev = _device()
    dev.zones.write(0, SMALL_SPEC.zone_cap_bytes)
    quiet = ReclaimScheduler(ZnsDevice(SMALL_SPEC), io_ctx=OpType.APPEND)
    quiet.zm.write(0, SMALL_SPEC.zone_cap_bytes)
    loud = ReclaimScheduler(dev, io_ctx=OpType.APPEND)
    quiet.schedule([0])
    loud.schedule([0])
    iso = quiet.drain(concurrent_io=False)
    conc = loud.drain(concurrent_io=True)
    infl = float(dev.lat.reset_inflation([OpType.APPEND]))
    assert infl > 1.5
    assert conc.seconds == pytest.approx(iso.seconds * infl, rel=1e-9)
    assert conc.write_amplification == 1.0
    # the reference costs the same drain identically
    rdev = R.ZnsDevice(R_SMALL_SPEC)
    rdev.zones.write(0, R_SMALL_SPEC.zone_cap_bytes)
    ref = RH.ReclaimScheduler(rdev, io_ctx=R.OpType.APPEND)
    ref.schedule([0])
    assert dataclasses.astuple(ref.drain(concurrent_io=True)) \
        == dataclasses.astuple(conc)


def test_reclaim_relocation_accounts_write_amplification():
    dev = _device()
    alloc = ZoneAllocator(zones=dev.zones, policy="greedy-open")
    sched = ReclaimScheduler(dev, allocator=alloc, io_ctx=OpType.APPEND,
                             relocation_stripe=64 * KiB)
    ext = alloc.allocate(SMALL_SPEC.zone_cap_bytes)
    sched.account(ext)
    victim = ext[0].zone
    sched.invalidate([Extent(victim, 0, SMALL_SPEC.zone_cap_bytes // 2)])
    sched.schedule([victim])
    rep = sched.drain()
    assert rep.zones_reset == 1
    assert rep.relocated_bytes == SMALL_SPEC.zone_cap_bytes // 2
    assert rep.write_amplification == pytest.approx(1.5, rel=1e-6)
    assert rep.reclaim_mibs > 0

    rdev = R.ZnsDevice(R_SMALL_SPEC)
    ralloc = RH.ZoneAllocator(zones=rdev.zones, policy="greedy-open")
    ref = RH.ReclaimScheduler(rdev, allocator=ralloc,
                              io_ctx=R.OpType.APPEND,
                              relocation_stripe=64 * KiB)
    rext = ralloc.allocate(R_SMALL_SPEC.zone_cap_bytes)
    ref.account(rext)
    ref.invalidate([RH.Extent(victim, 0, R_SMALL_SPEC.zone_cap_bytes // 2)])
    ref.schedule([victim])
    assert dataclasses.astuple(ref.drain()) == dataclasses.astuple(rep)
    assert (ref.total.seconds, ref.valid_bytes(victim)) \
        == (sched.total.seconds, sched.valid_bytes(victim))


def test_pick_victims_prefers_least_valid():
    dev = _device()
    sched = ReclaimScheduler(dev)
    for z in (0, 1, 2):
        dev.zones.write(z, SMALL_SPEC.zone_cap_bytes)
    sched.account([Extent(0, 0, SMALL_SPEC.zone_cap_bytes)])
    sched.account([Extent(2, 0, 4 * KiB)])
    assert sched.pick_victims(2) == [1, 2]
    assert sched.backlog == [1, 2]
    sched.schedule([1])
    assert sched.backlog == [1, 2]
    sched.unschedule([2])
    assert sched.backlog == [1]


def test_scheduled_zones_frozen_out_of_placement():
    dev = _device()
    alloc = ZoneAllocator(zones=dev.zones, policy="greedy-open")
    sched = ReclaimScheduler(dev, allocator=alloc)
    ext = alloc.allocate(4 * KiB)
    z = ext[0].zone
    sched.schedule([z])
    assert alloc.plan(4 * KiB)[0].zone != z
    sched.drain()
    assert alloc.plan(4 * KiB)[0].zone == z


def test_reclaim_workload_compiles_resets_with_io_ctx():
    dev = _device()
    sched = ReclaimScheduler(dev, io_ctx=OpType.WRITE)
    dev.zones.write(3, SMALL_SPEC.zone_cap_bytes // 2)
    sched.schedule([3])
    tr = sched.reclaim_workload().build()
    assert (tr.op == int(OpType.RESET)).sum() == 1
    assert tr.occupancy[0] == pytest.approx(0.5)
    assert tr.io_ctx[0] == int(OpType.WRITE)
    assert sched.backlog == [3]


@pytest.mark.parametrize("windows", [None, ((0.0, 5e4),),
                                     ((1e4, 2e4), (6e4, 9e4))])
@pytest.mark.parametrize("io_ctx", ["WRITE", None])
def test_reclaim_workload_trace_equals_reference(windows, io_ctx):
    """The same backlog (partly valid zones, so relocation appends too)
    compiled on a base workload by both packages: bit-equal traces."""
    built = []
    for M, H, spec in ((P, PH, SMALL_SPEC),
                       (R, RH, R_SMALL_SPEC)):
        dev = M.ZnsDevice(spec)
        ctx = None if io_ctx is None else getattr(M.OpType, io_ctx)
        sched = H.ReclaimScheduler(dev, io_ctx=ctx,
                                   relocation_stripe=128 * KiB)
        for z, frac in ((2, 0.25), (5, 1.0), (7, 0.5)):
            dev.zones.write(z, int(spec.zone_cap_bytes * frac))
        sched.account([H.Extent(5, 0, 96 * KiB)])
        sched.schedule([5, 2, 7])
        base = M.WorkloadSpec().reads(n=50, size=4 * KiB, qd=4)
        built.append(sched.reclaim_workload(base=base, thread=3,
                                            windows=windows).build())
    got, want = built
    for f in TRACE_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (got.op == int(OpType.APPEND)).sum() == 1


def test_reclaim_scheduler_needs_no_cuda(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dev = ZnsDevice(SMALL_SPEC)           # the default device="cuda"
    dev.zones.write(0, SMALL_SPEC.zone_cap_bytes)
    sched = ReclaimScheduler(dev)
    sched.account([Extent(0, 0, 64 * KiB)])
    sched.schedule([0])
    assert len(sched.reclaim_workload().build()) == 2
    assert sched.drain().zones_reset == 1
