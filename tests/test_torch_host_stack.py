"""The port's log-structured volume, application scenarios, policy
comparison and ``host`` CLI held against the reference on the CPU.

The behaviours of the volume and scenario sections of
``tests/test_host.py`` are asserted on the port, and the same calls go
through both packages: compiled traces are bit-equal, collect reports
equal, and ``compare_policies()`` rows within rtol 1e-12 of the
reference's with the same ranking.  Solves run on ``device="cpu"`` (the
kernels' plain versions); the default device raises without CUDA.
"""
import dataclasses
import json
import warnings

import numpy as np
import pytest
import torch

import repro.core as R
import repro.host as RH
import repro_torch.core as P
from repro_torch.core import KiB, OpType, ZoneError, ZNSDeviceSpec
from repro_torch.experiments.__main__ import main as cli_main
from repro_torch.host import (
    HOST_SCENARIO_SPEC, LogStructuredVolume, available_placement_policies,
    available_scenarios, build_scenario, compare_policies, rank_policies,
    register_scenario, unregister_scenario,
)
from strategies import SMALL_SPEC as R_SMALL_SPEC

POLICIES = ("greedy-open", "striped", "lifetime-binned")
SCENARIOS = ("cache", "circular-log", "lsm")
SMALL_SPEC = P.spec_from_dict(dataclasses.asdict(R_SMALL_SPEC))
TRACE_FIELDS = ("op", "zone", "size", "issue", "thread", "qd", "occupancy",
                "was_finished", "io_ctx")


def _assert_traces_equal(got, want):
    assert len(got) == len(want)
    for field in TRACE_FIELDS:
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)


def _both(fn):
    """``fn(core, volume_class, spec)`` run on the port and on the
    reference."""
    return (fn(P, LogStructuredVolume, SMALL_SPEC),
            fn(R, RH.LogStructuredVolume, R_SMALL_SPEC))


# ---------------------------------------------------------------------------
# LogStructuredVolume
# ---------------------------------------------------------------------------
def test_volume_roundtrip_and_compile():
    def drive(core, Vol, spec):
        vol = Vol(spec, stripe_bytes=64 * KiB, append_qd=2)
        vol.write("a", 128 * KiB, stream=0)
        vol.write("b", 256 * KiB, stream=1)
        vol.read("a")
        vol.delete("a")
        return vol

    vol, rvol = _both(drive)
    tr = vol.compile().build()
    _assert_traces_equal(tr, rvol.compile().build())
    n_app = int((tr.op == int(OpType.APPEND)).sum())
    assert n_app == (128 + 256) * KiB // (64 * KiB)
    assert (tr.op == int(OpType.READ)).sum() > 0
    res = vol.run(backend="event", device="cpu")
    assert res.user_bytes == (128 + 256) * KiB
    assert res.write_amplification == 1.0
    assert res.makespan_s > 0
    want = rvol.run(backend="event")
    np.testing.assert_array_equal(res.result.sim.complete,
                                  want.result.sim.complete)
    assert res.summary() == want.summary()


def test_volume_rejects_duplicate_keys():
    vol = LogStructuredVolume(SMALL_SPEC)
    vol.write("k", 4 * KiB)
    with pytest.raises(ZoneError, match="already exists"):
        vol.write("k", 4 * KiB)


def test_volume_collect_relocates_survivors():
    def drive(core, Vol, spec):
        vol = Vol(spec, stripe_bytes=64 * KiB)
        cap = spec.zone_cap_bytes
        vol.write("dead", cap // 2, stream=0)
        vol.write("live", cap // 2, stream=0)          # same zone, fills it
        zone = vol.objects["live"].extents[0].zone
        vol.delete("dead")
        rep = vol.collect(1, max_valid_frac=0.6)
        return vol, zone, rep

    (vol, zone, rep), (_, rzone, rrep) = _both(drive)
    cap = SMALL_SPEC.zone_cap_bytes
    assert rep.zones_reset == 1
    assert rep.relocated_bytes == cap // 2             # live half moved
    assert all(e.zone != zone for e in vol.objects["live"].extents)
    vol.read("live")                                   # still readable
    assert zone == rzone
    assert dataclasses.asdict(rep) == dataclasses.asdict(rrep)


def test_volume_wa_gt_one_shows_in_compiled_trace():
    def drive(core, Vol, spec):
        vol = Vol(spec, stripe_bytes=64 * KiB)
        cap = spec.zone_cap_bytes
        vol.write("dead", cap // 2)
        vol.write("live", cap // 2)
        vol.delete("dead")
        vol.collect(1, max_valid_frac=0.6)
        return vol

    vol, rvol = _both(drive)
    cap = SMALL_SPEC.zone_cap_bytes
    tr = vol.compile().build()
    _assert_traces_equal(tr, rvol.compile().build())
    append_bytes = int(tr.size[tr.op == int(OpType.APPEND)].sum())
    assert append_bytes == vol.user_bytes + cap // 2   # relocation appended
    assert (tr.op == int(OpType.RESET)).sum() == 1
    prog = vol.compile_program()
    rprog = rvol.compile_program()
    np.testing.assert_array_equal(prog.issue_flat, rprog.issue_flat)
    np.testing.assert_array_equal(prog.svc0_flat, rprog.svc0_flat)


def test_collect_aborts_cleanly_when_device_too_full_to_relocate():
    spec = ZNSDeviceSpec(zone_size_bytes=1 << 20, zone_cap_bytes=1 << 19,
                         num_zones=4, max_open_zones=4, max_active_zones=4)
    vol = LogStructuredVolume(spec, stripe_bytes=64 * KiB)
    cap = spec.zone_cap_bytes
    for i in range(8):                      # fill all 4 zones half-live
        vol.write(f"o{i}", cap // 2, stream=0)
    for i in range(0, 8, 2):
        vol.delete(f"o{i}")
    with pytest.raises(ZoneError, match="device full"):
        vol.collect(1)
    # victims thawed, backlog empty, survivors' extents + validity intact
    assert vol.allocator.frozen == set()
    assert vol.reclaim.backlog == []
    live = vol.objects["o1"]
    z = live.extents[0].zone
    assert vol.reclaim.valid_bytes(z) >= live.nbytes
    rep = vol.reclaim.drain()               # nothing scheduled: no-op
    assert rep.zones_reset == 0


@pytest.mark.parametrize("backend", ["event", "vectorized"])
def test_volume_run_takes_a_device(backend):
    """A volume built for the card still runs on the CPU when ``run`` is
    asked to; the result equals the reference's."""
    def drive(core, Vol, spec):
        vol = Vol(spec, stripe_bytes=64 * KiB, append_qd=4)
        for i in range(12):
            vol.write(f"o{i}", 192 * KiB, stream=i % 3)
        for i in range(0, 12, 3):
            vol.read(f"o{i}")
            vol.delete(f"o{i}")
        vol.collect(1)
        return vol

    vol, rvol = _both(drive)
    got = vol.run(backend=backend, device="cpu")
    want = rvol.run(backend=backend)
    np.testing.assert_allclose(got.result.sim.complete,
                               want.result.sim.complete, rtol=1e-12,
                               atol=0.0)
    assert got.write_amplification == want.write_amplification


def test_volume_needs_no_cuda_until_run(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    vol = LogStructuredVolume(SMALL_SPEC)           # device "cuda"
    vol.write("a", 64 * KiB)
    vol.compile().build()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vol.run()
    assert vol.run(device="cpu").user_bytes == 64 * KiB
    cpu = LogStructuredVolume(SMALL_SPEC, device="cpu")
    cpu.write("a", 64 * KiB)
    assert cpu.run().user_bytes == 64 * KiB
    session = P.ZnsDevice(SMALL_SPEC, device="cpu")
    assert LogStructuredVolume(device=session).device is session


# ---------------------------------------------------------------------------
# Scenarios + policy comparison
# ---------------------------------------------------------------------------
def test_scenarios_registered():
    assert set(SCENARIOS) <= set(available_scenarios())
    assert available_scenarios() == RH.available_scenarios()
    assert dataclasses.asdict(HOST_SCENARIO_SPEC) \
        == dataclasses.asdict(RH.HOST_SCENARIO_SPEC)


def test_scenario_registry_collision_warns_and_unregisters():
    def fake(vol, rng, scale):
        pass
    try:
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            register_scenario("collide-scen", fake)
            assert not w
            register_scenario("collide-scen", lambda *a: None)
            assert len(w) == 1 and "already registered" in str(w[0].message)
    finally:
        unregister_scenario("collide-scen")
    assert "collide-scen" not in available_scenarios()
    assert "collide-scen" not in RH.available_scenarios()


def test_build_scenario_deterministic_per_seed():
    a = build_scenario("cache", policy="striped", seed=7)
    b = build_scenario("cache", policy="striped", seed=7)
    c = build_scenario("cache", policy="striped", seed=8)
    assert a.stats == b.stats
    np.testing.assert_array_equal(a.workload.build().size,
                                  b.workload.build().size)
    assert a.stats != c.stats


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_scenario_builds_equal_reference(scenario, policy):
    """Each scenario draws from the same numpy stream in the same order:
    stats and compiled traces are bit-equal to the reference's."""
    got = build_scenario(scenario, policy=policy, seed=3, scale=0.75)
    want = RH.build_scenario(scenario, policy=policy, seed=3, scale=0.75)
    assert got.stats == want.stats
    _assert_traces_equal(got.workload.build(), want.workload.build())


def test_circular_log_has_unit_write_amplification():
    for policy in POLICIES:
        b = build_scenario("circular-log", policy=policy)
        assert b.stats["write_amplification"] == 1.0


def test_cache_scenario_relocates():
    b = build_scenario("cache", policy="greedy-open")
    assert b.stats["write_amplification"] > 1.0
    assert b.stats["zones_reset"] > 0


def test_compare_policies_one_fleet_run_and_ranking():
    rows = compare_policies(["circular-log"], backend="event", scale=0.5,
                            device="cpu")
    assert len(rows) == len(available_placement_policies())
    assert all(r["scenario"] == "circular-log" for r in rows)
    assert all(r["makespan_s"] > 0 for r in rows)
    ranking = rank_policies(rows)
    assert set(ranking) == {"circular-log"}
    assert sorted(ranking["circular-log"]) == \
        sorted(available_placement_policies())


def _assert_rows_close(rows, want, rtol):
    assert len(rows) == len(want)
    for a, b in zip(rows, want):
        assert set(a) == set(b)
        for k, v in a.items():
            if isinstance(v, float):
                np.testing.assert_allclose(v, b[k], rtol=rtol, atol=0.0,
                                           err_msg=k)
            elif k != "backend":
                assert v == b[k], k


def test_compare_policies_at_full_scale_equals_reference():
    """The ``host`` CLI's default sweep (9 combinations, 41,093 requests)
    as one vectorized fleet call on the CPU: rows within rtol 1e-12 of
    the reference's, ranking identical, one fleet solve."""
    rows = compare_policies(device="cpu")
    assert P.last_solve_stats().driver == "torch"
    want = RH.compare_policies()
    assert sum(r["n_requests"] for r in rows) == 41_093
    assert all(r["backend"] == "vectorized" for r in rows)
    _assert_rows_close(rows, want, 1e-12)
    assert rank_policies(rows) == RH.rank_policies(want)
    assert rank_policies(rows) == {
        "cache": ["striped", "lifetime-binned", "greedy-open"],
        "circular-log": ["greedy-open", "lifetime-binned", "striped"],
        "lsm": ["lifetime-binned", "striped", "greedy-open"]}


def test_compare_policies_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compare_policies(["lsm"], scale=0.25)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_main(["host", "--scenarios", "lsm", "--scale", "0.25"])


# ---------------------------------------------------------------------------
# The host CLI
# ---------------------------------------------------------------------------
def test_host_cli_writes_build_host_json(tmp_path, capsys):
    out = tmp_path / "host"
    assert cli_main(["host", "--scenarios", "lsm,cache", "--policies",
                     "greedy-open,striped", "--scale", "0.5", "--device",
                     "cpu", "--out", str(out)]) == 0
    rows = json.loads((out / "host_policies.json").read_text())
    want = RH.compare_policies(["lsm", "cache"], ["greedy-open", "striped"],
                               scale=0.5)
    _assert_rows_close(rows, json.loads(json.dumps(want)), 1e-12)
    text = capsys.readouterr().out
    assert "4 combinations in one fleet run" in text
    assert "lsm            best-first:" in text


def test_host_cli_defaults_and_list(capsys):
    from repro_torch.experiments.__main__ import HOST_OUT_DIR
    assert HOST_OUT_DIR.replace("\\", "/") == "build/host"
    assert cli_main(["host", "--list"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[1] for ln in lines if ln.startswith("scenario")] \
        == list(SCENARIOS)
    assert [ln.split()[1] for ln in lines if ln.startswith("policy")] \
        == sorted(POLICIES)


def test_host_cli_unknown_scenario_exits_2(tmp_path, capsys):
    assert cli_main(["host", "--scenarios", "nope", "--device", "cpu",
                     "--out", str(tmp_path)]) == 2
    assert "nope" in capsys.readouterr().err
