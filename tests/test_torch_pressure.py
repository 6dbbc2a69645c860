"""The port's write-pressure backends, conventional-SSD baseline and
fio-style workload generators held against the reference on the CPU.

All of it is host numpy drawing from ``np.random.default_rng(seed)`` in
the reference's order, so every series and trace must be bit-equal to
the reference's.
"""
import dataclasses

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as P
from repro.core import workloads as rw
from repro_torch.core import workloads as pw

KiB = P.KiB
TRACE_FIELDS = ("op", "zone", "size", "issue", "thread", "qd", "occupancy",
                "was_finished", "io_ctx")
SERIES = ("t_s", "write_mibs", "read_mibs")
SCALARS = ("read_lat_mean_us", "read_lat_p95_us", "write_amplification",
           "write_cv")


def _same_result(got, want):
    for f in SERIES:
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if b is not None:
            assert a.dtype == b.dtype and np.array_equal(a, b), f
    for f in SCALARS:
        assert getattr(got, f) == getattr(want, f), f


def _same_trace(got, want):
    assert (int(got.stack), int(got.fmt)) == (int(want.stack),
                                              int(want.fmt))
    for f in TRACE_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


# -- conventional SSD ------------------------------------------------------------
def test_conv_spec_carried_from_reference():
    spec = P.conv_spec_from_dict(dataclasses.asdict(R.SN640))
    assert spec == P.SN640
    with pytest.raises(ValueError, match="missing"):
        P.conv_spec_from_dict({"name": "x"})


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("rate,util", [(1155.0, 0.85), (600.0, 0.95),
                                       (150.0, 0.85), (1155.0, 0.3)])
def test_conventional_pressure_series_bit_equal(seed, rate, util):
    got = P.ConventionalSSD(seed=seed).simulate_write_pressure(
        rate_mibs=rate, duration_s=30, utilization=util)
    want = R.ConventionalSSD(seed=seed).simulate_write_pressure(
        rate_mibs=rate, duration_s=30, utilization=util)
    _same_result(got, want)


@pytest.mark.parametrize("util", [0.0, 0.5, 0.7, 0.9, 0.999, 1.2])
def test_write_amplification_equal(util):
    spec = P.conv_spec_from_dict(dataclasses.asdict(R.SN640))
    got = P.ConvDevice(spec).write_amplification(util)
    assert got == R.ConvDevice().write_amplification(util)
    assert got == P.ConventionalSSD(spec).write_amplification(util)
    assert got >= 1.0


@pytest.mark.parametrize("seed", [0, 7])
def test_zns_pressure_series_bit_equal(seed):
    t, w = P.zns_write_pressure_series(rate_mibs=750.0, duration_s=20,
                                       bin_s=0.5, seed=seed)
    rt, rw_ = R.zns_write_pressure_series(rate_mibs=750.0, duration_s=20,
                                          bin_s=0.5, seed=seed)
    assert np.array_equal(t, rt) and np.array_equal(w, rw_)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("rate", [0.0, 500.0, 1155.0])
def test_run_write_pressure_equal(seed, rate):
    _same_result(P.ZnsDevice().run_write_pressure(
        rate_mibs=rate, duration_s=10, seed=seed),
        R.ZnsDevice().run_write_pressure(rate_mibs=rate, duration_s=10,
                                         seed=seed))
    _same_result(P.ConvDevice(seed=seed).run_write_pressure(
        rate_mibs=rate, duration_s=10),
        R.ConvDevice(seed=seed).run_write_pressure(rate_mibs=rate,
                                                   duration_s=10))


def test_pressure_backend_registry():
    assert P.available_pressure_backends() == ("conventional", "zns") \
        == R.available_pressure_backends()
    with pytest.raises(TypeError, match="needs a ZnsDevice"):
        P.ConvDevice().run_write_pressure(rate_mibs=100.0, backend="zns")
    with pytest.raises(TypeError, match="needs a ConvDevice"):
        P.ZnsDevice().run_write_pressure(rate_mibs=100.0,
                                         backend="conventional")
    with pytest.raises(KeyError, match="unknown pressure backend"):
        P.ZnsDevice().run_write_pressure(rate_mibs=100.0, backend="nope")

    @P.register_pressure_backend("flat-test")
    def flat(dev, *, rate_mibs, duration_s=60.0, bin_s=1.0, seed=0):
        n = int(duration_s / bin_s)
        return P.PressureResult(t_s=np.arange(n) * bin_s,
                                write_mibs=np.full(n, rate_mibs),
                                read_lat_mean_us=1.0, read_lat_p95_us=2.0)
    try:
        with pytest.warns(RuntimeWarning, match="already registered"):
            P.register_pressure_backend("flat-test", lambda dev, **kw: None)
        P.register_pressure_backend("flat-test", flat, replace=True)
        res = P.ConvDevice().run_write_pressure(rate_mibs=5.0,
                                                duration_s=4,
                                                backend="flat-test")
        assert res.write_cv == 0.0 and len(res.t_s) == 4
        assert "flat-test" not in R.available_pressure_backends()
    finally:
        from repro_torch.core.device import _PRESSURE_BACKENDS
        _PRESSURE_BACKENDS.pop("flat-test", None)


def test_pressure_needs_no_cuda(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    # closed-form host numpy on the default device="cuda" session
    res = P.ZnsDevice().run_write_pressure(rate_mibs=1155.0, duration_s=5)
    assert res.read_lat_p95_us > 0


# -- the port-side cases of test_device_api.py and test_paper_claims.py ----------
def test_conv_device_shares_pressure_interface():
    conv = P.ConvDevice().run_write_pressure(rate_mibs=1155.0, duration_s=10)
    zns = P.ZnsDevice().run_write_pressure(rate_mibs=1155.0, duration_s=10)
    assert conv.write_cv > 5 * zns.write_cv
    assert conv.read_lat_p95_us > zns.read_lat_p95_us
    assert repr(P.ConvDevice()) == repr(R.ConvDevice())


def test_obs11_read_latency_under_pressure():
    from repro_torch.core import calibration as C
    tm = P.ThroughputModel()
    _, p95_idle = tm.read_latency_under_write_pressure_us(0.0)
    assert p95_idle == pytest.approx(C.READONLY_READ_P95_US, rel=0.01)
    _, p95_full = tm.read_latency_under_write_pressure_us(1.0)
    assert p95_full / 1e3 == pytest.approx(98.04, rel=0.02)
    conv = P.ConventionalSSD().simulate_write_pressure(rate_mibs=1155.0)
    assert conv.read_lat_p95_us / 1e3 == pytest.approx(299.89, rel=0.05)
    assert conv.write_amplification > 1.0


# -- fio-style workload generators -----------------------------------------------
def _gen_cases(M, W):
    """Each generator of ``core/workloads.py`` through package ``M``."""
    op = M.OpType
    stream = W.io_stream(op.WRITE, size=8 * KiB, n=700, qd=4, zone=3,
                         thread=2, stack=M.Stack.KERNEL_MQ_DEADLINE,
                         rate_bytes_per_s=200e6, start_us=50.0, nzones=5)
    return {
        "io_stream": stream,
        "io_stream_closed_loop": W.io_stream(op.READ, size=4 * KiB, n=300,
                                             qd=32, fmt=M.LBAFormat.LBA_512),
        "merge_intra_zone_writes": W.merge_intra_zone_writes(stream, 4),
        "merge_factor_1": W.merge_intra_zone_writes(stream, 1),
        "concat": W.concat(stream, W.io_stream(
            op.APPEND, size=16 * KiB, n=90, qd=2, zone=40,
            stack=M.Stack.KERNEL_MQ_DEADLINE)),
        "reset_sweep": W.reset_sweep((0.0, 0.3, 1.0), finished_first=False,
                                     n_per_level=7, pause_us=1e4),
        "reset_sweep_finished": W.reset_sweep((0.5,), finished_first=True,
                                              n_per_level=5),
        "finish_sweep": W.finish_sweep((0.001, 0.5, 1.0), n_per_level=6),
        "reset_interference_isolated": W.reset_interference(None,
                                                            n_resets=25),
        "reset_interference_read": W.reset_interference(op.READ,
                                                        n_resets=25),
        "reset_interference_append": W.reset_interference(
            op.APPEND, n_resets=10, io_size=8 * KiB),
        "write_pressure_write": W.write_pressure_workload(
            W.WritePressureConfig(rate_mibs=400.0, duration_s=0.5),
            use_append=False),
        "write_pressure_append": W.write_pressure_workload(
            W.WritePressureConfig(rate_mibs=900.0, duration_s=0.25,
                                  write_threads=2, read_qd=8),
            use_append=True),
    }


GEN_CASES = tuple(_gen_cases(R, rw))


@pytest.mark.parametrize("case", GEN_CASES)
def test_workload_generators_equal(case):
    _same_trace(_gen_cases(P, pw)[case], _gen_cases(R, rw)[case])


def test_concat_rejects_mixed_formats():
    a = pw.io_stream(P.OpType.WRITE, size=4 * KiB, n=4)
    b = pw.io_stream(P.OpType.WRITE, size=4 * KiB, n=4,
                     stack=P.Stack.KERNEL_NONE)
    with pytest.raises(ValueError, match="mixed stack/format"):
        pw.concat(a, b)


def test_reset_interference_obs12_on_port():
    tr = pw.reset_interference(P.OpType.WRITE, n_resets=100)
    res = P.simulate(tr, seed=0, jitter=False)
    io_svc = res.service[tr.op == P.OpType.WRITE]
    base = float(P.LatencyModel().io_service_us(P.OpType.WRITE, 4 * KiB))
    assert float(np.mean(io_svc)) == pytest.approx(base, rel=0.01)
