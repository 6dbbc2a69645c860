"""The paper's 13 observations as registered :class:`Experiment` entries.

Each entry bundles (a) the sweep points that reproduce the measurement,
(b) a metric extractor over the simulated results, and (c) executable
checks of the observation's qualitative claim, calibrated against the
paper's anchors (see :mod:`repro_torch.core.calibration`).  The entries,
their sweep points and their metrics are the reference registry's
(`docs/observations.md` tabulates them); the tests hold the two against
each other point by point.

Checks pass on both the ``event`` and ``vectorized`` backends
(``tests/test_torch_experiments.py``); extraction is deterministic
because the runner defaults to ``jitter=False``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core import (
    ConvDevice, KiB, LBAFormat, MiB, OpType, Stack, WorkloadSpec,
)
from repro_torch.core import calibration as C

from .registry import Check, Experiment, SweepPoint, register_experiment

_W = OpType.WRITE
_A = OpType.APPEND
_R = OpType.READ


# ---------------------------------------------------------------------------
# Check helpers
# ---------------------------------------------------------------------------
def _approx(name: str, value: float, anchor: float, rel: float,
            unit: str = "") -> Check:
    ok = bool(abs(value - anchor) <= rel * abs(anchor))
    return Check(name, ok,
                 f"{value:.4g}{unit} vs paper {anchor:.4g}{unit} "
                 f"(tol {rel:.0%})")


def _holds(name: str, ok, detail: str) -> Check:
    return Check(name, bool(ok), detail)


def _mean_lat_us(res, op: Optional[OpType] = None) -> float:
    return float(res.latency_stats(op).mean_us)


def _mgmt_mean_ms(res, op: OpType, occ: float) -> float:
    """Mean in-device latency (ms) of mgmt ops at one occupancy level."""
    tr = res.trace
    sel = (tr.op == int(op)) & np.isclose(tr.occupancy, occ)
    return float(np.mean(res.sim.in_device_latency[sel])) / 1e3


def _io(op: OpType, n: int, size: int, **kw) -> WorkloadSpec:
    return WorkloadSpec().stream(op, n=n, size=size, **kw)


# ---------------------------------------------------------------------------
# Obs 1 — LBA format
# ---------------------------------------------------------------------------
def _x01(ctx) -> Dict[str, float]:
    m = {}
    for op, tag in ((_W, "write"), (_A, "append")):
        m[f"{tag}_512_us"] = _mean_lat_us(ctx[f"{tag}_512"])
        m[f"{tag}_4k_us"] = _mean_lat_us(ctx[f"{tag}_4k"])
        m[f"{tag}_ratio"] = m[f"{tag}_512_us"] / m[f"{tag}_4k_us"]
    return m


def _c01(m) -> Tuple[Check, ...]:
    return tuple(
        _holds(f"{tag}_512_slower",
               1.0 < m[f"{tag}_ratio"] <= 2.1,
               f"512B/4KiB latency ratio {m[f'{tag}_ratio']:.2f} "
               f"(paper: slower, 'as much as a factor of two')")
        for tag in ("write", "append"))


register_experiment(Experiment(
    name="obs01_lba_format", obs=1,
    title="The LBA format affects I/O performance",
    claim="Writing with the 512B LBA format is slower than with the 4KiB "
          "format, sometimes by as much as a factor of two.",
    figure="Fig. 2a",
    points=(
        SweepPoint("write_512", _io(_W, 1000, 512).with_format(
            LBAFormat.LBA_512)),
        SweepPoint("write_4k", _io(_W, 1000, 4 * KiB)),
        SweepPoint("append_512", _io(_A, 1000, 512).with_format(
            LBAFormat.LBA_512)),
        SweepPoint("append_4k", _io(_A, 1000, 4 * KiB)),
    ),
    extract=_x01, check=_c01,
    knobs=("LatencyParams.lba512_penalty", "calibration.LBA512_PENALTY"),
    tests=("tests/test_paper_claims.py::test_obs1_lba_format_penalty",),
))


# ---------------------------------------------------------------------------
# Obs 2 — storage stack
# ---------------------------------------------------------------------------
def _x02(ctx) -> Dict[str, float]:
    return {"spdk_us": _mean_lat_us(ctx["spdk"]),
            "kernel_none_us": _mean_lat_us(ctx["kernel_none"]),
            "mq_deadline_us": _mean_lat_us(ctx["mq_deadline"])}


def _c02(m) -> Tuple[Check, ...]:
    return (
        _approx("spdk_anchor", m["spdk_us"], 11.36, 0.02, "us"),
        _approx("kernel_none_anchor", m["kernel_none_us"], 12.62, 0.02, "us"),
        _approx("mq_deadline_anchor", m["mq_deadline_us"], 14.47, 0.02, "us"),
        _holds("spdk_fastest",
               m["spdk_us"] < m["kernel_none_us"] < m["mq_deadline_us"],
               f"{m['spdk_us']:.2f} < {m['kernel_none_us']:.2f} < "
               f"{m['mq_deadline_us']:.2f} us"),
    )


register_experiment(Experiment(
    name="obs02_storage_stack", obs=2,
    title="The host storage stack adds measurable latency",
    claim="SPDK delivers the lowest write latency; the in-kernel path adds "
          "overhead, and an I/O scheduler (mq-deadline) adds more.",
    figure="Fig. 2a",
    points=(
        SweepPoint("spdk", _io(_W, 1000, 4 * KiB).on_stack(Stack.SPDK)),
        SweepPoint("kernel_none",
                   _io(_W, 1000, 4 * KiB).on_stack(Stack.KERNEL_NONE)),
        SweepPoint("mq_deadline",
                   _io(_W, 1000, 4 * KiB).on_stack(Stack.KERNEL_MQ_DEADLINE)),
    ),
    extract=_x02, check=_c02,
    knobs=("LatencyParams.stack_overhead_us", "calibration.STACK_OVERHEAD_US"),
    tests=("tests/test_paper_claims.py::test_obs2_stack_latencies_exact",),
))


# ---------------------------------------------------------------------------
# Obs 3 — request-size dependence
# ---------------------------------------------------------------------------
def _x03(ctx) -> Dict[str, float]:
    m = {"write_4k_kiops": ctx["write_4k"].iops / 1e3,
         "append_4k_kiops": ctx["append_4k"].iops / 1e3,
         "append_8k_kiops": ctx["append_8k"].iops / 1e3,
         "write_4k_mibs": ctx["write_4k"].bandwidth_bytes / MiB,
         "write_32k_mibs": ctx["write_32k"].bandwidth_bytes / MiB}
    return m


def _c03(m) -> Tuple[Check, ...]:
    return (
        _approx("write_4k_kiops", m["write_4k_kiops"], 85.0, 0.05, "K"),
        _approx("append_4k_kiops", m["append_4k_kiops"], 66.0, 0.05, "K"),
        _approx("append_8k_kiops", m["append_8k_kiops"], 69.0, 0.05, "K"),
        _holds("large_requests_higher_bandwidth",
               m["write_32k_mibs"] > 3.0 * m["write_4k_mibs"],
               f"32KiB {m['write_32k_mibs']:.0f} MiB/s vs 4KiB "
               f"{m['write_4k_mibs']:.0f} MiB/s"),
    )


register_experiment(Experiment(
    name="obs03_request_size", obs=3,
    title="QD1 throughput depends on the request size",
    claim="Small requests are IOPS-limited (write 85 KIOPS, append 66-69 "
          "KIOPS); bytes-throughput is highest for large (>=32KiB) "
          "requests.",
    figure="Fig. 3",
    points=(
        SweepPoint("write_4k", _io(_W, 1500, 4 * KiB)),
        SweepPoint("write_32k", _io(_W, 1500, 32 * KiB)),
        SweepPoint("append_4k", _io(_A, 1500, 4 * KiB)),
        SweepPoint("append_8k", _io(_A, 1500, 8 * KiB)),
    ),
    extract=_x03, check=_c03,
    knobs=("LatencyParams.size_anchors", "LatencyParams.io_svc_us",
           "calibration.WRITE_SVC_TABLE_US", "calibration.APPEND_SVC_TABLE_US"),
    tests=("tests/test_paper_claims.py::test_obs3_throughput_vs_size",),
))


# ---------------------------------------------------------------------------
# Obs 4 — append vs write latency
# ---------------------------------------------------------------------------
def _x04(ctx) -> Dict[str, float]:
    w = _mean_lat_us(ctx["write_4k"])
    a = _mean_lat_us(ctx["append_8k"])
    return {"write_us": w, "append_us": a,
            "gap_pct": (a - w) / w * 100.0}


def _c04(m) -> Tuple[Check, ...]:
    return (
        _approx("write_anchor", m["write_us"], 11.36, 0.02, "us"),
        _approx("append_anchor", m["append_us"], 14.02, 0.02, "us"),
        _approx("gap_anchor", m["gap_pct"], 23.42, 0.05, "%"),
        _holds("write_lower", m["write_us"] < m["append_us"],
               f"write {m['write_us']:.2f} < append {m['append_us']:.2f} us"),
    )


register_experiment(Experiment(
    name="obs04_append_vs_write", obs=4,
    title="Appends have higher latency than writes",
    claim="At their best request sizes, writes have up to 23.42% lower "
          "latency than appends.",
    figure="Fig. 2b",
    points=(
        SweepPoint("write_4k", _io(_W, 1500, 4 * KiB)),
        SweepPoint("append_8k", _io(_A, 1500, 8 * KiB)),
    ),
    extract=_x04, check=_c04,
    knobs=("LatencyParams.io_svc_us", "calibration.APPEND_SVC_TABLE_US"),
    tests=("tests/test_paper_claims.py::test_obs4_append_write_gap_exact",),
))


# ---------------------------------------------------------------------------
# Obs 5 — scheduler-dependent write scaling
# ---------------------------------------------------------------------------
def _x05(ctx) -> Dict[str, float]:
    spdk = _mean_lat_us(ctx["spdk_qd1"])
    mq = _mean_lat_us(ctx["mq_qd1"])
    intra = ctx.device.steady_state(_W, 4 * KiB, qd=32,
                                    stack=Stack.KERNEL_MQ_DEADLINE)
    try:
        ctx.device.steady_state(_W, 4 * KiB, qd=2, stack=Stack.SPDK)
        rejected = 0.0
    except ValueError:
        rejected = 1.0
    return {"spdk_qd1_us": spdk, "mq_qd1_us": mq,
            "sched_overhead_us": mq - spdk,
            "intra_mq_qd32_kiops": intra.iops / 1e3,
            "spdk_multi_write_rejected": rejected}


def _c05(m) -> Tuple[Check, ...]:
    return (
        _approx("mq_overhead", m["sched_overhead_us"], 3.11, 0.25, "us"),
        _approx("intra_mq_qd32", m["intra_mq_qd32_kiops"], 293.0, 0.10, "K"),
        _holds("spdk_single_writer_per_zone",
               m["spdk_multi_write_rejected"] == 1.0,
               "QD>1 same-zone writes require an I/O scheduler"),
    )


register_experiment(Experiment(
    name="obs05_scheduler", obs=5,
    title="Intra-zone write scaling needs an I/O scheduler",
    claim="A single zone admits one in-flight write without a scheduler; "
          "mq-deadline merges sequential writes (293 KIOPS at QD32) at the "
          "cost of per-request overhead.",
    figure="Fig. 4a",
    points=(
        SweepPoint("spdk_qd1", _io(_W, 1000, 4 * KiB).on_stack(Stack.SPDK)),
        SweepPoint("mq_qd1",
                   _io(_W, 1000, 4 * KiB).on_stack(Stack.KERNEL_MQ_DEADLINE)),
    ),
    extract=_x05, check=_c05,
    knobs=("calibration.MERGE_MAX", "calibration.WRITE_INTRA_MERGED_IOPS_CAP",
           "LatencyParams.stack_overhead_us"),
    tests=("tests/test_paper_claims.py::test_obs5_obs7_intra_zone_beats_inter_zone",),
))


# ---------------------------------------------------------------------------
# Obs 6 — append concurrency cap
# ---------------------------------------------------------------------------
def _x06(ctx) -> Dict[str, float]:
    return {"qd1_kiops": ctx["qd1"].iops / 1e3,
            "qd4_kiops": ctx["qd4"].iops / 1e3,
            "qd8_kiops": ctx["qd8"].iops / 1e3,
            "inter_z4_kiops": ctx["inter_z4"].iops / 1e3}


def _c06(m) -> Tuple[Check, ...]:
    cap = C.APPEND_IOPS_CAP / 1e3
    return (
        _approx("saturates_at_cap", m["qd4_kiops"], cap, 0.10, "K"),
        _holds("no_gain_past_qd4",
               abs(m["qd8_kiops"] - m["qd4_kiops"]) <= 0.05 * m["qd4_kiops"],
               f"qd8 {m['qd8_kiops']:.0f}K vs qd4 {m['qd4_kiops']:.0f}K"),
        _holds("layout_agnostic",
               abs(m["inter_z4_kiops"] - m["qd4_kiops"])
               <= 0.05 * m["qd4_kiops"],
               f"inter-zone {m['inter_z4_kiops']:.0f}K vs intra "
               f"{m['qd4_kiops']:.0f}K"),
        _holds("scales_from_qd1", m["qd4_kiops"] >= 1.8 * m["qd1_kiops"],
               f"qd1 {m['qd1_kiops']:.0f}K -> qd4 {m['qd4_kiops']:.0f}K"),
    )


register_experiment(Experiment(
    name="obs06_append_concurrency", obs=6,
    title="Append scalability saturates at low concurrency",
    claim="Appends scale only to ~132 KIOPS at concurrency 4, regardless "
          "of intra- vs inter-zone layout.",
    figure="Fig. 4a/4b",
    points=(
        SweepPoint("qd1", _io(_A, 1500, 4 * KiB, qd=1)),
        SweepPoint("qd4", _io(_A, 3000, 4 * KiB, qd=4)),
        SweepPoint("qd8", _io(_A, 3000, 4 * KiB, qd=8)),
        SweepPoint("inter_z4", _io(_A, 3000, 4 * KiB, qd=4, nzones=4)),
    ),
    extract=_x06, check=_c06,
    knobs=("ZNSDeviceSpec.append_parallelism", "calibration.APPEND_IOPS_CAP"),
    tests=("tests/test_paper_claims.py::test_obs6_append_agnostic",),
))


# ---------------------------------------------------------------------------
# Obs 7 — read/write concurrency scaling
# ---------------------------------------------------------------------------
def _x07(ctx) -> Dict[str, float]:
    intra = ctx.device.steady_state(_W, 4 * KiB, qd=32,
                                    stack=Stack.KERNEL_MQ_DEADLINE)
    inter = ctx.device.steady_state(_W, 4 * KiB, zones=14)
    return {"read_qd1_kiops": ctx["read_qd1"].iops / 1e3,
            "read_qd32_kiops": ctx["read_qd32"].iops / 1e3,
            "read_qd128_kiops": ctx["read_qd128"].iops / 1e3,
            "write_intra_mq_kiops": intra.iops / 1e3,
            "write_inter_kiops": inter.iops / 1e3}


def _c07(m) -> Tuple[Check, ...]:
    return (
        _approx("read_peak", m["read_qd128_kiops"],
                C.READ_IOPS_CAP / 1e3, 0.05, "K"),
        _holds("read_scales",
               m["read_qd1_kiops"] < m["read_qd32_kiops"]
               <= m["read_qd128_kiops"] * 1.01,
               f"{m['read_qd1_kiops']:.0f}K -> {m['read_qd32_kiops']:.0f}K "
               f"-> {m['read_qd128_kiops']:.0f}K"),
        _approx("write_inter_cap", m["write_inter_kiops"], 186.0, 0.10, "K"),
        _holds("intra_beats_inter",
               m["write_intra_mq_kiops"] > m["write_inter_kiops"],
               f"intra(mq) {m['write_intra_mq_kiops']:.0f}K vs inter "
               f"{m['write_inter_kiops']:.0f}K"),
    )


register_experiment(Experiment(
    name="obs07_concurrency_scaling", obs=7,
    title="Reads scale intra-zone; intra-zone writes beat inter-zone",
    claim="Reads reach 424 KIOPS at QD128 within one zone; merged "
          "intra-zone writes (293 KIOPS) outperform inter-zone writes "
          "(186 KIOPS).",
    figure="Fig. 4a/4b",
    points=(
        SweepPoint("read_qd1", _io(_R, 2000, 4 * KiB, qd=1)),
        SweepPoint("read_qd32", _io(_R, 6000, 4 * KiB, qd=32)),
        SweepPoint("read_qd128", _io(_R, 8000, 4 * KiB, qd=128)),
    ),
    extract=_x07, check=_c07,
    knobs=("ZNSDeviceSpec.read_parallelism", "calibration.READ_IOPS_CAP",
           "calibration.WRITE_INTER_IOPS_CAP"),
    tests=("tests/test_paper_claims.py::test_obs5_obs7_intra_zone_beats_inter_zone",),
))


# ---------------------------------------------------------------------------
# Obs 8 — large requests saturate device bandwidth
# ---------------------------------------------------------------------------
def _x08(ctx) -> Dict[str, float]:
    inter8 = ctx.device.steady_state(_W, 8 * KiB, zones=4)
    app16 = ctx.device.steady_state(_A, 16 * KiB, qd=4)
    return {"write_32k_qd1_mibs": ctx["write_32k"].bandwidth_bytes / MiB,
            "write_8k_z4_mibs": inter8.bandwidth_bytes / MiB,
            "append_16k_qd4_mibs": app16.bandwidth_bytes / MiB}


def _c08(m) -> Tuple[Check, ...]:
    peak = C.PEAK_WRITE_BW_MIBS
    return (
        _approx("qd1_32k_at_peak", m["write_32k_qd1_mibs"], peak, 0.10,
                " MiB/s"),
        _holds("8k_with_4_zones_at_peak",
               m["write_8k_z4_mibs"] >= 0.85 * peak,
               f"{m['write_8k_z4_mibs']:.0f} MiB/s vs peak {peak:.0f}"),
        _holds("append_16k_qd4_at_peak",
               m["append_16k_qd4_mibs"] >= 0.85 * peak,
               f"{m['append_16k_qd4_mibs']:.0f} MiB/s vs peak {peak:.0f}"),
    )


register_experiment(Experiment(
    name="obs08_bandwidth_saturation", obs=8,
    title="Large requests saturate the device write bandwidth",
    claim="Requests >=32KiB at QD1 (or >=8KiB with 2-4 concurrent zones) "
          "reach the ~1155 MiB/s device write-bandwidth limit.",
    figure="Fig. 4c",
    points=(
        SweepPoint("write_32k", _io(_W, 1500, 32 * KiB)),
    ),
    extract=_x08, check=_c08,
    knobs=("ZNSDeviceSpec.peak_write_bw_bytes",
           "calibration.PEAK_WRITE_BW_MIBS"),
    tests=("tests/test_paper_claims.py::test_obs8_large_requests_saturate",),
))


# ---------------------------------------------------------------------------
# Obs 9 — zone-transition costs
# ---------------------------------------------------------------------------
def _x09(ctx) -> Dict[str, float]:
    res = ctx["transitions"]
    stats = res.per_op_stats()
    p = ctx.device.params
    return {"open_us": stats[OpType.OPEN].mean_us,
            "close_us": stats[OpType.CLOSE].mean_us,
            "implicit_write_us": float(p.implicit_open_us[int(_W)]),
            "implicit_append_us": float(p.implicit_open_us[int(_A)])}


def _c09(m) -> Tuple[Check, ...]:
    return (
        _approx("open_anchor", m["open_us"], C.OPEN_LAT_US, 0.02, "us"),
        _approx("close_anchor", m["close_us"], C.CLOSE_LAT_US, 0.02, "us"),
        _approx("implicit_write",
                m["implicit_write_us"],
                C.IMPLICIT_OPEN_FIRST_WRITE_PENALTY_US, 0.02, "us"),
        _holds("transitions_cheap",
               m["open_us"] < 100.0 and m["close_us"] < 100.0,
               "open/close are microsecond-scale (vs ms-scale reset/finish)"),
    )


register_experiment(Experiment(
    name="obs09_transitions", obs=9,
    title="Explicit zone transitions are cheap",
    claim="Open (9.56us) and close (11.01us) cost microseconds; implicit "
          "opens add only a small first-write penalty.",
    figure="Fig. 5c",
    points=(
        SweepPoint("transitions",
                   WorkloadSpec().opens(n=300).closes(n=300)),
    ),
    extract=_x09, check=_c09,
    knobs=("LatencyParams.open_cost_us", "LatencyParams.close_cost_us",
           "LatencyParams.implicit_open_us"),
    tests=("tests/test_paper_claims.py::test_obs9_open_close_costs",),
))


# ---------------------------------------------------------------------------
# Obs 10 — occupancy-dependent reset/finish costs
# ---------------------------------------------------------------------------
_OCC = (0.0, 0.25, 0.5, 1.0)


def _x10(ctx) -> Dict[str, float]:
    rs = ctx["reset_sweep"]
    fin = ctx["finish_sweep"]
    plain05 = _mgmt_mean_ms(rs, OpType.RESET, 0.5)
    finished05 = _mgmt_mean_ms(ctx["finished_reset"], OpType.RESET, 0.5)
    return {
        "reset_ms_occ025": _mgmt_mean_ms(rs, OpType.RESET, 0.25),
        "reset_ms_occ05": plain05,
        "reset_ms_occ10": _mgmt_mean_ms(rs, OpType.RESET, 1.0),
        "reset_finished_ms_occ05": finished05,
        "finished_discount_pct": (1.0 - finished05 / plain05) * 100.0,
        "finish_ms_low": _mgmt_mean_ms(fin, OpType.FINISH, 0.001),
        "finish_ms_full": _mgmt_mean_ms(fin, OpType.FINISH, 1.0),
    }


def _c10(m) -> Tuple[Check, ...]:
    return (
        _holds("reset_grows_with_occupancy",
               m["reset_ms_occ025"] < m["reset_ms_occ05"]
               < m["reset_ms_occ10"],
               f"{m['reset_ms_occ025']:.2f} < {m['reset_ms_occ05']:.2f} < "
               f"{m['reset_ms_occ10']:.2f} ms"),
        _approx("reset_50pct_anchor", m["reset_ms_occ05"], 11.60, 0.05, "ms"),
        _approx("reset_100pct_anchor", m["reset_ms_occ10"], 16.19, 0.05,
                "ms"),
        _approx("finished_discount", m["finished_discount_pct"], 26.58,
                0.05, "%"),
        _approx("finish_empty_anchor", m["finish_ms_low"], 907.51, 0.02,
                "ms"),
        _approx("finish_full_anchor", m["finish_ms_full"], 3.07, 0.05, "ms"),
        _holds("finish_decreases",
               m["finish_ms_low"] > 100.0 * m["finish_ms_full"],
               f"{m['finish_ms_low']:.0f} ms (empty) vs "
               f"{m['finish_ms_full']:.2f} ms (full)"),
    )


register_experiment(Experiment(
    name="obs10_reset_finish_occupancy", obs=10,
    title="Reset/finish cost depends on zone occupancy",
    claim="Reset cost grows with occupancy (finished zones are 26.58% "
          "cheaper); finish is the most expensive command, hundreds of ms "
          "for nearly-empty zones.",
    figure="Fig. 5a/5b",
    points=(
        SweepPoint("reset_sweep", WorkloadSpec().reset_sweep(
            _OCC, n_per_level=10, pause_us=1e4)),
        SweepPoint("finished_reset", WorkloadSpec().reset_sweep(
            (0.5,), n_per_level=10, pause_us=1e4, finish_first=True)),
        SweepPoint("finish_sweep", WorkloadSpec().finish_sweep(
            (0.001, 0.5, 1.0), n_per_level=10, pause_us=1e4)),
    ),
    extract=_x10, check=_c10,
    knobs=("LatencyParams.reset_us_table",
           "LatencyParams.reset_finished_discount",
           "LatencyParams.finish_floor_us", "LatencyParams.finish_span_us"),
    tests=("tests/test_paper_claims.py::test_obs10_reset_finish_occupancy",),
))


# ---------------------------------------------------------------------------
# Obs 11 — stability under write pressure (ZNS vs conventional GC)
# ---------------------------------------------------------------------------
def _zns_pressure_wl(rate_mibs: float = 750.0, duration_s: float = 4.0,
                     threads: int = 4, size: int = 128 * KiB
                     ) -> WorkloadSpec:
    per = rate_mibs * MiB / threads
    n = int(per * duration_s / size)
    wl = WorkloadSpec()
    for t in range(threads):
        wl = wl.stream(_W, n=n, size=size, qd=8, zone=t * 50, nzones=8,
                       thread=t, rate_bytes_per_s=per)
    return wl


def _x11(ctx) -> Dict[str, float]:
    res = ctx["zns_writes"]
    _, mibs = res.throughput_timeseries(bin_s=1.0)
    steady = mibs[:-1] if len(mibs) > 1 else mibs  # drop partial last bin
    cv = float(np.std(steady) / np.mean(steady))
    conv = ConvDevice().run_write_pressure(rate_mibs=C.PEAK_WRITE_BW_MIBS,
                                           duration_s=60)
    zns = ctx.device.run_write_pressure(rate_mibs=C.PEAK_WRITE_BW_MIBS,
                                        duration_s=60)
    idle = ctx.device.run_write_pressure(rate_mibs=0.0, duration_s=60)
    return {"zns_write_cv": cv,
            "conv_write_cv": float(conv.write_cv),
            "conv_read_p95_ms": conv.read_lat_p95_us / 1e3,
            "zns_read_p95_ms": zns.read_lat_p95_us / 1e3,
            "idle_read_p95_us": idle.read_lat_p95_us,
            "zns_read_advantage": (conv.read_lat_p95_us
                                   / zns.read_lat_p95_us)}


def _c11(m) -> Tuple[Check, ...]:
    return (
        _holds("zns_writes_flat", m["zns_write_cv"] < 0.05,
               f"ZNS write-throughput CV {m['zns_write_cv']:.4f}"),
        _holds("conv_writes_fluctuate", m["conv_write_cv"] > 0.3,
               f"conventional (FTL GC) CV {m['conv_write_cv']:.2f}"),
        _approx("zns_read_p95", m["zns_read_p95_ms"],
                C.ZNS_READ_P95_UNDER_WRITES_MS, 0.05, "ms"),
        _approx("read_advantage", m["zns_read_advantage"], 3.06, 0.10, "x"),
        _holds("pressure_vs_idle",
               m["zns_read_p95_ms"] * 1e3 > 100.0 * m["idle_read_p95_us"],
               f"pressured p95 {m['zns_read_p95_ms']:.1f} ms vs idle "
               f"{m['idle_read_p95_us']:.1f} us"),
    )


register_experiment(Experiment(
    name="obs11_write_pressure", obs=11,
    title="ZNS performance is stable under write pressure",
    claim="Without device-side GC, ZNS write throughput stays flat and "
          "read p95 is ~3x lower than a conventional SSD under full-rate "
          "writes.",
    figure="Fig. 6",
    points=(
        SweepPoint("zns_writes", _zns_pressure_wl()),
    ),
    extract=_x11, check=_c11,
    knobs=("calibration.ZNS_READ_P95_UNDER_WRITES_MS",
           "calibration.CONV_READ_P95_UNDER_WRITES_MS",
           "ConvDeviceSpec.gc_write_amp_knee"),
    tests=("tests/test_paper_claims.py::test_obs11_read_latency_under_pressure",),
))


# ---------------------------------------------------------------------------
# Obs 12 — resets do not disturb I/O
# ---------------------------------------------------------------------------
def _quiet_reads() -> WorkloadSpec:
    return WorkloadSpec().reads(n=2500, size=4 * KiB, qd=32, thread=0)


def _x12(ctx) -> Dict[str, float]:
    quiet = ctx["quiet"]
    loud = ctx["loud"]
    rmask = loud.trace.op == int(_R)
    shift = float(np.max(np.abs(loud.sim.complete[rmask]
                                - quiet.sim.complete)))
    return {"max_read_shift_us": shift,
            "reset_mean_ms": loud.latency_stats(OpType.RESET).mean_us / 1e3}


def _c12(m) -> Tuple[Check, ...]:
    return (
        _holds("io_unperturbed", m["max_read_shift_us"] <= 1e-6,
               f"max read-completion shift {m['max_read_shift_us']:.2g} us "
               f"with 20 full-zone resets in flight"),
        _holds("resets_realistic", m["reset_mean_ms"] >= 1.0,
               f"reset latency {m['reset_mean_ms']:.2f} ms (ms-scale, so "
               f"the non-interference is meaningful)"),
    )


register_experiment(Experiment(
    name="obs12_reset_io_isolation", obs=12,
    title="Resets do not disturb concurrent I/O",
    claim="Zone resets are handled by a dedicated metadata path and leave "
          "concurrent read/write completions untouched.",
    figure="Fig. 7",
    points=(
        SweepPoint("quiet", _quiet_reads(), seed=0),
        SweepPoint("loud",
                   WorkloadSpec()
                   .resets(n=20, occupancy=1.0, nzones=20, thread=1)
                   .reads(n=2500, size=4 * KiB, qd=32, thread=0),
                   seed=0),
    ),
    extract=_x12, check=_c12,
    knobs=("LatencyParams.reset_on_io_path",
           "ZNSDeviceSpec.reset_parallelism"),
    tests=("tests/test_paper_claims.py::test_obs12_resets_do_not_disturb_io",),
))


# ---------------------------------------------------------------------------
# Obs 13 — concurrent I/O inflates reset latency
# ---------------------------------------------------------------------------
def _resets(io_ctx=None) -> WorkloadSpec:
    return WorkloadSpec().resets(n=30, occupancy=1.0, nzones=30,
                                 io_ctx=io_ctx)


def _x13(ctx) -> Dict[str, float]:
    iso = ctx["isolated"].latency_stats(OpType.RESET).mean_us
    m = {"isolated_reset_ms": iso / 1e3}
    for tag in ("read", "write", "append"):
        mean = ctx[f"under_{tag}"].latency_stats(OpType.RESET).mean_us
        m[f"{tag}_inflation_pct"] = (mean / iso - 1.0) * 100.0
    return m


def _c13(m) -> Tuple[Check, ...]:
    return (
        _approx("write_inflation", m["write_inflation_pct"], 78.42, 0.05,
                "%"),
        _approx("read_inflation", m["read_inflation_pct"], 56.11, 0.05, "%"),
        _approx("append_inflation", m["append_inflation_pct"], 75.50, 0.05,
                "%"),
        _holds("all_classes_inflate",
               min(m["read_inflation_pct"], m["write_inflation_pct"],
                   m["append_inflation_pct"]) > 30.0,
               "every concurrent I/O class inflates reset latency"),
    )


register_experiment(Experiment(
    name="obs13_reset_inflation", obs=13,
    title="Concurrent I/O inflates reset latency",
    claim="Resets take up to 78.42% longer when I/O runs concurrently "
          "(write worst, then append, then read) — the inverse of Obs#12.",
    figure="Fig. 7",
    points=(
        SweepPoint("isolated", _resets()),
        SweepPoint("under_read", _resets(_R)),
        SweepPoint("under_write", _resets(_W)),
        SweepPoint("under_append", _resets(_A)),
    ),
    extract=_x13, check=_c13,
    knobs=("LatencyParams.reset_inflation", "calibration.RESET_INFLATION"),
    tests=("tests/test_paper_claims.py::test_obs13_io_inflates_reset_p95",),
))
