"""Open-loop traffic scenarios (obs14/obs15): the paper's interference
observations at service scale.

Obs#12/#13 are per-request facts — resets never perturb concurrent I/O
on the ZN540 (a dedicated metadata path), while concurrent I/O inflates
the resets themselves.  These two registry entries replay those facts
under *open-loop* tenant traffic (:mod:`repro_torch.core.arrival`), where they
become tail-latency SLO statements:

* ``obs14_qos_noisy_neighbor`` — a victim tenant issues Poisson reads
  while a noisy neighbor fires zone resets at increasing rates.  On the
  calibrated ZN540 the victim's completions are bit-identical at every
  aggressor rate (Obs#12 at scale); on the NVMeVirt profile, whose
  erase executes on the data path, the victim's p99.9 and SLO-violation
  rate climb with the reset rate.  The aggressor still pays Obs#13
  inflation on the calibrated profile.  An event-engine oracle pass
  asserts the open-loop lowering is exact (<= 1e-9) on every point.
* ``obs15_diurnal_reclaim`` — a diurnal (on/off) read service plus a
  host :class:`repro_torch.host.ReclaimScheduler` backlog.  Scheduling the
  reclaim resets into the load troughs (``reclaim_workload(windows=)``)
  hides them completely even on NVMeVirt; spreading the *same* reclaim
  work uniformly across the day drags the busy-phase tail through the
  erase latency.  The calibrated profile is immune either way.

Both experiments run on both backends and extract deterministic metrics
(runner default ``jitter=False``), like every entry in
:mod:`repro_torch.experiments.observations`.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core import (
    KiB, DeterministicRate, LatencyModel, OpType, PoissonArrivals,
    WorkloadSpec, ZNSDeviceSpec, ZnsDevice,
)
from repro_torch.core import calibration as C
from repro_torch.core.emulator_models import nvmevirt_params
from repro_torch.host import ReclaimScheduler

from .observations import _approx, _holds
from .registry import Check, Experiment, SweepPoint, register_experiment

_R = OpType.READ
_RESET = OpType.RESET

#: Single-channel read path: one in-flight read at a time, so a reset
#: executing on the data path (NVMeVirt) visibly stalls the tenant.
_SPEC = ZNSDeviceSpec(read_parallelism=1)
_NV = nvmevirt_params()

_SLO_US = 1_000.0                    # tenant SLO: 1 ms from submission


def _from_issue_lat(res, mask) -> np.ndarray:
    return np.asarray(res.sim.latency_from(res.trace.issue))[mask]


def _read_mask(res) -> np.ndarray:
    return res.trace.op == int(_R)


def _victim_p999(res) -> float:
    lat = _from_issue_lat(res, _read_mask(res))
    return float(np.percentile(lat, 99.9))


def _victim_slo_rate(res) -> float:
    lat = _from_issue_lat(res, _read_mask(res))
    return float(np.count_nonzero(lat > _SLO_US) / len(lat))


def _oracle_pass(ctx) -> Tuple[float, bool]:
    """Re-run every sweep point on the event engine and return the worst
    completion-time relative difference plus the vectorized engine's own
    exactness claim (the open-loop differential gate).  The oracle runs
    on the host; its sessions take the runner's device all the same, so
    a run without a usable device raises here too."""
    worst, exact = 0.0, True
    for pt in ctx.experiment.points:
        dev = ZnsDevice(pt.spec, lat=LatencyModel(pt.spec, pt.params),
                        device=ctx.device.device)
        ref = dev.run(pt.workload, backend="event", jitter=False)
        got = ctx[pt.label]
        a = np.asarray(got.sim.complete)
        b = np.asarray(ref.sim.complete)
        if len(b):
            worst = max(worst, float(
                np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0))))
        claim = got.exact
        exact = exact and (claim is None or bool(claim))
    return worst, exact


# ---------------------------------------------------------------------------
# Obs 14 — multi-tenant QoS under a reset-happy neighbor (Obs#12/#13 at scale)
# ---------------------------------------------------------------------------
_VICTIM_N = 5000
_VICTIM_RATE = 10_000.0              # ~500 ms of Poisson reads


def _victim() -> WorkloadSpec:
    return WorkloadSpec().reads(
        n=_VICTIM_N, size=4 * KiB, qd=0, thread=0,
        arrival=PoissonArrivals(rate_per_s=_VICTIM_RATE, seed=14))


def _aggressor(wl: WorkloadSpec, rate_per_s: float, n: int, *,
               io_ctx: Optional[OpType] = _R) -> WorkloadSpec:
    """Noisy neighbor: open-loop full-zone resets at ``rate_per_s``."""
    return wl.resets(
        n=n, occupancy=1.0, nzones=n, thread=1, qd=0, io_ctx=io_ctx,
        arrival=PoissonArrivals(rate_per_s=rate_per_s, seed=41))


def _x14(ctx) -> Dict[str, float]:
    m: Dict[str, float] = {}
    for label, key in (("quiet", "quiet"), ("aggr_10", "aggr10"),
                       ("aggr_40", "aggr40"), ("nv_quiet", "nv_quiet"),
                       ("nv_aggr_10", "nv_aggr10"),
                       ("nv_aggr_40", "nv_aggr40")):
        res = ctx[label]
        m[f"victim_p999_{key}_us"] = _victim_p999(res)
        m[f"slo_rate_{key}"] = _victim_slo_rate(res)
    quiet = ctx["quiet"]
    shift = 0.0
    for label in ("aggr_10", "aggr_40"):
        loud = ctx[label]
        shift = max(shift, float(np.max(np.abs(
            loud.sim.complete[_read_mask(loud)]
            - quiet.sim.complete[_read_mask(quiet)]))))
    m["max_read_shift_us"] = shift
    m["nv_tail_ratio_40"] = (m["victim_p999_nv_aggr40_us"]
                             / m["victim_p999_nv_quiet_us"])
    # Obs#13 rides along: the aggressor's resets inflate under the
    # victim's reads on the calibrated profile.
    alone = ctx["aggr_alone"]
    under = ctx["aggr_40"]
    iso = float(np.mean(
        alone.sim.in_device_latency[alone.trace.op == int(_RESET)]))
    ctx_mean = float(np.mean(
        under.sim.in_device_latency[under.trace.op == int(_RESET)]))
    m["read_ctx_inflation_pct"] = (ctx_mean / iso - 1.0) * 100.0
    m["oracle_max_rel_diff"], ok = _oracle_pass(ctx)
    m["oracle_all_exact"] = float(ok)
    return m


def _c14(m) -> Tuple[Check, ...]:
    anchor = (C.RESET_INFLATION[_R] - 1.0) * 100.0
    return (
        _holds("victim_immune_calibrated",
               m["max_read_shift_us"] <= 1e-6,
               f"max victim completion shift {m['max_read_shift_us']:.2g} us "
               f"across aggressor rates (Obs#12 at scale)"),
        _holds("nv_neighbor_hurts",
               m["nv_tail_ratio_40"] > 2.0
               and m["slo_rate_nv_aggr40"] > m["slo_rate_nv_quiet"],
               f"NVMeVirt victim p99.9 inflates "
               f"{m['nv_tail_ratio_40']:.1f}x at 40 resets/s "
               f"(SLO violations {m['slo_rate_nv_quiet']:.3f} -> "
               f"{m['slo_rate_nv_aggr40']:.3f})"),
        _holds("nv_tail_monotonic",
               m["victim_p999_nv_quiet_us"]
               <= m["victim_p999_nv_aggr10_us"]
               <= m["victim_p999_nv_aggr40_us"],
               f"p99.9 {m['victim_p999_nv_quiet_us']:.0f} <= "
               f"{m['victim_p999_nv_aggr10_us']:.0f} <= "
               f"{m['victim_p999_nv_aggr40_us']:.0f} us with reset rate"),
        _approx("aggressor_pays_obs13", m["read_ctx_inflation_pct"],
                anchor, 0.05, "%"),
        _holds("open_loop_oracle_exact",
               m["oracle_max_rel_diff"] <= 1e-9
               and m["oracle_all_exact"] >= 1.0,
               f"event-oracle rel diff {m['oracle_max_rel_diff']:.2g} "
               f"over all sweep points, exactness claimed"),
    )


register_experiment(Experiment(
    name="obs14_qos_noisy_neighbor", obs=14,
    title="Reset-happy neighbors only break tenant SLOs on the data path",
    claim="Under open-loop Poisson reads, a neighbor firing zone resets "
          "leaves the victim's completions bit-identical on the ZN540 "
          "(Obs#12), while the NVMeVirt profile — erase on the data path "
          "— inflates the victim's p99.9 and SLO-violation rate with the "
          "reset rate; the aggressor itself pays Obs#13 inflation.",
    figure="Fig. 7 (scenario extension)",
    points=(
        SweepPoint("quiet", _victim(), spec=_SPEC),
        SweepPoint("aggr_10", _aggressor(_victim(), 10.0, 5), spec=_SPEC),
        SweepPoint("aggr_40", _aggressor(_victim(), 40.0, 20), spec=_SPEC),
        SweepPoint("aggr_alone",
                   _aggressor(WorkloadSpec(), 40.0, 20, io_ctx=None),
                   spec=_SPEC),
        SweepPoint("nv_quiet", _victim(), spec=_SPEC, params=_NV),
        SweepPoint("nv_aggr_10", _aggressor(_victim(), 10.0, 5),
                   spec=_SPEC, params=_NV),
        SweepPoint("nv_aggr_40", _aggressor(_victim(), 40.0, 20),
                   spec=_SPEC, params=_NV),
    ),
    extract=_x14, check=_c14,
    knobs=("LatencyParams.reset_on_io_path", "LatencyParams.reset_inflation",
           "ZNSDeviceSpec.reset_parallelism", "StreamSpec.arrival"),
    tests=("tests/test_arrival.py::test_obs14_noisy_neighbor_registry_checks",),
))


# ---------------------------------------------------------------------------
# Obs 15 — diurnal load: schedule reclaim into the troughs
# ---------------------------------------------------------------------------
_DAY_PHASES = (0.0, 60_000.0)        # two 30 ms busy phases
_PHASE_N = 300                       # one read / 100 us
_TROUGHS = ((30_000.0, 60_000.0), (90_000.0, 120_000.0))
_WHOLE_DAY = ((0.0, 120_000.0),)
_BACKLOG_ZONES = 8


def _diurnal_reads() -> WorkloadSpec:
    wl = WorkloadSpec()
    for start in _DAY_PHASES:
        wl = wl.reads(n=_PHASE_N, size=4 * KiB, qd=0, start_us=start,
                      arrival=DeterministicRate(every_us=100.0))
    return wl


def _with_reclaim(windows) -> WorkloadSpec:
    """Foreground reads + the scheduler's backlog compiled open-loop
    into ``windows`` (the trough-scheduling path).  Runs at import: the
    scheduler reads only the session's zone state and latency model, so
    the session never resolves its device."""
    sched = ReclaimScheduler(ZnsDevice(_SPEC), io_ctx=_R)
    sched.schedule(range(_BACKLOG_ZONES))
    return sched.reclaim_workload(base=_diurnal_reads(), thread=5,
                                  windows=windows)


def _x15(ctx) -> Dict[str, float]:
    m: Dict[str, float] = {}
    for label in ("nv_no_reclaim", "nv_uniform", "nv_trough"):
        res = ctx[label]
        key = label[3:]
        m[f"p999_{key}_us"] = _victim_p999(res)
        m[f"slo_rate_{key}"] = _victim_slo_rate(res)
    for label in ("nv_uniform", "nv_trough"):
        res = ctx[label]
        rmask = res.trace.op == int(_RESET)
        m[f"reset_total_{label[3:]}_us"] = float(
            np.sum(res.sim.in_device_latency[rmask]))
        m[f"resets_{label[3:]}"] = float(np.count_nonzero(rmask))
    quiet = ctx["nv_no_reclaim"]
    trough = ctx["nv_trough"]
    m["trough_read_shift_us"] = float(np.max(np.abs(
        trough.sim.complete[_read_mask(trough)]
        - quiet.sim.complete[_read_mask(quiet)])))
    zq, zu = ctx["zn540_no_reclaim"], ctx["zn540_uniform"]
    m["zn540_read_shift_us"] = float(np.max(np.abs(
        zu.sim.complete[_read_mask(zu)]
        - zq.sim.complete[_read_mask(zq)])))
    return m


def _c15(m) -> Tuple[Check, ...]:
    return (
        _holds("trough_hides_reclaim",
               m["trough_read_shift_us"] <= 1e-6,
               f"trough-scheduled reclaim shifts busy-phase reads by "
               f"{m['trough_read_shift_us']:.2g} us (vs no reclaim)"),
        _holds("uniform_drags_tail",
               m["p999_uniform_us"] > 5.0 * m["p999_trough_us"]
               and m["slo_rate_uniform"] > m["slo_rate_trough"],
               f"uniform reclaim p99.9 {m['p999_uniform_us']:.0f} us vs "
               f"trough {m['p999_trough_us']:.0f} us (SLO violations "
               f"{m['slo_rate_uniform']:.3f} vs "
               f"{m['slo_rate_trough']:.3f})"),
        _holds("same_reclaim_work",
               m["resets_uniform"] == m["resets_trough"]
               and abs(m["reset_total_uniform_us"]
                       - m["reset_total_trough_us"])
               <= 1e-6 * m["reset_total_uniform_us"],
               f"both schedules reset {m['resets_uniform']:.0f} zones, "
               f"{m['reset_total_uniform_us'] / 1e3:.1f} ms of erase work"),
        _holds("zn540_immune_either_way",
               m["zn540_read_shift_us"] <= 1e-6,
               f"calibrated ZN540 read shift {m['zn540_read_shift_us']:.2g} "
               f"us even under uniform reclaim (Obs#12)"),
    )


register_experiment(Experiment(
    name="obs15_diurnal_reclaim", obs=15,
    title="Trough-scheduled reclaim hides erase latency from the tenant",
    claim="With diurnal open-loop load, scheduling the host reclaim "
          "backlog into load troughs leaves the busy-phase tail "
          "untouched even when erases run on the data path (NVMeVirt); "
          "spreading the same reclaim work uniformly drags the tenant "
          "p99.9 through the erase latency.  The calibrated ZN540 is "
          "immune either way.",
    figure="Fig. 7 (scenario extension)",
    points=(
        SweepPoint("nv_no_reclaim", _diurnal_reads(),
                   spec=_SPEC, params=_NV),
        SweepPoint("nv_uniform", _with_reclaim(_WHOLE_DAY),
                   spec=_SPEC, params=_NV),
        SweepPoint("nv_trough", _with_reclaim(_TROUGHS),
                   spec=_SPEC, params=_NV),
        SweepPoint("zn540_no_reclaim", _diurnal_reads(), spec=_SPEC),
        SweepPoint("zn540_uniform", _with_reclaim(_WHOLE_DAY), spec=_SPEC),
    ),
    extract=_x15, check=_c15,
    knobs=("LatencyParams.reset_on_io_path", "StreamSpec.arrival",
           "ReclaimScheduler.reclaim_workload"),
    tests=("tests/test_arrival.py::test_obs15_diurnal_reclaim_registry_checks",),
))
