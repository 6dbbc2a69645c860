"""Executable form of the paper's emulator-fidelity analysis (§IV).

The paper examines FEMU and NVMeVirt and identifies which of the 13
observations each can reproduce, given its latency-model design.  Each
emulator's *model* (not the emulator itself) is encoded as a named
:class:`repro_torch.core.latency.LatencyParams` profile — the same parameter
pytree the calibrated ZN540 model uses — so all three run through the
identical simulation engines (single device or batched
:class:`repro_torch.core.DeviceFleet`), benchmarks compare them on identical
workloads, and :func:`simulated_fidelity` *derives* the §IV matrix from
simulated outputs instead of trusting the hardcoded table.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import calibration as C
from .latency import (
    DEFAULT_LATENCY_PARAMS, LatencyModel, LatencyParams, finish_us,
    io_service_us, reset_us,
)
from .spec import KiB, MiB, OpType, Stack

#: Which paper observations each emulator reproduces (paper §IV text).
#: Observations 1, 2, 11 are excluded by the paper as not-ZNS-essential.
FIDELITY_MATRIX = {
    # obs:      3      4      5      6      7      8      9      10     12     13
    "femu":     dict.fromkeys([3, 4, 5, 6, 7, 8, 9, 10, 12, 13], False),
    "nvmevirt": {3: True, 4: False, 5: False, 6: False, 7: True, 8: True,
                 9: False, 10: False, 12: False, 13: False},
    "ours":     dict.fromkeys([3, 4, 5, 6, 7, 8, 9, 10, 12, 13], True),
}


# ---------------------------------------------------------------------------
# Profiles: one LatencyParams per emulator, on the ZN540 anchor grids so
# heterogeneous fleets can stack them along a device axis.
# ---------------------------------------------------------------------------
_FEMU_DRAM_LAT_US = 1.5    # DRAM-backed completion
_FEMU_DRAM_BW = 12e9       # bytes/s host memcpy
_NVMEVIRT_NAND_ERASE_US = 3500.0   # "multiple milliseconds", static


def femu_params() -> LatencyParams:
    """FEMU 'makes no attempt at emulating ZNS SSD request latency';
    requests complete as fast as host DRAM permits (§IV)."""
    d = DEFAULT_LATENCY_PARAMS
    sizes = d.size_anchors
    dram = _FEMU_DRAM_LAT_US + sizes / _FEMU_DRAM_BW * 1e6
    return dataclasses.replace(
        d,
        io_svc_us=np.stack([dram, dram, dram]),       # read==write==append
        stack_overhead_us=np.zeros(3),                # no host-stack model
        lba512_penalty=np.ones(3),
        reset_us_table=np.full_like(d.reset_occ, _FEMU_DRAM_LAT_US),
        reset_finished_discount=np.float64(1.0),
        # "finish operations will become unrealistically fast" (§IV)
        finish_floor_us=np.float64(_FEMU_DRAM_LAT_US),
        finish_span_us=np.float64(0.0),
        open_cost_us=np.float64(0.0),
        close_cost_us=np.float64(0.0),
        implicit_open_us=np.zeros(3),
        reset_inflation=np.ones(3),                   # no Obs#13 coupling
        reset_on_io_path=np.float64(0.0),
        reset_tail_sigma=np.float64(0.0),
        io_jitter_sigma=np.zeros(3),
    )


def nvmevirt_params() -> LatencyParams:
    """NVMeVirt: explicit channel/NAND timing, accurate for read/write, but
    (a) append == write latency, (b) reset is a static NAND-erase constant
    executed on the data path, (c) no finish/open/close timing (§IV)."""
    d = DEFAULT_LATENCY_PARAMS
    # append modeled with the *write* latency row — the §IV critique.
    io_rows = np.stack([d.io_svc_us[int(OpType.READ)],
                        d.io_svc_us[int(OpType.WRITE)],
                        d.io_svc_us[int(OpType.WRITE)]])
    return dataclasses.replace(
        d,
        io_svc_us=io_rows,
        stack_overhead_us=np.zeros(3),                # device emulator only
        reset_us_table=np.full_like(d.reset_occ, _NVMEVIRT_NAND_ERASE_US),
        reset_finished_discount=np.float64(1.0),
        finish_floor_us=np.float64(0.0),              # not modeled at all
        finish_span_us=np.float64(0.0),
        open_cost_us=np.float64(0.0),
        close_cost_us=np.float64(0.0),
        implicit_open_us=np.zeros(3),
        reset_inflation=np.ones(3),
        reset_on_io_path=np.float64(1.0),             # erase blocks the channel
        reset_tail_sigma=np.float64(0.0),
    )


EMULATOR_PROFILES: dict[str, LatencyParams] = {
    "femu": femu_params(),
    "nvmevirt": nvmevirt_params(),
    "ours": DEFAULT_LATENCY_PARAMS,
}


# ---------------------------------------------------------------------------
# Simulated fidelity: derive the §IV matrix from model outputs.
# ---------------------------------------------------------------------------
def _within(x: float, anchor: float, rel: float) -> bool:
    return abs(x - anchor) <= rel * anchor


def simulated_fidelity(profile, *, backend: str = "event",
                       device="cuda") -> dict:
    """Which observations a latency profile reproduces, **by simulation**.

    Every entry is decided from the profile's actual outputs — pure
    latency-function evaluations for the per-request observations, full
    engine runs (through the standard device session) for the concurrency
    and interference ones — never from :data:`FIDELITY_MATRIX` itself.
    Tests assert the derived dict equals the paper's table.  ``device``
    is the device the runs solve on (see :class:`ZnsDevice`).
    """
    from .device import ZnsDevice          # local import: device -> us
    from .workload import WorkloadSpec

    params = EMULATOR_PROFILES[profile] if isinstance(profile, str) \
        else profile
    dev = ZnsDevice(lat=LatencyModel(params=params), device=device)
    obs = {}

    def run(wl):
        return dev.run(wl, backend=backend, jitter=False)

    # Obs#3 — request-size dependence matching the measured curve.
    w4 = float(io_service_us(params, OpType.WRITE, 4 * KiB))
    w32 = float(io_service_us(params, OpType.WRITE, 32 * KiB))
    obs[3] = _within(w4, 11.36, 0.25) and _within(w32, 27.10, 0.25)
    # Obs#4 — append and write have distinct service latencies.
    a8 = float(io_service_us(params, OpType.APPEND, 8 * KiB))
    w8 = float(io_service_us(params, OpType.WRITE, 8 * KiB))
    obs[4] = a8 >= 1.10 * w8
    # Obs#5 — scheduler-dependent write path (mq-deadline adds measurable
    # overhead over SPDK; prerequisite for modeling merged intra-zone
    # writes at QD>1).
    mq = float(io_service_us(params, OpType.WRITE, 4 * KiB,
                             Stack.KERNEL_MQ_DEADLINE))
    obs[5] = _within(mq - w4, 3.11, 0.25)
    # Obs#6 — append concurrency saturates at the measured 132 KIOPS.
    r = run(WorkloadSpec().appends(n=3000, size=4 * KiB, qd=4))
    obs[6] = _within(r.iops, C.APPEND_IOPS_CAP, 0.20)
    # Obs#7 — intra-zone read scaling reaches the measured 424 KIOPS.
    r = run(WorkloadSpec().reads(n=6000, size=4 * KiB, qd=128))
    obs[7] = _within(r.iops, C.READ_IOPS_CAP, 0.20)
    # Obs#8 — >=32 KiB writes saturate device bandwidth (~1155 MiB/s).
    r = run(WorkloadSpec().writes(n=2000, size=32 * KiB, qd=1))
    obs[8] = _within(r.bandwidth_bytes / MiB, C.PEAK_WRITE_BW_MIBS, 0.15)
    # Obs#9 — explicit open/close transition costs.
    obs[9] = _within(float(params.open_cost_us), C.OPEN_LAT_US, 0.25) and \
        _within(float(params.close_cost_us), C.CLOSE_LAT_US, 0.25)
    # Obs#10 — occupancy-dependent reset and finish costs.
    r_lo = float(reset_us(params, 0.25))
    r_hi = float(reset_us(params, 1.0))
    f_lo = float(finish_us(params, 0.001))
    f_hi = float(finish_us(params, 1.0))
    obs[10] = r_hi >= 1.3 * r_lo and f_lo >= 10.0 * max(f_hi, 1e-9)
    # Obs#12 — resets never delay I/O.  Requires (a) simulated I/O
    # completions unchanged by concurrent resets under pool saturation and
    # (b) a reset latency in the realistic ms range, otherwise the paper's
    # interference experiment cannot even be reproduced.
    quiet = WorkloadSpec().reads(n=2000, size=4 * KiB, qd=32, thread=0)
    loud = (WorkloadSpec()
            .resets(n=20, occupancy=1.0, nzones=20, thread=1)
            .reads(n=2000, size=4 * KiB, qd=32, thread=0))
    a = run(quiet)
    b = run(loud)
    rmask = b.trace.op == int(OpType.READ)
    shifted = bool(np.any(np.abs(b.sim.complete[rmask] - a.sim.complete)
                          > 1e-6))
    obs[12] = (not shifted) and r_hi >= 1e3
    # Obs#13 — concurrent I/O inflates reset latency.
    iso = run(WorkloadSpec().resets(n=30, occupancy=1.0, nzones=30))
    infl = run(WorkloadSpec().resets(n=30, occupancy=1.0, nzones=30,
                                     io_ctx=OpType.WRITE))
    ratio = (infl.latency_stats(OpType.RESET).mean_us
             / max(iso.latency_stats(OpType.RESET).mean_us, 1e-9))
    obs[13] = ratio >= 1.3
    return obs


def fidelity_report() -> list[tuple[str, int, bool]]:
    rows = []
    for name, obs in FIDELITY_MATRIX.items():
        for k in sorted(obs):
            rows.append((name, k, obs[k]))
    return rows
