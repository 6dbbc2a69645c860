"""Conventional (non-zoned) NVMe SSD baseline with an FTL GC model (§III-F).

The paper compares the ZN540 against a same-hardware conventional SSD
(SN640) and shows that firmware-triggered garbage collection makes write
and read throughput fluctuate (Fig. 6a/6b) and inflates read tail latency
to ~300 ms (vs ~98 ms on ZNS).  This module provides that baseline:

* a write-amplification model (dirty-block pressure vs overprovisioning),
* a GC sawtooth throughput model calibrated to Fig. 6a,
* read-latency inflation under write+GC pressure calibrated to Obs#11.

Host-side numpy, like the reference: the random series draw from
``np.random.default_rng(seed)`` in the reference's order, so they are
bit-equal to it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from . import calibration as C
from .latency import LatencyModel
from .spec import KiB, MiB, ConvDeviceSpec, OpType


@dataclasses.dataclass(frozen=True)
class PressureResult:
    """Write-pressure scenario output, shared by ZNS and conventional
    devices (Fig. 6 layout: rate-limited writes + 4 KiB random reads).

    Every registered pressure backend (``repro_torch.core.device.
    register_pressure_backend``) returns this type, so ZNS-vs-conventional
    comparisons are one code path.
    """

    t_s: np.ndarray
    write_mibs: np.ndarray
    read_lat_mean_us: float
    read_lat_p95_us: float
    read_mibs: Optional[np.ndarray] = None
    write_amplification: float = 1.0

    @property
    def write_cv(self) -> float:
        m = float(np.mean(self.write_mibs))
        return float(np.std(self.write_mibs)) / m if m > 0 else 0.0


class ConventionalSSD:
    """Steady-state + time-series model of a conventional SSD under load."""

    def __init__(self, spec: ConvDeviceSpec = ConvDeviceSpec(),
                 seed: int = 0):
        self.spec = spec
        self.lat = LatencyModel()
        self.rng = np.random.default_rng(seed)

    # -- GC model -----------------------------------------------------------
    def write_amplification(self, utilization: float) -> float:
        """Greedy-GC write amplification vs device utilization.

        Classic closed form: WA ~= 1 / (1 - u_eff) in the worst case; we
        use the standard smoothed model with overprovisioning.
        """
        op = self.spec.overprovision_frac
        u = min(utilization, 0.999) * (1.0 - op)
        if u <= self.spec.gc_write_amp_knee:
            return 1.0
        return float(1.0 + (u - self.spec.gc_write_amp_knee) / max(1.0 - u, 1e-3))

    def simulate_write_pressure(self, *, rate_mibs: float,
                                duration_s: float = 60.0,
                                utilization: float = 0.85,
                                read_qd: int = 32,
                                bin_s: float = 1.0) -> PressureResult:
        """Reproduce Fig. 6: rate-limited random writes + random 4 KiB reads.

        The ZNS device sustains the target rate flat; the conventional SSD
        oscillates between near-zero (deep GC) and peak (Fig. 6a shows a
        few MiB/s up to ~1,200 MiB/s at full-rate writes).
        """
        wa = self.write_amplification(utilization)
        peak = self.spec.peak_write_bw_bytes / MiB
        target = min(rate_mibs, peak)
        pressure = target / peak      # fraction of peak the host demands
        n = int(duration_s / bin_s)
        t = np.arange(n) * bin_s
        if wa <= 1.0 or pressure < 0.2:
            w = np.full(n, target)
        else:
            # GC sawtooth: the FTL periodically stalls host writes to free
            # blocks.  Duty/period calibrated to Fig. 6a at full pressure.
            duty = C.CONV_GC_DUTY * pressure
            period = C.CONV_GC_PERIOD_S
            phase = (t % period) / period
            in_gc = phase < duty
            burst = peak * (1.0 + 0.05 * self.rng.standard_normal(n))
            floor = C.CONV_GC_FLOOR_MIBS * (1.0 + 0.3 * np.abs(self.rng.standard_normal(n)))
            w = np.where(in_gc, floor, np.minimum(burst, target / max(1 - duty, 1e-3)))
            # conserve host-visible average at the target rate when feasible
            scale = target / max(w.mean(), 1e-9)
            w = np.minimum(w * min(scale, 1.5), peak * 1.05)
        # Reads: starved during GC bursts (Fig. 6b: up to ~3 MiB/s only).
        read_peak_mibs = 3.0 * pressure + (1 - pressure) * (
            self.spec.peak_read_bw_bytes / MiB)
        r = np.where(w > target * 0.5, read_peak_mibs * 0.6, read_peak_mibs)
        r = r * (1.0 + 0.25 * np.abs(self.rng.standard_normal(n)))
        r = np.minimum(r, self.spec.peak_read_bw_bytes / MiB)
        # Read latency under pressure (Obs#11 anchors).
        idle_mean = float(self.lat.io_service_us(OpType.READ, 4 * KiB))
        sigma = 0.54
        pressured_mean = C.CONV_READ_P95_UNDER_WRITES_MS * 1e3 / np.exp(1.645 * sigma)
        mean = idle_mean + (pressure ** 3) * pressured_mean
        p95 = mean * (np.exp(1.645 * sigma) if pressure > 0.05
                      else C.READONLY_READ_P95_US / idle_mean)
        return PressureResult(t_s=t, write_mibs=w, read_mibs=r,
                              read_lat_mean_us=float(mean),
                              read_lat_p95_us=float(p95),
                              write_amplification=wa)


def zns_write_pressure_series(*, rate_mibs: float, duration_s: float = 60.0,
                              bin_s: float = 1.0, seed: int = 0):
    """ZNS side of Fig. 6: flat at the target rate (Obs#11), host-driven GC
    (resets) costs ~1% of fill cost and runs on the metadata engine."""
    rng = np.random.default_rng(seed)
    n = int(duration_s / bin_s)
    t = np.arange(n) * bin_s
    w = np.full(n, rate_mibs) * (1.0 + 0.01 * rng.standard_normal(n))
    return t, w
