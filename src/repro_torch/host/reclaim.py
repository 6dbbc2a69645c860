"""Zone reclaim (host-side GC) scheduling and costing.

ZNS devices do no background GC (Obs#11/#12): reclaiming space is the
*host's* job — relocate whatever is still valid out of a victim zone,
then ``reset`` it.  The :class:`ReclaimScheduler` models that traffic
against the calibrated ZN540 model:

* reset cost is occupancy-dependent (Obs#10, linear) and — when resets
  run concurrently with foreground I/O — inflated by the paper's
  measured +78% p95 factor (Obs#13, ``LatencyParams.reset_inflation``);
  the inflation is charged to *reclaim throughput*, never to the
  foreground write path (Obs#12 holds structurally in the engines).
* relocation traffic (valid bytes moved before the reset) is charged at
  the device's append bandwidth and surfaces as write amplification.

The scheduler tracks valid bytes per zone (`account` / `invalidate`),
selects victims greedily by least-valid-data, and can either cost a
backlog drain in closed form (:meth:`drain`) or compile the reclaim
traffic into a :class:`repro_torch.core.WorkloadSpec` stream
(:meth:`reclaim_workload`) so it simulates *concurrently with* a
foreground workload on either backend.

The scheduler reads its device session only for the closed-form costs
(``lat``, ``steady_state``) and the zone state: constructing or using it
never touches the session's CUDA device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import (MiB, OpType, TraceReplay, WorkloadSpec,
                              ZnsDevice, ZoneError, spread_into_windows)

from .allocator import Extent, ZoneAllocator


@dataclasses.dataclass
class ReclaimReport:
    """Outcome of one backlog drain."""

    zones_reset: int = 0
    reclaimed_bytes: int = 0      # zone capacity returned to the free pool
    relocated_bytes: int = 0      # valid data rewritten before resets
    seconds: float = 0.0          # modeled reclaim wall time

    @property
    def write_amplification(self) -> float:
        """Device bytes per reclaimed byte beyond the user's own write
        (1.0 = pure resets, no relocation)."""
        if self.reclaimed_bytes <= 0:
            return 1.0
        return 1.0 + self.relocated_bytes / self.reclaimed_bytes

    @property
    def reclaim_mibs(self) -> float:
        """Reclaim throughput: capacity returned per modeled second."""
        if self.seconds <= 0:
            return float("inf") if self.reclaimed_bytes else 0.0
        return self.reclaimed_bytes / self.seconds / MiB


class ReclaimScheduler:
    """Backlog of reclaimable zones + calibrated costing of draining it.

    ``io_ctx`` names the foreground op type running concurrently with
    reclaim (charging Obs#13 inflation); ``None`` models isolated resets.
    """

    def __init__(self, device: ZnsDevice, *,
                 allocator: Optional[ZoneAllocator] = None,
                 io_ctx: Optional[OpType] = OpType.APPEND,
                 relocation_stripe: int = 1 * MiB,
                 relocation_qd: int = 4):
        self.device = device
        self.spec = device.spec
        self.zm = device.zones
        self.allocator = allocator
        self.io_ctx = io_ctx
        self.relocation_stripe = int(relocation_stripe)
        self.relocation_qd = int(relocation_qd)
        self.backlog: List[int] = []
        self._valid: Dict[int, int] = {}      # zone -> valid bytes
        self._pending_relocation = 0          # host-attributed moves to cost
        self.total = ReclaimReport()

    # -- validity accounting -------------------------------------------------
    def account(self, extents: List[Extent]) -> None:
        """Record freshly written extents as valid data."""
        for e in extents:
            self._valid[e.zone] = self._valid.get(e.zone, 0) + e.nbytes

    def invalidate(self, extents: List[Extent]) -> None:
        """Mark extents dead (deleted/overwritten/evicted objects)."""
        for e in extents:
            v = self._valid.get(e.zone, 0) - e.nbytes
            self._valid[e.zone] = max(v, 0)

    def valid_bytes(self, zone: int) -> int:
        return self._valid.get(zone, 0)

    # -- victim selection ----------------------------------------------------
    def schedule(self, zones) -> None:
        """Queue explicit zones for reclaim (deduplicated, order kept).
        Queued zones are frozen out of placement until their reset."""
        for z in zones:
            if z not in self.backlog:
                self.backlog.append(z)
                if self.allocator is not None:
                    self.allocator.frozen.add(z)

    def unschedule(self, zones) -> None:
        """Abort a pending reclaim of ``zones``: drop them from the
        backlog and thaw them for placement (used when a caller cannot
        complete the relocation step, e.g. the device is too full)."""
        for z in zones:
            if z in self.backlog:
                self.backlog.remove(z)
            if self.allocator is not None:
                self.allocator.frozen.discard(z)

    def charge_relocation(self, nbytes: int) -> None:
        """Record host-side relocation traffic (an object owner already
        re-placed the bytes through the allocator); the next ``drain``
        folds its cost and byte count into the report."""
        self._pending_relocation += int(nbytes)

    def pick_victims(self, n: int = 1, *, max_valid_frac: float = 1.0
                     ) -> List[int]:
        """Greedy least-valid-data victims among non-empty zones, queued
        onto the backlog.  ``max_valid_frac`` bounds how much relocation
        a victim may require (1.0 = any)."""
        cap = self.spec.zone_cap_bytes
        cands: List[Tuple[int, int]] = []
        for z in range(self.spec.num_zones):
            if z in self.backlog:
                continue
            if self.zm.write_pointer(z) == 0:
                continue
            valid = self.valid_bytes(z)
            if valid <= max_valid_frac * cap:
                cands.append((valid, z))
        cands.sort()
        picked = [z for _, z in cands[:n]]
        self.schedule(picked)
        return picked

    # -- costing -------------------------------------------------------------
    def _reset_cost_us(self, occupancy: float, was_finished: bool,
                       concurrent_io: bool) -> float:
        us = float(self.device.lat.reset_us(occupancy, was_finished))
        if concurrent_io and self.io_ctx is not None:
            us *= float(self.device.lat.reset_inflation([self.io_ctx]))
        return us

    def _relocation_cost_s(self, nbytes: int) -> float:
        if nbytes <= 0:
            return 0.0
        bw = self.device.steady_state(
            OpType.APPEND, self.relocation_stripe,
            qd=self.relocation_qd).bandwidth_bytes
        return nbytes / bw

    def drain(self, *, concurrent_io: bool = True) -> ReclaimReport:
        """Reclaim every backlog zone: relocate valid bytes, reset, and
        return the costed :class:`ReclaimReport`.  Mutates zone state
        (resets happen) and re-places relocated bytes through the
        allocator when one is attached."""
        rep = ReclaimReport()
        pend, self._pending_relocation = self._pending_relocation, 0
        if pend > 0:
            rep.relocated_bytes += pend
            rep.seconds += self._relocation_cost_s(pend)
        backlog, self.backlog = self.backlog, []
        for z in backlog:
            valid = self.valid_bytes(z)
            if valid > 0:
                if self.allocator is not None:
                    # Relocation is a host write: it must land somewhere.
                    moved = self.allocator.allocate(valid, stream=-1)
                    self.account(moved)
                rep.relocated_bytes += valid
                rep.seconds += self._relocation_cost_s(valid)
            try:
                occ, finished = self.zm.reset(z)
            except ZoneError:
                if self.allocator is not None:
                    self.allocator.frozen.discard(z)
                continue                      # zone vanished; skip costing
            if self.allocator is not None:
                self.allocator.frozen.discard(z)
            rep.zones_reset += 1
            rep.reclaimed_bytes += int(round(occ * self.spec.zone_cap_bytes))
            rep.seconds += self._reset_cost_us(occ, finished,
                                               concurrent_io) / 1e6
            self._valid[z] = 0
            if self.allocator is not None:
                self.allocator.forget_zone(z)
        self.total.zones_reset += rep.zones_reset
        self.total.reclaimed_bytes += rep.reclaimed_bytes
        self.total.relocated_bytes += rep.relocated_bytes
        self.total.seconds += rep.seconds
        return rep

    # -- workload compilation ------------------------------------------------
    def reclaim_workload(self, *, base: Optional[WorkloadSpec] = None,
                         thread: Optional[int] = None,
                         windows: Optional[Sequence[Tuple[float, float]]]
                         = None) -> WorkloadSpec:
        """Compile the backlog into reset (+ relocation append) streams on
        ``base`` **without draining it** — running the returned spec on a
        device models reclaim concurrent with whatever else is in
        ``base``.  Occupancies are read from live zone state.

        ``windows`` schedules the resets *open-loop into load troughs*:
        issue times are spread over the given ``(start_us, end_us)``
        windows proportionally to window length (diurnal scheduling —
        reclaim runs when foreground traffic is quiet) instead of
        back-to-back from time zero.  Omitting it keeps the legacy
        closed-loop drain."""
        wl = base if base is not None else WorkloadSpec()
        if not self.backlog:
            return wl
        cap = self.spec.zone_cap_bytes
        occs = tuple(
            float(np.clip(self.zm.write_pointer(z) / cap, 0.0, 1.0))
            for z in self.backlog)
        relocate = sum(self.valid_bytes(z) for z in self.backlog)
        ctx = -1 if self.io_ctx is None else int(self.io_ctx)
        kw = {} if thread is None else {"thread": thread}
        if windows is not None:
            times = spread_into_windows(len(occs), windows)
            kw.update(qd=0,
                      arrival=TraceReplay(times_us=tuple(map(float, times))))
        wl = wl.stream(OpType.RESET, n=1, occupancies=occs, n_per_level=1,
                       zone=self.backlog[0], io_ctx=ctx, **kw)
        if relocate > 0:
            n = max(int(np.ceil(relocate / self.relocation_stripe)), 1)
            wl = wl.appends(n=n, size=self.relocation_stripe,
                            qd=self.relocation_qd, zone=self.backlog[0])
        return wl
