"""The exactness matrix, built with the port's API.

The port's counterpart of ``benchmarks/exactness_matrix.py``.  Each cell
is a 2-device fleet program of one of three append-pool workloads,
jitter-free or jittered, solved three ways: pinned to the ``cols`` or
``rows`` family layout, or through the entry-sharded solver
(``sharded``), with the event engine's per-device completions as the
oracle.  A cell holds when ``ChainProgram.exact`` is true, the solve
converges, and every completion is within rtol ``TOL_JITTER_FREE``
(jitter-free) or ``TOL_JITTERED`` (jittered) of the event engine,
relative to ``max(|event|, 1 us)``.  The constants are the benchmark's,
kept equal to it by the tests.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from .chain_program import (ChainProgram, compile_fleet_program,
                            force_layout, solve_program)
from .engine import compute_service_times, simulate
from .latency import LatencyModel
from .spec import KiB, OpType, ZNSDeviceSpec
from .workload import WorkloadSpec

#: rtol of jitter-free cells: float64 accumulation noise only.
TOL_JITTER_FREE = 1e-9
#: rtol of jittered cells: one decade over jitter-free.
TOL_JITTERED = 1e-8
#: The matrix's workload rows, each jitter-free and jittered.
WORKLOADS = ("single_class", "multi_class", "reset_mixed")
#: The matrix's solve paths: the two pinned family layouts and the
#: entry-sharded solver.
LAYOUTS = ("cols", "rows", "sharded")
#: The shard executor of a sharded cell for each driver: the host
#: executor runs the ``loop`` driver, the mesh executor the fixpoint
#: kernel's stacked form (its plain version under ``torch``).
SHARD_EXECUTORS = {"loop": "host", "torch": "mesh", "cuda": "mesh"}
#: The benchmark's sweep budget, device seeds and full scale.
SWEEPS = 256
SEEDS = (3, 4)
SCALE = 150


def build_workload(name: str, scale: int = SCALE):
    """The trace of workload row ``name`` at ``scale`` requests a stream:
    saturated single-class append pools, two-class pools, or two-class
    pools mixed with zone resets (which also queue the metadata engine)."""
    wl = WorkloadSpec()
    if name == "single_class":
        for t in range(6):
            wl = wl.appends(n=scale, size=8 * KiB, qd=4, zone=t * 4,
                            nzones=4)
    elif name == "multi_class":
        for t in range(6):
            wl = wl.appends(n=scale, size=8 * KiB, qd=4, zone=t * 4,
                            nzones=4)
            wl = wl.appends(n=scale, size=64 * KiB, qd=4, zone=t * 4,
                            nzones=4)
    elif name == "reset_mixed":
        for t in range(4):
            wl = wl.appends(n=scale, size=8 * KiB, qd=4, zone=t * 4,
                            nzones=4)
            wl = wl.appends(n=scale, size=64 * KiB, qd=4, zone=t * 4,
                            nzones=4)
        wl = wl.resets(n=max(scale // 2, 8), occupancy=1.0,
                       nzones=max(scale // 2, 8), io_ctx=OpType.APPEND,
                       zone=500)
    else:
        raise KeyError(f"unknown exactness workload {name!r}; expected one "
                       f"of {WORKLOADS}")
    return wl.build()


@dataclasses.dataclass(frozen=True, eq=False)
class Cell:
    """One cell: its program (layout pinned), its service times and the
    event engine's completions of each device, in trace order."""

    name: str
    program: ChainProgram
    svc_flat: np.ndarray
    events: tuple
    tol: float
    layout: str = "rows"

    def solve(self, driver: str, *, device):
        """``(comp, sweeps_used, converged)`` of this cell with
        ``driver`` (``"loop"``, ``"torch"`` or ``"cuda"``) on
        ``device``; a sharded cell goes through
        :func:`repro_torch.core.shard.solve_program_sharded` on the
        executor of ``SHARD_EXECUTORS[driver]``."""
        if self.layout == "sharded":
            from .shard import solve_program_sharded
            return solve_program_sharded(
                self.program, self.svc_flat, sweeps=SWEEPS,
                executor=SHARD_EXECUTORS[driver], warn=False, device=device)
        return solve_program(self.program, self.svc_flat, sweeps=SWEEPS,
                             fixpoint=driver, warn=False, device=device)

    def max_rel_err(self, comp: np.ndarray) -> float:
        """Largest ``|comp - event| / max(|event|, 1)`` over both
        devices, ``comp`` in flat event order."""
        prog = self.program
        return max(float(np.max(
            np.abs(comp[prog.device_slice(b)][prog.invs[b]] - ev)
            / np.maximum(np.abs(ev), 1.0)))
            for b, ev in enumerate(self.events))


def cells(scale: int = SCALE) -> List[Cell]:
    """The 18 cells: ``WORKLOADS`` x {jitter-free, jittered} x
    ``LAYOUTS``, each a fleet of two devices running the same trace with
    the seeds ``SEEDS``, named ``workload/jitter/layout`` (a sharded
    cell's program keeps the compiler's layouts)."""
    spec = ZNSDeviceSpec()
    lat = LatencyModel(spec)
    out = []
    for wname in WORKLOADS:
        trace = build_workload(wname, scale)
        for jitter in (False, True):
            prog = compile_fleet_program(
                [trace, trace], [spec] * 2, [lat] * 2, cache=False,
                jitter=jitter, seeds=list(SEEDS))
            if jitter:
                svc = np.concatenate([
                    compute_service_times(trace, lat, seed=s,
                                          jitter=True)[prog.orders[b]]
                    for b, s in enumerate(SEEDS)])
            else:
                svc = prog.svc0_flat
            events = tuple(simulate(trace, spec, lat, seed=s,
                                    jitter=jitter).complete for s in SEEDS)
            jname = "jittered" if jitter else "jitter_free"
            for layout in LAYOUTS:
                out.append(Cell(
                    name=f"{wname}/{jname}/{layout}",
                    program=prog if layout == "sharded"
                    else force_layout(prog, layout), svc_flat=svc,
                    events=events,
                    tol=TOL_JITTERED if jitter else TOL_JITTER_FREE,
                    layout=layout))
    return out
