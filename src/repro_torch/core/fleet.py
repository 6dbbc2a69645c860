"""Batched multi-device simulation engine behind ``DeviceFleet``.

A fleet sweep (N devices x one workload each) used to be a Python loop of
single-device runs.  This module lowers all devices' traces into one
fleet-level :class:`repro_torch.core.ChainProgram`
(:func:`repro_torch.core.chain_program.compile_fleet_program`): per-device
chain families — per-thread closed-loop lag-qd chains, per-zone write
chains, metadata engine, pop-ordered per-service-class pool chains —
concatenate into fleet-wide length-bucketed ``(R, L)`` family blocks
addressing one flat completion vector, and the whole fleet solves as a
single fused Gauss–Seidel fixpoint of batched segmented max-plus scans
on the selected device (the CUDA ``zns_fixpoint`` kernel on the card,
its plain PyTorch version on the CPU).

Per-device results are bit-compatible with single-device runs: service
times draw from per-device seeds in the same rng order, lowering is
per-device (fleet assembly only concatenates and pads; padding rows
append isolated segments the scan treats as exact no-ops), and sweeps
apply family blocks in the same canonical order.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import List, Optional, Sequence

import numpy as np

from .engine import (
    SimResult, Trace, compute_service_times,
    zone_sequential_completions_batched,
)
from .latency import resolve_params
from .spec import ZNSDeviceSpec
from .torch_device import DEFAULT_DEVICE, resolve_device


def _pad_rows(rows: List[np.ndarray], fill: float, dtype) -> np.ndarray:
    """Stack variable-length 1-D arrays into a padded (R, L) matrix."""
    L = max(len(r) for r in rows)
    out = np.full((len(rows), L), fill, dtype=dtype)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out


#: Rows whose lengths differ by more than this factor go to separate
#: padded batches (see :func:`length_buckets`).
BUCKET_RATIO = 4.0


def length_buckets(lens: Sequence[int], *, ratio: float = BUCKET_RATIO
                   ) -> List[List[int]]:
    """Group row indices so each padded batch wastes bounded work.

    Sweep-point stacking across experiments (``repro.experiments``) mixes
    chains of wildly different lengths in one fleet call — a 40-request
    occupancy sweep next to a 100k-request I/O trace.  Padding all rows
    to the global max makes the scan do O(R * Lmax) work; bucketing rows
    whose max/min length ratio stays under ``ratio`` keeps the padding
    overhead a constant factor while still batching similar-length rows.
    Returns index lists, each sorted, covering ``range(len(lens))``.
    """
    order = sorted(range(len(lens)), key=lambda i: (lens[i], i))
    buckets: List[List[int]] = []
    base = None
    for i in order:
        if base is not None and lens[i] <= base * ratio:
            buckets[-1].append(i)
        else:
            buckets.append([i])
            base = max(lens[i], 1)
    return [sorted(b) for b in buckets]


def _warn_fleet_budget(program, svc_flat: np.ndarray, comp: np.ndarray,
                       used: int, budget: int) -> None:
    """One aggregated sweep-budget RuntimeWarning per fleet solve.

    The per-device warning of :func:`repro_torch.core.solve_program` would
    fire once per fleet call anyway (one fused solve), but it names no
    devices; this one lists the entry indices whose completions are
    still moving (found by one Bellman-target evaluation of the final
    iterate) together with the sweeps used and the budget.
    """
    from . import chain_program as cp
    target = cp._fixpoint_target(program, np.asarray(svc_flat), comp)
    moving = np.nonzero(target > comp + 1e-9)[0]
    if len(moving):
        edges = np.asarray(program.offsets + (program.n_flat,))
        devs = np.unique(np.searchsorted(edges, moving, side="right") - 1)
        detail = (f"completions are still moving on {len(devs)} of "
                  f"{program.n_devices} entries (indices {devs.tolist()}) "
                  f"and are a lower bound there")
    else:
        detail = ("the final iterate verifies as the fixpoint post-hoc "
                  "on every entry; the budget only precluded in-solve "
                  "verification")
    warnings.warn(
        f"fleet chain-program fixpoint exhausted its sweep budget "
        f"(sweeps_used={used}, budget={budget}): {detail}. Raise "
        f"sweeps= or inspect FleetRunResult.converged.",
        RuntimeWarning, stacklevel=3)


def simulate_fleet_vectorized(traces: Sequence[Trace],
                              specs: Sequence[ZNSDeviceSpec],
                              lats: Sequence,
                              *, seeds: Optional[Sequence[int]] = None,
                              jitter: bool = True, sweeps: int = 8,
                              scan_backend: str = "auto",
                              fixpoint: str = "auto",
                              refine: Optional[int] = None,
                              program=None,
                              device=DEFAULT_DEVICE) -> List[SimResult]:
    """Vectorized simulation of N heterogeneous devices at once.

    All devices' traces are lowered (once, cached) into a single
    fleet-level :class:`repro_torch.core.ChainProgram` — per-device programs
    concatenated into one flat completion vector with fleet-wide
    length-bucketed family blocks — and solved by one fused fixpoint
    (:func:`repro_torch.core.chain_program.solve_program`) on ``device``:
    one kernel call for N heterogeneous devices instead of ``sweeps ×
    families × devices`` dispatches; ``fixpoint="loop"`` pins the host
    driver.

    ``lats[i]`` may be a :class:`LatencyModel` or bare
    :class:`LatencyParams`.  ``seeds[i]`` defaults to ``i`` so device ``i``
    draws the jitter stream of a single-device run with ``seed=i``.
    Returns one :class:`SimResult` per device, equal (to float tolerance)
    to a Python loop of per-device ``simulate_vectorized`` calls.
    ``program`` reuses a pre-compiled fleet program (must match the
    traces); ``refine`` overrides the pop-order refinement budget.
    """
    from . import chain_program as cp
    resolve_device(device)
    B = len(traces)
    if not (len(specs) == len(lats) == B):
        raise ValueError(f"fleet shape mismatch: {B} traces, {len(specs)} "
                         f"specs, {len(lats)} latency models")
    seeds = list(range(B)) if seeds is None else list(seeds)
    params = [resolve_params(l) for l in lats]
    if program is None:
        program = cp.compile_fleet_program(
            traces, specs, params,
            refine=cp.DEFAULT_REFINE if refine is None else refine,
            jitter=jitter, seeds=seeds)
    if jitter:
        svc_origs = [compute_service_times(traces[b], params[b],
                                           seed=seeds[b], jitter=True)
                     for b in range(B)]
        svc_flat = np.concatenate(
            [svc_origs[b][program.orders[b]] for b in range(B)]) \
            if B else np.zeros(0)
    else:
        # jitter-free service times are part of the lowering output
        svc_flat = program.svc0_flat
        svc_origs = [svc_flat[program.device_slice(b)][program.invs[b]]
                     for b in range(B)]
    comp, used, converged = cp.solve_program(
        program, svc_flat, sweeps=sweeps, scan_backend=scan_backend,
        fixpoint=fixpoint, warn=False, device=device)
    if not converged:
        _warn_fleet_budget(program, svc_flat, comp, used, sweeps)
    results = cp.unpack_results(program, comp, svc_flat, svc_origs)
    # the compile-time exactness claim binds to the refinement service
    # vector; a jittered solve of a jitter-free program (or a seed
    # mismatch on a pre-compiled one) voids it
    seeds_bind = tuple(int(s) for s in seeds) if jitter else None
    claimed = bool(program.exact) and program.svc_seeds == seeds_bind
    return [dataclasses.replace(
        r, sweeps_used=used, converged=converged, exact=claimed,
        order_stable=bool(program.order_stable),
        unstable_pools=tuple(program.unstable_pools))
        for r in results]


def batched_sequential_completions(issues: Sequence[np.ndarray],
                                   svcs: Sequence[np.ndarray],
                                   segs: Sequence[np.ndarray], *,
                                   backend: str = "auto",
                                   device=DEFAULT_DEVICE) -> List[np.ndarray]:
    """Ragged batched max-plus scan: per-device 1-D arrays in, per-device
    completion times out, computed as one (B, L) padded scan on
    ``device`` (see :func:`zone_sequential_completions_batched`)."""
    if not (len(issues) == len(svcs) == len(segs)):
        raise ValueError("ragged batch length mismatch")
    if not issues:
        return []
    lens = [len(i) for i in issues]
    issue_mat = _pad_rows([np.asarray(i, dtype=np.float64) for i in issues],
                          0.0, np.float64)
    svc_mat = _pad_rows([np.asarray(s, dtype=np.float64) for s in svcs],
                        0.0, np.float64)
    seg_mat = _pad_rows([np.asarray(s, dtype=bool) for s in segs], True, bool)
    out = zone_sequential_completions_batched(issue_mat, svc_mat, seg_mat,
                                              backend=backend, device=device)
    return [out[i, :lens[i]] for i in range(len(lens))]
