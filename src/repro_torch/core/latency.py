"""Calibrated service-time model for ZNS operations.

This is the latency model the paper prescribes for emulators (§IV):

* distinct ``append`` vs ``write`` service times (Obs#4),
* request-size dependence (Obs#3),
* LBA-format and storage-stack terms (Obs#1/#2),
* occupancy-dependent ``reset``/``finish`` costs (Obs#10, *linear* models),
* explicit/implicit open and close costs (Obs#9),
* interference coupling: I/O inflates ``reset`` (Obs#13) but not vice versa
  (Obs#12).

The model is a **parameter record**: every calibrated coefficient lives in
the :class:`LatencyParams` dataclass-of-arrays, and the latency functions
are *pure* — ``io_service_us(params, op, size, stack, fmt)`` etc. operate
on scalars or numpy arrays, so the simulation engines vectorize over
requests and the :class:`repro_torch.core.DeviceFleet` layer stacks parameters
along a leading device axis (:func:`stack_latency_params`).  Emulator
profiles (FEMU, NVMeVirt — see :mod:`repro_torch.core.emulator_models`) are just
alternative :class:`LatencyParams` values run through the same functions.

The parameters stay numpy arrays on the host: only the host-side lowering
(service times, pool replay) reads them, never a CUDA kernel.
:func:`latency_params_from_arrays` carries a parameter set given as a
dict of arrays (for example ``dataclasses.asdict`` of another
implementation's record) into this module's :class:`LatencyParams`.

:class:`LatencyModel` remains as the thin object-style wrapper the rest of
the repo binds to (``spec`` + ``params``).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from . import calibration as C
from .spec import KiB, LBAFormat, OpType, Stack, ZNSDeviceSpec

#: Index order of the per-op parameter rows: OpType.READ/WRITE/APPEND
#: values are 0/1/2, so ``params.io_svc_us[int(op)]`` is the op's row.
N_IO_OPS = 3


@dataclasses.dataclass(frozen=True, eq=False)
class LatencyParams:
    """All calibrated latency coefficients as a dataclass-of-arrays.

    Fields are plain ``np.float64`` arrays so a batch of heterogeneous
    devices stacks along a leading axis (:func:`stack_latency_params`) and
    is plain host data for the fleet path.
    Equality is element-wise (ndarray fields break the generated
    ``__eq__``/``__hash__``, so both are provided explicitly — a
    :class:`LatencyModel` stays comparable and dict-keyable).

    Example (pure functions over the calibrated ZN540 values)::

        >>> from repro_torch.core import DEFAULT_LATENCY_PARAMS, KiB, OpType
        >>> from repro_torch.core.latency import io_service_us, reset_us
        >>> round(float(io_service_us(DEFAULT_LATENCY_PARAMS,
        ...                           OpType.WRITE, 4 * KiB)), 2)
        11.36
        >>> round(float(reset_us(DEFAULT_LATENCY_PARAMS, 0.5)))
        11600
    """

    # -- data-path ops: service = interp(size) [+ format/stack terms] -------
    size_anchors: np.ndarray       # (K,) request-size anchors, bytes
    io_svc_us: np.ndarray          # (3, K) rows: READ, WRITE, APPEND
    stack_overhead_us: np.ndarray  # (3,) indexed by Stack value (Obs#2)
    lba512_penalty: np.ndarray     # (3,) per-op multiplier (Obs#1)
    # -- zone-management ops -------------------------------------------------
    reset_occ: np.ndarray          # (M,) occupancy anchors (Obs#10)
    reset_us_table: np.ndarray     # (M,) reset cost at each anchor, us
    reset_finished_discount: np.ndarray  # () multiplier for finished zones
    finish_floor_us: np.ndarray    # () metadata floor (Obs#10)
    finish_span_us: np.ndarray     # () cost of finishing an ~empty zone
    open_cost_us: np.ndarray       # () explicit open (Obs#9)
    close_cost_us: np.ndarray      # () close (Obs#9)
    implicit_open_us: np.ndarray   # (3,) per-op first-write penalty (Obs#9)
    # -- interference couplings (Obs#12/#13) ---------------------------------
    reset_inflation: np.ndarray    # (3,) multiplier per concurrent I/O op
    reset_on_io_path: np.ndarray   # () 1.0 -> resets contend with I/O
    #                                 (emulator behaviour violating Obs#12);
    #                                 0.0 -> dedicated metadata engine.
    # -- stochastic service-time shape ---------------------------------------
    reset_tail_sigma: np.ndarray   # () lognormal sigma for reset/finish
    io_jitter_sigma: np.ndarray    # (3,) lognormal sigma per I/O op

    def fields(self) -> Iterator[Tuple[str, np.ndarray]]:
        for f in dataclasses.fields(self):
            yield f.name, getattr(self, f.name)

    def __eq__(self, other):
        if not isinstance(other, LatencyParams):
            return NotImplemented
        return all(np.array_equal(v, getattr(other, name))
                   for name, v in self.fields())

    def __hash__(self):
        return hash(tuple(np.asarray(v, dtype=np.float64).tobytes()
                          for _, v in self.fields()))


def _arr(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float64)


def zn540_params() -> LatencyParams:
    """The paper's calibrated ZN540 parameters (anchors in calibration.py)."""
    keys = sorted(C.WRITE_SVC_TABLE_US)
    assert keys == sorted(C.APPEND_SVC_TABLE_US) == sorted(C.READ_SVC_TABLE_US)
    occ = sorted(C.RESET_LAT_MS_TABLE)
    return LatencyParams(
        size_anchors=_arr(keys),
        io_svc_us=_arr([[C.READ_SVC_TABLE_US[k] for k in keys],
                        [C.WRITE_SVC_TABLE_US[k] for k in keys],
                        [C.APPEND_SVC_TABLE_US[k] for k in keys]]),
        stack_overhead_us=_arr([C.STACK_OVERHEAD_US[Stack(s)]
                                for s in range(3)]),
        lba512_penalty=_arr([C.LBA512_PENALTY[OpType.READ],
                             C.LBA512_PENALTY[OpType.WRITE],
                             C.LBA512_PENALTY[OpType.APPEND]]),
        reset_occ=_arr(occ),
        reset_us_table=_arr([C.RESET_LAT_MS_TABLE[o] * 1e3 for o in occ]),
        reset_finished_discount=_arr(C.RESET_FINISHED_DISCOUNT),
        finish_floor_us=_arr(C.FINISH_LAT_FLOOR_MS * 1e3),
        finish_span_us=_arr(C.FINISH_LAT_SPAN_MS * 1e3),
        open_cost_us=_arr(C.OPEN_LAT_US),
        close_cost_us=_arr(C.CLOSE_LAT_US),
        implicit_open_us=_arr([0.0, C.IMPLICIT_OPEN_FIRST_WRITE_PENALTY_US,
                               C.IMPLICIT_OPEN_FIRST_APPEND_PENALTY_US]),
        reset_inflation=_arr([C.RESET_INFLATION[OpType.READ],
                              C.RESET_INFLATION[OpType.WRITE],
                              C.RESET_INFLATION[OpType.APPEND]]),
        reset_on_io_path=_arr(0.0),
        reset_tail_sigma=_arr(C.RESET_TAIL_SIGMA),
        io_jitter_sigma=_arr([0.15, 0.05, 0.05]),
    )


def stack_latency_params(params: Sequence[LatencyParams]) -> LatencyParams:
    """Stack N parameter pytrees along a new leading device axis.

    All members must share anchor-grid shapes (the built-in profiles do);
    mismatched shapes raise ``ValueError``.
    """
    if not params:
        raise ValueError("stack_latency_params: empty sequence")
    out = {}
    for name, first in params[0].fields():
        vals = [getattr(p, name) for p in params]
        if any(v.shape != first.shape for v in vals):
            raise ValueError(
                f"LatencyParams.{name} shapes differ across devices: "
                f"{[v.shape for v in vals]}; re-anchor the profiles on a "
                f"common grid before stacking")
        out[name] = np.stack(vals)
    return LatencyParams(**out)


def unstack_latency_params(params: LatencyParams, i: int) -> LatencyParams:
    """Member ``i`` of a stacked parameter pytree."""
    return LatencyParams(**{name: val[i] for name, val in params.fields()})


def latency_params_from_arrays(d) -> LatencyParams:
    """Build :class:`LatencyParams` from a ``{field: array}`` mapping.

    Every field must be present and no other key; values are copied to
    float64 arrays, so a parameter set exported as plain arrays (e.g.
    ``dataclasses.asdict`` of an equivalent record) round-trips exactly.
    """
    names = [f.name for f in dataclasses.fields(LatencyParams)]
    missing = sorted(set(names) - set(d))
    extra = sorted(set(d) - set(names))
    if missing or extra:
        raise ValueError(f"latency parameter fields: missing {missing}, "
                         f"unexpected {extra}")
    return LatencyParams(**{k: np.array(d[k], dtype=np.float64)
                            for k in names})


# ---------------------------------------------------------------------------
# Pure latency functions over a LatencyParams pytree
# ---------------------------------------------------------------------------
def io_service_us(params: LatencyParams, op, size_bytes, stack=Stack.SPDK,
                  fmt=LBAFormat.LBA_4K):
    """QD=1 service latency of READ/WRITE/APPEND (Obs#1–#4), vectorized
    over ``op``/``size_bytes`` (mutually broadcastable)."""
    opi = np.clip(np.asarray(op, dtype=np.int64), 0, N_IO_OPS - 1)
    size = np.asarray(size_bytes, dtype=np.float64)
    keys = params.size_anchors
    svc = params.io_svc_us
    # piecewise-linear interp against the per-op anchor row
    x = np.clip(size, keys[0], keys[-1])
    hi = np.clip(np.searchsorted(keys, x, side="left"), 1, len(keys) - 1)
    lo = hi - 1
    f = (x - keys[lo]) / (keys[hi] - keys[lo])
    core = svc[opi, lo] * (1.0 - f) + svc[opi, hi] * f
    # bandwidth-limited proportional extrapolation beyond the last anchor
    tail = svc[opi, -1] * (size / keys[-1])
    base = np.where(size > keys[-1], tail, core)
    if fmt == LBAFormat.LBA_512:
        # LBA-format penalty (Obs#1), strongest for small requests; decays
        # once transfers are large (firmware small-I/O path).
        pen = params.lba512_penalty[opi]
        decay = np.clip(32 * KiB / np.maximum(size, 4 * KiB), 0.25, 1.0)
        base = base * (1.0 + (pen - 1.0) * decay)
    # Host-stack overhead (Obs#2).
    return base + params.stack_overhead_us[int(Stack(stack))]


def reset_us(params: LatencyParams, occupancy, was_finished=False):
    """Occupancy-dependent reset cost (Obs#10, Fig. 5a)."""
    occ = np.clip(np.asarray(occupancy, dtype=np.float64), 0.0, 1.0)
    us = np.interp(occ, params.reset_occ, params.reset_us_table)
    return np.where(np.asarray(was_finished, dtype=bool),
                    us * params.reset_finished_discount, us)


def finish_us(params: LatencyParams, occupancy):
    """Occupancy-dependent finish cost (Obs#10, Fig. 5b): linear in
    remaining capacity + metadata floor."""
    occ = np.clip(np.asarray(occupancy, dtype=np.float64), 0.0, 1.0)
    return params.finish_floor_us + params.finish_span_us * (1.0 - occ)


def open_us(params: LatencyParams, explicit: bool = True) -> float:
    return float(params.open_cost_us) if explicit else 0.0


def close_us(params: LatencyParams) -> float:
    return float(params.close_cost_us)


def implicit_open_penalty_us(params: LatencyParams, op: OpType) -> float:
    """First write/append to a not-yet-open zone (Obs#9)."""
    op = int(op)
    if 0 <= op < N_IO_OPS:
        return float(params.implicit_open_us[op])
    return 0.0


def reset_inflation_factors(params: LatencyParams, io_ctx) -> np.ndarray:
    """Obs#13 multiplier on reset latency for each concurrent-I/O context
    (``io_ctx``: OpType value of I/O running concurrently, or -1)."""
    ctx = np.asarray(io_ctx, dtype=np.int64)
    valid = (ctx >= 0) & (ctx < N_IO_OPS)
    return np.where(valid, params.reset_inflation[np.clip(ctx, 0,
                                                          N_IO_OPS - 1)], 1.0)


#: The calibrated ZN540 parameters (module-level default).
DEFAULT_LATENCY_PARAMS = zn540_params()


# ---------------------------------------------------------------------------
# Object-style wrapper (stable facade; all state lives in .params)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LatencyModel:
    """Service times in microseconds for a given device spec.

    A thin binding of ``(spec, params)``; all behaviour delegates to the
    pure functions above, so a :class:`LatencyModel` and its ``params``
    produce identical results by construction.
    """

    spec: ZNSDeviceSpec = ZNSDeviceSpec()
    params: Optional[LatencyParams] = None

    def __post_init__(self):
        if self.params is None:
            object.__setattr__(self, "params", DEFAULT_LATENCY_PARAMS)

    # -- data-path ops -------------------------------------------------------
    def io_service_us(self, op, size_bytes, stack=Stack.SPDK,
                      fmt=LBAFormat.LBA_4K):
        """QD=1 service latency of READ/WRITE/APPEND (Obs#1–#4)."""
        return io_service_us(self.params, op, size_bytes, stack, fmt)

    # -- zone-management ops ---------------------------------------------------
    def open_us(self, explicit: bool = True) -> float:
        return open_us(self.params, explicit)

    def close_us(self) -> float:
        return close_us(self.params)

    def implicit_open_penalty_us(self, op: OpType) -> float:
        """First write/append to a not-yet-open zone (Obs#9)."""
        return implicit_open_penalty_us(self.params, op)

    def reset_us(self, occupancy, was_finished=False):
        """Occupancy-dependent reset cost (Obs#10, Fig. 5a)."""
        return reset_us(self.params, occupancy, was_finished)

    def finish_us(self, occupancy):
        """Occupancy-dependent finish cost (Obs#10, Fig. 5b)."""
        return finish_us(self.params, occupancy)

    def reset_inflation(self, concurrent_ops) -> float:
        """Multiplier on reset latency under concurrent I/O (Obs#13).

        ``concurrent_ops``: iterable of OpType present concurrently.  The
        worst single-op inflation applies (contention is for the same
        internal resource, not additive in op count — Fig. 7 shows similar
        inflation for each op class alone).
        """
        mult = 1.0
        for op in concurrent_ops:
            mult = max(mult, float(
                reset_inflation_factors(self.params, int(OpType(op)))))
        return mult

    # -- derived helpers -------------------------------------------------------
    def qd1_iops(self, op, size_bytes, stack=Stack.SPDK,
                 fmt=LBAFormat.LBA_4K) -> float:
        return 1e6 / float(self.io_service_us(op, size_bytes, stack, fmt))


DEFAULT_LATENCY_MODEL = LatencyModel()


def resolve_params(lat) -> LatencyParams:
    """Normalize ``LatencyModel | LatencyParams | None`` to params."""
    if lat is None:
        return DEFAULT_LATENCY_PARAMS
    if isinstance(lat, LatencyModel):
        return lat.params
    if isinstance(lat, LatencyParams):
        return lat
    raise TypeError(f"expected LatencyModel or LatencyParams, got {type(lat)}")
