"""Conformance & differential validation of zone-op sequences.

The spirit of the NVMe-ZNS conformance suites (write at a non-WP offset,
append past zone capacity, exceed the open limit, reset/finish from
every state, read across a zone boundary) applied to this repo's model:
an op sequence — a :class:`repro_torch.core.Trace` or
:class:`repro_torch.core.WorkloadSpec` — is replayed through

* the **imperative** :class:`repro_torch.core.ZoneManager` (authoritative:
  state legality *plus* write pointers, capacity, and open/active
  limits), collecting the :class:`repro_torch.core.ZoneError` taxonomy, and
* the **table-driven** vectorized transition semantics
  (``repro_torch.core.state_machine.TRANSITION_TABLE`` /
  :func:`transition_array`), which knows states but not pointers.

Differential invariant: every op the table rejects the manager rejects
too; anything the manager additionally rejects must be a pointer /
capacity / limit violation.  ``tests/test_torch_conformance.py`` asserts
this for the conformance scenarios on both simulation backends.
Everything here is host-side Python and numpy.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple, Union

import numpy as np

from repro_torch.core import (
    OpType, Trace, WorkloadSpec, ZoneError, ZoneManager, ZoneState,
    ZNSDeviceSpec,
)
from repro_torch.core.state_machine import TRANSITION_TABLE


@dataclasses.dataclass(frozen=True)
class Violation:
    """One rejected op: trace index, op, zone, and the ZoneError text."""

    index: int
    op: OpType
    zone: int
    error: str

    def __str__(self) -> str:
        return f"[{self.index}] {self.op.name} zone={self.zone}: {self.error}"


def _as_trace(workload: Union[Trace, WorkloadSpec]) -> Trace:
    return workload.build() if isinstance(workload, WorkloadSpec) \
        else workload


def replay_trace(workload: Union[Trace, WorkloadSpec],
                 spec: ZNSDeviceSpec = ZNSDeviceSpec(), *,
                 default_io_bytes: int = 4096
                 ) -> Tuple[np.ndarray, List[Violation]]:
    """Replay ops in issue order through a fresh :class:`ZoneManager`.

    Returns ``(ok, violations)``: ``ok[i]`` is False when op ``i`` raised
    a :class:`ZoneError` (the op is skipped, replay continues — matching
    how a device fails one command without wedging the queue).
    RESET/FINISH occupancies are taken from live pointer state, not the
    trace's modelling hint.
    """
    trace = _as_trace(workload)
    zm = ZoneManager(spec)
    n = len(trace)
    ok = np.ones(n, dtype=bool)
    violations: List[Violation] = []
    order = np.argsort(trace.issue, kind="stable")
    for i in order:
        i = int(i)
        op = OpType(int(trace.op[i]))
        z = int(trace.zone[i])
        size = int(trace.size[i])
        try:
            if op == OpType.READ:
                # reads model a probe; a size-0 read in a trace means
                # "unspecified", not an illegal zero-length command
                zm.read(z, 0, size or default_io_bytes)
            elif op in (OpType.WRITE, OpType.APPEND):
                # size flows through untouched: a zero-size write-like
                # op must be rejected here exactly as table_ok rejects
                # it, keeping the differential invariant two-sided
                zm.write(z, size, append=op == OpType.APPEND)
            elif op == OpType.RESET:
                zm.reset(z)
            elif op == OpType.FINISH:
                zm.finish(z)
            elif op == OpType.OPEN:
                zm.open(z)
            elif op == OpType.CLOSE:
                zm.close(z)
        except ZoneError as e:
            ok[i] = False
            violations.append(Violation(index=i, op=op, zone=z,
                                        error=str(e)))
    return ok, violations


_FULL = int(ZoneState.FULL)
_WRITE_LIKE = (int(OpType.WRITE), int(OpType.APPEND))


def table_ok(workload: Union[Trace, WorkloadSpec],
             spec: ZNSDeviceSpec = ZNSDeviceSpec(), *,
             track_capacity: bool = True) -> np.ndarray:
    """State-table legality of the same replay (vectorized semantics:
    :data:`TRANSITION_TABLE` lookups over a state vector, mirroring
    :func:`repro_torch.core.transition_array`'s ``where(ok, nxt, states)``).

    With ``track_capacity`` (default) a write-pointer vector rides
    along: write-like ops reject on overflow and drive the fill-to-cap /
    ``FINISH`` / ``RESET`` pointer updates, so the only legality the
    table layer *cannot* see is what needs global host state — the
    open/active limits and non-WP write offsets.
    """
    trace = _as_trace(workload)
    n = len(trace)
    states = np.zeros(spec.num_zones, dtype=np.int32)
    wp = np.zeros(spec.num_zones, dtype=np.int64)
    cap = spec.zone_cap_bytes
    ok = np.ones(n, dtype=bool)
    order = np.argsort(trace.issue, kind="stable")
    for i in order:
        i = int(i)
        z = int(trace.zone[i])
        op = int(trace.op[i])
        nxt = TRANSITION_TABLE[states[z], op]
        if nxt < 0:
            ok[i] = False
            continue
        if track_capacity and op in _WRITE_LIKE:
            size = int(trace.size[i])
            if size <= 0 or wp[z] + size > cap:
                ok[i] = False
                continue
            wp[z] += size
            if wp[z] >= cap:
                nxt = _FULL
        if track_capacity:
            if op == int(OpType.FINISH):
                wp[z] = cap
            elif op == int(OpType.RESET):
                wp[z] = 0
        states[z] = nxt
    return ok


def differential_check(workload: Union[Trace, WorkloadSpec],
                       spec: ZNSDeviceSpec = ZNSDeviceSpec()) -> dict:
    """Cross-check imperative vs table semantics on one op sequence.

    Returns a report dict; ``report["consistent"]`` is True iff the
    table's rejections are a subset of the manager's and every extra
    manager rejection mentions a pointer/capacity/limit concern.
    """
    ok_zm, violations = replay_trace(workload, spec)
    ok_tab = table_ok(workload, spec)
    table_only = np.flatnonzero(ok_zm & ~ok_tab)
    extra = [v for v in violations if ok_tab[v.index]]
    resourceful = ("limit", "overflow", "write pointer", "boundary",
                   "invalid write", "<= 0 bytes")
    unexplained = [v for v in extra
                   if not any(s in v.error for s in resourceful)]
    return {
        "ok_manager": ok_zm,
        "ok_table": ok_tab,
        "violations": violations,
        "table_only_rejections": table_only,
        "unexplained_manager_rejections": unexplained,
        "consistent": len(table_only) == 0 and len(unexplained) == 0,
    }
