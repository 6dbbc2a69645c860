"""The ZNS zone state machine (paper Fig. 1).

Two implementations share one transition table:

* :class:`ZoneManager` — the host-side, imperative API used by the
  checkpoint store and the discrete-event engine.  Raises
  :class:`ZoneError` on illegal transitions, enforces the max-open /
  max-active limits, and tracks write pointers.
* :func:`transition_array` — a vectorized, pure-JAX transition function
  over arrays of zone states, used by property tests and the vectorized
  simulator.  Illegal transitions are reported via an ``ok`` mask instead
  of exceptions.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .spec import (
    ACTIVE_STATES,
    OPEN_STATES,
    OpType,
    ZNSDeviceSpec,
    ZoneState,
)


class ZoneError(RuntimeError):
    pass


# (state, op) -> new state, for ops that are unconditionally legal from that
# state.  WRITE/APPEND additionally require wp + nbytes <= cap; they map
# EMPTY -> IMPLICIT_OPEN (implicit transition) and *_OPEN -> FULL when the
# write fills the zone.
_TRANSITIONS = {
    (ZoneState.EMPTY, OpType.OPEN): ZoneState.EXPLICIT_OPEN,
    (ZoneState.EMPTY, OpType.WRITE): ZoneState.IMPLICIT_OPEN,
    (ZoneState.EMPTY, OpType.APPEND): ZoneState.IMPLICIT_OPEN,
    (ZoneState.EMPTY, OpType.FINISH): None,   # spec forbids finish on empty
    (ZoneState.EMPTY, OpType.RESET): ZoneState.EMPTY,
    (ZoneState.IMPLICIT_OPEN, OpType.WRITE): ZoneState.IMPLICIT_OPEN,
    (ZoneState.IMPLICIT_OPEN, OpType.APPEND): ZoneState.IMPLICIT_OPEN,
    (ZoneState.IMPLICIT_OPEN, OpType.OPEN): ZoneState.EXPLICIT_OPEN,
    (ZoneState.IMPLICIT_OPEN, OpType.CLOSE): ZoneState.CLOSED,
    (ZoneState.IMPLICIT_OPEN, OpType.FINISH): ZoneState.FULL,
    (ZoneState.IMPLICIT_OPEN, OpType.RESET): ZoneState.EMPTY,
    (ZoneState.EXPLICIT_OPEN, OpType.WRITE): ZoneState.EXPLICIT_OPEN,
    (ZoneState.EXPLICIT_OPEN, OpType.APPEND): ZoneState.EXPLICIT_OPEN,
    (ZoneState.EXPLICIT_OPEN, OpType.CLOSE): ZoneState.CLOSED,
    (ZoneState.EXPLICIT_OPEN, OpType.FINISH): ZoneState.FULL,
    (ZoneState.EXPLICIT_OPEN, OpType.RESET): ZoneState.EMPTY,
    (ZoneState.CLOSED, OpType.WRITE): ZoneState.IMPLICIT_OPEN,
    (ZoneState.CLOSED, OpType.APPEND): ZoneState.IMPLICIT_OPEN,
    (ZoneState.CLOSED, OpType.OPEN): ZoneState.EXPLICIT_OPEN,
    (ZoneState.CLOSED, OpType.FINISH): ZoneState.FULL,
    (ZoneState.CLOSED, OpType.RESET): ZoneState.EMPTY,
    (ZoneState.FULL, OpType.RESET): ZoneState.EMPTY,
    # READs are legal from any non-offline state and change nothing.
}


@dataclasses.dataclass
class ZoneInfo:
    state: ZoneState
    write_pointer: int      # bytes written (relative to zone start)
    was_finished: bool      # finish() seen since last reset (discounts reset)


class ZoneManager:
    """Host-side zone bookkeeping with strict legality enforcement."""

    def __init__(self, spec: ZNSDeviceSpec):
        self.spec = spec
        self.zones = [
            ZoneInfo(ZoneState.EMPTY, 0, False) for _ in range(spec.num_zones)
        ]

    # -- queries ------------------------------------------------------------
    def state(self, z: int) -> ZoneState:
        return self.zones[z].state

    def write_pointer(self, z: int) -> int:
        return self.zones[z].write_pointer

    def occupancy(self, z: int) -> float:
        return self.zones[z].write_pointer / self.spec.zone_cap_bytes

    @property
    def open_count(self) -> int:
        return sum(1 for zi in self.zones if zi.state in OPEN_STATES)

    @property
    def active_count(self) -> int:
        return sum(1 for zi in self.zones if zi.state in ACTIVE_STATES)

    def find_empty(self) -> Optional[int]:
        for z, zi in enumerate(self.zones):
            if zi.state == ZoneState.EMPTY:
                return z
        return None

    # -- transitions ----------------------------------------------------------
    def _check_limits(self, z: int) -> None:
        zi = self.zones[z]
        opening = zi.state not in OPEN_STATES
        activating = zi.state not in ACTIVE_STATES
        if opening and self.open_count >= self.spec.max_open_zones:
            raise ZoneError(
                f"max open zone limit ({self.spec.max_open_zones}) reached"
            )
        if activating and self.active_count >= self.spec.max_active_zones:
            raise ZoneError(
                f"max active zone limit ({self.spec.max_active_zones}) reached"
            )

    def open(self, z: int) -> None:
        self._apply(z, OpType.OPEN)

    def close(self, z: int) -> None:
        zi = self.zones[z]
        if zi.state not in OPEN_STATES:
            raise ZoneError(f"close on zone {z} in state {zi.state.name}")
        zi.state = ZoneState.CLOSED

    def finish(self, z: int) -> float:
        """Finish a zone; returns the occupancy at finish time (for costing)."""
        zi = self.zones[z]
        if zi.state == ZoneState.EMPTY:
            raise ZoneError("finish on EMPTY zone is not permitted (§III-E)")
        if zi.state == ZoneState.FULL:
            raise ZoneError("finish on FULL zone is not permitted (§III-E)")
        occ = self.occupancy(z)
        zi.state = ZoneState.FULL
        zi.was_finished = True
        zi.write_pointer = self.spec.zone_cap_bytes
        return occ

    def reset(self, z: int) -> tuple[float, bool]:
        """Reset a zone; returns (occupancy, was_finished) for costing."""
        zi = self.zones[z]
        if zi.state in (ZoneState.READ_ONLY, ZoneState.OFFLINE):
            raise ZoneError(f"reset on zone {z} in state {zi.state.name}")
        occ = self.occupancy(z)
        finished = zi.was_finished
        zi.state = ZoneState.EMPTY
        zi.write_pointer = 0
        zi.was_finished = False
        return occ, finished

    def write(self, z: int, nbytes: int, *, append: bool = False,
              at: Optional[int] = None) -> int:
        """Advance the write pointer; returns the LBA (bytes) written at.

        For ``append`` the returned LBA is what the device reports on
        completion (§II-B); for ``write`` the host must already know it —
        passing ``at`` (a byte offset within the zone) asserts that
        knowledge: a regular write whose offset is not the current write
        pointer is rejected (NVMe "Zone Invalid Write"), exactly as the
        ZNS conformance suites probe it.  ``at`` on an append is ignored
        (the device chooses the location).
        """
        zi = self.zones[z]
        op = OpType.APPEND if append else OpType.WRITE
        if (zi.state, op) not in _TRANSITIONS:
            raise ZoneError(f"{op.name} on zone {z} in state {zi.state.name}")
        if nbytes <= 0:
            raise ZoneError("write of <= 0 bytes")
        if not append and at is not None and at != zi.write_pointer:
            raise ZoneError(
                f"zone {z} invalid write: offset {at} != write pointer "
                f"{zi.write_pointer}"
            )
        if zi.write_pointer + nbytes > self.spec.zone_cap_bytes:
            raise ZoneError(
                f"zone {z} overflow: wp={zi.write_pointer} + {nbytes} "
                f"> cap={self.spec.zone_cap_bytes}"
            )
        self._check_limits(z)
        lba = self.spec.zone_start(z) + zi.write_pointer
        zi.state = _TRANSITIONS[(zi.state, op)]
        zi.write_pointer += nbytes
        if zi.write_pointer == self.spec.zone_cap_bytes:
            zi.state = ZoneState.FULL
        return lba

    def read(self, z: int, offset: int = 0, nbytes: int = 1) -> None:
        """Legality check for a read of ``nbytes`` at byte ``offset``.

        Reads are legal from every non-OFFLINE state but must not cross
        the zone's LBA boundary (the ZN540 does not report the
        cross-zone-read capability bit; conformance suites assert the
        boundary error)."""
        zi = self.zones[z]
        if zi.state == ZoneState.OFFLINE:
            raise ZoneError(f"read on OFFLINE zone {z}")
        if nbytes <= 0:
            raise ZoneError("read of <= 0 bytes")
        if offset < 0 or offset + nbytes > self.spec.zone_size_bytes:
            raise ZoneError(
                f"zone {z} boundary error: read [{offset}, "
                f"{offset + nbytes}) crosses zone size "
                f"{self.spec.zone_size_bytes}"
            )

    def read_ok(self, z: int) -> bool:
        return self.zones[z].state != ZoneState.OFFLINE

    def _apply(self, z: int, op: OpType) -> None:
        zi = self.zones[z]
        key = (zi.state, op)
        if key not in _TRANSITIONS or _TRANSITIONS[key] is None:
            raise ZoneError(f"{op.name} on zone {z} in state {zi.state.name}")
        if op == OpType.OPEN:
            self._check_limits(z)
        zi.state = _TRANSITIONS[key]


# ---------------------------------------------------------------------------
# Vectorized (pure-function) form over tensors.
# ---------------------------------------------------------------------------
N_STATES = len(ZoneState)
N_OPS = len(OpType)

# transition_table[state, op] = next_state, or -1 if illegal.
TRANSITION_TABLE = np.full((N_STATES, N_OPS), -1, dtype=np.int32)
for (s, o), ns in _TRANSITIONS.items():
    if ns is not None:
        TRANSITION_TABLE[int(s), int(o)] = int(ns)
for s in ZoneState:
    if s != ZoneState.OFFLINE:
        TRANSITION_TABLE[int(s), int(OpType.READ)] = int(s)


def transition_array(states, ops):
    """Vectorized transition: (states[i], ops[i]) -> (new_states[i], ok[i]).

    Works with torch tensors (on any device) or array-likes, which are
    converted to CPU tensors (table lookups only).
    """
    import torch

    states = torch.as_tensor(states)
    ops = torch.as_tensor(ops, device=states.device)
    table = torch.as_tensor(TRANSITION_TABLE, device=states.device)
    nxt = table[states.long(), ops.long()]
    ok = nxt >= 0
    return torch.where(ok, nxt, states.to(nxt.dtype)), ok
