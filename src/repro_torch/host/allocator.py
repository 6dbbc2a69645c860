"""Zone allocation with pluggable placement policies.

The :class:`ZoneAllocator` owns the host-side placement decision — which
zone receives the next extent of a write stream — on top of the strict
:class:`repro_torch.core.ZoneManager` state machine.  Policies are registered
functions (``register_placement_policy``); three ship built in:

* ``"greedy-open"``   — fill the lowest-numbered already-open zone first
  (the paper's R3 guidance: *fill* zones to capacity, never ``finish``
  them), opening a new zone only when every open zone is full.
* ``"striped"``       — rotate extents over up to ``stripe_width`` open
  zones in ``stripe_bytes`` chunks (inter-zone write parallelism,
  Obs#5: writes scale with open zones up to the limit).
* ``"lifetime-binned"`` — one active zone per data-lifetime bin so data
  that dies together is reclaimed together (the flash-cache / LSM
  guidance: zone-sized groups of equal lifetime reset with WA ≈ 1).

Every policy is bounded by the device's ``max_open_zones`` /
``max_active_zones`` limits: the allocator tracks shadow state during
planning and never proposes a placement the :class:`ZoneManager` would
reject for a limit violation.

    alloc = ZoneAllocator(spec, policy="striped", stripe_width=4)
    extents = alloc.allocate(64 * MiB, stream=1)   # plan + commit
    sum(e.nbytes for e in extents) == 64 * MiB
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core import MiB, ZNSDeviceSpec, ZoneError, ZoneManager, \
    ZoneState
from repro_torch.core.registry import Registry
from repro_torch.core.spec import ACTIVE_STATES, OPEN_STATES


@dataclasses.dataclass(frozen=True)
class Extent:
    """One contiguous placement: ``nbytes`` at byte ``offset`` of ``zone``."""

    zone: int
    offset: int
    nbytes: int

    @property
    def end(self) -> int:
        return self.offset + self.nbytes


@dataclasses.dataclass(frozen=True)
class StreamHint:
    """Placement hints accompanying an allocation request."""

    stream: int = 0
    lifetime: Optional[int] = None   # smaller = shorter-lived; None = unknown


class _PlanView:
    """Shadow of zone states during one ``plan()`` — placement decisions
    must not mutate the device before ``commit``."""

    def __init__(self, alloc: "ZoneAllocator"):
        self.alloc = alloc
        self.spec = alloc.spec
        self._wp: Dict[int, int] = {}
        self._opened: set = set()     # zones this plan newly opens

    def wp(self, z: int) -> int:
        return self._wp.get(z, self.alloc.zm.write_pointer(z))

    def state(self, z: int) -> ZoneState:
        st = self.alloc.zm.state(z)
        if z in self._opened:
            # this plan writes into an EMPTY or CLOSED zone: both count
            # against the open limit the moment the write lands
            st = ZoneState.IMPLICIT_OPEN
        if self.wp(z) >= self.spec.zone_cap_bytes:
            st = ZoneState.FULL
        return st

    def remaining(self, z: int) -> int:
        return self.spec.zone_cap_bytes - self.wp(z)

    @property
    def open_count(self) -> int:
        return sum(1 for z in range(self.spec.num_zones)
                   if self.state(z) in OPEN_STATES)

    @property
    def active_count(self) -> int:
        return sum(1 for z in range(self.spec.num_zones)
                   if self.state(z) in ACTIVE_STATES)

    def can_open_new(self) -> bool:
        return (self.open_count < self.spec.max_open_zones
                and self.active_count < self.spec.max_active_zones)

    def open_zones(self) -> List[int]:
        """Writable non-reserved zones this plan may target without a
        limit violation: open zones with capacity always qualify; CLOSED
        zones re-open on write, so they qualify only while the open
        count has headroom."""
        skip = self.alloc.reserved | self.alloc.frozen
        out = []
        open_headroom = self.open_count < self.spec.max_open_zones
        for z in range(self.spec.num_zones):
            if z in skip or self.remaining(z) <= 0:
                continue
            st = self.state(z)
            if st in OPEN_STATES or (st == ZoneState.CLOSED
                                     and open_headroom):
                out.append(z)
        return out

    def empty_zones(self) -> List[int]:
        skip = self.alloc.reserved | self.alloc.frozen
        return [z for z in range(self.spec.num_zones)
                if z not in skip and self.state(z) == ZoneState.EMPTY]

    def place(self, z: int, nbytes: int) -> Extent:
        if self.state(z) not in OPEN_STATES:
            # EMPTY or CLOSED: the write (implicitly) opens the zone
            self._opened.add(z)
        wp = self.wp(z)
        if nbytes > self.remaining(z):
            raise ZoneError(f"plan overflow: zone {z} has "
                            f"{self.remaining(z)} bytes, asked {nbytes}")
        self._wp[z] = wp + nbytes
        return Extent(zone=z, offset=wp, nbytes=nbytes)


#: A placement policy maps (view, hint, remaining bytes) to the next
#: ``(zone, take_bytes)`` placement.  It must only return zones the view
#: reports writable, and may open a new (EMPTY) zone only when
#: ``view.can_open_new()`` holds.
PolicyFn = Callable[["ZoneAllocator", _PlanView, StreamHint, int],
                    Tuple[int, int]]

_POLICIES = Registry("placement policy")


def register_placement_policy(name: str, fn: Optional[PolicyFn] = None, *,
                              replace: bool = False):
    """Register a placement policy (usable as a decorator); collisions
    warn unless ``replace=True``, mirroring ``register_backend``."""
    return _POLICIES.register(name, fn, replace=replace)


def unregister_placement_policy(name: str) -> None:
    _POLICIES.unregister(name)


def available_placement_policies() -> tuple:
    return _POLICIES.available()


def _next_zone_or_raise(view: _PlanView, prefer_open: bool = True
                        ) -> Optional[int]:
    """Lowest open zone with space, else lowest empty zone if a new one
    may be opened; None when neither exists (caller decides)."""
    opens = view.open_zones()
    if prefer_open and opens:
        return opens[0]
    if view.can_open_new():
        empties = view.empty_zones()
        if empties:
            return empties[0]
    if opens:
        return opens[0]
    return None


@register_placement_policy("greedy-open")
def _greedy_open(alloc: "ZoneAllocator", view: _PlanView, hint: StreamHint,
                 remaining: int) -> Tuple[int, int]:
    z = _next_zone_or_raise(view)
    if z is None:
        raise ZoneError("device full: no writable zones (reclaim first)")
    return z, min(remaining, view.remaining(z))


@register_placement_policy("striped")
def _striped(alloc: "ZoneAllocator", view: _PlanView, hint: StreamHint,
             remaining: int) -> Tuple[int, int]:
    # Keep up to stripe_width zones in rotation; chunks of stripe_bytes.
    width = max(1, min(alloc.stripe_width, alloc.spec.max_open_zones))
    opens = view.open_zones()
    while len(opens) < width and view.can_open_new():
        empties = view.empty_zones()
        if not empties:
            break
        # Touch the empty zone so it joins the rotation set.
        view._opened.add(empties[0])
        opens = view.open_zones()
    if not opens:
        z = _next_zone_or_raise(view)
        if z is None:
            raise ZoneError("device full: no writable zones (reclaim first)")
        opens = [z]
    ring = opens[:width]
    z = ring[alloc._rr % len(ring)]
    alloc._rr += 1
    return z, min(remaining, alloc.stripe_bytes, view.remaining(z))


@register_placement_policy("lifetime-binned")
def _lifetime_binned(alloc: "ZoneAllocator", view: _PlanView,
                     hint: StreamHint, remaining: int) -> Tuple[int, int]:
    key = hint.lifetime if hint.lifetime is not None else hint.stream
    b = int(key) % max(alloc.lifetime_bins, 1)
    z = alloc._bin_zone.get(b)
    if z is not None and z not in view.open_zones():
        z = None                  # bin zone full/frozen/limit-bound: rebind
    if z is None:
        # A fresh zone for the bin when limits allow; otherwise fall back
        # to sharing the greedy zone (bounded by max-open/max-active).
        taken = {v for k, v in alloc._bin_zone.items() if k != b}
        if view.can_open_new():
            empties = [e for e in view.empty_zones() if e not in taken]
            if empties:
                z = empties[0]
        if z is None:
            unclaimed = [o for o in view.open_zones() if o not in taken]
            opens = unclaimed or view.open_zones()
            if not opens:
                raise ZoneError("device full: no writable zones "
                                "(reclaim first)")
            z = opens[0]
        alloc._bin_zone[b] = z
    return z, min(remaining, view.remaining(z))


class ZoneAllocator:
    """Policy-driven zone placement over a :class:`ZoneManager`.

    ``plan(nbytes)`` produces :class:`Extent`\\ s without touching device
    state (a shadow tracks in-plan write pointers and newly opened
    zones); ``commit(extents)`` applies them through the state machine,
    which re-checks every transition.  ``allocate`` = plan + commit.
    """

    def __init__(self, spec: Optional[ZNSDeviceSpec] = None, *,
                 zones: Optional[ZoneManager] = None,
                 policy: str = "greedy-open",
                 reserved: Tuple[int, ...] = (),
                 stripe_bytes: int = 1 * MiB,
                 stripe_width: int = 4,
                 lifetime_bins: int = 4):
        if zones is not None:
            self.zm = zones
            self.spec = zones.spec
        else:
            self.spec = spec if spec is not None else ZNSDeviceSpec()
            self.zm = ZoneManager(self.spec)
        self.policy = policy
        self._policy_fn = _POLICIES.get(policy)
        self.reserved = frozenset(reserved)
        self.stripe_bytes = int(stripe_bytes)
        self.stripe_width = int(stripe_width)
        self.lifetime_bins = int(lifetime_bins)
        self._rr = 0                       # striped rotation counter
        self._bin_zone: Dict[int, int] = {}  # lifetime bin -> active zone
        #: Zones queued for reclaim (set by the ReclaimScheduler): never
        #: placement candidates until their reset lands.
        self.frozen: set = set()
        # counters
        self.bytes_placed = 0
        self.zones_opened = 0

    # -- planning ------------------------------------------------------------
    def plan(self, nbytes: int, *, stream: int = 0,
             lifetime: Optional[int] = None) -> List[Extent]:
        """Bin-pack ``nbytes`` into zones per the policy; pure w.r.t.
        device state.  Raises :class:`ZoneError` when the device cannot
        take the payload."""
        if nbytes <= 0:
            raise ZoneError(f"allocation of {nbytes} bytes")
        hint = StreamHint(stream=stream, lifetime=lifetime)
        view = _PlanView(self)
        out: List[Extent] = []
        remaining = int(nbytes)
        while remaining > 0:
            z, take = self._policy_fn(self, view, hint, remaining)
            take = min(take, remaining, view.remaining(z))
            if take <= 0:
                raise ZoneError(
                    f"placement policy {self.policy!r} returned a full "
                    f"zone {z}")
            out.append(view.place(z, take))
            remaining -= take
        return out

    def commit(self, extents: List[Extent], *, append: bool = True) -> None:
        """Apply planned extents through the zone state machine (which
        enforces legality and the open/active limits a second time)."""
        for e in extents:
            if self.zm.write_pointer(e.zone) != e.offset:
                raise ZoneError(
                    f"stale plan: zone {e.zone} wp="
                    f"{self.zm.write_pointer(e.zone)} != extent offset "
                    f"{e.offset}")
            was_empty = self.zm.state(e.zone) == ZoneState.EMPTY
            self.zm.write(e.zone, e.nbytes, append=append,
                          at=None if append else e.offset)
            if was_empty:
                self.zones_opened += 1
            self.bytes_placed += e.nbytes

    def allocate(self, nbytes: int, *, stream: int = 0,
                 lifetime: Optional[int] = None,
                 append: bool = True) -> List[Extent]:
        extents = self.plan(nbytes, stream=stream, lifetime=lifetime)
        self.commit(extents, append=append)
        return extents

    # -- bookkeeping hooks ---------------------------------------------------
    def forget_zone(self, z: int) -> None:
        """Drop any policy affinity for a reclaimed zone (called by the
        reclaim scheduler after a reset)."""
        for b, zz in list(self._bin_zone.items()):
            if zz == z:
                del self._bin_zone[b]

    @property
    def open_count(self) -> int:
        return self.zm.open_count

    @property
    def active_count(self) -> int:
        return self.zm.active_count

    def occupancy(self, z: int) -> float:
        return self.zm.occupancy(z)

    def __repr__(self) -> str:
        return (f"ZoneAllocator(policy={self.policy!r}, "
                f"open={self.open_count}/{self.spec.max_open_zones}, "
                f"active={self.active_count}/{self.spec.max_active_zones})")
