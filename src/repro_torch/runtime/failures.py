"""Failure detection and straggler mitigation for the multi-host runtime.

The port's own copy of ``repro.runtime.failures`` (host Python and
numpy, unchanged).  The control plane operates on a simulated clock;
the *policies* (lease-based failure detection, deadline-based straggler
mitigation with backup tasks, bounded restart storms) are the
production logic and are unit-tested directly.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np


class HostState(enum.Enum):
    HEALTHY = "healthy"
    SUSPECT = "suspect"
    DEAD = "dead"


@dataclasses.dataclass
class HostInfo:
    host: int
    last_heartbeat: float = 0.0
    state: HostState = HostState.HEALTHY
    incarnation: int = 0


class FailureDetector:
    """Lease-based detector: miss one lease -> SUSPECT, two -> DEAD.

    SUSPECT hosts keep participating but their checkpoint shards get
    backup copies; DEAD hosts trigger elastic resharding.
    """

    def __init__(self, n_hosts: int, *, lease_s: float = 10.0):
        self.lease_s = lease_s
        self.hosts = {h: HostInfo(h) for h in range(n_hosts)}

    def heartbeat(self, host: int, now: float) -> None:
        info = self.hosts[host]
        info.last_heartbeat = now
        if info.state is HostState.DEAD:
            info.incarnation += 1      # rejoin with a new incarnation
        info.state = HostState.HEALTHY

    def tick(self, now: float) -> dict:
        """Advance the detector; returns {host: HostState} transitions."""
        changes = {}
        for info in self.hosts.values():
            age = now - info.last_heartbeat
            new = info.state
            if age > 2 * self.lease_s:
                new = HostState.DEAD
            elif age > self.lease_s:
                new = HostState.SUSPECT
            else:
                new = HostState.HEALTHY
            if new is not info.state:
                info.state = new
                changes[info.host] = new
        return changes

    def healthy_hosts(self) -> list[int]:
        return [h for h, i in self.hosts.items()
                if i.state is not HostState.DEAD]


@dataclasses.dataclass
class StragglerPolicy:
    """Deadline = factor x rolling median; over deadline -> backup task."""

    factor: float = 1.5
    window: int = 32

    def __post_init__(self):
        self._history: list[float] = []

    def observe(self, duration_s: float) -> None:
        self._history.append(duration_s)
        self._history = self._history[-self.window:]

    def deadline(self) -> Optional[float]:
        if len(self._history) < 4:
            return None
        return float(np.median(self._history)) * self.factor

    def mitigate(self, host_durations: dict) -> dict:
        """Given {host: projected_duration}, return {host: backup_host}
        for hosts over deadline (backup = next healthy host)."""
        dl = self.deadline()
        if dl is None:
            return {}
        hosts = sorted(host_durations)
        out = {}
        for i, h in enumerate(hosts):
            if host_durations[h] > dl:
                out[h] = hosts[(i + 1) % len(hosts)]
        return out


@dataclasses.dataclass
class RestartBudget:
    """Bounded restart storms: at most ``max_restarts`` in ``window_s``."""

    max_restarts: int = 5
    window_s: float = 3600.0

    def __post_init__(self):
        self._times: list[float] = []

    def allow(self, now: float) -> bool:
        self._times = [t for t in self._times if now - t < self.window_s]
        if len(self._times) >= self.max_restarts:
            return False
        self._times.append(now)
        return True
