"""Open-loop arrival processes for the workload layer.

A closed-loop stream (the default everywhere else in
:mod:`repro_torch.core.workload`) issues its next request only when a queue
slot frees up — the device sets the pace.  An *open-loop* stream issues
on its own clock regardless of completions, which is how the paper's
interference effects (Obs#12/#13) bite at scale: bursts pile onto the
device no matter how slowly it drains.  An :class:`ArrivalProcess` is a
seeded, deterministic recipe for such a clock: it lowers to an explicit
per-request issue-time vector, which both simulation backends (the event
oracle and the chain-program fixpoint) already consume — so the
exactness contract between them carries over to open-loop traffic
unchanged.

Attach one to a stream via ``WorkloadSpec.stream(..., arrival=...)``;
combine with ``qd=0`` ("unbounded in-flight") for a purely open-loop
stream whose closed-loop gate never binds:

    >>> from repro_torch.core import KiB, WorkloadSpec
    >>> from repro_torch.core.arrival import PoissonArrivals
    >>> wl = WorkloadSpec().reads(
    ...     n=100, size=4 * KiB, qd=0,
    ...     arrival=PoissonArrivals(rate_per_s=50_000, seed=1))
    >>> tr = wl.build()
    >>> bool((tr.issue[1:] >= tr.issue[:-1]).all())
    True

Variants (all frozen, hashable, deterministic in their ``seed``):

* :class:`DeterministicRate` — fixed spacing; subsumes the legacy
  ``every_us`` / ``rate_bytes_per_s`` stream knobs.
* :class:`PoissonArrivals` — exponential inter-arrival gaps.
* :class:`MarkovModulated` — a two-state (on/off) Markov-modulated
  Poisson process: bursty traffic with exponential dwell times.
* :class:`TraceReplay` — explicit issue times, inline or from a file.

:func:`spread_into_windows` is the scheduling helper behind
``ReclaimScheduler.reclaim_workload(windows=...)``: it places ``n``
events into trough windows proportionally to window length.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ArrivalProcess:
    """Base class: a deterministic recipe for per-request issue times.

    Subclasses implement :meth:`issue_times`; randomized processes carry
    their own ``seed`` field so ``WorkloadSpec.build()`` stays a pure
    function of the spec.
    """

    def issue_times(self, n: int, *, start_us: float = 0.0,
                    size: int = 0) -> np.ndarray:
        """``n`` nondecreasing issue times (us), offset by ``start_us``.

        ``size`` is the stream's request size in bytes — only
        byte-rate-paced processes consume it.
        """
        raise NotImplementedError

    def _check_n(self, n: int) -> int:
        if n < 0:
            raise ValueError(f"n must be >= 0, got {n}")
        return int(n)


@dataclasses.dataclass(frozen=True)
class DeterministicRate(ArrivalProcess):
    """Fixed inter-arrival spacing, specified exactly one of three ways:
    ``every_us`` (direct spacing), ``rate_per_s`` (requests per second),
    or ``rate_bytes_per_s`` (byte rate; spacing is ``size / rate``, so
    the stream's request size must be nonzero).

    Subsumes the legacy ``StreamSpec.every_us`` / ``rate_bytes_per_s``
    knobs — those now lower through this class.

    >>> DeterministicRate(every_us=10.0).issue_times(3, start_us=5.0)
    array([ 5., 15., 25.])
    >>> DeterministicRate(rate_per_s=1e6).interval_us()
    1.0
    """

    every_us: Optional[float] = None
    rate_per_s: Optional[float] = None
    rate_bytes_per_s: Optional[float] = None

    def __post_init__(self):
        set_ = [k for k in ("every_us", "rate_per_s", "rate_bytes_per_s")
                if getattr(self, k) is not None]
        if len(set_) != 1:
            raise ValueError(
                f"DeterministicRate needs exactly one of every_us | "
                f"rate_per_s | rate_bytes_per_s, got {set_ or 'none'}")
        val = float(getattr(self, set_[0]))
        if not val > 0.0 or not np.isfinite(val):
            raise ValueError(f"{set_[0]} must be finite and > 0, got {val}")

    def interval_us(self, size: int = 0) -> float:
        if self.every_us is not None:
            return float(self.every_us)
        if self.rate_per_s is not None:
            return 1e6 / float(self.rate_per_s)
        if size <= 0:
            raise ValueError(
                "rate_bytes_per_s pacing needs a request size > 0 "
                "(a zero-size stream would silently degrade to "
                "closed-loop); set size= on the stream or use "
                "rate_per_s / every_us")
        return float(size) / float(self.rate_bytes_per_s) * 1e6

    def issue_times(self, n: int, *, start_us: float = 0.0,
                    size: int = 0) -> np.ndarray:
        n = self._check_n(n)
        pace = self.interval_us(size)
        return start_us + np.arange(n, dtype=np.float64) * pace


@dataclasses.dataclass(frozen=True)
class PoissonArrivals(ArrivalProcess):
    """Poisson process at ``rate_per_s``: i.i.d. exponential gaps,
    deterministic in ``seed``.

    >>> a = PoissonArrivals(rate_per_s=1000.0, seed=7)
    >>> t = a.issue_times(4)
    >>> bool((np.diff(t) > 0).all()), len(t)
    (True, 4)
    >>> bool((t == a.issue_times(4)).all())       # same seed, same draw
    True
    """

    rate_per_s: float = 1000.0
    seed: int = 0

    def __post_init__(self):
        if not self.rate_per_s > 0.0 or not np.isfinite(self.rate_per_s):
            raise ValueError(
                f"rate_per_s must be finite and > 0, got {self.rate_per_s}")

    def issue_times(self, n: int, *, start_us: float = 0.0,
                    size: int = 0) -> np.ndarray:
        n = self._check_n(n)
        rng = np.random.default_rng(self.seed)
        gaps = rng.exponential(1e6 / float(self.rate_per_s), n)
        return start_us + np.cumsum(gaps)


@dataclasses.dataclass(frozen=True)
class MarkovModulated(ArrivalProcess):
    """Two-state Markov-modulated Poisson process (on/off bursts).

    The source alternates between an *on* state (Poisson arrivals at
    ``rate_on_per_s``) and an *off* state (``rate_off_per_s``, typically
    0) with exponentially distributed dwell times of means
    ``mean_on_us`` / ``mean_off_us``.  Deterministic in ``seed``.

    >>> a = MarkovModulated(rate_on_per_s=1e5, mean_on_us=500.0,
    ...                     mean_off_us=2000.0, seed=3)
    >>> t = a.issue_times(50)
    >>> bool((np.diff(t) >= 0).all()), len(t)
    (True, 50)
    """

    rate_on_per_s: float = 10_000.0
    rate_off_per_s: float = 0.0
    mean_on_us: float = 10_000.0
    mean_off_us: float = 10_000.0
    seed: int = 0
    start_on: bool = True

    def __post_init__(self):
        if not self.rate_on_per_s > 0.0:
            raise ValueError(
                f"rate_on_per_s must be > 0, got {self.rate_on_per_s}")
        if self.rate_off_per_s < 0.0:
            raise ValueError(
                f"rate_off_per_s must be >= 0, got {self.rate_off_per_s}")
        if not (self.mean_on_us > 0.0 and self.mean_off_us > 0.0):
            raise ValueError("dwell-time means must be > 0")

    def issue_times(self, n: int, *, start_us: float = 0.0,
                    size: int = 0) -> np.ndarray:
        n = self._check_n(n)
        rng = np.random.default_rng(self.seed)
        out = np.empty(n, dtype=np.float64)
        t = 0.0
        on = bool(self.start_on)
        dwell = self.mean_on_us if on else self.mean_off_us
        state_end = float(rng.exponential(dwell))
        i = 0
        while i < n:
            rate = self.rate_on_per_s if on else self.rate_off_per_s
            # Memorylessness makes discarding the partial gap at a state
            # switch and redrawing in the new state statistically exact.
            gap = (float(rng.exponential(1e6 / rate)) if rate > 0.0
                   else float("inf"))
            if t + gap >= state_end:
                t = state_end
                on = not on
                dwell = self.mean_on_us if on else self.mean_off_us
                state_end = t + float(rng.exponential(dwell))
                continue
            t += gap
            out[i] = t
            i += 1
        return start_us + out


@dataclasses.dataclass(frozen=True)
class TraceReplay(ArrivalProcess):
    """Replay explicit issue times — inline (``times_us``) or from a
    text file (``path``: whitespace-separated microsecond floats;
    ``#``-prefixed comment lines are skipped).  Times are sorted at
    lowering; the trace must hold at least as many times as the stream
    has requests.

    >>> TraceReplay(times_us=(30.0, 10.0, 20.0)).issue_times(2)
    array([10., 20.])
    """

    times_us: Tuple[float, ...] = ()
    path: Optional[str] = None

    def __post_init__(self):
        if bool(self.times_us) == (self.path is not None):
            raise ValueError(
                "TraceReplay needs exactly one of times_us | path")

    def _load(self) -> np.ndarray:
        if self.path is not None:
            vals = []
            with open(self.path) as f:
                for line in f:
                    line = line.strip()
                    if not line or line.startswith("#"):
                        continue
                    vals.extend(float(tok) for tok in line.split())
            times = np.asarray(vals, dtype=np.float64)
        else:
            times = np.asarray(self.times_us, dtype=np.float64)
        if not np.isfinite(times).all():
            raise ValueError("TraceReplay times must be finite")
        return np.sort(times)

    def issue_times(self, n: int, *, start_us: float = 0.0,
                    size: int = 0) -> np.ndarray:
        n = self._check_n(n)
        times = self._load()
        if len(times) < n:
            raise ValueError(
                f"TraceReplay holds {len(times)} issue times but the "
                f"stream needs {n}")
        return start_us + times[:n]


def spread_into_windows(n: int, windows: Sequence[Tuple[float, float]]
                        ) -> np.ndarray:
    """``n`` issue times (us) spread over ``[(start_us, end_us), ...]``
    windows: each window receives a share proportional to its length,
    placed evenly inside it (half-step inset from the edges).  The
    trough-scheduling primitive behind
    ``ReclaimScheduler.reclaim_workload(windows=...)``.

    >>> t = spread_into_windows(4, [(0.0, 100.0), (300.0, 400.0)])
    >>> [round(float(x), 1) for x in t]
    [25.0, 75.0, 325.0, 375.0]
    """
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    wins = [(float(lo), float(hi)) for lo, hi in windows]
    if not wins or any(hi <= lo for lo, hi in wins):
        raise ValueError(f"windows must be nonempty (start < end): {wins}")
    lengths = np.asarray([hi - lo for lo, hi in wins])
    # Largest-remainder apportionment of n slots over the windows.
    quota = n * lengths / lengths.sum()
    counts = np.floor(quota).astype(int)
    rem = n - int(counts.sum())
    if rem > 0:
        order = np.argsort(-(quota - counts), kind="stable")
        counts[order[:rem]] += 1
    out = []
    for (lo, hi), k in zip(wins, counts):
        if k == 0:
            continue
        step = (hi - lo) / k
        out.append(lo + step * (np.arange(k) + 0.5))
    return np.sort(np.concatenate(out)) if out \
        else np.zeros(0, dtype=np.float64)
