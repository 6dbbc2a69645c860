"""Throughput/latency reducers used by the benchmark harness (§III-B),
plus the named metric-extractor registry behind
:meth:`repro_torch.core.RunResult.summary` and the experiment runner
(:mod:`repro.experiments`).

Example (registering a custom extractor)::

    >>> from repro_torch.core.metrics import (available_metrics, register_metric,
    ...                                 unregister_metric)
    >>> @register_metric("span_s", replace=True)
    ... def _span_s(result):
    ...     c = result.sim.complete
    ...     return float(c.max() - c.min()) / 1e6 if len(c) else 0.0
    >>> "span_s" in available_metrics()
    True
    >>> unregister_metric("span_s")
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Dict, Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class LatencyStats:
    """mean/percentile latency summary (microseconds) of one sample set.

    Includes the p99.9 tail (``p999_us``) the cluster capacity planner's
    SLO curves are drawn from.  Empty sample sets are safe: every field
    is 0.0 with ``n == 0`` (no numpy warnings, no NaNs in JSON).

    Example::

        >>> from repro_torch.core import LatencyStats
        >>> LatencyStats.from_samples([10.0, 20.0, 30.0]).mean_us
        20.0
        >>> LatencyStats.from_samples([]).p999_us
        0.0
    """

    mean_us: float
    p50_us: float
    p95_us: float
    p99_us: float
    p999_us: float
    n: int

    @staticmethod
    def from_samples(lat_us) -> "LatencyStats":
        lat = np.asarray(lat_us, dtype=np.float64)
        if len(lat) == 0:
            return LatencyStats(mean_us=0.0, p50_us=0.0, p95_us=0.0,
                                p99_us=0.0, p999_us=0.0, n=0)
        return LatencyStats(
            mean_us=float(lat.mean()), p50_us=float(np.percentile(lat, 50)),
            p95_us=float(np.percentile(lat, 95)),
            p99_us=float(np.percentile(lat, 99)),
            p999_us=float(np.percentile(lat, 99.9)), n=len(lat))


def iops(complete_us, n: int = None) -> float:
    """Operations per second over the busy interval (0.0 for empty runs)."""
    c = np.asarray(complete_us, dtype=np.float64)
    if len(c) == 0:
        return 0.0
    n = n if n is not None else len(c)
    span = c.max() - c.min()
    if span <= 0:
        return float("inf")
    return (n - 1) / span * 1e6


def bandwidth_bytes(complete_us, sizes) -> float:
    """Bytes per second over the busy interval (0.0 for empty runs)."""
    c = np.asarray(complete_us, dtype=np.float64)
    if len(c) == 0:
        return 0.0
    span = (c.max() - c.min()) / 1e6
    if span <= 0:
        return float("inf")
    return float(np.sum(sizes)) / span


def throughput_timeseries(complete_us, sizes, *, bin_s: float = 1.0):
    """(t_seconds, MiB/s) series for Fig. 6-style plots."""
    c = np.asarray(complete_us, dtype=np.float64) / 1e6
    sizes = np.asarray(sizes, dtype=np.float64)
    t0, t1 = c.min(), c.max()
    nbins = max(int((t1 - t0) / bin_s) + 1, 1)
    idx = np.clip(((c - t0) / bin_s).astype(int), 0, nbins - 1)
    acc = np.zeros(nbins)
    np.add.at(acc, idx, sizes)
    return t0 + np.arange(nbins) * bin_s, acc / bin_s / (1024 ** 2)


# ---------------------------------------------------------------------------
# Metric-extractor registry
# ---------------------------------------------------------------------------
#: An extractor maps a finished run (anything shaped like
#: :class:`repro_torch.core.RunResult`: ``.trace``, ``.sim``, ``.latency_stats()``)
#: to one scalar.  Registered extractors drive ``RunResult.summary()`` and
#: the per-experiment JSON artifacts of :mod:`repro.experiments`.
MetricFn = Callable[[object], float]
_METRICS: Dict[str, MetricFn] = {}


def register_metric(name: str, fn: Optional[MetricFn] = None, *,
                    replace: bool = False):
    """Register a named metric extractor; usable as a decorator.

    Registering an existing name warns unless ``replace=True`` (mirrors
    :func:`repro_torch.core.register_backend` semantics).
    """
    def _register(f):
        if not replace and name in _METRICS and _METRICS[name] is not f:
            warnings.warn(
                f"metric {name!r} is already registered; replacing it. "
                f"Pass replace=True to silence this warning.",
                RuntimeWarning, stacklevel=3)
        _METRICS[name] = f
        return f
    return _register(fn) if fn is not None else _register


def unregister_metric(name: str) -> None:
    _METRICS.pop(name, None)


def available_metrics() -> tuple:
    return tuple(sorted(_METRICS))


def extract_metrics(result, names: Optional[Sequence[str]] = None
                    ) -> Dict[str, float]:
    """Evaluate registered extractors on a run result -> ``{name: value}``.

    ``names=None`` evaluates every registered extractor; unknown names
    raise ``KeyError``.
    """
    if names is None:
        names = available_metrics()
    out = {}
    for name in names:
        if name not in _METRICS:
            raise KeyError(f"unknown metric {name!r}; available: "
                           f"{available_metrics()}")
        out[name] = float(_METRICS[name](result))
    return out


@register_metric("n_requests")
def _m_n(result) -> float:
    return float(len(result.trace))


@register_metric("iops")
def _m_iops(result) -> float:
    return iops(result.sim.complete)


@register_metric("bandwidth_mibs")
def _m_bw(result) -> float:
    return bandwidth_bytes(result.sim.complete, result.trace.size) / (1024 ** 2)


@register_metric("makespan_us")
def _m_makespan(result) -> float:
    c = result.sim.complete
    return float(c.max()) if len(c) else 0.0


def _lat_metric(field):
    def fn(result) -> float:
        if not len(result.trace):
            return 0.0
        return getattr(result.latency_stats(), field)
    return fn


for _f in ("mean_us", "p50_us", "p95_us", "p99_us", "p999_us"):
    register_metric(f"lat_{_f}", _lat_metric(_f))
del _f


def _qlat_metric(field):
    """Submission-to-completion ("queueing-inclusive") latency reducer:
    measured from the trace's issue times, so open-loop streams charge
    the time a burst spends waiting to be served — the quantity the
    tail-latency SLO scenarios gate on."""
    def fn(result) -> float:
        if not len(result.trace):
            return 0.0
        lat = result.sim.latency_from(result.trace.issue)
        return getattr(LatencyStats.from_samples(lat), field)
    return fn


for _f in ("p50_us", "p99_us", "p999_us"):
    register_metric(f"qlat_{_f}", _qlat_metric(_f))
del _f


#: Threshold of the default registered SLO-violation extractor
#: (``slo_violations_10ms`` in every ``RunResult.summary()``).
DEFAULT_SLO_US = 10_000.0


def violation_rate(lat_us, threshold_us: float) -> float:
    """Fraction of latency samples strictly above ``threshold_us``
    (0.0 for empty sample sets)."""
    lat = np.asarray(lat_us, dtype=np.float64)
    if len(lat) == 0:
        return 0.0
    return float(np.count_nonzero(lat > float(threshold_us)) / len(lat))


def slo_violations(threshold_us: float) -> MetricFn:
    """Extractor factory: fraction of requests whose
    submission-to-completion latency exceeds ``threshold_us``.

    Returns a :data:`MetricFn` suitable for :func:`register_metric`; the
    cluster capacity planner evaluates these per sweep point to find the
    user count a rack can serve inside a p99 SLO.  Empty runs report
    0.0 violations.

    Example::

        >>> from repro_torch.core.metrics import slo_violations, register_metric
        >>> from repro_torch.core import KiB, WorkloadSpec, ZnsDevice
        >>> fn = register_metric("slo_violations_1us", slo_violations(1.0))
        >>> res = ZnsDevice(device="cpu").run(
        ...     WorkloadSpec().writes(n=10, size=4 * KiB), backend="event",
        ...     jitter=False)
        >>> res.summary(["slo_violations_1us"])   # every write > 1 us
        {'slo_violations_1us': 1.0}
        >>> from repro_torch.core.metrics import unregister_metric
        >>> unregister_metric("slo_violations_1us")
    """
    thresh = float(threshold_us)

    def fn(result) -> float:
        if not len(result.trace):
            return 0.0
        return violation_rate(result.sim.latency_from(result.trace.issue),
                              thresh)
    fn.__name__ = f"slo_violations_{thresh:g}us"
    return fn


register_metric("slo_violations_10ms", slo_violations(DEFAULT_SLO_US))
