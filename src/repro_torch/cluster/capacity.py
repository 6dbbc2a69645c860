"""Capacity planning: users-per-rack at a p99 latency SLO.

The planner compiles every point of a (stripe width x redundancy scheme
x placement policy) x load-ladder x (normal | degraded) sweep to its
own :class:`~repro_torch.core.ChainProgram`, concatenates them with
:func:`repro_torch.core.concat_programs`, and solves the whole rack sweep in
**one** :func:`repro_torch.core.solve_program` call.  Per-config curves are
then sliced back out, the p99-vs-load curve is interpolated against
the SLO (log-space in latency), and configurations are ranked by the
load the rack can serve inside the SLO — with a degraded-mode row
(one server down, reconstruction reads) next to every normal row.

The ladder comes in two flavours:

* ``users_ladder`` — closed-loop: each rung scales ``n_users`` and the
  figure of merit is **users-at-SLO**;
* ``rate_ladder`` — open-loop: each rung keeps the user population
  fixed but stamps Poisson arrivals (``ClusterWorkload.arrival``) at
  that offered rate (objects/s) with ``qd >= ops_per_user`` so the
  closed-loop edges vanish; the figure of merit becomes
  **arrival-rate-at-SLO**.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import PoissonArrivals, concat_programs, solve_program
from repro_torch.core.metrics import (DEFAULT_SLO_US, LatencyStats,
                                      violation_rate)
from repro_torch.core.torch_device import DEFAULT_DEVICE

from .cluster import Cluster
from .codec import RedundancyScheme
from .compiler import CompiledCluster, build_graph, compile_graph, \
    op_latencies
from .spec import ClusterSpec, ClusterWorkload


def _op_digest(graph, i: int) -> bytes:
    """Content digest of op ``i``'s event slice: stage labels and
    service times.  Two rungs map an op onto each other only when
    these agree — same stages, same service demands.  Issue times are
    deliberately excluded: a rate ladder re-stamps every arrival, yet
    the op is still the same work (and the warm solve re-derives any
    slot the new clock makes stale)."""
    s, e = graph.op_slices[i]
    h = hashlib.sha1()
    h.update("|".join(graph.labels[s:e]).encode())
    h.update(np.ascontiguousarray(graph.svc[s:e]).tobytes())
    return h.digest()


def _rung_comp0(prev_graph, prev_comp: np.ndarray, graph
                ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """Warm-start arrays for the next ladder rung, mapped per-op from
    the previous rung's completions: ``(cand, seed)``.

    ``cand`` joins ops on their ``(client, slot)`` identity and accepts
    a slice only when the op's content digest (:func:`_op_digest`)
    matches — the shared clients of a users-ladder rung re-draw
    identical op streams, but e.g. a GET's device-read stage can appear
    or vanish as the global interleave shifts flush timing, and
    open-loop rate ladders re-stamp every arrival.  Unmatched slots
    stay ``-inf`` (the solver's additive identity), so a partial join
    is still a usable candidate for the verified completion warm start.

    ``seed`` additionally estimates the *new* clients' slots from
    their modulo twin (client ``c % prev_n_users``, same slot, no
    digest required) so every op sits on the previous rung's time
    scale — that is what makes it a usable FIFO pop-*order* seed,
    unlike ``cand``, whose unmatched ``-inf`` slots would interleave
    bootstrap-scale events into previous-rung-scale queues.

    ``(None, None)`` when nothing matches at all."""
    if prev_graph.op_slices is None or graph.op_slices is None or \
            prev_graph.op_keys is None or graph.op_keys is None:
        return None, None
    prev_by_key = {k: i for i, k in enumerate(prev_graph.op_keys)}
    prev_users = 1 + max(c for c, _ in prev_graph.op_keys)
    comp0 = np.full(graph.n, -np.inf)
    seed = np.full(graph.n, -np.inf)
    hits = 0
    for i, (client, slot) in enumerate(graph.op_keys):
        s, e = graph.op_slices[i]
        j = prev_by_key.get((client, slot))
        if j is not None:
            ps, pe = prev_graph.op_slices[j]
            if e - s == pe - ps and _op_digest(graph, i) == \
                    _op_digest(prev_graph, j):
                comp0[s:e] = prev_comp[ps:pe]
                seed[s:e] = prev_comp[ps:pe]
                hits += 1
                continue
        j = prev_by_key.get((client % prev_users, slot))
        if j is not None:
            ps, pe = prev_graph.op_slices[j]
            if e - s == pe - ps:
                seed[s:e] = prev_comp[ps:pe]
    if not hits:
        return None, None
    return comp0, seed


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """One ranked configuration: a redundancy scheme + placement."""

    scheme: RedundancyScheme
    placement: str

    @property
    def name(self) -> str:
        return f"{self.scheme.name}/{self.placement}"


@dataclasses.dataclass(frozen=True)
class CapacityPoint:
    """One solved sweep point (a config at one load-ladder rung).

    ``offered_rate`` is the open-loop arrival rate (objects/s) of a
    ``rate_ladder`` rung; ``None`` on closed-loop (users-ladder) points.
    """

    users: int
    objects_per_sec: float
    lat: LatencyStats
    slo_violation_rate: float
    converged: bool
    offered_rate: Optional[float] = None

    def to_json(self) -> Dict[str, float]:
        out = {"users": self.users,
               "objects_per_sec": self.objects_per_sec,
               "p50_us": self.lat.p50_us, "p99_us": self.lat.p99_us,
               "p999_us": self.lat.p999_us,
               "slo_violation_rate": self.slo_violation_rate,
               "converged": self.converged}
        if self.offered_rate is not None:
            out["offered_rate"] = self.offered_rate
        return out


@dataclasses.dataclass(frozen=True)
class CapacityCurve:
    """The p99-vs-load curve of one (config, mode).

    ``rate_at_slo`` (objects/s) is set on open-loop (``rate_ladder``)
    sweeps and becomes the ranking key; ``users_at_slo`` keeps its
    closed-loop meaning otherwise.
    """

    config: ClusterConfig
    degraded: bool
    points: Tuple[CapacityPoint, ...]
    users_at_slo: float
    rate_at_slo: Optional[float] = None

    @property
    def load_at_slo(self) -> float:
        """The curve's figure of merit: offered rate at the SLO when
        open-loop, users at the SLO otherwise."""
        return self.rate_at_slo if self.rate_at_slo is not None \
            else self.users_at_slo

    def to_json(self) -> Dict:
        out = {"config": self.config.name, "degraded": self.degraded,
               "users_at_slo": self.users_at_slo,
               "points": [p.to_json() for p in self.points]}
        if self.rate_at_slo is not None:
            out["rate_at_slo"] = self.rate_at_slo
        return out


@dataclasses.dataclass
class CapacityReport:
    """Every curve of a rack sweep + the one-call solve's metadata."""

    curves: List[CapacityCurve]
    slo_us: float
    n_programs: int
    n_events: int
    sweeps_used: int
    converged: bool
    #: Config names whose pop-order refinement exhausted its budget
    #: (``order_stable=False``) — their curves are still reported, but
    #: the underlying programs are approximate, not exact.
    order_unstable: Tuple[str, ...] = ()
    #: Warm-ladder telemetry: rung compiles whose previous-rung warm
    #: start survived the tightness verification / rungs where a warm
    #: start was attempted (0/0 when ``warm_ladder=False``).
    warm_hits: int = 0
    warm_attempts: int = 0
    #: The sweep's entries as compiled (config-major, then mode, then
    #: rung) and the fleet solve's flat completions over them, kept so a
    #: caller can hold two runs against each other program by program
    #: (a port addition; not part of :meth:`to_json`).
    compiled: Tuple[CompiledCluster, ...] = dataclasses.field(
        default=(), repr=False, compare=False)
    comp: Optional[np.ndarray] = dataclasses.field(
        default=None, repr=False, compare=False)

    def ranking(self) -> List[CapacityCurve]:
        """Normal-mode curves, best (most load inside SLO) first —
        offered rate on open-loop sweeps, users otherwise."""
        normal = [c for c in self.curves if not c.degraded]
        return sorted(normal, key=lambda c: -c.load_at_slo)

    def degraded_curve(self, config: ClusterConfig
                       ) -> Optional[CapacityCurve]:
        for c in self.curves:
            if c.degraded and c.config == config:
                return c
        return None

    def to_json(self) -> Dict:
        return {"slo_us": self.slo_us, "n_programs": self.n_programs,
                "n_events": self.n_events, "sweeps_used": self.sweeps_used,
                "converged": self.converged,
                "order_unstable": list(self.order_unstable),
                "warm_hits": self.warm_hits,
                "warm_attempts": self.warm_attempts,
                "curves": [c.to_json() for c in self.curves]}


def _load_at_slo(loads: Sequence[float], p99s: Sequence[float],
                 slo_us: float) -> float:
    """Largest load whose p99 stays inside the SLO, interpolating
    (log-space in latency) between the ladder rungs that straddle it.

    0.0 when even the smallest rung violates; the top rung's load when
    no rung violates (the rack wasn't driven to the SLO).
    """
    if not len(loads):
        return 0.0
    p99 = np.asarray(p99s, dtype=np.float64)
    load = np.asarray(loads, dtype=np.float64)
    over = np.nonzero(p99 > slo_us)[0]
    if len(over) == 0:
        return float(load[-1])
    i = int(over[0])
    if i == 0:
        return 0.0
    lo, hi = p99[i - 1], p99[i]
    if not (hi > lo > 0.0):
        return float(load[i - 1])
    frac = (np.log(slo_us) - np.log(lo)) / (np.log(hi) - np.log(lo))
    return float(load[i - 1] + frac * (load[i] - load[i - 1]))


def users_at_slo(points: Sequence[CapacityPoint], slo_us: float) -> float:
    """Closed-loop figure of merit: user count at the p99 SLO."""
    return _load_at_slo([float(p.users) for p in points],
                        [p.lat.p99_us for p in points], slo_us)


def rate_at_slo(points: Sequence[CapacityPoint], slo_us: float
                ) -> Optional[float]:
    """Open-loop figure of merit: offered arrival rate (objects/s) at
    the p99 SLO; ``None`` unless every point carries an offered rate."""
    if not points or any(p.offered_rate is None for p in points):
        return None
    return _load_at_slo([float(p.offered_rate) for p in points],
                        [p.lat.p99_us for p in points], slo_us)


def _can_degrade(scheme: RedundancyScheme) -> bool:
    return scheme.m >= 1


def plan_capacity(configs: Sequence[ClusterConfig],
                  users_ladder: Sequence[int], *,
                  base_spec: Optional[ClusterSpec] = None,
                  workload: Optional[ClusterWorkload] = None,
                  slo_us: float = DEFAULT_SLO_US,
                  rate_ladder: Optional[Sequence[float]] = None,
                  degraded: bool = True, down_server: int = 0,
                  sweeps: int = 512, fixpoint: str = "auto",
                  scan_backend: str = "auto",
                  max_refine: Optional[int] = None,
                  warm_ladder: bool = False,
                  device=DEFAULT_DEVICE) -> CapacityReport:
    """Compile the whole sweep, solve it as ONE fleet-level program,
    and slice the capacity curves back out.

    ``rate_ladder`` switches the sweep to open-loop offered load: each
    rung keeps the workload's user population but stamps Poisson
    arrivals at that rate (objects/s, ``qd`` raised to ``ops_per_user``
    so the closed-loop edges vanish), ``users_ladder`` is ignored, and
    curves rank by :func:`rate_at_slo` instead of :func:`users_at_slo`.

    ``warm_ladder=True`` threads each rung's completions into the next
    rung's refined solves as ``comp0`` (ops joined per ``(client,
    slot)`` key when their content digests match), seeds the FIFO
    pop-order refinement from the previous rung's orders, and — on
    rate ladders, whose rungs share their entire structure — reuses
    the previous rung's graph with the new arrival clock re-stamped
    instead of rebuilding placement and shard planning from scratch.
    Rung monotonicity is not assumed: the warm solve only sticks when
    the tightness verification proves it equal to the cold result (see
    :func:`repro_torch.cluster.compiler.compile_graph`), so the report is
    identical either way — ``warm_hits`` / ``warm_attempts`` expose
    how often the shortcut landed.  Rate ladders pay best (graph reuse
    plus order carry-over); users ladders rebuild each rung's graph
    and warm only the solves.

    Every solve, the final fleet solve included, runs on ``device``
    (``"cuda"`` by default, which raises without CUDA) with the
    ``fixpoint`` driver: ``"auto"`` is one launch of the CUDA fixpoint
    kernel a solve on the card and its plain PyTorch version on the CPU.
    """
    base_spec = base_spec if base_spec is not None else ClusterSpec()
    workload = workload if workload is not None else ClusterWorkload()
    open_loop = rate_ladder is not None
    rungs = [float(r) for r in rate_ladder] if open_loop \
        else [int(u) for u in users_ladder]
    entries: List[Tuple[ClusterConfig, bool, int, Optional[float],
                        CompiledCluster]] = []
    warm_hits = warm_attempts = 0
    for cfg in configs:
        spec = dataclasses.replace(base_spec, scheme=cfg.scheme,
                                   placement=cfg.placement)
        modes = [None] + ([down_server] if degraded
                          and _can_degrade(cfg.scheme) else [])
        for down in modes:
            prev: Optional[Tuple[object, np.ndarray, object]] = None
            # Open-loop rungs thread best top-down: a sparser Poisson
            # clock (lower rate, same seed) only stretches issue times,
            # so the *higher*-rate rung's completions are lower bounds
            # for the next rung almost everywhere.  Curve points are
            # re-sorted by load afterwards, so rung order is free.
            sweep_rungs = sorted(rungs, reverse=True) \
                if warm_ladder and open_loop else rungs
            for rung in sweep_rungs:
                if open_loop:
                    wl = dataclasses.replace(
                        workload,
                        arrival=PoissonArrivals(rate_per_s=float(rung),
                                                seed=workload.seed),
                        qd=max(workload.qd, workload.ops_per_user))
                    users, rate = workload.n_users, float(rung)
                else:
                    wl = dataclasses.replace(workload, n_users=int(rung))
                    users, rate = int(rung), None
                kw = {} if max_refine is None else {"max_refine": max_refine}
                if warm_ladder:
                    chains0 = None
                    if open_loop and prev is not None:
                        # Rate rungs share their entire structure: the
                        # op mix is drawn before the clock is stamped
                        # and placement/shard planning never read issue
                        # times.  Reuse the previous rung's graph with
                        # the new arrival clock re-stamped on the op
                        # heads instead of rebuilding it.
                        times = wl.arrival.issue_times(
                            wl.n_users * wl.ops_per_user,
                            size=wl.object_bytes)
                        issue = prev[0].issue.copy()
                        issue[prev[0].op_head] = times
                        graph = dataclasses.replace(prev[0], issue=issue)
                        # Identical slot indexing: the previous rung's
                        # replayed pop orders are a valid first iterate.
                        chains0 = prev[2]
                    else:
                        ops = wl.build(spec.n_gateways)
                        graph = build_graph(spec, ops, qd=wl.qd,
                                            down=down, seed=wl.seed,
                                            device=device)
                    comp0, seed = (None, None) if prev is None else \
                        _rung_comp0(prev[0], prev[1], graph)
                    warm_attempts += comp0 is not None
                    compiled = compile_graph(
                        graph, sweeps=sweeps, fixpoint=fixpoint,
                        scan_backend=scan_backend, comp0=comp0,
                        order_seed=seed, chains0=chains0, device=device,
                        **kw)
                    warm_hits += compiled.warm_start_used
                    prev = (graph, compiled.comp, compiled.fifo_chains)
                else:
                    compiled = Cluster(spec, device=device).compile(
                        wl, down=down, sweeps=sweeps, fixpoint=fixpoint,
                        scan_backend=scan_backend, **kw)
                entries.append((cfg, down is not None, users, rate,
                                compiled))

    # ONE fleet-level call over every config x rung x mode.  The
    # per-entry fixpoints found during compilation are exact lower
    # bounds of the concatenated program, so they seed the fleet solve
    # (comp0) and it converges in one verification sweep.
    program = concat_programs([c.program for *_, c in entries])
    svc = np.concatenate([c.graph.svc for *_, c in entries])
    comp, used, converged = solve_program(
        program, svc, sweeps=sweeps, fixpoint=fixpoint,
        scan_backend=scan_backend, warn=False,
        comp0=np.concatenate([c.comp for *_, c in entries]), device=device)

    curves: List[CapacityCurve] = []
    off = 0
    by_key: Dict[Tuple[str, bool], List[CapacityPoint]] = {}
    key_cfg: Dict[Tuple[str, bool], ClusterConfig] = {}
    for cfg, is_degraded, users, rate, compiled in entries:
        g = compiled.graph
        sl = comp[off:off + g.n]
        off += g.n
        lats = op_latencies(g, sl)
        span = float(sl.max()) if len(sl) else 0.0
        point = CapacityPoint(
            users=users,
            objects_per_sec=len(lats) / span * 1e6 if span > 0 else 0.0,
            lat=LatencyStats.from_samples(lats),
            slo_violation_rate=violation_rate(lats, slo_us),
            converged=bool(converged and compiled.converged),
            offered_rate=rate)
        key = (cfg.name, is_degraded)
        by_key.setdefault(key, []).append(point)
        key_cfg[key] = cfg
    for key, points in by_key.items():
        points = sorted(points, key=lambda p: (
            p.offered_rate if p.offered_rate is not None else p.users))
        curves.append(CapacityCurve(
            config=key_cfg[key], degraded=key[1], points=tuple(points),
            users_at_slo=users_at_slo(points, slo_us),
            rate_at_slo=rate_at_slo(points, slo_us)))
    unstable = tuple(sorted({
        cfg.name for cfg, *_, c in entries
        if not c.program.order_stable}))
    return CapacityReport(
        curves=curves, slo_us=slo_us, n_programs=len(entries),
        n_events=program.n_flat, sweeps_used=used,
        converged=bool(converged) and all(
            c.converged for *_, c in entries),
        order_unstable=unstable,
        warm_hits=int(warm_hits), warm_attempts=int(warm_attempts),
        compiled=tuple(c for *_, c in entries), comp=comp)
