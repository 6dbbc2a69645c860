"""Trace-compilation layer: ``Trace + spec + params -> ChainProgram``.

The vectorized backend decomposes a trace into serialized *chain
families* (per-thread closed-loop lag-qd chains, per-zone write chains,
the metadata engine, lag-capacity server-pool chains) and solves the
coupled system by Gauss-Seidel sweeps of segmented max-plus scans.
Before this module, that decomposition was re-derived on every call and
the sweeps ran as a Python loop of per-chain scans; worse, server-pool
chains were ordered by *issue* time, which breaks down exactly on the
paper's key workloads -- saturated multi-thread append pools (Obs#5-#7)
interleave threads in *readiness* order, so the issue-ordered FIFO
approximation serialized whole threads back to back.

A :class:`ChainProgram` is the compiled artifact:

* **event-order transform** per device (stable sort by issue time) and
  the inverse permutation back to trace order;
* **family blocks**: padded, length-bucketed ``(R, L)`` gather-index +
  segment-head tensors addressing one flat fleet-wide completion
  vector, so every Gauss-Seidel step is one vectorized gather ->
  batched max-plus scan -> scatter-max per family (no per-device Python
  loops);
* **pop-order pool chains**: server-pool families are ordered by the
  event engine's *processing* order -- ``ready = max(issue, completion
  of the request qd earlier on the same thread)``, the key the event
  heap pops by (zone/pool constraints apply after the pop, so they
  never affect the order).  The order is found by *refinement*: solve
  the fixpoint with the pool families removed (optimistic readiness),
  sort, rebuild, re-solve from below, and freeze once the order stops
  changing.  Single-service-class pools keep the vectorized FIFO
  lag-``capacity`` chains (round-robin in pop order IS the greedy
  assignment when services are homogeneous).  Pools whose saturating
  traffic mixes service classes -- and every saturated pool of a
  jitter-aware compile (``jitter=True``: refinement re-sorts against
  the *sampled* service vector) -- instead replay the event engine's
  greedy heterogeneous server assignment per pop: one free-time heap
  per pool reproduces ``argmin(free)`` exactly (server choice depends
  only on the free-time *multiset*), emitting one exact per-server
  coupling chain per slot plus pop-ordered per-zone write chains.
  Both forms reproduce the event engine to float tolerance once the
  pop order stabilizes; only budget exhaustion
  (``order_stable=False``, with the offending pools listed in
  ``unstable_pools``) leaves a documented lower-bound approximation.

Programs are cached in a module-level LRU keyed by ``(trace digest,
spec, params, refine, jitter, seeds)`` so experiment sweeps and the
host layer's ``compare_policies()`` stop re-lowering identical traces.

:func:`solve_program` runs the fused fixpoint on the selected device:
the ``"cuda"`` driver hands the whole program to the CUDA
``repro_torch.kernels.zns_fixpoint`` kernel (all sweeps x families
enqueued at once, with an on-device active set and early exit), the
``"torch"`` driver to that kernel's plain PyTorch version, both in
float64; the host ``"loop"`` driver iterates family blocks in Python
around the batched float64 scan
(:func:`repro_torch.core.engine.zone_sequential_completions_batched`).
Lowering and caching stay on the host.
"""
from __future__ import annotations

import dataclasses
import hashlib
import heapq
import os
import pickle
import tempfile
import time
import warnings
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .engine import (
    Trace, compute_service_times, trace_chain_families,
    zone_sequential_completions_batched,
)
from .fleet import length_buckets
from .latency import resolve_params
from .spec import OpType, ZNSDeviceSpec
from .torch_device import DEFAULT_DEVICE, resolve_device

#: Default pop-order refinement budget.  The greedy replay derives each
#: pool's pop order dynamically, so any budget >= 1 freezes after one
#: rebuild; ``refine=0`` disables refinement entirely (issue-ordered
#: base pool chains, a warned, documented lower bound).
DEFAULT_REFINE = 4

#: Server-pool family kinds whose chains are re-ordered by readiness
#: when refinement triggers (the event engine pops all of them from one
#: ready-time heap).
REORDERED_KINDS = ("meta", "mgmt", "io_pool", "append_pool")

#: Family kinds whose *presence* triggers refinement: the saturated
#: server pools where issue order visibly diverges from pop order.
#: meta/mgmt-only traces keep their issue-ordered chains (paced
#: management sweeps issue in pop order already).
REFINE_TRIGGER_KINDS = ("io_pool", "append_pool")


def _pool_capacity(kind: str, spec: ZNSDeviceSpec) -> int:
    if kind == "meta":
        return max(spec.reset_parallelism, 1)
    if kind == "mgmt":
        return 2
    if kind == "io_pool":
        return max(spec.read_parallelism, 1)
    if kind == "append_pool":
        return max(spec.append_parallelism, 1)
    raise KeyError(kind)


# ---------------------------------------------------------------------------
# Program representation
# ---------------------------------------------------------------------------
#: Chain buckets with at least this many chains use the transposed
#: ``"cols"`` layout (position loop, vectorized across chains); smaller
#: buckets fall back to the ``"rows"`` doubling-scan layout whose cost
#: does not scale with chain count.
POSLOOP_MIN_CHAINS = 8

#: Layout cost cutover: the position loop does O(n) work but pays a
#: per-position dispatch overhead, the doubling scan does O(n log L)
#: bandwidth-bound work.  ``cols`` wins when R * log2(L) clears this
#: (both sides divided by L): ~2.6 us dispatch / (16 B / ~5 GB/s).
POSLOOP_COST_CUTOVER = 512.0

#: Max/min chain-length ratio within one padded bucket (tighter than the
#: fleet row bucketing: padded cells cost position-loop iterations).
CHAIN_BUCKET_RATIO = 2.0


@dataclasses.dataclass(frozen=True)
class FamilyBlock:
    """One length bucket of one chain family, fleet-wide.

    One *chain* per lane.  ``layout="cols"`` stores ``(L, R)`` matrices
    — lane ``r`` is column ``r`` — solved by a position loop that is
    sequential along the chain but vectorized across all R chains (the
    exact event-engine recurrence, O(n) work, contiguous row
    operations).  ``layout="rows"`` stores ``(R, L)`` matrices solved
    by the batched doubling scan (O(n log n) but independent of R; used
    for skinny buckets where the position loop would be overhead-bound,
    and by the fixpoint kernels).

    ``gidx`` indexes the flat event-order completion vector (padding
    points at the dead slot ``n_flat``); ``heads`` marks chain starts
    (position 0 of every lane, plus all padding).
    """

    label: str            # e.g. "io_pool", "append_pool/cls0", "meta"
    gidx: np.ndarray      # int64; (R, L) for rows, (L, R) for cols
    heads: np.ndarray     # bool, same shape
    layout: str = "rows"  # "rows" | "cols"

    @property
    def shape(self) -> Tuple[int, int]:
        return self.gidx.shape

    def rows_view(self) -> Tuple[np.ndarray, np.ndarray]:
        """(gidx, heads) in rows layout regardless of storage."""
        if self.layout == "rows":
            return self.gidx, self.heads
        return np.ascontiguousarray(self.gidx.T), \
            np.ascontiguousarray(self.heads.T)

    def nbytes(self) -> int:
        return self.gidx.nbytes + self.heads.nbytes


@dataclasses.dataclass(frozen=True)
class ChainProgram:
    """A compiled multi-device trace: one fused fixpoint per fleet call.

    Solve with :func:`solve_program` after binding per-request service
    times (event order, concatenated across devices).  ``exact`` is the
    compiler's exactness claim versus the event engine for the service
    vector the program was compiled against: jitter-free services by
    default, or the seeded jittered draw when compiled with
    ``jitter=True`` (``svc_seeds`` records which).  The claim holds for
    single- AND multi-service-class pools — heterogeneous pools replay
    the event engine's greedy ``argmin(free)`` server assignment into
    per-server coupling chains — so the event engine is a test oracle,
    never a fallback.  ``exact`` is ``False`` only when pop-order
    refinement exhausted its budget before stabilizing
    (``order_stable=False``; the offending pools are listed in
    ``unstable_pools``), in which case completions remain a convergent
    lower bound.  Solving an ``exact`` program against any *other*
    service vector (e.g. a jittered draw on a jitter-free compile)
    voids the claim: the frozen pop order no longer matches the event
    heap's.
    """

    n_flat: int
    offsets: Tuple[int, ...]            # per-device starts into flat arrays
    orders: Tuple[np.ndarray, ...]      # per-device trace->event order perm
    invs: Tuple[np.ndarray, ...]        # per-device event->trace order perm
    issue_flat: np.ndarray              # (n_flat,) event-order issue times
    #: Jitter-free service times (event order, flat) — part of the
    #: lowering output, so ``jitter=False`` solves bind it directly
    #: instead of recomputing service times per call.
    svc0_flat: np.ndarray
    families: Tuple[FamilyBlock, ...]   # application order
    exact: bool
    multiclass_pools: Tuple[str, ...]   # pool kinds mixing service classes
    refine_used: int                    # refinement solves spent
    order_stable: bool                  # pop orders reached a fixpoint
    #: ``"dev{i}:{kind}"`` labels of the pools whose pop order was still
    #: changing when the refinement budget ran out (empty when
    #: ``order_stable``).
    unstable_pools: Tuple[str, ...] = ()
    #: Per-device seeds of the jittered service draw the refinement ran
    #: against, or ``None`` for a jitter-free compile.  The exactness
    #: claim is relative to exactly this service vector.
    svc_seeds: Optional[Tuple[int, ...]] = None

    @property
    def n_devices(self) -> int:
        return len(self.orders)

    def device_slice(self, d: int) -> slice:
        return slice(self.offsets[d],
                     self.offsets[d] + len(self.orders[d]))

    def nbytes(self) -> int:
        own = self.issue_flat.nbytes + sum(o.nbytes for o in self.orders) \
            + sum(i.nbytes for i in self.invs)
        return own + sum(f.nbytes() for f in self.families)

    def __repr__(self) -> str:
        return (f"ChainProgram(devices={self.n_devices}, n={self.n_flat}, "
                f"families={len(self.families)}, exact={self.exact})")


# ---------------------------------------------------------------------------
# Compile cache
# ---------------------------------------------------------------------------
_PROGRAM_CACHE: "OrderedDict[tuple, ChainProgram]" = OrderedDict()
_PROGRAM_CACHE_MAX = 8
_CACHE_STATS = {"hits": 0, "misses": 0, "disk_hits": 0}

#: Identity fast path: recent ``(traces, specs, params, refine) ->
#: program`` bindings keyed by trace object identity, so hot loops that
#: re-run the *same* trace objects (experiment sweeps, benchmarks, the
#: host layer's compare_policies) skip even the content digest.  Strong
#: refs to the traces are kept so ids cannot be recycled.
_IDENTITY_CACHE: "OrderedDict[tuple, tuple]" = OrderedDict()
_IDENTITY_CACHE_MAX = 4


def _trace_digest(trace: Trace) -> bytes:
    """Content digest of a trace, computed once per trace *object*.

    The digest is memoized on the trace itself (traces are structurally
    immutable once built), so refinement rebuilds, repeated fleet
    compiles, and the on-disk program cache all hash each trace exactly
    once instead of once per lookup.
    """
    cached = getattr(trace, "_digest_memo", None)
    if cached is not None:
        return cached
    h = hashlib.sha1()
    for f in ("op", "zone", "size", "issue", "thread", "qd", "occupancy",
              "was_finished", "io_ctx"):
        a = np.ascontiguousarray(getattr(trace, f))
        h.update(a.tobytes())
    h.update(bytes([int(trace.stack), int(trace.fmt)]))
    d = h.digest()
    try:
        trace._digest_memo = d
    except Exception:        # frozen/slotted trace subclass: skip memo
        pass
    return d


@dataclasses.dataclass(frozen=True)
class CompileStats:
    """Cost attribution of the most recent fleet compile.

    ``hits``/``misses`` count in-memory program-cache lookups (LRU +
    identity fast path) since the cache was last cleared; ``disk_hits``
    counts programs loaded from the persistent on-disk cache;
    ``lowering_ms`` is the wall-clock the last
    :func:`compile_fleet_program` call spent lowering (0.0 on any cache
    hit).  ``n_devices``/``n_unique`` expose the replica dedup: only
    ``n_unique`` of the ``n_devices`` member traces were lowered.
    """

    hits: int = 0
    misses: int = 0
    disk_hits: int = 0
    lowering_ms: float = 0.0
    n_devices: int = 0
    n_unique: int = 0

    def to_json(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


_LAST_STATS = CompileStats()

#: Persistent program cache directory (``None`` disables).  Seeded from
#: the ``REPRO_TORCH_PROGRAM_CACHE_DIR`` environment variable; override
#: with :func:`set_program_cache_dir`.  The variable and the key are
#: this package's own, so pickles of another package's programs are
#: never read.
_DISK_CACHE_DIR: Optional[str] = os.environ.get(
    "REPRO_TORCH_PROGRAM_CACHE_DIR") or None

#: Bump when the ChainProgram layout or lowering semantics change: the
#: on-disk key includes it, so stale pickles are never deserialized.
#: v2: exact multi-class/jitter-aware pool replay (``unstable_pools`` /
#: ``svc_seeds`` fields; key gained the jitter/seeds components).
_DISK_CACHE_VERSION = 3


def last_compile_stats() -> CompileStats:
    """Stats of the most recent :func:`compile_fleet_program` call."""
    return _LAST_STATS


@dataclasses.dataclass(frozen=True)
class SolveStats:
    """Telemetry of the most recent :func:`solve_program` call.

    ``active_blocks[s]`` counts the family blocks the active-set
    Gauss–Seidel driver actually gathered/scanned during sweep ``s``
    (converged blocks whose inputs did not change are dropped from the
    sweep entirely); ``residuals[s]`` is the largest completion-time
    increase any event saw during that sweep (``0.0`` on a pure
    verification sweep).  Kernel and sharded drivers report the sweep
    count and leave the per-sweep trajectories empty.
    """

    driver: str = "loop"
    sweeps: int = 0
    converged: bool = True
    n_blocks: int = 0
    active_blocks: Tuple[int, ...] = ()
    residuals: Tuple[float, ...] = ()

    def to_json(self) -> Dict[str, object]:
        return {"driver": self.driver, "sweeps": self.sweeps,
                "converged": self.converged, "n_blocks": self.n_blocks,
                "active_blocks": list(self.active_blocks),
                "residuals": list(self.residuals)}


_LAST_SOLVE_STATS = SolveStats()


def last_solve_stats() -> SolveStats:
    """Stats of the most recent :func:`solve_program` call."""
    return _LAST_SOLVE_STATS


def set_program_cache_dir(path: Optional[str]) -> Optional[str]:
    """Set (or with ``None`` disable) the persistent program cache.

    Compiled :class:`ChainProgram` artifacts are pickled under
    ``path`` keyed by (trace content digests, device specs, latency
    params, refine budget), so repeated experiment and capacity sweeps
    across *processes* skip lowering entirely.  Returns the previous
    directory.  The directory is created on first write.  Only point
    this at a directory you trust: loading uses ``pickle``.
    """
    global _DISK_CACHE_DIR
    prev = _DISK_CACHE_DIR
    _DISK_CACHE_DIR = str(path) if path else None
    return prev


def program_cache_dir() -> Optional[str]:
    return _DISK_CACHE_DIR


def _disk_cache_path(key) -> Optional[str]:
    if _DISK_CACHE_DIR is None:
        return None
    digests, specs, params, refine, skey = key
    h = hashlib.sha1()
    h.update(repr(("repro_torch", _DISK_CACHE_VERSION)).encode())
    for d in digests:
        h.update(d)
    h.update(repr(specs).encode())
    h.update(repr(params).encode())
    h.update(repr(int(refine)).encode())
    h.update(repr(skey).encode())
    return os.path.join(_DISK_CACHE_DIR, f"program-{h.hexdigest()}.pkl")


def _disk_cache_get(key) -> Optional[ChainProgram]:
    path = _disk_cache_path(key)
    if path is None:
        return None
    try:
        with open(path, "rb") as f:
            prog = pickle.load(f)
    except (OSError, pickle.PickleError, EOFError, AttributeError):
        return None
    if not isinstance(prog, ChainProgram):
        return None
    _CACHE_STATS["disk_hits"] += 1
    return prog


def _disk_cache_put(key, prog: ChainProgram) -> None:
    path = _disk_cache_path(key)
    if path is None:
        return
    try:
        os.makedirs(_DISK_CACHE_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=_DISK_CACHE_DIR, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                pickle.dump(prog, f, protocol=pickle.HIGHEST_PROTOCOL)
            os.replace(tmp, path)
        except BaseException:
            os.unlink(tmp)
            raise
    except OSError:
        pass                    # cache writes are strictly best-effort


def program_cache_info() -> Dict[str, int]:
    return dict(_CACHE_STATS, size=len(_PROGRAM_CACHE),
                maxsize=_PROGRAM_CACHE_MAX)


def clear_program_cache() -> None:
    _PROGRAM_CACHE.clear()
    _IDENTITY_CACHE.clear()
    _CACHE_STATS.update(hits=0, misses=0, disk_hits=0)


def _cache_get(key):
    prog = _PROGRAM_CACHE.get(key)
    if prog is not None:
        _PROGRAM_CACHE.move_to_end(key)
        _CACHE_STATS["hits"] += 1
    else:
        _CACHE_STATS["misses"] += 1
    return prog


def _cache_put(key, prog: ChainProgram) -> None:
    _PROGRAM_CACHE[key] = prog
    _PROGRAM_CACHE.move_to_end(key)
    while len(_PROGRAM_CACHE) > _PROGRAM_CACHE_MAX:
        _PROGRAM_CACHE.popitem(last=False)


# ---------------------------------------------------------------------------
# Lowering
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _DeviceLowering:
    """Mutable per-device scratch state during compilation."""

    n: int
    order: np.ndarray
    inv: np.ndarray
    issue: np.ndarray          # event order
    svc0: np.ndarray           # jitter-free service times, event order
    base: list                 # [(kind, perm, heads)] from trace_chain_families
    caps: dict                 # kind -> capacity for reordered kinds
    members: dict              # kind -> sorted member indices
    tperm: Optional[np.ndarray] = None
    theads: Optional[np.ndarray] = None
    reordered: Optional[list] = None    # [(label, perm, heads)] current
    needs_refine: bool = False
    multiclass: Tuple[str, ...] = ()
    #: Refinement service vector (event order): ``svc0`` by default, the
    #: seeded jittered draw under a jitter-aware compile.  Pop orders,
    #: class splits, and the greedy replay all use this vector.
    svcr: Optional[np.ndarray] = None
    thread: Optional[np.ndarray] = None   # event-order thread ids
    zone: Optional[np.ndarray] = None     # event-order zone ids
    wr: Optional[np.ndarray] = None       # event-order zoned-write mask
    #: True when any reordered pool mixes service classes under ``svcr``
    #: with more than one server — the exact greedy replay path.
    replay: bool = False
    #: Base family labels the replay re-emits in pop order (the base
    #: issue-ordered versions are dropped from the refined assembly).
    replaced: Tuple[str, ...] = ()
    #: Lag-qd same-thread predecessor per event (-1 at chain heads);
    #: the closed-loop gate the replay applies dynamically.
    pred: Optional[np.ndarray] = None


def _lower_device(trace: Trace, spec: ZNSDeviceSpec, params, *,
                  jitter: bool = False, seed: int = 0) -> _DeviceLowering:
    n = len(trace)
    if n == 0:
        e = np.zeros(0, dtype=np.int64)
        return _DeviceLowering(n=0, order=e, inv=e.copy(),
                               issue=np.zeros(0), svc0=np.zeros(0),
                               base=[], caps={}, members={})
    order = np.argsort(trace.issue, kind="stable")
    inv = np.empty(n, dtype=np.int64)
    inv[order] = np.arange(n)
    svc0 = compute_service_times(trace, params, seed=0, jitter=False)[order]
    base = trace_chain_families(
        trace.op[order], trace.zone[order].astype(np.int64),
        trace.thread[order].astype(np.int64),
        np.maximum(trace.qd[order].astype(np.int64), 1), spec,
        meta_on_io_path=bool(params.reset_on_io_path))
    dev = _DeviceLowering(n=n, order=order, inv=inv,
                          issue=trace.issue[order], svc0=svc0, base=base,
                          caps={}, members={})
    dev.thread = trace.thread[order].astype(np.int64)
    dev.zone = trace.zone[order].astype(np.int64)
    dev.wr = (trace.op[order] == OpType.WRITE) & (dev.zone >= 0)
    dev.svcr = compute_service_times(
        trace, params, seed=seed, jitter=True)[order] if jitter else svc0
    for kind, perm, heads in base:
        if kind == "thread":
            dev.tperm, dev.theads = perm, heads
        if kind in REORDERED_KINDS:
            dev.members[kind] = np.sort(perm)
            dev.caps[kind] = _pool_capacity(kind, spec)
    dev.needs_refine = any(kind in dev.members
                           for kind in REFINE_TRIGGER_KINDS)
    if dev.needs_refine:
        dev.multiclass = tuple(
            kind for kind in REORDERED_KINDS if kind in dev.members
            and dev.caps[kind] > 1
            and len(np.unique(dev.svc0[dev.members[kind]])) > 1)
        # every refined pool goes through the exact greedy replay: even
        # homogeneous pools need it, because the alternative (round-robin
        # chains re-sorted against the previous solve) can limit-cycle
        # and silently diverge from the event engine's greedy assignment
        dev.replay = True
        if bool(dev.wr.any()):
            dev.replaced = ("zone_write",)
        dev.pred = np.full(n, -1, dtype=np.int64)
        tail = ~dev.theads[1:]
        dev.pred[dev.tperm[1:][tail]] = dev.tperm[:-1][tail]
    return dev


def _chain_family(chain_lists) -> Tuple[np.ndarray, np.ndarray]:
    """Concatenate chains into one ``(perm, heads)`` family."""
    chs = [c for c in chain_lists if c]
    perm = np.asarray([e for c in chs for e in c], dtype=np.int64)
    heads = np.zeros(len(perm), dtype=bool)
    pos = 0
    for c in chs:
        heads[pos] = True
        pos += len(c)
    return perm, heads


def _replay_pools(dev: _DeviceLowering) -> list:
    """Exact greedy pool replay for every refined pool.

    Walks the event-heap pop order once, keeping one ``(free, slot)``
    heap per server pool, exactly as the event engine keeps free-time
    arrays: each pop starts at ``max(closed-loop thread gate, zone
    gate, min(free) of every touched pool)`` — appends touch the flash
    *and* append pools jointly — and pushes its end back.  Greedy
    ``argmin(free)`` depends only on the free-time *multiset*, so the
    replay reproduces the event engine's begins exactly, event by
    event; the per-slot event sequences become one coupling chain per
    server.  Per-zone write chains are re-emitted in pop order too
    (``dev.replaced`` drops the issue-ordered base family), since the
    zone gate binds in pop order.

    The pop order is derived *dynamically* along the walk, exactly as
    the event heap builds it: each thread keeps one in-flight request
    (the next is pushed with ``ready = max(issue, end of the lag-qd
    predecessor — already popped)`` only after its predecessor pops),
    and the walk always pops the smallest ``(ready, issue, index)``
    key.  The rebuild is therefore deterministic — independent of any
    solve-side readiness estimate — so refinement freezes after one
    round trip instead of iterating order -> solve -> order to a
    fixed point, which can limit-cycle even for homogeneous pools
    (and wander for tens of round trips on heterogeneous ones).
    """
    kinds = [k for k in REORDERED_KINDS if k in dev.members]
    in_kind = {}
    for k in kinds:
        m = np.zeros(dev.n, dtype=bool)
        m[dev.members[k]] = True
        in_kind[k] = m
    heaps = {k: [(0.0, j) for j in range(dev.caps[k])] for k in kinds}
    chains: Dict[str, list] = {k: [[] for _ in range(dev.caps[k])]
                               for k in kinds}
    zchains: Dict[int, list] = {}
    zready: Dict[int, float] = {}
    end = [0.0] * dev.n
    issue_l = dev.issue.tolist()
    svc_l = dev.svcr.tolist()
    wr_l = dev.wr.tolist()
    zone_l = dev.zone.tolist()
    pred_l = dev.pred.tolist()
    kind_l = {k: in_kind[k].tolist() for k in kinds}
    # per-thread event queues in event order (the push discipline)
    by_t = np.argsort(dev.thread, kind="stable")
    tsort = dev.thread[by_t]
    starts = np.flatnonzero(np.r_[True, tsort[1:] != tsort[:-1]])
    queues = [q.tolist() for q in np.split(by_t, starts[1:])]
    ptr = [0] * len(queues)
    heap: list = []
    for t, q in enumerate(queues):
        e = q[0]
        heapq.heappush(heap, (issue_l[e], issue_l[e], e, t))
    while heap:
        r, _, e, t = heapq.heappop(heap)
        begin = r
        if wr_l[e]:
            begin = max(begin, zready.get(zone_l[e], 0.0))
        touched = [k for k in kinds if kind_l[k][e]]
        for k in touched:
            begin = max(begin, heaps[k][0][0])
        end[e] = begin + svc_l[e]
        for k in touched:
            _, j = heaps[k][0]
            heapq.heapreplace(heaps[k], (end[e], j))
            chains[k][j].append(e)
        if wr_l[e]:
            zready[zone_l[e]] = end[e]
            zchains.setdefault(zone_l[e], []).append(e)
        ptr[t] += 1
        if ptr[t] < len(queues[t]):
            x = queues[t][ptr[t]]
            p = pred_l[x]
            rx = issue_l[x] if p < 0 else max(issue_l[x], end[p])
            heapq.heappush(heap, (rx, issue_l[x], x, t))
    out = [(k, *_chain_family(chains[k])) for k in kinds]
    if dev.replaced:
        out.append(("zone_write",
                    *_chain_family([zchains[z] for z in sorted(zchains)])))
    return out


def _reorder_pools(dev: _DeviceLowering) -> list:
    """Rebuild every reordered family by exact greedy replay
    (:func:`_replay_pools`)."""
    return _replay_pools(dev)


def _family_lists(devs: Sequence[_DeviceLowering], *, include_reordered: bool
                  ) -> List[list]:
    """Per-device ``[(label, perm, heads)]`` for assembly.  Devices that
    never needed refinement keep their base families verbatim (bitwise
    compatibility with the pre-compiler engine)."""
    out = []
    for dev in devs:
        fams = []
        for kind, perm, heads in dev.base:
            if dev.needs_refine and kind in REORDERED_KINDS:
                continue        # replaced by the reordered versions
            if include_reordered and dev.needs_refine and dev.reordered \
                    and kind in dev.replaced:
                continue        # re-emitted in pop order by the replay
            fams.append((kind, perm, heads))
        if include_reordered and dev.needs_refine and dev.reordered:
            fams.extend(dev.reordered)
        out.append(fams)
    return out


def _label_rank(label: str) -> Tuple[int, str]:
    from .engine import FAMILY_ORDER
    base = label.split("/", 1)[0]
    try:
        return FAMILY_ORDER.index(base), label
    except ValueError:
        return len(FAMILY_ORDER), label


def _blocks_from_segments(segments: "OrderedDict[str, tuple]", n_flat: int
                          ) -> Tuple[FamilyBlock, ...]:
    """Vectorized block fill from segment form.

    ``segments`` maps label -> ``(vals, lens)`` where ``vals`` is the
    concatenation of every chain of the family (chain order preserved)
    and ``lens`` the per-chain lengths.  Each bucket is laid out with
    one fancy-index scatter instead of a per-chain Python loop — the
    hot path that dominated fleet lowering at >=64 devices.
    """
    blocks = []
    for label in sorted(segments, key=_label_rank):
        vals, lens = segments[label]
        if len(lens) == 0:
            continue
        starts = np.zeros(len(lens), dtype=np.int64)
        np.cumsum(lens[:-1], out=starts[1:])
        for bucket in length_buckets(lens.tolist(),
                                     ratio=CHAIN_BUCKET_RATIO):
            sel = np.asarray(bucket, dtype=np.int64)
            sl = lens[sel]
            R = len(sel)
            L = int(sl.max())
            tot = int(sl.sum())
            # lane/position coordinates of every real event in the
            # padded (R, L) bucket, then one gather + one scatter
            lane = np.repeat(np.arange(R, dtype=np.int64), sl)
            lane_start = np.zeros(R, dtype=np.int64)
            np.cumsum(sl[:-1], out=lane_start[1:])
            pos = np.arange(tot, dtype=np.int64) - np.repeat(lane_start, sl)
            cvals = vals[np.repeat(starts[sel], sl) + pos]
            if R >= POSLOOP_MIN_CHAINS and \
                    R * np.log2(max(L, 2)) >= POSLOOP_COST_CUTOVER:
                gidx = np.full((L, R), n_flat, dtype=np.int64)
                heads = np.ones((L, R), dtype=bool)
                gidx[pos, lane] = cvals
                heads[pos, lane] = pos == 0
                blocks.append(FamilyBlock(label=label, gidx=gidx,
                                          heads=heads, layout="cols"))
            else:
                gidx = np.full((R, L), n_flat, dtype=np.int64)
                heads = np.ones((R, L), dtype=bool)
                gidx[lane, pos] = cvals
                heads[lane, pos] = pos == 0
                blocks.append(FamilyBlock(label=label, gidx=gidx,
                                          heads=heads, layout="rows"))
    return tuple(blocks)


def _segments_from_chains(chains: "OrderedDict[str, list]"
                          ) -> "OrderedDict[str, tuple]":
    segments: "OrderedDict[str, tuple]" = OrderedDict()
    for label, chs in chains.items():
        vals = np.concatenate(chs) if chs else np.zeros(0, dtype=np.int64)
        lens = np.asarray([len(c) for c in chs], dtype=np.int64)
        segments[label] = (vals, lens)
    return segments


def _blocks_from_chains(chains: "OrderedDict[str, list]", n_flat: int
                        ) -> Tuple[FamilyBlock, ...]:
    """Length-bucket + lay out ``{label: [chain index arrays]}`` into
    padded :class:`FamilyBlock` tensors addressing a flat vector of
    ``n_flat`` events (padding points at the dead slot ``n_flat``).
    Labels are emitted in :data:`repro_torch.core.engine.FAMILY_ORDER`-first
    rank (unknown labels sort after, alphabetically) — the Gauss-Seidel
    application order."""
    return _blocks_from_segments(_segments_from_chains(chains), n_flat)


def _assemble(devs: Sequence[_DeviceLowering], fam_lists: Sequence[list], *,
              exact: bool, refine_used: int, order_stable: bool,
              unstable_pools: Tuple[str, ...] = (),
              svc_seeds: Optional[Tuple[int, ...]] = None) -> ChainProgram:
    offsets, off = [], 0
    for dev in devs:
        offsets.append(off)
        off += dev.n
    n_flat = off
    issue_flat = np.concatenate([dev.issue for dev in devs]) if devs else \
        np.zeros(0)
    svc0_flat = np.concatenate([dev.svc0 for dev in devs]) if devs else \
        np.zeros(0)
    # split every (device, family) into its chains; chains are the
    # batching unit: bucketed by length across devices so one block
    # solves all similar-length chains of a family fleet-wide
    # segment form: a family's ``perm`` already IS its chains
    # concatenated in order, so one offset-shift per (device,
    # family) replaces a per-chain ``np.split`` loop.  Chain
    # lengths are memoized per heads array — replicated devices
    # share ``_DeviceLowering`` objects, so lengths compute once
    # per *unique* device.
    segs: "OrderedDict[str, list]" = OrderedDict()
    lens_memo: Dict[int, np.ndarray] = {}
    for d, fams in enumerate(fam_lists):
        for label, perm, heads in fams:
            if len(perm) == 0:
                continue
            lens = lens_memo.get(id(heads))
            if lens is None:
                cuts = np.flatnonzero(heads)
                lens = np.diff(np.r_[0, cuts[1:], len(perm)])
                lens_memo[id(heads)] = lens
            segs.setdefault(label, ([], []))
            segs[label][0].append(offsets[d] + perm)
            segs[label][1].append(lens)
    segments: "OrderedDict[str, tuple]" = OrderedDict(
        (label, (np.concatenate(vs), np.concatenate(ls)))
        for label, (vs, ls) in segs.items())
    blocks = _blocks_from_segments(segments, n_flat)
    multiclass = tuple(sorted({k for dev in devs for k in dev.multiclass}))
    return ChainProgram(
        n_flat=n_flat, offsets=tuple(offsets),
        orders=tuple(dev.order for dev in devs),
        invs=tuple(dev.inv for dev in devs),
        issue_flat=issue_flat, svc0_flat=svc0_flat,
        families=tuple(blocks), exact=exact,
        multiclass_pools=multiclass, refine_used=refine_used,
        order_stable=order_stable, unstable_pools=tuple(unstable_pools),
        svc_seeds=svc_seeds)


def compile_fleet_program(traces: Sequence[Trace],
                          specs: Sequence[ZNSDeviceSpec],
                          lats: Sequence, *,
                          refine: int = DEFAULT_REFINE,
                          cache: bool = True,
                          dedup: bool = True,
                          jitter: bool = False,
                          seeds: Optional[Sequence[int]] = None
                          ) -> ChainProgram:
    """Lower N devices' traces into one fused :class:`ChainProgram`.

    ``lats[i]`` may be a :class:`repro_torch.core.LatencyModel` or a bare
    :class:`repro_torch.core.LatencyParams` pytree.  Compilation is
    deterministic in ``(traces, specs, params, refine, jitter, seeds)``
    and cached in a module-level LRU on exactly that key (plus a
    persistent on-disk cache when :func:`set_program_cache_dir` or
    ``REPRO_TORCH_PROGRAM_CACHE_DIR`` points somewhere).

    Pop-order refinement sorts and replays against jitter-free service
    times by default.  With ``jitter=True`` it uses the *sampled*
    service vector of ``compute_service_times(trace, params,
    seed=seeds[i], jitter=True)`` instead — the pop order, class
    splits, and greedy pool replay then match the jittered run the
    caller is about to solve, which is what makes jittered saturated
    pools exact (``svc_seeds`` records the binding; ``seeds`` defaults
    to ``0`` per device, matching ``simulate``'s default).

    With ``dedup`` (default), devices with identical (trace content,
    spec, params) — and, under ``jitter``, the same seed — lower and
    refine once and share the result: the fleet solve is block-diagonal
    per device, so replicas follow identical refinement trajectories.
    Mega-fleets replicating one workload over thousands of devices
    lower in O(unique) time.
    """
    global _LAST_STATS
    t0 = time.perf_counter()
    B = len(traces)
    if not (len(specs) == len(lats) == B):
        raise ValueError(f"fleet shape mismatch: {B} traces, {len(specs)} "
                         f"specs, {len(lats)} latency models")
    params = [resolve_params(l) for l in lats]
    jitter = bool(jitter)
    if seeds is None:
        seeds = [0] * B
    else:
        seeds = [int(s) for s in seeds]
        if len(seeds) != B:
            raise ValueError(f"fleet shape mismatch: {B} traces, "
                             f"{len(seeds)} seeds")
    skey = tuple(seeds) if jitter else None
    key = None
    digests: Optional[list] = None
    if cache:
        ikey = (tuple(id(t) for t in traces), tuple(specs), tuple(params),
                int(refine), skey)
        ihit = _IDENTITY_CACHE.get(ikey)
        if ihit is not None and all(a is b for a, b in
                                    zip(ihit[0], traces)):
            _IDENTITY_CACHE.move_to_end(ikey)
            _CACHE_STATS["hits"] += 1
            _LAST_STATS = CompileStats(hits=1, n_devices=B)
            return ihit[1]
        # replicated workloads pass the same trace object many times;
        # digest each object once (and memoize on the trace itself)
        digests = [_trace_digest(t) for t in traces]
        key = (tuple(digests), tuple(specs), tuple(params), int(refine),
               skey)
        hit = _cache_get(key)
        disk = 0
        if hit is None:
            hit = _disk_cache_get(key)
            if hit is not None:
                disk = 1
                _cache_put(key, hit)
        if hit is not None:
            _IDENTITY_CACHE[ikey] = (tuple(traces), hit)
            while len(_IDENTITY_CACHE) > _IDENTITY_CACHE_MAX:
                _IDENTITY_CACHE.popitem(last=False)
            _LAST_STATS = CompileStats(
                hits=1 - disk, misses=disk, disk_hits=disk, n_devices=B,
                lowering_ms=(time.perf_counter() - t0) * 1e3)
            return hit

    # --- replica dedup: lower + refine only the unique devices -------
    if dedup and B > 1:
        if digests is None:
            digests = [_trace_digest(t) for t in traces]
        slot: Dict[tuple, int] = {}
        urep: List[int] = []            # unique slot -> first device idx
        rep: List[int] = []             # device idx -> unique slot
        for b in range(B):
            k = (digests[b], specs[b], params[b],
                 seeds[b] if jitter else 0)
            s = slot.get(k)
            if s is None:
                s = slot[k] = len(urep)
                urep.append(b)
            rep.append(s)
    else:
        urep = list(range(B))
        rep = list(range(B))
    udevs = [_lower_device(traces[b], specs[b], params[b],
                           jitter=jitter, seed=seeds[b]) for b in urep]
    refine_used = 0
    order_stable = True
    unstable: List[str] = []
    if refine <= 0:
        # no refinement budget: keep the issue-ordered base pool chains.
        # This is the budget-exhaustion path — warn with the affected
        # pool labels and record them on the program so RunResult /
        # FleetRunResult diagnostics can surface which pools degraded.
        unstable = sorted({f"dev{urep[d]}:{kind}"
                           for d, dev in enumerate(udevs)
                           if dev.needs_refine for kind in dev.members})
        for dev in udevs:
            dev.needs_refine = False
        if unstable:
            order_stable = False
            warnings.warn(
                f"pop-order refinement disabled (refine={int(refine)}) "
                f"with server pools present; pool chains keep their "
                f"issue-ordered bootstrap approximation; affected "
                f"pools: {', '.join(unstable)}. Completions stay a "
                f"convergent lower bound (exact=False); raise refine= "
                f"to tighten.", RuntimeWarning, stacklevel=2)
    elif any(dev.needs_refine for dev in udevs):

        def _rebuild() -> List[str]:
            """Re-derive every refined pool's chains by greedy replay;
            returns the ``dev{i}:{label}`` names of families that
            changed since the previous rebuild."""
            changed: List[str] = []
            for d, dev in enumerate(udevs):
                if not dev.needs_refine:
                    continue
                new = _reorder_pools(dev)
                old = dev.reordered
                if old is None or len(new) != len(old):
                    changed.extend(f"dev{urep[d]}:{lab}"
                                   for lab, _, _ in new)
                else:
                    changed.extend(
                        f"dev{urep[d]}:{a[0]}" for a, b in zip(new, old)
                        if not np.array_equal(a[1], b[1]))
                dev.reordered = new
            return changed

        # the greedy replay derives each pop order dynamically under the
        # refinement service vector, so a single rebuild freezes; the
        # second rebuild is the stability certificate (it must reproduce
        # the frozen chains — the replay is deterministic)
        _rebuild()
        refine_used = 1
        unstable = sorted(set(_rebuild()))
        order_stable = not unstable
        if not order_stable:
            warnings.warn(
                f"pop-order refinement did not freeze "
                f"(refine={int(refine)}): the greedy replay failed to "
                f"reproduce its own chains; unstable pools: "
                f"{', '.join(unstable)}. Completions stay a convergent "
                f"lower bound (exact=False).",
                RuntimeWarning, stacklevel=2)
    exact = order_stable
    devs = [udevs[s] for s in rep]
    prog = _assemble(devs, _family_lists(devs, include_reordered=True),
                     exact=exact, refine_used=refine_used,
                     order_stable=order_stable,
                     unstable_pools=tuple(unstable), svc_seeds=skey)
    if cache and key is not None:
        _cache_put(key, prog)
        _disk_cache_put(key, prog)
        _IDENTITY_CACHE[ikey] = (tuple(traces), prog)
        while len(_IDENTITY_CACHE) > _IDENTITY_CACHE_MAX:
            _IDENTITY_CACHE.popitem(last=False)
    _LAST_STATS = CompileStats(
        misses=1, n_devices=B, n_unique=len(urep),
        lowering_ms=(time.perf_counter() - t0) * 1e3)
    return prog


def compile_program(trace: Trace, spec: ZNSDeviceSpec, lat, *,
                    refine: int = DEFAULT_REFINE,
                    cache: bool = True, jitter: bool = False,
                    seed: int = 0) -> ChainProgram:
    """Single-device convenience wrapper of :func:`compile_fleet_program`.

    ``jitter=True`` refines against the jittered service draw of
    ``seed`` (see :func:`compile_fleet_program`), making the matching
    jittered solve exact.

    Example (a saturated two-thread append pool — exact on the fast
    backend because its pop order stabilizes during refinement)::

        >>> from repro_torch.core import (KiB, WorkloadSpec, ZnsDevice,
        ...                         compile_program, solve_program)
        >>> dev = ZnsDevice(device="cpu")
        >>> wl = (WorkloadSpec()
        ...       .appends(n=64, size=8 * KiB, qd=4, zone=0, nzones=4)
        ...       .appends(n=64, size=8 * KiB, qd=4, zone=4, nzones=4))
        >>> prog = compile_program(wl.build(), dev.spec, dev.lat)
        >>> prog.n_flat, prog.n_devices, prog.exact
        (128, 1, True)
        >>> comp, sweeps_used, converged = solve_program(
        ...     prog, prog.svc0_flat, device="cpu")
        >>> converged and sweeps_used >= 1
        True
    """
    return compile_fleet_program([trace], [spec], [lat], refine=refine,
                                 cache=cache, jitter=jitter, seeds=[seed])


# ---------------------------------------------------------------------------
# Generic program construction: custom chain families + concatenation
# ---------------------------------------------------------------------------
def _validate_family_chains(families, n_flat: int) -> None:
    for label, chs in families:
        seen = np.concatenate([np.asarray(c) for c in chs]) if chs else \
            np.zeros(0, dtype=np.int64)
        if len(seen) and (seen.min() < 0 or seen.max() >= n_flat):
            raise ValueError(
                f"family {label!r}: chain index out of range for "
                f"{n_flat} events")
        if len(np.unique(seen)) != len(seen):
            raise ValueError(
                f"family {label!r}: an event appears in more than one "
                f"chain of the same family (scatter would be ambiguous); "
                f"split the family into sub-labels")


def build_program(issue, svc0, families: Sequence[Tuple[str, Sequence]], *,
                  exact: bool = True,
                  multiclass_pools: Sequence[str] = (),
                  refine_used: int = 0,
                  order_stable: bool = True,
                  unstable_pools: Sequence[str] = ()) -> ChainProgram:
    """Build a :class:`ChainProgram` from explicit chain families.

    The device compiler (:func:`compile_fleet_program`) derives its
    families from a :class:`Trace`; higher tiers — the cluster layer's
    network/NIC/CPU hops — construct theirs directly.  ``issue`` and
    ``svc0`` are flat per-event arrays (the program's event order *is*
    the given order); ``families`` is ``[(label, [chain, ...]), ...]``
    where each chain is an index array into the event vector and the
    chain semantics are the max-plus recurrence
    ``c_i >= c_{i-1} + svc_i`` (c initialized to ``issue + svc``).  An
    event may appear in many families but at most once per family
    (scatter-uniqueness); violations raise ``ValueError``.

    The result is a single-pseudo-device program: ``solve_program``
    accepts it unchanged, and :func:`concat_programs` stacks it with
    other programs (device-compiled or custom) into one fused fixpoint.
    """
    issue = np.ascontiguousarray(issue, dtype=np.float64)
    svc0 = np.ascontiguousarray(svc0, dtype=np.float64)
    if len(issue) != len(svc0):
        raise ValueError(f"issue/svc0 length mismatch: "
                         f"{len(issue)} vs {len(svc0)}")
    n = len(issue)
    fams = [(label, [np.ascontiguousarray(c, dtype=np.int64) for c in chs
                     if len(c)]) for label, chs in families]
    fams = [(label, chs) for label, chs in fams if chs]
    _validate_family_chains(fams, n)
    chains: "OrderedDict[str, list]" = OrderedDict()
    for label, chs in fams:
        chains.setdefault(label, []).extend(chs)
    order = np.arange(n, dtype=np.int64)
    return ChainProgram(
        n_flat=n, offsets=(0,), orders=(order,), invs=(order.copy(),),
        issue_flat=issue, svc0_flat=svc0,
        families=_blocks_from_chains(chains, n),
        exact=bool(exact), multiclass_pools=tuple(multiclass_pools),
        refine_used=int(refine_used), order_stable=bool(order_stable),
        unstable_pools=tuple(unstable_pools))


def program_chains(program: ChainProgram) -> "OrderedDict[str, list]":
    """Recover ``{label: [chain index arrays]}`` from a program's padded
    family blocks (each block lane is one chain; padding stripped).
    Inverse of the block assembly up to length bucketing."""
    chains: "OrderedDict[str, list]" = OrderedDict()
    for blk in program.families:
        gidx, _ = blk.rows_view()
        for lane in gidx:
            c = lane[lane != program.n_flat]
            if len(c):
                chains.setdefault(blk.label, []).append(c)
    return chains


def concat_programs(programs: Sequence[ChainProgram]) -> ChainProgram:
    """Concatenate compiled programs into ONE fused fixpoint.

    Event vectors stack (each input program's flat indices shift by its
    offset), same-label families merge into shared length-bucketed
    blocks, and per-device unpacking metadata concatenates — so N
    independently compiled programs (one per cluster config, say) solve
    as a single :func:`solve_program` call with block-diagonal coupling
    (no cross-program constraints are added).  ``device_slice(i)``
    indexes devices in input order: a 3-device program followed by a
    1-device program yields devices 0-2 and 3.
    """
    programs = list(programs)
    if not programs:
        raise ValueError("concat_programs needs at least one program")
    if len(programs) == 1:
        return programs[0]
    chains: "OrderedDict[str, list]" = OrderedDict()
    offsets: List[int] = []
    orders: List[np.ndarray] = []
    invs: List[np.ndarray] = []
    off = 0
    for p in programs:
        for label, chs in program_chains(p).items():
            chains.setdefault(label, []).extend(
                [c + off for c in chs] if off else chs)
        offsets.extend(o + off for o in p.offsets)
        orders.extend(p.orders)
        invs.extend(p.invs)
        off += p.n_flat
    return ChainProgram(
        n_flat=off, offsets=tuple(offsets), orders=tuple(orders),
        invs=tuple(invs),
        issue_flat=np.concatenate([p.issue_flat for p in programs]),
        svc0_flat=np.concatenate([p.svc0_flat for p in programs]),
        families=_blocks_from_chains(chains, off),
        exact=all(p.exact for p in programs),
        multiclass_pools=tuple(sorted({k for p in programs
                                       for k in p.multiclass_pools})),
        refine_used=max(p.refine_used for p in programs),
        order_stable=all(p.order_stable for p in programs),
        unstable_pools=tuple(sorted({k for p in programs
                                     for k in p.unstable_pools})),
        svc_seeds=None if all(p.svc_seeds is None for p in programs)
        else tuple(s for p in programs
                   for s in (p.svc_seeds if p.svc_seeds is not None
                             else (None,) * p.n_devices)))


def extend_program(program: ChainProgram,
                   families: Sequence[Tuple[str, Sequence]],
                   *, exact: Optional[bool] = None,
                   multiclass_pools: Optional[Sequence[str]] = None
                   ) -> ChainProgram:
    """Return a program with extra chain families merged in.

    ``families`` uses *global* flat-event indices, so cross-cutting
    constraints may span events of different devices (the cluster
    compiler links network stages to device I/O this way).  Existing
    families are preserved; a label collision merges chain lists (the
    combined family must still satisfy scatter-uniqueness).  ``exact``
    defaults to the input program's flag.
    """
    fams = [(label, [np.ascontiguousarray(c, dtype=np.int64) for c in chs
                     if len(c)]) for label, chs in families]
    fams = [(label, chs) for label, chs in fams if chs]
    _validate_family_chains(fams, program.n_flat)
    chains = program_chains(program)
    for label, chs in fams:
        merged = chains.setdefault(label, [])
        merged.extend(chs)
        flat = np.concatenate(merged)
        if len(np.unique(flat)) != len(flat):
            raise ValueError(
                f"extend_program: family {label!r} would contain a "
                f"duplicate event after merging; use a fresh label")
    return dataclasses.replace(
        program, families=_blocks_from_chains(chains, program.n_flat),
        exact=program.exact if exact is None else bool(exact),
        multiclass_pools=program.multiclass_pools
        if multiclass_pools is None else tuple(multiclass_pools))


def force_layout(program: ChainProgram, layout: str) -> ChainProgram:
    """Return the program with every family block stored in ``layout``.

    ``"cols"`` (position loop) and ``"rows"`` (doubling scan) solve the
    same chains with different arithmetic schedules; the compiler picks
    per bucket by a cost model.  The exactness matrix and the layout
    equivalence tests pin one layout for a whole solve.  The index
    tensors are transposed copies — chain contents are unchanged.
    """
    if layout not in ("rows", "cols"):
        raise ValueError(f"unknown layout {layout!r}; expected rows | cols")
    blocks = []
    for blk in program.families:
        if blk.layout == layout:
            blocks.append(blk)
        elif layout == "rows":
            g, h = blk.rows_view()
            blocks.append(FamilyBlock(label=blk.label, gidx=g, heads=h,
                                      layout="rows"))
        else:
            blocks.append(FamilyBlock(
                label=blk.label, gidx=np.ascontiguousarray(blk.gidx.T),
                heads=np.ascontiguousarray(blk.heads.T), layout="cols"))
    return dataclasses.replace(program, families=tuple(blocks))


# ---------------------------------------------------------------------------
# Fused fixpoint solve
# ---------------------------------------------------------------------------
def _posloop_scan(cur: np.ndarray, svc: np.ndarray) -> np.ndarray:
    """Exact chain recurrence, sequential over positions (rows of the
    (L, R) matrices), vectorized across the R chains:
    ``c_j = max(c_{j-1} + svc_j, cur_j)`` — identical arithmetic to the
    event engine's per-chain loop, O(n) work."""
    out = np.empty_like(cur)
    out[0] = cur[0]
    prev = out[0]
    for j in range(1, cur.shape[0]):
        o = out[j]
        np.add(prev, svc[j], out=o)
        np.maximum(o, cur[j], out=o)
        prev = o
    return out


def block_adjacency(program: ChainProgram) -> np.ndarray:
    """Symmetric ``(F, F)`` bool matrix: ``adj[i, j]`` iff family blocks
    ``i`` and ``j`` gather overlapping flat-event slots (dead/padding
    slot excluded), i.e. a scatter by one can change the other's inputs.

    This is the dependency structure the active-set sweep driver uses to
    decide which converged blocks a moving block re-activates.  The
    diagonal is False: a block is at its own fixpoint immediately after
    its scan, so it never re-activates itself.  Memoized on the program
    (frozen but not slotted, same trick as the trace digest memo).
    """
    cached = getattr(program, "_adjacency_memo", None)
    if cached is not None:
        return cached
    nf = len(program.families)
    adj = np.zeros((nf, nf), dtype=bool)
    if nf > 1:
        dead = program.n_flat
        parts, owners = [], []
        for f, blk in enumerate(program.families):
            flat = blk.gidx.ravel()
            flat = flat[flat != dead]
            parts.append(flat)
            owners.append(np.full(len(flat), f, dtype=np.int32))
        idx = np.concatenate(parts)
        own = np.concatenate(owners)
        order = np.argsort(idx, kind="stable")
        idx, own = idx[order], own[order]
        # Runs of equal index mark every pair of owning blocks adjacent.
        # An index appears at most once per block, so run length <= F and
        # comparing each shift k < F covers all within-run pairs.
        for k in range(1, nf):
            same = idx[k:] == idx[:-k]
            if not same.any():
                break
            a, b = own[k:][same], own[:-k][same]
            adj[a, b] = True
            adj[b, a] = True
        np.fill_diagonal(adj, False)
    try:
        object.__setattr__(program, "_adjacency_memo", adj)
    except Exception:        # pragma: no cover - slotted subclass
        pass
    return adj


def _solve_numpy(program: ChainProgram, svc_flat: np.ndarray, *,
                 sweeps: int, scan_backend: str,
                 comp0: Optional[np.ndarray] = None,
                 device=DEFAULT_DEVICE
                 ) -> Tuple[np.ndarray, int, bool]:
    comp = np.append(program.issue_flat + svc_flat, -np.inf)
    warm = comp0 is not None
    if warm:
        comp[:-1] = np.maximum(comp[:-1], comp0)
    svc_ext = np.append(svc_flat, 0.0)
    svc_mats = [svc_ext[blk.gidx] for blk in program.families]
    used, converged = 0, True
    budget = max(int(sweeps), 1)
    nf = len(program.families)
    adj = block_adjacency(program)
    # Active-set sweeps: a block is processed only while "dirty" — its
    # gather slots may have changed since its last fixpoint check.  A
    # moving block re-dirties its neighbours (shared flat slots): those
    # later in the sweep order immediately (Gauss–Seidel sees the update
    # this sweep, exactly as the full loop would), earlier ones for the
    # next sweep.  Skipping a clean block is bit-identical to checking
    # it: its inputs did not change, so the edge check would find no
    # violated lanes and fall through.
    dirty_now = np.ones(nf, dtype=bool)
    dirty_next = np.zeros(nf, dtype=bool)
    active_counts: List[int] = []
    residuals: List[float] = []
    for s in range(budget):
        if not dirty_now.any():
            # Nothing can have moved since every block's last check:
            # this sweep is the full loop's no-op verification sweep.
            used, converged = s + 1, True
            active_counts.append(0)
            residuals.append(0.0)
            break
        moved = False
        n_active = 0
        residual = 0.0
        dirty_next[:] = False
        for f, (blk, svc_m) in enumerate(zip(program.families, svc_mats)):
            if not dirty_now[f]:
                continue
            n_active += 1
            cur = comp[blk.gidx]
            cols = blk.layout == "cols"
            if s == 0 and not warm:
                # first sweep: everything is a fresh lower bound — scan
                # all lanes, skip the fixpoint pre-check.  With more
                # budget, assume movement (the next sweep's O(L) checks
                # settle it cheaply); on a one-sweep budget, movement
                # must be measured or an already-converged trace would
                # be misreported as truncated.
                lanes = None
                moved = moved or budget > 1
                full = True
            else:
                # A chain is at its fixpoint iff every intra-chain edge
                # satisfies c_i >= c_{i-1} + svc_i (heads/padding
                # excluded) — an O(L) check, ~log(run) cheaper than the
                # scan it guards.  Only violated chains are re-solved;
                # convergence sweeps (and chains untouched by other
                # families' updates) cost one shifted compare instead
                # of a scan.
                if cols:
                    viol = (cur[1:] * (1.0 + 1e-12) + 1e-9
                            < cur[:-1] + svc_m[1:]) & ~blk.heads[1:]
                    lanes = viol.any(axis=0)
                else:
                    viol = (cur[:, 1:] * (1.0 + 1e-12) + 1e-9
                            < cur[:, :-1] + svc_m[:, 1:]) \
                        & ~blk.heads[:, 1:]
                    lanes = viol.any(axis=1)
                if not lanes.any():
                    continue
                moved = True
                full = bool(lanes.all())
            if cols:
                cur_s = cur if full else np.ascontiguousarray(cur[:, lanes])
                svc_s = svc_m if full else \
                    np.ascontiguousarray(svc_m[:, lanes])
                upd = _posloop_scan(cur_s, svc_s)
                gidx_s = blk.gidx if full else blk.gidx[:, lanes]
            else:
                cur_s = cur if full else cur[lanes]
                svc_s = svc_m if full else svc_m[lanes]
                heads_s = blk.heads if full else blk.heads[lanes]
                out = zone_sequential_completions_batched(
                    cur_s - svc_s, svc_s, heads_s, backend=scan_backend,
                    device=device)
                upd = np.maximum(cur_s, out)
                gidx_s = blk.gidx if full else blk.gidx[lanes]
            if s == 0 and budget == 1:
                # one-sweep budget: measure real progress (mask padding
                # — the position loop carries finite values through it)
                moved = moved or bool(
                    ((upd > cur_s * (1.0 + 1e-12) + 1e-9)
                     & (gidx_s != len(comp) - 1)).any())
            # each real index appears at most once per family block, so
            # fancy assignment is a well-defined scatter; the padding
            # slots all collapse onto the dead slot, reset below.
            comp[gidx_s] = upd
            comp[-1] = -np.inf
            # Residual + dirty propagation.  A violated lane strictly
            # increases at least one slot, so any processed block in the
            # check path moved; the first full sweep measures movement
            # directly (padding masked — it gathers the -inf sentinel).
            nonpad = gidx_s != len(comp) - 1
            diff = upd[nonpad] - cur_s[nonpad]
            if diff.size:
                residual = max(residual, float(diff.max()))
            blk_moved = bool((diff > 0.0).any()) if full and s == 0 \
                else True
            if blk_moved and nf > 1:
                nbr = adj[f]
                # neighbours later in the sweep order see this scatter
                # within the current sweep (Gauss–Seidel), earlier ones
                # on the next sweep.
                dirty_now[f + 1:] |= nbr[f + 1:]
                dirty_next[:f] |= nbr[:f]
        used = s + 1
        active_counts.append(n_active)
        residuals.append(residual)
        dirty_now, dirty_next = dirty_next, dirty_now
        if not moved:
            converged = True
            break
        converged = False
    global _LAST_SOLVE_STATS
    _LAST_SOLVE_STATS = SolveStats(
        driver="loop", sweeps=used, converged=converged, n_blocks=nf,
        active_blocks=tuple(active_counts), residuals=tuple(residuals))
    return comp[:-1], used, converged


def _packed_blocks(program: ChainProgram, device: torch.device):
    """The program's family blocks packed onto ``device`` for the
    fixpoint kernels (rows views, int32 indices, block adjacency).
    Memoized on the program per device, so repeated solves of a cached
    program upload the blocks once."""
    from ..kernels.zns_fixpoint import pack_blocks
    memo = getattr(program, "_packed_memo", None)
    if memo is None:
        memo = {}
        object.__setattr__(program, "_packed_memo", memo)
    key = str(device)
    packed = memo.get(key)
    if packed is None:
        packed = pack_blocks([blk.rows_view() for blk in program.families],
                             program.n_flat, device,
                             adj=block_adjacency(program))
        memo[key] = packed
    return packed


def _solve_kernel(program: ChainProgram, svc_flat: np.ndarray, *,
                  sweeps: int, impl: str, device: torch.device,
                  comp0: Optional[np.ndarray] = None
                  ) -> Tuple[np.ndarray, int, bool]:
    """Solve with the fixpoint kernel wrapper in float64 on ``device``
    (``impl``: ``"cuda"`` kernel or ``"torch"`` plain version)."""
    from ..kernels import ops as kops
    init = program.issue_flat + svc_flat
    if comp0 is not None:
        init = np.maximum(init, comp0)
    comp, used, converged = kops.zns_fixpoint(
        torch.as_tensor(init, dtype=torch.float64, device=device),
        torch.as_tensor(svc_flat, dtype=torch.float64, device=device),
        _packed_blocks(program, device), sweeps=max(int(sweeps), 1),
        impl=impl)
    return comp.cpu().numpy(), int(used), bool(converged)


def verify_fixpoint(program: ChainProgram, svc_flat: np.ndarray,
                    comp: np.ndarray, *, rtol: float = 1e-12,
                    atol: float = 1e-9) -> bool:
    """True iff ``comp`` is (to tolerance) the *least* fixpoint of the
    program at ``svc_flat`` — i.e. every event is **tight**: its
    completion equals the max of its own init (``issue + svc``) and its
    incoming chain-edge lower bounds (``comp[pred] + svc``), with no
    slack.

    A converged solve warm-started from a valid lower bound is always
    tight; one warm-started from an *invalid* ``comp0`` (e.g. a
    previous capacity-ladder rung whose greedy schedule anomalously
    completed some op later) keeps the unjustified value and fails this
    check — the caller then falls back to a cold solve.  The tightness
    ⇒ least-fixpoint argument needs every justifying chain to
    terminate, which strictly positive service times guarantee; with
    any ``svc <= 0`` the check conservatively returns False.
    """
    if program.n_flat == 0:
        return True
    svc = np.asarray(svc_flat, dtype=np.float64)
    if not np.all(svc > 0.0):
        return False
    comp = np.asarray(comp, dtype=np.float64)
    target = _fixpoint_target(program, svc, comp)
    tol = np.maximum(np.abs(target) * rtol, atol)
    return bool(np.all(np.abs(comp - target) <= tol))


def _fixpoint_target(program: ChainProgram, svc: np.ndarray,
                     comp: np.ndarray) -> np.ndarray:
    """Per-event justification: ``max(issue + svc, comp[pred] + svc)``
    over every incoming chain edge — what each completion *should* be
    if the rest of ``comp`` is taken as given."""
    ext = np.append(comp, -np.inf)
    svc_ext = np.append(svc, 0.0)
    text = np.append(program.issue_flat + svc, -np.inf)
    for blk in program.families:
        g, h = blk.gidx, blk.heads
        if blk.layout == "cols":
            pred, me, hh = g[:-1], g[1:], h[1:]
        else:
            pred, me, hh = g[:, :-1], g[:, 1:], h[:, 1:]
        mask = ~hh
        cand = ext[pred[mask]] + svc_ext[me[mask]]
        np.maximum.at(text, me[mask], cand)
    return text[:-1]


def unjustified_slots(program: ChainProgram, svc_flat: np.ndarray,
                      comp: np.ndarray, *, rtol: float = 1e-12,
                      atol: float = 1e-9) -> np.ndarray:
    """Indices whose completion exceeds its justification (init and
    every incoming edge) — the slots an invalid warm start ``comp0``
    pushed above the least fixpoint.  In a *converged* warm solve only
    candidate-dominated slots can be unjustified (everything else is
    explained by its predecessors), so a caller can drop exactly these
    slots from the candidate and re-solve — each round either ends
    tight or strictly shrinks the candidate (see
    :func:`repro.cluster.compiler.compile_graph`)."""
    if program.n_flat == 0:
        return np.zeros(0, dtype=np.int64)
    svc = np.asarray(svc_flat, dtype=np.float64)
    comp = np.asarray(comp, dtype=np.float64)
    target = _fixpoint_target(program, svc, comp)
    tol = np.maximum(np.abs(target) * rtol, atol)
    return np.nonzero(comp - target > tol)[0]


def solve_program(program: ChainProgram, svc_flat: np.ndarray, *,
                  sweeps: int = 8, scan_backend: str = "auto",
                  fixpoint: str = "auto", warn: bool = True,
                  comp0: Optional[np.ndarray] = None,
                  device=DEFAULT_DEVICE
                  ) -> Tuple[np.ndarray, int, bool]:
    """Run the fused Gauss-Seidel fixpoint; returns ``(completions,
    sweeps_used, converged)`` in flat event order (host float64 arrays).

    ``fixpoint`` selects the driver: ``"cuda"`` runs all sweeps x
    families through the CUDA ``zns_fixpoint`` kernel, ``"torch"``
    through its plain PyTorch version, both in float64 on ``device``;
    ``"auto"`` picks ``"cuda"`` on a CUDA device and ``"torch"`` on the
    CPU.  ``"loop"`` iterates family blocks in Python on the host
    around the batched scan (float64; ``scan_backend`` as in
    :func:`repro_torch.core.engine.zone_sequential_completions_batched`,
    on ``device``).  ``"sharded"`` partitions the entry axis into
    signature groups (:mod:`repro_torch.core.shard`), each with its own
    convergence: on a CUDA device every shard is solved in one launch of
    the stacked fixpoint kernel, on the CPU each by the ``loop`` driver;
    ``"windowed"`` partitions the *request* axis of a single mega-entry
    into issue-time windows solved as a pipeline
    (:func:`repro_torch.core.shard.solve_program_windowed`), one fixpoint
    solve a window.  Every driver records :class:`SolveStats` telemetry,
    readable via :func:`last_solve_stats`.  When the sweep budget is exhausted
    while constraints are still moving the result is a documented
    under-approximation -- a :class:`RuntimeWarning` is emitted unless
    ``warn=False``.

    ``comp0`` warm-starts the fixpoint from per-event completion lower
    bounds (flat event order).  The iteration is monotone from below,
    so any valid lower bound is safe; passing the solved completions of
    the member programs of a :func:`concat_programs` merge (their
    blocks share no constraints, so their fixpoints ARE the merged
    fixpoint) reduces the fleet-level solve to one cheap verification
    sweep.
    """
    dev = resolve_device(device)
    if program.n_flat == 0:
        return np.zeros(0, dtype=np.float64), 0, True
    if len(svc_flat) != program.n_flat:
        raise ValueError(f"service vector has {len(svc_flat)} entries for a "
                         f"{program.n_flat}-request program")
    if fixpoint == "auto":
        fixpoint = "cuda" if dev.type == "cuda" else "torch"
    if comp0 is not None and len(comp0) != program.n_flat:
        raise ValueError(f"comp0 has {len(comp0)} entries for a "
                         f"{program.n_flat}-request program")
    if fixpoint == "loop":
        comp, used, converged = _solve_numpy(
            program, np.asarray(svc_flat, dtype=np.float64),
            sweeps=sweeps, scan_backend=scan_backend, comp0=comp0,
            device=dev)
    elif fixpoint == "sharded":
        from .shard import solve_program_sharded
        comp, used, converged = solve_program_sharded(
            program, np.asarray(svc_flat, dtype=np.float64),
            sweeps=sweeps, scan_backend=scan_backend, comp0=comp0,
            warn=False, device=dev)
    elif fixpoint == "windowed":
        from .shard import solve_program_windowed
        comp, used, converged = solve_program_windowed(
            program, np.asarray(svc_flat, dtype=np.float64),
            sweeps=sweeps, scan_backend=scan_backend, comp0=comp0,
            warn=False, device=dev)
    elif fixpoint in ("cuda", "torch"):
        comp, used, converged = _solve_kernel(
            program, np.asarray(svc_flat, dtype=np.float64),
            sweeps=sweeps, impl=fixpoint, device=dev, comp0=comp0)
        global _LAST_SOLVE_STATS
        _LAST_SOLVE_STATS = SolveStats(
            driver=fixpoint, sweeps=used, converged=converged,
            n_blocks=len(program.families))
    else:
        raise ValueError(f"unknown fixpoint driver {fixpoint!r}; expected "
                         f"auto | cuda | torch | loop | sharded | windowed")
    if not converged and warn:
        warnings.warn(
            f"chain-program fixpoint exhausted its sweep budget "
            f"({sweeps}) while still moving; completions are a lower "
            f"bound. Raise ZnsDevice.run(..., sweeps=...) or inspect "
            f"SimResult.converged.", RuntimeWarning, stacklevel=3)
    return comp, used, converged


def unpack_results(program: ChainProgram, comp_flat: np.ndarray,
                   svc_flat: np.ndarray, svc_origs: Sequence[np.ndarray]
                   ) -> List["SimResult"]:
    """Split a flat solve back into per-device trace-order results."""
    from .engine import SimResult
    out = []
    for d in range(program.n_devices):
        sl = program.device_slice(d)
        if sl.stop == sl.start:
            z = np.zeros(0, dtype=np.float64)
            out.append(SimResult(start=z, complete=z.copy(),
                                 service=svc_origs[d]))
            continue
        comp = comp_flat[sl]
        svc = svc_flat[sl]
        inv = program.invs[d]
        out.append(SimResult(start=(comp - svc)[inv].copy(),
                             complete=comp[inv].copy(),
                             service=svc_origs[d]))
    return out
