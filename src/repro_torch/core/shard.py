"""Entry-axis sharding and issue-time windowing of compiled chain
programs, on one device.

A fleet-wide :class:`~repro_torch.core.chain_program.ChainProgram` is
block-diagonal over its entries: chains never cross devices (the fleet
compiler) or cluster entries (``concat_programs``), so the fused
Gauss-Seidel fixpoint decomposes into independent sub-fixpoints.  This
module exploits that two ways:

* **host executor** — partition the entries into *signature groups*
  (entries with identical chain structure: replicas, or one
  heterogeneity tier of a mixed fleet) and solve each group with the
  float64 ``loop`` driver under its own convergence budget.  A single
  whole-fleet solve pays ``max_s sweeps(s)`` sweeps of fleet-wide
  gathers and edge checks; the grouped solve pays
  ``sum_s sweeps(s) * |group_s|``.
* **mesh executor** — the same signature plan, every shard solved by
  **one** launch of the stacked fixpoint kernel
  (:func:`repro_torch.kernels.zns_fixpoint.zns_fixpoint_sharded`): each
  shard keeps its own blocks, sweep count, active set and convergence,
  and one barrier pair serves a family slot for every shard.  It takes
  the place of the reference's ``shard_map`` executor over a mesh of
  chips, whose LPT plan for one device is a single shard; on one card
  the signature groups and their own budgets are what sharding buys.  A
  plan of one shard falls back to the single-program kernel,
  bit-identical to ``fixpoint="cuda"`` (``"torch"`` on the CPU, where
  the stacked solve is its plain version).

Partitioning is safe by construction: entries are the connected
components of the chain/device incidence graph (a union-find pass), so
a family added by ``extend_program`` that couples two devices simply
fuses them into one shard.  Plans and window partitions are host numpy,
identical to the reference's.  ``solve_program(fixpoint="auto")`` never
routes here; ``fixpoint="sharded"`` / ``"windowed"`` do.  Force an
executor with ``REPRO_TORCH_SHARD_EXECUTOR=mesh`` / ``host``.  Solves
run on ``device=`` (``"cuda"`` by default, which raises without a CUDA
device); importing the module needs no CUDA.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import warnings
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import chain_program as _cp
from .chain_program import (ChainProgram, SolveStats, _blocks_from_chains,
                            _solve_kernel, _solve_numpy, block_adjacency,
                            program_chains)
from .torch_device import DEFAULT_DEVICE, resolve_device

#: Environment override for the sharded executor: ``mesh`` | ``host``
#: force one.  The port's own name, so that the reference's
#: ``REPRO_SHARD_EXECUTOR`` does not steer it.
EXECUTOR_ENV = "REPRO_TORCH_SHARD_EXECUTOR"

#: The signature plan merges the smallest groups until at most this many
#: shards remain — each shard is one sub-solve of the host executor, and
#: Python dispatch per sweep makes many tiny solves slower than one
#: fused solve.
HOST_MAX_SHARDS = 16


@dataclasses.dataclass(frozen=True)
class Shard:
    """One independent sub-fixpoint of a sharded program.

    ``devices`` are base-program device ids (ascending); ``perm`` maps
    the shard's flat event order back to base flat indices
    (``base_comp[perm] = shard_comp``); ``program`` is the extracted
    sub-program (device metadata collapsed to one flat pseudo-device —
    results are always scattered back through ``perm``, never unpacked
    from the sub-program).
    """

    devices: Tuple[int, ...]
    program: ChainProgram
    perm: np.ndarray

    @property
    def n_events(self) -> int:
        return self.program.n_flat


@dataclasses.dataclass
class ShardedProgram:
    """A partition of a chain program's entry axis into shards."""

    base: ChainProgram
    shards: Tuple[Shard, ...]
    #: the shards packed for the stacked kernel, per device, and their
    #: lane index into the base program ("index"), built lazily
    _packed: Dict[str, object] = dataclasses.field(
        default_factory=dict, repr=False)

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    def __repr__(self) -> str:
        sizes = [s.n_events for s in self.shards]
        return (f"ShardedProgram(shards={len(sizes)}, "
                f"events={sizes})")


def _entry_components(program: ChainProgram):
    """Union-find connected components of the chain/device graph.

    Returns ``(bounds, comp_list, recs)``: per-device flat bounds,
    components as ascending device-id lists, and one record ``(label,
    chain, component_index)`` per chain.
    """
    D = program.n_devices
    bounds = np.append(np.asarray(program.offsets, dtype=np.int64),
                       program.n_flat)
    parent = list(range(D))

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(a: int, b: int) -> None:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)

    raw = []                    # (label, chain, device)
    for label, chs in program_chains(program).items():
        for c in chs:
            cmin = int(c.min())
            d0 = int(np.searchsorted(bounds, cmin, side="right") - 1)
            if int(c.max()) >= bounds[d0 + 1]:
                # cross-entry chain (extend_program coupling): fuse
                # every touched device into one component
                ds = np.unique(np.searchsorted(bounds, c,
                                               side="right") - 1)
                for d in ds[1:]:
                    union(int(ds[0]), int(d))
                d0 = int(ds[0])
            raw.append((label, c, d0))
    comps: "OrderedDict[int, list]" = OrderedDict()
    for d in range(D):
        comps.setdefault(find(d), []).append(d)
    pos = {root: i for i, root in enumerate(comps)}
    recs = [(label, c, pos[find(d)]) for label, c, d in raw]
    return bounds, list(comps.values()), recs


def _signatures(n_comps: int, recs) -> List[tuple]:
    """Chain-structure signature per component: sorted ``(label,
    n_chains, total_len)`` triples.  Replicated entries and the members
    of one heterogeneity tier share a signature."""
    acc: List[dict] = [OrderedDict() for _ in range(n_comps)]
    for label, c, i in recs:
        st = acc[i].setdefault(label, [0, 0])
        st[0] += 1
        st[1] += len(c)
    return [tuple(sorted((lab, st[0], st[1]) for lab, st in a.items()))
            for a in acc]


def _lpt(weights: Sequence[int], k: int) -> List[List[int]]:
    """Longest-processing-time balanced partition into ``k`` bins."""
    k = max(min(k, len(weights)), 1)
    bins: List[List[int]] = [[] for _ in range(k)]
    loads = [0] * k
    for i in sorted(range(len(weights)), key=lambda i: -weights[i]):
        j = min(range(k), key=loads.__getitem__)
        bins[j].append(i)
        loads[j] += weights[i]
    return [sorted(b) for b in bins if b]


def shard_program(program: ChainProgram, *,
                  n_shards: Optional[int] = None) -> ShardedProgram:
    """Partition a program's entry axis into independent shards.

    With ``n_shards=None`` (host executor) entries group by chain
    *signature* — replicas and same-tier devices solve together, each
    group under its own convergence budget — merged down to at most
    :data:`HOST_MAX_SHARDS` groups.  With ``n_shards=k`` (mesh
    executor) entries are LPT-balanced into ``<= k`` event-weighted
    bins.  Entries are connected components of the chain/device graph,
    so cross-entry families from ``extend_program`` are never split —
    and neither are a refined pool's greedy-replay coupling chains,
    which always live inside one device's component.  Sub-programs
    inherit the parent's exactness contract verbatim (``exact``,
    ``order_stable``, ``unstable_pools``, ``svc_seeds``), so the
    sharded solve claims exactly what the single-chip solve would.
    """
    if program.n_devices == 0 or program.n_flat == 0:
        return ShardedProgram(base=program, shards=())
    bounds, comp_list, recs = _entry_components(program)
    weights = [int(sum(bounds[d + 1] - bounds[d] for d in devs))
               for devs in comp_list]
    if n_shards is None:
        by_sig: "OrderedDict[tuple, list]" = OrderedDict()
        for i, sig in enumerate(_signatures(len(comp_list), recs)):
            by_sig.setdefault(sig, []).append(i)
        groups = list(by_sig.values())
        while len(groups) > HOST_MAX_SHARDS:
            groups.sort(key=lambda g: sum(weights[i] for i in g))
            a, b = groups[0], groups[1]
            groups = [sorted(a + b)] + groups[2:]
    else:
        groups = _lpt(weights, int(n_shards))

    group_of = np.empty(len(comp_list), dtype=np.int64)
    for g, comps in enumerate(groups):
        for i in comps:
            group_of[i] = g

    # global -> shard-local index map (shards partition the flat axis)
    loc = np.empty(program.n_flat, dtype=np.int64)
    perms: List[np.ndarray] = []
    dev_lists: List[Tuple[int, ...]] = []
    for comps in groups:
        devs = sorted(d for i in comps for d in comp_list[i])
        perm = np.concatenate([np.arange(bounds[d], bounds[d + 1])
                               for d in devs]) if devs else \
            np.zeros(0, dtype=np.int64)
        loc[perm] = np.arange(len(perm))
        perms.append(perm)
        dev_lists.append(tuple(devs))

    chain_maps: List["OrderedDict[str, list]"] = \
        [OrderedDict() for _ in groups]
    for label, c, i in recs:
        chain_maps[group_of[i]].setdefault(label, []).append(loc[c])

    shards = []
    for g, perm in enumerate(perms):
        n = len(perm)
        order = np.arange(n, dtype=np.int64)
        sub = ChainProgram(
            n_flat=n, offsets=(0,), orders=(order,), invs=(order,),
            issue_flat=program.issue_flat[perm],
            svc0_flat=program.svc0_flat[perm],
            families=_blocks_from_chains(chain_maps[g], n),
            exact=program.exact,
            multiclass_pools=program.multiclass_pools,
            refine_used=program.refine_used,
            order_stable=program.order_stable,
            unstable_pools=program.unstable_pools,
            svc_seeds=program.svc_seeds)
        shards.append(Shard(devices=dev_lists[g], program=sub, perm=perm))
    return ShardedProgram(base=program, shards=tuple(shards))


# ---------------------------------------------------------------------------
# Plan cache: program object identity fast path + content-digest
# fallback (mirrors the lowering cache), so rebuilding an identical
# program — e.g. across capacity-ladder rungs — still hits.
# ---------------------------------------------------------------------------
_PLAN_CACHE: "OrderedDict[tuple, tuple]" = OrderedDict()
_PLAN_CACHE_MAX = 4


def _program_digest(program: ChainProgram) -> bytes:
    """Content digest of a compiled program's solve-relevant structure
    (flat size, entry offsets, family tensors), memoized on the program
    object — same trick as the trace digest memo."""
    cached = getattr(program, "_shard_digest_memo", None)
    if cached is not None:
        return cached
    h = hashlib.sha1()
    h.update(np.int64(program.n_flat).tobytes())
    h.update(np.asarray(program.offsets, dtype=np.int64).tobytes())
    for blk in program.families:
        h.update(blk.label.encode())
        h.update(blk.layout.encode())
        h.update(np.ascontiguousarray(blk.gidx).tobytes())
        h.update(np.ascontiguousarray(blk.heads).tobytes())
    d = h.digest()
    try:
        object.__setattr__(program, "_shard_digest_memo", d)
    except Exception:        # pragma: no cover - slotted subclass
        pass
    return d


def _plan(program: ChainProgram,
          n_shards: Optional[int]) -> ShardedProgram:
    ikey = ("id", id(program), n_shards)
    hit = _PLAN_CACHE.get(ikey)
    if hit is not None and hit[0] is program:
        _PLAN_CACHE.move_to_end(ikey)
        return hit[1]
    dkey = ("sha", _program_digest(program), n_shards)
    hit = _PLAN_CACHE.get(dkey)
    if hit is not None:
        sp = hit[1]
        _PLAN_CACHE.move_to_end(dkey)
    else:
        sp = shard_program(program, n_shards=n_shards)
        _PLAN_CACHE[dkey] = (None, sp)
    # (re)bind the identity fast path for this object; the digest entry
    # keeps serving identical rebuilds after this object dies.
    _PLAN_CACHE[ikey] = (program, sp)
    _PLAN_CACHE.move_to_end(ikey)
    while len(_PLAN_CACHE) > 2 * _PLAN_CACHE_MAX:
        _PLAN_CACHE.popitem(last=False)
    return sp


def clear_shard_plans() -> None:
    _PLAN_CACHE.clear()


def _pick_executor(device: torch.device) -> str:
    forced = os.environ.get(EXECUTOR_ENV, "").lower()
    if forced in ("mesh", "host"):
        return forced
    return "mesh" if device.type == "cuda" else "host"


# ---------------------------------------------------------------------------
# Executors
# ---------------------------------------------------------------------------
def _solve_host(program: ChainProgram, svc: np.ndarray, *, sweeps: int,
                scan_backend: str, comp0: Optional[np.ndarray],
                device: torch.device) -> Tuple[np.ndarray, int, bool]:
    plan = _plan(program, None)
    if len(plan.shards) <= 1:
        if program.n_flat >= WINDOW_AUTO_MIN:
            # homogeneous mega-entry: the entry axis gives no
            # parallelism, but the request axis still pipelines into
            # issue-time windows with bounded per-window memory
            return solve_program_windowed(
                program, svc, sweeps=sweeps, scan_backend=scan_backend,
                comp0=comp0, warn=False, driver="loop", device=device)
        # one signature group: the grouped solve IS the base solve
        return _solve_numpy(program, svc, sweeps=sweeps,
                            scan_backend=scan_backend, comp0=comp0,
                            device=device)
    comp = np.empty(program.n_flat, dtype=np.float64)
    used, conv = 0, True
    for sh in plan.shards:
        c, u, k = _solve_numpy(
            sh.program, svc[sh.perm], sweeps=sweeps,
            scan_backend=scan_backend,
            comp0=None if comp0 is None else comp0[sh.perm], device=device)
        comp[sh.perm] = c
        used = max(used, u)
        conv = conv and k
    return comp, used, conv


def _packed_shards(plan: ShardedProgram, device: torch.device):
    """The plan's shards packed for the stacked kernel, straight from each
    shard's own family blocks and adjacency (no padding), and ``lane``:
    the stack lane of each base event, as an index tensor on ``device``;
    cached on the plan per device."""
    from ..kernels.zns_fixpoint import pack_shards
    key = str(device)
    hit = plan._packed.get(key)
    if hit is None:
        packed = pack_shards(
            [([blk.rows_view() for blk in sh.program.families],
              sh.program.n_flat, block_adjacency(sh.program))
             for sh in plan.shards], device)
        lane = np.empty(plan.base.n_flat, dtype=np.int64)
        for sh, b in zip(plan.shards, packed.base):
            lane[sh.perm] = b + np.arange(len(sh.perm))
        hit = plan._packed[key] = (packed, torch.from_numpy(lane).to(device))
    return hit


def _solve_mesh(program: ChainProgram, svc: np.ndarray, *, sweeps: int,
                comp0: Optional[np.ndarray], device: torch.device
                ) -> Tuple[np.ndarray, int, bool]:
    from ..kernels import ops as kops
    impl = "cuda" if device.type == "cuda" else "torch"
    plan = _plan(program, None)
    if len(plan.shards) <= 1:
        if program.n_flat >= WINDOW_AUTO_MIN:
            # a homogeneous mega-entry windows as on the host executor,
            # one fixpoint launch a window
            return solve_program_windowed(
                program, svc, sweeps=sweeps, comp0=comp0, warn=False,
                driver=impl, device=device)
        return _solve_kernel(program, svc, sweeps=sweeps, impl=impl,
                             device=device, comp0=comp0)
    packed, lane = _packed_shards(plan, device)
    # only the (n,) vectors cross the bus: the stack is built and read on
    # the device (its dead slots keep the sentinel and a zero service time)
    c0 = program.issue_flat + svc
    if comp0 is not None:
        c0 = np.maximum(c0, comp0)
    f64 = dict(dtype=torch.float64, device=device)
    init = torch.full((packed.total,), -np.inf, **f64).index_copy_(
        0, lane, torch.as_tensor(c0, **f64))
    svc_s = torch.zeros(packed.total, **f64).index_copy_(
        0, lane, torch.as_tensor(svc, **f64))
    comp_s, used_s, conv_s = kops.zns_fixpoint_sharded(
        init, svc_s, packed, sweeps=max(int(sweeps), 1), impl=impl)
    comp = comp_s.index_select(0, lane).cpu().numpy()
    return comp, int(used_s.max()), bool(conv_s.all())


def solve_program_sharded(program: ChainProgram, svc_flat, *,
                          sweeps: int = 8, scan_backend: str = "auto",
                          comp0: Optional[np.ndarray] = None,
                          executor: str = "auto", warn: bool = True,
                          device=DEFAULT_DEVICE
                          ) -> Tuple[np.ndarray, int, bool]:
    """Sharded drop-in for :func:`repro_torch.core.solve_program`.

    Partitions the program's entry axis by chain signature (plan cached
    per program object) and solves each shard independently — the
    fixpoint is block-diagonal over entries, so the result equals the
    single solve to float64 fixpoint tolerance (~1e-12 relative).
    ``executor`` = ``"host"`` (one ``loop``-driver sub-solve a shard on
    ``device``; a 1-shard plan is the plain ``loop`` solve,
    bit-identically), ``"mesh"`` (every shard in one launch of the
    stacked fixpoint kernel on a CUDA ``device``, its plain version on
    the CPU; a 1-shard plan is the single-program kernel,
    bit-identically), or ``"auto"`` (mesh on a CUDA device, host on the
    CPU; ``REPRO_TORCH_SHARD_EXECUTOR`` overrides).  A 1-shard plan of
    :data:`WINDOW_AUTO_MIN` events or more (a homogeneous mega-entry) is
    windowed, on the executor's own driver (``loop`` on host, the kernel
    or its plain version on mesh).  Raises ``RuntimeError`` for a CUDA
    device when CUDA is not available.
    """
    dev = resolve_device(device)
    svc = np.asarray(svc_flat, dtype=np.float64)
    if program.n_flat == 0:
        return np.zeros(0, dtype=np.float64), 0, True
    if len(svc) != program.n_flat:
        raise ValueError(f"service vector has {len(svc)} entries for a "
                         f"{program.n_flat}-request program")
    if comp0 is not None and len(comp0) != program.n_flat:
        raise ValueError(f"comp0 has {len(comp0)} entries for a "
                         f"{program.n_flat}-request program")
    if executor not in ("auto", "host", "mesh"):
        raise ValueError(f"unknown shard executor {executor!r}; "
                         f"expected auto | host | mesh")
    if executor == "auto":
        executor = _pick_executor(dev)
    if executor == "host":
        comp, used, conv = _solve_host(program, svc, sweeps=sweeps,
                                       scan_backend=scan_backend,
                                       comp0=comp0, device=dev)
    else:
        comp, used, conv = _solve_mesh(program, svc, sweeps=sweeps,
                                       comp0=comp0, device=dev)
    _cp._LAST_SOLVE_STATS = SolveStats(
        driver=f"sharded/{executor}", sweeps=used, converged=conv,
        n_blocks=len(program.families))
    if not conv and warn:
        warnings.warn(
            f"sharded chain-program fixpoint exhausted its sweep budget "
            f"({sweeps}) while still moving; completions are a lower "
            f"bound.", RuntimeWarning, stacklevel=2)
    return comp, used, conv


# ---------------------------------------------------------------------------
# Intra-entry time-window sharding
# ---------------------------------------------------------------------------
#: Default issue-time window size (events) when ``n_windows`` is not
#: given: large enough that per-window solver overhead vanishes, small
#: enough that the per-window float64 scratch stays ~tens of MB.
WINDOW_TARGET_EVENTS = 1 << 18

#: ``solve_program_sharded`` auto-windows a degenerate 1-shard plan
#: only above this event count — smaller programs keep the documented
#: bit-identical numpy fallback.
WINDOW_AUTO_MIN = 2_000_000


@dataclasses.dataclass(frozen=True)
class Window:
    """One issue-time window of a windowed program.

    ``perm`` maps the window's flat event order back to base flat
    indices; ``bnd_local``/``bnd_pred`` are the pipeline boundary: the
    window-local index of each chain-segment head whose predecessor
    completed in an earlier window, and that predecessor's base flat
    index.  The boundary condition ``comp0[head] >= comp[pred] +
    svc[head]`` re-creates the cut chain edge exactly (the fixpoint is
    monotone from below, so a lower bound installed at init holds
    permanently)."""

    program: ChainProgram
    perm: np.ndarray
    bnd_local: np.ndarray
    bnd_pred: np.ndarray


@dataclasses.dataclass
class WindowedProgram:
    """A partition of one program's request axis into issue-time
    windows, solved as a pipelined sequence (earlier windows feed later
    ones their completion frontier)."""

    base: ChainProgram
    windows: Tuple[Window, ...]

    @property
    def n_windows(self) -> int:
        return len(self.windows)

    def __repr__(self) -> str:
        return (f"WindowedProgram(windows={len(self.windows)}, "
                f"events={[len(w.perm) for w in self.windows]})")


def window_program(program: ChainProgram, *,
                   n_windows: Optional[int] = None,
                   window_events: Optional[int] = None
                   ) -> WindowedProgram:
    """Partition a program's request axis into issue-time windows.

    Events are bucketed by issue-time rank into ``n_windows`` (default
    ``ceil(n_flat / window_events)``) near-equal windows, then the
    window index is repaired to be non-decreasing along every chain of
    every family (a running max per chain, iterated across families to
    a fixpoint) — so every cross-window chain edge points forward and
    the pipelined solve is exact.  Each window becomes a sub-program
    over its own events plus a boundary list of (segment head,
    upstream predecessor) pairs.  Results are memoized on the program
    per window count.
    """
    n = program.n_flat
    if n_windows is None:
        we = int(window_events) if window_events else WINDOW_TARGET_EVENTS
        n_windows = -(-n // we) if n else 1
    k = max(min(int(n_windows), n if n else 1), 1)
    memo = getattr(program, "_window_memo", None)
    if memo is not None and k in memo:
        return memo[k]

    w = np.empty(n, dtype=np.int64)
    order = np.argsort(program.issue_flat, kind="stable")
    w[order] = (np.arange(n, dtype=np.int64) * k) // max(n, 1)
    chains_by_label = program_chains(program)
    all_chains = [c for chs in chains_by_label.values() for c in chs]
    # monotone repair: raising an event's window can break another
    # chain through that event, so iterate to a fixpoint (bounded by
    # k passes; in practice 1-2)
    changed = True
    while changed:
        changed = False
        for c in all_chains:
            wc = w[c]
            acc = np.maximum.accumulate(wc)
            if (acc != wc).any():
                w[c] = acc
                changed = True

    perms = [np.nonzero(w == j)[0] for j in range(k)]
    loc = np.empty(n, dtype=np.int64)
    for p in perms:
        loc[p] = np.arange(len(p))
    chain_maps: List["OrderedDict[str, list]"] = \
        [OrderedDict() for _ in range(k)]
    bnds: List[Tuple[list, list]] = [([], []) for _ in range(k)]
    for label, chs in chains_by_label.items():
        for c in chs:
            wc = w[c]
            cut = np.nonzero(np.diff(wc))[0] + 1
            starts = np.concatenate(([0], cut))
            ends = np.concatenate((cut, [len(c)]))
            for a, b in zip(starts, ends):
                j = int(wc[a])
                chain_maps[j].setdefault(label, []).append(loc[c[a:b]])
                if a > 0:
                    bnds[j][0].append(int(loc[c[a]]))
                    bnds[j][1].append(int(c[a - 1]))

    windows = []
    for j in range(k):
        p = perms[j]
        m = len(p)
        oj = np.arange(m, dtype=np.int64)
        sub = ChainProgram(
            n_flat=m, offsets=(0,), orders=(oj,), invs=(oj,),
            issue_flat=program.issue_flat[p],
            svc0_flat=program.svc0_flat[p],
            families=_blocks_from_chains(chain_maps[j], m),
            exact=program.exact,
            multiclass_pools=program.multiclass_pools,
            refine_used=program.refine_used,
            order_stable=program.order_stable,
            unstable_pools=program.unstable_pools,
            svc_seeds=program.svc_seeds)
        windows.append(Window(
            program=sub, perm=p,
            bnd_local=np.asarray(bnds[j][0], dtype=np.int64),
            bnd_pred=np.asarray(bnds[j][1], dtype=np.int64)))
    wp = WindowedProgram(base=program, windows=tuple(windows))
    if memo is None:
        memo = {}
        try:
            object.__setattr__(program, "_window_memo", memo)
        except Exception:    # pragma: no cover - slotted subclass
            pass
    memo[k] = wp
    return wp


def solve_program_windowed(program: ChainProgram, svc_flat, *,
                           sweeps: int = 8, scan_backend: str = "auto",
                           comp0: Optional[np.ndarray] = None,
                           n_windows: Optional[int] = None,
                           window_events: Optional[int] = None,
                           warn: bool = True, driver: str = "auto",
                           device=DEFAULT_DEVICE
                           ) -> Tuple[np.ndarray, int, bool]:
    """Solve one program as a pipeline of issue-time windows.

    Window ``j+1`` starts from window ``j``'s completion frontier: each
    cut chain edge becomes a ``comp0`` lower bound ``comp[pred] +
    svc[head]`` on its downstream head, which the monotone fixpoint
    enforces permanently — so the pipelined result equals the full
    solve (and hence the event oracle, when ``program.exact``) to
    float64 fixpoint tolerance, while the solver's scratch is bounded by
    the largest window instead of the whole program.  ``sweeps`` is a
    per-window budget; ``sweeps_used`` reports the hungriest window.
    Each window is one solve of ``driver`` on ``device``: ``"auto"`` is
    the fixpoint kernel on a CUDA device (one launch a window) and its
    plain version on the CPU; ``"cuda"``, ``"torch"`` and ``"loop"`` as
    in :func:`repro_torch.core.solve_program`.  Raises ``RuntimeError``
    for a CUDA device when CUDA is not available.
    """
    dev = resolve_device(device)
    if driver == "auto":
        driver = "cuda" if dev.type == "cuda" else "torch"
    if driver not in ("cuda", "torch", "loop"):
        raise ValueError(f"unknown window driver {driver!r}; expected "
                         f"auto | cuda | torch | loop")
    svc = np.asarray(svc_flat, dtype=np.float64)
    if program.n_flat == 0:
        return np.zeros(0, dtype=np.float64), 0, True
    if len(svc) != program.n_flat:
        raise ValueError(f"service vector has {len(svc)} entries for a "
                         f"{program.n_flat}-request program")
    if comp0 is not None and len(comp0) != program.n_flat:
        raise ValueError(f"comp0 has {len(comp0)} entries for a "
                         f"{program.n_flat}-request program")

    def solve(prog, s, lb):
        if driver == "loop":
            return _solve_numpy(prog, s, sweeps=sweeps,
                                scan_backend=scan_backend, comp0=lb,
                                device=dev)
        return _solve_kernel(prog, s, sweeps=sweeps, impl=driver,
                             device=dev, comp0=lb)

    wp = window_program(program, n_windows=n_windows,
                        window_events=window_events)
    if wp.n_windows <= 1:
        comp, used, conv = solve(program, svc, comp0)
    else:
        comp, used, conv = _pipeline(wp, svc, comp0, solve)
    _cp._LAST_SOLVE_STATS = SolveStats(
        driver="windowed", sweeps=used, converged=conv,
        n_blocks=len(program.families))
    if not conv and warn:
        warnings.warn(
            f"windowed chain-program fixpoint exhausted its per-window "
            f"sweep budget ({sweeps}) while still moving; completions "
            f"are a lower bound.", RuntimeWarning, stacklevel=2)
    return comp, used, conv


def _pipeline(wp: WindowedProgram, svc: np.ndarray,
              comp0: Optional[np.ndarray], solve
              ) -> Tuple[np.ndarray, int, bool]:
    """Solve the windows in order, each from the frontier of the ones
    before it (``solve(program, svc, comp0)`` solves one window)."""
    comp = np.empty(wp.base.n_flat, dtype=np.float64)
    used, conv = 0, True
    for win in wp.windows:
        p = win.perm
        if not len(p):
            continue
        svc_w = svc[p]
        lb = None
        if comp0 is not None:
            lb = np.asarray(comp0, dtype=np.float64)[p].copy()
        if len(win.bnd_local):
            if lb is None:
                lb = np.full(len(p), -np.inf)
            np.maximum.at(lb, win.bnd_local,
                          comp[win.bnd_pred] + svc_w[win.bnd_local])
        c, u, ok = solve(win.program, svc_w, lb)
        comp[p] = c
        used = max(used, u)
        conv = conv and ok
    return comp, used, conv
