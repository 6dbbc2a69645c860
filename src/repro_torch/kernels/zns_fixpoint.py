"""Chain-program fixpoint: the CUDA kernel and its plain PyTorch version.

The compiler (:mod:`repro_torch.core.chain_program`) lowers a fleet of
traces into family blocks: padded ``(R, L)`` gather-index + segment-head
matrices addressing one flat completion vector with a dead slot at index
``n``.  One Gauss–Seidel sweep applies, per block, a segmented max-plus
scan to the gathered completions and writes the result back; an
active-set mask over the block adjacency skips converged blocks, and the
solve stops once no block is active.

* :func:`zns_fixpoint` launches ``csrc/zns_fixpoint.cu`` for CUDA
  tensors (float32 or float64): one persistent cooperative launch a
  solve, which runs the sweeps, the active set and the early exit on the
  device and returns once no block is active.  It replaces the TPU kernel
  ``src/repro/kernels/zns_fixpoint.py::zns_fixpoint``.
* :func:`zns_fixpoint_torch` is the plain version of the same loop
  (``_fixpoint_core`` of the reference).  The wrapper uses it only for
  tensors on the CPU.
* :func:`zns_fixpoint_sharded` solves a stack of S independent programs
  (the shards of a plan, :mod:`repro_torch.core.shard`) in one launch of
  the same kernel, each shard with its own blocks, adjacency, sweep count,
  active set and convergence.  It replaces the reference's
  ``zns_fixpoint_sharded`` (``lax.map`` of ``_fixpoint_core`` inside
  ``shard_map``).  :func:`zns_fixpoint_sharded_torch` is its plain
  version, a loop over the shards of :func:`zns_fixpoint_torch`.

The single solve takes the blocks packed by :func:`pack_blocks`: one
flat int32 ``gidx`` and bool ``heads`` buffer with a per-family
``(offset, R, L)`` table, plus the block adjacency; the stacked solve
takes every shard's, packed by :func:`pack_shards` or
:func:`pack_stacked`.  Sentinels and the early-exit tolerances follow
the reference (:func:`pad_value`, :func:`moved_tol`).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build
from .zns_event_scan import (NEG_INF, launch_info, pad_value,  # noqa: F401
                             rows_maxplus_torch)

#: Progress thresholds of the float32 early-exit test (looser than the
#: float64 1e-12 / 1e-9).
MOVED_RTOL = 1e-5
MOVED_ATOL = 1e-3


def moved_tol(dtype: torch.dtype) -> Tuple[float, float]:
    """Early-exit progress tolerances ``(rtol, atol)``: 1e-12 / 1e-9 in
    float64, 1e-5 / 1e-3 in float32."""
    if dtype == torch.float64:
        return 1e-12, 1e-9
    return MOVED_RTOL, MOVED_ATOL


def blocks_adjacency(gidxs, n: int) -> np.ndarray:
    """Symmetric ``(F, F)`` bool block adjacency from raw gather-index
    matrices: ``adj[i, j]`` iff blocks ``i`` and ``j`` address a common
    flat slot (padding at ``n`` excluded).  Diagonal False — a block is
    at its own fixpoint right after its scan.  Host-side numpy."""
    nf = len(gidxs)
    adj = np.zeros((nf, nf), dtype=bool)
    if nf > 1:
        parts, owners = [], []
        for f, g in enumerate(gidxs):
            flat = np.asarray(g).ravel()
            flat = flat[flat != n]
            parts.append(flat)
            owners.append(np.full(len(flat), f, dtype=np.int32))
        idx = np.concatenate(parts)
        own = np.concatenate(owners)
        order = np.argsort(idx, kind="stable")
        idx, own = idx[order], own[order]
        # an index appears at most once per block, so runs of equal
        # index are <= F long; shifted compares cover all in-run pairs
        for k in range(1, nf):
            same = idx[k:] == idx[:-k]
            if not same.any():
                break
            adj[own[k:][same], own[:-k][same]] = True
            adj[own[:-k][same], own[k:][same]] = True
        np.fill_diagonal(adj, False)
    return adj


@dataclasses.dataclass(frozen=True, eq=False)
class PackedBlocks:
    """Family blocks of one program, packed for the fixpoint.

    ``gidx`` (int32) and ``heads`` (bool) hold every block's rows view
    back to back; ``shapes[f] = (offset, R, L)`` locates block ``f``, and
    ``table`` holds the same triples as an int64 ``(F, 3)`` tensor on the
    blocks' device.  Padding lanes index the dead slot ``n``.  ``adj`` is
    the host adjacency, ``adj_dev`` the same matrix as uint8 on the
    blocks' device.
    """

    n: int
    gidx: torch.Tensor
    heads: torch.Tensor
    shapes: Tuple[Tuple[int, int, int], ...]
    table: torch.Tensor
    adj: np.ndarray
    adj_dev: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.gidx.device

    def views(self) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Per-block ``(gidx (R, L), heads (R, L))`` views."""
        return [(self.gidx[o:o + r * l].view(r, l),
                 self.heads[o:o + r * l].view(r, l))
                for o, r, l in self.shapes]


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _pack_host(blocks: Sequence, n: int, adj: Optional[np.ndarray],
               off: int, name: str):
    """Host half of packing one program's blocks: the int32 gidx and bool
    heads parts, each block's ``(offset, R, L)`` from ``off``, and the
    checked ``(F, F)`` adjacency (:func:`blocks_adjacency` when None)."""
    if n >= 2 ** 31 - 1:
        raise ValueError(f"{name}: {n} events do not fit int32 gather "
                         f"indices")
    gs, hs, shapes = [], [], []
    for g, h in blocks:
        g, h = _host(g), _host(h)
        if g.ndim != 2 or h.shape != g.shape:
            raise ValueError(f"{name}: block gidx {g.shape} / heads "
                             f"{h.shape} must be matching (R, L)")
        if g.size and (g.min() < 0 or g.max() > n):
            raise ValueError(f"{name}: gather index out of range")
        shapes.append((off, int(g.shape[0]), int(g.shape[1])))
        off += g.size
        gs.append(g.reshape(-1).astype(np.int32))
        hs.append(h.reshape(-1).astype(bool))
    if adj is None:
        adj = blocks_adjacency([_host(g) for g, _ in blocks], n)
    adj = np.asarray(adj, dtype=bool)
    if adj.shape != (len(shapes), len(shapes)):
        raise ValueError(f"{name}: adjacency {adj.shape} for {len(shapes)} "
                         f"blocks")
    return gs, hs, shapes, adj


def _cat(xs, dtype) -> np.ndarray:
    return np.concatenate(xs) if xs else np.zeros(0, dtype)


def pack_blocks(blocks: Sequence, n: int, device,
                adj: Optional[np.ndarray] = None) -> PackedBlocks:
    """Pack ``[(gidx (R, L), heads (R, L)), ...]`` (numpy or tensors,
    padding at ``n``) onto ``device``.  ``adj`` defaults to
    :func:`blocks_adjacency`."""
    gs, hs, shapes, adj = _pack_host(blocks, n, adj, 0, "zns_fixpoint")
    return PackedBlocks(
        n=int(n),
        gidx=torch.from_numpy(_cat(gs, np.int32)).to(device),
        heads=torch.from_numpy(_cat(hs, bool)).to(device),
        shapes=tuple(shapes),
        table=torch.tensor(shapes, dtype=torch.int64).reshape(-1, 3).to(
            device),
        adj=adj, adj_dev=torch.from_numpy(adj.astype(np.uint8)).to(device))


def _extend(comp0: torch.Tensor, svc: torch.Tensor):
    """Flat ``(n + 1,)`` vectors with the dead slot last: the sentinel
    in ``comp``, a zero service time in ``svc``."""
    dt = comp0.dtype
    comp = torch.cat([comp0, comp0.new_full((1,), pad_value(dt))])
    svc_ext = torch.cat([svc, svc.new_zeros(1)])
    return comp, svc_ext


def zns_fixpoint_torch(comp0: torch.Tensor, svc: torch.Tensor,
                       blocks: PackedBlocks, *, sweeps: int = 8,
                       active_log: Optional[list] = None
                       ) -> Tuple[torch.Tensor, int, bool]:
    """Plain PyTorch fixpoint (the reference's ``_fixpoint_core``) on
    whatever device the tensors are on.  Returns ``(comp (n,),
    sweeps_used, converged)``.  ``active_log``, when given, receives the
    list of block indices scanned in each sweep."""
    n = comp0.shape[0]
    dead = n
    dt = comp0.dtype
    ninf = pad_value(dt)
    rtol, atol = moved_tol(dt)
    comp, svc_ext = _extend(comp0, svc)
    views = [(g.long(), h) for g, h in blocks.views()]
    nf = len(views)
    adj = blocks.adj
    later = [np.arange(nf) > f for f in range(nf)]
    active = np.ones(max(nf, 1), dtype=bool)
    used = 0
    while used < max(int(sweeps), 1) and active.any():
        act_now = active.copy()
        act_next = np.zeros_like(active)
        ran = []
        for f, (gidx, heads) in enumerate(views):
            if not act_now[f]:
                continue
            ran.append(f)
            svc_m = svc_ext[gidx]
            cur = comp[gidx]
            out = rows_maxplus_torch(cur - svc_m, svc_m, heads)
            # padding gathers the sentinel, which would trivially satisfy
            # the relative-progress test: mask it out
            mv = bool(((out > cur * (1.0 + rtol) + atol)
                       & (gidx < dead)).any())
            comp[gidx] = torch.maximum(cur, out)
            comp[dead] = ninf
            if mv:
                # a moving block re-activates neighbours: later blocks see
                # the write within this sweep, earlier ones on the next
                nbr = adj[f]
                act_now |= nbr & later[f]
                act_next |= nbr & ~later[f]
        if active_log is not None:
            active_log.append(ran)
        active = act_next
        used += 1
    return comp[:n], used, not bool(active.any())


def block_tiles(rows: int, length: int, tile: int) -> int:
    """Tiles of ``tile`` lanes the CUDA kernel cuts a ``(rows, length)``
    block into, as its ``fp_shape`` does: a row longer than a tile spans
    ``ceil(length / tile)`` tiles; shorter rows pack ``tile // length`` to
    a tile."""
    if length < 1:
        return 0
    if length <= tile:
        return -(-rows // (tile // length))
    return rows * -(-length // tile)


#: The most shards, and block slots over all shards (``S * F``), one
#: stacked launch takes: the kernel keeps each shard's active set in
#: shared memory (``FP_MAX_SHARDS`` / ``FP_MAX_FLAGS`` of
#: ``csrc/zns_fixpoint.cu``).  :func:`pack_shards` refuses larger stacks.
MAX_SHARDS = 1024
MAX_FLAGS = 4096


@dataclasses.dataclass(frozen=True, eq=False)
class PackedShards:
    """S independent programs packed for the stacked fixpoint.

    Shard ``s`` owns lanes ``base[s] .. base[s] + ns[s]`` of one flat
    vector, its dead slot last (``base[s + 1] = base[s] + ns[s] + 1``);
    its gather indices are its own (``0 .. ns[s]``).  ``gidx`` / ``heads``
    hold every shard's blocks back to back; ``shapes[s]`` lists shard
    ``s``'s own ``(offset, R, L)`` blocks and ``table`` the same as an
    int64 ``(S, F, 3)`` tensor on the device, padded with empty blocks to
    ``F`` slots.  ``adj`` is the host ``(S, F, F)`` adjacency, ``adj_dev``
    the same as uint8 on the device, ``base_dev`` the ``(S + 1,)`` starts.
    """

    ns: Tuple[int, ...]
    base: Tuple[int, ...]
    F: int
    gidx: torch.Tensor
    heads: torch.Tensor
    shapes: Tuple[Tuple[Tuple[int, int, int], ...], ...]
    table: torch.Tensor
    table_host: np.ndarray
    adj: np.ndarray
    adj_dev: torch.Tensor
    base_dev: torch.Tensor
    _cache: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def S(self) -> int:
        return len(self.ns)

    @property
    def total(self) -> int:
        """Lanes of the flat vector, every shard's dead slot included."""
        return self.base[-1]

    @property
    def device(self) -> torch.device:
        return self.gidx.device

    def shard(self, s: int) -> PackedBlocks:
        """Shard ``s``'s own blocks as a :class:`PackedBlocks` (views of
        the packed buffers, offsets made the shard's own)."""
        pb = self._cache.get(s)
        if pb is None:
            own = self.shapes[s]
            lo = own[0][0] if own else 0
            hi = own[-1][0] + own[-1][1] * own[-1][2] if own else 0
            shapes = tuple((o - lo, r, l) for o, r, l in own)
            nf = len(own)
            pb = PackedBlocks(
                n=self.ns[s], gidx=self.gidx[lo:hi], heads=self.heads[lo:hi],
                shapes=shapes,
                table=torch.tensor(shapes, dtype=torch.int64).reshape(
                    -1, 3).to(self.device),
                adj=self.adj[s, :nf, :nf],
                adj_dev=self.adj_dev[s, :nf, :nf].contiguous())
            self._cache[s] = pb
        return pb

    def tiles(self, tile: int) -> int:
        """The most tiles of ``tile`` lanes of any family slot summed over
        the shards (the stacked kernel's grid and scratch), computed
        once."""
        key = ("tiles", tile)
        most = self._cache.get(key)
        if most is None:
            most = max([sum(block_tiles(int(r), int(l), tile)
                            for _, r, l in self.table_host[:, f])
                        for f in range(self.F)] + [0])
            self._cache[key] = most
        return most

    def c_table(self):
        """The host table as a ctypes array (the library's host copy),
        built once."""
        t = self._cache.get("table")
        if t is None:
            flat = self.table_host.reshape(-1).tolist()
            t = (ctypes.c_longlong * max(len(flat), 1))(*flat)
            self._cache["table"] = t
        return t


def pack_shards(shards: Sequence, device) -> PackedShards:
    """Pack ``[(blocks, n, adj), ...]``, one entry a shard (``blocks``
    rows-view ``(gidx (R, L), heads (R, L))`` pairs with padding at the
    shard's ``n``; ``adj`` its ``(F_s, F_s)`` adjacency, or None for
    :func:`blocks_adjacency`) onto ``device``.  Raises ``ValueError``
    beyond ``MAX_SHARDS`` shards or ``MAX_FLAGS`` block slots."""
    S = len(shards)
    F = max([len(b) for b, _, _ in shards] + [0])
    if S < 1 or S > MAX_SHARDS or S * F > MAX_FLAGS:
        raise ValueError(f"zns_fixpoint_sharded: {S} shards of up to {F} "
                         f"blocks; one launch takes 1 to {MAX_SHARDS} "
                         f"shards and {MAX_FLAGS} blocks in all")
    gs, hs, shapes = [], [], []
    table = np.zeros((S, F, 3), dtype=np.int64)
    adj_all = np.zeros((S, F, F), dtype=bool)
    ns, base, off = [], [0], 0
    for s, (blocks, n, adj) in enumerate(shards):
        g, h, own, adj = _pack_host(blocks, int(n), adj, off,
                                    "zns_fixpoint_sharded")
        gs += g
        hs += h
        if own:
            table[s, :len(own)] = own
            off = own[-1][0] + own[-1][1] * own[-1][2]
        adj_all[s, :len(own), :len(own)] = adj
        shapes.append(tuple(own))
        ns.append(int(n))
        base.append(base[-1] + int(n) + 1)
    return PackedShards(
        ns=tuple(ns), base=tuple(base), F=F,
        gidx=torch.from_numpy(_cat(gs, np.int32)).to(device),
        heads=torch.from_numpy(_cat(hs, bool)).to(device),
        shapes=tuple(shapes), table=torch.from_numpy(table).to(device),
        table_host=table, adj=adj_all,
        adj_dev=torch.from_numpy(adj_all.astype(np.uint8)).to(device),
        base_dev=torch.tensor(base, dtype=torch.int64).to(device))


def pack_stacked(blocks: Sequence, n_max: int, device,
                 adj: Optional[np.ndarray] = None) -> PackedShards:
    """Pack the reference's stacked signature: ``blocks`` a sequence of
    family slots ``(gidx (S, R_f, L_f), heads (S, R_f, L_f))``, padding
    indexed at ``n_max``; ``adj`` an ``(S, F, F)`` adjacency or None.
    Each shard's block keeps only its own rows and columns (trailing rows
    and columns that gather nothing but the dead slot are cut), so no
    shard pays for another's padding."""
    if not blocks:
        raise ValueError("zns_fixpoint_sharded: no family slots")
    S = _host(blocks[0][0]).shape[0]
    host = [(_host(g), _host(h)) for g, h in blocks]
    shards = []
    for s in range(S):
        own = []
        for g, h in host:
            gs, hs = g[s], h[s]
            live = gs != n_max
            rows = np.nonzero(live.any(axis=1))[0]
            cols = np.nonzero(live.any(axis=0))[0]
            r = int(rows[-1]) + 1 if len(rows) else 0
            c = int(cols[-1]) + 1 if len(cols) else 0
            own.append((gs[:r, :c], hs[:r, :c]))
        shards.append((own, n_max,
                       None if adj is None else np.asarray(adj)[s]))
    return pack_shards(shards, device)


def check_inputs(comp0, svc, packed) -> None:
    """``comp0`` / ``svc``: matching float32 or float64 vectors on the
    packed blocks' device, ``(n,)`` for a :class:`PackedBlocks` and
    ``(total,)`` for a :class:`PackedShards`."""
    stacked = isinstance(packed, PackedShards)
    name = "zns_fixpoint_sharded" if stacked else "zns_fixpoint"
    lanes = packed.total if stacked else packed.n
    if comp0.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: float32 or float64 inputs, got "
                        f"{comp0.dtype}")
    if svc.dtype != comp0.dtype or svc.shape != comp0.shape \
            or comp0.dim() != 1 or comp0.shape[0] != lanes:
        raise ValueError(f"{name}: comp0 {tuple(comp0.shape)} "
                         f"{comp0.dtype} and svc {tuple(svc.shape)} "
                         f"{svc.dtype} must be matching ({lanes},) vectors")
    if not (comp0.device == svc.device == packed.device):
        raise ValueError(f"{name}: comp0 on {comp0.device}, svc on "
                         f"{svc.device}, blocks on {packed.device}")


def zns_fixpoint_sharded_torch(comp0: torch.Tensor, svc: torch.Tensor,
                               shards: PackedShards, *, sweeps: int = 8
                               ) -> Tuple[torch.Tensor, np.ndarray,
                                          np.ndarray]:
    """Plain version of the stacked solve: :func:`zns_fixpoint_torch` on
    each shard in turn, each under its own sweep budget.  ``comp0`` /
    ``svc``: the flat ``(shards.total,)`` vectors (only real lanes are
    read).  Returns ``(comp (total,), sweeps_used (S,), converged (S,))``,
    every dead slot the sentinel."""
    comp = comp0.new_full(comp0.shape, pad_value(comp0.dtype))
    used = np.zeros(shards.S, dtype=np.int64)
    conv = np.zeros(shards.S, dtype=bool)
    for s in range(shards.S):
        b, n = shards.base[s], shards.ns[s]
        c, used[s], conv[s] = zns_fixpoint_torch(
            comp0[b:b + n], svc[b:b + n], shards.shard(s), sweeps=sweeps)
        comp[b:b + n] = c
    return comp, used, conv


_LIB = None


def _lib():
    """The built library, its C signatures set once."""
    global _LIB
    if _LIB is None:
        lib = _build.load("zns_fixpoint")
        for fn in (lib.zns_fixpoint_f32, lib.zns_fixpoint_f64):
            fn.argtypes = [ctypes.c_void_p] * 6 + [
                ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_longlong] \
                + [ctypes.c_void_p] * 4
            fn.restype = ctypes.c_int
        lib.zns_fixpoint_error.restype = ctypes.c_char_p
        lib.tile = lib.zns_fixpoint_tile()
        _LIB = lib
    return _LIB


def _sharded_fn(dtype: torch.dtype):
    """The library's stacked entry for ``dtype``, its C signature set at
    first use (a build of an earlier source, as
    ``scripts/fixpoint_phases.py --source`` loads, has only the single
    entries)."""
    lib = _lib()
    fn = lib.zns_fixpoint_sharded_f64 if dtype == torch.float64 \
        else lib.zns_fixpoint_sharded_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int] \
            + [ctypes.c_void_p] * 6
        fn.restype = ctypes.c_int
    return fn


def _launch(wrapper, comp0: torch.Tensor, lanes: int, most: int,
            words: int, call) -> Tuple[torch.Tensor, ctypes.Array]:
    """One solve on the card: one allocation (``lanes`` completions, the
    per-tile aggregates of at most ``most`` tiles, and ``words`` int32
    state words after them), then ``call(comp, agg, state, info)``, the
    library's entry.  Raises ``RuntimeError`` naming the CUDA error on a
    refused launch; else counts it on ``wrapper`` and keeps its
    ``last_launch``.  Returns the completions and ``info``."""
    most = max(1, most)
    cells = -(-words * 4 // comp0.element_size())
    buf = torch.empty(lanes + 2 * most + cells, dtype=comp0.dtype,
                      device=comp0.device)
    comp, agg = buf[:lanes], buf[lanes:lanes + 2 * most]
    state = buf[lanes + 2 * most:].view(torch.int32)
    info = (ctypes.c_int * 5)()
    rc = call(comp, agg, state, info)
    if rc != 0:
        raise RuntimeError(f"{wrapper.__name__} kernel launch failed: "
                           f"{_lib().zns_fixpoint_error(rc).decode()} "
                           f"(CUDA error {rc})")
    wrapper.launches += 1
    wrapper.last_launch = launch_info(info)
    return comp, info


def zns_fixpoint(comp0: torch.Tensor, svc: torch.Tensor,
                 blocks: PackedBlocks, *, sweeps: int = 8
                 ) -> Tuple[torch.Tensor, int, bool]:
    """Fused Gauss–Seidel fixpoint; returns ``(comp (n,), sweeps_used,
    converged)``.  CUDA tensors launch the kernel once (the whole solve
    on the current stream; the library waits for it and reads its sweep
    count and active set back, and the wrapper launches no other device
    kernel); CPU tensors run :func:`zns_fixpoint_torch`.  A refused
    cooperative launch raises ``RuntimeError`` naming the CUDA error."""
    check_inputs(comp0, svc, blocks)
    if not comp0.is_cuda:
        return zns_fixpoint_torch(comp0, svc, blocks, sweeps=sweeps)
    n = comp0.shape[0]
    nf = len(blocks.shapes)
    comp0 = comp0.contiguous()
    svc = svc.contiguous()
    lib = _lib()
    table = (ctypes.c_longlong * max(3 * nf, 1))(
        *[v for shape in blocks.shapes for v in shape])
    most = max([0] + [block_tiles(r, l, lib.tile)
                      for _, r, l in blocks.shapes])
    fn = lib.zns_fixpoint_f64 if comp0.dtype == torch.float64 \
        else lib.zns_fixpoint_f32
    comp, info = _launch(
        zns_fixpoint, comp0, n + 1, most, 2 + nf,
        lambda comp, agg, state, info: fn(
            comp.data_ptr(), comp0.data_ptr(), svc.data_ptr(),
            blocks.gidx.data_ptr(), blocks.heads.data_ptr(),
            blocks.table.data_ptr(), table, blocks.adj_dev.data_ptr(), nf,
            max(int(sweeps), 1), n, agg.data_ptr(), state.data_ptr(),
            _build.stream_handle(comp.device), info))
    return comp[:n], int(info[3]), bool(info[4])


zns_fixpoint.launches = 0
zns_fixpoint.last_launch = None


def zns_fixpoint_sharded(comp0: torch.Tensor, svc: torch.Tensor,
                         shards: PackedShards, *, sweeps: int = 8
                         ) -> Tuple[torch.Tensor, np.ndarray, np.ndarray]:
    """Stacked fixpoint of S independent programs; returns ``(comp
    (total,), sweeps_used (S,), converged (S,))`` with ``comp0`` / ``svc``
    the flat ``(shards.total,)`` vectors of :class:`PackedShards` (only
    real lanes are read).  CUDA tensors launch the kernel once for the
    whole stack (each shard its own sweeps, active set and early exit; the
    library waits for it and reads every shard's state back); CPU tensors
    run :func:`zns_fixpoint_sharded_torch`.  A refused launch raises
    ``RuntimeError`` naming the CUDA error."""
    check_inputs(comp0, svc, shards)
    if not comp0.is_cuda:
        return zns_fixpoint_sharded_torch(comp0, svc, shards, sweeps=sweeps)
    comp0 = comp0.contiguous()
    svc = svc.contiguous()
    S, F = shards.S, shards.F
    fn = _sharded_fn(comp0.dtype)
    used = (ctypes.c_int * S)()
    conv = (ctypes.c_int * S)()
    comp, _ = _launch(
        zns_fixpoint_sharded, comp0, shards.total,
        shards.tiles(_lib().tile), S * (2 + F),
        lambda comp, agg, state, info: fn(
            comp.data_ptr(), comp0.data_ptr(), svc.data_ptr(),
            shards.gidx.data_ptr(), shards.heads.data_ptr(),
            shards.table.data_ptr(), shards.c_table(),
            shards.adj_dev.data_ptr(), shards.base_dev.data_ptr(), S, F,
            max(int(sweeps), 1), agg.data_ptr(), state.data_ptr(),
            _build.stream_handle(comp.device), info, used, conv))
    zns_fixpoint_sharded.last_launch.update(shards=S, slots=F)
    return (comp, np.asarray(used[:], dtype=np.int64),
            np.asarray(conv[:], dtype=bool))


zns_fixpoint_sharded.launches = 0
zns_fixpoint_sharded.last_launch = None
