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

Both take the blocks packed by :func:`pack_blocks`: one flat int32
``gidx`` and bool ``heads`` buffer with a per-family ``(offset, R, L)``
table, plus the block adjacency.  Sentinels and the early-exit
tolerances follow the reference (:func:`pad_value`, :func:`moved_tol`).
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


def pack_blocks(blocks: Sequence, n: int, device,
                adj: Optional[np.ndarray] = None) -> PackedBlocks:
    """Pack ``[(gidx (R, L), heads (R, L)), ...]`` (numpy or tensors,
    padding at ``n``) onto ``device``.  ``adj`` defaults to
    :func:`blocks_adjacency`."""
    if n >= 2 ** 31 - 1:
        raise ValueError(f"zns_fixpoint: {n} events do not fit int32 "
                         f"gather indices")
    gs, hs, shapes, off = [], [], [], 0
    for g, h in blocks:
        g, h = _host(g), _host(h)
        if g.ndim != 2 or h.shape != g.shape:
            raise ValueError(f"zns_fixpoint: block gidx {g.shape} / heads "
                             f"{h.shape} must be matching (R, L)")
        if g.size and (g.min() < 0 or g.max() > n):
            raise ValueError("zns_fixpoint: gather index out of range")
        shapes.append((off, int(g.shape[0]), int(g.shape[1])))
        off += g.size
        gs.append(g.reshape(-1).astype(np.int32))
        hs.append(h.reshape(-1).astype(bool))
    if adj is None:
        adj = blocks_adjacency([_host(g) for g, _ in blocks], n)
    adj = np.asarray(adj, dtype=bool)
    if adj.shape != (len(shapes), len(shapes)):
        raise ValueError(f"zns_fixpoint: adjacency {adj.shape} for "
                         f"{len(shapes)} blocks")
    cat = (lambda xs, dt: np.concatenate(xs) if xs else np.zeros(0, dt))
    return PackedBlocks(
        n=int(n),
        gidx=torch.from_numpy(cat(gs, np.int32)).to(device),
        heads=torch.from_numpy(cat(hs, bool)).to(device),
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


def check_inputs(comp0, svc, blocks) -> None:
    if comp0.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"zns_fixpoint: float32 or float64 inputs, got "
                        f"{comp0.dtype}")
    if svc.dtype != comp0.dtype or svc.shape != comp0.shape \
            or comp0.dim() != 1:
        raise ValueError(f"zns_fixpoint: comp0 {tuple(comp0.shape)} "
                         f"{comp0.dtype} and svc {tuple(svc.shape)} "
                         f"{svc.dtype} must be matching (n,) vectors")
    if blocks.n != comp0.shape[0]:
        raise ValueError(f"zns_fixpoint: blocks packed for {blocks.n} "
                         f"events, comp0 has {comp0.shape[0]}")
    if not (comp0.device == svc.device == blocks.device):
        raise ValueError(f"zns_fixpoint: comp0 on {comp0.device}, svc on "
                         f"{svc.device}, blocks on {blocks.device}")


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
    # the largest block's tile count (at least 1), as the library sizes it
    most = max([1] + [r * -(-l // lib.tile) for _, r, l in blocks.shapes])
    # one allocation: the completions, the per-tile aggregates, and the
    # int32 state in the words after them
    words = -(-(2 + nf) * 4 // comp0.element_size())
    buf = torch.empty(n + 1 + 2 * most + words, dtype=comp0.dtype,
                      device=comp0.device)
    comp, agg = buf[:n + 1], buf[n + 1:n + 1 + 2 * most]
    state = buf[n + 1 + 2 * most:].view(torch.int32)
    fn = lib.zns_fixpoint_f64 if comp0.dtype == torch.float64 \
        else lib.zns_fixpoint_f32
    info = (ctypes.c_int * 5)()
    rc = fn(comp.data_ptr(), comp0.data_ptr(), svc.data_ptr(),
            blocks.gidx.data_ptr(), blocks.heads.data_ptr(),
            blocks.table.data_ptr(), table, blocks.adj_dev.data_ptr(), nf,
            max(int(sweeps), 1), n, agg.data_ptr(), state.data_ptr(),
            _build.stream_handle(comp.device), info)
    if rc != 0:
        raise RuntimeError(f"zns_fixpoint kernel launch failed: "
                           f"{lib.zns_fixpoint_error(rc).decode()} (CUDA "
                           f"error {rc})")
    zns_fixpoint.launches += 1
    zns_fixpoint.last_launch = launch_info(info)
    return comp[:n], int(info[3]), bool(info[4])


zns_fixpoint.launches = 0
zns_fixpoint.last_launch = None
