"""Public kernel entry points with ``impl`` dispatch.

Every op takes ``impl``: ``"cuda"`` launches the hand-written CUDA kernel
(CUDA tensors only), ``"torch"`` runs the kernel's plain PyTorch version
on whatever device the tensors are on, and ``None`` / ``"auto"`` picks
``"cuda"`` for CUDA tensors and ``"torch"`` for CPU tensors.  This is the
counterpart of the reference package's ``pallas | interpret | xla``
dispatch.  The two scans also take ``impl="ref"``, the sequential
oracles of :mod:`repro_torch.kernels.ref`, as the reference's
``impl="xla"`` takes its oracles.  Nothing falls back: a CUDA kernel
that fails to build or launch raises.

Gradients: ``impl="torch"`` is plain autograd through the plain
versions.  On ``impl="cuda"``, :func:`rmsnorm`, :func:`rmsnorm_cut`,
:func:`attention`, :func:`linear_recurrence` and :func:`ssd_scan` go through
``torch.autograd.Function`` objects whose backward launches the backward
kernels whenever an input requires a gradient (the plain kernel call
otherwise, as in serving).  A float64 call runs the plain versions only,
when asked for by name (``impl="torch"``).
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from . import flash_attention as _fa
from . import linear_recurrence as _lr
from . import ref as _ref
from . import rmsnorm as _rms
from . import ssd_chunk_scan as _ssd
from . import zns_event_scan as _scan
from . import zns_fixpoint as _fix
from .zns_fixpoint import PackedBlocks, PackedShards, pack_blocks, \
    pack_stacked

IMPLS = ("cuda", "torch")


def _wants_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _resolve(impl: Optional[str], t: torch.Tensor) -> str:
    if impl in (None, "auto"):
        return "cuda" if t.is_cuda else "torch"
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected cuda | torch | "
                         f"auto")
    if impl == "cuda" and not t.is_cuda:
        raise ValueError(f"impl='cuda' needs CUDA tensors, got tensors on "
                         f"{t.device}")
    return impl


def zns_event_scan(issue: torch.Tensor, svc: torch.Tensor,
                   seg: torch.Tensor, *, impl: Optional[str] = None
                   ) -> torch.Tensor:
    """1-D segmented max-plus scan (per-zone serialized completions)."""
    _scan.check_inputs(issue, svc, seg, 1)
    if impl == "ref":
        return _ref.zns_event_scan_ref(issue, svc, seg)
    if _resolve(impl, issue) == "torch":
        return _scan.rows_maxplus_torch(issue[None], svc[None], seg[None])[0]
    return _scan.zns_event_scan(issue, svc, seg)


def zns_event_scan_batched(issue: torch.Tensor, svc: torch.Tensor,
                           seg: torch.Tensor, *, impl: Optional[str] = None
                           ) -> torch.Tensor:
    """``(B, N)`` device-batched max-plus scan (the fleet's scan)."""
    _scan.check_inputs(issue, svc, seg, 2)
    if impl == "ref":
        return _ref.zns_event_scan_batched_ref(issue, svc, seg)
    if _resolve(impl, issue) == "torch":
        return _scan.rows_maxplus_torch(issue, svc, seg)
    return _scan.zns_event_scan_batched(issue, svc, seg)


def zns_fixpoint(comp0: torch.Tensor, svc: torch.Tensor,
                 blocks: Union[PackedBlocks, Sequence], *, sweeps: int = 8,
                 impl: Optional[str] = None,
                 adj: Optional[np.ndarray] = None):
    """Fused chain-program fixpoint; returns ``(completions, sweeps_used,
    converged)``.

    ``blocks``: a :class:`PackedBlocks`, or ``(gidx, heads)`` rows-view
    pairs (packed here onto ``comp0``'s device with ``adj``, by default
    the blocks' own adjacency).  The dtype of ``comp0`` (float32 or
    float64) selects the sentinels and early-exit tolerances.
    """
    if not isinstance(blocks, PackedBlocks):
        blocks = pack_blocks(blocks, comp0.shape[0], comp0.device, adj)
    if _resolve(impl, comp0) == "torch":
        _fix.check_inputs(comp0, svc, blocks)
        return _fix.zns_fixpoint_torch(comp0, svc, blocks, sweeps=sweeps)
    return _fix.zns_fixpoint(comp0, svc, blocks, sweeps=sweeps)


def zns_fixpoint_sharded(comp0: torch.Tensor, svc: torch.Tensor,
                         blocks: Union[PackedShards, Sequence], *,
                         sweeps: int = 8, impl: Optional[str] = None,
                         adj: Optional[np.ndarray] = None):
    """S independent chain-program fixpoints in one solve; returns
    ``(completions, sweeps_used (S,), converged (S,))``, each shard under
    its own sweep budget and early exit.

    ``blocks``: a :class:`PackedShards`, with ``comp0`` / ``svc`` its flat
    ``(total,)`` vectors (the completions come back the same); or the
    reference's stacked signature, ``comp0`` / ``svc`` ``(S, n_max + 1)``
    (one row a shard, dead slot last) and ``blocks`` the family slots
    ``(gidx (S, R_f, L_f), heads (S, R_f, L_f))`` with padding indexed at
    ``n_max`` and ``adj`` an optional ``(S, F, F)`` adjacency (the
    completions come back ``(S, n_max + 1)``).
    """
    stacked = not isinstance(blocks, PackedShards)
    if stacked:
        if comp0.dim() != 2:
            raise ValueError(f"zns_fixpoint_sharded: stacked comp0 must be "
                             f"(S, n_max + 1), got {tuple(comp0.shape)}")
        shape = comp0.shape
        blocks = pack_stacked(blocks, shape[1] - 1, comp0.device, adj)
        comp0, svc = comp0.reshape(-1), svc.reshape(-1)
    if _resolve(impl, comp0) == "torch":
        _fix.check_inputs(comp0, svc, blocks)
        comp, used, conv = _fix.zns_fixpoint_sharded_torch(
            comp0, svc, blocks, sweeps=sweeps)
    else:
        comp, used, conv = _fix.zns_fixpoint_sharded(comp0, svc, blocks,
                                                     sweeps=sweeps)
    return (comp.view(shape) if stacked else comp), used, conv


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              scale: Optional[float] = None, kv_length=None,
              impl: Optional[str] = None) -> torch.Tensor:
    """Attention forward, q ``(B, Hq, Tq, D)``, k/v ``(B, Hkv, Tk, D)``,
    query positions aligned to the end of the keys.  A ``kv_length``
    call goes to the dense oracle :func:`ref.attention_ref`, as in the
    reference."""
    if kv_length is not None:
        return _ref.attention_ref(q, k, v, causal=causal, window=window,
                                  scale=scale, kv_length=kv_length)
    _fa.check_inputs(q, k, v, window, plain=impl == "torch")
    if _resolve(impl, q) == "torch":
        return _fa.attention_torch(q, k, v, causal=causal, window=window,
                                   scale=scale)
    if _wants_grad(q, k, v):
        return _fa.FlashAttentionFunction.apply(q, k, v, causal, window,
                                                scale)
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               scale=scale)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6,
            impl: Optional[str] = None) -> torch.Tensor:
    """RMSNorm over the last dim of ``x``: ``x * rsqrt(mean(x^2) + eps)
    * (1 + w)`` in float32, returned in ``x``'s dtype."""
    _rms.check_inputs(x, w, plain=impl == "torch")
    if _resolve(impl, x) == "torch":
        return _rms.rmsnorm_torch(x, w, eps=eps)
    if _wants_grad(x, w):
        return _rms.RMSNormFunction.apply(x, w, eps)
    return _rms.rmsnorm(x, w, eps=eps)


def rmsnorm_cut(x: torch.Tensor, w: torch.Tensor, reduce, *, width: int,
                eps: float = 1e-6, impl: Optional[str] = None) -> torch.Tensor:
    """RMSNorm of rows whose ``width`` columns are cut over ranks: ``x``
    (..., d) and ``w`` (d,) this rank's columns, ``reduce`` the sum of a
    tensor of the rows' partial sums over the ranks (an all-reduce; on
    the plain version it carries the gradient, a ``psum``)."""
    _rms.check_inputs(x, w, plain=impl == "torch")
    if _resolve(impl, x) == "torch":
        return _ref.rmsnorm_cut_ref(x, w, reduce, width=width, eps=eps)
    if _wants_grad(x, w):
        return _rms.RMSNormCutFunction.apply(x, w, reduce, width, eps)
    return _rms.rmsnorm_cut(x, w, reduce, width=width, eps=eps)


def linear_recurrence(a: torch.Tensor, b: torch.Tensor, *,
                      impl: Optional[str] = None) -> torch.Tensor:
    """``h_t = a_t h_{t-1} + b_t`` over ``(B, T, D)`` from ``h_0 = 0``, in
    float32 (float64 for float64 inputs), returned in b's dtype."""
    _lr.check_inputs(a, b, plain=impl == "torch")
    if _resolve(impl, a) == "torch":
        return _lr.linear_recurrence_torch(a, b)
    if _wants_grad(a, b):
        return _lr.LinearRecurrenceFunction.apply(a, b)
    return _lr.linear_recurrence(a, b)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128,
             impl: Optional[str] = None):
    """Mamba2 SSD scan; returns ``(y, final state)``.  The CUDA kernel
    needs T to be a multiple of ``chunk`` (the model pads), as the
    reference's kernel does."""
    _ssd.check_inputs(x, dt, A, B, C, plain=impl == "torch")
    if _resolve(impl, x) == "torch":
        return _ssd.ssd_torch(x, dt, A, B, C, chunk=chunk)
    if _wants_grad(x, dt, A, B, C):
        return _ssd.SSDScanFunction.apply(x, dt, A, B, C, chunk)
    return _ssd.ssd_chunk_scan(x, dt, A, B, C, chunk=chunk)
