"""Public kernel entry points with ``impl`` dispatch.

Every op takes ``impl``: ``"cuda"`` launches the hand-written CUDA kernel
(CUDA tensors only), ``"torch"`` runs the kernel's plain PyTorch version
on whatever device the tensors are on, and ``None`` / ``"auto"`` picks
``"cuda"`` for CUDA tensors and ``"torch"`` for CPU tensors.  This is the
counterpart of the reference package's ``pallas | interpret | xla``
dispatch.  Nothing falls back: a CUDA kernel that fails to build or
launch raises.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from . import zns_event_scan as _scan
from . import zns_fixpoint as _fix
from .zns_fixpoint import PackedBlocks, pack_blocks

IMPLS = ("cuda", "torch")


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
    if _resolve(impl, issue) == "torch":
        return _scan.rows_maxplus_torch(issue[None], svc[None], seg[None])[0]
    return _scan.zns_event_scan(issue, svc, seg)


def zns_event_scan_batched(issue: torch.Tensor, svc: torch.Tensor,
                           seg: torch.Tensor, *, impl: Optional[str] = None
                           ) -> torch.Tensor:
    """``(B, N)`` device-batched max-plus scan (the fleet's scan)."""
    _scan.check_inputs(issue, svc, seg, 2)
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
    _fix.check_inputs(comp0, svc, blocks)
    if _resolve(impl, comp0) == "torch":
        return _fix.zns_fixpoint_torch(comp0, svc, blocks, sweeps=sweeps)
    return _fix.zns_fixpoint(comp0, svc, blocks, sweeps=sweeps)
