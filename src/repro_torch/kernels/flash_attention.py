"""Blocked (flash) attention forward: the CUDA kernel and its plain
PyTorch version.

q ``(B, Hq, Tq, D)``, k/v ``(B, Hkv, Tk, D)`` -> ``(B, Hq, Tq, D)`` in q's
dtype (float32 or bfloat16), computed in float32.  Query ``i`` sits at
position ``i + (Tk - Tq)``; ``causal`` keeps keys at or before it,
``window`` the last ``window`` of those; GQA maps query head ``h`` to KV
head ``h // (Hq // Hkv)``; a row that sees no key is 0.

* :func:`flash_attention` launches ``csrc/flash_attention.cu`` for CUDA
  tensors (D in :data:`HEAD_DIMS`): bfloat16 on the tensor cores
  (``wgmma``), float32 on the float32 cores.  It takes q/k/v by their
  strides, so the ``(B, H, S, D)`` views that the model makes with
  ``movedim`` are not copied; the output has q's strides.  In bfloat16
  every row must start 16-byte aligned (the kernel's ``cp.async`` copies):
  a tensor whose pointer or strides break that is copied to contiguous
  first.  It replaces the TPU kernel
  ``src/repro/kernels/flash_attention.py::flash_attention`` and counts its
  launches in ``flash_attention.launches``.
* :func:`tile_products` runs the bfloat16 kernel's two ``wgmma`` products
  on one 64-row tile, for the card tests.
* :func:`attention_torch` is the plain version: a masked softmax in
  float32 over chunks of queries, GQA by head grouping.  The wrapper uses
  it only for tensors on the CPU.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build
from .ref import NEG_INF, attention_mask

#: Head dims the CUDA kernel is compiled for.
HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)


def check_inputs(q, k, v, window: Optional[int] = None) -> None:
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"attention: q, k, v of one dtype, float32 or "
                        f"bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"attention: q (B, Hq, Tq, D), k/v (B, Hkv, Tk, D);"
                         f" got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[1]:
        raise ValueError(f"attention: k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (batch, head dim, Hq % Hkv)")
    if window is not None and window < 1:
        raise ValueError(f"attention: window must be >= 1, got {window}")
    if not (q.device == k.device == v.device):
        raise ValueError("attention: q, k, v on different devices")


def attention_torch(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    scale: Optional[float] = None,
                    q_chunk: int = 512) -> torch.Tensor:
    """Plain version: per chunk of ``q_chunk`` queries, float32 logits,
    masked weights ``exp(s - max)`` (0 where masked), divided by their
    sum (1 where the sum is 0)."""
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    rep = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kt = k.float().unsqueeze(2).transpose(-1, -2)     # (B, Hkv, 1, D, Tk)
    vf = v.float().unsqueeze(2)                       # (B, Hkv, 1, Tk, D)
    out = torch.empty_like(q)
    for c0 in range(0, tq, q_chunk):
        qc = q[:, :, c0:c0 + q_chunk].float()
        cq = qc.shape[2]
        s = torch.matmul(qc.reshape(b, hkv, rep, cq, d), kt) * scale
        mask = attention_mask(tq, tk, causal, window, q.device, c0, cq)
        s = s.masked_fill(~mask, NEG_INF)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * mask
        den = p.sum(dim=-1, keepdim=True)
        o = torch.matmul(p, vf) / torch.where(den == 0, 1.0, den)
        out[:, :, c0:c0 + cq] = o.reshape(b, hq, cq, d).to(q.dtype)
    return out


def _fits(t: torch.Tensor) -> bool:
    """Whether the kernel takes ``t`` as it is: unit stride along D and,
    in bfloat16, 16-byte aligned rows (pointer and strides)."""
    if t.stride(-1) != 1:
        return False
    if t.dtype != torch.bfloat16:
        return True
    return t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3])


def _launch(q, k, v, causal: bool, window: Optional[int],
            scale: float) -> torch.Tensor:
    """Run the CUDA kernel on CUDA tensors (raises on any failure)."""
    d = q.shape[3]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    # a fresh copy: .contiguous() returns a misaligned contiguous view as is
    q, k, v = (t if _fits(t) else t.clone(memory_format=torch.contiguous_format)
               for t in (q, k, v))
    out = torch.empty_like(q)     # q's strides when dense, else contiguous
    strides = (ctypes.c_longlong * 12)(
        *[s for t in (q, k, v, out) for s in t.stride()[:3]])
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_fwd
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
                   + [ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    b, hq, tq, _ = q.shape
    rc = fn(1 if q.dtype == torch.bfloat16 else 0, d, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), out.data_ptr(),
            strides,
            b, hq, k.shape[1], tq, k.shape[2], int(causal),
            -1 if window is None else int(window), float(scale),
            _build.stream_handle(q.device))
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    return out


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention forward.  CUDA tensors launch the kernel; CPU tensors
    run :func:`attention_torch`."""
    check_inputs(q, k, v, window)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[3])
    if not q.is_cuda:
        return attention_torch(q, k, v, causal=causal, window=window,
                               scale=scale)
    out = _launch(q, k, v, causal, window, scale)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def tile_products(q, k, v):
    """``(q k^T, bf16(q k^T) v)`` in float32 for contiguous ``(64, D)``
    bfloat16 CUDA tensors, through the bfloat16 kernel's shared-memory
    tiles and ``wgmma`` calls (a check of its descriptors and fragment
    layouts against ``torch.matmul``)."""
    d = q.shape[1]
    if (q.shape != (64, d) or k.shape != q.shape or v.shape != q.shape
            or d not in HEAD_DIMS or not q.is_cuda):
        raise ValueError("tile_products: q, k, v (64, D) CUDA tensors")
    q, k, v = (t.to(torch.bfloat16).clone(memory_format=torch.contiguous_format)
               for t in (q, k, v))     # fresh, so 16-byte aligned
    s = torch.empty((64, 64), dtype=torch.float32, device=q.device)
    o = torch.empty((64, d), dtype=torch.float32, device=q.device)
    fn = _build.load("flash_attention").flash_attention_tile_products
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6
    fn.restype = ctypes.c_int
    rc = fn(d, q.data_ptr(), k.data_ptr(), v.data_ptr(), s.data_ptr(),
            o.data_ptr(), _build.stream_handle(q.device))
    if rc != 0:
        raise RuntimeError(f"tile_products launch failed: CUDA error {rc}")
    return s, o
