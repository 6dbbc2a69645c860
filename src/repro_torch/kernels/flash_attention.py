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
* With ``return_lse=True`` the forward also returns each row's natural
  log-sum-exp of its scaled scores, float32 ``(B, Hq, Tq)``, ``-inf`` for
  a row that sees no key (the kernel writes it; serving asks for none).
* :func:`flash_attention_bwd` launches the backward kernels of the same
  source (FlashAttention-2's scheme, head dims in :data:`BWD_HEAD_DIMS`;
  no atomics, so a backward gives the same bits in every run) and counts
  ``flash_attention_bwd.launches`` (those at D 256 again in
  ``flash_attention_bwd.d256_launches``).  bfloat16 runs all five
  products on the tensor cores (``wgmma``, P and dS rounded to bfloat16
  as their A operands, float32 sums); at D 256 the two warpgroups of a
  dK/dV block take one product each (S^T or dP^T) and trade the
  fragments through shared memory, so no product runs twice.  float32
  runs on the float32 cores, register-tiled, with Q/dO and K/V streamed
  through 16-byte ``cp.async`` copies.  Both copy a tensor whose rows do
  not start 16-byte aligned.  Where the dK/dV grid would leave SMs idle,
  :func:`attention_bwd_plan` splits each KV head's query heads into G
  groups, a block each; the blocks write float32 partial sums that one
  kernel adds in group order.  :func:`attention_bwd_torch` is its plain
  version.  The reference has no backward kernel: its gradients are
  XLA's autodiff of the plain attention.
* :func:`bwd_tile_products` runs the bfloat16 backward's register-A
  ``wgmma`` on one tile, for the card tests.
* :class:`FlashAttentionFunction` is the ``torch.autograd.Function``
  (forward with ``lse``, backward :func:`flash_attention_bwd`) that
  ``ops.attention(..., impl="cuda")`` uses when a gradient is wanted.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional

import torch

from . import _build
from .ref import NEG_INF, attention_mask, compute_dtype

#: Head dims the CUDA kernel is compiled for.
HEAD_DIMS = (16, 32, 64, 128, 256)
#: Head dims of the backward kernel.
BWD_HEAD_DIMS = (16, 32, 64, 128, 256)
#: The kernels' dtypes; float64 runs the plain version only, when it is
#: asked for by name.
DTYPES = (torch.float32, torch.bfloat16)


def check_inputs(q, k, v, window: Optional[int] = None, *,
                 plain: bool = False) -> None:
    """Raises on inputs the kernel does not take (``plain``: the plain
    version is asked for, and float64 is taken too)."""
    dtypes = DTYPES + ((torch.float64,) if plain else ())
    if q.dtype not in dtypes or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"attention: q, k, v of one dtype, float32 or "
                        f"bfloat16 (float64: impl='torch' only); got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
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
                    q_chunk: int = 512, return_lse: bool = False):
    """Plain version: per chunk of ``q_chunk`` queries, float32 logits
    (float64 for float64 inputs), masked weights ``exp(s - max)`` (0
    where masked), divided by their sum (1 where the sum is 0).
    ``return_lse``: also the rows' log-sum-exp, ``(out, lse)``."""
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    rep = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    ct = compute_dtype(q)
    kt = k.to(ct).unsqueeze(2).transpose(-1, -2)      # (B, Hkv, 1, D, Tk)
    vf = v.to(ct).unsqueeze(2)                        # (B, Hkv, 1, Tk, D)
    out = torch.empty_like(q)
    lse = (torch.empty((b, hq, tq), dtype=ct, device=q.device)
           if return_lse else None)
    for c0 in range(0, tq, q_chunk):
        qc = q[:, :, c0:c0 + q_chunk].to(ct)
        cq = qc.shape[2]
        s = torch.matmul(qc.reshape(b, hkv, rep, cq, d), kt) * scale
        mask = attention_mask(tq, tk, causal, window, q.device, c0, cq)
        s = s.masked_fill(~mask, NEG_INF)
        mx = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - mx) * mask
        den = p.sum(dim=-1, keepdim=True)
        o = torch.matmul(p, vf) / torch.where(den == 0, 1.0, den)
        out[:, :, c0:c0 + cq] = o.reshape(b, hq, cq, d).to(q.dtype)
        if return_lse:
            row = torch.where(den > 0, mx + torch.log(den), -math.inf)
            lse[:, :, c0:c0 + cq] = row.reshape(b, hq, cq).detach()
    return (out, lse) if return_lse else out


def attention_bwd_torch(q, k, v, o, do, lse, *, causal: bool = True,
                        window: Optional[int] = None,
                        scale: Optional[float] = None, q_chunk: int = 512):
    """Plain backward, FlashAttention-2's arithmetic in float32 (or
    float64 for float64 inputs) per chunk of queries: ``delta = rowsum(dO
    O)``, ``P = exp(S scale - lse)`` (0 where masked), ``dS = P (dO V^T -
    delta)``; ``dQ = dS K scale``, ``dK = dS^T Q scale``, ``dV = P^T dO``,
    the GQA group summed.  Returns ``(dq, dk, dv)`` in the inputs'
    dtypes."""
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    rep = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    ct = compute_dtype(q)
    kf = k.to(ct).unsqueeze(2)                         # (B, Hkv, 1, Tk, D)
    vf = v.to(ct).unsqueeze(2)
    delta = (do.to(ct) * o.to(ct)).sum(-1)             # (B, Hq, Tq)
    dq = torch.empty_like(q)
    dk = torch.zeros(kf.shape[:2] + kf.shape[3:], dtype=ct, device=q.device)
    dv = torch.zeros_like(dk)
    for c0 in range(0, tq, q_chunk):
        qc = q[:, :, c0:c0 + q_chunk].to(ct)
        cq = qc.shape[2]
        qg = qc.reshape(b, hkv, rep, cq, d)
        gg = do[:, :, c0:c0 + cq].to(ct).reshape(b, hkv, rep, cq, d)
        lg = lse[:, :, c0:c0 + cq].to(ct).reshape(b, hkv, rep, cq, 1)
        dg = delta[:, :, c0:c0 + cq].reshape(b, hkv, rep, cq, 1)
        mask = attention_mask(tq, tk, causal, window, q.device, c0, cq)
        s = torch.matmul(qg, kf.transpose(-1, -2)) * scale
        p = torch.where(mask, torch.exp(s - lg), 0.0)
        ds = p * (torch.matmul(gg, vf.transpose(-1, -2)) - dg)
        dv += torch.matmul(p.transpose(-1, -2), gg).sum(2)
        dk += torch.matmul(ds.transpose(-1, -2), qg).sum(2) * scale
        dq[:, :, c0:c0 + cq] = (torch.matmul(ds, kf) * scale).reshape(
            b, hq, cq, d).to(q.dtype)
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def _fits(t: torch.Tensor, aligned: bool = False) -> bool:
    """Whether the kernel takes ``t`` as it is: unit stride along D and,
    in bfloat16 (or where ``aligned`` asks for it), 16-byte aligned rows
    (pointer and strides)."""
    if t.stride(-1) != 1:
        return False
    if t.dtype != torch.bfloat16 and not aligned:
        return True
    vec = 16 // t.element_size()
    return t.data_ptr() % 16 == 0 and all(s % vec == 0
                                          for s in t.stride()[:3])


def _launch(q, k, v, causal: bool, window: Optional[int], scale: float,
            return_lse: bool = False):
    """Run the CUDA kernel on CUDA tensors (raises on any failure);
    ``(out, lse)``, lse None unless asked for."""
    d = q.shape[3]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    # a fresh copy: .contiguous() returns a misaligned contiguous view as is
    q, k, v = (t if _fits(t) else t.clone(memory_format=torch.contiguous_format)
               for t in (q, k, v))
    out = torch.empty_like(q)     # q's strides when dense, else contiguous
    b, hq, tq, _ = q.shape
    lse = (torch.empty((b, hq, tq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    strides = (ctypes.c_longlong * 12)(
        *[s for t in (q, k, v, out) for s in t.stride()[:3]])
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_fwd
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 5
                   + [ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    rc = fn(1 if q.dtype == torch.bfloat16 else 0, d, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), strides,
            b, hq, k.shape[1], tq, k.shape[2], int(causal),
            -1 if window is None else int(window), float(scale),
            _build.stream_handle(q.device))
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    return out, lse


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    scale: Optional[float] = None,
                    return_lse: bool = False):
    """Attention forward.  CUDA tensors launch the kernel; CPU tensors
    run :func:`attention_torch`.  ``return_lse``: ``(out, lse)``."""
    check_inputs(q, k, v, window)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[3])
    if not q.is_cuda:
        return attention_torch(q, k, v, causal=causal, window=window,
                               scale=scale, return_lse=return_lse)
    out, lse = _launch(q, k, v, causal, window, scale, return_lse)
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0


#: Streaming multiprocessors of an H100 SXM: the plan's default card (on a
#: card it takes the device's own count).
SMS = 132
#: Shared memory a block may take (bytes).
SMEM_LIMIT = 232_448


@dataclasses.dataclass(frozen=True)
class BwdTiles:
    """The backward's tiles at one head dim and dtype, as the source's
    ``Cfg`` sets them: the dK/dV kernel's keys a block and query rows a
    streamed tile, the dQ kernel's query rows a block and keys a streamed
    tile, each kernel's shared memory a block (bytes), the blocks an SM
    holds, and whether the dK/dV kernel takes query-head groups."""
    kv_keys: int
    kv_rows: int
    dq_rows: int
    dq_keys: int
    kv_smem: int
    dq_smem: int
    per_sm: int
    takes_groups: bool


def bwd_tiles(d: int, dtype) -> BwdTiles:
    """The tiles of the backward's instance at head dim ``d`` (float32 or
    bfloat16): a mirror of ``wgb::Cfg`` and ``bwd::Cfg`` in
    ``csrc/flash_attention.cu``."""
    if dtype == torch.bfloat16:
        dp = max(d, 64)
        pair = d > 128                   # bwd_dkdv_wgmma_pair
        bkv, bq = (64, 32) if pair else (128, 64)
        stages = 4
        ring_end = 2 * bkv * dp * 2 + stages * 2 * bq * dp * 2
        kv_xch = ring_end + stages * 2 * bq * 4   # after lse, delta
        kv_bar = kv_xch + (2 * 2 * 64 * bq * 4 if pair else 0)
        bk, dq_stages = (32, 3) if pair else (64, 4)
        dq_bar = 2 * 128 * dp * 2 + dq_stages * 2 * bk * dp * 2
        return BwdTiles(bkv, bq, 128, bk, kv_bar + stages * 2 * 8 + 1024,
                        dq_bar + dq_stages * 2 * 8 + 1024, 1, pair)
    bk, bq = 32, (32 if d > 128 else 64)
    ld, lp = d + 4, bk + 4
    q_stage, k_stage = 2 * bq * ld + 2 * bq, 2 * bk * ld
    return BwdTiles(bk, bq, bq, bk,
                    4 * (2 * bk * ld + 2 * q_stage + 2 * bq * lp),
                    4 * (q_stage + 2 * k_stage + 2 * bq * lp), 1, True)


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """How the backward launches: ``groups`` (G) query-head groups a KV
    head in the dK/dV grid, its ``blocks`` at G = 1, the ``wave`` of
    blocks the card holds at once, and the instance's ``tiles``."""
    groups: int
    blocks: int
    wave: int
    tiles: BwdTiles


@functools.lru_cache(maxsize=1024)
def attention_bwd_plan(b: int, hq: int, hkv: int, tq: int, tk: int, d: int,
                       dtype, sms: int = SMS) -> BwdPlan:
    """G for the dK/dV kernel: the largest divisor of ``hq // hkv`` whose
    blocks (key tiles x Hkv x B x G) still fit one wave of ``sms`` SMs;
    1 where the grid fills a wave already, or the instance takes no
    groups (bfloat16 at D <= 128).  At recurrentgemma-9b's training shape
    in bfloat16 (1 x 16/1 x 4,096, D 256: 64 key tiles) G is 2, 128
    blocks."""
    tiles = bwd_tiles(d, dtype)
    rep = hq // hkv
    blocks = -(-tk // tiles.kv_keys) * hkv * b
    wave = sms * tiles.per_sm
    groups = 1
    if tiles.takes_groups:
        groups = max(g for g in range(1, rep + 1)
                     if rep % g == 0 and (g == 1 or blocks * g <= wave))
    return BwdPlan(groups, blocks, wave, tiles)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    """The SMs of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch_bwd(q, k, v, o, do, lse, causal: bool, window: Optional[int],
                scale: float):
    d = q.shape[3]
    # the kernels' 16-byte cp.async copies: aligned rows (an expanded
    # gradient is copied too)
    q, k, v, o, do = (
        t if _fits(t, aligned=True) and t.numel()
        else t.clone(memory_format=torch.contiguous_format)
        for t in (q, k, v, o, do))
    lse = lse.contiguous()
    b, hq, tq, _ = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    plan = attention_bwd_plan(b, hq, hkv, tq, tk, d, q.dtype,
                              _sms(q.device.index))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    f32 = dict(dtype=torch.float32, device=q.device)
    delta = torch.empty((b, hq, tq), **f32)
    part = (torch.empty((2, plan.groups, b, hkv, tk, d), **f32)
            if plan.groups > 1 else None)
    strides = (ctypes.c_longlong * 24)(
        *[s for t in (q, k, v, o, do, dq, dk, dv) for s in t.stride()[:3]])
    fn = _build.load("flash_attention").flash_attention_bwd
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 11
                   + [ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    rc = fn(1 if q.dtype == torch.bfloat16 else 0, d, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), None if part is None else part.data_ptr(),
            plan.groups, strides, b, hq, hkv, tq, tk, int(causal),
            -1 if window is None else int(window), float(scale),
            _build.stream_handle(q.device))
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA "
                           f"error {rc}")
    flash_attention_bwd.last_plan = plan
    return dq, dk, dv


def flash_attention_bwd(q, k, v, o, do, lse, *, causal: bool = True,
                        window: Optional[int] = None,
                        scale: Optional[float] = None):
    """Attention backward from the forward's ``o`` and ``lse``: ``(dq, dk,
    dv)`` in q's and k's / v's layouts and dtype.  CUDA tensors launch the
    kernel (head dims in :data:`BWD_HEAD_DIMS`); CPU tensors run
    :func:`attention_bwd_torch`."""
    check_inputs(q, k, v, window)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} and do "
                         f"{tuple(do.shape)} must be q's {tuple(q.shape)}")
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[3])
    if not q.is_cuda:
        return attention_bwd_torch(q, k, v, o, do, lse, causal=causal,
                                   window=window, scale=scale)
    if q.shape[3] not in BWD_HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: head dim {q.shape[3]} not in "
                         f"{BWD_HEAD_DIMS}")
    out = _launch_bwd(q, k, v, o, do.to(q.dtype), lse, causal, window, scale)
    flash_attention_bwd.launches += 1
    if q.shape[3] == 256:
        flash_attention_bwd.d256_launches += 1
    return out


flash_attention_bwd.launches = 0
flash_attention_bwd.d256_launches = 0
#: The :class:`BwdPlan` of the last launch (None before one).
flash_attention_bwd.last_plan = None


class FlashAttentionFunction(torch.autograd.Function):
    """Attention with the backward kernel: forward :func:`flash_attention`
    with ``lse``, backward :func:`flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int],
                scale: Optional[float]):
        out, lse = flash_attention(q, k, v, causal=causal, window=window,
                                   scale=scale, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, scale = ctx.args
        dq, dk, dv = flash_attention_bwd(q, k, v, out, do, lse,
                                         causal=causal, window=window,
                                         scale=scale)
        return dq, dk, dv, None, None, None


def bwd_tile_products(a, b):
    """``bf16(a) b`` in float32 for a ``(64, 64)`` and b ``(64, D)`` CUDA
    tensors, through the bfloat16 backward's register-A ``wgmma`` with b
    the MN-major operand (the shape of its products P^T dO, dS^T Q and dS
    K a warpgroup; a check of their descriptors and fragment layouts
    against ``torch.matmul``)."""
    d = b.shape[1] if b.dim() == 2 else 0
    if (a.shape != (64, 64) or b.shape != (64, d) or d not in BWD_HEAD_DIMS
            or not (a.is_cuda and b.is_cuda)):
        raise ValueError("bwd_tile_products: a (64, 64) and b (64, D) CUDA "
                         "tensors, D in BWD_HEAD_DIMS")
    a = a.to(torch.float32).clone(memory_format=torch.contiguous_format)
    b = b.to(torch.bfloat16).clone(memory_format=torch.contiguous_format)
    out = torch.empty((64, d), dtype=torch.float32, device=b.device)
    fn = _build.load("flash_attention").flash_attention_bwd_tile_products
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    rc = fn(d, a.data_ptr(), b.data_ptr(), out.data_ptr(),
            _build.stream_handle(b.device))
    if rc != 0:
        raise RuntimeError(f"bwd_tile_products launch failed: CUDA error "
                           f"{rc}")
    return out


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
