"""Row-wise RMSNorm: the CUDA kernel and its plain PyTorch version.

``y = x * rsqrt(mean(x^2) + eps) * (1 + w)`` per row of the ``(rows, D)``
view of ``x`` (``(..., D)``), in float32, written in ``x``'s dtype
(float32 or bfloat16); ``w`` is ``(D,)`` float32.

* :func:`rmsnorm` launches ``csrc/rmsnorm.cu`` for CUDA tensors: one
  pass with 16-byte vectors held in registers where the rows, ``w`` and
  the output start 16-byte aligned and ``D`` fills whole vectors, the
  scalar two-pass kernels otherwise (the source's launcher picks from
  ``D`` and the pointers; see its note).  It replaces the TPU kernel
  ``src/repro/kernels/rmsnorm.py::rmsnorm``.  It counts its launches in
  ``rmsnorm.launches``.
* :func:`rmsnorm_torch` is the plain version, a float32 row reduction
  (the oracle :func:`repro_torch.kernels.ref.rmsnorm_ref` itself).  The
  wrapper uses it only for tensors on the CPU.
* :func:`rmsnorm_bwd` launches the backward kernels of the same source
  (``rmsnorm_bwd_f32`` / ``_bf16``: dx in one pass over each row, with
  16-byte vectors held in registers where the rows are aligned as for the
  forward, and dw summed without atomics through per-block partial rows
  in a fixed order; two device kernels a call) and counts
  ``rmsnorm_bwd.launches``; :func:`rmsnorm_bwd_torch` is its plain
  version.  The reference has no backward kernel (its gradient is XLA's
  autodiff of the plain RMSNorm).
* :class:`RMSNormFunction` is the ``torch.autograd.Function`` whose
  forward is :func:`rmsnorm` and whose backward is :func:`rmsnorm_bwd`;
  ``ops.rmsnorm(..., impl="cuda")`` uses it when a gradient is wanted.
* Rows cut over ranks (a rank holds ``d`` of each row's ``width``
  columns, as Mamba2's gated norm on a rank's heads): :func:`rmsnorm_cut`
  launches ``rmsnorm_row_sums`` (each row's partial sum of squares, one
  float32 a row), hands the sums to ``reduce`` (the caller's all-reduce
  over the ranks) and launches ``rmsnorm_cut`` on the summed rows;
  :func:`rmsnorm_cut_bwd` likewise sums ``dy (1 + w) x`` and launches
  ``rmsnorm_cut_bwd`` (dx, and dw through partial rows as the backward's).
  They count ``rmsnorm_cut.launches`` and ``rmsnorm_cut_bwd.launches``;
  :class:`RMSNormCutFunction` pairs them.  Their plain versions are
  :func:`repro_torch.kernels.ref.rmsnorm_cut_ref` and
  :func:`rmsnorm_cut_bwd_torch`.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import compute_dtype, rmsnorm_cut_ref as rmsnorm_cut_torch, \
    rmsnorm_ref as rmsnorm_torch

#: The kernels' dtypes; float64 runs the plain versions only, when they
#: are asked for by name.
DTYPES = (torch.float32, torch.bfloat16)


def check_inputs(x: torch.Tensor, w: torch.Tensor, *,
                 plain: bool = False) -> None:
    """Raises on inputs the kernel does not take (``plain``: the plain
    version is asked for, and float64 is taken too)."""
    if x.dtype not in DTYPES + ((torch.float64,) if plain else ()):
        raise TypeError(f"rmsnorm: float32 or bfloat16 input (float64: "
                        f"impl='torch' only), got {x.dtype}")
    if x.dim() < 1 or w.shape != (x.shape[-1],):
        raise ValueError(f"rmsnorm: x (..., D) and w (D,), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.device != w.device:
        raise ValueError("rmsnorm: x and w on different devices")


_LIB = None


def _lib():
    """The built library, its C signatures set once."""
    global _LIB
    if _LIB is None:
        lib = _build.load("rmsnorm")
        ptr, tail = ctypes.c_void_p, [ctypes.c_longlong, ctypes.c_int,
                                      ctypes.c_float, ctypes.c_void_p]
        for fn in (lib.rmsnorm_f32, lib.rmsnorm_bf16):
            fn.argtypes = [ptr] * 3 + tail
            fn.restype = ctypes.c_int
        for fn in (lib.rmsnorm_bwd_f32, lib.rmsnorm_bwd_bf16):
            fn.argtypes = [ptr] * 6 + tail
            fn.restype = ctypes.c_int
        rows_d = [ctypes.c_longlong, ctypes.c_int]
        for fn in (lib.rmsnorm_row_sums_f32, lib.rmsnorm_row_sums_bf16):
            fn.argtypes = [ptr] * 4 + rows_d + [ptr]
            fn.restype = ctypes.c_int
        cut_tail = rows_d + [ctypes.c_float, ctypes.c_float, ptr]
        for fn in (lib.rmsnorm_cut_f32, lib.rmsnorm_cut_bf16):
            fn.argtypes = [ptr] * 4 + cut_tail
            fn.restype = ctypes.c_int
        for fn in (lib.rmsnorm_cut_bwd_f32, lib.rmsnorm_cut_bwd_bf16):
            fn.argtypes = [ptr] * 8 + cut_tail
            fn.restype = ctypes.c_int
        lib.rmsnorm_bwd_parts.argtypes = [ctypes.c_longlong, ctypes.c_int]
        lib.rmsnorm_bwd_parts.restype = ctypes.c_longlong
        _LIB = lib
    return _LIB


def _launch(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """Run the CUDA kernel on CUDA tensors (raises on any failure)."""
    d = x.shape[-1]
    x2 = x.reshape(-1, d).contiguous()
    w32 = w.float().contiguous()
    out = torch.empty_like(x2)
    lib = _lib()
    fn = lib.rmsnorm_bf16 if x.dtype == torch.bfloat16 else lib.rmsnorm_f32
    rc = fn(x2.data_ptr(), w32.data_ptr(), out.data_ptr(), x2.shape[0], d,
            float(eps), _build.stream_handle(x.device))
    if rc != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed: CUDA error {rc}")
    return out.view(x.shape)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm of ``x`` over its last dim.  CUDA tensors launch the
    kernel; CPU tensors run :func:`rmsnorm_torch`."""
    check_inputs(x, w)
    if not x.is_cuda:
        return rmsnorm_torch(x, w, eps=eps)
    out = _launch(x, w, eps)
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0


def rmsnorm_bwd_torch(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor, *,
                      eps: float = 1e-6):
    """Plain backward of :func:`rmsnorm_torch`: ``(dx, dw)``, dx in x's
    dtype and dw float32 (float64 for float64 x), computed in float32
    with r = rsqrt(mean(x^2) +
    eps): ``dx = r (1 + w) dy - x r^3 / D * sum(dy (1 + w) x)``, ``dw =
    sum over rows of dy x r``."""
    d = x.shape[-1]
    ct = compute_dtype(x)
    xf, gf = x.to(ct), dy.to(ct)
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    gw = gf * (1.0 + w.to(ct))
    dot = torch.sum(gw * xf, dim=-1, keepdim=True)
    dx = r * gw - xf * (r * r * r) * dot / d
    dw = (gf * xf * r).reshape(-1, d).sum(0)
    return dx.to(x.dtype), dw


def _launch_bwd(x, w, dy, eps: float):
    d = x.shape[-1]
    x2 = x.reshape(-1, d).contiguous()
    g2 = dy.reshape(-1, d).contiguous()
    w32 = w.float().contiguous()
    lib = _lib()
    parts = lib.rmsnorm_bwd_parts(x2.shape[0], d)
    if parts <= 0 and x2.shape[0] > 0:
        raise ValueError(f"rmsnorm_bwd: rows of {d} are too long for the "
                         f"kernel (at most 16,384)")
    dx = torch.empty_like(x2)
    part = torch.empty((max(parts, 1), d), dtype=torch.float32,
                       device=x.device)
    dw = torch.empty((d,), dtype=torch.float32, device=x.device)
    fn = lib.rmsnorm_bwd_bf16 if x.dtype == torch.bfloat16 \
        else lib.rmsnorm_bwd_f32
    rc = fn(x2.data_ptr(), w32.data_ptr(), g2.data_ptr(), dx.data_ptr(),
            part.data_ptr(), dw.data_ptr(), x2.shape[0], d, float(eps),
            _build.stream_handle(x.device))
    if rc != 0:
        raise RuntimeError(f"rmsnorm_bwd kernel launch failed: CUDA error "
                           f"{rc}")
    return dx.view(x.shape), dw


def rmsnorm_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor, *,
                eps: float = 1e-6):
    """Backward of :func:`rmsnorm`: ``(dx, dw)``.  CUDA tensors launch the
    kernel; CPU tensors run :func:`rmsnorm_bwd_torch`."""
    check_inputs(x, w)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"rmsnorm_bwd: dy {tuple(dy.shape)} {dy.dtype} "
                         f"does not match x {tuple(x.shape)} {x.dtype}")
    if not x.is_cuda:
        return rmsnorm_bwd_torch(x, w, dy, eps=eps)
    out = _launch_bwd(x, w, dy, eps)
    rmsnorm_bwd.launches += 1
    return out


rmsnorm_bwd.launches = 0


class RMSNormFunction(torch.autograd.Function):
    """RMSNorm with the backward kernel: forward :func:`rmsnorm`, backward
    :func:`rmsnorm_bwd` (dw returned in w's dtype)."""

    @staticmethod
    def forward(ctx, x, w, eps: float):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return rmsnorm(x, w, eps=eps)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = rmsnorm_bwd(x, w, dy, eps=ctx.eps)
        return dx, dw.to(w.dtype), None


# ---------------------------------------------------------------------------
# Rows cut over ranks
# ---------------------------------------------------------------------------
def _bf16(x: torch.Tensor) -> bool:
    return x.dtype == torch.bfloat16


def _row_sums(x2, w32, g2=None) -> torch.Tensor:
    """Each row's partial sum on the card: ``sum x^2`` (``g2`` None) or
    ``sum g (1 + w) x``, float32 (rows,)."""
    out = torch.empty((x2.shape[0],), dtype=torch.float32, device=x2.device)
    lib = _lib()
    fn = lib.rmsnorm_row_sums_bf16 if _bf16(x2) else lib.rmsnorm_row_sums_f32
    rc = fn(x2.data_ptr(), w32.data_ptr(),
            None if g2 is None else g2.data_ptr(), out.data_ptr(),
            x2.shape[0], x2.shape[1], _build.stream_handle(x2.device))
    if rc != 0:
        raise RuntimeError(f"rmsnorm_row_sums launch failed: CUDA error {rc}")
    return out


def _check_cut(x, w, width: int) -> None:
    check_inputs(x, w)
    if width < x.shape[-1]:
        raise ValueError(f"rmsnorm_cut: a row of {width} columns cannot "
                         f"hold the {x.shape[-1]} given")


def _cut(x, w, reduce, width: int, eps: float):
    """:func:`rmsnorm_cut`: ``(y, ss)``, ss the rows' summed squares
    ((rows,), float32; the compute dtype on the plain version, which CPU
    tensors run, uncounted)."""
    d = x.shape[-1]
    if not x.is_cuda:
        xf = x.to(compute_dtype(x)).reshape(-1, d)
        ss = reduce(torch.sum(xf * xf, dim=-1))
        r = torch.rsqrt(ss[:, None] / width + eps)
        y = (xf * r * (1.0 + w.to(xf.dtype))).to(x.dtype)
        return y.view(x.shape), ss
    x2 = x.reshape(-1, d).contiguous()
    w32 = w.float().contiguous()
    ss = reduce(_row_sums(x2, w32)).contiguous()
    out = torch.empty_like(x2)
    lib = _lib()
    fn = lib.rmsnorm_cut_bf16 if _bf16(x) else lib.rmsnorm_cut_f32
    rc = fn(x2.data_ptr(), w32.data_ptr(), ss.data_ptr(), out.data_ptr(),
            x2.shape[0], d, float(width), float(eps),
            _build.stream_handle(x.device))
    if rc != 0:
        raise RuntimeError(f"rmsnorm_cut launch failed: CUDA error {rc}")
    rmsnorm_cut.launches += 1
    return out.view(x.shape), ss


def rmsnorm_cut(x: torch.Tensor, w: torch.Tensor, reduce, *, width: int,
                eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm of rows whose ``width`` columns are cut over ranks: ``x``
    (..., d) and ``w`` (d,) are this rank's columns, ``reduce`` sums a
    float32 (rows,) tensor over the ranks (an all-reduce).  ``y = x *
    rsqrt(ss / width + eps) * (1 + w)``, ``ss`` each row's sum of squares
    over all its columns.  CUDA tensors launch the kernels; CPU tensors
    run :func:`rmsnorm_cut_torch`."""
    _check_cut(x, w, width)
    if not x.is_cuda:
        return rmsnorm_cut_torch(x, w, reduce, width=width, eps=eps)
    return _cut(x, w, reduce, width, eps)[0]


rmsnorm_cut.launches = 0


def rmsnorm_cut_bwd_torch(x, w, dy, ss, reduce, *, width: int,
                          eps: float = 1e-6):
    """Plain backward of :func:`rmsnorm_cut_torch` given the rows' summed
    squares ``ss`` (rows,): ``(dx, dw)``, with r = rsqrt(ss / width +
    eps), ``dx = r (1 + w) dy - x r^3 / width * reduce(sum(dy (1 + w)
    x))``, ``dw = sum over rows of dy x r``."""
    d = x.shape[-1]
    ct = compute_dtype(x)
    xf, gf = x.to(ct).reshape(-1, d), dy.to(ct).reshape(-1, d)
    r = torch.rsqrt(ss.to(ct).reshape(-1, 1) / width + eps)
    gw = gf * (1.0 + w.to(ct))
    dot = reduce(torch.sum(gw * xf, dim=-1)).reshape(-1, 1)
    dx = r * gw - xf * (r * r * r) * dot / width
    dw = (gf * xf * r).sum(0)
    return dx.to(x.dtype).view(x.shape), dw


def rmsnorm_cut_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                    ss: torch.Tensor, reduce, *, width: int,
                    eps: float = 1e-6):
    """Backward of :func:`rmsnorm_cut`: ``(dx, dw)`` from the rows' summed
    squares ``ss``; the rows' ``dy (1 + w) x`` sums go through ``reduce``.
    CUDA tensors launch the kernels; CPU tensors run
    :func:`rmsnorm_cut_bwd_torch`."""
    _check_cut(x, w, width)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"rmsnorm_cut_bwd: dy {tuple(dy.shape)} {dy.dtype} "
                         f"does not match x {tuple(x.shape)} {x.dtype}")
    if not x.is_cuda:
        return rmsnorm_cut_bwd_torch(x, w, dy, ss, reduce, width=width,
                                     eps=eps)
    d = x.shape[-1]
    x2 = x.reshape(-1, d).contiguous()
    g2 = dy.reshape(-1, d).contiguous()
    w32 = w.float().contiguous()
    dot = reduce(_row_sums(x2, w32, g2)).contiguous()
    lib = _lib()
    parts = lib.rmsnorm_bwd_parts(x2.shape[0], d)
    if parts <= 0 and x2.shape[0] > 0:
        raise ValueError(f"rmsnorm_cut_bwd: rows of {d} are too long for the "
                         f"kernel (at most 16,384)")
    dx = torch.empty_like(x2)
    part = torch.empty((max(parts, 1), d), dtype=torch.float32,
                       device=x.device)
    dw = torch.empty((d,), dtype=torch.float32, device=x.device)
    fn = lib.rmsnorm_cut_bwd_bf16 if _bf16(x) else lib.rmsnorm_cut_bwd_f32
    rc = fn(x2.data_ptr(), w32.data_ptr(), g2.data_ptr(),
            ss.float().contiguous().data_ptr(), dot.data_ptr(), dx.data_ptr(),
            part.data_ptr(), dw.data_ptr(), x2.shape[0], d, float(width),
            float(eps), _build.stream_handle(x.device))
    if rc != 0:
        raise RuntimeError(f"rmsnorm_cut_bwd launch failed: CUDA error {rc}")
    rmsnorm_cut_bwd.launches += 1
    return dx.view(x.shape), dw


rmsnorm_cut_bwd.launches = 0


class RMSNormCutFunction(torch.autograd.Function):
    """The cut RMSNorm with its backward kernels: forward
    :func:`rmsnorm_cut` (one ``reduce`` of the squares' sums), backward
    :func:`rmsnorm_cut_bwd` (one ``reduce`` of the rows' dot products; dw
    returned in w's dtype)."""

    @staticmethod
    def forward(ctx, x, w, reduce, width: int, eps: float):
        y, ss = _cut(x, w, reduce, width, eps)
        ctx.save_for_backward(x, w, ss)
        ctx.reduce, ctx.width, ctx.eps = reduce, width, eps
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, ss = ctx.saved_tensors
        dx, dw = rmsnorm_cut_bwd(x, w, dy.contiguous(), ss, ctx.reduce,
                                 width=ctx.width, eps=ctx.eps)
        return dx, dw.to(w.dtype), None, None, None
