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
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import rmsnorm_ref as rmsnorm_torch

DTYPES = (torch.float32, torch.bfloat16)


def check_inputs(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dtype not in DTYPES:
        raise TypeError(f"rmsnorm: float32 or bfloat16 input, got {x.dtype}")
    if x.dim() < 1 or w.shape != (x.shape[-1],):
        raise ValueError(f"rmsnorm: x (..., D) and w (D,), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.device != w.device:
        raise ValueError("rmsnorm: x and w on different devices")


def _launch(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """Run the CUDA kernel on CUDA tensors (raises on any failure)."""
    d = x.shape[-1]
    x2 = x.reshape(-1, d).contiguous()
    w32 = w.float().contiguous()
    out = torch.empty_like(x2)
    lib = _build.load("rmsnorm")
    fn = lib.rmsnorm_bf16 if x.dtype == torch.bfloat16 else lib.rmsnorm_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
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
