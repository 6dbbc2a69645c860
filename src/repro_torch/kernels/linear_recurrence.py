"""Diagonal linear recurrence (the RG-LRU core): the CUDA kernel and its
plain PyTorch version.

``h_t = a_t * h_{t-1} + b_t`` over ``(B, T, D)`` from ``h_0 = 0``,
computed in float32 and written in b's dtype; a and b are float32 or
bfloat16, of one dtype.

* :func:`linear_recurrence` launches ``csrc/linear_recurrence.cu`` for
  CUDA tensors (one thread per (batch, channel) walking T in the
  sequential oracle's order, fed from a four-stage shared-memory ring of
  32 KB tiles of a and b).  It replaces
  the TPU kernel ``src/repro/kernels/linear_recurrence.py::linear_recurrence``
  and counts its launches in ``linear_recurrence.launches``.
* :func:`linear_recurrence_torch` is the plain version, the TPU kernel's
  blocked Hillis–Steele scan written out over all time blocks at once,
  then the carry from block to block.  The wrapper uses it only for
  tensors on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

DTYPES = (torch.float32, torch.bfloat16)
#: Time block of the plain version's scan (the TPU kernel's ``block_t``).
BLOCK_T = 256


def check_inputs(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dtype not in DTYPES or b.dtype != a.dtype:
        raise TypeError(f"linear_recurrence: a and b of one dtype, float32 "
                        f"or bfloat16; got {a.dtype}, {b.dtype}")
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"linear_recurrence: a and b (B, T, D) of one "
                         f"shape; got {tuple(a.shape)}, {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError("linear_recurrence: a and b on different devices")


def linear_recurrence_torch(a: torch.Tensor, b: torch.Tensor, *,
                            block_t: int = BLOCK_T) -> torch.Tensor:
    """Plain version.  T is padded with identity maps (a = 1, b = 0) to a
    multiple of the block; within every block at once, ``log2(block)``
    Hillis–Steele steps compose each step's map with the one ``k`` before
    it (``a, b = a_s * a, b_s * a + b``); then block by block
    ``h = a * h_carry + b``."""
    bb, t, d = a.shape
    bt = min(block_t, t)
    nb = -(-t // bt)
    pad = nb * bt - t
    a32 = torch.nn.functional.pad(a.float(), (0, 0, 0, pad), value=1.0)
    b32 = torch.nn.functional.pad(b.float(), (0, 0, 0, pad))
    a32 = a32.view(bb, nb, bt, d)
    b32 = b32.view(bb, nb, bt, d)
    k = 1
    while k < bt:
        a_s = torch.cat([torch.ones_like(a32[:, :, :k]), a32[:, :, :-k]], 2)
        b_s = torch.cat([torch.zeros_like(b32[:, :, :k]), b32[:, :, :-k]], 2)
        a32, b32 = a_s * a32, b_s * a32 + b32
        k *= 2
    out = torch.empty_like(b32)
    h = torch.zeros_like(b32[:, 0, :1])               # (B, 1, D) carry
    for j in range(nb):
        out[:, j] = a32[:, j] * h + b32[:, j]
        h = out[:, j, -1:]
    return out.view(bb, nb * bt, d)[:, :t].to(b.dtype)


def _launch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Run the CUDA kernel on CUDA tensors (raises on any failure)."""
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty_like(b)
    lib = _build.load("linear_recurrence")
    fn = (lib.linear_recurrence_bf16 if a.dtype == torch.bfloat16
          else lib.linear_recurrence_f32)
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    bb, t, d = a.shape
    rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), bb, t, d,
            _build.stream_handle(a.device))
    if rc != 0:
        raise RuntimeError(f"linear_recurrence kernel launch failed: CUDA "
                           f"error {rc}")
    return out


def linear_recurrence(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t h_{t-1} + b_t``.  CUDA tensors launch the kernel; CPU
    tensors run :func:`linear_recurrence_torch`."""
    check_inputs(a, b)
    if not a.is_cuda:
        return linear_recurrence_torch(a, b)
    out = _launch(a, b)
    linear_recurrence.launches += 1
    return out


linear_recurrence.launches = 0
