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
* :func:`linear_recurrence_bwd` launches the backward kernel of the same
  source for CUDA tensors and counts ``linear_recurrence_bwd.launches``:
  from the forward's ``h`` and the output gradient ``dh``, the reverse
  scan ``g_t = dh_t + a_{t+1} g_{t+1}``, then ``db_t = g_t`` and ``da_t =
  g_t h_{t-1}`` (``h_0 = 0``), in float32.  The reference has no backward
  kernel: its gradients are XLA's autodiff of the sequential oracle.
  :func:`linear_recurrence_bwd_torch` is its plain version.
* :class:`LinearRecurrenceFunction` is the ``torch.autograd.Function``
  (forward :func:`linear_recurrence`, backward
  :func:`linear_recurrence_bwd`) that ``ops.linear_recurrence(...,
  impl="cuda")`` uses when a gradient is wanted.  It saves ``a`` and the
  output ``h``, in b's dtype: in bfloat16, ``da`` is formed from ``h``
  as the forward rounded it (2^-9 relative a term against the float32
  ``h`` that the reference's autodiff keeps), which costs ``da`` a
  relative error of about 4e-3; the tests hold bfloat16 ``da`` at rtol
  2e-2.  Recomputing ``h`` in float32 would cost a forward pass in the
  backward, and the models feed the recurrence float32 ``a`` and ``b``
  (``models/rglru.py``), where ``h`` is exact.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import compute_dtype

DTYPES = (torch.float32, torch.bfloat16)
#: The plain versions also compute in float64, when asked for by name.
PLAIN_DTYPES = DTYPES + (torch.float64,)
#: Time block of the plain version's scan (the TPU kernel's ``block_t``).
BLOCK_T = 256


def check_inputs(a: torch.Tensor, b: torch.Tensor, *,
                 plain: bool = False) -> None:
    """Raises on inputs the kernel does not take (``plain``: the plain
    version is asked for, and float64 is taken too)."""
    if (a.dtype not in (PLAIN_DTYPES if plain else DTYPES)
            or b.dtype != a.dtype):
        raise TypeError(f"linear_recurrence: a and b of one dtype, float32 "
                        f"or bfloat16 (float64: impl='torch' only); got "
                        f"{a.dtype}, {b.dtype}")
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
    ``h = a * h_carry + b``.  Float32 arithmetic (float64 for float64
    inputs)."""
    bb, t, d = a.shape
    bt = min(block_t, t)
    nb = -(-t // bt)
    pad = nb * bt - t
    ct = compute_dtype(a)
    a32 = torch.nn.functional.pad(a.to(ct), (0, 0, 0, pad), value=1.0)
    b32 = torch.nn.functional.pad(b.to(ct), (0, 0, 0, pad))
    a32 = a32.view(bb, nb, bt, d)
    b32 = b32.view(bb, nb, bt, d)
    k = 1
    while k < bt:
        a_s = torch.cat([torch.ones_like(a32[:, :, :k]), a32[:, :, :-k]], 2)
        b_s = torch.cat([torch.zeros_like(b32[:, :, :k]), b32[:, :, :-k]], 2)
        a32, b32 = a_s * a32, b_s * a32 + b32
        k *= 2
    blocks = []                  # out of place, so autograd can record it
    h = torch.zeros_like(b32[:, 0, :1])               # (B, 1, D) carry
    for j in range(nb):
        blocks.append(a32[:, j] * h + b32[:, j])
        h = blocks[-1][:, -1:]
    return torch.cat(blocks, 1)[:, :t].to(b.dtype)


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


def linear_recurrence_bwd_torch(a: torch.Tensor, h: torch.Tensor,
                                dh: torch.Tensor):
    """Plain backward from the forward's output ``h``: the reverse scan
    ``g_t = dh_t + a_{t+1} g_{t+1}`` is the forward recurrence run
    backwards in time over the shifted decays (``a_{T+1} = 0``), through
    :func:`linear_recurrence_torch`; then ``db = g`` and ``da_t = g_t
    h_{t-1}`` (``h_0 = 0``).  Float32 arithmetic (float64 for float64
    inputs); returns ``(da, db)`` in a's dtype."""
    ct = compute_dtype(a)
    a_next = torch.cat([a[:, 1:].to(ct), torch.zeros_like(a[:, :1], dtype=ct)],
                       1)
    g = linear_recurrence_torch(a_next.flip(1), dh.to(ct).flip(1)).flip(1)
    h_prev = torch.cat([torch.zeros_like(h[:, :1], dtype=ct),
                        h[:, :-1].to(ct)], 1)
    return (g * h_prev).to(a.dtype), g.to(a.dtype)


def _launch_bwd(a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor):
    """Run the backward kernel on CUDA tensors (raises on any failure)."""
    a, h, dh = a.contiguous(), h.contiguous(), dh.contiguous()
    da, db = torch.empty_like(a), torch.empty_like(a)
    lib = _build.load("linear_recurrence")
    fn = (lib.linear_recurrence_bwd_bf16 if a.dtype == torch.bfloat16
          else lib.linear_recurrence_bwd_f32)
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    bb, t, d = a.shape
    rc = fn(a.data_ptr(), h.data_ptr(), dh.data_ptr(), da.data_ptr(),
            db.data_ptr(), bb, t, d, _build.stream_handle(a.device))
    if rc != 0:
        raise RuntimeError(f"linear_recurrence_bwd kernel launch failed: "
                           f"CUDA error {rc}")
    return da, db


def linear_recurrence_bwd(a: torch.Tensor, h: torch.Tensor,
                          dh: torch.Tensor):
    """``(da, db)`` of ``h = linear_recurrence(a, b)`` from ``h`` and the
    output gradient ``dh``, in a's dtype.  CUDA tensors launch the
    backward kernel; CPU tensors run :func:`linear_recurrence_bwd_torch`."""
    check_inputs(a, h)
    if dh.shape != a.shape or dh.device != a.device:
        raise ValueError(f"linear_recurrence_bwd: dh {tuple(dh.shape)} must "
                         f"be a's {tuple(a.shape)}, on its device")
    if not a.is_cuda:
        return linear_recurrence_bwd_torch(a, h, dh)
    out = _launch_bwd(a, h, dh.to(a.dtype))
    linear_recurrence_bwd.launches += 1
    return out


linear_recurrence_bwd.launches = 0


class LinearRecurrenceFunction(torch.autograd.Function):
    """The recurrence with the backward kernel: forward
    :func:`linear_recurrence`, backward :func:`linear_recurrence_bwd`
    (``a`` and ``h`` saved)."""

    @staticmethod
    def forward(ctx, a, b):
        h = linear_recurrence(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        return linear_recurrence_bwd(a, h, dh)
