"""Mamba2 SSD (state-space duality) chunked scan: the CUDA kernel and its
plain PyTorch version.

x ``(Bb, T, H, P)``, dt ``(Bb, T, H)`` float32 positive steps, A ``(H,)``
float32 negative, B/C ``(Bb, T, G, N)`` (head ``h`` reads group
``h // (H // G)``) -> y ``(Bb, T, H, P)`` in x's dtype and the final state
``(Bb, H, P, N)`` in float32.  x, B and C are float32 or bfloat16, of one
dtype.  Per chunk of ``L`` steps, with ``cum`` the inclusive cumsum of
``dt * A`` within the chunk::

    y_i = sum_{j<=i} (C_i . B_j) e^(cum_i - cum_j) dt_j x_j
          + (C_i e^(cum_i)) . S_prev^T
    S   = e^(cum_L) S_prev + sum_j e^(cum_L - cum_j) dt_j x_j B_j^T

* :func:`ssd_chunk_scan` launches ``csrc/ssd_chunk_scan.cu`` for CUDA
  tensors (one block per (batch, head) walking the chunks; T a multiple
  of the chunk, L in 32 / 64 / 128, P <= 128 and P, N multiples of 4).
  It replaces the TPU kernel
  ``src/repro/kernels/ssd_chunk_scan.py::ssd_chunk_scan`` and counts its
  launches in ``ssd_chunk_scan.launches``.  Two instances, chosen by
  :func:`instance` from dtype and shape before the launch: bfloat16 with
  N <= 128 runs the tensor-core kernel (``mma.sync``; counted again in
  ``ssd_chunk_scan.mma_launches``), float32 and bfloat16 with N > 128 the
  float32-core kernel.
* :func:`ssd_torch` is the plain version: the same chunked maths as
  batched matrix products over (batch, head), with a loop over chunks
  only.  It takes any T (zero steps pad it to a chunk multiple: dt = 0
  leaves the state as it is).  The wrapper uses it only for tensors on
  the CPU.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from . import _build

DTYPES = (torch.float32, torch.bfloat16)
#: Chunk lengths the CUDA kernel takes.
CHUNKS = (32, 64, 128)
#: Shared memory a block may use on the card (bytes).
SMEM_LIMIT = 232_448


def check_inputs(x, dt, A, B, C) -> None:
    if x.dtype not in DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"ssd_scan: x, B, C of one dtype, float32 or "
                        f"bfloat16; got {x.dtype}, {B.dtype}, {C.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"ssd_scan: dt and A in float32; got {dt.dtype}, "
                        f"{A.dtype}")
    if x.dim() != 4 or B.dim() != 4 or C.shape != B.shape:
        raise ValueError(f"ssd_scan: x (Bb, T, H, P), B/C (Bb, T, G, N); "
                         f"got {tuple(x.shape)}, {tuple(B.shape)}, "
                         f"{tuple(C.shape)}")
    bb, t, h, _ = x.shape
    if (dt.shape != (bb, t, h) or A.shape != (h,) or B.shape[:2] != (bb, t)
            or h % B.shape[2]):
        raise ValueError(f"ssd_scan: dt {tuple(dt.shape)}, A "
                         f"{tuple(A.shape)}, B {tuple(B.shape)} do not fit "
                         f"x {tuple(x.shape)} (H % G == 0)")
    if not (x.device == dt.device == A.device == B.device == C.device):
        raise ValueError("ssd_scan: inputs on different devices")


def smem_bytes(chunk: int, p: int, n: int) -> int:
    """The float32-core kernel's shared memory per block (see the
    source's layout)."""
    nb = n + 4
    return 4 * (chunk * p + chunk * nb + 32 * nb + p * nb + 32 * chunk
                + 4 * chunk)


def padded(v: int) -> int:
    """P or N padded to the tensor-core kernel's tile: 16, 32, 64, 128."""
    return next(k for k in (16, 32, 64, 128) if v <= k)


def mma_smem_bytes(chunk: int, p: int, n: int, stages: int) -> int:
    """The tensor-core kernel's shared memory per block (see the source's
    layout): ``stages`` copies of x, B, C (rows padded by 8 bf16) and dt,
    the bf16 state, and four float vectors of the chunk."""
    pp, np_ = padded(p), padded(n)
    stage = 2 * chunk * (pp + 8) + 4 * chunk * (np_ + 8) + 4 * chunk
    return stages * stage + 2 * pp * (np_ + 8) + 16 * chunk


def mma_stages(chunk: int, p: int, n: int) -> int:
    """Shared-memory stages of the tensor-core kernel: 2 where they fit,
    else 1 (the next chunk loads after the current one)."""
    return 2 if mma_smem_bytes(chunk, p, n, 2) <= SMEM_LIMIT else 1


def instance(dtype: torch.dtype, n: int) -> str:
    """The kernel a launch takes, from dtype and N alone: ``"mma"`` (the
    bfloat16 tensor-core kernel, N <= 128) or ``"simt"`` (the float32-core
    kernel: float32, or bfloat16 with N > 128)."""
    return "mma" if dtype == torch.bfloat16 and n <= 128 else "simt"


def ssd_torch(x, dt, A, B, C, *, chunk: int = 128
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version, float32 throughout.  Masked decay entries (j > i)
    are ``exp(-inf) = 0``, never an overflowed ``exp`` times 0."""
    bb, t, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    L = chunk
    nc = -(-t // L)
    pad = nc * L - t
    xf = F.pad(x.float(), (0, 0, 0, 0, 0, pad)).view(bb, nc, L, h, p)
    dtf = F.pad(dt.float(), (0, 0, 0, pad)).view(bb, nc, L, h)
    Bf = F.pad(B.float(), (0, 0, 0, 0, 0, pad)).view(bb, nc, L, g, n)
    Cf = F.pad(C.float(), (0, 0, 0, 0, 0, pad)).view(bb, nc, L, g, n)
    Af = A.float()
    tri = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    S = torch.zeros((bb, h, p, n), dtype=torch.float32, device=x.device)
    y = torch.empty((bb, nc, L, h, p), dtype=torch.float32, device=x.device)
    for c in range(nc):
        dth = dtf[:, c].transpose(1, 2)                     # (bb, h, L)
        cum = torch.cumsum(dth * Af[:, None], dim=-1)       # (bb, h, L)
        xh = xf[:, c].permute(0, 2, 1, 3)                   # (bb, h, L, p)
        Bh = Bf[:, c].permute(0, 2, 1, 3).repeat_interleave(rep, 1)
        Ch = Cf[:, c].permute(0, 2, 1, 3).repeat_interleave(rep, 1)
        scores = Ch @ Bh.transpose(-1, -2)                  # (bb, h, L, L)
        diff = cum[..., :, None] - cum[..., None, :]
        decay = torch.exp(diff.masked_fill(~tri, float("-inf")))
        scores = scores * decay * dth[:, :, None, :]
        y_intra = scores @ xh
        y_inter = (Ch * torch.exp(cum)[..., None]) @ S.transpose(-1, -2)
        y[:, c] = (y_intra + y_inter).permute(0, 2, 1, 3)
        w = torch.exp(cum[..., -1:] - cum) * dth            # (bb, h, L)
        xw = xh * w[..., None]
        S = (S * torch.exp(cum[..., -1])[..., None, None]
             + xw.transpose(-1, -2) @ Bh)
    return y.view(bb, nc * L, h, p)[:, :t].to(x.dtype), S


def _launch(x, dt, A, B, C, chunk: int):
    """Run the CUDA kernel on CUDA tensors (raises on any failure)."""
    bb, t, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if chunk not in CHUNKS or t % chunk:
        raise ValueError(f"ssd_chunk_scan: chunk in {CHUNKS} dividing T; "
                         f"got chunk {chunk}, T {t} (pad T to a chunk "
                         f"multiple)")
    if p % 4 or p > 128 or n % 4:
        raise ValueError(f"ssd_chunk_scan: P <= 128 and P, N multiples of "
                         f"4; got P {p}, N {n}")
    kind = instance(x.dtype, n)
    if kind == "simt" and smem_bytes(chunk, p, n) > SMEM_LIMIT:
        raise ValueError(f"ssd_chunk_scan: chunk {chunk}, P {p}, N {n} need "
                         f"{smem_bytes(chunk, p, n)} bytes of shared memory "
                         f"(limit {SMEM_LIMIT})")
    x, dt, A, B, C = (u.contiguous() for u in (x, dt, A, B, C))
    y = torch.empty_like(x)
    state = torch.empty((bb, h, p, n), dtype=torch.float32, device=x.device)
    lib = _build.load("ssd_chunk_scan")
    ptrs = [u.data_ptr() for u in (x, dt, A, B, C, y, state)]
    dims = [bb, t, h, p, g, n, chunk, _build.stream_handle(x.device)]
    if kind == "mma":
        fn = lib.ssd_chunk_scan_mma_fwd
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
        args = ptrs + dims
    else:
        fn = lib.ssd_chunk_scan_fwd
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                       + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        args = [1 if x.dtype == torch.bfloat16 else 0] + ptrs + dims
    fn.restype = ctypes.c_int
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"ssd_chunk_scan ({kind}) kernel launch failed: "
                           f"CUDA error {rc}")
    return y, state, kind


def ssd_chunk_scan(x, dt, A, B, C, *, chunk: int = 128
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD scan; returns ``(y, final state)``.  CUDA tensors launch the
    kernel; CPU tensors run :func:`ssd_torch`."""
    check_inputs(x, dt, A, B, C)
    if not x.is_cuda:
        return ssd_torch(x, dt, A, B, C, chunk=chunk)
    y, state, kind = _launch(x, dt, A, B, C, chunk)
    ssd_chunk_scan.launches += 1
    if kind == "mma":
        ssd_chunk_scan.mma_launches += 1
    return y, state


ssd_chunk_scan.launches = 0
ssd_chunk_scan.mma_launches = 0
