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
* :func:`ssd_chunk_scan_bwd` launches the backward kernels of the same
  source for CUDA tensors and counts ``ssd_chunk_scan_bwd.launches``:
  from ``(dy, dS_final)`` it gives ``(dx, ddt, dA, dB, dC)`` with the
  chunked maths of :func:`ssd_bwd_torch` (below), with no atomics (every
  sum in a fixed order, so a backward gives the same bits in every run).
  Two instances, chosen by :func:`bwd_instance` before the launch:
  bfloat16 runs on the tensor cores (``mma.sync``; counted again in
  ``ssd_chunk_scan_bwd.mma_launches``), float32 on the float32 cores.
  The reference has no backward kernel: its gradients are XLA's autodiff
  of the sequential oracle.
* :func:`ssd_bwd_torch` is its plain version: per chunk, walking the
  chunks in reverse and carrying ``dS``, with ``u_j = dt_j x_j``, ``M_ij
  = (C_i . B_j) e^(cum_i - cum_j)`` (i >= j) and ``S_prev`` the state
  entering the chunk (from a forward pass over the chunks, kept for
  every chunk)::

    du_j = sum_{i>=j} M_ij dy_i + e^(cum_L - cum_j) dS B_j
    dC_i = sum_{j<=i} e^(cum_i - cum_j) (dy_i . u_j) B_j
           + e^(cum_i) S_prev^T dy_i
    dB_j = sum_{i>=j} e^(cum_i - cum_j) (dy_i . u_j) C_i
           + e^(cum_L - cum_j) dS^T u_j
    dS  <- e^(cum_L) dS + sum_i e^(cum_i) dy_i C_i^T

  and ``dcum`` (through every exponent) becomes ``ddt = x . du + A
  rc`` and ``dA = sum dt rc``, ``rc`` the reverse cumsum of ``dcum``
  within the chunk.  ``dB`` and ``dC`` sum over the heads of a group.
* :class:`SSDScanFunction` is the ``torch.autograd.Function`` (forward
  :func:`ssd_chunk_scan`, backward :func:`ssd_chunk_scan_bwd`) that
  ``ops.ssd_scan(..., impl="cuda")`` uses when a gradient is wanted.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from . import _build
from .ref import compute_dtype

DTYPES = (torch.float32, torch.bfloat16)
#: The plain versions also compute in float64, when asked for by name.
PLAIN_DTYPES = DTYPES + (torch.float64,)
#: Chunk lengths the CUDA kernel takes.
CHUNKS = (32, 64, 128)
#: Shared memory a block may use on the card (bytes).
SMEM_LIMIT = 232_448


def check_inputs(x, dt, A, B, C, *, plain: bool = False) -> None:
    """Raises on inputs the kernel does not take (``plain``: the plain
    version is asked for, and float64 is taken too, for every input)."""
    f64 = plain and x.dtype == torch.float64
    if ((x.dtype not in (PLAIN_DTYPES if plain else DTYPES))
            or B.dtype != x.dtype or C.dtype != x.dtype):
        raise TypeError(f"ssd_scan: x, B, C of one dtype, float32 or "
                        f"bfloat16 (float64: impl='torch' only); got "
                        f"{x.dtype}, {B.dtype}, {C.dtype}")
    want = torch.float64 if f64 else torch.float32
    if dt.dtype != want or A.dtype != want:
        raise TypeError(f"ssd_scan: dt and A in {want}; got {dt.dtype}, "
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


def bwd_instance(dtype: torch.dtype, n: int) -> str:
    """The backward's kernels for a launch, from dtype and N alone:
    ``"mma"`` (the bfloat16 tensor-core kernels, N <= 128; P and N padded
    to 16, 32, 64 or 128) or ``"simt"`` (the float32-core kernels,
    ``ssd_bwd_f32_walk`` and ``ssd_bwd_f32_chunk``, register-tiled, P and N
    padded to 32, 64 or 128: float32 is held to float32, and TF32 would not
    be).  Nothing falls back from one to the other."""
    return "mma" if dtype == torch.bfloat16 and n <= 128 else "simt"


def ssd_torch(x, dt, A, B, C, *, chunk: int = 128
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version, float32 throughout (float64 for float64 inputs).
    Masked decay entries (j > i) are ``exp(-inf) = 0``, never an
    overflowed ``exp`` times 0."""
    bb, t, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    L = chunk
    nc = -(-t // L)
    pad = nc * L - t
    ct = compute_dtype(x)
    xf = F.pad(x.to(ct), (0, 0, 0, 0, 0, pad)).view(bb, nc, L, h, p)
    dtf = F.pad(dt.to(ct), (0, 0, 0, pad)).view(bb, nc, L, h)
    Bf = F.pad(B.to(ct), (0, 0, 0, 0, 0, pad)).view(bb, nc, L, g, n)
    Cf = F.pad(C.to(ct), (0, 0, 0, 0, 0, pad)).view(bb, nc, L, g, n)
    Af = A.to(ct)
    tri = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    S = torch.zeros((bb, h, p, n), dtype=ct, device=x.device)
    y = torch.empty((bb, nc, L, h, p), dtype=ct, device=x.device)
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


def ssd_bwd_torch(x, dt, A, B, C, dy, dstate=None, *, chunk: int = 128):
    """Plain backward of :func:`ssd_torch` (the maths of the module's
    docstring), float32 throughout (float64 for float64 inputs): a
    forward pass keeps the state entering every chunk, then the chunks in
    reverse carry ``dS`` (from ``dstate``, the final state's gradient, or
    0).  Returns ``(dx, ddt, dA, dB, dC)``: dx, dB, dC in x's dtype, ddt
    and dA in float32 (float64).  Takes any T, as the forward does."""
    bb, t, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    L = chunk
    nc = -(-t // L)
    pad = nc * L - t
    ct = compute_dtype(x)
    dev = x.device

    def chunks(u, tail):
        return F.pad(u.to(ct), (0, 0) * len(tail) + (0, pad)).view(
            (bb, nc, L) + tail)

    xf, dyf = chunks(x, (h, p)), chunks(dy, (h, p))
    dtf = chunks(dt, (h,))
    Bf, Cf = chunks(B, (g, n)), chunks(C, (g, n))
    Af = A.to(ct)
    tri = torch.ones((L, L), dtype=torch.bool, device=dev).tril()

    def heads(u, c):                                     # (bb, h, L, -)
        u = u[:, c].permute(0, 2, 1, 3)
        return u.repeat_interleave(rep, 1) if u.shape[1] != h else u

    def decays(c):
        dth = dtf[:, c].transpose(1, 2)                  # (bb, h, L)
        cum = torch.cumsum(dth * Af[:, None], dim=-1)
        return dth, cum

    states = []
    S = torch.zeros((bb, h, p, n), dtype=ct, device=dev)
    for c in range(nc):
        states.append(S)
        dth, cum = decays(c)
        w = torch.exp(cum[..., -1:] - cum) * dth
        S = (S * torch.exp(cum[..., -1])[..., None, None]
             + (heads(xf, c) * w[..., None]).transpose(-1, -2)
             @ heads(Bf, c))
    dS = (torch.zeros_like(S) if dstate is None else dstate.to(ct))
    dx = torch.empty((bb, nc, L, h, p), dtype=ct, device=dev)
    ddt = torch.empty((bb, nc, L, h), dtype=ct, device=dev)
    dBf = torch.empty((bb, nc, L, g, n), dtype=ct, device=dev)
    dCf = torch.empty_like(dBf)
    dA = torch.zeros((h,), dtype=ct, device=dev)
    for c in reversed(range(nc)):
        dth, cum = decays(c)
        xh, dyh = heads(xf, c), heads(dyf, c)
        Bh, Ch = heads(Bf, c), heads(Cf, c)
        Sp = states[c]
        u = xh * dth[..., None]                          # (bb, h, L, p)
        e = torch.exp(cum)
        eL = torch.exp(cum[..., -1])
        wL = torch.exp(cum[..., -1:] - cum)
        E = torch.exp((cum[..., :, None] - cum[..., None, :])
                      .masked_fill(~tri, float("-inf")))
        M = (Ch @ Bh.transpose(-1, -2)) * E              # M_ij
        Q = (dyh @ u.transpose(-1, -2)) * E              # e (dy_i . u_j)
        R = M * (dyh @ u.transpose(-1, -2))
        dSB = Bh @ dS.transpose(-1, -2)                  # (dS B_j)_p
        du = M.transpose(-1, -2) @ dyh + wL[..., None] * dSB
        dCh = Q @ Bh + e[..., None] * (dyh @ Sp)
        dBh = Q.transpose(-1, -2) @ Ch + wL[..., None] * (u @ dS)
        y_inter = e[..., None] * (Ch @ Sp.transpose(-1, -2))
        T = (u * wL[..., None] * dSB).sum(-1)
        dcum = R.sum(-1) - R.sum(-2) + (dyh * y_inter).sum(-1) - T
        dcum[..., -1] += T.sum(-1) + eL * (dS * Sp).sum((-1, -2))
        rc = dcum.flip(-1).cumsum(-1).flip(-1)
        ddt[:, c] = ((xh * du).sum(-1) + Af[:, None] * rc).transpose(1, 2)
        dA += (dth * rc).sum((0, 2))
        dx[:, c] = (du * dth[..., None]).permute(0, 2, 1, 3)
        dBf[:, c] = dBh.view(bb, g, rep, L, n).sum(2).permute(0, 2, 1, 3)
        dCf[:, c] = dCh.view(bb, g, rep, L, n).sum(2).permute(0, 2, 1, 3)
        dS = (eL[..., None, None] * dS
              + (dyh * e[..., None]).transpose(-1, -2) @ Ch)

    def out(u, dtype):
        return u.reshape((bb, nc * L) + u.shape[3:])[:, :t].to(dtype)
    return (out(dx, x.dtype), out(ddt, ct), dA, out(dBf, x.dtype),
            out(dCf, x.dtype))


def _launch(x, dt, A, B, C, chunk: int):
    """Run the CUDA kernel on CUDA tensors (raises on any failure)."""
    _check_kernel_shape(x, B, chunk)
    bb, t, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
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


def _check_kernel_shape(x, B, chunk: int) -> None:
    t, p, n = x.shape[1], x.shape[3], B.shape[3]
    if chunk not in CHUNKS or t % chunk:
        raise ValueError(f"ssd_chunk_scan: chunk in {CHUNKS} dividing T; "
                         f"got chunk {chunk}, T {t} (pad T to a chunk "
                         f"multiple)")
    if p % 4 or p > 128 or n % 4:
        raise ValueError(f"ssd_chunk_scan: P <= 128 and P, N multiples of "
                         f"4; got P {p}, N {n}")


def padded32(v: int) -> int:
    """P or N padded to the float32 backward chunk kernel's tile: 32, 64,
    128."""
    return next(k for k in (32, 64, 128) if v <= k)


def bwd_smem_bytes(chunk: int, p: int, n: int) -> int:
    """Shared memory of the float32-core backward's kernels per block, the
    larger (see the source's layout): the state walks hold x or dy and B
    or C (rows padded to 8 floats), dt, and a float vector of the chunk:
    one stage at P <= 64 (two blocks share an SM), else two where they
    fit; the chunk kernel two stages of its own 32-row tiles and the
    other side's whole chunk, or two stages of its 32-row tiles
    (:func:`f32_chunk_rows`; N and P padded to 32, 64 or 128, rows 4 floats
    longer), two tiles of 36 floats a row of the other side's, the own X
    tile transposed, the state and three float vectors of the chunk."""
    stage = chunk * (-(-p // 8) * 8) + chunk * (-(-n // 8) * 8) + chunk
    walk = 4 * (2 * stage + chunk + 4)
    if p <= 64 or walk > SMEM_LIMIT:
        walk = 4 * (stage + chunk + 4)
    pp, np_ = padded32(p), padded32(n)
    return max(walk, f32_chunk_bytes(chunk, pp, np_,
                                     f32_chunk_rows(chunk, pp, np_)))


def f32_chunk_bytes(chunk: int, pp: int, np_: int, rows: int) -> int:
    """The float32 chunk kernel's shared memory at padded PP, NP: streaming
    the other side in 32-row tiles (``rows`` 32), or holding its whole
    chunk (``rows`` the chunk)."""
    row = (np_ + 4) + (pp + 4)
    if rows == 32:
        return 4 * (4 * 32 * row + pp * 36 + 2 * 32 * 36 + pp * (np_ + 4)
                    + 3 * chunk)
    return 4 * (2 * 32 * row + chunk * row + 2 * chunk * 36
                + pp * (np_ + 4) + 3 * chunk)


def f32_chunk_rows(chunk: int, pp: int, np_: int) -> int:
    """The other side's rows the float32 chunk kernel holds: the whole
    chunk (64 or 128 steps) where it fits and PP <= the chunk, else 32-row
    tiles streamed."""
    return chunk if chunk >= 64 and pp <= chunk and f32_chunk_bytes(
        chunk, pp, np_, chunk) <= SMEM_LIMIT else 32


def mma_bwd_smem_bytes(chunk: int, p: int, n: int) -> int:
    """Shared memory of the tensor-core backward's kernels per block, the
    larger (see the source's layout): the state walks hold two stages of
    x or dy, B or C (rows padded by 8 bf16) and dt; the chunk kernel the
    chunk's x, dy, B and C, the state's bf16 hi and lo, eleven float
    vectors of the chunk, and a float32 state (S_prev, then dS) where
    that still fits."""
    pp, np_ = padded(p), padded(n)
    walk = (2 * (2 * chunk * (pp + 8) + 2 * chunk * (np_ + 8) + 4 * chunk)
            + 8 * chunk)
    core = (4 * chunk * (pp + 8) + 4 * chunk * (np_ + 8)
            + 4 * pp * (np_ + 8) + 4 * (7 + chunk // 16) * chunk + 128)
    staged = core + 4 * pp * np_
    return max(walk, staged if staged <= SMEM_LIMIT else core)


def check_bwd_shape(chunk: int, p: int, n: int, kind: str) -> None:
    """Raises ``ValueError`` where the backward's kernels of instance
    ``kind`` do not take the shape: N above 128, or a block's shared
    memory above :data:`SMEM_LIMIT`."""
    need = None if n > 128 else (
        mma_bwd_smem_bytes if kind == "mma" else bwd_smem_bytes)(chunk, p, n)
    if need is None or need > SMEM_LIMIT:
        raise ValueError(f"ssd_chunk_scan_bwd ({kind}): N <= 128 and chunk "
                         f"{chunk}, P {p}, N {n} within {SMEM_LIMIT} bytes "
                         f"of shared memory (needs {need})")


def _launch_bwd(x, dt, A, B, C, dy, dstate, chunk: int):
    """Run the backward kernels on CUDA tensors (raises on any failure);
    returns the gradients and the instance that ran."""
    _check_kernel_shape(x, B, chunk)
    bb, t, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    kind = bwd_instance(x.dtype, n)
    check_bwd_shape(chunk, p, n, kind)
    x, dt, A, B, C = (u.contiguous() for u in (x, dt, A, B, C))
    dy = dy.to(x.dtype).contiguous()
    nc = t // chunk
    f32 = dict(dtype=torch.float32, device=x.device)
    dstate = (torch.zeros((bb, h, p, n), **f32) if dstate is None
              else dstate.float().contiguous())
    states = torch.empty((bb, h, nc, p, n), **f32)
    dstates = torch.empty_like(states)
    dBp = torch.empty((bb, t, h, n), **f32)
    dCp = torch.empty_like(dBp)
    rows = torch.empty((3, bb, t, h), **f32)      # dcum (two parts), x.du
    dAp = torch.empty((bb, h, nc), **f32)
    dx, dB, dC = torch.empty_like(x), torch.empty_like(B), torch.empty_like(C)
    ddt = torch.empty_like(dt)
    dA = torch.empty_like(A)
    lib = _build.load("ssd_chunk_scan")
    fn = lib.ssd_chunk_scan_bwd
    ptrs = [u.data_ptr() for u in (x, dt, A, B, C, dy, dstate, states,
                                    dstates, dBp, dCp, rows, dAp, dx, ddt,
                                    dA, dB, dC)]
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * len(ptrs)
                   + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    rc = fn(1 if x.dtype == torch.bfloat16 else 0, *ptrs, bb, t, h, p, g, n,
            chunk, _build.stream_handle(x.device))
    if rc != 0:
        raise RuntimeError(f"ssd_chunk_scan_bwd ({kind}) kernel launch "
                           f"failed: CUDA error {rc}")
    return (dx, ddt, dA, dB, dC), kind


def ssd_chunk_scan_bwd(x, dt, A, B, C, dy, dstate=None, *,
                       chunk: int = 128):
    """``(dx, ddt, dA, dB, dC)`` of the SSD scan from the output gradient
    ``dy`` and the final state's ``dstate`` (None: 0).  CUDA tensors
    launch the backward kernels (T a multiple of the chunk, N <= 128;
    :func:`bwd_instance` picks them); CPU tensors run
    :func:`ssd_bwd_torch`."""
    check_inputs(x, dt, A, B, C)
    if dy.shape != x.shape or dy.device != x.device:
        raise ValueError(f"ssd_chunk_scan_bwd: dy {tuple(dy.shape)} must be "
                         f"x's {tuple(x.shape)}, on its device")
    if not x.is_cuda:
        return ssd_bwd_torch(x, dt, A, B, C, dy, dstate, chunk=chunk)
    out, kind = _launch_bwd(x, dt, A, B, C, dy, dstate, chunk)
    ssd_chunk_scan_bwd.launches += 1
    if kind == "mma":
        ssd_chunk_scan_bwd.mma_launches += 1
    return out


ssd_chunk_scan_bwd.launches = 0
ssd_chunk_scan_bwd.mma_launches = 0


class SSDScanFunction(torch.autograd.Function):
    """The SSD scan with the backward kernels: forward
    :func:`ssd_chunk_scan`, backward :func:`ssd_chunk_scan_bwd` (the
    inputs saved; the states are recomputed)."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk: int):
        y, state = ssd_chunk_scan(x, dt, A, B, C, chunk=chunk)
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk = chunk
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, A, B, C = ctx.saved_tensors
        grads = ssd_chunk_scan_bwd(x, dt, A, B, C, dy, dstate,
                                   chunk=ctx.chunk)
        return grads + (None,)
