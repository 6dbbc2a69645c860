"""Segmented max-plus scan: the CUDA kernel and its plain PyTorch version.

The per-zone sequential completion recurrence
``c_i = max(c_{i-1}, s_i) + v_i`` is linear in the max-plus semiring:
with ``a_i = v_i`` and ``b_i = s_i + v_i``, ``c_i = max(c_{i-1} + a_i,
b_i)``.  Two such maps compose as ``(a1, b1) . (a2, b2) = (a1 + a2,
max(b1 + a2, b2))``, which is associative, so the recurrence scans in
parallel.  Segment heads set ``a_i`` to the padding sentinel, which drops
the carry.

* :func:`zns_event_scan_batched` / :func:`zns_event_scan` launch
  ``csrc/zns_event_scan.cu`` for CUDA tensors, in float32 or float64: one
  cooperative launch spreads the 2,048-element tiles of all rows over the
  card, scans each tile in registers, and composes each tile's carry-in
  from the earlier tiles' aggregates after one grid-wide barrier (see the
  source's note).  They replace the TPU kernels
  ``src/repro/kernels/zns_event_scan.py`` (``zns_event_scan_batched``
  and ``zns_event_scan``).
* :func:`rows_maxplus_torch` is the plain version: a doubling ladder of
  ``log2(L)`` shifted composes over the rows.  The wrappers use it only
  for tensors on the CPU.

Sentinels follow the reference kernels: ``-1e30`` in float32, ``-inf``
in float64.  Each wrapper counts its kernel launches in ``.launches``
and keeps the last launch's grid, resident-block capacity and registers
in ``.last_launch``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

#: Finite padding sentinel of the float32 kernels.
NEG_INF = -1e30


def pad_value(dtype: torch.dtype) -> float:
    """Segment-head / padding sentinel: ``-inf`` in float64, the finite
    ``NEG_INF`` in float32 (the TPU kernels' value)."""
    return float("-inf") if dtype == torch.float64 else NEG_INF


def rows_maxplus_torch(start: torch.Tensor, svc: torch.Tensor,
                       heads: torch.Tensor) -> torch.Tensor:
    """Segmented max-plus scan over the rows of ``(R, L)`` tensors.

    ``a = svc`` (the sentinel at heads), ``b = start + svc``, composed by
    a doubling ladder; returns the completions ``b``.  Plain PyTorch on
    whatever device the inputs are on.
    """
    r, n = start.shape
    ninf = pad_value(start.dtype)
    a = torch.where(heads, torch.full_like(svc, ninf), svc)
    b = start + svc
    k = 1
    while k < n:
        a_prev = torch.cat([a.new_zeros((r, k)), a[:, :-k]], dim=1)
        b_prev = torch.cat([b.new_full((r, k), ninf), b[:, :-k]], dim=1)
        # compose earlier (shifted) map, then current: (a_p,b_p) . (a,b)
        a, b = a_prev + a, torch.maximum(b_prev + a, b)
        k *= 2
    return b


def check_inputs(issue, svc, seg, ndim: int) -> None:
    if issue.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"zns_event_scan: float32 or float64 inputs, got "
                        f"{issue.dtype}")
    if svc.dtype != issue.dtype:
        raise TypeError(f"zns_event_scan: issue is {issue.dtype} but svc "
                        f"is {svc.dtype}")
    if seg.dtype != torch.bool:
        raise TypeError(f"zns_event_scan: seg must be bool, got {seg.dtype}")
    if issue.dim() != ndim or svc.shape != issue.shape \
            or seg.shape != issue.shape:
        raise ValueError(f"zns_event_scan: expected {ndim}-D inputs of one "
                         f"shape, got {tuple(issue.shape)}, "
                         f"{tuple(svc.shape)}, {tuple(seg.shape)}")
    if not (issue.device == svc.device == seg.device):
        raise ValueError("zns_event_scan: inputs on different devices")


def launch_info(info) -> dict:
    """The ``(grid, resident blocks, registers)`` a launcher reports."""
    return dict(grid=int(info[0]), resident_blocks=int(info[1]),
                registers=int(info[2]))


_LIB = None


def _lib():
    """The built library, its C signatures set once."""
    global _LIB
    if _LIB is None:
        lib = _build.load("zns_event_scan")
        for fn in (lib.zns_scan_rows_f32, lib.zns_scan_rows_f64):
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2 \
                + [ctypes.c_void_p] * 2
            fn.restype = ctypes.c_int
        lib.zns_scan_error.restype = ctypes.c_char_p
        lib.tile = lib.zns_scan_tile()
        _LIB = lib
    return _LIB


def _launch(issue, svc, seg):
    """Run the CUDA kernel on ``(B, N)`` CUDA tensors; returns the output
    and :func:`launch_info`.  Raises on any failure, naming the CUDA
    error (a refused cooperative launch among them)."""
    issue = issue.contiguous()
    svc = svc.contiguous()
    seg = seg.contiguous()
    rows, n = issue.shape
    lib = _lib()
    tiles = rows * -(-n // lib.tile)
    # one allocation: the output, then the per-tile aggregates
    buf = torch.empty(rows * n + 2 * tiles, dtype=issue.dtype,
                      device=issue.device)
    out, agg = buf[:rows * n].view(rows, n), buf[rows * n:]
    fn = lib.zns_scan_rows_f64 if issue.dtype == torch.float64 \
        else lib.zns_scan_rows_f32
    info = (ctypes.c_int * 3)()
    rc = fn(issue.data_ptr(), svc.data_ptr(), seg.data_ptr(),
            out.data_ptr(), agg.data_ptr(), rows, n,
            _build.stream_handle(issue.device), info)
    if rc != 0:
        raise RuntimeError(f"zns_event_scan kernel launch failed: "
                           f"{lib.zns_scan_error(rc).decode()} (CUDA "
                           f"error {rc})")
    return out, launch_info(info)


def zns_event_scan_batched(issue: torch.Tensor, svc: torch.Tensor,
                           seg: torch.Tensor) -> torch.Tensor:
    """Completion times of ``(B, N)`` independent rows (each row's carry
    starts fresh).  CUDA tensors launch the kernel; CPU tensors run
    :func:`rows_maxplus_torch`."""
    check_inputs(issue, svc, seg, 2)
    if not issue.is_cuda:
        return rows_maxplus_torch(issue, svc, seg)
    out, zns_event_scan_batched.last_launch = _launch(issue, svc, seg)
    zns_event_scan_batched.launches += 1
    return out


zns_event_scan_batched.launches = 0
zns_event_scan_batched.last_launch = None


def zns_event_scan(issue: torch.Tensor, svc: torch.Tensor,
                   seg: torch.Tensor) -> torch.Tensor:
    """Completion times of per-zone serialized requests, ``(N,)`` inputs
    (the one-row case of the batched kernel)."""
    check_inputs(issue, svc, seg, 1)
    if not issue.is_cuda:
        return rows_maxplus_torch(issue[None], svc[None], seg[None])[0]
    out, zns_event_scan.last_launch = _launch(issue[None], svc[None],
                                              seg[None])
    zns_event_scan.launches += 1
    return out[0]


zns_event_scan.launches = 0
zns_event_scan.last_launch = None
