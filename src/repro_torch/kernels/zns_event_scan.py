"""Segmented max-plus scan: the CUDA kernel and its plain PyTorch version.

The per-zone sequential completion recurrence
``c_i = max(c_{i-1}, s_i) + v_i`` is linear in the max-plus semiring:
with ``a_i = v_i`` and ``b_i = s_i + v_i``, ``c_i = max(c_{i-1} + a_i,
b_i)``.  Two such maps compose as ``(a1, b1) . (a2, b2) = (a1 + a2,
max(b1 + a2, b2))``, which is associative, so the recurrence scans in
parallel.  Segment heads set ``a_i`` to the padding sentinel, which drops
the carry.

* :func:`zns_event_scan_batched` / :func:`zns_event_scan` launch
  ``csrc/zns_event_scan.cu`` (one thread block per row, chunked
  warp-shuffle scans with a register carry; see the source's note) for
  CUDA tensors, in float32 or float64.  They replace the TPU kernels
  ``src/repro/kernels/zns_event_scan.py`` (``zns_event_scan_batched``
  and ``zns_event_scan``).
* :func:`rows_maxplus_torch` is the plain version: a doubling ladder of
  ``log2(L)`` shifted composes over the rows.  The wrappers use it only
  for tensors on the CPU.

Sentinels follow the reference kernels: ``-1e30`` in float32, ``-inf``
in float64.  Each wrapper counts its kernel launches in ``.launches``.
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


def _launch(issue, svc, seg) -> torch.Tensor:
    """Run the CUDA kernel on ``(B, N)`` CUDA tensors (raises on any
    failure)."""
    issue = issue.contiguous()
    svc = svc.contiguous()
    seg = seg.contiguous()
    out = torch.empty_like(issue)
    rows, n = issue.shape
    lib = _build.load("zns_event_scan")
    fn = lib.zns_scan_rows_f64 if issue.dtype == torch.float64 \
        else lib.zns_scan_rows_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(issue.data_ptr(), svc.data_ptr(), seg.data_ptr(),
            out.data_ptr(), rows, n, _build.stream_handle(issue.device))
    if rc != 0:
        raise RuntimeError(f"zns_event_scan kernel launch failed: CUDA "
                           f"error {rc}")
    return out


def zns_event_scan_batched(issue: torch.Tensor, svc: torch.Tensor,
                           seg: torch.Tensor) -> torch.Tensor:
    """Completion times of ``(B, N)`` independent rows (each row's carry
    starts fresh).  CUDA tensors launch the kernel; CPU tensors run
    :func:`rows_maxplus_torch`."""
    check_inputs(issue, svc, seg, 2)
    if not issue.is_cuda:
        return rows_maxplus_torch(issue, svc, seg)
    out = _launch(issue, svc, seg)
    zns_event_scan_batched.launches += 1
    return out


zns_event_scan_batched.launches = 0


def zns_event_scan(issue: torch.Tensor, svc: torch.Tensor,
                   seg: torch.Tensor) -> torch.Tensor:
    """Completion times of per-zone serialized requests, ``(N,)`` inputs
    (the one-row case of the batched kernel)."""
    check_inputs(issue, svc, seg, 1)
    if not issue.is_cuda:
        return rows_maxplus_torch(issue[None], svc[None], seg[None])[0]
    out = _launch(issue[None], svc[None], seg[None])[0]
    zns_event_scan.launches += 1
    return out


zns_event_scan.launches = 0
