"""Plain PyTorch oracles of the kernels.

The port's counterparts of ``repro.kernels.ref`` (``attention_ref``,
``attention_xla_chunked``, ``rmsnorm_ref``, ``linear_recurrence_ref``,
``ssd_ref``, ``zns_event_scan_ref``, ``zns_event_scan_batched_ref``,
``zns_fixpoint_ref``, ``affine_scan_pairs_ref``): the same finite
``NEG_INF`` sentinel, query positions aligned to the end of the keys, GQA
by head repeat, and the recurrences as sequential scans, the model
kernels' in float32.  The ZNS oracles keep their inputs' dtype: float32
with the finite sentinel and the float32 progress thresholds, as the
reference's, or float64 with ``-inf`` and the float64 thresholds.  They
are the semantic ground truth the tests hold the kernels' plain versions
against; :func:`repro_torch.kernels.ops.attention` sends a ``kv_length``
call here, and ``ops.zns_event_scan(..., impl="ref")`` the scans, as
the reference's ``impl="xla"`` does.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .zns_event_scan import pad_value
from .zns_fixpoint import moved_tol

NEG_INF = -1e30


def attention_mask(tq: int, tk: int, causal: bool, window: Optional[int],
                   device, q0: int = 0,
                   rows: Optional[int] = None) -> torch.Tensor:
    """``(rows, tk)`` visibility of keys to queries ``q0 .. q0 + rows``,
    query ``i`` at position ``i + (tk - tq)``."""
    rows = tq - q0 if rows is None else rows
    qpos = torch.arange(q0, q0 + rows, device=device)[:, None] + (tk - tq)
    kpos = torch.arange(tk, device=device)[None, :]
    mask = torch.ones((rows, tk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def attention_ref(q, k, v, *, causal: bool = True,
                  window: Optional[int] = None,
                  scale: Optional[float] = None, kv_length=None):
    """Dense attention oracle.

    q: (B, Hq, Tq, D); k/v: (B, Hkv, Tk, D).  GQA by head repeat.
    ``window``: keys within ``[pos - window + 1, pos]``.  ``kv_length``:
    optional (B,) valid KV lengths.
    """
    d = q.shape[-1]
    hq, hkv = q.shape[1], k.shape[1]
    if hq != hkv:
        k = k.repeat_interleave(hq // hkv, dim=1)
        v = v.repeat_interleave(hq // hkv, dim=1)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    tq, tk = q.shape[2], k.shape[2]
    if kv_length is not None:
        kpos = torch.arange(tk, device=q.device)
        lmask = kpos[None] < torch.as_tensor(kv_length,
                                             device=q.device)[:, None]
        logits = torch.where(lmask[:, None, None], logits, NEG_INF)
    mask = attention_mask(tq, tk, causal, window, q.device)
    logits = torch.where(mask[None, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype)


def attention_xla_chunked(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None,
                          scale: Optional[float] = None, q_chunk: int = 512):
    """Attention over chunks of ``q_chunk`` queries, so the ``(B, H, Tq,
    Tk)`` logits never exist at once; weights cast to v's dtype before the
    second product, as in the reference."""
    b, hq, tq, d = q.shape
    hkv = k.shape[1]
    tk = k.shape[2]
    if hq != hkv:
        k = k.repeat_interleave(hq // hkv, dim=1)
        v = v.repeat_interleave(hq // hkv, dim=1)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kf, vf = k.float(), v.float()
    outs = []
    for c0 in range(0, tq, q_chunk):
        qc = q[:, :, c0:c0 + q_chunk].float()
        logits = torch.einsum("bhqd,bhsd->bhqs", qc, kf) * scale
        mask = attention_mask(tq, tk, causal, window, q.device, c0,
                              qc.shape[2])
        logits = torch.where(mask[None, None], logits, NEG_INF)
        p = torch.softmax(logits, dim=-1).to(v.dtype).float()
        outs.append(torch.einsum("bhqs,bhsd->bhqd", p, vf).to(q.dtype))
    return torch.cat(outs, dim=2)


def rmsnorm_ref(x, w, *, eps: float = 1e-6):
    """``x * rsqrt(mean(x^2) + eps) * (1 + w)`` over the last dim, in
    float32, returned in ``x``'s dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + w.float())).to(x.dtype)


def linear_recurrence_ref(a, b, h0=None):
    """``h_t = a_t * h_{t-1} + b_t`` over ``(B, T, D)``, one time step at a
    time from ``h0`` (zeros by default), in float32; returned in b's
    dtype."""
    a32, b32 = a.float(), b.float()
    h = (torch.zeros_like(a32[:, 0]) if h0 is None else h0.float())
    out = torch.empty_like(b32)
    for t in range(a.shape[1]):
        h = a32[:, t] * h + b32[:, t]
        out[:, t] = h
    return out.to(b.dtype)


def ssd_ref(x, dt, A, B, C, *, init_state=None):
    """Sequential Mamba2 SSD oracle.

    x: (Bb, T, H, P); dt: (Bb, T, H) positive steps; A: (H,) negative;
    B, C: (Bb, T, G, N), group ``h // (H // G)`` per head.  Per step
    ``S = exp(dt A) S + (x dt) B^T`` and ``y = S C``, in float32.
    Returns y (Bb, T, H, P) in x's dtype and the final state (Bb, H, P, N)
    in float32.
    """
    bb, t, h, p = x.shape
    n = B.shape[3]
    rep = h // B.shape[2]
    Bh = B.repeat_interleave(rep, dim=2).float()
    Ch = C.repeat_interleave(rep, dim=2).float()
    xf, dtf, Af = x.float(), dt.float(), A.float()
    S = (torch.zeros((bb, h, p, n), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    ys = torch.empty_like(xf)
    for i in range(t):
        decay = torch.exp(dtf[:, i] * Af)[..., None, None]
        S = S * decay + torch.einsum("bhp,bhn->bhpn",
                                     xf[:, i] * dtf[:, i, :, None], Bh[:, i])
        ys[:, i] = torch.einsum("bhpn,bhn->bhp", S, Ch[:, i])
    return ys.to(x.dtype), S


# ---------------------------------------------------------------------------
# ZNS event scan: c_i = max(c_{i-1}, s_i) + v_i with segment resets
# ---------------------------------------------------------------------------
def zns_event_scan_batched_ref(issue, svc, seg_start):
    """Sequential max-plus recurrence along the last axis, one element
    at a time (the rows of a batch advance together, each with its own
    carry): ``c = sentinel`` at a segment head, then ``c = max(c, s) +
    v``."""
    ninf = pad_value(issue.dtype)
    c = torch.full(issue.shape[:-1], ninf, dtype=issue.dtype,
                   device=issue.device)
    out = torch.empty_like(issue)
    for i in range(issue.shape[-1]):
        c = torch.where(seg_start[..., i], torch.full_like(c, ninf), c)
        c = torch.maximum(c, issue[..., i]) + svc[..., i]
        out[..., i] = c
    return out


def zns_event_scan_ref(issue, svc, seg_start):
    """Max-plus linear recurrence oracle on ``(N,)`` inputs (the one-row
    case of :func:`zns_event_scan_batched_ref`)."""
    return zns_event_scan_batched_ref(issue, svc, seg_start)


def zns_fixpoint_ref(comp0, svc, blocks, *, sweeps: int = 8):
    """Chain-program fixpoint oracle (eager Gauss–Seidel sweeps).

    ``comp0``/``svc``: flat (n,) vectors; ``blocks``: ``(gidx, heads)``
    (R, L) index/head pairs with padding indexed at ``n`` (a dead slot).
    Every sweep gathers each block's completions, runs the sequential
    scan oracle and writes the maximum back; it stops after a sweep in
    which nothing moved.  No active set: every block runs every sweep.
    Returns ``(comp (n,), sweeps_used, converged)``.
    """
    dt = comp0.dtype
    ninf = pad_value(dt)
    rtol, atol = moved_tol(dt)
    comp = torch.cat([comp0, comp0.new_full((1,), ninf)])
    svc_e = torch.cat([svc, svc.new_zeros(1)])
    dead = comp.shape[0] - 1
    used, moved = 0, True
    for s in range(max(int(sweeps), 1)):
        moved = False
        for gidx, heads in blocks:
            gidx = gidx.long()
            svc_m = svc_e[gidx]
            cur = comp[gidx]
            out = zns_event_scan_batched_ref(cur - svc_m, svc_m, heads)
            # padding gathers the sentinel, which would trivially pass
            # the relative-progress test: mask it
            moved = moved or bool(((out > cur * (1.0 + rtol) + atol)
                                   & (gidx < dead)).any())
            # a real index appears at most once in a block
            comp[gidx] = torch.maximum(cur, out)
            comp[dead] = ninf
        used = s + 1
        if not moved:
            break
    return comp[:-1], used, not moved


# ---------------------------------------------------------------------------
# shared helper: affine scans as (a, b) pair composition
# ---------------------------------------------------------------------------
def affine_scan_pairs_ref(a, b, *, semiring: str):
    """Inclusive scan of affine maps ``f_i(c) = a_i (*) c (+) b_i`` along
    axis 0, one map at a time.

    ``semiring='mul_add'``: ``f(c) = a*c + b`` (linear recurrence);
    ``semiring='max_plus'``: ``f(c) = max(c + a, b)`` (ZNS event
    recurrence).  Returns the composed ``(A_i, B_i)`` such that ``c_i =
    f_i(...f_1(c_0))``.
    """
    if semiring not in ("mul_add", "max_plus"):
        raise ValueError(semiring)
    A, B = a.clone(), b.clone()
    for i in range(1, a.shape[0]):
        if semiring == "mul_add":
            A[i] = A[i - 1] * a[i]
            B[i] = B[i - 1] * a[i] + b[i]
        else:
            A[i] = A[i - 1] + a[i]
            B[i] = torch.maximum(B[i - 1] + a[i], b[i])
    return A, B
