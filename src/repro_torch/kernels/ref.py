"""Plain PyTorch oracles of the model kernels.

The port's counterparts of ``repro.kernels.ref`` (``attention_ref``,
``attention_xla_chunked``, ``rmsnorm_ref``, ``linear_recurrence_ref``,
``ssd_ref``): the same finite ``NEG_INF`` sentinel, query positions
aligned to the end of the keys, GQA by head repeat, and the two
recurrences as sequential scans over time in float32.  They are the
semantic ground truth the tests hold the kernels' plain versions
against, and :func:`repro_torch.kernels.ops.attention` sends a
``kv_length`` call here, as the reference does.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

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
