"""Plain PyTorch oracles of the model kernels.

The port's counterparts of ``repro.kernels.ref`` (``attention_ref``,
``attention_xla_chunked``, ``rmsnorm_ref``): the same finite ``NEG_INF``
sentinel, query positions aligned to the end of the keys, GQA by head
repeat.  They are the semantic ground truth the tests hold the kernels'
plain versions against, and :func:`repro_torch.kernels.ops.attention`
sends a ``kv_length`` call here, as the reference does.
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
