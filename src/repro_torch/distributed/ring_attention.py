"""Ring attention: sequence-parallel exact attention over a mesh axis.

The port of ``repro.distributed.ring_attention``.  Q, K, V are sharded
over the sequence dim on the ``seq_axis``; K/V blocks rotate around the
ring one step at a time (:func:`repro_torch.distributed.comm.ppermute`,
K and V together in one exchange) while each rank keeps a float32
online-softmax accumulator for its local queries.  A layer's wire cost
is K+V once around the ring (2·S·D_kv) against the TP all-reduce's
2·S·D_model; GQA is repeated locally, so the ring carries the unrepeated
K/V.

Causality: rank i's queries attend to K/V blocks j <= i, unmasked for
j < i and causally for j == i; blocks with j > i are masked to zero
contribution arithmetically, not skipped, so every rank runs the same
schedule.  The blocks are plain products (``torch.einsum``), as the
reference's are plain ``einsum``s outside any Pallas kernel.
Differentiable: gradients go back around the ring through ``ppermute``'s
inverse permutation.
"""
from __future__ import annotations

import math

import torch

from . import comm
from .mesh import Mesh, axis_index, shard_map
from .sharding import PartitionSpec as PS

NEG_INF = -1e30


def _block_attend(q, k, v, mask, scale):
    """q: (B,H,Sq,D) f32; k: (B,H,Sk,D) f32; v: (B,H,Sk,D); mask: (Sq,Sk)
    bool.  Returns partial (o, m, l) in f32 (the probabilities rounded to
    v's dtype before the product, as the reference's ``p.astype(v.dtype)``
    with a float32 result)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    s = torch.where(mask[None, None], s, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    m_safe = torch.clamp(m, min=-1e29)       # guard fully-masked rows
    p = torch.exp(s - m_safe)
    l = torch.sum(p, dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return o, m_safe, l


def ring_attention(mesh: Mesh, q, k, v, *, causal: bool = True,
                   scale=None, seq_axis: str = "model",
                   batch_axes=("data",)):
    """q: (B, Hq, S, D), k/v: (B, Hkv, S, D), global.  Returns the global
    (B, Hq, S, D), computed with S sharded over ``seq_axis`` and B over
    the ``batch_axes`` present in the mesh.  Where this rank holds only
    its rows of the batch already (a
    :class:`repro_torch.distributed.ctx.RowCut` on ``mesh``), q, k, v and
    the output are those rows: not cut again, not gathered back."""
    from .ctx import local_axes
    local = local_axes(mesh)
    n = mesh.shape[seq_axis]
    hq, d = q.shape[1], q.shape[3]
    rep = hq // k.shape[1]
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    ba = tuple(a for a in batch_axes if a in mesh.axis_names
               and a not in local)
    b_spec = ba[0] if len(ba) == 1 else (ba if ba else None)

    def body(q_l, k_l, v_l):
        bl, hl, s_loc, dl = q_l.shape
        sid = axis_index(mesh, seq_axis)
        ar = torch.arange(s_loc, device=q_l.device)
        qpos = sid * s_loc + ar
        q32 = q_l.float()
        acc = q32.new_zeros((bl, hl, s_loc, dl))
        m_run = q32.new_full((bl, hl, s_loc, 1), NEG_INF)
        l_run = q32.new_zeros((bl, hl, s_loc, 1))
        perm = [(i, (i - 1) % n) for i in range(n)]   # kv moves to rank-1
        kv = torch.stack((k_l, v_l))
        for step in range(n):
            src = (sid + step) % n                     # kv shard held now
            kpos = src * s_loc + ar
            if causal:
                mask = kpos[None, :] <= qpos[:, None]
            else:
                mask = torch.ones((s_loc, s_loc), dtype=torch.bool,
                                  device=q_l.device)
            k_cur, v_cur = kv[0], kv[1]
            if rep > 1:
                k_cur = k_cur.repeat_interleave(rep, dim=1)
                v_cur = v_cur.repeat_interleave(rep, dim=1)
            o, m, l = _block_attend(q32, k_cur.float(), v_cur, mask, scale)
            m_new = torch.maximum(m_run, m)
            c_old = torch.exp(m_run - m_new)
            c_blk = torch.exp(m - m_new)
            acc = acc * c_old + o * c_blk
            l_run = l_run * c_old + l * c_blk
            m_run = m_new
            if step != n - 1:
                kv = comm.ppermute(mesh, kv, seq_axis, perm)
        out = acc / torch.clamp(l_run, min=1e-30)
        return out.to(q_l.dtype)

    spec = PS(b_spec, None, seq_axis, None)
    return shard_map(body, mesh, in_specs=(spec, spec, spec),
                     out_specs=spec, local=local)(q, k, v)
