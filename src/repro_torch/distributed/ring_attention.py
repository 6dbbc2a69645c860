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
inverse permutation.  :func:`ring_attention_heads` is the form for a
rank that holds only its block of the query heads and every key head
over the whole sequence: the same blocks in the same order, each read
from the rank's own K/V, with no permute.
"""
from __future__ import annotations

import math

import torch

from . import comm
from .mesh import Mesh, axis_index, shard_map
from .sharding import PartitionSpec as PS
from .tensor_parallel import SITE

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


def _ring(mesh: Mesh, seq_axis: str, q_l, k_l, v_l, causal: bool,
          scale: float, rep: int):
    """The ring on this rank's blocks: q_l (b, H, s, D) its queries'
    sequence block; k_l / v_l (b, K, s, D) its keys' and values', which
    go round the ring, or (b, K, n·s, D) every block of them, each read
    in the ring's order with no exchange.  The output's block
    (b, H, s, D) in q's dtype."""
    n = mesh.shape[seq_axis]
    bl, hl, s_loc, dl = q_l.shape
    whole = k_l.shape[2] != s_loc
    sid = axis_index(mesh, seq_axis)
    ar = torch.arange(s_loc, device=q_l.device)
    qpos = sid * s_loc + ar
    q32 = q_l.float()
    acc = q32.new_zeros((bl, hl, s_loc, dl))
    m_run = q32.new_full((bl, hl, s_loc, 1), NEG_INF)
    l_run = q32.new_zeros((bl, hl, s_loc, 1))
    perm = [(i, (i - 1) % n) for i in range(n)]   # kv moves to rank-1
    kv = None if whole else torch.stack((k_l, v_l))
    for step in range(n):
        src = (sid + step) % n                     # kv shard held now
        kpos = src * s_loc + ar
        if causal:
            mask = kpos[None, :] <= qpos[:, None]
        else:
            mask = torch.ones((s_loc, s_loc), dtype=torch.bool,
                              device=q_l.device)
        if whole:
            k_cur, v_cur = (t.narrow(2, src * s_loc, s_loc)
                            for t in (k_l, v_l))
        else:
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
        if kv is not None and step != n - 1:
            kv = comm.ppermute(mesh, kv, seq_axis, perm)
    out = acc / torch.clamp(l_run, min=1e-30)
    return out.to(q_l.dtype)


def _batch_spec(mesh: Mesh, batch_axes, local):
    ba = tuple(a for a in batch_axes if a in mesh.axis_names
               and a not in local)
    return ba[0] if len(ba) == 1 else (ba if ba else None)


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
    d = q.shape[3]
    rep = q.shape[1] // k.shape[1]
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)

    def body(q_l, k_l, v_l):
        return _ring(mesh, seq_axis, q_l, k_l, v_l, causal, scale, rep)

    spec = PS(_batch_spec(mesh, batch_axes, local), None, seq_axis, None)
    return shard_map(body, mesh, in_specs=(spec, spec, spec),
                     out_specs=spec, local=local)(q, k, v)


def ring_attention_heads(mesh: Mesh, q, k, v, *, causal: bool = True,
                         scale=None, seq_axis: str = "model",
                         batch_axes=("data",)):
    """Ring attention on this rank's query heads, as GSPMD partitions
    the reference's ring where its rules cut the heads over ``seq_axis``
    too.  q: (B, H/n, S, D), this rank's block of the query heads (its
    linear index along ``seq_axis``, n ranks); k/v: (B, Hkv, S, D), every
    key head (``kv_heads`` map to no mesh axis).  Returns this rank's
    heads of the output, (B, H/n, S, D).

    One tiled all-to-all over ``seq_axis`` trades q's heads for sequence
    blocks (every head on this rank's block of S); the ring's blocks then
    run as in :func:`ring_attention`, in its order, on the K/V blocks
    this rank holds already (every rank holds them all, so nothing goes
    round the ring); the inverse all-to-all brings the output back to
    this rank's heads.  The two exchanges (and their backwards) are
    recorded at :mod:`repro_torch.utils.comm_stats`' ``"tp"`` site.  The
    region is tensor-parallel: each rank's gradient of k and v is its
    queries' share, a partial sum that the caller adds over ``seq_axis``
    (the key and value products take their weights and input through
    :func:`repro_torch.distributed.tensor_parallel.copy_in`).  The batch
    is cut over ``batch_axes`` as :func:`ring_attention` cuts it."""
    from .ctx import local_axes
    local = local_axes(mesh) + (seq_axis,)
    n = mesh.shape[seq_axis]
    d = q.shape[3]
    rep = q.shape[1] * n // k.shape[1]
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)

    def body(q_l, k_l, v_l):
        q_s = comm.all_to_all(mesh, q_l, seq_axis, 2, 1, site=SITE)
        out = _ring(mesh, seq_axis, q_s, k_l, v_l, causal, scale, rep)
        return comm.all_to_all(mesh, out, seq_axis, 1, 2, site=SITE)

    spec = PS(_batch_spec(mesh, batch_axes, local))
    return shard_map(body, mesh, in_specs=(spec, spec, spec),
                     out_specs=spec, local=local)(q, k, v)
