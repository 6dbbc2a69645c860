"""Flash-decoding over a sequence-sharded KV cache.

The port of ``repro.distributed.flash_decode``: each rank along the seq
axis computes a partial (m, l, o) over its cache slice, and one small
``pmax`` and two ``psum``\\ s combine them: O(B·H·Dh) wire bytes a layer
instead of any logits gather.  The partials are plain products
(``torch.einsum``), as the reference's are plain ``einsum``\\ s.
"""
from __future__ import annotations

import math

import torch

from . import comm
from .mesh import Mesh, axis_index, shard_map
from .sharding import PartitionSpec as PS

NEG_INF = -1e30


def _partial_softmax_attend(q, k, v, valid):
    """q: (B,K,rep,Dh); k/v: (B,K,S_loc,Dh); valid: (B,S_loc) bool.
    Returns partial (o, m, l) in float32 for cross-shard combination."""
    logits = torch.einsum("bkrd,bksd->bkrs", q.float(), k.float())
    logits = logits / math.sqrt(q.shape[-1])
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    m = torch.amax(logits, dim=-1, keepdim=True)           # (B,K,rep,1)
    p = torch.exp(logits - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    o = torch.einsum("bkrs,bksd->bkrd", p.to(v.dtype).float(), v.float())
    return o, m, l


def combine(mesh: Mesh, q, k, v, valid, seq_axes, *, site: str = "body"):
    """Decode attention over a cache whose slots are cut over
    ``seq_axes``: this rank's partial (o, m, l) over its block ``k``/``v``
    (B, K, S_loc, Dh) of the query ``q`` (B, K, rep, Dh), its slots masked
    by ``valid`` (broadcasting to (B, S_loc)), then one ``pmax`` and two
    ``psum``\\ s over ``seq_axes``: the (B, K, rep, Dh) output in
    ``q``'s dtype on every rank along them."""
    o, m, l = _partial_softmax_attend(q, k, v, valid)
    # combine across seq shards: global max, rescale, sum
    m_g = comm.pmax(mesh, m, seq_axes, site=site)
    corr = torch.exp(m - m_g)
    o = comm.psum(mesh, o * corr, seq_axes, site=site)
    l = comm.psum(mesh, l * corr, seq_axes, site=site)
    return (o / torch.clamp(l, min=1e-30)).to(q.dtype)


def flash_decode(mesh: Mesh, q, cache_k, cache_v, pos, *,
                 seq_axis: str = "model", batch_axes=("data",)):
    """Distributed decode attention.

    q: (B, K, rep, Dh); cache_{k,v}: (B, K, S, Dh), global, computed with
    (batch_axes, None, seq_axis, None) blocks; ``pos``: the index of the
    current token (an int or a 0-d tensor; its key and value are in the
    cache already).  Returns the global (B, K, rep, Dh) output.  Where
    this rank holds only its rows of the batch already (a
    :class:`repro_torch.distributed.ctx.RowCut` on ``mesh``), q and the
    cache are those rows, and so is the output.
    """
    from .ctx import local_axes
    local = local_axes(mesh)
    ba = batch_axes if isinstance(batch_axes, tuple) else (batch_axes,)
    ba = tuple(a for a in ba if a not in local)
    b_spec = (ba[0] if len(ba) == 1 else ba) if ba else None

    def body(q_l, k_l, v_l, pos_l):
        s_loc = k_l.shape[2]
        shard = axis_index(mesh, seq_axis)
        kpos = shard * s_loc + torch.arange(s_loc, device=k_l.device)
        valid = (kpos <= pos_l)[None, :].expand(k_l.shape[0], s_loc)
        return combine(mesh, q_l, k_l, v_l, valid, seq_axis)

    return shard_map(
        body, mesh,
        in_specs=(PS(b_spec, None, None, None),
                  PS(b_spec, None, seq_axis, None),
                  PS(b_spec, None, seq_axis, None),
                  PS()),
        out_specs=PS(b_spec, None, None, None), local=local,
    )(q, cache_k, cache_v, pos)
