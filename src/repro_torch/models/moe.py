"""Mixture-of-Experts FFN with sort-based dispatch.

The port of ``repro.models.moe``.  Tokens are sorted by expert id (a
stable sort), scattered into a static ``(Et, capacity, D)`` buffer,
processed by three batched expert products (``torch.bmm`` over the
expert axis) and combined back with their top-k gate weights.  Tokens
past an expert's capacity are dropped (capacity-factor semantics); the
load-balancing loss ``aux`` is returned beside the output.

Where the port could silently differ from the reference, it does what
the reference does:

* top-k on float32 probabilities, ties broken toward the lower expert
  index as ``jax.lax.top_k`` does, renormalised over the k picks;
* a stable sort, so the order of an expert's tokens (and so which pass
  ``rank < capacity``) is the reference's;
* dropped entries are written to the extra row ``Et * cap`` only, which
  is thrown away; real slots are unique;
* the combine adds a token's k contributions one by one in ``x.dtype``,
  in the reference's scatter-add order (ascending expert id), never with
  atomics, so a bfloat16 sum rounds where the reference's does;
* padded experts (``moe_expert_pad``) keep their weights and their rows
  of the buffer but receive no token.

Variants: arctic-480b (128 experts, top-2, a dense FFN in parallel,
``moe_dense_parallel``) and qwen2-moe-a2.7b (60 routed experts, top-4,
an always-on shared expert, ``moe_shared_d_ff``).  With
``moe_impl="ep"`` under a sharding context
(:func:`repro_torch.distributed.ctx.axis_rules`), :func:`moe_block` runs
the expert-parallel schedule of
:func:`repro_torch.distributed.moe_parallel.moe_ffn_ep` on the context's
mesh instead; without one it runs :func:`moe_ffn`, as the reference does.

Where a rank holds only its rows of the batch (a
:class:`repro_torch.distributed.ctx.RowCut`), :func:`moe_ffn` routes
over the global token order, as GSPMD partitions the reference's
routing: the capacity comes from the global number of tokens, an entry's
rank within its expert is offset by the entries of that expert on the
ranks before this one (one all-gather of the E counts over the row
axes), so its slot is the global routing's, and ``aux`` is built from
the probabilities and top-1 counts summed over the global batch (one
``psum``, whose backward is a ``psum``: every rank's loss holds the same
``aux``, and the gradient's sum over the ranks divided by their number
gives its gradient once).  A rank's buffer keeps the global slots; the
other ranks' rows of it stay zero.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import common as cm
from .common import P
from .config import ModelConfig


def moe_spec(cfg: ModelConfig) -> dict:
    D, E, Fe = cfg.d_model, cfg.moe_num_experts, cfg.moe_d_ff
    Et = E + cfg.moe_expert_pad      # padded experts never receive tokens
    spec = {
        "router": P((D, E), ("embed", "experts_r")),
        "w_gate": P((Et, D, Fe), ("experts", "embed", "expert_mlp")),
        "w_up": P((Et, D, Fe), ("experts", "embed", "expert_mlp")),
        "w_down": P((Et, Fe, D), ("experts", "expert_mlp", "embed")),
    }
    if cfg.moe_shared_d_ff:
        spec["shared"] = cm.mlp_spec(cfg, cfg.moe_shared_d_ff)
    return spec


def _capacity(cfg: ModelConfig, n_tokens: int) -> int:
    cap = int(np.ceil(n_tokens * cfg.moe_top_k / cfg.moe_num_experts
                      * cfg.moe_capacity_factor))
    return max(int(np.ceil(cap / 8)) * 8, 8)   # pad for TPU tiling


@dataclasses.dataclass
class Routing:
    """One call's routing: each token's experts and gates ``(T, k)``, and
    the dispatch of the ``T * k`` (token, expert) entries in sorted
    order: ``order`` (the stable sort by expert), each entry's buffer
    ``slot`` (``Et * cap`` when dropped) and ``valid`` (kept)."""

    expert_idx: torch.Tensor
    gate_vals: torch.Tensor
    order: torch.Tensor
    slot: torch.Tensor
    valid: torch.Tensor
    cap: int


def route(cfg: ModelConfig, p, xf, cut=None) -> tuple:
    """Router, top-k, aux loss and sort-based dispatch of ``xf`` (T, D):
    returns ``(Routing, aux)``.  ``cut``: the rank's
    :class:`repro_torch.distributed.ctx.RowCut`, whose rows ``xf`` holds;
    the routing is then the global batch's (see the module docstring)."""
    n = cut.n_rows if cut is not None else 1
    return route_logits(cfg, xf.float() @ p["router"].float(),
                        _capacity(cfg, xf.shape[0] * n), cut=cut)


def _count(idx, n: int):
    """How often each of ``0 .. n - 1`` occurs in ``idx`` (int64), as
    ``torch.bincount(idx, minlength=n)`` for indices below ``n``, but with
    a shape that does not depend on the values, so that a fake-tensor
    trace (the dry run) can follow it."""
    return torch.zeros(n, dtype=torch.long, device=idx.device).scatter_add_(
        0, idx.long(), torch.ones_like(idx, dtype=torch.long))


def route_logits(cfg: ModelConfig, logits, cap: int, *, cut=None) -> tuple:
    """Top-k, aux loss and sort-based dispatch of T tokens' router
    ``logits`` (T, E) into ``cap`` slots an expert: ``(Routing, aux)``.
    ``cut``: a :class:`repro_torch.distributed.ctx.RowCut` whose rows the
    T tokens are; ``aux`` and the slots are then the global batch's."""
    T = logits.shape[0]
    k, E = cfg.moe_top_k, cfg.moe_num_experts
    probs = torch.softmax(logits.float(), dim=-1)              # (T, E)
    # top-k as jax.lax.top_k: largest first, ties to the lower index
    # (torch.topk leaves the order of ties open; a stable sort fixes it)
    gate_vals, expert_idx = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals, expert_idx = gate_vals[:, :k], expert_idx[:, :k]  # (T, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)

    # Aux load-balancing loss (Switch-style): E * sum_e f_e * p_e.
    top1 = _count(expert_idx[:, 0], E).float()
    flat_e = expert_idx.reshape(-1)                            # (T*k,)
    counts = _count(flat_e, E)                                 # (E,)
    if cut is not None and cut.rows:
        from repro_torch.distributed import comm
        from repro_torch.distributed.mesh import axis_index
        t_all = T * cut.n_rows
        sums = comm.psum(cut.mesh, torch.cat([probs.sum(0), top1]),
                         cut.rows, site="rows")
        me, fe = sums[:E] / t_all, sums[E:] / t_all
        # the entries of each expert on the ranks before this one
        every = cut.gather(counts.int()).view(cut.n_rows, E)
        before = every[:axis_index(cut.mesh, cut.rows)].sum(0).long()
    else:
        me, fe = probs.mean(0), top1 / T                       # (E,)
        before = torch.zeros_like(counts)
    aux = E * torch.sum(me * fe)

    order = torch.argsort(flat_e, stable=True)
    e_s = flat_e[order]
    starts = torch.cumsum(counts, 0) - counts - before         # exclusive
    rank = torch.arange(T * k, device=logits.device) - starts[e_s]
    Et = E + cfg.moe_expert_pad
    valid = rank < cap
    slot = torch.where(valid, e_s * cap + rank,
                       torch.full_like(rank, Et * cap))        # drop row
    return Routing(expert_idx, gate_vals, order, slot, valid, cap), aux


def moe_ffn(cfg: ModelConfig, p, x, *, record: Optional[list] = None):
    """x: (B, S, D) -> (y, aux).  ``record``, when a list, receives this
    call's :class:`Routing`."""
    from repro_torch.distributed.ctx import current_cut
    B, S, D = x.shape
    Et = cfg.moe_num_experts + cfg.moe_expert_pad
    xf = x.reshape(B * S, D)
    r, aux = route(cfg, p, xf, current_cut())
    if record is not None:
        record.append(r)
    out = experts(p, dispatch(r, xf, Et))
    return undispatch(out, r).reshape(B, S, D), aux


def dispatch(r: Routing, xf, et: int):
    """The ``(et, cap, D)`` expert buffer of tokens ``xf`` (T, D) routed
    by ``r``: real slots are unique; dropped entries land on an extra row,
    which is thrown away."""
    d = xf.shape[1]
    buf = xf.new_zeros((et * r.cap + 1, d))
    buf[r.slot] = xf[r.order // r.expert_idx.shape[1]]
    return buf[: et * r.cap].view(et, r.cap, d)


def experts(p, h):
    """The SwiGLU experts on their buffer ``h`` (E, cap, D), batched over
    the expert axis; ``p``'s expert weights lead with the same E."""
    g = torch.bmm(h, p["w_gate"].to(h.dtype))
    u = torch.bmm(h, p["w_up"].to(h.dtype))
    return torch.bmm(F.silu(g) * u, p["w_down"].to(h.dtype))


def undispatch(out, r: Routing):
    """Each token's gate-weighted sum of its experts' rows of ``out``
    (et, cap, D): ``(T, D)``; dropped entries add nothing."""
    out_flat = out.reshape(-1, out.shape[-1])
    gathered = torch.where(r.valid[:, None],
                           out_flat[r.slot.clamp(max=out_flat.shape[0] - 1)],
                           out_flat.new_zeros(()))
    gate_s = r.gate_vals.reshape(-1)[r.order]
    return combine(gathered * gate_s[:, None].to(out.dtype), r)


def combine(contrib, r: Routing):
    """Each token's sum of its sorted entries' contributions ``(T * k,
    D)``: ``(T, D)`` in ``contrib.dtype``.  The reference scatter-adds
    the sorted entries in order, so a token's k contributions are added
    one by one in ascending expert order (a token's experts are
    distinct), each sum rounded to the dtype; so are they here."""
    T, k = r.expert_idx.shape
    per_tok = torch.empty_like(contrib)
    per_tok[r.order] = contrib                        # (token, pick) order
    per_tok = per_tok.view(T, k, -1)
    by_expert = torch.argsort(r.expert_idx, dim=-1)
    per_tok = torch.gather(per_tok, 1,
                           by_expert[..., None].expand_as(per_tok))
    y = per_tok[:, 0]
    for j in range(1, k):
        y = y + per_tok[:, j]
    return y


def moe_block(cfg: ModelConfig, p, x, *, record: Optional[list] = None):
    """The full FFN half of an MoE layer (routed + shared/dense paths).
    Under expert parallelism the routed experts are the rank's block of
    them where the rules cut ``experts`` over ``model`` (passed to
    :func:`repro_torch.distributed.moe_parallel.moe_ffn_ep` as they are),
    else every expert, which that function cuts; without it
    (:func:`moe_ffn`) every rank along ``model`` computes every expert on
    its weights gathered whole (under sequence parallelism on the whole
    sequence).  The shared expert and the parallel
    dense MLP are :func:`repro_torch.models.common.mlp`, on the rank's
    block of their columns where the rules cut ``mlp`` over ``model``.
    ``p`` maps ``"moe"`` (and ``"dense_mlp"``) to the layer's
    parameters.  ``record``, when a list, receives the call's routing
    (this rank's local one on the expert-parallel path)."""
    c = None
    if cfg.moe_impl == "ep":
        from repro_torch.distributed import ctx as dctx
        c = dctx.current()
    if c is not None:
        from repro_torch.distributed.moe_parallel import moe_ffn_ep
        mesh = c[0]
        data_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
        y, aux = moe_ffn_ep(cfg, mesh, p["moe"], x, data_axes=data_axes,
                            record=record)
    else:
        # under sequence parallelism the routed experts, whole on every
        # rank, take the whole sequence and give back the rank's block
        from repro_torch.distributed import tensor_parallel as tpar
        y, aux = moe_ffn(cfg, p["moe"], tpar.enter(None, x), record=record)
        y = tpar.leave(None, y)
    if cfg.moe_shared_d_ff:
        y = y + cm.mlp(p["moe"]["shared"], x, cfg.moe_shared_d_ff)
    if cfg.moe_dense_parallel:
        y = y + cm.mlp(p["dense_mlp"], x, cfg.d_ff)
    return y, aux
