"""Tensor parallelism over the ``model`` axis: Megatron's column and row
products, as GSPMD partitions the reference's step with its rules.

The reference's rules put the vocabulary, the attention's query heads,
the MLP's hidden columns, the RG-LRU's channels and the MoE's experts
on ``"model"`` (``repro.distributed.sharding.make_rules``); GSPMD then
computes each device's heads, columns and experts.  Here a rank holds
the same blocks (:mod:`repro_torch.distributed.rank_local` gathers such
a leaf over its other axes only, or the serve steps take the blocks as
they are), runs under a :class:`repro_torch.distributed.ctx.ModelCut`,
and the model code computes on the blocks it is given:

* a *column* product (``wq``, ``w_gate`` / ``w_up``, ``proj_x``, the LM
  head) takes its input through :func:`copy_in`: the identity forward,
  an all-reduce over the cut's axes backward (each rank's gradient of
  the input is a partial sum over its columns);
* a *row* product (``wo``, ``w_down``, ``out_proj``) gives its partial
  sum through :func:`reduce_out`: an all-reduce forward, the identity
  backward;
* a weight the rules leave whole but that a rank applies to its block
  only (``wk`` / ``wv``, whose ``kv_heads`` map to no mesh axis; the
  query and key norms; the RG-LRU's gate blocks) goes through
  :func:`copy_in` too: each rank's gradient of it is a partial sum;
* the vocabulary-parallel pieces: :func:`embed` (a lookup of the tokens
  in this rank's rows of the table, the others zero; the caller
  reduces out), :func:`cross_entropy` (the row maximum by an all-reduce
  MAX, detached; the sum of exponentials and the target logit by one
  all-reduce SUM) and :func:`argmax` (ties to the lowest global index,
  as ``torch.argmax`` breaks them);
* under ring attention, the query heads' block is traded for a
  sequence block by a tiled all-to-all over ``model`` and back
  (:func:`repro_torch.distributed.ring_attention.ring_attention_heads`,
  GSPMD's reshard of the heads for the reference's ring);
* under expert parallelism (``moe_impl="ep"``) the experts' block is
  the rank's experts: :func:`repro_torch.distributed.moe_parallel
  .moe_ffn_ep` computes on it as it is.

* Mamba2 on a rank's heads (``"ssm_inner"`` cut over ``model``, the
  model extent dividing ``ssm_heads``): ``in_proj``, ``conv_w`` and
  ``conv_b`` hold contiguous blocks of ``"ssm_inner"`` that mix z, x, B,
  C and dt, so they are gathered whole where they are read
  (:func:`computes_block` says which leaves; the rank's head columns are
  sliced from them, B and C whole, through :func:`copy_in`), while
  ``out_proj`` and the gated norm's weight are read as their blocks
  (their rows are whole heads).  The gated norm's mean of squares is
  summed over the cut (:func:`repro_torch.kernels.ops.rmsnorm_cut`, one
  float32 a row all-reduced forward and one backward).
* Megatron's sequence parallelism (``cfg.seq_parallel``,
  :func:`sequence_parallel`): the residual stream between the sublayers
  is the rank's block of S / n positions; a sublayer's input is
  all-gathered over the sequence (:func:`enter`, whose backward is a
  reduce-scatter) and its row product's partial sums reduce-scattered
  back (:func:`leave`, whose backward is an all-gather), in place of
  :func:`copy_in` / :func:`reduce_out`; the norms on the block take their
  weights through :func:`copy_in` over :func:`seq_cut` (each rank's
  gradient of them is a partial sum over its positions).  A sublayer whose width stays whole
  computes the whole sequence on every rank, as it does without SP.

Which widths are cut is the rules' decision, resolved once
(:func:`local_names`): a leaf the rules leave whole over ``model``, or
that ``sanitize`` keeps whole, is computed whole, and so is a width that
the model extent does not divide.  The model code reads it from the
shapes it is given (:func:`split`).  What stays whole by design: the
MoE's routed experts under ``moe_impl="gspmd"`` (gathered whole: the
sort-based dispatch runs on every expert).  Sequence parallelism does
not combine with ring attention or expert parallelism: those raise.

Every collective here goes through :mod:`repro_torch.distributed.mesh`
and is recorded at :mod:`repro_torch.utils.comm_stats`' ``"tp"`` site;
:func:`collectives` is their arithmetic and :func:`train_flops` the
products a rank traces.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from .ctx import ModelCut, current_model_cut, model_cut, spanning
from .mesh import all_gather_dim, all_reduce, reduce_scatter_dim

#: The logical axes whose widths a rank computes a block of, when the
#: rules cut them over the mesh (the reference's "TP over model", and
#: its expert parallelism).
TP_NAMES = ("vocab", "heads", "mlp", "rnn", "ssm_inner", "experts")

#: Mamba2's leaves on ``"ssm_inner"`` whose contiguous blocks mix z, x,
#: B, C and dt: gathered whole where they are read, the rank's head
#: columns sliced from them.
MIXED = ("in_proj", "conv_w", "conv_b")

SITE = "tp"


def local_names(cfg, mesh, rules) -> frozenset:
    """The logical axes of ``cfg``'s parameters that a rank computes a
    block of on ``mesh`` under ``rules``: :data:`TP_NAMES` where the
    rules cut them over axes of more than one rank, less what stays
    whole by design (see the module docstring).  The RG-LRU's channels
    are cut only where its gate blocks divide too, the experts only
    under expert parallelism (``moe_impl="ep"``, whose
    :func:`repro_torch.distributed.moe_parallel.moe_ffn_ep` raises
    unless the experts with their pad divide the axis), Mamba2's
    ``"ssm_inner"`` only where the extent divides its heads (the rank
    computes whole heads); names no parameter of ``cfg`` carries are
    left out.  ``cfg.seq_parallel`` changes none of them."""
    from repro_torch import models as M
    from . import sharding as sh

    def carried(tree):
        if isinstance(tree, dict):
            return set().union(*(carried(v) for v in tree.values()))
        return set(tree)
    present = carried(M.logical_axes(cfg))
    out = set()
    for name in TP_NAMES:
        if name not in present:
            continue
        entry = sh.spec_from_axes((name,), rules, mesh)
        ax = spanning(mesh, entry[0] if len(entry) else None)
        if not ax:
            continue
        if name == "experts" and cfg.moe_impl != "ep":
            continue
        if name == "rnn" and (cfg.family != "hybrid"
                              or cfg.num_heads % mesh.extent(ax)):
            continue
        if name == "ssm_inner" and (cfg.family != "ssm"
                                    or cfg.ssm_heads % mesh.extent(ax)):
            continue
        out.add(name)
    return frozenset(out)


def computes_block(path: tuple, name: str, names) -> bool:
    """Whether a rank reads the leaf at ``path`` as its block along the
    dim of logical axis ``name`` (the rank computes on that block), given
    the cut names ``names``; else it gathers that dim whole.  Mamba2's
    :data:`MIXED` leaves are gathered whole: their blocks are not whole
    heads."""
    return name in names and not (name == "ssm_inner" and path
                                  and path[-1] in MIXED)


def split(local: int, width: int) -> Optional[ModelCut]:
    """The :class:`ModelCut` a product over ``width`` computes on, where
    the weight holds a block of ``local`` of it; None where it holds the
    whole width."""
    if local == width:
        return None
    tp = current_model_cut()
    if tp is None or local * tp.n != width:
        raise ValueError(
            f"a weight holds {local} of {width} columns, but the rank's "
            f"model cut is {tp}: run under ctx.model_cut with the "
            f"layout's cut (rank_local.Layout.model_cut)")
    return tp


# ---------------------------------------------------------------------------
# Megatron's sequence parallelism
# ---------------------------------------------------------------------------
def seq_cut() -> Optional[ModelCut]:
    """The current model cut where sequence parallelism is on, else
    None."""
    tp = current_model_cut()
    return tp if tp is not None and tp.seq else None


def applies(cfg, seq: int) -> bool:
    """Whether a forward over ``seq`` positions runs sequence-parallel
    under the current model cut: ``cfg.seq_parallel``, a cut, and a
    sequence of more than one position that divides by its extent (a
    decode step, or a sequence that does not divide, runs as TP alone,
    as the reference's ``sanitize`` drops the axis)."""
    tp = current_model_cut()
    return bool(cfg.seq_parallel and tp is not None and seq > 1
                and seq % tp.n == 0)


@contextlib.contextmanager
def sequence_parallel(cfg, seq: int):
    """Run the block with the current model cut's sequence parallelism on
    where :func:`applies` (the residual stream is then the rank's block of
    ``seq / n`` positions); yields whether it is.  Ring attention and
    expert parallelism do not combine with it: they raise."""
    on = applies(cfg, seq)
    if on and cfg.ring_attention:
        raise ValueError("seq_parallel with ring_attention: the ring "
                         "shards the sequence over 'model' itself; set one")
    if on and cfg.moe_num_experts and cfg.moe_impl == "ep":
        raise ValueError("seq_parallel with moe_impl='ep': expert "
                         "parallelism takes the whole sequence of a rank's "
                         "rows; use moe_impl='gspmd'")
    if not on:
        yield False
        return
    with model_cut(dataclasses.replace(current_model_cut(), seq=True)):
        yield True


def _seq_block(sp: ModelCut, x: torch.Tensor) -> torch.Tensor:
    n = x.shape[1] // sp.n
    return x.narrow(1, sp.index * n, n).clone(
        memory_format=torch.contiguous_format)


class _SeqGather(torch.autograd.Function):
    """The whole sequence from the ranks' blocks (dim 1); backward: the
    sum of the ranks' partial gradients cut to this rank's block (a
    reduce-scatter), or, where every rank computed the same gradient
    (``summed`` False), this rank's block of it."""

    @staticmethod
    def forward(ctx, x, sp, summed):
        ctx.sp, ctx.summed = sp, summed
        return all_gather_dim(sp.mesh, x, sp.axes, 1, site=SITE)

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            return reduce_scatter_dim(ctx.sp.mesh, g, ctx.sp.axes, 1,
                                      site=SITE), None, None
        return _seq_block(ctx.sp, g), None, None


class _SeqScatter(torch.autograd.Function):
    """The ranks' partial sums over the whole sequence, reduce-scattered
    to this rank's block; backward: the all-gather of the blocks'
    gradients."""

    @staticmethod
    def forward(ctx, x, sp):
        ctx.sp = sp
        return reduce_scatter_dim(sp.mesh, x, sp.axes, 1, site=SITE)

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(ctx.sp.mesh, g, ctx.sp.axes, 1,
                              site=SITE), None


class _SeqTake(torch.autograd.Function):
    """This rank's block of a sequence every rank computed whole;
    backward: the all-gather of the blocks' gradients (every rank then
    runs the whole backward, as it ran the whole forward)."""

    @staticmethod
    def forward(ctx, x, sp):
        ctx.sp = sp
        return _seq_block(sp, x)

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(ctx.sp.mesh, g, ctx.sp.axes, 1,
                              site=SITE), None


def enter(tp: Optional[ModelCut], x: torch.Tensor) -> torch.Tensor:
    """A sublayer's input ``x`` (B, S, ...) into its region: without
    sequence parallelism :func:`copy_in` (``tp``: the sublayer's cut, None
    where its width is whole); with it the all-gather of the sequence,
    whose backward reduce-scatters the partial gradients (or, where the
    width is whole and every rank computes alike, takes the rank's
    block)."""
    sp = seq_cut()
    if sp is None:
        return copy_in(tp, x)
    return _SeqGather.apply(x, sp, tp is not None)


def leave(tp: Optional[ModelCut], x: torch.Tensor) -> torch.Tensor:
    """A sublayer's output ``x`` (B, S, ...) back to the residual stream:
    without sequence parallelism :func:`reduce_out`; with it the
    reduce-scatter of the partial sums to the rank's block of the
    sequence (where the width is whole, the rank's block of the whole
    output); the backward all-gathers the gradient."""
    sp = seq_cut()
    if sp is None:
        return reduce_out(tp, x)
    if tp is None:
        return _SeqTake.apply(x, sp)
    return _SeqScatter.apply(x, sp)


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(ctx.tp.mesh, g, ctx.tp.axes, site=SITE), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return all_reduce(tp.mesh, x, tp.axes, site=SITE)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_in(tp: Optional[ModelCut], x: torch.Tensor) -> torch.Tensor:
    """``x`` into a region of blocks: the identity; its gradient summed
    over the cut's axes."""
    if tp is None or not torch.is_grad_enabled():
        return x
    return _CopyIn.apply(x, tp)


def reduce_out(tp: Optional[ModelCut], x: torch.Tensor) -> torch.Tensor:
    """The sum of the ranks' partial ``x`` over the cut's axes; its
    gradient is the identity."""
    if tp is None:
        return x
    return _ReduceOut.apply(x, tp)


def gather_heads(tp: Optional[ModelCut], x: torch.Tensor,
                 dim: int) -> torch.Tensor:
    """Every rank's block of ``x`` concatenated on ``dim`` (no gradient:
    the decode step's query heads)."""
    if tp is None:
        return x
    return all_gather_dim(tp.mesh, x, tp.axes, dim, site=SITE)


def kv_heads(x: torch.Tensor, tp: Optional[ModelCut], hl: int, rep: int,
             dim: int = 1) -> torch.Tensor:
    """The key or value heads (on ``dim``) that this rank's ``hl`` query
    heads use, in the order that
    :func:`repro_torch.kernels.ops.attention` maps query head ``h`` to
    key head ``h // (hl / kv)``: the group's slice where the local heads
    are whole groups (``hl % rep == 0``) or lie in one group (``rep %
    hl == 0``), else one key head a query head."""
    if tp is None:
        return x
    h0 = tp.index * hl
    if hl % rep == 0:
        return x.narrow(dim, h0 // rep, hl // rep)
    if rep % hl == 0:
        return x.narrow(dim, h0 // rep, 1)
    idx = torch.arange(h0, h0 + hl, device=x.device) // rep
    return x.index_select(dim, idx)


def embed(tp: ModelCut, table: torch.Tensor, tokens) -> torch.Tensor:
    """This rank's part of the lookup of ``tokens`` in the vocabulary
    table whose rows ``table`` holds a block of: the rows of the tokens
    in its block, zero for the others (the sum over the ranks, by
    :func:`reduce_out`, is the lookup)."""
    vl = table.shape[0]
    t = tokens.long() - tp.index * vl
    inside = (t >= 0) & (t < vl)
    rows = table[torch.where(inside, t, torch.zeros_like(t))]
    return torch.where(inside[..., None], rows, rows.new_zeros(()))


def cross_entropy(tp: ModelCut, logits: torch.Tensor,
                  targets) -> torch.Tensor:
    """``logsumexp(logits) - logits[target]`` of each row over the
    vocabulary whose block of columns ``logits`` holds: the row maximum
    by an all-reduce MAX (detached, as the one-rank loss detaches it),
    the sum of exponentials and the target's logit by one all-reduce
    SUM (:func:`reduce_out`, so each rank's block gets its gradient)."""
    mesh, axes = tp.mesh, tp.axes
    lmax = torch.amax(logits, dim=-1, keepdim=True).detach()
    lmax = all_reduce(mesh, lmax, axes, op=dist.ReduceOp.MAX, site=SITE)
    sumexp = torch.sum(torch.exp(logits - lmax), dim=-1)
    vl = logits.shape[-1]
    t = targets.long() - tp.index * vl
    inside = (t >= 0) & (t < vl)
    tgt = torch.gather(logits, -1,
                       torch.where(inside, t, torch.zeros_like(t))[..., None])
    tgt = torch.where(inside, tgt[..., 0], tgt.new_zeros(()))
    sumexp, tgt = reduce_out(tp, torch.stack([sumexp, tgt])).unbind(0)
    return torch.log(sumexp) + lmax[..., 0] - tgt


def argmax(tp: Optional[ModelCut], logits: torch.Tensor) -> torch.Tensor:
    """``torch.argmax(logits, -1)`` of the vocabulary whose block of
    columns ``logits`` holds: each rank's largest logit and its global
    index (the first in the block), all-gathered once; the first rank
    holding the largest wins, so a tie goes to the lowest global index."""
    if tp is None:
        return torch.argmax(logits, dim=-1)
    val, idx = torch.max(logits, dim=-1)
    idx = idx + tp.index * logits.shape[-1]
    # a float32 index is exact below 2**24 (a vocabulary of 16.7M)
    pair = torch.stack([val, idx.to(val.dtype)], dim=-1)[None]
    every = all_gather_dim(tp.mesh, pair, tp.axes, 0, site=SITE)
    win = torch.argmax(every[..., 0], dim=0, keepdim=True)
    return torch.gather(every[..., 1], 0, win)[0].long()


# ---------------------------------------------------------------------------
# Arithmetic
# ---------------------------------------------------------------------------
def _cut(cfg, names, n: int) -> dict:
    """The width each product computes on a rank, given the logical axes
    ``names`` that are cut ``n`` ways: heads, MLP columns (and the MoE's
    shared expert's), vocabulary, RG-LRU channels, Mamba2's heads, and
    whether each is cut."""
    def w(name, width):
        return width // n if name in names and width % n == 0 else width
    di = cfg.d_model
    return {"heads": w("heads", cfg.num_heads),
            "mlp": w("mlp", cfg.d_ff),
            "shared": (w("mlp", cfg.moe_shared_d_ff)
                       if cfg.moe_shared_d_ff else 0),
            "vocab": w("vocab", cfg.vocab_size),
            "rnn": w("rnn", di),
            "ssm": w("ssm_inner", cfg.ssm_heads) if cfg.ssm_heads else 0}


def seq_parallel_on(cfg, names, n: int, seq: int, kind: str) -> bool:
    """Whether a step of ``kind`` over ``seq`` positions runs
    sequence-parallel (:func:`applies`, from the arithmetic's side: a
    width is cut, so the step runs under a model cut)."""
    return bool(cfg.seq_parallel and names and n > 1 and kind != "decode"
                and seq > 1 and seq % n == 0)


def collectives(cfg, names, n: int, rows: int, seq: int,
                kind: str = "train", seq_cut: bool = False) -> dict:
    """The ``"tp"`` site's collectives of one microbatch of ``rows`` x
    ``seq`` tokens on a rank whose widths ``names`` (:func:`local_names`)
    are cut ``n`` ways, each a ``(count, result bytes)``: ``"unit"`` one
    layer's (or pattern group's), ``"tail"`` one of the hybrid's
    trailing rec blocks (run outside the remat regions), ``"rest"`` the
    embedding's, the final norm's, the head's and the loss's, each as
    ``{"fwd", "bwd"}``: one forward run (a remat recompute runs a unit's
    again: :func:`step_collectives`) and one backward; and the unit's
    ``"last"``, the forward's collectives after its last product (a
    unit's own recompute stops before it).  ``kind``: ``"train"`` (the
    loss's too), ``"prefill"`` / ``"decode"`` (the greedy argmax's, no
    backward; a decode step's ``seq`` is 1, and its query heads are
    all-gathered where the cache's slots are cut, ``seq_cut``).  Under
    ring attention (no window, ``seq`` dividing by ``n``, not a decode)
    a unit's attention trades its query heads for a sequence block and
    back, two tiled all-to-alls a forward and two a backward.  Under
    sequence parallelism (:func:`seq_parallel_on`) each sublayer's input
    is all-gathered over the sequence and its output reduce-scattered
    (a whole width's output is the rank's block, no collective), the
    backward the other way round, and each norm on the residual stream
    sums its weight's gradient; a prefill gathers the last hidden
    states before the head.  Mamba2 on a rank's heads sums its gated
    norm's squares forward and its rows' dot products backward (one
    value of the compute dtype a row), and the gradients of the weights
    it reads whole (``in_proj``, ``conv_w``, ``conv_b``, ``a_log``,
    ``d_skip``, ``dt_bias``).  Result bytes: an all-reduce's operand, an
    all-gather's result, an all-to-all's operand, a reduce-scatter's
    result.  The VLM's frontend inputs are not counted."""
    w = _cut(cfg, names, n)
    act = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    par = torch.empty((), dtype=getattr(torch, cfg.param_dtype)
                      ).element_size()
    lg = 8 if cfg.dtype == "float64" else 4         # the logits' dtype
    tok, d = rows * seq, cfg.d_model
    resid = tok * d * act                           # a (rows, seq, D)
    gather = kind == "decode" and seq_cut
    ring = (cfg.ring_attention and cfg.window is None and kind != "decode"
            and seq % n == 0)
    sp = seq_parallel_on(cfg, names, n, seq, kind)

    def tally():
        return {"fwd": [0, 0], "bwd": [0, 0]}

    def add(t, way, count, nbytes):
        t[way][0] += count
        t[way][1] += count * nbytes

    def enter(t, cut):
        if sp:
            add(t, "fwd", 1, resid)                 # the sequence gathered
            if cut:
                add(t, "bwd", 1, resid // n)        # its reduce-scatter
        elif cut:
            add(t, "bwd", 1, resid)                 # copy-in's all-reduce

    def leave(t, cut):
        if sp:
            if cut:
                add(t, "fwd", 1, resid // n)        # the reduce-scatter
            add(t, "bwd", 1, resid)                 # the gradient gathered
        elif cut:
            add(t, "fwd", 1, resid)                 # reduce-out

    def norm(t):
        if sp:
            add(t, "bwd", 1, d * par)

    def attention(t):
        cut = w["heads"] != cfg.num_heads
        norm(t)
        enter(t, cut)
        leave(t, cut)                               # wo's sum
        if not cut:
            return
        if ring:
            # q to sequence blocks, the output back to heads
            heads = rows * w["heads"] * seq * cfg.head_dim * act
            add(t, "fwd", 2, heads)
            add(t, "bwd", 2, heads)
        if gather:
            add(t, "fwd", 1, rows * cfg.num_heads * cfg.head_dim * act)
        # copy-in of wk and wv, of the q/k norms
        add(t, "bwd", 2, d * cfg.num_kv_heads * cfg.head_dim * par)
        if cfg.qk_norm:
            add(t, "bwd", 2, cfg.head_dim * par)

    def rec(t):
        cut = w["rnn"] != d
        norm(t)
        enter(t, cut)
        leave(t, cut)                               # out_proj's sum
        if cut:
            bs = d // cfg.num_heads
            add(t, "bwd", 2, cfg.num_heads * bs * bs * par)   # w_a, w_i

    def mamba(t):
        nh = cfg.ssm_heads
        cut = w["ssm"] != nh
        norm(t)
        enter(t, cut)
        leave(t, cut)                               # out_proj's sum
        if not cut:
            return
        ct = 8 if cfg.dtype == "float64" else 4
        add(t, "fwd", 1, tok * ct)                  # the gated norm's squares
        add(t, "bwd", 1, tok * ct)                  # its rows' dot products
        conv = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
        for width in (d * (conv + cfg.d_inner + nh),     # in_proj
                      cfg.conv_width * conv, conv,       # conv_w, conv_b
                      nh, nh, nh):                  # a_log, d_skip, dt_bias
            add(t, "bwd", 1, width * par)

    def mlp(t, width, local):
        if width:
            enter(t, local != width)
            leave(t, local != width)

    unit, tail = tally(), tally()
    if cfg.family == "hybrid":
        for b in cfg.block_pattern:
            (rec if b == "rec" else attention)(unit)
            norm(unit)
            mlp(unit, cfg.d_ff, w["mlp"])
        rec(tail)
        norm(tail)
        mlp(tail, cfg.d_ff, w["mlp"])
    elif cfg.family == "ssm":
        mamba(unit)
    else:
        attention(unit)
        norm(unit)
        if cfg.moe_num_experts:
            enter(unit, False)                      # the routed experts,
            leave(unit, False)                      # whole on every rank
            mlp(unit, cfg.moe_shared_d_ff, w["shared"])
            if cfg.moe_dense_parallel:
                mlp(unit, cfg.d_ff, w["mlp"])
        else:
            mlp(unit, cfg.d_ff, w["mlp"])
    # the unit's last product: its last sublayer's row product, whose sum
    # follows it where that width is cut
    if cfg.family == "ssm":
        last = w["ssm"] != cfg.ssm_heads
    elif cfg.moe_num_experts and not cfg.moe_dense_parallel:
        last = cfg.moe_shared_d_ff and w["shared"] != cfg.moe_shared_d_ff
    else:
        last = w["mlp"] != cfg.d_ff
    unit["last"] = ([1, resid // n if sp else resid] if last else [0, 0])

    rest = tally()
    vcut = w["vocab"] != cfg.vocab_size
    lookup = tok * d * par
    if sp:
        if vcut:
            add(rest, "fwd", 1, lookup // n)        # the lookup scattered
        add(rest, "bwd", 1, lookup)                 # its gradient gathered
    elif vcut:
        add(rest, "fwd", 1, lookup)                 # the lookup
    norm(rest)                                      # the final norm
    cb = max(cfg.num_codebooks, 1)
    if kind == "train":
        enter(rest, vcut)                           # the head's input
        if vcut:
            pos = rows * (seq - 1) * cb
            add(rest, "fwd", 1, pos * lg)           # the row maximum
            add(rest, "fwd", 1, 2 * pos * lg)       # sumexp, target
    else:
        if sp:
            add(rest, "fwd", 1, resid)              # the hidden gathered
        if vcut:
            add(rest, "fwd", 1, n * 2 * rows * cb * lg)  # the argmax
    return {k: {way: tuple(v) for way, v in t.items()}
            for k, t in (("unit", unit), ("tail", tail), ("rest", rest))}


def _units(cfg) -> tuple:
    """``(stacked units, tail rec blocks)``."""
    if cfg.family == "hybrid":
        plen = len(cfg.block_pattern)
        groups = cfg.num_layers // plen
        return groups, cfg.num_layers - groups * plen
    return cfg.num_layers, 0


def step_collectives(cfg, names, n: int, rows: int, seq: int,
                     microbatches: int = 1) -> tuple:
    """``(count, result bytes)`` of the ``"tp"`` collectives of a train
    step of ``microbatches`` microbatches of ``rows`` x ``seq`` tokens a
    rank: a unit's forward once a unit forward, the remat recomputes
    included (:func:`repro_torch.models.common.layer_forward_runs`), less
    what follows its last product in each unit's own recompute
    (``torch.utils.checkpoint`` stops once it holds every tensor the
    backward saved); its backward once a unit; the tail's and the
    rest's once each."""
    from repro_torch.models.common import layer_forward_runs
    units, tail = _units(cfg)
    c = collectives(cfg, names, n, rows, seq)
    runs = layer_forward_runs(cfg, units)
    own = units if cfg.remat != "none" else 0
    u, t, r = c["unit"], c["tail"], c["rest"]
    return tuple(microbatches * (
        runs * u["fwd"][i] - own * u["last"][i] + units * u["bwd"][i]
        + tail * (t["fwd"][i] + t["bwd"][i]) + r["fwd"][i] + r["bwd"][i])
        for i in (0, 1))


def serve_collectives(cfg, names, n: int, rows: int, seq: int,
                      kind: str, seq_cut: bool = False) -> tuple:
    """``(count, result bytes)`` of the ``"tp"`` collectives of a serve
    step (``kind`` ``"prefill"`` or ``"decode"``, ``seq`` 1 for a decode;
    ``seq_cut``: the cache's slots cut) on a rank's ``rows``: every
    unit's and tail block's forward once, the lookup and the argmax."""
    units, tail = _units(cfg)
    c = collectives(cfg, names, n, rows, seq, kind, seq_cut)
    return tuple(units * c["unit"]["fwd"][i] + tail * c["tail"]["fwd"][i]
                 + c["rest"]["fwd"][i] for i in (0, 1))


def _layer_products(cfg, names, n: int, rows: int, seq: int) -> list:
    """The products of one layer's forward on a rank, in the order they
    run, as multiply-adds: ``[(name, MACs), ...]``.  A dense decoder
    layer's, the plain attention's masked scores counted whole (the
    trace's ``torch.einsum`` computes every score); a Mamba2 layer's,
    its plain SSD scan's products chunk by chunk (:func:`_ssd_products`)
    as one entry."""
    w = _cut(cfg, names, n)
    tok, d = rows * seq, cfg.d_model
    if cfg.family == "ssm":
        hl, p = w["ssm"], cfg.ssm_headdim
        gn = cfg.ssm_groups * cfg.ssm_state
        if hl != cfg.ssm_heads:     # the rank's groups: one, or whole ones
            gn = max(gn * hl // cfg.ssm_heads, cfg.ssm_state)
        return [("in_proj", tok * d * (2 * hl * p + 2 * gn + hl)),
                ("ssd", _ssd_products(cfg, rows, seq, hl)[0]),
                ("out_proj", tok * hl * p * d)]
    dh = cfg.head_dim
    hl, kv = w["heads"], cfg.num_kv_heads
    return [("q", tok * d * hl * dh), ("k", tok * d * kv * dh),
            ("v", tok * d * kv * dh),
            ("scores", rows * hl * seq * seq * dh),
            ("pv", rows * hl * seq * seq * dh),
            ("o", tok * hl * dh * d),
            ("gate", tok * d * w["mlp"]), ("up", tok * d * w["mlp"]),
            ("down", tok * w["mlp"] * d)]


def _ssd_products(cfg, rows: int, seq: int, heads: int) -> tuple:
    """``(forward, backward)`` MACs of the plain SSD scan
    (:func:`repro_torch.kernels.ssd_chunk_scan.ssd_torch`) on ``heads``
    heads of ``rows`` x ``seq``: per chunk of L the scores ``C B^T`` (L L
    N), their product with x (L L P), the inter-chunk output ``C S^T`` (L
    N P) and the state's update ``(x w)^T B`` (P L N).  Autograd takes
    each product's two operand gradients, but the first chunk's ``C S^T``
    (S is zero there, with no gradient) only one, and the last chunk's
    state update none (the final state is not used)."""
    L, N, P = cfg.ssm_chunk, cfg.ssm_state, cfg.ssm_headdim
    nc = -(-seq // L)
    bh = rows * heads
    fwd = bh * nc * (L * L * N + L * L * P + 2 * L * N * P)
    bwd = bh * (nc * 2 * (L * L * N + L * L * P) + (2 * nc - 1) * L * N * P
                + 2 * (nc - 1) * L * N * P)
    return fwd, bwd


def train_flops(cfg, names, n: int, rows: int, seq: int,
                microbatches: int = 1) -> float:
    """The product flops (2 a multiply-add) a rank traces in one train
    step of a dense transformer or of Mamba2 (``torch.utils
    .flop_counter``, the plain attention and SSD scan): each product
    forward once a layer forward (``layer_forward_runs``) and twice more
    in the backward (its two operands' gradients; the SSD scan's as
    :func:`_ssd_products` counts), the head's likewise.  A layer's own
    recompute stops before its last product (``torch.utils.checkpoint``
    stops once it holds every tensor the backward saved, and ``w_down``'s
    or ``out_proj``'s inputs are saved before it runs), so with remat
    each layer's last product runs once less than its others.  Under
    ring attention on a rank's heads the ring's blocks take every head on
    the rank's block of S / n queries against every key, masked blocks
    included: ``H x S / n x S``, the count of the rank's H / n heads over
    the whole sequence.  Sequence parallelism moves no product."""
    from repro_torch.models.common import layer_forward_runs
    if cfg.family not in ("dense", "ssm"):
        raise ValueError(f"train_flops counts the dense and ssm families, "
                         f"not {cfg.family!r}")
    w = _cut(cfg, names, n)
    L = cfg.num_layers
    runs = layer_forward_runs(cfg, L)
    prods = _layer_products(cfg, names, n, rows, seq)
    per = sum(m for _, m in prods)
    macs = (runs + 2 * L) * per
    if cfg.family == "ssm":
        fwd, bwd = _ssd_products(cfg, rows, seq, w["ssm"])
        macs += L * (bwd - 2 * fwd)
    if cfg.remat != "none":
        macs -= L * prods[-1][1]
    macs += 3 * rows * seq * cfg.d_model * w["vocab"]
    return 2.0 * microbatches * macs
