"""Serve-step factories: prefill and single-token greedy decode.

The port of ``repro.serve.step``.  The steps run under
``torch.inference_mode`` and return the cache the next step takes: the
dense and MoE families update their KV cache in place (the reference donates the
cache buffer), the recurrent families return new states.

Under a sharding context (:func:`repro_torch.distributed.ctx.axis_rules`)
the steps serve as GSPMD partitions the reference's steps with the cache
sharded by ``cache_logical_axes``: :func:`serving_cut` resolves the
cache's specs (``tree_shardings_for``, sanitized against the global
batch and cache length) into a :class:`repro_torch.distributed.ctx
.RowCut`, the rows the batch dim is cut over and the slots' blocks over
``cache_seq``'s axes.  A step takes the global tokens, cuts this rank's
rows, runs under the cut (the cache it takes and returns is this rank's
block, ``(B / data, K, S / model, Dh)`` at the default rules; the decode
attention combines the blocks of slots over the seq axes) and gathers
the next tokens back to the global batch.  The decode step needs the
cache's global length for that: ``make_serve_step(cfg, max_seq)``.

The steps also take a rank's blocks of the parameters
(:func:`repro_torch.distributed.rank_local.serve_blocks`): they run
under the layout's :class:`repro_torch.distributed.ctx.ModelCut`, a rank
computes its attention heads, MLP columns, vocabulary block, RG-LRU
channels and Mamba2 heads (:mod:`repro_torch.distributed.tensor_parallel`;
the recurrent cache holds its channels' or heads' state, the KV cache
every key head of its block of slots), and the next token is the argmax
over the vocabulary's blocks.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import models as M
from repro_torch.distributed import ctx as dctx
from repro_torch.distributed import sharding as sh
from repro_torch.models.config import ModelConfig


#: The cache's logical axes a rank's block is cut on: its rows and its
#: slots, and the widths a rank computes a block of
#: (``tensor_parallel.local_names``: the RG-LRU's ``rnn``).  Mamba2's
#: heads are cut by :func:`cache_block`, not by a spec.
_CUT_AXES = ("batch", "cache_seq")


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int, mesh,
                rules) -> dict:
    """The specs of a rank's block of the ``batch``-row, ``max_seq``
    cache: ``tree_shardings_for`` of its shapes and
    ``cache_logical_axes`` (sanitized), kept on the ``batch`` and
    ``cache_seq`` dims and on those whose width the rank computes a
    block of.  Mamba2's ``"ssm_inner"`` is whole here: a rank on its
    heads holds their state ``(L, B, H / n, P, N)`` and their conv tail,
    the tail of its heads' x channels with B's and C's whole, which is
    no block of ``"ssm_inner"`` (nor is the state's ``"ssm_heads"`` cut
    by the rules: the reference keeps it whole).  That cut is the port's
    own: :func:`cache_block` gives its shapes."""
    from repro_torch.distributed.tensor_parallel import local_names
    axes = M.cache_logical_axes(cfg)
    keep = set(_CUT_AXES) | (local_names(cfg, mesh, rules) - {"ssm_inner"})
    specs = sh.tree_shardings_for(M.cache_spec(cfg, batch, max_seq), axes,
                                  mesh, rules)
    return {k: sh.PartitionSpec(*(e if name in keep else None
                                  for name, e in zip(axes[k], specs[k])))
            for k in axes}


def cache_block(cfg: ModelConfig, batch: int, max_seq: int, mesh,
                rules) -> dict:
    """A rank's block of the ``batch``-row, ``max_seq`` cache as
    ``meta`` tensors: :func:`cache_specs`' blocks, and where a rank
    computes Mamba2's heads (``"ssm_inner"`` in ``local_names``) its
    heads' state and conv tail (:func:`repro_torch.models.mamba2
    .init_cache`'s ``heads_blocks``)."""
    from repro_torch.distributed import rank_local
    from repro_torch.distributed.tensor_parallel import local_names
    specs = cache_specs(cfg, batch, max_seq, mesh, rules)
    full = M.cache_spec(cfg, batch, max_seq)
    if "ssm_inner" in local_names(cfg, mesh, rules):
        from repro_torch.models import mamba2
        n = mesh.extent(sh.spec_from_axes(("ssm_inner",), rules, mesh)[0])
        full = mamba2.init_cache(cfg, batch, max_seq, device="meta",
                                 heads_blocks=n)
    return rank_local.block_spec(full, specs, mesh)


def serving_cut(cfg: ModelConfig, batch: int,
                max_seq: int) -> Optional[dctx.RowCut]:
    """The cut of a ``batch``-row serving batch and its ``max_seq`` cache
    under the current sharding context: the mesh axes of more than one
    rank over which :func:`cache_specs` cuts the cache's ``batch`` dims
    and its ``cache_seq`` dims (every leaf the same); None outside a
    context, or where neither is cut."""
    c = dctx.current()
    if c is None:
        return None
    mesh, rules = c
    axes = M.cache_logical_axes(cfg)
    specs = cache_specs(cfg, batch, max_seq, mesh, rules)
    found = {name: set() for name in _CUT_AXES}
    for key, names in axes.items():
        for name, entry in zip(names, specs[key]):
            if name in found:
                found[name].add(dctx.spanning(mesh, entry))
    rows, seq = (found[k] or {()} for k in _CUT_AXES)
    if len(rows) != 1 or len(seq) != 1:
        raise ValueError(f"the cache's leaves cut their rows or slots over "
                         f"different axes: {specs}")
    rows, seq = rows.pop(), seq.pop()
    return dctx.RowCut(mesh, rows, seq) if rows or seq else None


def _take(cut, x):
    return x if cut is None or x is None else cut.take(x)


def _give(cut, tokens):
    return tokens if cut is None else cut.gather(tokens)


def _model_cut(params):
    """The :class:`repro_torch.distributed.ctx.ModelCut` of a rank's
    blocks of the parameters, None for whole parameters."""
    from repro_torch.distributed import rank_local
    layout = rank_local.layout_of(params)
    return None if layout is None else layout.model_cut()


def _next(cfg: ModelConfig, logits):
    """The greedy tokens: the argmax over the vocabulary, or over its
    blocks where the logits are a rank's block of it."""
    from repro_torch.distributed import tensor_parallel as tpar
    return tpar.argmax(tpar.split(logits.shape[-1], cfg.vocab_size), logits)


def make_prefill_step(cfg: ModelConfig, max_seq: int):
    """prefill_step(params, tokens, frontend_inputs=None) -> (next tokens
    (B,), or (B, Cb) for audio, cache).  Under a sharding context the
    tokens are the global batch and the cache this rank's block (see the
    module docstring)."""
    @torch.inference_mode()
    def prefill_step(params, tokens, frontend_inputs=None):
        cut = serving_cut(cfg, tokens.shape[0], max_seq)
        with dctx.row_cut(cut), dctx.model_cut(_model_cut(params)):
            logits, cache = M.prefill(cfg, params, _take(cut, tokens),
                                      max_seq, _take(cut, frontend_inputs))
            tok = _next(cfg, logits[:, -1])
        return _give(cut, tok), cache
    return prefill_step


def make_serve_step(cfg: ModelConfig, max_seq: Optional[int] = None):
    """serve_step(params, cache, tokens, pos) -> (next tokens, cache): one
    new token per sequence against the existing KV or recurrent cache.
    Under a sharding context the tokens are the global batch and the
    cache this rank's block of a ``max_seq`` cache, which must be
    given."""
    @torch.inference_mode()
    def serve_step(params, cache, tokens, pos):
        cut = None
        if dctx.current() is not None:
            if max_seq is None:
                raise ValueError("under a sharding context the serve step "
                                 "takes this rank's block of the cache: "
                                 "give make_serve_step the cache's max_seq")
            cut = serving_cut(cfg, tokens.shape[0], max_seq)
        with dctx.row_cut(cut), dctx.model_cut(_model_cut(params)):
            logits, cache = M.decode_step(cfg, params, cache,
                                          _take(cut, tokens), pos)
            tok = _next(cfg, logits)
        return _give(cut, tok), cache
    return serve_step


@torch.inference_mode()
def greedy_generate(cfg: ModelConfig, params, prompt, *, steps: int,
                    max_seq: int):
    """Prefill ``prompt`` (B, S), or (B, S, Cb) for audio, then ``steps -
    1`` decode steps; returns the (B, steps), or (B, steps, Cb), greedy
    tokens."""
    prefill = make_prefill_step(cfg, max_seq)
    step = make_serve_step(cfg, max_seq)
    tok, cache = prefill(params, prompt)
    toks = [tok]
    pos = prompt.shape[1]
    for i in range(steps - 1):
        tok, cache = step(params, cache, tok, pos + i)
        toks.append(tok)
    return torch.stack(toks, dim=1)
