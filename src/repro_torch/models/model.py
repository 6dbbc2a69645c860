"""Family dispatch: one API over the architectures.

    init_params(cfg, generator, device=)  -> Transformer (dense, moe, vlm
                                             and audio families), Mamba2
                                             (ssm), RecurrentGemma (hybrid)
    forward(cfg, params, tokens)          -> (logits, aux)
    train_forward(cfg, params, tokens)    -> the same, recorded by autograd
    loss_fn(cfg, params, batch)           -> (loss, {"nll", "aux"})
    bind_grads(cfg, params)               -> stacked gradient buffers
    init_cache / prefill / decode_step    -> serving entry points
    cache_spec(cfg, batch, max_seq)       -> init_cache's tree on "meta"
    count_params(cfg)                     -> exact (spec tree, no alloc)
    logical_axes / cache_logical_axes     -> the trees' logical axis
                                             tuples (distributed.sharding)

All six families are ported.  The VLM takes ``frontend_inputs``
(B, num_patches, D) in ``forward``, ``loss_fn`` (``batch[
"frontend_inputs"]``) and ``prefill``; the audio family takes (B, S,
Cb) tokens and gives (B, S, Cb, V) logits.  For the recurrent
families ``prefill`` returns the reference's zeroed cache for the prompt
(``repro.models.model.prefill``): decoding after it starts from a blank
state.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.torch_device import DEFAULT_DEVICE
from repro_torch.utils.tree import tree_leaves
from . import common as cm
from . import mamba2, rglru, specs, transformer
from .config import ModelConfig

_MODULES = {"dense": transformer, "moe": transformer, "vlm": transformer,
            "audio": transformer, "ssm": mamba2, "hybrid": rglru}


def _module(cfg: ModelConfig):
    if cfg.family in _MODULES:
        return _MODULES[cfg.family]
    raise ValueError(f"unknown family {cfg.family}")


def model_spec(cfg: ModelConfig):
    """The parameter spec tree of any family (for counting)."""
    if cfg.family == "ssm":
        return specs.mamba2_model_spec(cfg)
    if cfg.family == "hybrid":
        return specs.rglru_model_spec(cfg)
    return transformer.model_spec(cfg)


def init_params(cfg: ModelConfig, generator=None, *, device=DEFAULT_DEVICE,
                weight_std=None):
    """A random init from ``generator``: the reference's fan-in rule, or
    with ``weight_std`` every ``normal`` weight N(0, weight_std)."""
    return _module(cfg).init_params(cfg, generator, device=device,
                                    weight_std=weight_std)


def logical_axes(cfg: ModelConfig):
    """The parameters' logical axis tuples, shaped as the parameter tree
    (the input of :func:`repro_torch.distributed.sharding.tree_specs`)."""
    return _module(cfg).logical_axes(cfg)


def cache_logical_axes(cfg: ModelConfig):
    """The decode cache's logical axis tuples, shaped as ``init_cache``'s
    tree."""
    return _module(cfg).cache_logical_axes(cfg)


def forward(cfg: ModelConfig, params, tokens, frontend_inputs=None):
    return _module(cfg).forward(cfg, params, tokens, frontend_inputs)


def train_forward(cfg: ModelConfig, params, tokens, frontend_inputs=None):
    return _module(cfg).train_forward(cfg, params, tokens, frontend_inputs)


# ---------------------------------------------------------------------------
# Loss and gradients
# ---------------------------------------------------------------------------
def loss_fn(cfg: ModelConfig, params, batch, *, aux_weight: float = 0.01):
    """Next-token cross-entropy (+ MoE aux loss), the port of
    ``repro.models.model.loss_fn``.

    batch: ``{"tokens": (B, S) or (B, S, Cb)}``, and for the VLM optionally
    ``"frontend_inputs"`` (labels are the tokens shifted; audio averages
    over every codebook of every position).  The logits are float32
    (float64 for a float64 model); the row maximum is detached, the loss
    is ``mean(logsumexp - target logit) + aux_weight * aux``.  The target
    logit is gathered: the reference's one-hot contraction adds exact
    zeros to it, so the values are the same.  Where the logits are a
    rank's block of the vocabulary (cut over ``model``), the
    logsumexp and the target logit are reduced over the cut
    (:func:`repro_torch.distributed.tensor_parallel.cross_entropy`).
    Returns ``(loss, {"nll", "aux"})``.
    """
    from repro_torch.distributed import tensor_parallel as tpar
    tokens = batch["tokens"]
    logits, aux = train_forward(cfg, params, tokens,
                                batch.get("frontend_inputs"))
    targets = tokens[:, 1:]
    logits = logits[:, :-1]
    tp = tpar.split(logits.shape[-1], cfg.vocab_size)
    if tp is not None:
        loss = torch.mean(tpar.cross_entropy(tp, logits, targets))
    else:
        lmax = torch.amax(logits, dim=-1, keepdim=True).detach()
        lse = torch.log(torch.sum(torch.exp(logits - lmax), dim=-1)) \
            + lmax[..., 0]
        tgt = torch.gather(logits, -1, targets[..., None].long())[..., 0]
        loss = torch.mean(lse - tgt)
    aux = torch.as_tensor(aux, dtype=loss.dtype, device=loss.device)
    return loss + aux_weight * aux, {"nll": loss, "aux": aux}


def bind_grads(cfg: ModelConfig, params) -> dict:
    """Zeroed gradient buffers in the reference's layout (layers stacked,
    in the parameters' dtypes), with every parameter's ``.grad`` a view of
    them: a backward then accumulates each layer's gradient in place into
    its slice, and the tree is the gradient tree of
    ``params.param_tree()`` with no copy.  A parameter is paired with the
    leaf whose storage it views (a rank-local module's parameters are its
    blocks' views, :mod:`repro_torch.distributed.rank_local`, so its
    buffers are block-sized)."""
    del cfg
    tree = params.param_tree()

    def zeros(node):
        return {k: zeros(v) if isinstance(v, dict) else torch.zeros_like(v)
                for k, v in node.items()}

    grads = zeros(tree)
    leaves, bufs = tree_leaves(tree), tree_leaves(grads)
    by_storage = {leaf.untyped_storage()._cdata: (leaf, g)
                  for leaf, g in zip(leaves, bufs)}
    for p in params.parameters():
        pair = by_storage.get(p.untyped_storage()._cdata)
        if pair is None:
            raise ValueError("bind_grads: a parameter views no leaf of the "
                             "model's parameter tree")
        leaf, g = pair
        p.grad = g.as_strided(p.shape, p.stride(), g.storage_offset()
                              + p.storage_offset() - leaf.storage_offset())
    return grads


def cache_spec(cfg: ModelConfig, batch: int, max_seq: int):
    """The decode cache's shapes and dtypes, shaped as ``init_cache``'s
    tree: tensors on the ``meta`` device (nothing is allocated)."""
    return _module(cfg).cache_spec(cfg, batch, max_seq)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
               device=DEFAULT_DEVICE):
    return _module(cfg).init_cache(cfg, batch, max_seq, device=device)


def prefill(cfg: ModelConfig, params, tokens, max_seq: int,
            frontend_inputs=None):
    return _module(cfg).prefill(cfg, params, tokens, max_seq,
                                frontend_inputs)


def decode_step(cfg: ModelConfig, params, cache, tokens, pos):
    return _module(cfg).decode_step(cfg, params, cache, tokens, pos)


# ---------------------------------------------------------------------------
# Param counting (exact, from the spec tree; no allocation)
# ---------------------------------------------------------------------------
def count_params(cfg: ModelConfig) -> int:
    return int(sum(np.prod(p.shape) for _, p in
                   cm.spec_leaves(model_spec(cfg))))


def count_active_params(cfg: ModelConfig) -> int:
    """Params touched per token (MoE experts scaled by top_k/E)."""
    total = 0
    for _, p in cm.spec_leaves(model_spec(cfg)):
        n = int(np.prod(p.shape))
        if "experts" in p.axes:
            n = int(n * cfg.moe_top_k / cfg.moe_num_experts)
        total += n
    return total


def model_flops(cfg: ModelConfig, n_tokens: int, kind: str) -> float:
    """MODEL_FLOPS for the roofline: 6·N_active·D for train, 2·N·D fwd."""
    n = count_active_params(cfg)
    mult = 6.0 if kind == "train" else 2.0
    return mult * n * n_tokens
