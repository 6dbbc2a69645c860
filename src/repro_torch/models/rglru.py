"""RecurrentGemma-style hybrid: RG-LRU recurrent blocks and local
attention in a (rec, rec, attn) pattern, each followed by a SwiGLU MLP.

The port of ``repro.models.rglru`` (recurrentgemma-9b).  The RG-LRU has
block-diagonal recurrence and input gates, a per-channel decay
``a = sigmoid(Lambda)`` raised to ``c * r_t`` and input scaled by
``sqrt(1 - a_t^2)``; its diagonal linear recurrence runs through
:func:`repro_torch.kernels.ops.linear_recurrence` (the CUDA kernel on a
card), prefill attention through the flash-attention kernel with the
local window, and every norm through the RMSNorm kernel.

The stack is ``groups`` pattern groups (stacked on a leading axis in the
reference's tree) and ``tail`` trailing rec blocks.  Decode runs the
reference's per-step form; local attention keeps a rolling window cache
(:func:`repro_torch.models.common.attention_decode`, written in place).
``decode_step`` returns the cache with new recurrent states.
``prefill`` returns the reference's zeroed cache sized for the prompt
(``init_cache(cfg, B, S)``), as ``repro.models.model.prefill`` does.
Where the rules cut ``rnn`` over ``model``, a rank runs its block of the
recurrent channels (:func:`rec_block`) and its cache holds their state.
Under Megatron's sequence parallelism the residual stream between the
blocks is the rank's block of the sequence (the recurrence runs over
the whole sequence inside each block).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.torch_device import DEFAULT_DEVICE, resolve_device
from repro_torch.distributed import tensor_parallel as tpar
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from . import common as cm
from .config import ModelConfig
from .mamba2 import causal_conv
from .specs import rglru_model_spec as model_spec


def _rec_dims(cfg: ModelConfig):
    di = cfg.d_model            # lru width = d_model (recurrentgemma)
    nb = cfg.num_heads          # gate block-diagonal blocks
    return di, nb, di // nb


def _pattern_counts(cfg: ModelConfig):
    plen = len(cfg.block_pattern)
    groups = cfg.num_layers // plen
    return plen, groups, cfg.num_layers - groups * plen


class RecurrentGemma(nn.Module):
    """The hybrid model's parameters: ``embed``, one :class:`ParamTree` per
    pattern group (views of the reference's stacked ``groups``, blocks
    keyed ``b{i}_{kind}``) and the trailing rec blocks ``tail``."""

    def __init__(self, cfg: ModelConfig, tree: dict):
        super().__init__()
        if cfg.family != "hybrid":
            raise ValueError(f"RecurrentGemma holds the hybrid family, not "
                             f"{cfg.family!r}")
        _, groups, tail = _pattern_counts(cfg)
        self.embed = cm.ParamTree(tree["embed"])
        self.groups = nn.ModuleList(
            cm.ParamTree(cm.index_tree(tree["groups"], i))
            for i in range(groups))
        self.tail = nn.ModuleList(cm.ParamTree(tree[f"tail{t}"])
                                  for t in range(tail))
        self._tree = tree

    def param_tree(self) -> dict:
        """The parameters in the reference's layout, groups stacked: the
        tensors this module's parameters are views of (no copy)."""
        return self._tree


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                *, device=DEFAULT_DEVICE,
                weight_std: Optional[float] = None) -> RecurrentGemma:
    """Random init from the spec tree, in ``cfg.param_dtype``, on
    ``device``; ``generator`` (on that device) defaults to seed 0.
    ``weight_std``: every ``normal`` weight N(0, weight_std) instead of
    the reference's fan-in rule (:meth:`repro_torch.models.common.P.initialize`)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    return RecurrentGemma(cfg, cm.init_from_spec(
        model_spec(cfg), generator, cm.torch_dtype(cfg.param_dtype), dev,
        weight_std))


# ---------------------------------------------------------------------------
# RG-LRU core
# ---------------------------------------------------------------------------
def block_linear(w, x):
    """Block-diagonal linear: w (nb, bs, bs); x (..., nb * bs)."""
    nb, bs, _ = w.shape
    xs = x.reshape(x.shape[:-1] + (nb, bs))
    return torch.einsum("...ni,nij->...nj", xs,
                        w.to(x.dtype)).reshape(x.shape)


def _gates(cfg: ModelConfig, p, u):
    """The decay ``a`` (float32; float64 for a float64 model) and input
    gate ``i`` (u's dtype)."""
    ct = kref.compute_dtype(u)
    r = torch.sigmoid(block_linear(p["w_a"], u) + p["b_a"].to(u.dtype))
    i = torch.sigmoid(block_linear(p["w_i"], u) + p["b_i"].to(u.dtype))
    log_a0 = F.logsigmoid(p["lam"].to(ct))                  # log a
    return torch.exp(cfg.rglru_c * r.to(ct) * log_a0), i


def rglru(cfg: ModelConfig, p, u):
    """u: (B, S, di) -> (B, S, di) from a zero state."""
    a, i = _gates(cfg, p, u)
    b = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * u).to(a.dtype)
    h = kops.linear_recurrence(a, b, impl=cm.kernel_impl(cfg))
    return h.to(u.dtype)


def _rec_cut(cfg: ModelConfig, p, proj_x):
    """``(model cut, gates)`` of a rec block: where ``proj_x`` (read by
    the caller: a rank-local weight is gathered at each read) holds a
    block of the channels (``rnn`` cut over ``model``), the cut and the
    rank's gate parameters: its channels of ``b_a``, ``b_i`` and ``lam``
    (held as blocks) and its ``nb / n`` blocks of ``w_a`` / ``w_i``
    (held whole, ``rnn_blocks`` maps to no axis; in through ``copy_in``,
    as each rank's gradient of them is a partial sum); else (None,
    ``p``)."""
    di, nb, _ = _rec_dims(cfg)
    tp = tpar.split(proj_x.shape[1], di)
    if tp is None:
        return None, p
    nl = nb // tp.n
    gates = {k: tpar.copy_in(tp, p[k]).narrow(0, tp.index * nl, nl)
             for k in ("w_a", "w_i")}
    gates.update({k: p[k] for k in ("b_a", "b_i", "lam")})
    return tp, gates


def rec_block(cfg: ModelConfig, p, x):
    """A recurrent block and its MLP.  Under a model cut the rank runs
    its block of the ``rnn`` channels: ``proj_x`` / ``proj_gate`` are
    column products, the conv, the gates and the recurrence run on
    ``(B, S, di / n)``, ``out_proj`` is a row product summed over the
    cut (``tensor_parallel.enter`` / ``leave``: under sequence
    parallelism the block's input is gathered over the sequence and its
    output reduce-scattered)."""
    x = cm.constrain_act(x, cfg)
    proj_x = p["proj_x"]
    tp, gates = _rec_cut(cfg, p, proj_x)
    xn = tpar.enter(tp, cm.block_norm(cfg, p["ln"], x))
    u = causal_conv(xn @ proj_x.to(x.dtype), p["conv_w"], p["conv_b"])
    h = rglru(cfg, gates, u)
    gate = F.gelu(xn @ p["proj_gate"].to(x.dtype), approximate="tanh")
    x = x + tpar.leave(tp, (h * gate) @ p["out_proj"].to(x.dtype))
    return x + cm.mlp(p["mlp"], cm.block_norm(cfg, p["ln2"], x), cfg.d_ff)


def attn_block(cfg: ModelConfig, p, x, positions):
    x = cm.constrain_act(x, cfg)
    h = cm.attention(cfg, p["attn"], cm.block_norm(cfg, p["ln"], x),
                     positions, window=cfg.window)
    x = x + h
    return x + cm.mlp(p["mlp"], cm.block_norm(cfg, p["ln2"], x), cfg.d_ff)


def _hidden(cfg: ModelConfig, params: RecurrentGemma, tokens):
    x = cm.embed_tokens(cfg, params.embed, tokens, cm.torch_dtype(cfg.dtype))
    b, s = tokens.shape[0], tokens.shape[1]
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)

    def group(x, gp):
        for i, kind in enumerate(cfg.block_pattern):
            p = gp[f"b{i}_{kind}"]
            x = (rec_block(cfg, p, x) if kind == "rec"
                 else attn_block(cfg, p, x, positions))
        return x, None

    x, _ = cm.stacked_apply(cfg, group, x, params.groups)
    for p in params.tail:
        x = rec_block(cfg, p, x)
    return cm.block_norm(cfg, params.embed["final_norm"], x)


def train_forward(cfg: ModelConfig, params: RecurrentGemma, tokens,
                  frontend_inputs=None):
    """:func:`forward` that autograd records (pattern groups
    rematerialised per ``cfg.remat``).  On a card the gradients run the
    ``linear_recurrence`` backward kernel, the attention backward at D 256
    with the window, and the RMSNorm backward (the ops' Functions)."""
    with tpar.sequence_parallel(cfg, tokens.shape[1]):
        return cm.lm_logits(cfg, params.embed,
                            _hidden(cfg, params, tokens)), 0.0


def forward(cfg: ModelConfig, params: RecurrentGemma, tokens,
            frontend_inputs=None):
    """tokens: (B, S) integer -> (float32 logits (B, S, V), aux 0.0)."""
    with torch.inference_mode():
        return train_forward(cfg, params, tokens, frontend_inputs)


def logical_axes(cfg: ModelConfig):
    return cm.axes_from_spec(model_spec(cfg))


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
def cache_logical_axes(cfg: ModelConfig):
    return {
        "rec_h": ("layer_groups", None, "batch", "rnn"),
        "conv": ("layer_groups", None, "batch", "conv", "rnn"),
        "k": ("layer_groups", None, "batch", "kv_heads", "cache_seq",
              "head_dim"),
        "v": ("layer_groups", None, "batch", "kv_heads", "cache_seq",
              "head_dim"),
        "tail_rec_h": (None, "batch", "rnn"),
        "tail_conv": (None, "batch", "conv", "rnn"),
    }


def cache_spec(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    """:func:`init_cache`'s shapes and dtypes with no allocation: the same
    tree of tensors on the ``meta`` device."""
    return init_cache(cfg, batch, max_seq, device="meta")


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
               device=DEFAULT_DEVICE, seq_blocks: int = 1,
               rnn_blocks: int = 1) -> dict:
    """Zero decode state, the reference's layout: ``rec_h`` (groups, rec
    blocks, B, di) and ``tail_rec_h`` in float32; ``conv`` / ``tail_conv``
    conv tails and ``k`` / ``v`` rolling windows of ``min(window,
    max_seq)`` slots in ``cfg.dtype`` (``seq_blocks``: the number of
    blocks the window's slots are cut into, a rank's block of a
    seq-sharded cache; ``rnn_blocks``: the number of blocks the
    recurrent channels are cut into, a rank's of a model cut)."""
    di, _, _ = _rec_dims(cfg)
    di //= rnn_blocks
    _, groups, tail = _pattern_counts(cfg)
    n_rec = sum(1 for k in cfg.block_pattern if k == "rec")
    n_att = len(cfg.block_pattern) - n_rec
    w = min(cfg.window or max_seq, max_seq)
    if w % seq_blocks:
        raise ValueError(f"{w} cache slots do not cut into {seq_blocks} "
                         f"blocks")
    w //= seq_blocks
    dev = resolve_device(device)
    dt = cm.torch_dtype(cfg.dtype)
    f32 = torch.float32
    kv = (groups, n_att, batch, cfg.num_kv_heads, w, cfg.head_dim)
    return {
        "rec_h": torch.zeros((groups, n_rec, batch, di), dtype=f32,
                             device=dev),
        "conv": torch.zeros((groups, n_rec, batch, cfg.conv_width - 1, di),
                            dtype=dt, device=dev),
        "k": torch.zeros(kv, dtype=dt, device=dev),
        "v": torch.zeros(kv, dtype=dt, device=dev),
        "tail_rec_h": torch.zeros((max(tail, 1), batch, di), dtype=f32,
                                  device=dev),
        "tail_conv": torch.zeros((max(tail, 1), batch, cfg.conv_width - 1,
                                  di), dtype=dt, device=dev),
    }


def prefill(cfg: ModelConfig, params: RecurrentGemma, tokens, max_seq: int,
            frontend_inputs=None):
    """Run the prompt; returns (last logits (B, 1, V), the reference's
    zeroed cache ``init_cache(cfg, B, S)``; under a
    :class:`repro_torch.distributed.ctx.RowCut` whose ``seq`` cuts the
    attention window's slots, this rank's block of it)."""
    from repro_torch.distributed.ctx import current_cut
    cut = current_cut()
    blocks = cut.mesh.extent(cut.seq) if cut is not None else 1
    with torch.inference_mode():
        with tpar.sequence_parallel(cfg, tokens.shape[1]):
            x = tpar.enter(None, _hidden(cfg, params, tokens))
        return (cm.lm_logits(cfg, params.embed, x[:, -1:]),
                init_cache(cfg, tokens.shape[0], tokens.shape[1],
                           device=tokens.device, seq_blocks=blocks,
                           rnn_blocks=rnn_blocks(cfg, params)))


def rnn_blocks(cfg: ModelConfig, params: RecurrentGemma) -> int:
    """The number of blocks a rank's ``rnn`` channels are of the whole:
    1, or the model cut's extent where the rec blocks hold a block of
    them."""
    di, _, _ = _rec_dims(cfg)
    rec = [gp[f"b{i}_rec"] for gp in params.groups[:1]
           for i, k in enumerate(cfg.block_pattern) if k == "rec"]
    rec += list(params.tail[:1])
    if not rec:
        return 1
    # the width a read gives, from the block: a read would gather it
    tp = tpar.split(cm.held_width(rec[0], "proj_x", 1), di)
    return 1 if tp is None else tp.n


def _rec_block_decode(cfg: ModelConfig, p, x, h_prev, conv_st):
    """x: (B, 1, D); h_prev: (B, di); conv_st: (B, W - 1, di); under a
    model cut the rank's channels of the state (B, di / n), as
    :func:`rec_block` computes them."""
    proj_x = p["proj_x"]
    tp, gates = _rec_cut(cfg, p, proj_x)
    xn = cm.rmsnorm(cfg, p["ln"], x)
    u = (xn @ proj_x.to(x.dtype))[:, 0]
    hist = torch.cat([conv_st, u[:, None, :]], dim=1)
    u = (torch.einsum("bwc,wc->bc", hist, p["conv_w"].to(x.dtype))
         + p["conv_b"].to(x.dtype))
    a, i = _gates(cfg, gates, u)
    h = a * h_prev + torch.sqrt(torch.clamp_min(1 - a * a, 1e-12)) * (
        i * u).float()
    gate = F.gelu(xn @ p["proj_gate"].to(x.dtype), approximate="tanh")[:, 0]
    y = tpar.reduce_out(tp, (h.to(x.dtype) * gate)
                        @ p["out_proj"].to(x.dtype))
    x = x + y[:, None, :]
    x = x + cm.mlp(p["mlp"], cm.rmsnorm(cfg, p["ln2"], x), cfg.d_ff)
    return x, h, hist[:, 1:]


def decode_step(cfg: ModelConfig, params: RecurrentGemma, cache: dict,
                tokens, pos):
    """One token.  tokens: (B,); ``pos``: the position written.  Returns
    (logits (B, V), cache): new recurrent states and conv tails, and the
    attention windows of the given cache written in place."""
    pos = int(pos)
    with torch.inference_mode():
        x = cm.embed_tokens(cfg, params.embed, tokens[:, None],
                            cm.torch_dtype(cfg.dtype))
        rec_h, conv = [], []
        for g, gp in enumerate(params.groups):
            ri = ai = 0
            for i, kind in enumerate(cfg.block_pattern):
                p = gp[f"b{i}_{kind}"]
                if kind == "rec":
                    x, hh, cst = _rec_block_decode(
                        cfg, p, x, cache["rec_h"][g, ri], cache["conv"][g, ri])
                    rec_h.append(hh)
                    conv.append(cst)
                    ri += 1
                else:
                    att, _, _ = cm.attention_decode(
                        cfg, p["attn"], cm.rmsnorm(cfg, p["ln"], x),
                        cache["k"][g, ai], cache["v"][g, ai], pos,
                        window=cfg.window)
                    x = x + att
                    x = x + cm.mlp(p["mlp"], cm.rmsnorm(cfg, p["ln2"], x),
                                   cfg.d_ff)
                    ai += 1
        new = dict(cache,
                   rec_h=torch.stack(rec_h).view(cache["rec_h"].shape),
                   conv=torch.stack(conv).view(cache["conv"].shape))
        tail_h, tail_c = [], []
        for t, p in enumerate(params.tail):
            x, hh, cc = _rec_block_decode(cfg, p, x, cache["tail_rec_h"][t],
                                          cache["tail_conv"][t])
            tail_h.append(hh)
            tail_c.append(cc)
        if tail_h:      # the cache keeps one unused tail slot without a tail
            new["tail_rec_h"] = torch.stack(tail_h)
            new["tail_conv"] = torch.stack(tail_c)
        x = cm.rmsnorm(cfg, params.embed["final_norm"], x)
        return cm.lm_logits(cfg, params.embed, x)[:, 0], new
