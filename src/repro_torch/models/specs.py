"""Parameter layouts of the Mamba2 and RG-LRU families.

Mamba2 (``repro.models.mamba2.model_spec``) and the RG-LRU hybrid
(``repro.models.rglru.model_spec``), shape for shape, so that
:func:`repro_torch.models.count_params` and ``count_active_params`` give
the reference's exact counts for all ten configurations.  The MoE FFN's
layout, :func:`moe_spec`, lives with its forward pass in ``moe.py`` and
is re-exported here.
"""
from __future__ import annotations

from . import common as cm
from .common import P
from .config import ModelConfig
from .moe import moe_spec  # noqa: F401


def mamba2_model_spec(cfg: ModelConfig) -> dict:
    D = cfg.d_model
    di, nh = cfg.d_inner, cfg.ssm_heads
    g, n = cfg.ssm_groups, cfg.ssm_state
    conv_dim = di + 2 * g * n
    layer = {
        "ln": P((D,), ("embed",), "zeros"),
        "in_proj": P((D, 2 * di + 2 * g * n + nh), ("embed", "ssm_inner")),
        "conv_w": P((cfg.conv_width, conv_dim), ("conv", "ssm_inner"),
                    "normal", scale=0.5),
        "conv_b": P((conv_dim,), ("ssm_inner",), "zeros"),
        "a_log": P((nh,), ("ssm_heads",), "ones"),
        "d_skip": P((nh,), ("ssm_heads",), "ones"),
        "dt_bias": P((nh,), ("ssm_heads",), "zeros"),
        "norm": P((di,), ("ssm_inner",), "zeros"),
        "out_proj": P((di, D), ("ssm_inner", "embed")),
    }
    return {"embed": cm.embed_spec(cfg),
            "layers": cm.stack_spec(layer, cfg.num_layers)}


def _rec_block_spec(cfg: ModelConfig) -> dict:
    D = cfg.d_model
    di, nb = cfg.d_model, cfg.num_heads   # lru width = d_model
    bs = di // nb
    return {
        "ln": P((D,), ("embed",), "zeros"),
        "proj_x": P((D, di), ("embed", "rnn")),
        "proj_gate": P((D, di), ("embed", "rnn")),
        "conv_w": P((cfg.conv_width, di), ("conv", "rnn"), "normal", 0.5),
        "conv_b": P((di,), ("rnn",), "zeros"),
        "w_a": P((nb, bs, bs), ("rnn_blocks", "rnn_in", "rnn_out")),
        "b_a": P((di,), ("rnn",), "zeros"),
        "w_i": P((nb, bs, bs), ("rnn_blocks", "rnn_in", "rnn_out")),
        "b_i": P((di,), ("rnn",), "zeros"),
        "lam": P((di,), ("rnn",), "ones"),
        "out_proj": P((di, D), ("rnn", "embed")),
        "ln2": P((D,), ("embed",), "zeros"),
        "mlp": cm.mlp_spec(cfg),
    }


def rglru_model_spec(cfg: ModelConfig) -> dict:
    D = cfg.d_model
    plen = len(cfg.block_pattern)
    groups = cfg.num_layers // plen
    tail = cfg.num_layers - groups * plen
    attn_block = {
        "ln": P((D,), ("embed",), "zeros"),
        "attn": cm.attn_spec(cfg),
        "ln2": P((D,), ("embed",), "zeros"),
        "mlp": cm.mlp_spec(cfg),
    }
    group = {f"b{i}_{kind}": (_rec_block_spec(cfg) if kind == "rec"
                              else attn_block)
             for i, kind in enumerate(cfg.block_pattern)}
    spec = {"embed": cm.embed_spec(cfg),
            "groups": cm.stack_spec(group, groups, "layer_groups")}
    for t in range(tail):
        spec[f"tail{t}"] = _rec_block_spec(cfg)
    return spec
