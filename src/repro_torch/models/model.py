"""Family dispatch: one API over the architectures.

    init_params(cfg, generator, device=)  -> Transformer (dense and moe
                                             families), Mamba2 (ssm),
                                             RecurrentGemma (hybrid)
    forward(cfg, params, tokens)          -> (logits, aux)
    init_cache / prefill / decode_step    -> serving entry points
    count_params(cfg)                     -> exact (spec tree, no alloc)

The dense, moe, ssm and hybrid families are ported; the others raise
``NotImplementedError`` naming the ROADMAP slice that brings them.
Parameter counts work for all ten configurations.  For the recurrent
families ``prefill`` returns the reference's zeroed cache for the prompt
(``repro.models.model.prefill``): decoding after it starts from a blank
state.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.torch_device import DEFAULT_DEVICE
from . import common as cm
from . import mamba2, rglru, specs, transformer
from .config import ModelConfig

#: Families whose compute is not ported yet, with their ROADMAP slice.
NOT_PORTED = {
    "vlm": "VLM and audio serving (ROADMAP queue 1, slice 8)",
    "audio": "VLM and audio serving (ROADMAP queue 1, slice 8)",
}

_MODULES = {"dense": transformer, "moe": transformer, "ssm": mamba2,
            "hybrid": rglru}


def _module(cfg: ModelConfig):
    if cfg.family in _MODULES:
        return _MODULES[cfg.family]
    if cfg.family in NOT_PORTED:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet: "
                                  f"{NOT_PORTED[cfg.family]}")
    raise ValueError(f"unknown family {cfg.family}")


def model_spec(cfg: ModelConfig):
    """The parameter spec tree of any family (for counting)."""
    if cfg.family == "ssm":
        return specs.mamba2_model_spec(cfg)
    if cfg.family == "hybrid":
        return specs.rglru_model_spec(cfg)
    return transformer.model_spec(cfg)


def init_params(cfg: ModelConfig, generator=None, *, device=DEFAULT_DEVICE):
    return _module(cfg).init_params(cfg, generator, device=device)


def forward(cfg: ModelConfig, params, tokens, frontend_inputs=None):
    return _module(cfg).forward(cfg, params, tokens, frontend_inputs)


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
