"""Serve-step factories: prefill and single-token greedy decode.

The port of ``repro.serve.step``.  The steps run under
``torch.inference_mode`` and return the cache the next step takes: the
dense and MoE families update their KV cache in place (the reference donates the
cache buffer), the recurrent families return new states.
"""
from __future__ import annotations

import torch

from repro_torch import models as M
from repro_torch.models.config import ModelConfig


def make_prefill_step(cfg: ModelConfig, max_seq: int):
    """prefill_step(params, tokens, frontend_inputs=None) -> (next tokens
    (B,), or (B, Cb) for audio, cache)."""
    @torch.inference_mode()
    def prefill_step(params, tokens, frontend_inputs=None):
        logits, cache = M.prefill(cfg, params, tokens, max_seq,
                                  frontend_inputs)
        return torch.argmax(logits[:, -1], dim=-1), cache
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """serve_step(params, cache, tokens, pos) -> (next tokens, cache): one
    new token per sequence against the existing KV or recurrent cache."""
    @torch.inference_mode()
    def serve_step(params, cache, tokens, pos):
        logits, cache = M.decode_step(cfg, params, cache, tokens, pos)
        return torch.argmax(logits, dim=-1), cache
    return serve_step


@torch.inference_mode()
def greedy_generate(cfg: ModelConfig, params, prompt, *, steps: int,
                    max_seq: int):
    """Prefill ``prompt`` (B, S), or (B, S, Cb) for audio, then ``steps -
    1`` decode steps; returns the (B, steps), or (B, steps, Cb), greedy
    tokens."""
    prefill = make_prefill_step(cfg, max_seq)
    step = make_serve_step(cfg)
    tok, cache = prefill(params, prompt)
    toks = [tok]
    pos = prompt.shape[1]
    for i in range(steps - 1):
        tok, cache = step(params, cache, tok, pos + i)
        toks.append(tok)
    return torch.stack(toks, dim=1)
