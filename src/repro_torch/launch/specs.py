"""input_specs(): stand-ins for every model input with no allocation.

The port of ``repro.launch.specs``: tensors on the ``meta`` device in
place of ``jax.ShapeDtypeStruct``\\ s; the dry run
(:mod:`repro_torch.launch.dryrun`) traces against them.  The modality
frontends are stubs: ``vision_stub`` takes precomputed patch
embeddings, ``audio_stub`` EnCodec codebook token ids.
"""
from __future__ import annotations

import torch

from repro_torch import models as M
from repro_torch.models.common import torch_dtype
from repro_torch.models.config import ModelConfig, ShapeConfig


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Training / prefill batch."""
    b, s = shape.global_batch, shape.seq_len
    if cfg.num_codebooks > 1:
        tokens = _meta((b, s, cfg.num_codebooks), torch.int32)
    else:
        tokens = _meta((b, s), torch.int32)
    batch = {"tokens": tokens}
    if cfg.frontend == "vision_stub":
        batch["frontend_inputs"] = _meta((b, cfg.num_patches, cfg.d_model),
                                         torch_dtype(cfg.dtype))
    return batch


def batch_logical_axes(cfg: ModelConfig) -> dict:
    axes = {"tokens": ("batch", "seq", None) if cfg.num_codebooks > 1
            else ("batch", "seq")}
    if cfg.frontend == "vision_stub":
        axes["frontend_inputs"] = ("batch", "seq", "act_embed")
    return axes


def decode_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """serve_step inputs: cache + one new token per sequence."""
    b, s = shape.global_batch, shape.seq_len
    if cfg.num_codebooks > 1:
        tokens = _meta((b, cfg.num_codebooks), torch.int32)
    else:
        tokens = _meta((b,), torch.int32)
    return {
        "cache": M.cache_spec(cfg, b, s),
        "tokens": tokens,
        "pos": _meta((), torch.int32),
    }


def decode_logical_axes(cfg: ModelConfig) -> dict:
    return {
        "cache": M.cache_logical_axes(cfg),
        "tokens": ("batch", None) if cfg.num_codebooks > 1 else ("batch",),
        "pos": None,
    }


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    if shape.kind in ("train", "prefill"):
        return batch_specs(cfg, shape)
    return decode_specs(cfg, shape)
