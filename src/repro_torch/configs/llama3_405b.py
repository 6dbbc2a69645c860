"""Llama-3 405B — frontier dense LM [arXiv:2407.21783].

126L, d_model=16384, 128 heads (GQA kv=8), d_ff=53248, vocab=128256.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b", family="dense",
    num_layers=126, d_model=16384, num_heads=128, num_kv_heads=8,
    head_dim=128, d_ff=53248, vocab_size=128256, rope_theta=500_000.0,
    # bf16 master weights + f32 Adam moments (10 B/param), as the
    # reference's config sets them.
    param_dtype="bfloat16",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=3, d_model=128, num_heads=8, num_kv_heads=2,
        head_dim=16, d_ff=384, vocab_size=256, kernel_impl="xla")
