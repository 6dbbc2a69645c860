"""Qwen3-4B — dense LM with qk-norm and GQA [hf:Qwen/Qwen3-8B family].

36L, d_model=2560, 32 heads (GQA kv=8), d_ff=9728, vocab=151936.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b", family="dense",
    num_layers=36, d_model=2560, num_heads=32, num_kv_heads=8,
    head_dim=128, d_ff=9728, vocab_size=151936, qk_norm=True,
    rope_theta=1_000_000.0,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=160, vocab_size=128, kernel_impl="xla")
