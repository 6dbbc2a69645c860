"""TinyLlama-1.1B — llama2-arch small dense LM [arXiv:2401.02385].

22L, d_model=2048, 32 heads (GQA kv=4), d_ff=5632, vocab=32000.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b", family="dense",
    num_layers=22, d_model=2048, num_heads=32, num_kv_heads=4,
    d_ff=5632, vocab_size=32000, rope_theta=10_000.0,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=128, kernel_impl="xla")
