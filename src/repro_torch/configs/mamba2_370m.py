"""Mamba2-370M — SSD state-space LM, attention-free [arXiv:2405.21060].

48L, d_model=1024, ssm_state=128, vocab=50280.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm",
    num_layers=48, d_model=1024, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280, head_dim=64,
    ssm_state=128, ssm_headdim=64, ssm_groups=1, ssm_expand=2,
    conv_width=4, ssm_chunk=128, tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, vocab_size=128,
        ssm_state=16, ssm_headdim=16, ssm_chunk=32, kernel_impl="xla")
