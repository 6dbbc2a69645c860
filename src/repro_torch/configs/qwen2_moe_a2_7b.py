"""Qwen1.5-MoE-A2.7B — fine-grained MoE [hf:Qwen/Qwen1.5-MoE-A2.7B].

24L, d_model=2048, 16 heads (kv=16, MHA), 60 routed experts top-4
(expert d_ff=1408) + shared expert (d_ff=5632), vocab=151936.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=0, vocab_size=151936,
    moe_num_experts=60, moe_top_k=4, moe_d_ff=1408,
    moe_shared_d_ff=5632,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, vocab_size=128,
        moe_num_experts=6, moe_top_k=2, moe_d_ff=48, moe_shared_d_ff=96,
        kernel_impl="xla")
