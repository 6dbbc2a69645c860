"""Snowflake Arctic 480B — dense-MoE hybrid [hf:Snowflake/snowflake-arctic-base].

35L, d_model=7168, 56 heads (GQA kv=8), dense-residual FFN d_ff=4864 in
parallel with a 128-expert top-2 MoE (expert d_ff=4864), vocab=32000.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    num_layers=35, d_model=7168, num_heads=56, num_kv_heads=8,
    head_dim=128, d_ff=4864, vocab_size=32000,
    moe_num_experts=128, moe_top_k=2, moe_d_ff=4864,
    moe_dense_parallel=True,
    # bf16 master weights: 477B params + f32 moments = 4.8 TB must spread
    # over the fleet's HBM.
    param_dtype="bfloat16",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=96, vocab_size=128,
        moe_num_experts=8, moe_top_k=2, moe_d_ff=96, kernel_impl="xla")
