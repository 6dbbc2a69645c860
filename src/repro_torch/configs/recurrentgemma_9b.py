"""RecurrentGemma-9B — Griffin-style hybrid [arXiv:2402.19427].

38 blocks in a (rec, rec, attn) 2:1 pattern; RG-LRU recurrence width
= d_model = 4096; local attention window 2048 with MQA (kv=1);
d_ff=12288; vocab=256000.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1,
    head_dim=256, d_ff=12288, vocab_size=256_000,
    block_pattern=("rec", "rec", "attn"), window=2048,
    logits_softcap=30.0,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=4, d_model=64, num_heads=4, num_kv_heads=1,
        head_dim=16, d_ff=128, vocab_size=128, window=32,
        block_pattern=("rec", "rec", "attn"), kernel_impl="xla")
