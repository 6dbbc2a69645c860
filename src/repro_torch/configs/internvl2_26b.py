"""InternVL2-26B — VLM; InternLM2-20B LM backbone [arXiv:2404.16821].

Backbone: 48L, d_model=6144, 48 heads (GQA kv=8), d_ff=16384,
vocab=92553.  The InternViT vision tower is a STUB per the assignment:
``input_specs()`` supplies precomputed patch embeddings which are
projected and spliced over the leading image-placeholder positions.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b", family="vlm",
    num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8,
    head_dim=128, d_ff=16384, vocab_size=92553,
    frontend="vision_stub", num_patches=256, rope_theta=1_000_000.0,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=128, num_patches=4,
        kernel_impl="xla")
