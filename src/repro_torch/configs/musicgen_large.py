"""MusicGen-large — decoder-only LM over EnCodec tokens [arXiv:2306.05284].

48L, d_model=2048, 32 heads (kv=32, MHA), d_ff=8192, vocab=2048 per
codebook, 4 codebooks.  The EnCodec frontend is a STUB per the
assignment: inputs are codebook token ids (B, S, 4); embeddings are
summed and each position carries 4 output heads.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=2048,
    frontend="audio_stub", num_codebooks=4,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=64, num_codebooks=2,
        kernel_impl="xla")
