"""Model and shape configuration dataclasses.

One :class:`ModelConfig` covers all ten assigned architecture families;
family-specific fields are simply unused elsewhere.  :class:`ShapeConfig`
describes one cell of the (architecture × input-shape) grid.

The port's own copy of ``repro.models.config``, field for field.
``kernel_impl`` keeps the reference's names: ``"xla"`` and
``"interpret"`` select the kernels' plain PyTorch versions, ``"pallas"``
the CUDA kernels, ``"auto"`` the CUDA kernels for tensors on a card and
the plain versions on the CPU; ``"cuda"`` and ``"torch"`` are accepted
as they are (see :func:`repro_torch.models.common.kernel_impl`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // num_heads
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    rms_eps: float = 1e-6
    tie_embeddings: bool = False

    # -- MoE ------------------------------------------------------------
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0            # per-expert hidden
    moe_shared_d_ff: int = 0     # shared-expert hidden (qwen2-moe)
    moe_dense_parallel: bool = False   # dense-FFN residual ∥ MoE (arctic)
    moe_capacity_factor: float = 1.25
    moe_impl: str = "gspmd"            # gspmd | ep (shard_map all_to_all)
    moe_expert_pad: int = 0            # dummy experts so E divides EP degree

    # -- SSM (mamba2) ------------------------------------------------------
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_groups: int = 1
    ssm_expand: int = 2
    conv_width: int = 4
    ssm_chunk: int = 128

    # -- hybrid (recurrentgemma) -------------------------------------------
    block_pattern: Sequence[str] = ("attn",)   # e.g. ("rec","rec","attn")
    window: Optional[int] = None               # local attention window
    rglru_c: float = 8.0

    # -- modality frontends (STUBS per assignment) ---------------------------
    frontend: Optional[str] = None   # "vision_stub" | "audio_stub"
    num_patches: int = 256           # vision stub: patch embeddings per image
    num_codebooks: int = 0           # audio: EnCodec codebooks

    # -- numerics / implementation -------------------------------------------
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    kernel_impl: str = "auto"        # see kernels.ops
    remat: str = "full"              # none | full | dots_saveable
    remat_block: int = 0             # layers per remat block; 0 = auto ~sqrt(L)
    scan_layers: bool = True
    seq_parallel: bool = False       # Megatron-SP: seq-shard norm regions
    ring_attention: bool = False     # shard_map ring attention (prefill/train)
    logits_softcap: float = 0.0

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def full_attention(self) -> bool:
        """True if the arch has at least one unwindowed attention layer."""
        if self.family == "ssm":
            return False
        if self.family == "hybrid":
            return self.window is None
        return self.window is None

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    # Exact parameter counts come from the spec tree: models.count_params /
    # models.count_active_params (no allocation, cannot drift from init).


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str                   # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                   # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeConfig("train_4k", "train", 4096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524288, 1)

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


def shapes_for(cfg: ModelConfig) -> tuple[ShapeConfig, ...]:
    """The runnable shape set for an architecture.

    ``long_500k`` requires sub-quadratic attention: it runs only for
    ssm/hybrid families (see DESIGN.md §Arch-applicability); pure
    full-attention archs skip it by design.
    """
    if cfg.family in ("ssm", "hybrid"):
        return ALL_SHAPES
    return (TRAIN_4K, PREFILL_32K, DECODE_32K)
