"""Models: the port of ``repro.models`` (dense, moe, ssm and hybrid
families)."""
from .config import (  # noqa: F401
    ALL_SHAPES, DECODE_32K, LONG_500K, PREFILL_32K, SHAPES_BY_NAME, TRAIN_4K,
    ModelConfig, ShapeConfig, shapes_for,
)
from .convert import (  # noqa: F401
    model_from_tree, params_from_reference, params_to_reference,
    train_state_from_reference, train_state_to_reference,
)
from .model import (  # noqa: F401
    bind_grads, cache_logical_axes, cache_spec, count_active_params,
    count_params, decode_step, forward, init_cache, init_params,
    logical_axes, loss_fn, model_flops, model_spec, prefill, train_forward,
)
from .mamba2 import Mamba2  # noqa: F401
from .rglru import RecurrentGemma  # noqa: F401
from .transformer import DecoderLayer, Transformer  # noqa: F401
