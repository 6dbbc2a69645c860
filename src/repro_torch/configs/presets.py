"""Best-known-config presets: the port's copy of ``repro.configs.presets``.

``get_optimized_config(arch)`` layers the settings the reference's perf
loop chose onto the published architecture config: expert-parallel
all_to_all dispatch for the MoE archs, expert padding where E does not
divide the model axis, and the microbatch setting that fits
llama3-405b's activation carries.
"""
from __future__ import annotations

from .registry import get_config

#: per-arch config overrides
OPTIMIZED_OVERRIDES = {
    "arctic-480b": dict(moe_impl="ep"),
    "qwen2-moe-a2.7b": dict(moe_impl="ep", moe_expert_pad=4),
}

#: step-level settings (consumed by launch drivers, not ModelConfig)
OPTIMIZED_STEP_SETTINGS = {
    "llama3-405b": dict(microbatches=16),
}


def get_optimized_config(arch: str, **extra):
    over = dict(OPTIMIZED_OVERRIDES.get(arch, {}))
    over.update(extra)
    return get_config(arch, **over)


def step_settings(arch: str) -> dict:
    return dict(OPTIMIZED_STEP_SETTINGS.get(arch, {}))
