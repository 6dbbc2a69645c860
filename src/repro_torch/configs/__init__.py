"""Per-architecture configurations: the port's own copy of
``repro.configs`` (the registry and the ten per-arch modules, data only,
smoke configs included) and its presets (``get_optimized_config``,
``step_settings``)."""
from .registry import ARCH_IDS, all_configs, get_config, get_smoke_config  # noqa: F401
from .presets import get_optimized_config, step_settings  # noqa: F401
