"""Per-architecture configurations: the port's own copy of
``repro.configs`` (the registry and the ten per-arch modules, data only,
smoke configs included)."""
from .registry import ARCH_IDS, all_configs, get_config, get_smoke_config  # noqa: F401
