"""Hand-written CUDA kernels for Hopper, each with a plain PyTorch
version.  ``ops`` is the dispatching API (``impl="cuda" | "torch"``);
``zns_event_scan``, ``zns_fixpoint``, ``rmsnorm`` and ``flash_attention``
hold the kernel wrappers (with their launch counters) and plain versions;
``ref`` the attention and RMSNorm oracles; ``csrc/`` holds the CUDA
sources, built at first use by ``_build``."""
from . import (  # noqa: F401
    flash_attention, ops, ref, rmsnorm, zns_event_scan, zns_fixpoint,
)
