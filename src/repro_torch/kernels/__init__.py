"""Hand-written CUDA kernels for Hopper, each with a plain PyTorch
version.  ``ops`` is the dispatching API (``impl="cuda" | "torch"``);
``zns_event_scan``, ``zns_fixpoint``, ``rmsnorm``, ``flash_attention``,
``linear_recurrence`` and ``ssd_chunk_scan`` hold the kernel wrappers
(with their launch counters) and plain versions; ``ref`` the model
kernels' oracles; ``csrc/`` holds the CUDA sources, built at first use
by ``_build``."""
from . import (  # noqa: F401
    flash_attention, linear_recurrence, ops, ref, rmsnorm, ssd_chunk_scan,
    zns_event_scan, zns_fixpoint,
)
