"""Hand-written CUDA kernels for Hopper, each with a plain PyTorch
version.  ``ops`` is the dispatching API (``impl="cuda" | "torch"``);
``zns_event_scan`` and ``zns_fixpoint`` hold the kernel wrappers (with
their launch counters) and plain versions; ``csrc/`` holds the CUDA
sources, built at first use by ``_build``."""
from . import ops, zns_event_scan, zns_fixpoint  # noqa: F401
