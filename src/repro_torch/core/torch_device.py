"""Device selection for the port's entry points.

Every entry point that solves on a device (``ZnsDevice``, ``DeviceFleet``,
``solve_program``, ``simulate_vectorized``, the scan dispatchers) takes
``device=``, defaulting to ``"cuda"``.  Without a usable CUDA device that
default raises instead of quietly running on the CPU; pass
``device="cpu"`` to run the kernels' plain PyTorch versions there.
"""
from __future__ import annotations

import torch

#: The default of every ``device=`` argument.
DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``device`` as a :class:`torch.device`; raises ``RuntimeError`` for
    a CUDA device when CUDA is not available."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default, but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "on the CPU")
    return dev
