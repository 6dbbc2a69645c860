"""Hand-written CUDA kernels for Hopper, each with a plain PyTorch
version.  ``ops`` is the dispatching API (``impl="cuda" | "torch"``);
``zns_event_scan``, ``zns_fixpoint``, ``rmsnorm``, ``flash_attention``,
``linear_recurrence`` and ``ssd_chunk_scan`` hold the kernel wrappers
(with their launch counters) and plain versions; ``ref`` the model
kernels' oracles; ``csrc/`` holds the CUDA sources, built at first use
by ``_build``.

:func:`launch_counts` reads every wrapper's counter and
:func:`reset_launch_counts` sets them to 0.  A process started
with ``REPRO_TORCH_LAUNCH_LOG=<path>`` in its environment writes them to
that file as JSON when it exits, so that a caller can count the kernels
a program launched (``python3 examples/quickstart_torch.py`` in a
subprocess, say) without changing how the program is run."""
import atexit
import json
import os

from . import (  # noqa: F401
    flash_attention, linear_recurrence, ops, ref, rmsnorm, ssd_chunk_scan,
    zns_event_scan, zns_fixpoint,
)

#: The environment variable naming the file :func:`launch_counts` is
#: written to at exit.
LAUNCH_LOG_ENV = "REPRO_TORCH_LAUNCH_LOG"


#: Every launch counter: name -> (module, wrapper, attribute).  The
#: ``_d256`` and ``_mma`` counters count a subset of their wrapper's
#: launches (the attention backward at head dim 256; the SSD scan's
#: tensor-core instance), which its ``launches`` counts too.
_COUNTERS = {
    "zns_event_scan": (zns_event_scan, "zns_event_scan", "launches"),
    "zns_event_scan_batched":
        (zns_event_scan, "zns_event_scan_batched", "launches"),
    "zns_fixpoint": (zns_fixpoint, "zns_fixpoint", "launches"),
    "zns_fixpoint_sharded": (zns_fixpoint, "zns_fixpoint_sharded",
                             "launches"),
    "flash_attention": (flash_attention, "flash_attention", "launches"),
    "flash_attention_bwd": (flash_attention, "flash_attention_bwd",
                            "launches"),
    "flash_attention_bwd_d256": (flash_attention, "flash_attention_bwd",
                                 "d256_launches"),
    "rmsnorm": (rmsnorm, "rmsnorm", "launches"),
    "rmsnorm_bwd": (rmsnorm, "rmsnorm_bwd", "launches"),
    "rmsnorm_cut": (rmsnorm, "rmsnorm_cut", "launches"),
    "rmsnorm_cut_bwd": (rmsnorm, "rmsnorm_cut_bwd", "launches"),
    "ssd_chunk_scan": (ssd_chunk_scan, "ssd_chunk_scan", "launches"),
    "ssd_chunk_scan_mma": (ssd_chunk_scan, "ssd_chunk_scan", "mma_launches"),
    "ssd_chunk_scan_bwd": (ssd_chunk_scan, "ssd_chunk_scan_bwd", "launches"),
    "ssd_chunk_scan_bwd_mma": (ssd_chunk_scan, "ssd_chunk_scan_bwd",
                               "mma_launches"),
    "linear_recurrence": (linear_recurrence, "linear_recurrence",
                          "launches"),
    "linear_recurrence_bwd": (linear_recurrence, "linear_recurrence_bwd",
                              "launches"),
}


def launch_counts() -> dict:
    """Every kernel wrapper's launches since the last
    :func:`reset_launch_counts`, by counter name."""
    return {k: getattr(getattr(mod, fn), attr)
            for k, (mod, fn, attr) in _COUNTERS.items()}


def reset_launch_counts() -> None:
    """Sets every counter of :func:`launch_counts` to 0."""
    for mod, fn, attr in _COUNTERS.values():
        setattr(getattr(mod, fn), attr, 0)


def _write_launch_log(path: str) -> None:
    with open(path, "w") as f:
        json.dump(launch_counts(), f)


if os.environ.get(LAUNCH_LOG_ENV):
    atexit.register(_write_launch_log, os.environ[LAUNCH_LOG_ENV])
