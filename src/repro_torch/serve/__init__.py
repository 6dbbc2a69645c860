"""Serving: prefill and greedy decode steps (the port of ``repro.serve``)."""
from .step import (  # noqa: F401
    greedy_generate, make_prefill_step, make_serve_step,
)
