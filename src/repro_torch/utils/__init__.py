"""Support helpers: the port of ``repro.utils`` (pytree helpers).

``repro.utils.hlo`` (HLO inspection) has no torch counterpart and
``scan_or_loop`` (``lax.scan`` for roofline extraction) waits for the
roofline's port (ROADMAP queue 1, item 9)."""
from .tree import (  # noqa: F401
    TreeDef, tree_bytes, tree_count, tree_flatten, tree_leaves,
    tree_unflatten,
)
