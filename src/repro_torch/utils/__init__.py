"""Support helpers: the port of ``repro.utils``.

``tree`` holds the pytree helpers.  ``comm_stats`` is the counterpart of
``repro.utils.hlo``: it counts the port's collectives as they run, where
the reference reads them out of XLA's compiled HLO.  ``scan_or_loop``
is not ported: it exists so that XLA's cost analysis, which costs a
while-loop body once, can be read from small unrolled variants; torch
runs and traces the layer loop in Python, so the dry run
(:mod:`repro_torch.launch.dryrun`) counts every layer as it is.
"""
from .comm_stats import (  # noqa: F401
    CollectiveRecorder, CollectiveStats, record_collectives,
)
from .tree import (  # noqa: F401
    TreeDef, tree_bytes, tree_count, tree_flatten, tree_leaves,
    tree_unflatten,
)
