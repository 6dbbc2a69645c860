"""Distributed execution on ``torch.distributed``: the port of
``repro.distributed``.

Ranks are processes, and the modules take global tensors in and give
global tensors out, as the reference's ``shard_map`` functions take and
give global arrays (:mod:`.mesh`).  :mod:`.sharding` resolves logical
axes to PartitionSpecs, :mod:`.ctx` holds the ambient mesh and rules,
:mod:`.comm` the in-body collectives; the schedules are
:mod:`.ring_attention`, :mod:`.flash_decode`, :mod:`.moe_parallel`,
:mod:`.pipeline` and :mod:`.collectives`.  :mod:`.launch` starts a world
of ranks on one host.  :mod:`.rank_local` holds a train state as each
rank's blocks under the state's shardings, gathering a weight where the
step reads it.
"""
from . import (  # noqa: F401
    collectives, comm, ctx, flash_decode, launch, mesh, moe_parallel,
    pipeline, rank_local, ring_attention, sharding,
)
from .mesh import AbstractMesh, Mesh, axis_index, shard_map  # noqa: F401
from .sharding import (  # noqa: F401
    DEFAULT_RULES, PartitionSpec, make_rules, tree_shardings_for, tree_specs,
)
