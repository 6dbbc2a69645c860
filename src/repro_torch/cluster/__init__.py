"""Cluster tier, ported: gateways, storage servers, and the network
between them, with the :mod:`repro_torch.host` volume /
:mod:`repro_torch.core` device as the leaf — all compiled to ONE
fleet-level :class:`repro_torch.core.ChainProgram` per configuration and
solved in a single fixpoint call (differential greedy-engine oracle for
small configs).  See ``docs/cluster.md``.

Graph building, the FIFO pop-order replay and the refinement loop run on
the host in numpy; every solve runs on ``device=`` (``"cuda"`` by
default, which raises without CUDA; ``"cpu"`` runs the plain versions),
with ``fixpoint="auto"``: one launch of the CUDA fixpoint kernel a solve.

    from repro_torch.cluster import Cluster, ClusterSpec, ClusterWorkload
    res = Cluster(ClusterSpec(), device="cpu").run(ClusterWorkload())
"""
from .spec import (  # noqa: F401
    CLUSTER_DEVICE_SPEC, OP_DELETE, OP_GET, OP_NAMES, OP_PUT, ClusterSpec,
    ClusterWorkload, GatewaySpec, NetworkSpec, ObjectOp, ServerSpec,
)
from .codec import (  # noqa: F401
    RedundancyScheme, erasure, parse_scheme, replication,
)
from .placement import (  # noqa: F401
    PLACEMENTS, available_placements, placement_map, register_placement,
)
from .gateway import Gateway, OpPlan, ShardOp, plan_workload  # noqa: F401
from .server import StorageServer  # noqa: F401
from .compiler import (  # noqa: F401
    MAX_REFINE, ClusterGraph, CompiledCluster, Resource, build_graph,
    compile_graph, edge_families, op_latencies,
)
from .oracle import oracle_op_latencies, simulate_graph, touched_servers  # noqa: F401
from .cluster import Cluster, ClusterRunResult  # noqa: F401
from .capacity import (  # noqa: F401
    CapacityCurve, CapacityPoint, CapacityReport, ClusterConfig,
    plan_capacity, rate_at_slo, users_at_slo,
)
