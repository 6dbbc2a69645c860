"""Runtime: the port of ``repro.runtime``: the ZNS checkpoint store
(``zns_store``; its modeled timing runs on the max-plus scan kernels on
``device=``) and the control-plane policies (``failures``, ``elastic``:
host numpy, copied as they are)."""
from .elastic import ReshardPlan, largest_mesh, make_reshard_plan, validate_plan  # noqa: F401
from .failures import (  # noqa: F401
    FailureDetector, HostState, RestartBudget, StragglerPolicy,
)
from .zns_store import ZnsHostDevice, ZonedCheckpointStore  # noqa: F401
