"""Host storage-stack layer, ported: zone allocation, reclaim scheduling
and log-structured volumes over the calibrated ZNS device model.

* :class:`ZoneAllocator` — pluggable placement policies
  (``greedy-open`` / ``striped`` / ``lifetime-binned``,
  :func:`register_placement_policy`) bounded by the device's
  max-open/max-active limits, following fill-don't-finish (R3).
* :class:`ReclaimScheduler` — host GC as reset traffic concurrent with
  foreground I/O: occupancy-dependent reset costs (Obs#10), Obs#13
  inflation charged to reclaim throughput (never the write path,
  Obs#12), write-amplification accounting for relocation.
* :class:`LogStructuredVolume` — object writes/reads/deletes/GC on one
  device, compiled to :class:`repro_torch.core.WorkloadSpec`\\ s so whole
  app scenarios simulate batched on either backend.
* scenarios — ``lsm`` / ``circular-log`` / ``cache`` generators
  (:func:`register_scenario`) + :func:`compare_policies`, which runs
  every (scenario, policy) combination as one
  :class:`repro_torch.core.DeviceFleet` call: one launch of the fixpoint
  kernel on the card.
* :mod:`repro_torch.host.conformance` — replay/differential validation
  of zone op sequences (imperative manager vs vectorized table
  semantics).

Everything but the solve is host-side Python and numpy, so importing the
package needs no CUDA; ``compare_policies`` and
``LogStructuredVolume.run`` solve on ``device=`` (``"cuda"`` by
default, which raises without a CUDA device).

    from repro_torch.host import LogStructuredVolume, compare_policies
    rows = compare_policies(["lsm"], backend="vectorized", device="cpu")
"""
from .allocator import (  # noqa: F401
    Extent, StreamHint, ZoneAllocator, available_placement_policies,
    register_placement_policy, unregister_placement_policy,
)
from .reclaim import ReclaimReport, ReclaimScheduler  # noqa: F401
from .volume import HostObject, HostRunResult, LogStructuredVolume  # noqa: F401
from .scenarios import (  # noqa: F401
    HOST_SCENARIO_SPEC, ScenarioBuild, available_scenarios, build_scenario,
    compare_policies, rank_policies, register_scenario, unregister_scenario,
)
from . import conformance  # noqa: F401
