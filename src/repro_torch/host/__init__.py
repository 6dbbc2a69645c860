"""Host storage-stack layer, ported: zone allocation and reclaim
scheduling over the calibrated ZNS device model.

* :class:`ZoneAllocator` — pluggable placement policies
  (``greedy-open`` / ``striped`` / ``lifetime-binned``,
  :func:`register_placement_policy`) bounded by the device's
  max-open/max-active limits, following fill-don't-finish (R3).
* :class:`ReclaimScheduler` — host GC as reset traffic concurrent with
  foreground I/O: occupancy-dependent reset costs (Obs#10), Obs#13
  inflation charged to reclaim throughput (never the write path,
  Obs#12), write-amplification accounting for relocation.

Both are host-side Python and numpy.  The log-structured volume
(``volume``), the application scenarios (``scenarios``) and the
zone-op conformance replay (``conformance``) of the reference's host
package come in the next slice of the port.
"""
from .allocator import (  # noqa: F401
    Extent, StreamHint, ZoneAllocator, available_placement_policies,
    register_placement_policy, unregister_placement_policy,
)
from .reclaim import ReclaimReport, ReclaimScheduler  # noqa: F401
