"""The port reproduces the reference's pinned pool fixtures.

Rebuilds the three ``tests/golden/pool-*.json`` workloads with the
port's ``WorkloadSpec`` (as ``tests/test_pool_golden.py`` does with the
reference's), checks the built trace's digest against the fixture, and
holds the port's vectorized run (``device="cpu"``) to the fixture's
event-engine completion times at the exactness-matrix tolerances.  The
fixtures are only read.
"""
import hashlib
import json
import pathlib

import numpy as np
import pytest

from repro_torch.core import KiB, OpType, WorkloadSpec, ZNSDeviceSpec, \
    ZnsDevice

GOLDEN_DIR = pathlib.Path(__file__).parent / "golden"

#: (case name, jitter, seed), as pinned by the fixtures.
GOLDEN_CASES = (
    ("pool-multiclass", False, 0),
    ("pool-multiclass-jittered", True, 3),
    ("pool-reset-mixed", False, 0),
)

RTOL = {False: 1e-9, True: 1e-8}     # exactness-matrix tolerances


def _workload(case: str):
    wl = WorkloadSpec()
    for t in range(4):
        wl = wl.appends(n=50, size=8 * KiB, qd=4, zone=t * 4, nzones=4)
        wl = wl.appends(n=50, size=64 * KiB, qd=4, zone=t * 4, nzones=4)
    if case == "pool-reset-mixed":
        wl = wl.resets(n=20, occupancy=1.0, nzones=20,
                       io_ctx=OpType.APPEND, zone=500)
    return wl.build()


def _trace_digest(trace) -> str:
    h = hashlib.sha256()
    for field in ("op", "zone", "size", "issue", "thread", "qd",
                  "occupancy", "was_finished", "io_ctx"):
        h.update(np.ascontiguousarray(getattr(trace, field)).tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("case,jitter,seed", GOLDEN_CASES,
                         ids=lambda v: str(v))
def test_port_reproduces_pool_golden(case, jitter, seed):
    with open(GOLDEN_DIR / f"{case}.json") as f:
        want = json.load(f)
    trace = _workload(case)
    assert len(trace) == want["n_requests"]
    assert _trace_digest(trace) == want["workload_sha256"]
    dev = ZnsDevice(ZNSDeviceSpec(), device="cpu")
    res = dev.run(trace, backend="vectorized", seed=seed, jitter=jitter)
    assert res.exact is True and res.order_stable is True
    assert res.converged
    np.testing.assert_allclose(res.sim.complete,
                               np.asarray(want["complete_us"]),
                               rtol=RTOL[jitter], atol=1e-6)
    # the port's own event engine reproduces the pinned oracle too
    ev = dev.run(trace, backend="event", seed=seed, jitter=jitter)
    np.testing.assert_allclose(ev.sim.complete,
                               np.asarray(want["complete_us"]), rtol=1e-12)
