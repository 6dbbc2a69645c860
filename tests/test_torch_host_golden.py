"""The port reproduces the reference's pinned host-scenario fixtures.

Rebuilds the three ``tests/golden/*__greedy-open.json`` scenarios with
the port's host layer (as ``tests/test_host_golden.py`` does with the
reference's), checks the compiled trace's size and digest, and holds the
port's ``event`` backend to the fixture's completion times at the
reference test's tolerance (rtol 1e-9, atol 1e-6).  Then ``event`` vs
``vectorized`` (``device="cpu"``) on every scenario x policy
combination.  The fixtures are only read.
"""
import hashlib
import json
import pathlib

import numpy as np
import pytest

from repro_torch.core import ZnsDevice
from repro_torch.host import available_scenarios, build_scenario
from repro_torch.host.scenarios import HOST_SCENARIO_SPEC

GOLDEN_DIR = pathlib.Path(__file__).parent / "golden"

#: (scenario, policy, seed, scale) pinned by a fixture each.
GOLDEN_CASES = (
    ("lsm", "greedy-open", 0, 0.5),
    ("circular-log", "greedy-open", 0, 0.5),
    ("cache", "greedy-open", 0, 0.5),
)

ALL_COMBOS = tuple(
    (scen, pol)
    for scen in ("lsm", "circular-log", "cache")
    for pol in ("greedy-open", "striped", "lifetime-binned"))

TOL = dict(rtol=1e-9, atol=1e-6)


def _trace_digest(trace) -> str:
    h = hashlib.sha256()
    for field in ("op", "zone", "size", "issue", "thread", "qd",
                  "occupancy", "was_finished", "io_ctx"):
        h.update(np.ascontiguousarray(getattr(trace, field)).tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("scenario,policy,seed,scale", GOLDEN_CASES,
                         ids=lambda v: str(v))
def test_golden_trace_regression(scenario, policy, seed, scale):
    with open(GOLDEN_DIR / f"{scenario}__{policy}.json") as f:
        want = json.load(f)
    build = build_scenario(scenario, policy=policy, seed=seed, scale=scale,
                           device="cpu")
    trace = build.workload.build()
    assert len(trace) == want["n_requests"]
    assert _trace_digest(trace) == want["workload_sha256"]
    res = ZnsDevice(HOST_SCENARIO_SPEC, device="cpu").run(
        trace, backend="event", seed=seed, jitter=False)
    np.testing.assert_allclose(res.sim.complete,
                               np.asarray(want["complete_us"]), **TOL)


@pytest.mark.parametrize("scenario,policy", ALL_COMBOS,
                         ids=lambda v: str(v))
def test_event_vs_vectorized_equivalence(scenario, policy):
    build = build_scenario(scenario, policy=policy, seed=0, scale=0.5,
                           device="cpu")
    trace = build.workload.build()
    dev = ZnsDevice(HOST_SCENARIO_SPEC, device="cpu")
    ev = dev.run(trace, backend="event", jitter=False)
    vec = dev.run(trace, backend="vectorized", jitter=False)
    np.testing.assert_allclose(vec.sim.complete, ev.sim.complete, **TOL)
    np.testing.assert_allclose(vec.sim.start, ev.sim.start, **TOL)
    np.testing.assert_array_equal(vec.sim.service, ev.sim.service)


def test_golden_fixtures_cover_every_scenario():
    assert {c[0] for c in GOLDEN_CASES} == set(available_scenarios())
