"""The exactness matrix's 18 cells on the port's host drivers.

``repro_torch.core.exactness`` builds the cells of
``benchmarks/exactness_matrix.py`` with the port's API: its three
workloads x {jitter-free, jittered} x the ``cols``, ``rows`` and
``sharded`` layouts, two devices each, at the benchmark's full scale.
Every cell is solved with the port's ``loop`` driver and with its
``torch`` driver (the plain version of the fixpoint kernel; a sharded
cell takes the host executor under ``loop`` and the mesh executor, the
stacked fixpoint's plain version, under ``torch``) against the port's
own event engine, and must be exact, converged and within the matrix's
tolerances.  The
benchmark module is only read: its constants are held equal to the
port's, and its workload builder (which drives ``repro``) to the port's
on the traces it makes.  ``chip_smoke.py`` solves the same cells with the
CUDA kernel.
"""
import dataclasses
import pathlib
import sys

import numpy as np
import pytest

from repro_torch.core import exactness as ex

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
from benchmarks import exactness_matrix as bench  # noqa: E402

NAMES = [f"{w}/{j}/{lay}" for w in ex.WORKLOADS
         for j in ("jitter_free", "jittered") for lay in ex.LAYOUTS]


@pytest.fixture(scope="module")
def cells():
    return {c.name: c for c in ex.cells()}


def test_constants_match_the_benchmark():
    assert ex.TOL_JITTER_FREE == bench.TOL_JITTER_FREE
    assert ex.TOL_JITTERED == bench.TOL_JITTERED
    assert ex.WORKLOADS == bench.WORKLOADS
    assert ex.LAYOUTS == bench.LAYOUTS
    assert ex.SWEEPS == bench._SWEEPS


@pytest.mark.parametrize("name", bench.WORKLOADS)
def test_workload_traces_match_the_benchmark(name):
    want = bench._build(name, 25)
    got = ex.build_workload(name, 25)
    for field in dataclasses.fields(want):
        w, g = getattr(want, field.name), getattr(got, field.name)
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w, err_msg=field.name)
        else:
            assert g.name == w.name, field.name


def test_cells_cover_the_matrix(cells):
    assert sorted(cells) == sorted(NAMES)
    assert len(cells) == 18


@pytest.mark.parametrize("driver", ["loop", "torch"])
@pytest.mark.parametrize("name", NAMES)
def test_cell_is_exact_on_host_drivers(cells, name, driver):
    cell = cells[name]
    comp, used, converged = cell.solve(driver, device="cpu")
    assert cell.program.exact
    assert converged and used < ex.SWEEPS
    err = cell.max_rel_err(comp)
    assert err <= cell.tol, f"{name} ({driver}): max rel err {err:.3e}"
