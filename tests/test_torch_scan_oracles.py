"""The port's own scan and fixpoint oracles, and the tiled scan's
decomposition, held on the CPU.

``repro_torch.kernels.ref`` carries torch counterparts of the
reference's ``zns_event_scan_ref``, ``zns_event_scan_batched_ref``,
``zns_fixpoint_ref`` and ``affine_scan_pairs_ref``.  Each is held here
against the reference's JAX oracle on the same numpy inputs in float32,
at the reference kernel tests' tolerances, and in float64 against the
sequential numpy loop (or the reference's float64 loop driver) at rtol
1e-12.

The last tests model the CUDA scan's decomposition
(``src/repro_torch/csrc/maxplus.cuh``) on tensors: rows cut into tiles,
each tile scanned with ``affine_scan_pairs_ref``, each tile's carry-in
composed from the earlier tiles' aggregates in the kernel's fixed order
(runs of ``ceil(k / threads)`` aggregates, then the runs in order).  At
awkward tile boundaries the model must equal the sequential oracle to
rtol 1e-12 in float64.  This holds the decomposition; the kernel itself
is held on the card by ``tests/test_torch_gpu.py``.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import KiB as RKiB, OpType as ROp, WorkloadSpec as RWorkload
from repro.core import ZnsDevice as RDevice, compile_program as r_compile
from repro.core import solve_program as r_solve
from repro.core.engine import zone_sequential_completions as r_scan
from repro.kernels import ref as rref

from repro_torch.kernels import ops, ref

#: float32 tolerances of the reference kernel tests (scans; fixpoint).
F32_SCAN = dict(rtol=1e-5, atol=1e-2)
F32_FIX = dict(rtol=2e-5, atol=1e-2)
#: float64 contract with the sequential loop.
F64 = dict(rtol=1e-12, atol=1e-9)
#: The CUDA scan's tile: 256 threads x 8 elements
#: (``csrc/zns_event_scan.cu``); the fixpoint's tile is 512 x 4.
TILE = 2048
THREADS = 256


def _scan_inputs(rng, shape, p=0.05):
    issue = np.sort(rng.uniform(0, 1e5, shape), axis=-1)
    svc = rng.uniform(1, 50, shape)
    seg = rng.uniform(size=shape) < p
    seg[..., 0] = True
    return issue, svc, seg


def _t(x, dtype=None):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


@pytest.mark.parametrize("n", [1, 7, 1000, 3000])
def test_event_scan_oracle_float32_matches_jax_oracle(n):
    issue, svc, seg = _scan_inputs(np.random.default_rng(n), n)
    want = rref.zns_event_scan_ref(jnp.asarray(issue, jnp.float32),
                                   jnp.asarray(svc, jnp.float32),
                                   jnp.asarray(seg))
    got = ref.zns_event_scan_ref(_t(issue, torch.float32),
                                 _t(svc, torch.float32), _t(seg))
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_SCAN)


@pytest.mark.parametrize("bsz,n", [(1, 7), (3, 1000), (4, 2500)])
def test_event_scan_batched_oracle_float32_matches_jax_oracle(bsz, n):
    issue, svc, seg = _scan_inputs(np.random.default_rng(bsz + n), (bsz, n))
    want = rref.zns_event_scan_batched_ref(jnp.asarray(issue, jnp.float32),
                                           jnp.asarray(svc, jnp.float32),
                                           jnp.asarray(seg))
    got = ref.zns_event_scan_batched_ref(_t(issue, torch.float32),
                                         _t(svc, torch.float32), _t(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_SCAN)


@pytest.mark.parametrize("n", [1, 500, 5000])
def test_event_scan_oracle_float64_matches_numpy_loop(n):
    issue, svc, seg = _scan_inputs(np.random.default_rng(3 * n), n)
    want = r_scan(issue, svc, seg, backend="python")
    got = ref.zns_event_scan_ref(_t(issue, torch.float64),
                                 _t(svc, torch.float64), _t(seg))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, **F64)


def test_event_scan_batched_oracle_float64_rows_match_numpy_loop():
    issue, svc, seg = _scan_inputs(np.random.default_rng(11), (5, 1500),
                                   p=0.02)
    got = ref.zns_event_scan_batched_ref(_t(issue, torch.float64),
                                         _t(svc, torch.float64), _t(seg))
    for b in range(5):
        np.testing.assert_allclose(
            got[b].numpy(), r_scan(issue[b], svc[b], seg[b],
                                   backend="python"), **F64)


def test_ops_scans_route_ref_to_the_oracles():
    issue, svc, seg = _scan_inputs(np.random.default_rng(5), (3, 700))
    args = (_t(issue, torch.float64), _t(svc, torch.float64), _t(seg))
    assert torch.equal(ops.zns_event_scan_batched(*args, impl="ref"),
                       ref.zns_event_scan_batched_ref(*args))
    row = [a[1] for a in args]
    assert torch.equal(ops.zns_event_scan(*row, impl="ref"),
                       ref.zns_event_scan_ref(*row))
    # the oracle and the plain version agree to the float64 contract
    np.testing.assert_allclose(
        ops.zns_event_scan_batched(*args, impl="ref").numpy(),
        ops.zns_event_scan_batched(*args, impl="torch").numpy(), **F64)


def _pairs(rng, semiring, shape):
    if semiring == "mul_add":
        return rng.uniform(0.5, 1.0, shape), rng.standard_normal(shape)
    a = rng.uniform(1, 50, shape)
    a[rng.uniform(size=shape) < 0.1] = ref.NEG_INF      # segment heads
    return a, np.sort(rng.uniform(0, 1e4, shape), axis=0) + a.clip(0)


@pytest.mark.parametrize("semiring", ["mul_add", "max_plus"])
@pytest.mark.parametrize("shape", [(1,), (37,), (300, 3)])
def test_affine_scan_pairs_oracle_float32_matches_jax(semiring, shape):
    a, b = _pairs(np.random.default_rng(len(shape) + shape[0]), semiring,
                  shape)
    wa, wb = rref.affine_scan_pairs_ref(jnp.asarray(a, jnp.float32),
                                        jnp.asarray(b, jnp.float32),
                                        semiring=semiring)
    ga, gb = ref.affine_scan_pairs_ref(_t(a, torch.float32),
                                       _t(b, torch.float32),
                                       semiring=semiring)
    tol = F32_SCAN if semiring == "max_plus" else dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), **tol)
    if semiring == "mul_add":
        np.testing.assert_allclose(ga.numpy(), np.asarray(wa), **tol)
    else:       # sums of sentinels: compare where both are real sums
        real = np.asarray(wa) > -1e29
        assert np.array_equal(ga.numpy() > -1e29, real)
        np.testing.assert_allclose(ga.numpy()[real], np.asarray(wa)[real],
                                   **tol)


@pytest.mark.parametrize("semiring", ["mul_add", "max_plus"])
def test_affine_scan_pairs_oracle_float64_matches_numpy_loop(semiring):
    a, b = _pairs(np.random.default_rng(2), semiring, (400, 2))
    if semiring == "max_plus":
        a[a == ref.NEG_INF] = -np.inf
    want_a, want_b = a.copy(), b.copy()
    for i in range(1, len(a)):
        if semiring == "mul_add":
            want_a[i] = want_a[i - 1] * a[i]
            want_b[i] = want_b[i - 1] * a[i] + b[i]
        else:
            want_a[i] = want_a[i - 1] + a[i]
            want_b[i] = np.maximum(want_b[i - 1] + a[i], b[i])
    ga, gb = ref.affine_scan_pairs_ref(_t(a, torch.float64),
                                       _t(b, torch.float64),
                                       semiring=semiring)
    np.testing.assert_allclose(ga.numpy(), want_a, **F64)
    np.testing.assert_allclose(gb.numpy(), want_b, **F64)


def test_affine_scan_pairs_oracle_rejects_unknown_semiring():
    with pytest.raises(ValueError):
        ref.affine_scan_pairs_ref(torch.ones(3), torch.ones(3),
                                  semiring="min_plus")


def _reference_program(case: str):
    dev = RDevice()
    if case == "pool-resets":
        wl = RWorkload()
        for t in range(3):
            wl = wl.appends(n=60, size=8 * RKiB, qd=2, zone=t * 4, nzones=4)
        wl = wl.resets(n=8, occupancy=1.0, nzones=8, zone=600)
    else:
        wl = (RWorkload()
              .writes(n=600, size=4 * RKiB, qd=4, zone=0)
              .reads(n=600, size=4 * RKiB, qd=16, zone=100, nzones=64)
              .resets(n=10, occupancy=1.0, io_ctx=ROp.WRITE))
    return r_compile(wl.build(), dev.spec, dev.lat, cache=False)


@pytest.mark.parametrize("case", ["pool-resets", "readme-mix"])
def test_fixpoint_oracle_float32_matches_jax_oracle(case):
    prog = _reference_program(case)
    svc = prog.svc0_flat
    blocks = [blk.rows_view() for blk in prog.families]
    want = rref.zns_fixpoint_ref(
        jnp.asarray(prog.issue_flat + svc, jnp.float32),
        jnp.asarray(svc, jnp.float32),
        tuple((jnp.asarray(g), jnp.asarray(h)) for g, h in blocks),
        sweeps=16)
    got = ref.zns_fixpoint_ref(
        _t(prog.issue_flat + svc, torch.float32), _t(svc, torch.float32),
        [(_t(g), _t(h)) for g, h in blocks], sweeps=16)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               **F32_FIX)
    assert got[1] == int(want[1]) and got[2] == bool(want[2]) and got[2]


@pytest.mark.parametrize("case", ["pool-resets", "readme-mix"])
def test_fixpoint_oracle_float64_matches_loop_driver(case):
    prog = _reference_program(case)
    svc = prog.svc0_flat
    want, _, wconv = r_solve(prog, svc, sweeps=16, fixpoint="loop",
                             warn=False)
    got = ref.zns_fixpoint_ref(
        _t(prog.issue_flat + svc, torch.float64), _t(svc, torch.float64),
        [(_t(g), _t(h)) for g, h in
         (blk.rows_view() for blk in prog.families)], sweeps=16)
    assert got[0].dtype == torch.float64
    np.testing.assert_allclose(got[0].numpy(), want, **F64)
    assert got[2] == wconv and got[2]


# ---------------------------------------------------------------------------
# the CUDA scan's tile decomposition, modelled on tensors
# ---------------------------------------------------------------------------
def _compose(x, y):
    """``x . y`` (x earlier) on ``(A, B)`` pairs."""
    return x[0] + y[0], torch.maximum(x[1] + y[0], y[1])


def _carry_in(agg_a, agg_b, threads):
    """Tile k's carry-in value from the aggregates of tiles 0..k-1, in
    ``tile_carry``'s order: thread i composes the i-th run of ceil(k /
    threads) aggregates, then the runs are composed in thread order."""
    k = len(agg_a)
    ninf = torch.tensor(-math.inf, dtype=torch.float64)
    if k == 0:
        return ninf
    run = -(-k // threads)
    total = None
    for i in range(threads):
        j0, j1 = i * run, min(k, (i + 1) * run)
        if j0 >= j1:
            continue
        part = (agg_a[j0], agg_b[j0])
        for j in range(j0 + 1, j1):
            part = _compose(part, (agg_a[j], agg_b[j]))
        total = part if total is None else _compose(total, part)
    return torch.maximum(ninf + total[0], total[1])


def _tiled_scan(issue, svc, seg, tile=TILE, threads=THREADS):
    """The scan of ``(R, N)`` float64 rows as the kernel decomposes it."""
    r, n = issue.shape
    a = torch.where(seg, torch.full_like(svc, -math.inf), svc)
    b = issue + svc
    tpr = -(-n // tile)
    pad = tpr * tile - n
    # identity maps (0, -inf) past the row end
    a = torch.cat([a, a.new_zeros((r, pad))], dim=1)
    b = torch.cat([b, b.new_full((r, pad), -math.inf)], dim=1)
    # every tile scanned on its own, positions along axis 0
    pa, pb = ref.affine_scan_pairs_ref(a.reshape(r * tpr, tile).T,
                                       b.reshape(r * tpr, tile).T,
                                       semiring="max_plus")
    pa = pa.T.reshape(r, tpr, tile)
    pb = pb.T.reshape(r, tpr, tile)
    out = torch.empty_like(pa)
    for row in range(r):
        for k in range(tpr):
            c = _carry_in(pa[row, :k, -1], pb[row, :k, -1], threads)
            out[row, k] = torch.maximum(c + pa[row, k], pb[row, k])
    return out.reshape(r, tpr * tile)[:, :n]


def _heads(kind, shape, rng):
    seg = np.zeros(shape, dtype=bool)
    n = shape[-1]
    if kind == "random":
        seg = rng.uniform(size=shape) < 0.02
        seg[..., 0] = True
    elif kind == "every":
        seg[...] = True
    elif kind == "tile_starts":
        seg[..., ::TILE] = True
    elif kind == "first_only":
        seg[..., 0] = True
    elif kind == "head_tile":          # one whole tile of heads
        seg[..., 0] = True
        seg[..., TILE:2 * TILE] = True
    elif kind != "none":
        raise KeyError(kind)
    assert seg.shape[-1] == n
    return seg


@pytest.mark.parametrize("heads", ["random", "every", "tile_starts",
                                   "first_only", "head_tile", "none"])
@pytest.mark.parametrize("n", [1, TILE - 1, TILE, TILE + 1, 3 * TILE + 5])
def test_tiled_decomposition_matches_sequential_oracle(n, heads):
    rng = np.random.default_rng(n + len(heads))
    issue, svc, _ = _scan_inputs(rng, (2, n))
    seg = _heads(heads, (2, n), rng)
    args = (_t(issue, torch.float64), _t(svc, torch.float64), _t(seg))
    want = ref.zns_event_scan_batched_ref(*args)
    np.testing.assert_allclose(_tiled_scan(*args).numpy(), want.numpy(),
                               **F64)


@pytest.mark.parametrize("threads", [1, 2, 3])
def test_tiled_carry_runs_match_sequential_oracle(threads):
    """More earlier tiles than threads: each thread composes a run of
    aggregates before the runs are composed (the kernel's path for rows
    of more than 256 tiles), here with small tiles."""
    rng = np.random.default_rng(threads)
    issue, svc, seg = _scan_inputs(rng, (3, 450), p=0.01)
    args = (_t(issue, torch.float64), _t(svc, torch.float64), _t(seg))
    want = ref.zns_event_scan_batched_ref(*args)
    got = _tiled_scan(*args, tile=32, threads=threads)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F64)
