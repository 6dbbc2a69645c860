"""The port's kernels held against the reference package's kernels.

On the CPU the port's wrappers run their plain PyTorch versions; these
are compared, on the same numpy inputs, with the reference's Pallas
kernels in interpret mode (float32, at those kernels' own tolerances)
and with its float64 numpy paths (rtol 1e-12).  The CUDA kernels
themselves are held against these plain versions on the card by
``tests/test_torch_gpu.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import KiB as RKiB, OpType as ROp, WorkloadSpec as RWorkload
from repro.core import ZnsDevice as RDevice, compile_program as r_compile
from repro.core import solve_program as r_solve
from repro.core.engine import (
    zone_sequential_completions as r_scan,
    zone_sequential_completions_batched as r_scan_batched,
)
from repro.kernels import ops as rops
from repro.kernels.zns_event_scan import zns_event_scan as r_pallas_scan
from repro.kernels.zns_fixpoint import blocks_adjacency as r_adjacency

from repro_torch.kernels import ops, zns_event_scan as pscan
from repro_torch.kernels import zns_fixpoint as pfix

#: float32 tolerances of the reference kernel tests.
F32_SCAN = dict(rtol=1e-5, atol=1e-2)
F32_FIX = dict(rtol=2e-5, atol=1e-2)
#: float64 contract with the reference's numpy paths.
F64 = dict(rtol=1e-12, atol=1e-9)


def _scan_inputs(rng, shape):
    issue = np.sort(rng.uniform(0, 1e5, shape), axis=-1)
    svc = rng.uniform(1, 50, shape)
    seg = rng.uniform(size=shape) < 0.05
    seg[..., 0] = True
    return issue, svc, seg


def _t(x, dtype=None):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


@pytest.mark.parametrize("n,block", [(7, 1024), (1000, 256), (4096, 512)])
def test_scan_float32_matches_pallas_interpret(n, block):
    issue, svc, seg = _scan_inputs(np.random.default_rng(n), n)
    want = r_pallas_scan(jnp.asarray(issue, jnp.float32),
                         jnp.asarray(svc, jnp.float32), jnp.asarray(seg),
                         block=block, interpret=True)
    got = ops.zns_event_scan(_t(issue, torch.float32),
                             _t(svc, torch.float32), _t(seg))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_SCAN)


@pytest.mark.parametrize("bsz,n", [(1, 7), (3, 1000), (5, 2048)])
def test_scan_batched_float32_matches_pallas_interpret(bsz, n):
    issue, svc, seg = _scan_inputs(np.random.default_rng(bsz * n), (bsz, n))
    want = rops.zns_event_scan_batched(
        jnp.asarray(issue, jnp.float32), jnp.asarray(svc, jnp.float32),
        jnp.asarray(seg), impl="interpret")
    got = ops.zns_event_scan_batched(_t(issue, torch.float32),
                                     _t(svc, torch.float32), _t(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_SCAN)
    # rows are independent: each row equals its own 1-D scan
    for b in range(bsz):
        row = ops.zns_event_scan(_t(issue[b], torch.float32),
                                 _t(svc[b], torch.float32), _t(seg[b]))
        np.testing.assert_array_equal(got[b].numpy(), row.numpy())


@pytest.mark.parametrize("n", [1, 500, 5000])
def test_scan_float64_matches_reference_numpy(n):
    issue, svc, seg = _scan_inputs(np.random.default_rng(7 + n), n)
    want = r_scan(issue, svc, seg, backend="numpy")
    got = ops.zns_event_scan(_t(issue), _t(svc), _t(seg))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, **F64)
    # and the sequential oracle
    np.testing.assert_allclose(got.numpy(),
                               r_scan(issue, svc, seg, backend="python"),
                               **F64)


@pytest.mark.parametrize("bsz,n", [(1, 7), (4, 600), (6, 3000)])
def test_scan_batched_float64_matches_reference_numpy(bsz, n):
    issue, svc, seg = _scan_inputs(np.random.default_rng(bsz + n), (bsz, n))
    want = r_scan_batched(issue, svc, seg, backend="numpy")
    got = ops.zns_event_scan_batched(_t(issue), _t(svc), _t(seg))
    np.testing.assert_allclose(got.numpy(), want, **F64)


def test_scan_wrappers_use_plain_version_on_cpu():
    issue, svc, seg = _scan_inputs(np.random.default_rng(3), (2, 300))
    before = (pscan.zns_event_scan.launches,
              pscan.zns_event_scan_batched.launches)
    plain = pscan.rows_maxplus_torch(_t(issue), _t(svc), _t(seg))
    np.testing.assert_array_equal(
        pscan.zns_event_scan_batched(_t(issue), _t(svc), _t(seg)).numpy(),
        plain.numpy())
    np.testing.assert_array_equal(
        pscan.zns_event_scan(_t(issue[1]), _t(svc[1]), _t(seg[1])).numpy(),
        plain[1].numpy())
    assert (pscan.zns_event_scan.launches,
            pscan.zns_event_scan_batched.launches) == before


def test_cuda_impl_refuses_cpu_tensors():
    issue, svc, seg = _scan_inputs(np.random.default_rng(4), 64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.zns_event_scan(_t(issue), _t(svc), _t(seg), impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        ops.zns_event_scan(_t(issue), _t(svc), _t(seg), impl="pallas")
    with pytest.raises(TypeError):
        ops.zns_event_scan(_t(issue), _t(svc, torch.float32), _t(seg))


# -- fixpoint ------------------------------------------------------------------
def _program(case: str):
    """Reference-compiled programs of the reference fixpoint tests
    (``tests/test_chain_program.py``): an append pool with resets, and
    uneven chains that pad blocks with dead-slot lanes."""
    dev = RDevice()
    if case == "pool-resets":
        wl = RWorkload()
        for t in range(3):
            wl = wl.appends(n=60, size=8 * RKiB, qd=2, zone=t * 4, nzones=4)
        wl = wl.resets(n=8, occupancy=1.0, nzones=8, zone=600)
    elif case == "padding":
        wl = (RWorkload()
              .appends(n=40, size=8 * RKiB, qd=4, zone=0, nzones=4)
              .appends(n=64, size=8 * RKiB, qd=4, zone=4, nzones=4))
    else:
        wl = (RWorkload()
              .writes(n=600, size=4 * RKiB, qd=4, zone=0)
              .reads(n=600, size=4 * RKiB, qd=16, zone=100, nzones=64)
              .resets(n=10, occupancy=1.0, io_ctx=ROp.WRITE))
    return r_compile(wl.build(), dev.spec, dev.lat, cache=False)


FIX_CASES = ("pool-resets", "padding", "readme-mix")


@pytest.mark.parametrize("case", FIX_CASES)
@pytest.mark.parametrize("impl", ["interpret", "xla"])
def test_fixpoint_float32_matches_reference_kernels(case, impl):
    prog = _program(case)
    svc = prog.svc0_flat
    comp0 = prog.issue_flat + svc
    blocks = [b.rows_view() for b in prog.families]
    want, w_used, w_conv = rops.zns_fixpoint(comp0, svc, tuple(blocks),
                                             sweeps=8, impl=impl)
    got, used, conv = ops.zns_fixpoint(_t(comp0, torch.float32),
                                       _t(svc, torch.float32), blocks,
                                       sweeps=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_FIX)
    assert conv == bool(w_conv) and conv
    assert used == int(w_used)


@pytest.mark.parametrize("case", FIX_CASES)
def test_fixpoint_float64_matches_reference_loop(case):
    prog = _program(case)
    svc = prog.svc0_flat
    want, _, w_conv = r_solve(prog, svc, fixpoint="loop")
    got, used, conv = ops.zns_fixpoint(
        _t(prog.issue_flat + svc), _t(svc),
        [b.rows_view() for b in prog.families], sweeps=8)
    assert got.dtype == torch.float64
    assert conv and w_conv and used >= 1
    np.testing.assert_allclose(got.numpy(), want, **F64)


@pytest.mark.parametrize("case", FIX_CASES)
def test_blocks_adjacency_matches_reference(case):
    prog = _program(case)
    gidxs = [b.rows_view()[0] for b in prog.families]
    np.testing.assert_array_equal(pfix.blocks_adjacency(gidxs, prog.n_flat),
                                  r_adjacency(gidxs, prog.n_flat))


def test_fixpoint_wrapper_uses_plain_version_on_cpu():
    prog = _program("pool-resets")
    svc = prog.svc0_flat
    packed = pfix.pack_blocks([b.rows_view() for b in prog.families],
                              prog.n_flat, "cpu")
    before = pfix.zns_fixpoint.launches
    a = pfix.zns_fixpoint(_t(prog.issue_flat + svc), _t(svc), packed)
    log = []
    b = pfix.zns_fixpoint_torch(_t(prog.issue_flat + svc), _t(svc), packed,
                                active_log=log)
    np.testing.assert_array_equal(a[0].numpy(), b[0].numpy())
    assert a[1:] == b[1:] and len(log) == b[1]
    assert log[0] == list(range(len(packed.shapes)))
    assert pfix.zns_fixpoint.launches == before


def test_pack_blocks_validates():
    g = np.array([[0, 1, 5]])
    h = np.array([[True, False, True]])
    with pytest.raises(ValueError, match="out of range"):
        pfix.pack_blocks([(g, h)], 4, "cpu")
    with pytest.raises(ValueError, match="matching"):
        pfix.pack_blocks([(g, h[:, :2])], 5, "cpu")
    packed = pfix.pack_blocks([(g, h)], 5, "cpu")
    assert packed.gidx.dtype == torch.int32 and packed.shapes == ((0, 1, 3),)
