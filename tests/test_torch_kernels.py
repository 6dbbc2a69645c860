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

import jax
import jax.numpy as jnp

from repro.core import KiB as RKiB, OpType as ROp, WorkloadSpec as RWorkload
from repro.core import ZnsDevice as RDevice, compile_program as r_compile
from repro.core import solve_program as r_solve
from repro.core.engine import (
    zone_sequential_completions as r_scan,
    zone_sequential_completions_batched as r_scan_batched,
)
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.kernels.zns_event_scan import zns_event_scan as r_pallas_scan
from repro.kernels.zns_fixpoint import blocks_adjacency as r_adjacency

from repro_torch.kernels import flash_attention as pfa
from repro_torch.kernels import ops, zns_event_scan as pscan
from repro_torch.kernels import ref as pref
from repro_torch.kernels import rmsnorm as prms
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


@pytest.mark.parametrize("rows,length,tiles", [
    (33_094, 1, 17),          # one-lane chains pack 2,048 to a tile
    (192, 79, 8),             # 25 rows a tile
    (5, 2048, 5),             # a row fills a tile
    (4, 1025, 4),             # one row a tile
    (16, 50_000, 400),        # a row spans 25 tiles
    (3, 0, 0), (0, 7, 0),     # empty blocks take no tile
])
def test_fixpoint_block_tiles(rows, length, tiles):
    """How the CUDA fixpoint cuts a block into tiles of 2,048 lanes (its
    grid is the largest block's count, and its scratch two values a
    tile)."""
    assert pfix.block_tiles(rows, length, 2048) == tiles


# -- backward passes: the plain versions of the two backward kernels ---------
#: Plain backward against autograd of the plain forward: the same float32
#: arithmetic in another order.
BWD_AUTOGRAD = {torch.float32: dict(rtol=1e-5, atol=1e-5),
                torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
#: ... and against jax.grad of the reference's oracle (float32 inputs);
#: bfloat16 inputs round their gradients to 8 bits in both.
BWD_JAX = {torch.float32: dict(rtol=1e-4, atol=1e-4),
           torch.bfloat16: dict(rtol=2e-2, atol=3e-2)}


BWD_CASES = [
    (1, 4, 4, 40, 40, 16, None),
    (2, 8, 2, 33, 33, 32, None),      # GQA 4
    (1, 8, 1, 20, 50, 16, None),      # GQA 8, tq < tk (end-aligned)
    (1, 4, 2, 48, 48, 32, 7),         # window
    (1, 4, 2, 30, 45, 16, 5),         # window, tq < tk
    (1, 4, 2, 50, 20, 16, None),      # tq > tk: the first rows see no key
]


@pytest.mark.parametrize("b,hq,hkv,tq,tk,d,window", BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_bwd_plain_matches_autograd_and_jax(b, hq, hkv, tq, tk, d,
                                                      window, dtype):
    rng = np.random.default_rng(tq + tk + d)
    shapes = ((b, hq, tq, d), (b, hkv, tk, d), (b, hkv, tk, d))
    arrays = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    do = rng.standard_normal(shapes[0]).astype(np.float32)
    q, k, v = (torch.as_tensor(a).to(dtype).requires_grad_(True)
               for a in arrays)
    out, lse = pfa.attention_torch(q, k, v, window=window, return_lse=True)
    seen = torch.isfinite(lse)
    # rows that see no key: the port writes 0 and takes no gradient; the
    # reference's dense oracle spreads them over every key, so their
    # cotangent is 0 for the comparison with it
    do[~seen.numpy()] = 0.0
    dot = torch.as_tensor(do).to(dtype)
    want = torch.autograd.grad(out, (q, k, v), dot)
    got = pfa.attention_bwd_torch(q.detach(), k.detach(), v.detach(),
                                  out.detach(), dot, lse, window=window)
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.dtype == t.dtype and g.shape == t.shape
        np.testing.assert_allclose(g.float().numpy(), w.float().numpy(),
                                   **BWD_AUTOGRAD[dtype])
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jq, jk, jv = (jnp.asarray(a, jd) for a in arrays)
    _, vjp = jax.vjp(lambda q_, k_, v_: rref.attention_ref(
        q_, k_, v_, window=window), jq, jk, jv)
    ref = vjp(jnp.asarray(do, jd))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(r, np.float32),
                                   **BWD_JAX[dtype])
    if not bool(seen.all()):
        assert bool((got[0][~seen] == 0).all())


def _bwd_bf16_rounding_points(q, k, v, o, do, lse, window):
    """``attention_bwd_torch``'s arithmetic in float32 with the bfloat16
    CUDA backward's rounding points: P and dS rounded to bfloat16 before
    the three products (dV = P^T dO, dK = dS^T Q, dQ = dS K), as the
    tensor cores take them; S and dP, products of bfloat16 inputs, stay
    float32; the gradients are rounded to bfloat16 at the end."""
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    rep, scale = hq // hkv, d ** -0.5
    qg = q.float().reshape(b, hkv, rep, tq, d)
    gg = do.float().reshape(b, hkv, rep, tq, d)
    kf, vf = k.float().unsqueeze(2), v.float().unsqueeze(2)
    lg = lse.reshape(b, hkv, rep, tq, 1)
    dg = (do.float() * o.float()).sum(-1).reshape(b, hkv, rep, tq, 1)
    mask = pref.attention_mask(tq, tk, True, window, q.device)
    p = torch.where(mask, torch.exp(qg @ kf.transpose(-1, -2) * scale - lg),
                    0.0)
    ds = p * (gg @ vf.transpose(-1, -2) - dg)
    p, ds = (t.to(torch.bfloat16).float() for t in (p, ds))
    dq = (ds @ kf * scale).reshape(b, hq, tq, d)
    dk = (ds.transpose(-1, -2) @ qg).sum(2) * scale
    dv = (p.transpose(-1, -2) @ gg).sum(2)
    return tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))


@pytest.mark.parametrize("b,hq,hkv,tq,tk,d,window", BWD_CASES)
def test_attention_bwd_bf16_rounding_points_match_jax(b, hq, hkv, tq, tk, d,
                                                      window):
    """The bfloat16 kernel's rounding points (P and dS in bfloat16 before
    its tensor-core products) keep the gradients within the bfloat16
    tolerance of jax.vjp of the reference's oracle."""
    rng = np.random.default_rng(tq + tk + d)
    shapes = ((b, hq, tq, d), (b, hkv, tk, d), (b, hkv, tk, d))
    arrays = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    do = rng.standard_normal(shapes[0]).astype(np.float32)
    q, k, v = (torch.as_tensor(a).to(torch.bfloat16) for a in arrays)
    out, lse = pfa.attention_torch(q, k, v, window=window, return_lse=True)
    seen = torch.isfinite(lse)
    do[~seen.numpy()] = 0.0       # as in the test above
    got = _bwd_bf16_rounding_points(q, k, v, out,
                                    torch.as_tensor(do).to(torch.bfloat16),
                                    lse, window)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in arrays)
    _, vjp = jax.vjp(lambda q_, k_, v_: rref.attention_ref(
        q_, k_, v_, window=window), jq, jk, jv)
    ref = vjp(jnp.asarray(do, jnp.bfloat16))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(r, np.float32),
                                   **BWD_JAX[torch.bfloat16])
    if not bool(seen.all()):
        assert bool((got[0][~seen] == 0).all())


@pytest.mark.parametrize("shape", [(6, 64), (2, 5, 48), (3, 4, 2, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_bwd_plain_matches_autograd_and_jax(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    xa = rng.standard_normal(shape).astype(np.float32)
    wa = (rng.standard_normal(shape[-1]) * 0.1).astype(np.float32)
    dya = rng.standard_normal(shape).astype(np.float32)
    x = torch.as_tensor(xa).to(dtype).requires_grad_(True)
    w = torch.as_tensor(wa).requires_grad_(True)
    dy = torch.as_tensor(dya).to(dtype)
    want = torch.autograd.grad(prms.rmsnorm_torch(x, w), (x, w), dy)
    dx, dw = prms.rmsnorm_bwd_torch(x.detach(), w.detach(), dy)
    assert dx.dtype == dtype and dw.dtype == torch.float32
    np.testing.assert_allclose(dx.float().numpy(), want[0].float().numpy(),
                               **BWD_AUTOGRAD[dtype])
    np.testing.assert_allclose(dw.numpy(), want[1].numpy(), rtol=1e-5,
                               atol=1e-4)
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    _, vjp = jax.vjp(lambda x_, w_: rref.rmsnorm_ref(x_, w_),
                     jnp.asarray(xa, jd), jnp.asarray(wa))
    rdx, rdw = vjp(jnp.asarray(dya, jd))
    np.testing.assert_allclose(dx.float().numpy(), np.asarray(rdx,
                                                              np.float32),
                               **BWD_JAX[dtype])
    np.testing.assert_allclose(dw.numpy(), np.asarray(rdw, np.float32),
                               rtol=1e-4, atol=5e-3)


@pytest.mark.parametrize("shape,n", [((6, 64), 4), ((2, 5, 48), 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_cut_plain_matches_whole_rows(shape, n, dtype):
    """Rows cut into ``n`` blocks of columns, each block's partial sums
    completed by the others' (the all-reduce's result): the cut norm's
    plain forward and backward (and ``RMSNormCutFunction`` on CPU
    tensors, which runs them) against the whole-row ``rmsnorm_torch`` and
    ``rmsnorm_bwd_torch``, block by block."""
    rng = np.random.default_rng(sum(shape) + n)
    d = shape[-1]
    x = torch.as_tensor(rng.standard_normal(shape).astype(np.float32)
                        ).to(dtype)
    w = torch.as_tensor((rng.standard_normal(d) * 0.1).astype(np.float32))
    dy = torch.as_tensor(rng.standard_normal(shape).astype(np.float32)
                         ).to(dtype)
    b = d // n
    cols = [slice(i * b, (i + 1) * b) for i in range(n)]
    xf, gf = x.float(), dy.float()
    sq = [torch.sum(xf[..., c] ** 2, -1) for c in cols]
    dots = [torch.sum(gf[..., c] * (1 + w[c]) * xf[..., c], -1)
            for c in cols]

    def adding(parts, i):
        others = sum(p for j, p in enumerate(parts) if j != i)
        return lambda t: t + others.reshape(t.shape)

    want = prms.rmsnorm_torch(x, w)
    want_dx, want_dw = prms.rmsnorm_bwd_torch(x, w, dy)
    tol = BWD_AUTOGRAD[dtype]
    for i, c in enumerate(cols):
        y = prms.rmsnorm_cut_torch(x[..., c], w[c], adding(sq, i), width=d)
        np.testing.assert_allclose(y.float().numpy(),
                                   want[..., c].float().numpy(), **tol)
        ss = sum(sq).reshape(-1)
        dx, dw = prms.rmsnorm_cut_bwd_torch(x[..., c], w[c], dy[..., c], ss,
                                            adding(dots, i), width=d)
        assert dx.dtype == dtype and dw.dtype == torch.float32
        np.testing.assert_allclose(dx.float().numpy(),
                                   want_dx[..., c].float().numpy(), **tol)
        np.testing.assert_allclose(dw.numpy(), want_dw[c].numpy(),
                                   rtol=1e-5, atol=1e-4)
        xc = x[..., c].clone().requires_grad_(True)
        wc = w[c].clone().requires_grad_(True)
        launches = (prms.rmsnorm_cut.launches, prms.rmsnorm_cut_bwd.launches)
        # the Function sums the squares forward, the dot products backward
        others = iter([adding(sq, i), adding(dots, i)])
        z = prms.RMSNormCutFunction.apply(
            xc, wc, lambda t: next(others)(t), d, 1e-6)
        got = torch.autograd.grad(z, (xc, wc), dy[..., c])
        np.testing.assert_allclose(z.detach().float().numpy(),
                                   y.float().numpy(), **tol)
        np.testing.assert_allclose(got[0].float().numpy(),
                                   dx.float().numpy(), **tol)
        np.testing.assert_allclose(got[1].numpy(), dw.numpy(), rtol=1e-5,
                                   atol=1e-4)
        assert launches == (prms.rmsnorm_cut.launches,
                            prms.rmsnorm_cut_bwd.launches)


def test_autograd_functions_run_plain_versions_on_cpu():
    """The Functions that ``ops`` uses on ``impl="cuda"`` take CPU tensors
    too (their wrappers then run the plain versions), and give plain
    autograd's gradients; no kernel launch is counted."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.as_tensor(rng.standard_normal(s).astype(np.float32))
               .requires_grad_(True) for s in ((1, 4, 20, 16),
                                               (1, 2, 20, 16),
                                               (1, 2, 20, 16)))
    x = torch.as_tensor(rng.standard_normal((5, 32)).astype(np.float32)
                        ).requires_grad_(True)
    w = torch.zeros(32, requires_grad=True)
    launches = (pfa.flash_attention.launches,
                pfa.flash_attention_bwd.launches, prms.rmsnorm.launches,
                prms.rmsnorm_bwd.launches)
    y = pfa.FlashAttentionFunction.apply(q, k, v, True, 6, None)
    z = prms.RMSNormFunction.apply(x, w, 1e-6)
    got = torch.autograd.grad((y.sum(), (z * z).sum()), (q, k, v, x, w))
    y2 = pfa.attention_torch(q, k, v, window=6)
    z2 = prms.rmsnorm_torch(x, w)
    want = torch.autograd.grad((y2.sum(), (z2 * z2).sum()), (q, k, v, x, w))
    for g, t in zip(got, want):
        np.testing.assert_allclose(g.numpy(), t.numpy(), rtol=1e-5,
                                   atol=1e-5)
    assert launches == (pfa.flash_attention.launches,
                        pfa.flash_attention_bwd.launches,
                        prms.rmsnorm.launches, prms.rmsnorm_bwd.launches)


def test_cuda_route_needs_cuda_tensors_for_gradients_too():
    q = torch.zeros((1, 2, 4, 16), requires_grad=True)
    with pytest.raises(ValueError, match="CUDA"):
        ops.attention(q, q, q, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ops.rmsnorm(q, torch.zeros(16), impl="cuda")
