"""The recurrent families' backward held against the reference's autodiff.

The plain backward versions of the port's recurrent kernels
(``linear_recurrence_bwd_torch``, ``ssd_bwd_torch``) and the attention
backward at D 256 with a window (recurrentgemma-9b's shape, cut small)
against ``jax.vjp`` of the reference's oracles
(``repro.kernels.ref.linear_recurrence_ref`` / ``ssd_ref`` /
``attention_ref``) and against autograd of the port's plain forwards, on
seeded numpy inputs; then the two ``torch.autograd.Function`` objects
that ``ops`` uses on a card, run on the CPU (their wrappers take the
plain versions for CPU tensors), inside mamba2's and recurrentgemma's
smoke configs against ``jax.value_and_grad`` of the reference's loss on
shared weights; and the plain versions in float64, the arbiter of the
card's float32 gradients.  The CUDA kernels themselves are held against
these plain versions on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py`` phase 2).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import models as RM
from repro.configs import get_smoke_config as r_smoke
from repro.kernels import ref as rref

from repro_torch import models as M
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import flash_attention as pfa
from repro_torch.kernels import linear_recurrence as plr
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_chunk_scan as pssd
from repro_torch.utils.tree import tree_flatten

#: Against jax.vjp: float32 differs in summation order only (the plain
#: recurrence scans in blocks, the reference step by step; the SSD
#: plain backward works in chunks); bfloat16 gradients by their last
#: rounding (2^-8 relative), and the recurrence's da also by h's bfloat16
#: rounding (2^-9 relative a term, the saved h of the Function's
#: docstring).  rtol, and atol as a fraction of the largest magnitude.
TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2e-2, 1e-2)}
#: Smoke models' gradient leaves, float32: tests/test_torch_train.py's F32.
MODEL_TOL = (1e-4, 1e-4)
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _hold(got, want, tol, what):
    rtol, frac = tol
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=frac * max(float(np.abs(want).max()),
                                               1e-30), err_msg=what)


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a, np.float32)).to(dtype)


@pytest.mark.parametrize("shape", [(2, 50, 6), (1, 600, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_linear_recurrence_bwd_matches_jax_vjp(shape, dtype):
    """da, db from the forward's h and dh against jax.vjp of the
    sequential oracle and autograd of the plain forward; T 600 crosses
    the plain scan's 256-step blocks."""
    rng = np.random.default_rng(sum(shape))
    a = rng.uniform(0.6, 0.999, shape)
    b, dh = rng.standard_normal(shape), rng.standard_normal(shape)
    jd = JNP[dtype]
    _, vjp = jax.vjp(rref.linear_recurrence_ref, jnp.asarray(a, jd),
                     jnp.asarray(b, jd))
    want = vjp(jnp.asarray(dh, jd))
    ta, tb, tdh = _t(a, dtype), _t(b, dtype), _t(dh, dtype)
    h = plr.linear_recurrence_torch(ta, tb)
    got = plr.linear_recurrence_bwd_torch(ta, h, tdh)
    assert [g.dtype for g in got] == [dtype, dtype]
    for name, g, w in zip("ab", got, want):
        _hold(g, w, TOL[dtype], f"d{name}")
    xa, xb = ta.clone().requires_grad_(True), tb.clone().requires_grad_(True)
    auto = torch.autograd.grad(plr.linear_recurrence_torch(xa, xb), (xa, xb),
                               tdh)
    for name, g, w in zip("ab", got, auto):
        _hold(g, w.float(), TOL[dtype], f"d{name} against autograd")


@pytest.mark.parametrize("bb,t,h,p,g,n,chunk", [
    (2, 70, 4, 8, 1, 8, 32),         # T not a chunk multiple, G 1
    (1, 64, 4, 8, 2, 12, 32),        # G 2
    (2, 45, 6, 4, 3, 16, 16),        # G 3, ragged, chunk 16
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_bwd_matches_jax_vjp(bb, t, h, p, g, n, chunk, dtype):
    """(dx, ddt, dA, dB, dC) from dy and the final state's gradient against
    jax.vjp of the sequential oracle, and autograd of the plain forward."""
    rng = np.random.default_rng(t * h + n)
    x = rng.standard_normal((bb, t, h, p))
    dt = rng.uniform(0.01, 0.5, (bb, t, h))
    A = -rng.uniform(0.5, 2.0, h)
    B, C = (rng.standard_normal((bb, t, g, n)) * 0.5 for _ in "BC")
    dy = rng.standard_normal((bb, t, h, p))
    ds = rng.standard_normal((bb, h, p, n))
    jd = JNP[dtype]
    _, vjp = jax.vjp(rref.ssd_ref, jnp.asarray(x, jd),
                     jnp.asarray(dt, jnp.float32), jnp.asarray(A, jnp.float32),
                     jnp.asarray(B, jd), jnp.asarray(C, jd))
    want = vjp((jnp.asarray(dy, jd), jnp.asarray(ds, jnp.float32)))
    ins = [_t(x, dtype), _t(dt), _t(A), _t(B, dtype), _t(C, dtype)]
    got = pssd.ssd_bwd_torch(*ins, _t(dy, dtype), _t(ds), chunk=chunk)
    assert [u.dtype for u in got] == [dtype, torch.float32, torch.float32,
                                      dtype, dtype]
    for name, u, w in zip(("x", "dt", "A", "B", "C"), got, want):
        _hold(u, w, TOL[dtype], f"d{name}")
    req = [u.clone().requires_grad_(True) for u in ins]
    y, s = pssd.ssd_torch(*req, chunk=chunk)
    auto = torch.autograd.grad((y, s), req, (_t(dy, dtype), _t(ds)))
    for name, u, w in zip(("x", "dt", "A", "B", "C"), got, auto):
        _hold(u, w.float(), TOL[dtype], f"d{name} against autograd")


@pytest.mark.parametrize("hq,hkv,dtype", [
    pytest.param(4, 1, torch.float32, id="dtype0"),
    pytest.param(4, 1, torch.bfloat16, id="dtype1"),
    # recurrentgemma's MQA 16/1 and a GQA 4/2 (the kernels' head groups)
    pytest.param(16, 1, torch.float32, id="mqa16-dtype0"),
    pytest.param(16, 1, torch.bfloat16, id="mqa16-dtype1"),
    pytest.param(4, 2, torch.float32, id="gqa4_2-dtype0"),
    pytest.param(4, 2, torch.bfloat16, id="gqa4_2-dtype1"),
])
def test_attention_bwd_d256_window_matches_jax_vjp(hq, hkv, dtype):
    """recurrentgemma's attention backward cut small: D 256, window 32 of
    T 96, hq query heads on hkv KV heads."""
    rng = np.random.default_rng(256)
    q = rng.standard_normal((1, hq, 96, 256))
    k, v = (rng.standard_normal((1, hkv, 96, 256)) for _ in "kv")
    do = rng.standard_normal((1, hq, 96, 256))
    jd = JNP[dtype]
    _, vjp = jax.vjp(lambda q_, k_, v_: rref.attention_ref(q_, k_, v_,
                                                           window=32),
                     jnp.asarray(q, jd), jnp.asarray(k, jd),
                     jnp.asarray(v, jd))
    want = vjp(jnp.asarray(do, jd))
    tq, tk, tv, tdo = (_t(u, dtype) for u in (q, k, v, do))
    o, lse = pfa.attention_torch(tq, tk, tv, window=32, return_lse=True)
    got = pfa.attention_bwd_torch(tq, tk, tv, o, tdo, lse, window=32)
    for name, u, w in zip("qkv", got, want):
        _hold(u, w, TOL[dtype], f"d{name}")


def test_recurrent_functions_run_plain_versions_on_cpu():
    """The two Functions that ops uses on impl="cuda" take CPU tensors (the
    wrappers then run the plain versions) and give plain autograd's
    gradients, the SSD scan's final state's gradient included; no kernel
    launch is counted."""
    rng = np.random.default_rng(4)
    a = _t(rng.uniform(0.5, 0.99, (2, 40, 8))).requires_grad_(True)
    b = _t(rng.standard_normal((2, 40, 8))).requires_grad_(True)
    ins = [_t(rng.standard_normal((1, 64, 4, 8))), _t(rng.uniform(
        0.01, 0.3, (1, 64, 4))), _t(-rng.uniform(0.5, 2, 4)),
        _t(rng.standard_normal((1, 64, 2, 8))),
        _t(rng.standard_normal((1, 64, 2, 8)))]
    ins = [u.requires_grad_(True) for u in ins]
    counters = (plr.linear_recurrence, plr.linear_recurrence_bwd,
                pssd.ssd_chunk_scan, pssd.ssd_chunk_scan_bwd)
    before = [fn.launches for fn in counters]
    h = plr.LinearRecurrenceFunction.apply(a, b)
    y, s = pssd.SSDScanFunction.apply(*ins, 32)
    loss = (h * h).sum() + (y * y).sum() + s.sum()
    got = torch.autograd.grad(loss, [a, b] + ins)
    h2 = plr.linear_recurrence_torch(a, b)
    y2, s2 = pssd.ssd_torch(*ins, chunk=32)
    want = torch.autograd.grad((h2 * h2).sum() + (y2 * y2).sum() + s2.sum(),
                               [a, b] + ins)
    for g, w in zip(got, want):
        _hold(g, w, TOL[torch.float32], "Function gradient")
    assert [fn.launches for fn in counters] == before


@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-9b"])
def test_smoke_gradients_through_functions_match_reference(arch,
                                                           monkeypatch):
    """loss_fn's float32 gradients with the SSD scan and the linear
    recurrence through their Functions (on the CPU, the plain versions
    forward and backward) against jax.value_and_grad of the reference's
    loss on shared weights; 40 tokens: two SSD chunks with padding, and
    more than recurrentgemma's window of 32."""
    calls = []

    def ssd(x, dt, A, B, C, *, chunk=128, impl=None):
        calls.append("ssd")
        return pssd.SSDScanFunction.apply(x, dt, A, B, C, chunk)

    def lr(a, b, *, impl=None):
        calls.append("lr")
        return plr.LinearRecurrenceFunction.apply(a, b)

    monkeypatch.setattr(ops, "ssd_scan", ssd)
    monkeypatch.setattr(ops, "linear_recurrence", lr)
    rcfg = dataclasses.replace(r_smoke(arch), dtype="float32")
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    rp = RM.init_params(rcfg, jax.random.PRNGKey(0))
    params = M.params_from_reference(cfg, jax.tree.map(np.asarray, rp),
                                     device="cpu")
    params.requires_grad_(True)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size,
                                             (2, 40)).astype(np.int32)
    (rloss, _), rgrads = jax.value_and_grad(
        lambda p: RM.loss_fn(rcfg, p, {"tokens": jnp.asarray(toks)}),
        has_aux=True)(rp)
    grads = M.bind_grads(cfg, params)
    loss, _ = M.loss_fn(cfg, params, {"tokens": torch.as_tensor(toks)})
    loss.backward()
    assert calls and set(calls) == {"ssd" if arch == "mamba2-370m" else "lr"}
    assert float(loss.detach()) == pytest.approx(float(rloss), rel=1e-5)
    paths, _ = jax.tree_util.tree_flatten_with_path(rgrads)
    port, _ = tree_flatten(grads)
    assert len(paths) == len(port)
    for (path, want), got in zip(paths, port):
        _hold(got, want, MODEL_TOL, jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-9b"])
def test_float64_smoke_model_runs_plain_versions(arch):
    """A float64 model (kernel_impl="torch") computes the SSD scan and the
    recurrence in float64: its loss and gradients agree with the float32
    model's to float32's precision, and its leaves are float64."""
    cfg = get_smoke_config(arch)
    out = {}
    for dtype in ("float32", "float64"):
        c = dataclasses.replace(cfg, dtype=dtype, param_dtype=dtype,
                                kernel_impl="torch")
        params = M.init_params(c, torch.Generator().manual_seed(0),
                               device="cpu", weight_std=0.02)
        params.requires_grad_(True)
        grads = M.bind_grads(c, params)
        toks = torch.as_tensor(np.random.default_rng(5).integers(
            0, c.vocab_size, (2, 40)))
        loss, _ = M.loss_fn(c, params, {"tokens": toks})
        loss.backward()
        out[dtype] = (loss, tree_flatten(grads)[0])
    assert out["float64"][0].dtype == torch.float64
    assert float(out["float64"][0].detach()) == pytest.approx(
        float(out["float32"][0].detach()), rel=1e-5)
    for g64, g32 in zip(out["float64"][1], out["float32"][1]):
        assert g64.dtype == torch.float64
        _hold(g32, g64.numpy(), (1e-3, 1e-4), "float32 against float64")


def test_plain_recurrent_ops_take_float64_only_by_name():
    """float64 goes to the plain versions when asked for by name; the
    kernels' dtypes stay float32 and bfloat16."""
    a = torch.full((1, 8, 4), 0.5, dtype=torch.float64)
    h = ops.linear_recurrence(a, torch.ones_like(a), impl="torch")
    assert h.dtype == torch.float64
    assert float(h[0, -1, 0]) == pytest.approx(2 - 2 ** -7, abs=1e-15)
    with pytest.raises(TypeError, match="float64"):
        plr.linear_recurrence(a, torch.ones_like(a))
    x = torch.ones((1, 32, 2, 4), dtype=torch.float64)
    dt = torch.full((1, 32, 2), 0.1, dtype=torch.float64)
    y, s = ops.ssd_scan(x, dt, -torch.ones(2, dtype=torch.float64),
                        torch.ones((1, 32, 1, 4), dtype=torch.float64),
                        torch.ones((1, 32, 1, 4), dtype=torch.float64),
                        chunk=32, impl="torch")
    assert y.dtype == s.dtype == torch.float64
    with pytest.raises(TypeError, match="float64"):
        pssd.ssd_chunk_scan(x, dt, -torch.ones(2, dtype=torch.float64),
                            torch.ones((1, 32, 1, 4), dtype=torch.float64),
                            torch.ones((1, 32, 1, 4), dtype=torch.float64))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("n", [4, 16, 100, 128, 132, 256])
def test_ssd_bwd_instance_follows_dtype_and_n(dtype, n):
    """The backward's tensor-core kernels take bfloat16 with N <= 128,
    and only that; every other case keeps the float32-core kernels."""
    want = "mma" if dtype == torch.bfloat16 and n <= 128 else "simt"
    assert pssd.bwd_instance(dtype, n) == want


def _ssd_shapes():
    """(chunk, P, N) of every ssm configuration, full size and smoke."""
    from repro_torch.configs import all_configs
    cfgs = list(all_configs().values())
    cfgs += [get_smoke_config(c.name) for c in cfgs]
    return sorted({(c.ssm_chunk, c.ssm_headdim, c.ssm_state) for c in cfgs
                   if c.family == "ssm"})


def test_ssd_mma_bwd_smem_fits_every_config_and_refuses_beyond():
    """The tensor-core backward's shared memory per block stays within
    SMEM_LIMIT at every configuration's (chunk, P, N), mamba2-370m's
    (128, 64, 128) among them (its chunk kernel stages dS in float32 there:
    181,888 bytes), and at every shape the kernels take; a chunk of 256
    would not fit and is refused."""
    shapes = _ssd_shapes()
    assert (128, 64, 128) in shapes
    for chunk, p, n in shapes:
        assert pssd.mma_bwd_smem_bytes(chunk, p, n) <= pssd.SMEM_LIMIT
        pssd.check_bwd_shape(chunk, p, n, "mma")
    assert pssd.mma_bwd_smem_bytes(128, 64, 128) == 181_888
    for chunk in pssd.CHUNKS:
        for p in (4, 16, 20, 64, 100, 128):
            for n in (4, 16, 36, 64, 128):
                assert (pssd.mma_bwd_smem_bytes(chunk, p, n)
                        <= pssd.SMEM_LIMIT), (chunk, p, n)
    assert pssd.mma_bwd_smem_bytes(256, 128, 128) > pssd.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        pssd.check_bwd_shape(256, 128, 128, "mma")
    with pytest.raises(ValueError, match="N <= 128"):
        pssd.check_bwd_shape(128, 64, 256, "simt")


def test_ssd_f32_bwd_smem_fits_every_config_and_refuses_beyond():
    """The float32-core backward's shared memory per block stays within
    SMEM_LIMIT at every configuration's (chunk, P, N), mamba2-370m's
    (128, 64, 128) among them (its chunk kernel, holding the other side's
    whole chunk, takes 225,792 bytes),
    and at every shape check_bwd_shape takes: P and N multiples of 4 up to
    128, chunk 32, 64 or 128 (the chunk kernel's most, 231,936 bytes, at
    P and N above 64 and chunk 128; the walks take one stage where two do
    not fit).  A chunk of 256 would not fit and is refused, as is N above
    128."""
    for chunk, p, n in _ssd_shapes():
        assert pssd.bwd_smem_bytes(chunk, p, n) <= pssd.SMEM_LIMIT
        pssd.check_bwd_shape(chunk, p, n, "simt")
    assert pssd.bwd_smem_bytes(128, 64, 128) == 225_792
    most = 0
    for chunk in pssd.CHUNKS:
        for p in range(4, 129, 4):
            for n in range(4, 129, 4):
                need = pssd.bwd_smem_bytes(chunk, p, n)
                assert need <= pssd.SMEM_LIMIT, (chunk, p, n)
                most = max(most, need)
                pssd.check_bwd_shape(chunk, p, n, "simt")
    assert most == pssd.bwd_smem_bytes(128, 128, 128) == 231_936
    assert pssd.bwd_smem_bytes(256, 128, 128) > pssd.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        pssd.check_bwd_shape(256, 128, 128, "simt")
    with pytest.raises(ValueError, match="N <= 128"):
        pssd.check_bwd_shape(128, 64, 132, "simt")


@pytest.mark.parametrize("p,n,want", [(16, 16, (32, 32)), (20, 36, (32, 64)),
                                      (64, 128, (64, 128)),
                                      (100, 4, (128, 32)),
                                      (128, 128, (128, 128))])
def test_ssd_f32_bwd_pads_p_and_n_to_its_tiles(p, n, want):
    """The float32 chunk kernel's instance: P and N padded to 32, 64 or
    128; it holds the other side's whole chunk at chunk 64 and 128 (P up to
    the chunk), except at P = N = 128 (where that does not fit), and
    streams 32-row tiles of it otherwise."""
    assert (pssd.padded32(p), pssd.padded32(n)) == want
    for chunk in pssd.CHUNKS:
        whole = (chunk > 32 and want[0] <= chunk and want != (128, 128))
        assert pssd.f32_chunk_rows(chunk, *want) == (chunk if whole else 32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_chunk_scan_bwd_runs_plain_version_on_cpu(dtype):
    """ssd_chunk_scan_bwd on CPU tensors is ssd_bwd_torch, bit for bit,
    in either dtype, and counts no launch of either instance."""
    rng = np.random.default_rng(5)
    x, dy = (_t(rng.standard_normal((1, 64, 4, 16)), dtype) for _ in "xy")
    dt = _t(rng.uniform(0.01, 0.3, (1, 64, 4)))
    A = _t(-rng.uniform(0.5, 2, 4))
    B, C = (_t(rng.standard_normal((1, 64, 2, 16)), dtype) for _ in "BC")
    ds = _t(rng.standard_normal((1, 4, 16, 16)))
    fn = pssd.ssd_chunk_scan_bwd
    before = (fn.launches, fn.mma_launches)
    got = fn(x, dt, A, B, C, dy, ds, chunk=32)
    want = pssd.ssd_bwd_torch(x, dt, A, B, C, dy, ds, chunk=32)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (fn.launches, fn.mma_launches) == before
