"""The port's Mamba2 serving path held against the reference.

The SSD scan's plain PyTorch version is held against the reference's
Pallas kernel in interpret mode and the torch oracle against the
reference's oracle, on numpy inputs from a seed; the mamba2 model (smoke
config) runs on the reference's weights (``PRNGKey(0)``, carried across
with ``params_from_reference``) against ``repro.models``.  The CUDA
kernel is held against the plain version on the card by
``tests/test_torch_gpu.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import models as RM
from repro.configs import get_smoke_config as r_smoke
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.serve import greedy_generate as r_generate

from repro_torch import models as M
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_chunk_scan as pssd
from repro_torch.serve import greedy_generate

ARCH = "mamba2-370m"
#: The reference kernel test's tolerance (tests/test_kernels.py) for y and
#: the state; bfloat16 y may also differ by one rounding step (2^-7).
SSD_TOL = {"float32": dict(rtol=0.0, atol=1e-3),
           "bfloat16": dict(rtol=1e-2, atol=2e-2)}
#: Whole models on shared weights, as in tests/test_torch_serve.py: float32
#: differs by summation order only; bfloat16 rounds at other places.
F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=8e-2)
#: Decode steps against the forward pass (tests/test_system.py).
DECODE_TOL = dict(rtol=3e-2, atol=3e-2)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _ssd_inputs(rng, b, t, h, p, g, n):
    """The reference kernel test's input distributions, as numpy."""
    return (rng.standard_normal((b, t, h, p)).astype(np.float32) * 0.5,
            rng.uniform(0.001, 0.1, (b, t, h)).astype(np.float32),
            -rng.uniform(0.5, 2.0, h).astype(np.float32),
            rng.standard_normal((b, t, g, n)).astype(np.float32) * 0.3,
            rng.standard_normal((b, t, g, n)).astype(np.float32) * 0.3)


def _both(arrays, dtype):
    """x, B, C in ``dtype``; dt and A in float32, for jax and torch."""
    kinds = (dtype, "float32", "float32", dtype, dtype)
    return ([jnp.asarray(a, getattr(jnp, k)) for a, k in zip(arrays, kinds)],
            [torch.as_tensor(a).to(getattr(torch, k))
             for a, k in zip(arrays, kinds)])


# -- the kernel's plain version and the oracle -------------------------------
@pytest.mark.parametrize("b,t,h,p,g,n,chunk", [
    (1, 128, 4, 32, 2, 64, 64),
    (2, 256, 2, 16, 1, 32, 128),
    (1, 64, 2, 64, 2, 128, 32),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_plain_matches_pallas_interpret(b, t, h, p, g, n, chunk, dtype):
    rargs, args = _both(_ssd_inputs(np.random.default_rng(t + p), b, t, h,
                                    p, g, n), dtype)
    yr, sr = rops.ssd_scan(*rargs, chunk=chunk, impl="interpret")
    before = pssd.ssd_chunk_scan.launches
    y, s = ops.ssd_scan(*args, chunk=chunk, impl="torch")
    assert y.dtype == args[0].dtype and y.shape == args[0].shape
    assert s.dtype == torch.float32 and s.shape == (b, h, p, n)
    np.testing.assert_allclose(_f32(y), _f32(yr), **SSD_TOL[dtype])
    np.testing.assert_allclose(s.numpy(), np.asarray(sr),
                               **SSD_TOL["float32"])
    # on CPU tensors the wrapper runs the plain version and counts nothing
    y2, s2 = pssd.ssd_chunk_scan(*args, chunk=chunk)
    np.testing.assert_array_equal(_f32(y2), _f32(y))
    np.testing.assert_array_equal(s2.numpy(), s.numpy())
    assert pssd.ssd_chunk_scan.launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_plain_matches_pallas_interpret_under_strong_decay(dtype):
    """dt up to 1 and A down to -16: cum falls below -1,000 inside a
    128-step chunk, where exp(-cum) overflows float32 (the inputs of the
    card test ``test_ssd_kernel_strong_decay_on_card``, at a smaller
    width).  The plain version agrees with the Pallas kernel and y stays
    finite."""
    rng = np.random.default_rng(16)
    b, t, h, p, g, n = 1, 256, 4, 16, 1, 32
    arrays = (rng.standard_normal((b, t, h, p)).astype(np.float32) * 0.5,
              rng.uniform(0.001, 1.0, (b, t, h)).astype(np.float32),
              -np.linspace(0.5, 16.0, h).astype(np.float32),
              rng.standard_normal((b, t, g, n)).astype(np.float32) * 0.3,
              rng.standard_normal((b, t, g, n)).astype(np.float32) * 0.3)
    cum = np.cumsum((arrays[1] * arrays[2]).reshape(b, 2, 128, h), axis=2)
    assert cum.min() < -1000.0
    rargs, args = _both(arrays, dtype)
    yr, sr = rops.ssd_scan(*rargs, chunk=128, impl="interpret")
    y, s = ops.ssd_scan(*args, chunk=128, impl="torch")
    assert bool(torch.isfinite(y.float()).all())
    assert bool(torch.isfinite(s).all())
    np.testing.assert_allclose(_f32(y), _f32(yr), **SSD_TOL[dtype])
    np.testing.assert_allclose(s.numpy(), np.asarray(sr),
                               **SSD_TOL["float32"])


@pytest.mark.parametrize("t,g", [(40, 1), (70, 2)])
def test_ssd_oracle_and_ragged_plain_match_reference_oracle(t, g):
    """The torch oracle against ``repro.kernels.ref.ssd_ref``, and the
    plain version on a T that is no chunk multiple (zero-step padding)."""
    rargs, args = _both(_ssd_inputs(np.random.default_rng(t), 2, t, 4, 16,
                                    g, 16), "float32")
    yr, sr = rref.ssd_ref(*rargs)
    y, s = ref.ssd_ref(*args)
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(sr), atol=1e-5)
    yp, sp = ops.ssd_scan(*args, chunk=32, impl="torch")
    np.testing.assert_allclose(yp.numpy(), np.asarray(yr), atol=1e-3)
    np.testing.assert_allclose(sp.numpy(), np.asarray(sr), atol=1e-3)


def test_ssd_ops_check_inputs():
    _, (x, dt, A, B, C) = _both(_ssd_inputs(np.random.default_rng(1), 1, 64,
                                            2, 16, 1, 16), "float32")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.ssd_scan(x, dt, A, B, C, chunk=32, impl="cuda")
    with pytest.raises(TypeError, match="float32"):
        ops.ssd_scan(x, dt.double(), A, B, C, chunk=32)
    with pytest.raises(TypeError):
        ops.ssd_scan(x.double(), dt, A, B.double(), C.double(), chunk=32)
    with pytest.raises(ValueError, match="do not fit"):
        ops.ssd_scan(x, dt[:, :, :1], A, B, C, chunk=32)
    with pytest.raises(ValueError, match="chunk"):
        pssd._launch(x, dt, A, B, C, 48)
    assert pssd.smem_bytes(128, 64, 128) <= pssd.SMEM_LIMIT


def test_ssd_instance_is_chosen_by_dtype_and_shape():
    """bfloat16 with N <= 128 takes the tensor-core kernel, in two
    shared-memory stages where they fit (mamba2-370m's P = 64, N = 128)
    and one otherwise; every such shape fits one.  On CPU tensors the
    wrapper counts no launch of either instance."""
    assert pssd.instance(torch.bfloat16, 128) == "mma"
    assert pssd.instance(torch.bfloat16, 132) == "simt"
    assert pssd.instance(torch.float32, 64) == "simt"
    assert pssd.mma_stages(128, 64, 128) == 2
    assert pssd.mma_stages(128, 128, 128) == 1
    assert pssd.mma_stages(32, 128, 128) == 2
    for chunk in pssd.CHUNKS:
        for p in range(4, 129, 4):
            for n in range(4, 129, 4):
                assert (pssd.mma_smem_bytes(chunk, p, n, 1)
                        <= pssd.SMEM_LIMIT), (chunk, p, n)
    _, args = _both(_ssd_inputs(np.random.default_rng(2), 1, 64, 2, 16, 1,
                                16), "bfloat16")
    before = (pssd.ssd_chunk_scan.launches, pssd.ssd_chunk_scan.mma_launches)
    pssd.ssd_chunk_scan(*args, chunk=32)
    assert (pssd.ssd_chunk_scan.launches,
            pssd.ssd_chunk_scan.mma_launches) == before


# -- the model on shared weights ---------------------------------------------
def _pair(**over):
    rcfg = r_smoke(ARCH, **over)
    cfg = get_smoke_config(ARCH, **{k: v for k, v in over.items()
                                    if k != "kernel_impl"})
    rp = RM.init_params(rcfg, jax.random.PRNGKey(0))
    params = M.params_from_reference(cfg, jax.tree.map(np.asarray, rp),
                                     device="cpu")
    return rcfg, rp, cfg, params


@pytest.mark.parametrize("over", [
    dict(dtype="float32"),
    dict(dtype="float32", kernel_impl="interpret"),
    dict(),
], ids=["f32", "f32-interpret", "bf16"])
def test_mamba2_matches_reference(over):
    """Forward, prefill, three decode steps and greedy tokens on a prompt
    of 40 tokens (chunk 32: the padded path)."""
    rcfg, rp, cfg, params = _pair(**over)
    assert isinstance(params, M.Mamba2)
    tol = F32 if cfg.dtype == "float32" else BF16
    tokens = np.random.default_rng(0).integers(1, cfg.vocab_size, (2, 40))
    assert tokens.shape[1] % cfg.ssm_chunk
    rt, tt = jnp.asarray(tokens, jnp.int32), torch.as_tensor(tokens)

    want, _ = RM.forward(rcfg, rp, rt)
    got, aux = M.forward(cfg, params, tt)
    assert got.dtype == torch.float32 and got.shape == (2, 40, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)

    rlog, rcache = RM.prefill(rcfg, rp, rt, 64)
    log, cache = M.prefill(cfg, params, tt, 64)
    np.testing.assert_allclose(log.numpy(), np.asarray(rlog), **tol)
    assert set(cache) == set(rcache)
    for key in cache:
        assert cache[key].shape == rcache[key].shape
        assert str(cache[key].dtype).split(".")[-1] == rcache[key].dtype.name
        assert not cache[key].any()          # the reference's zeroed state

    step = jnp.asarray(np.asarray(rlog)[:, -1].argmax(-1), jnp.int32)
    for i in range(3):
        rlog, rcache = RM.decode_step(rcfg, rp, rcache, step,
                                      jnp.int32(40 + i))
        log, cache = M.decode_step(cfg, params, cache,
                                   torch.as_tensor(np.array(step)), 40 + i)
        np.testing.assert_allclose(log.numpy(), np.asarray(rlog), **tol)
        for key in cache:
            np.testing.assert_allclose(_f32(cache[key]), _f32(rcache[key]),
                                       **tol)
        step = jnp.asarray(np.asarray(rlog).argmax(-1), jnp.int32)

    want = r_generate(rcfg, rp, rt, steps=4, max_seq=64)
    got = greedy_generate(cfg, params, tt, steps=4, max_seq=64)
    assert got.shape == (2, 4)
    if cfg.dtype == "float32":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_mamba2_decode_matches_forward():
    """The port's counterpart of tests/test_system.py's
    ``test_mamba_decode_matches_forward``: stepping the prompt one token at
    a time from a zero cache gives the forward pass's logits."""
    cfg = get_smoke_config(ARCH, dtype="float32")
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, 8)))
    full, _ = M.forward(cfg, params, toks)
    cache = M.init_cache(cfg, 1, 8, device="cpu")
    for pos in range(8):
        logits, cache = M.decode_step(cfg, params, cache, toks[:, pos], pos)
        np.testing.assert_allclose(logits.numpy(), full[:, pos].numpy(),
                                   **DECODE_TOL)


def test_mamba2_params_round_trip_every_leaf():
    rcfg = r_smoke(ARCH)
    tree = jax.tree.map(np.asarray, RM.init_params(rcfg,
                                                   jax.random.PRNGKey(0)))
    params = M.params_from_reference(get_smoke_config(ARCH), tree,
                                     device="cpu")
    back = M.params_to_reference(params)
    flat_want = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_got) == len(flat_want)
    for path, want in flat_want:
        got = flat_got[path]
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    # each layer's parameters are views of one stacked tensor per leaf
    assert params.layers[1]["in_proj"].shape == tree["layers"][
        "in_proj"].shape[1:]
    bad = dict(tree, layers=dict(tree["layers"], a_log=np.zeros((3,))))
    with pytest.raises(ValueError, match="a_log"):
        M.params_from_reference(get_smoke_config(ARCH), bad, device="cpu")
