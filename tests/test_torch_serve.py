"""The port's dense-transformer serving path held against the reference.

Inputs come from ``numpy.random.default_rng``; the reference runs its
Pallas kernels in interpret mode (or its plain oracles, as its smoke
configs pin ``kernel_impl="xla"``) and the port its kernels' plain
PyTorch versions, on the same numpy inputs and, for the models, on the
same weights (initialised by the reference from ``PRNGKey(0)`` and
carried across with ``params_from_reference``).  The CUDA kernels are
held against these plain versions on the card by
``tests/test_torch_gpu.py``.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import models as RM
from repro.configs import ARCH_IDS as R_ARCH_IDS
from repro.configs import get_config as r_config
from repro.configs import get_smoke_config as r_smoke
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.serve import greedy_generate as r_generate

from repro_torch import models as M
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import flash_attention as pfa
from repro_torch.kernels import rmsnorm as prms
from repro_torch.launch import serve as pserve
from repro_torch.serve import greedy_generate

#: The reference kernel tests' tolerances (tests/test_kernels.py).
ATTN_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
RMS_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
#: Whole models on shared weights.  float32: the two frameworks differ by
#: summation order only (max 2.3e-5 seen on the smoke configs).  bfloat16:
#: both round every activation to 8 mantissa bits, at places that differ
#: (einsum outputs, silu), so one rounding step is 2^-8 of the value:
#: logits near 4 differ by up to 0.07, cached keys near 16 by 0.125.
F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=8e-2)

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")


def _np(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _both(a, dtype):
    """The same numpy array as a jax and a torch array of ``dtype``."""
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.as_tensor(a).to(getattr(torch, dtype)))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# -- kernels -----------------------------------------------------------------
@pytest.mark.parametrize("b,hq,hkv,tq,tk,d", [
    (1, 4, 4, 128, 128, 64),
    (2, 8, 2, 100, 100, 64),
    (1, 4, 1, 64, 256, 128),
    (1, 2, 2, 1, 128, 64),        # decode-like single query
    (2, 4, 2, 37, 37, 32),        # ragged, non-multiple-of-block
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_plain_matches_pallas_interpret(b, hq, hkv, tq, tk, d,
                                                  dtype):
    rng = np.random.default_rng(tq * 1000 + tk)
    (rq, q), (rk, k), (rv, v) = (_both(_np(rng, s), dtype) for s in
                                 ((b, hq, tq, d), (b, hkv, tk, d),
                                  (b, hkv, tk, d)))
    want = rops.attention(rq, rk, rv, impl="interpret")
    before = pfa.flash_attention.launches
    got = ops.attention(q, k, v, impl="torch")
    np.testing.assert_allclose(_f32(got), _f32(want), atol=ATTN_TOL[dtype])
    assert got.dtype == q.dtype and got.shape == q.shape
    # on CPU tensors the wrapper runs the plain version and counts nothing
    np.testing.assert_array_equal(_f32(pfa.flash_attention(q, k, v)),
                                  _f32(got))
    assert pfa.flash_attention.launches == before


@pytest.mark.parametrize("window", [16, 64])
def test_attention_window_matches_pallas_interpret(window):
    rng = np.random.default_rng(window)
    (rq, q), (rk, k), (rv, v) = (_both(_np(rng, s), "float32") for s in
                                 ((1, 4, 128, 64), (1, 2, 128, 64),
                                  (1, 2, 128, 64)))
    want = rops.attention(rq, rk, rv, window=window, impl="interpret")
    got = ops.attention(q, k, v, window=window, impl="torch")
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-4)


def test_attention_plain_empty_rows_are_zero():
    """More queries than keys under a causal mask: the first rows see no
    key and are 0 (the kernel's ``l == 0`` rule); the others match the
    dense oracle."""
    rng = np.random.default_rng(5)
    q = torch.as_tensor(_np(rng, (1, 2, 24, 16)))
    k = torch.as_tensor(_np(rng, (1, 2, 16, 16)))
    v = torch.as_tensor(_np(rng, (1, 2, 16, 16)))
    got = ops.attention(q, k, v, impl="torch")
    assert torch.count_nonzero(got[:, :, :8]) == 0
    want = ref.attention_ref(q[:, :, 8:], k, v)
    np.testing.assert_allclose(got[:, :, 8:].numpy(), want.numpy(),
                               atol=1e-5)


@pytest.mark.parametrize("shape", [(4, 17, 256), (2, 128), (1, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_matches_pallas_interpret(shape, dtype):
    rng = np.random.default_rng(shape[-1])
    rx, x = _both(_np(rng, shape), dtype)
    rw, w = _both(_np(rng, (shape[-1],)), "float32")
    want = rops.rmsnorm(rx, rw, impl="interpret")
    before = prms.rmsnorm.launches
    got = ops.rmsnorm(x, w, impl="torch")
    np.testing.assert_allclose(_f32(got), _f32(want), atol=RMS_TOL[dtype])
    assert got.dtype == x.dtype
    np.testing.assert_array_equal(_f32(prms.rmsnorm(x, w)), _f32(got))
    assert prms.rmsnorm.launches == before


@pytest.mark.parametrize("oracle", ["attention_ref", "attention_kv_length",
                                    "attention_xla_chunked", "rmsnorm_ref"])
def test_oracles_match_reference(oracle):
    rng = np.random.default_rng(7)
    if oracle == "rmsnorm_ref":
        (rx, x), (rw, w) = _both(_np(rng, (3, 40)), "float32"), \
            _both(_np(rng, (40,)), "float32")
        np.testing.assert_allclose(ref.rmsnorm_ref(x, w).numpy(),
                                   np.asarray(rref.rmsnorm_ref(rx, rw)),
                                   atol=1e-5)
        return
    (rq, q), (rk, k), (rv, v) = (_both(_np(rng, s), "float32") for s in
                                 ((2, 4, 50, 32), (2, 2, 70, 32),
                                  (2, 2, 70, 32)))
    if oracle == "attention_ref":
        got = ref.attention_ref(q, k, v, window=24)
        want = rref.attention_ref(rq, rk, rv, window=24)
    elif oracle == "attention_kv_length":
        lens = np.array([40, 70])
        got = ops.attention(q, k, v, kv_length=torch.as_tensor(lens))
        want = rops.attention(rq, rk, rv, kv_length=jnp.asarray(lens))
    else:
        got = ref.attention_xla_chunked(q, k, v, q_chunk=16)
        want = rref.attention_xla_chunked(rq, rk, rv, q_chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_kernel_ops_refuse_cuda_impl_on_cpu_tensors():
    q = torch.zeros(1, 2, 4, 16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.attention(q, q, q, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.rmsnorm(q, torch.zeros(16), impl="cuda")
    with pytest.raises(ValueError, match="head dim 48"):
        pfa._launch(torch.zeros(1, 2, 4, 48), torch.zeros(1, 2, 4, 48),
                    torch.zeros(1, 2, 4, 48), True, None, 1.0)
    with pytest.raises(ValueError, match="window"):
        ops.attention(q, q, q, window=0)
    with pytest.raises(TypeError):
        ops.rmsnorm(q.double(), torch.zeros(16))


def test_kernel_build_failure_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "false")
    monkeypatch.setattr(_build, "_LIBS", {})
    for name in ("rmsnorm", "flash_attention", "linear_recurrence",
                 "ssd_chunk_scan"):
        with pytest.raises(RuntimeError, match="build failed"):
            _build.load(name)


# -- configs and weights -----------------------------------------------------
@pytest.mark.parametrize("arch", R_ARCH_IDS)
def test_configs_and_param_counts_match_reference(arch):
    assert ARCH_IDS == R_ARCH_IDS
    for mine, theirs in ((get_config(arch), r_config(arch)),
                         (get_smoke_config(arch), r_smoke(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        assert M.count_params(mine) == RM.count_params(theirs)
        assert M.count_active_params(mine) == RM.count_active_params(theirs)
        assert M.model_flops(mine, 4096, "train") == \
            RM.model_flops(theirs, 4096, "train")


def test_qwen3_4b_size():
    assert M.count_params(get_config("qwen3-4b")) == 4_411_424_256


def test_params_from_reference_keeps_every_leaf():
    rcfg = r_smoke("qwen3-4b")
    tree = jax.tree.map(np.asarray,
                        RM.init_params(rcfg, jax.random.PRNGKey(0)))
    params = M.params_from_reference(get_smoke_config("qwen3-4b"), tree,
                                     device="cpu")
    back = M.params_to_reference(params)
    flat_want = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_got) == len(flat_want)
    for path, want in flat_want:
        got = flat_got[path]
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    bad = dict(tree, embed=dict(tree["embed"], lm_head=np.zeros((3, 3))))
    with pytest.raises(ValueError, match="lm_head"):
        M.params_from_reference(get_smoke_config("qwen3-4b"), bad,
                                device="cpu")


def test_init_follows_reference_rule():
    """Same leaves, shapes, dtypes and init scales as the reference's
    random init (values differ: torch and jax draw different numbers)."""
    cfg = get_smoke_config("qwen3-4b", d_model=128, d_ff=256)
    mine = M.params_to_reference(M.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"))
    theirs = jax.tree.map(np.asarray, RM.init_params(
        r_smoke("qwen3-4b", d_model=128, d_ff=256), jax.random.PRNGKey(0)))
    flat_mine = dict(jax.tree_util.tree_flatten_with_path(mine)[0])
    for path, want in jax.tree_util.tree_flatten_with_path(theirs)[0]:
        got = flat_mine[path]
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got.std(), want.std(), rtol=0.1,
                                   atol=1e-7)
        np.testing.assert_allclose(got.mean(), want.mean(), atol=0.02)


def test_unported_families_and_features_raise():
    """An unknown family raises.  Ring attention is ported: with no
    sharding context the flag falls through to the kernel path, as the
    reference's full_attention does, and the forward equals the flag-off
    one (it raised NotImplementedError before)."""
    cfg = get_smoke_config("qwen3-4b")
    params = M.init_params(cfg, device="cpu")
    toks = torch.ones(1, 4, dtype=torch.long)
    ring = get_smoke_config("qwen3-4b", ring_attention=True)
    assert torch.equal(M.forward(ring, params, toks)[0],
                       M.forward(cfg, params, toks)[0])
    with pytest.raises(ValueError, match="unknown family"):
        M.forward(get_smoke_config("qwen3-4b", family="nope"), params, toks)


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("qwen3-4b")
    for call in (lambda: M.init_params(cfg),
                 lambda: M.init_cache(cfg, 1, 8),
                 lambda: M.params_from_reference(cfg, {}),
                 lambda: pserve.main(["--smoke", "--requests", "1"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


# -- models on shared weights ------------------------------------------------
def _pair(arch, **over):
    rcfg = r_smoke(arch, **over)
    cfg = get_smoke_config(arch, **{k: v for k, v in over.items()
                                    if k != "kernel_impl"})
    rp = RM.init_params(rcfg, jax.random.PRNGKey(0))
    params = M.params_from_reference(cfg, jax.tree.map(np.asarray, rp),
                                     device="cpu")
    return rcfg, rp, cfg, params


@pytest.mark.parametrize("arch,over", [
    ("qwen3-4b", dict(dtype="float32")),
    ("qwen3-4b", dict(dtype="float32", kernel_impl="interpret")),
    ("qwen3-4b", dict(dtype="float32", window=6)),
    ("tinyllama-1.1b", dict(dtype="float32")),
    ("qwen3-4b", dict()),
    ("tinyllama-1.1b", dict()),
], ids=["qwen3-f32", "qwen3-f32-interpret", "qwen3-f32-window",
        "tinyllama-f32", "qwen3-bf16", "tinyllama-bf16"])
def test_model_matches_reference(arch, over):
    rcfg, rp, cfg, params = _pair(arch, **over)
    tol = F32 if cfg.dtype == "float32" else BF16
    tokens = np.random.default_rng(0).integers(1, cfg.vocab_size, (2, 12))
    rt, tt = jnp.asarray(tokens, jnp.int32), torch.as_tensor(tokens)
    max_seq = 16

    want, _ = RM.forward(rcfg, rp, rt)
    got, aux = M.forward(cfg, params, tt)
    assert got.dtype == torch.float32 and got.shape == (2, 12, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)

    rlog, rcache = RM.prefill(rcfg, rp, rt, max_seq)
    log, cache = M.prefill(cfg, params, tt, max_seq)
    np.testing.assert_allclose(log.numpy(), np.asarray(rlog), **tol)
    for key in ("k", "v"):
        assert cache[key].shape == rcache[key].shape
        np.testing.assert_allclose(_f32(cache[key]), _f32(rcache[key]), **tol)

    step = jnp.asarray(np.asarray(rlog)[:, -1].argmax(-1), jnp.int32)
    for i in range(3):
        pos = tokens.shape[1] + i
        rlog, rcache = RM.decode_step(rcfg, rp, rcache, step, jnp.int32(pos))
        log, cache = M.decode_step(cfg, params, cache,
                                   torch.as_tensor(np.array(step)), pos)
        np.testing.assert_allclose(log.numpy(), np.asarray(rlog), **tol)
        for key in ("k", "v"):
            np.testing.assert_allclose(_f32(cache[key]), _f32(rcache[key]),
                                       **tol)
        step = jnp.asarray(np.asarray(rlog).argmax(-1), jnp.int32)

    want = r_generate(rcfg, rp, rt, steps=4, max_seq=max_seq)
    got = greedy_generate(cfg, params, tt, steps=4, max_seq=max_seq)
    assert got.shape == (2, 4)
    if cfg.dtype == "float32":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the serving driver ------------------------------------------------------
def test_serve_driver_runs_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--device", "cpu", "--requests", "4", "--batch", "2",
         "--max-new", "4"],
        env=dict(os.environ, PYTHONPATH=SRC), capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "[serve] 4/4 requests" in out.stdout


@pytest.mark.parametrize("arch", ["qwen3-4b", "mamba2-370m",
                                  "recurrentgemma-9b", "internvl2-26b"])
def test_serve_driver_matches_reference_driver(monkeypatch, capsys, arch):
    """The same request stream, admission and decode steps as the
    reference driver on the smoke config, on the reference driver's
    weights (its init from ``PRNGKey(seed)``, carried across), so that an
    end-of-sequence token ends a request at the same step in both."""
    from repro.launch import serve as rserve
    argv = ["--arch", arch, "--smoke", "--requests", "5", "--batch", "2",
            "--max-new", "3"]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    rserve.main()
    want = capsys.readouterr().out
    tree = jax.tree.map(np.asarray, RM.init_params(r_smoke(arch),
                                                   jax.random.PRNGKey(0)))
    monkeypatch.setattr(pserve.M, "init_params", lambda cfg, gen, device:
                        M.params_from_reference(cfg, tree, device=device))
    stats = pserve.main(argv + ["--device", "cpu"])
    assert stats["done"] == 5
    assert f"5/5 requests, {stats['steps']} decode steps" in want, want
