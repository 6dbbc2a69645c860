"""The port's RG-LRU hybrid serving path held against the reference.

The linear recurrence's plain PyTorch version is held against the
reference's Pallas kernel in interpret mode and the torch oracle against
the reference's oracle, on numpy inputs from a seed; the
recurrentgemma model (smoke config: one (rec, rec, attn) group and a
trailing rec block, window 32) runs on the reference's weights
(``PRNGKey(0)``, carried across with ``params_from_reference``) against
``repro.models``.  The CUDA kernel is held against the plain version on
the card by ``tests/test_torch_gpu.py``.
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
from repro_torch.kernels import linear_recurrence as plr
from repro_torch.kernels import ops, ref
from repro_torch.serve import greedy_generate

ARCH = "recurrentgemma-9b"
#: The reference kernel test's tolerance (tests/test_kernels.py).
LR_TOL = dict(rtol=1e-3, atol=2e-3)
#: Whole models on shared weights, as in tests/test_torch_serve.py.
F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=8e-2)
#: Decode steps against the forward pass (tests/test_system.py).
DECODE_TOL = dict(rtol=3e-2, atol=3e-2)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _recurrence_inputs(rng, shape):
    return (rng.uniform(0.6, 0.999, shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


# -- the kernel's plain version and the oracle -------------------------------
@pytest.mark.parametrize("b,t,d", [(2, 64, 32), (1, 300, 16), (3, 1024, 8)])
def test_linear_recurrence_plain_matches_pallas_interpret(b, t, d):
    a, x = _recurrence_inputs(np.random.default_rng(t), (b, t, d))
    want = rops.linear_recurrence(jnp.asarray(a), jnp.asarray(x),
                                  impl="interpret")
    ta, tx = torch.as_tensor(a), torch.as_tensor(x)
    before = plr.linear_recurrence.launches
    got = ops.linear_recurrence(ta, tx, impl="torch")
    assert got.dtype == torch.float32 and got.shape == (b, t, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LR_TOL)
    # on CPU tensors the wrapper runs the plain version and counts nothing
    np.testing.assert_array_equal(plr.linear_recurrence(ta, tx).numpy(),
                                  got.numpy())
    assert plr.linear_recurrence.launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linear_recurrence_oracle_matches_reference(dtype):
    a, x = _recurrence_inputs(np.random.default_rng(9), (2, 77, 12))
    h0 = np.random.default_rng(10).standard_normal((2, 12)).astype(
        np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = rref.linear_recurrence_ref(jnp.asarray(a, jd), jnp.asarray(x, jd),
                                      jnp.asarray(h0))
    got = ref.linear_recurrence_ref(torch.as_tensor(a).to(td),
                                    torch.as_tensor(x).to(td),
                                    torch.as_tensor(h0))
    assert got.dtype == td
    np.testing.assert_allclose(_f32(got), _f32(want),
                               atol=1e-5 if dtype == "float32" else 2e-2)
    plain = ops.linear_recurrence(torch.as_tensor(a).to(td),
                                  torch.as_tensor(x).to(td), impl="torch")
    oracle = ref.linear_recurrence_ref(torch.as_tensor(a).to(td),
                                       torch.as_tensor(x).to(td))
    np.testing.assert_allclose(_f32(plain), _f32(oracle),
                               **(LR_TOL if dtype == "float32"
                                  else dict(rtol=1e-2, atol=2e-2)))


def test_linear_recurrence_ops_check_inputs():
    a = torch.rand(1, 8, 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.linear_recurrence(a, a, impl="cuda")
    with pytest.raises(TypeError):
        ops.linear_recurrence(a.double(), a.double())
    with pytest.raises(TypeError):
        ops.linear_recurrence(a, a.bfloat16())
    with pytest.raises(ValueError, match="one shape"):
        ops.linear_recurrence(a, a[:, :4])


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
], ids=["f32", "f32-interpret"])
def test_recurrentgemma_matches_reference(over):
    """Forward, prefill, three decode steps and greedy tokens on a prompt
    of 40 tokens, longer than the window of 32."""
    rcfg, rp, cfg, params = _pair(**over)
    assert isinstance(params, M.RecurrentGemma) and len(params.tail) == 1
    tol = F32
    tokens = np.random.default_rng(0).integers(1, cfg.vocab_size, (2, 40))
    assert tokens.shape[1] > cfg.window
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
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_recurrentgemma_bf16_blocks_match_reference():
    """bfloat16, block by block, each block given the reference's own
    input.  The random smoke model has no q/k-norm and its attention
    logits reach about +-140, so the softmax is one-hot: a single bfloat16
    rounding flip upstream (2^-8 relative, which the two frameworks place
    differently) changes which key wins, and the whole bfloat16 chain is
    not comparable at a tolerance.  The float32 cases above hold the chain
    whole; here every prefill and decode block, the final norm and the
    soft-capped head are held at the bfloat16 tolerance."""
    from repro.models import common as RC
    from repro.models import rglru as RR
    from repro_torch.models import common as PC
    from repro_torch.models import rglru as PR

    rcfg, rp, cfg, params = _pair()
    assert cfg.dtype == "bfloat16"
    rng = np.random.default_rng(4)

    def port(x):
        return torch.as_tensor(np.array(x, np.float32)).to(
            getattr(torch, str(x.dtype)))

    tokens = rng.integers(1, cfg.vocab_size, (2, 40))
    rx = RC.embed_tokens(rcfg, rp["embed"], jnp.asarray(tokens),
                         jnp.bfloat16)
    tx = PC.embed_tokens(cfg, params.embed, torch.as_tensor(tokens),
                         torch.bfloat16)
    np.testing.assert_array_equal(_f32(tx), _f32(rx))
    rpos = jnp.broadcast_to(jnp.arange(40, dtype=jnp.int32), (2, 40))
    tpos = torch.arange(40, dtype=torch.int32).expand(2, 40)
    group = jax.tree.map(lambda a: a[0], rp["groups"])
    blocks = [(kind, group[f"b{i}_{kind}"], params.groups[0][f"b{i}_{kind}"])
              for i, kind in enumerate(cfg.block_pattern)]
    blocks.append(("rec", rp["tail0"], params.tail[0]))
    for kind, rb, pb in blocks:
        if kind == "rec":
            want = RR.rec_block(rcfg, rb, rx)
            got = PR.rec_block(cfg, pb, port(rx))
        else:
            want = RR.attn_block(rcfg, rb, rx, rpos)
            got = PR.attn_block(cfg, pb, port(rx), tpos)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(_f32(got), _f32(want), **BF16)
        rx = want
    rx = RC.rmsnorm(rcfg, rp["embed"]["final_norm"], rx)
    want = RC.lm_logits(rcfg, rp["embed"], rx)
    got = PC.lm_logits(cfg, params.embed, port(rx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BF16)

    # decode forms: a rec block from a random state, windowed attention
    # against a random rolling cache
    x1 = jnp.asarray(rng.standard_normal((2, 1, 64)), jnp.bfloat16)
    h0 = jnp.asarray(rng.standard_normal((2, 64)), jnp.float32)
    c0 = jnp.asarray(rng.standard_normal((2, 3, 64)), jnp.bfloat16)
    want = RR._rec_block_decode(rcfg, group["b0_rec"], x1, h0, c0)
    got = PR._rec_block_decode(cfg, params.groups[0]["b0_rec"], port(x1),
                               port(h0), port(c0))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_f32(g), _f32(w), **BF16)
    ck, cv = (jnp.asarray(rng.standard_normal((2, 1, 32, 16)), jnp.bfloat16)
              for _ in range(2))
    ratt = group["b2_attn"]["attn"]
    watt, wk, wv = RC.attention_decode(rcfg, ratt, x1, ck, cv, 45,
                                       window=cfg.window)
    gatt, gk, gv = PC.attention_decode(cfg, params.groups[0]["b2_attn"][
        "attn"], port(x1), port(ck), port(cv), 45, window=cfg.window)
    for g, w in ((gatt, watt), (gk, wk), (gv, wv)):
        np.testing.assert_allclose(_f32(g), _f32(w), **BF16)


@pytest.mark.parametrize("s", [12, 40])
def test_recurrentgemma_decode_matches_forward(s):
    """Stepping the prompt one token at a time from a zero cache gives the
    forward pass's logits; at 40 tokens the rolling window of 32 slots
    wraps."""
    cfg = get_smoke_config(ARCH, dtype="float32")
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    toks = torch.as_tensor(np.random.default_rng(s).integers(
        0, cfg.vocab_size, (1, s)))
    full, _ = M.forward(cfg, params, toks)
    cache = M.init_cache(cfg, 1, s, device="cpu")
    for pos in range(s):
        logits, cache = M.decode_step(cfg, params, cache, toks[:, pos], pos)
        np.testing.assert_allclose(logits.numpy(), full[:, pos].numpy(),
                                   **DECODE_TOL)


def test_recurrentgemma_params_round_trip_every_leaf():
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
    bad = dict(tree, tail0=dict(tree["tail0"], lam=np.zeros((3,))))
    with pytest.raises(ValueError, match="tail0/lam"):
        M.params_from_reference(get_smoke_config(ARCH), bad, device="cpu")
