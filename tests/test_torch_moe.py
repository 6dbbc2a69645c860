"""The port's MoE serving path held against the reference.

``repro_torch.models.moe`` (``moe_ffn``, ``moe_block``, ``_capacity``,
``moe_spec``) and the MoE transformer against ``repro.models.moe`` on
the two MoE smoke configs: qwen2-moe-a2.7b (a shared expert) and
arctic-480b (a dense MLP in parallel).  Weights come from the
reference's ``PRNGKey(0)`` init, carried across with
``params_from_reference``; inputs from ``numpy.random.default_rng``.
The smoke configs pin the reference's plain ops (``kernel_impl="xla"``)
and the port runs its kernels' plain versions on the CPU.  Routing is
discrete, so it is held exactly: each token's experts, each entry's
slot and the drop mask.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import models as RM
from repro.configs import get_config as r_config
from repro.configs import get_smoke_config as r_smoke
from repro.models import common as rcm
from repro.models import moe as rmoe
from repro.models import transformer as RT
from repro.serve import greedy_generate as r_generate

from repro_torch import models as M
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import serve as pserve
from repro_torch.models import moe as pmoe
from repro_torch.serve import greedy_generate

#: As tests/test_torch_serve.py: float32 differs by summation order only,
#: bfloat16 by one rounding step (2^-8 relative) at places that differ.
F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=8e-2)
#: The aux loss: a float32 mean of the probabilities, summed in another
#: order by the two frameworks.
AUX = dict(rtol=1e-6, atol=1e-7)
#: The aux loss of a bfloat16 layer given the same input: the router's
#: input comes out of each framework's own norm and attention, which round
#: to bfloat16 at different places (one step is 2^-8 relative); the mean
#: over tokens averages that down.
AUX_BF16 = dict(rtol=1e-3, atol=1e-6)

ARCHS = ("qwen2-moe-a2.7b", "arctic-480b")
SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")

#: Variants of the smoke config: as published; the capacity factor
#: lowered until tokens drop; qwen2-moe's preset expert padding; a zero
#: router, so that every token's probabilities tie.
VARIANTS = {
    "base": dict(),
    "drops": dict(moe_capacity_factor=0.5),
    "pad4": dict(moe_expert_pad=4),
    "ties": dict(),
}


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _pair(arch, **over):
    """The reference's smoke model from PRNGKey(0) and the port's on the
    same weights."""
    rcfg = r_smoke(arch, **over)
    cfg = get_smoke_config(arch, **over)
    rp = RM.init_params(rcfg, jax.random.PRNGKey(0))
    params = M.params_from_reference(cfg, jax.tree.map(np.asarray, rp),
                                     device="cpu")
    return rcfg, rp, cfg, params


def _ref_routing(cfg, p, x):
    """The reference ``moe_ffn``'s routing (its lines, in jnp): each
    token's experts, and each sorted entry's slot and drop mask."""
    T = x.shape[0] * x.shape[1]
    k, E = cfg.moe_top_k, cfg.moe_num_experts
    xf = x.reshape(T, -1)
    logits = jnp.einsum("td,de->te", xf.astype(jnp.float32),
                        p["router"].astype(jnp.float32))
    _, expert_idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    flat_e = expert_idx.reshape(-1)
    order = jnp.argsort(flat_e)
    e_s = flat_e[order]
    counts = jnp.bincount(flat_e, length=E)
    starts = jnp.cumsum(counts) - counts
    rank = jnp.arange(T * k, dtype=jnp.int32) - starts[e_s]
    cap = rmoe._capacity(cfg, T)
    valid = rank < cap
    slot = jnp.where(valid, e_s * cap + rank,
                     (E + cfg.moe_expert_pad) * cap)
    return (np.asarray(expert_idx), np.asarray(order), np.asarray(slot),
            np.asarray(valid), cap)


def _layer0(arch, variant, dtype):
    """Layer 0's FFN parameters in both frameworks and an input x."""
    over = dict(VARIANTS[variant], dtype=dtype)
    rcfg, rp, cfg, params = _pair(arch, **over)
    rlayer = jax.tree.map(lambda a: a[0], rp["layers"])
    layer = params.layers[0]
    if variant == "ties":
        rlayer["moe"]["router"] = jnp.zeros_like(rlayer["moe"]["router"])
        with torch.no_grad():
            layer.moe.router.zero_()
    seq = 32 if variant == "drops" else 12
    x = np.random.default_rng(3).standard_normal(
        (2, seq, cfg.d_model)).astype(np.float32)
    return (rcfg, rlayer, jnp.asarray(x, getattr(jnp, dtype)),
            cfg, layer, torch.as_tensor(x).to(getattr(torch, dtype)))


# -- capacity and layout -----------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_and_spec_match_reference(arch):
    for mine, theirs in ((get_config(arch), r_config(arch)),
                         (get_smoke_config(arch), r_smoke(arch)),
                         (get_config(arch, moe_expert_pad=4,
                                     moe_capacity_factor=0.3),
                          r_config(arch, moe_expert_pad=4,
                                   moe_capacity_factor=0.3))):
        for n in (1, 2, 7, 8, 24, 64, 1000, 2048, 4096):
            assert pmoe._capacity(mine, n) == rmoe._capacity(theirs, n)
        want = rmoe.moe_spec(theirs)
        got = pmoe.moe_spec(mine)
        assert jax.tree.map(lambda p: (p.shape, p.axes, p.init), want,
                            is_leaf=lambda p: hasattr(p, "axes")) == \
            jax.tree.map(lambda p: (p.shape, p.axes, p.init), got,
                         is_leaf=lambda p: hasattr(p, "axes"))
    # qwen2-moe at full size: a 2 x 1,024 prefill fills 176 slots an
    # expert, a batch-2 decode step 8
    cfg = get_config("qwen2-moe-a2.7b")
    assert pmoe._capacity(cfg, 2048) == 176 and pmoe._capacity(cfg, 2) == 8


# -- the FFN on one layer's weights -------------------------------------------
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_reference(arch, dtype, variant):
    rcfg, rlayer, rx, cfg, layer, x = _layer0(arch, variant, dtype)
    tol = F32 if dtype == "float32" else BF16
    want_y, want_aux = rmoe.moe_ffn(rcfg, rlayer["moe"], rx)
    record = []
    with torch.inference_mode():
        y, aux = pmoe.moe_ffn(cfg, layer.moe, x, record=record)
    assert y.dtype == x.dtype and y.shape == x.shape
    np.testing.assert_allclose(_f32(y), _f32(want_y), **tol)
    np.testing.assert_allclose(float(aux), float(want_aux), **AUX)

    # the routing, exactly
    (r,) = record
    want_e, want_order, want_slot, want_valid, cap = _ref_routing(
        rcfg, rlayer["moe"], rx)
    assert r.cap == cap
    np.testing.assert_array_equal(r.expert_idx.numpy(), want_e)
    np.testing.assert_array_equal(r.order.numpy(), want_order)
    np.testing.assert_array_equal(r.slot.numpy(), want_slot)
    np.testing.assert_array_equal(r.valid.numpy(), want_valid)
    n_drop = int((~r.valid).sum())
    if variant in ("drops", "ties"):
        assert n_drop > 0, "no token was dropped"
    if variant == "ties":     # every token ties: experts 0..k-1, in order
        assert (want_e == np.arange(cfg.moe_top_k)).all()
    # dropped entries land on the extra row only; real slots are unique
    kept = r.slot[r.valid].numpy()
    assert len(np.unique(kept)) == len(kept)
    Et = cfg.moe_num_experts + cfg.moe_expert_pad
    assert (r.slot[~r.valid] == Et * cap).all()
    assert (kept // cap < cfg.moe_num_experts).all()   # no padded expert

    # the whole FFN half: routed + shared expert / parallel dense MLP
    want_b, want_baux = rmoe.moe_block(rcfg, rlayer, rx)
    with torch.inference_mode():
        got_b, got_baux = layer.ffn(cfg, x)
    np.testing.assert_allclose(_f32(got_b), _f32(want_b), **tol)
    np.testing.assert_allclose(float(got_baux), float(want_baux), **AUX)


def test_combine_sums_in_reference_order():
    """A token's k contributions are added one by one in ascending expert
    order, each sum rounded to bfloat16, as the reference's scatter-add
    of the sorted entries does.  The order shows in bfloat16: 256 + 1 + 1
    is 256, 1 + 1 + 256 is 258."""
    # token 0 picks experts (2, 0, 1), token 1 picks (1, 2, 0)
    expert_idx = torch.tensor([[2, 0, 1], [1, 2, 0]])
    value = {(0, 2): 256.0, (0, 0): 1.0, (0, 1): 1.0,
             (1, 1): 1.0, (1, 2): 1.0, (1, 0): 256.0}
    flat_e = expert_idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    tok_s = order // 3
    contrib = torch.tensor([[value[(int(t), int(e))]] for t, e in
                            zip(tok_s, flat_e[order])], dtype=torch.bfloat16)
    r = pmoe.Routing(expert_idx, None, order, None, None, 8)
    got = pmoe.combine(contrib, r)
    want = jnp.zeros((2, 1), jnp.bfloat16).at[jnp.asarray(tok_s.numpy())].add(
        jnp.asarray(contrib.float().numpy(), jnp.bfloat16))
    np.testing.assert_array_equal(_f32(got), _f32(want))
    assert _f32(got)[:, 0].tolist() == [258.0, 256.0]


# -- whole models on shared weights ------------------------------------------
@pytest.mark.parametrize("variant", ["base", "pad4"])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_matches_reference(arch, variant):
    """The float32 models whole: forward (logits and aux), prefill and its
    cache, three decode steps and greedy tokens.  (In bfloat16 the two
    frameworks round the hidden state at different places, and on the
    qwen2-moe smoke model that routes one token of 24 to another expert
    at layer 1, which moves its logits by up to 0.084; so bfloat16 is
    held layer by layer, below.)"""
    dtype = "float32"
    rcfg, rp, cfg, params = _pair(arch, dtype=dtype, **VARIANTS[variant])
    tol = F32
    tokens = np.random.default_rng(0).integers(1, cfg.vocab_size, (2, 12))
    rt, tt = jnp.asarray(tokens, jnp.int32), torch.as_tensor(tokens)
    max_seq = 16

    want, want_aux = RM.forward(rcfg, rp, rt)
    got, aux = M.forward(cfg, params, tt)
    assert got.dtype == torch.float32 and got.shape == (2, 12, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    np.testing.assert_allclose(float(aux), float(want_aux), **AUX)

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
        step = jnp.asarray(np.asarray(rlog).argmax(-1), jnp.int32)

    want = r_generate(rcfg, rp, rt, steps=4, max_seq=max_seq)
    got = greedy_generate(cfg, params, tt, steps=4, max_seq=max_seq)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("variant", ["base", "pad4"])
@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_layers_match_reference(arch, variant):
    """The bfloat16 models layer by layer: each layer (attention, then the
    MoE block) is given the reference chain's input, and its output, aux
    and routing are held against the reference layer's on that input."""
    rcfg, rp, cfg, params = _pair(arch, dtype="bfloat16",
                                  **VARIANTS[variant])
    tokens = np.random.default_rng(0).integers(1, cfg.vocab_size, (2, 12))
    rx = rcm.embed_tokens(rcfg, rp["embed"], jnp.asarray(tokens, jnp.int32),
                          jnp.bfloat16)
    rpos = jnp.broadcast_to(jnp.arange(12, dtype=jnp.int32), (2, 12))
    pos = torch.as_tensor(np.array(rpos))
    for i, layer in enumerate(params.layers):
        lp = jax.tree.map(lambda a, i=i: a[i], rp["layers"])
        want, want_aux = RT.decoder_layer(rcfg, lp, rx, rpos)
        layer.routing = []
        with torch.inference_mode():
            got, aux = layer(cfg, torch.as_tensor(_f32(rx)).to(
                torch.bfloat16), pos)
        np.testing.assert_allclose(_f32(got), _f32(want), **BF16)
        np.testing.assert_allclose(float(aux), float(want_aux), **AUX_BF16)
        hn = rcm.rmsnorm(rcfg, lp["ln2"], rx + rcm.attention(
            rcfg, lp["attn"], rcm.rmsnorm(rcfg, lp["ln1"], rx), rpos))
        want_e, _, want_slot, want_valid, _ = _ref_routing(rcfg, lp["moe"],
                                                           hn)
        np.testing.assert_array_equal(
            layer.routing[0].expert_idx.numpy(), want_e)
        np.testing.assert_array_equal(layer.routing[0].slot.numpy(),
                                      want_slot)
        rx = want


def test_routing_is_recorded_per_layer():
    _, _, cfg, params = _pair("qwen2-moe-a2.7b", dtype="float32")
    for layer in params.layers:
        layer.routing = []
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        1, cfg.vocab_size, (2, 9)))
    M.prefill(cfg, params, tokens, 16)
    assert [len(ly.routing) for ly in params.layers] == [1] * cfg.num_layers
    r = params.layers[0].routing[0]
    assert tuple(r.expert_idx.shape) == (18, cfg.moe_top_k)
    assert r.cap == pmoe._capacity(cfg, 18)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip(arch):
    rcfg = r_smoke(arch)
    tree = jax.tree.map(np.asarray, RM.init_params(rcfg,
                                                   jax.random.PRNGKey(0)))
    params = M.params_from_reference(get_smoke_config(arch), tree,
                                     device="cpu")
    assert isinstance(params, M.Transformer)
    back = M.params_to_reference(params)
    flat_want = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_got) == len(flat_want)
    names = {jax.tree_util.keystr(p) for p, _ in flat_want}
    assert any("['moe']['router']" in n for n in names)
    assert any("dense_mlp" in n or "shared" in n for n in names)
    for path, want in flat_want:
        got = flat_got[path]
        assert got.shape == want.shape
        # bfloat16 leaves (arctic's param_dtype) come back as float32
        np.testing.assert_array_equal(got, want.astype(np.float32))


# -- the serving driver ------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_driver_runs_on_cpu(arch):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--smoke", "--device", "cpu", "--requests", "4", "--batch", "2",
         "--max-new", "4"],
        env=dict(os.environ, PYTHONPATH=SRC), capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "[serve] 4/4 requests" in out.stdout


def test_serve_driver_matches_reference_driver(monkeypatch, capsys):
    """The reference driver and the port's on the reference's weights:
    the same number of decode steps for the same request stream."""
    from repro.launch import serve as rserve
    arch = "qwen2-moe-a2.7b"
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


def test_moe_models_init_on_cpu():
    """The MoE family is ported: init, a forward pass and its aux."""
    for arch in ARCHS:
        cfg = get_smoke_config(arch)
        params = M.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
        logits, aux = M.forward(cfg, params, torch.ones(1, 5,
                                                        dtype=torch.long))
        assert logits.shape == (1, 5, cfg.vocab_size)
        assert torch.isfinite(logits).all() and float(aux) > 0
        assert cfg.family == "moe"
