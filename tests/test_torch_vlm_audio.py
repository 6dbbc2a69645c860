"""The port's VLM (internvl2-26b) and audio (musicgen-large) families
held against the reference.

The same numpy inputs go through ``repro`` and ``repro_torch`` on the
same weights (the reference's init from ``PRNGKey(0)``, carried across
with ``params_from_reference``), on the smoke configs, whose
``kernel_impl="xla"`` runs the reference's plain oracles and the port's
plain versions.  The VLM takes stub patch embeddings (``frontend_inputs``,
(B, num_patches, D)) that overwrite the first positions; the audio model
takes (B, S, Cb) codebook tokens and gives (B, S, Cb, V) logits.
Tolerances are those of ``tests/test_torch_serve.py`` (serving) and
``tests/test_torch_train.py`` / ``tests/test_torch_train_bf16.py``
(gradients).
"""
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
from repro.models import transformer as r_transformer
from repro.optim import AdamWConfig as RAdamWConfig
from repro.serve import greedy_generate as r_generate
from repro.train import TrainState as RTrainState
from repro.train import make_train_step as r_make_train_step

from repro_torch import models as M
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.launch import serve as pserve
from repro_torch.launch import train as ptrain
from repro_torch.models import common as cm
from repro_torch.optim import AdamWConfig
from repro_torch.serve import greedy_generate
from repro_torch.train import make_train_step
from repro_torch.utils.tree import tree_flatten

from test_torch_serve import BF16, F32, _f32
from test_torch_train import _hold_f32, _leaf_pairs
from test_torch_train_bf16 import BF16_REL, _rel
from test_torch_train_steps import LR, _hold, _pairs

#: Full-size parameter counts (the spec trees; equal in both packages).
FULL_PARAMS = {"musicgen-large": 3_254_978_560,
               "internvl2-26b": 19_899_009_024}


def _pair(arch, dtype):
    rcfg = r_smoke(arch, dtype=dtype)
    cfg = get_smoke_config(arch, dtype=dtype)
    rp = RM.init_params(rcfg, jax.random.PRNGKey(0))
    params = M.params_from_reference(cfg, jax.tree.map(np.asarray, rp),
                                     device="cpu")
    return rcfg, rp, cfg, params


def _tokens(cfg, b, s, seed=0, low=1):
    """(b, s) token ids, or (b, s, Cb) for a codebook model."""
    shape = (b, s) + ((cfg.num_codebooks,) if cfg.num_codebooks > 1 else ())
    return np.random.default_rng(seed).integers(
        low, cfg.vocab_size, shape).astype(np.int32)


def _patches(cfg, b, seed=1):
    """Stub patch embeddings (b, num_patches, D), as numpy float32."""
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.num_patches, cfg.d_model)).astype(np.float32)


def _frontend(patches, dtype):
    """The same patches as a jax and a torch array (None, None if none)."""
    if patches is None:
        return None, None
    return (jnp.asarray(patches, getattr(jnp, dtype)),
            torch.as_tensor(patches).to(getattr(torch, dtype)))


# -- the family's own pieces ---------------------------------------------------
def test_codebook_embeddings_and_heads_match_reference():
    """embed_tokens sums the codebooks' embeddings in the parameters'
    dtype and casts after, so float32 is bit-equal; the codebook heads
    give (B, S, Cb, V) after the main head's."""
    rcfg, rp, cfg, params = _pair("musicgen-large", "float32")
    toks = _tokens(cfg, 2, 7, low=0)
    want = rcm.embed_tokens(rcfg, rp["embed"], jnp.asarray(toks),
                            jnp.float32)
    got = cm.embed_tokens(cfg, params.embed, torch.as_tensor(toks),
                          torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    x = np.random.default_rng(3).standard_normal(
        (2, 7, cfg.d_model)).astype(np.float32)
    want = rcm.lm_logits(rcfg, rp["embed"], jnp.asarray(x))
    got = cm.lm_logits(cfg, params.embed, torch.as_tensor(x))
    assert got.shape == (2, 7, cfg.num_codebooks, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    # the first codebook's logits are the main head's alone
    head = torch.as_tensor(x) @ params.embed["lm_head"]
    np.testing.assert_allclose(got[:, :, 0].numpy(), head.numpy(), **F32)


@pytest.mark.parametrize("seq", [9, 4, 2], ids=["longer", "equal",
                                                "shorter"])
def test_patch_frontend_matches_reference(seq):
    """The projected patches overwrite the first num_patches positions;
    a sequence shorter than the patches comes out as long as the
    patches, as the reference's concatenate makes it."""
    rcfg, rp, cfg, params = _pair("internvl2-26b", "float32")
    x = np.random.default_rng(4).standard_normal(
        (2, seq, cfg.d_model)).astype(np.float32)
    patches = _patches(cfg, 2)
    want = rcm.apply_frontend(rcfg, rp["embed"], jnp.asarray(x),
                              jnp.asarray(patches))
    got = cm.apply_frontend(cfg, params.embed, torch.as_tensor(x),
                            torch.as_tensor(patches))
    assert got.shape == want.shape == (2, max(seq, cfg.num_patches),
                                       cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_array_equal(got[:, cfg.num_patches:].numpy(),
                                  x[:, cfg.num_patches:])
    same = cm.apply_frontend(cfg, params.embed, torch.as_tensor(x), None)
    np.testing.assert_array_equal(same.numpy(), x)


@pytest.mark.parametrize("arch", ["musicgen-large", "internvl2-26b"])
def test_full_size_param_counts_match_reference(arch):
    assert M.count_params(get_config(arch)) == FULL_PARAMS[arch] \
        == RM.count_params(r_config(arch))


# -- serving on shared weights -------------------------------------------------
def _hold_forward_layer_by_layer(rcfg, rp, cfg, params, toks, tol):
    """forward's pieces one by one, each from the reference chain's input:
    the embeddings bit for bit, every decoder layer, and the final norm
    and heads, at ``tol``."""
    x = cm.embed_tokens(cfg, params.embed, torch.as_tensor(toks),
                        cm.torch_dtype(cfg.dtype))
    rx = rcm.embed_tokens(rcfg, rp["embed"], jnp.asarray(toks),
                          jnp.dtype(rcfg.dtype))
    np.testing.assert_array_equal(_f32(x), _f32(rx))
    b, s = toks.shape[:2]
    pos = torch.arange(s, dtype=torch.int32).expand(b, s)
    rpos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (b, s))
    for i, layer in enumerate(params.layers):
        lp = jax.tree.map(lambda a: a[i], rp["layers"])
        ry, _ = r_transformer.decoder_layer(rcfg, lp, rx, rpos)
        with torch.inference_mode():
            y, _ = layer(cfg, torch.as_tensor(_f32(rx)).to(x.dtype), pos)
        np.testing.assert_allclose(_f32(y), _f32(ry), **tol,
                                   err_msg=f"layer {i}")
        rx = ry
    rh = rcm.rmsnorm(rcfg, rp["embed"]["final_norm"], rx)
    with torch.inference_mode():
        h = cm.rmsnorm(cfg, params.embed["final_norm"],
                       torch.as_tensor(_f32(rx)).to(x.dtype))
        np.testing.assert_allclose(_f32(h), _f32(rh), **tol)
        got = cm.lm_logits(cfg, params.embed,
                           torch.as_tensor(_f32(rh)).to(x.dtype))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(rcm.lm_logits(rcfg, rp["embed"], rh)), **tol)


@pytest.mark.parametrize("arch,dtype,image,whole", [
    ("musicgen-large", "float32", False, True),
    ("musicgen-large", "bfloat16", False, False),
    ("internvl2-26b", "float32", False, True),
    ("internvl2-26b", "float32", True, True),
    ("internvl2-26b", "bfloat16", False, True),
    ("internvl2-26b", "bfloat16", True, True),
], ids=["musicgen-f32", "musicgen-bf16", "internvl2-f32-text",
        "internvl2-f32-image", "internvl2-bf16-text",
        "internvl2-bf16-image"])
def test_model_matches_reference(arch, dtype, image, whole):
    """forward, prefill (last logits and K/V caches), three decode steps
    and greedy_generate, on (B, S) or (B, S, Cb) tokens, with or without
    the VLM's patch embeddings (greedy_generate takes none, as in the
    reference).

    musicgen's bfloat16 forward is held layer by layer (``whole`` False),
    as tests/test_torch_rglru.py holds recurrentgemma's: the reference's
    fan-in init takes the 4 heads as the fan-in of wq and wk (std 0.5), so
    the smoke model's attention logits reach tens and its softmax is
    near one-hot.  Each layer holds at BF16 from the reference chain's
    input, but over the whole chain one logit of 3,072 moves by 0.084,
    where BF16 allows 0.0827.  Its prefill and decode logits and caches
    (the last position) are held whole."""
    rcfg, rp, cfg, params = _pair(arch, dtype)
    tol = F32 if dtype == "float32" else BF16
    toks = _tokens(cfg, 2, 12)
    rt, tt = jnp.asarray(toks), torch.as_tensor(toks)
    rfi, fi = _frontend(_patches(cfg, 2) if image else None, dtype)
    max_seq = 16
    vshape = (cfg.num_codebooks,) if cfg.num_codebooks > 1 else ()

    got, aux = M.forward(cfg, params, tt, fi)
    assert got.dtype == torch.float32
    assert got.shape == (2, 12) + vshape + (cfg.vocab_size,)
    if whole:
        want, _ = RM.forward(rcfg, rp, rt, rfi)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    else:
        _hold_forward_layer_by_layer(rcfg, rp, cfg, params, toks, tol)

    rlog, rcache = RM.prefill(rcfg, rp, rt, max_seq, rfi)
    log, cache = M.prefill(cfg, params, tt, max_seq, fi)
    assert log.shape == (2, 1) + vshape + (cfg.vocab_size,)
    np.testing.assert_allclose(log.numpy(), np.asarray(rlog), **tol)
    for key in ("k", "v"):
        assert cache[key].shape == rcache[key].shape
        np.testing.assert_allclose(_f32(cache[key]), _f32(rcache[key]), **tol)

    step = np.asarray(rlog)[:, -1].argmax(-1).astype(np.int32)
    for i in range(3):
        pos = toks.shape[1] + i
        rlog, rcache = RM.decode_step(rcfg, rp, rcache, jnp.asarray(step),
                                      jnp.int32(pos))
        log, cache = M.decode_step(cfg, params, cache,
                                   torch.as_tensor(step), pos)
        assert log.shape == (2,) + vshape + (cfg.vocab_size,)
        np.testing.assert_allclose(log.numpy(), np.asarray(rlog), **tol)
        for key in ("k", "v"):
            np.testing.assert_allclose(_f32(cache[key]), _f32(rcache[key]),
                                       **tol)
        step = np.asarray(rlog).argmax(-1).astype(np.int32)

    want = r_generate(rcfg, rp, rt, steps=4, max_seq=max_seq)
    got = greedy_generate(cfg, params, tt, steps=4, max_seq=max_seq)
    assert got.shape == (2, 4) + vshape
    if dtype == "float32":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- training on shared weights ------------------------------------------------
def _loss_and_grads(arch, dtype, image):
    rcfg, rp, cfg, params = _pair(arch, dtype)
    params.requires_grad_(True)
    toks = _tokens(cfg, 2, 24, seed=1, low=0)
    rfi, fi = _frontend(_patches(cfg, 2, seed=5) if image else None, dtype)
    rbatch, batch = {"tokens": jnp.asarray(toks)}, {
        "tokens": torch.as_tensor(toks)}
    if image:
        rbatch["frontend_inputs"], batch["frontend_inputs"] = rfi, fi
    (rloss, _), rgrads = jax.value_and_grad(
        lambda p: RM.loss_fn(rcfg, p, rbatch), has_aux=True)(rp)
    grads = M.bind_grads(cfg, params)
    loss, _ = M.loss_fn(cfg, params, batch)
    loss.backward()
    return rloss, rgrads, loss, grads


@pytest.mark.parametrize("arch,image", [("musicgen-large", False),
                                        ("internvl2-26b", True)],
                         ids=["musicgen", "internvl2-image"])
def test_loss_and_every_gradient_match_reference_float32(arch, image):
    """The cross-entropy over every codebook of every position, or with
    the image's patches over the first positions; every leaf, the
    codebook embeddings and heads or patch_proj among them, within
    tests/test_torch_train.py's F32."""
    rloss, rgrads, loss, grads = _loss_and_grads(arch, "float32", image)
    assert float(loss) == pytest.approx(float(rloss), rel=1e-5)
    paths = [p for p, _, _ in _leaf_pairs(rgrads, grads)]
    for key in (("codebook_embed", "codebook_head") if not image
                else ("patch_proj",)):
        assert any(key in p for p in paths), (key, paths)
    for path, want, got in _leaf_pairs(rgrads, grads):
        if any(k in path for k in ("codebook", "patch_proj")):
            assert np.abs(want).max() > 0, path
        _hold_f32(path, want, got)


@pytest.mark.parametrize("arch,image", [("musicgen-large", False),
                                        ("internvl2-26b", True)],
                         ids=["musicgen", "internvl2-image"])
def test_loss_and_every_gradient_match_reference_bfloat16(arch, image):
    """The same in bfloat16, each leaf by its relative (Frobenius) error
    within tests/test_torch_train_bf16.py's BF16_REL."""
    rloss, rgrads, loss, grads = _loss_and_grads(arch, "bfloat16", image)
    assert float(loss) == pytest.approx(float(rloss), abs=2e-2)
    for path, want, got in _leaf_pairs(rgrads, grads):
        assert _rel(want, got) <= BF16_REL, (path, _rel(want, got))


def test_adamw_step_matches_reference_musicgen():
    """One AdamW step of musicgen's smoke config through train.step from
    the reference's state, on a (B, S, Cb) batch of the data pipeline:
    the metrics, parameters, m and v at tests/test_torch_train_steps.py's
    first-step tolerance."""
    rcfg = r_smoke("musicgen-large", dtype="float32")
    cfg = get_smoke_config("musicgen-large", dtype="float32")
    rstate = RTrainState.create(rcfg, jax.random.PRNGKey(0))
    state = M.train_state_from_reference(
        cfg, jax.tree.map(np.asarray, rstate), device="cpu")
    batch = next(TokenPipeline(DataConfig(
        cfg.vocab_size, seq_len=24, global_batch=4,
        num_codebooks=cfg.num_codebooks)))
    assert batch["tokens"].shape == (4, 24, cfg.num_codebooks)
    rstate, rmet = jax.jit(r_make_train_step(
        rcfg, RAdamWConfig(lr=LR, warmup_steps=2, total_steps=10)))(
            rstate, jax.tree.map(jnp.asarray, batch))
    state, met = make_train_step(
        cfg, AdamWConfig(lr=LR, warmup_steps=2, total_steps=10))(state,
                                                                 batch)
    for key in ("loss", "nll", "grad_norm", "lr"):
        assert float(met[key]) == pytest.approx(float(rmet[key]),
                                                rel=1e-4), key
    for name, rt, pt in (("params", rstate.params,
                          state.params.param_tree()),
                         ("m", rstate.opt["m"], state.opt["m"]),
                         ("v", rstate.opt["v"], state.opt["v"])):
        for path, want, got in _pairs(rt, pt):
            _hold(f"{name}{path}", want, got, 0,
                  1e-2 * LR if name == "params" else 0.0)


def test_train_state_carries_the_family_leaves():
    """train_state_from_reference / _to_reference carry codebook_embed,
    codebook_head and patch_proj (parameters, m and v) both ways."""
    for arch in ("musicgen-large", "internvl2-26b"):
        rcfg, cfg = r_smoke(arch), get_smoke_config(arch)
        rstate = jax.tree.map(np.asarray,
                              RTrainState.create(rcfg, jax.random.PRNGKey(2)))
        state = M.train_state_from_reference(cfg, rstate, device="cpu")
        back = M.train_state_to_reference(state)
        for key in ("codebook_embed", "codebook_head", "patch_proj"):
            if key not in rstate.params["embed"]:
                continue
            np.testing.assert_array_equal(back["params"]["embed"][key],
                                          rstate.params["embed"][key])
            for part in ("m", "v"):
                np.testing.assert_array_equal(back["opt"][part]["embed"][key],
                                              rstate.opt[part]["embed"][key])


@pytest.mark.parametrize("arch", ["musicgen-large", "internvl2-26b"])
def test_bfloat16_params_carry_across(arch):
    """params_from_reference / params_to_reference with param_dtype
    bfloat16 (internvl2-26b's serving dtype) keep every leaf, the
    family's own among them, bit for bit."""
    rcfg = r_smoke(arch, param_dtype="bfloat16")
    cfg = get_smoke_config(arch, param_dtype="bfloat16")
    tree = jax.tree.map(np.asarray, RM.init_params(rcfg,
                                                   jax.random.PRNGKey(0)))
    params = M.params_from_reference(cfg, tree, device="cpu")
    embed = params.embed
    assert all(t.dtype == torch.bfloat16 for t in embed.values())
    back = M.params_to_reference(params)
    want = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert got.keys() == want.keys()
    for path, w in want.items():
        np.testing.assert_array_equal(got[path], np.asarray(w, np.float32))


# -- the drivers -------------------------------------------------------------
def test_serve_driver_refuses_codebooks_as_the_reference_fails(monkeypatch):
    """The driver feeds one token a slot: the reference's fails on
    musicgen's (B, Cb) tokens with a shape error, the port's raises a
    ValueError that names the cause before it builds anything."""
    from repro.launch import serve as rserve
    argv = ["--arch", "musicgen-large", "--smoke", "--requests", "2",
            "--batch", "2", "--max-new", "2"]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    with pytest.raises(ValueError):
        rserve.main()
    with pytest.raises(ValueError, match="num_codebooks"):
        pserve.main(argv + ["--device", "cpu"])


def test_train_driver_trains_musicgen_on_cpu():
    """launch.train on musicgen's smoke config: (B, S, Cb) batches from
    the pipeline, finite losses that fall."""
    out = ptrain.main(["--arch", "musicgen-large", "--smoke", "--device",
                       "cpu", "--steps", "12", "--batch", "4", "--seq-len",
                       "32", "--warmup", "2", "--log-every", "4"])
    losses = np.asarray(out["losses"])
    assert len(losses) == 12 and np.isfinite(losses).all()
    assert losses[-3:].mean() < losses[:3].mean()
    leaves = tree_flatten(out["state"].params.param_tree())[0]
    assert all(bool(torch.isfinite(t).all()) for t in leaves)
