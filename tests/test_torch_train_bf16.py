"""The port's bfloat16 loss and gradients held against the reference's.

``repro_torch.models.loss_fn`` and every gradient leaf (autograd, with the
kernels' plain versions on the CPU) against
``jax.value_and_grad(repro.models.loss_fn)`` with the smoke configs'
``kernel_impl="xla"``, on the same weights (the reference's init from
``PRNGKey(0)``, carried across with ``params_from_reference``) and the same
numpy tokens, with bfloat16 activations (float32:
``tests/test_torch_train.py``).  Where a rounding at another place can
flip a discrete choice (MoE routing, recurrentgemma's near-one-hot
attention) the blocks are held one by one.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import models as RM
from repro.configs import get_smoke_config as r_smoke
from repro.models import rglru as r_rglru
from repro.models import transformer as r_transformer

from repro_torch import models as M
from repro_torch.configs import get_smoke_config
from repro_torch.models import common as cm
from repro_torch.models import rglru as p_rglru
from repro_torch.utils.tree import tree_flatten, tree_unflatten

#: bfloat16: both round every activation to 8 mantissa bits, at places
#: that differ, and the backward carries those roundings; each leaf is
#: held by its relative (Frobenius) error, 1-6% seen on the smoke configs.
BF16_REL = 0.1


def _configs(arch, dtype):
    return (dataclasses.replace(r_smoke(arch), dtype=dtype),
            dataclasses.replace(get_smoke_config(arch), dtype=dtype))


def _shared_params(rcfg, cfg):
    rp = RM.init_params(rcfg, jax.random.PRNGKey(0))
    params = M.params_from_reference(cfg, jax.tree.map(np.asarray, rp),
                                     device="cpu")
    params.requires_grad_(True)
    return rp, params


def _leaf_pairs(ref_tree, port_tree):
    """``(path, reference leaf, port leaf)`` in the reference's order."""
    paths, _ = jax.tree_util.tree_flatten_with_path(ref_tree)
    port, _ = tree_flatten(port_tree)
    assert len(paths) == len(port)
    for (path, r), p in zip(paths, port):
        yield (jax.tree_util.keystr(path), np.asarray(r, np.float32),
               p.detach().float().numpy())


def _rel(want, got):
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _loss_and_grads(rcfg, cfg, toks):
    rp, params = _shared_params(rcfg, cfg)
    (rloss, rmet), rgrads = jax.value_and_grad(
        lambda p: RM.loss_fn(rcfg, p, {"tokens": jnp.asarray(toks)}),
        has_aux=True)(rp)
    grads = M.bind_grads(cfg, params)
    loss, met = M.loss_fn(cfg, params, {"tokens": torch.as_tensor(toks)})
    loss.backward()
    return (rloss, rmet, rgrads), (loss, met, grads)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen3-4b",
                                  "mamba2-370m"])
def test_loss_and_every_gradient_match_reference_bfloat16(arch):
    rcfg, cfg = _configs(arch, "bfloat16")
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32)
    (rloss, _, rgrads), (loss, _, grads) = _loss_and_grads(rcfg, cfg, toks)
    assert float(loss) == pytest.approx(float(rloss), abs=2e-2)
    for path, want, got in _leaf_pairs(rgrads, grads):
        assert _rel(want, got) <= BF16_REL, (path, _rel(want, got))


def _layer_grads(r_fn, rp, p_fn, pp, x, dy, dtype):
    """Gradients of one block with respect to its input and parameters,
    both packages from the same input and output cotangent: ``r_fn(rp,
    x)`` in the reference, ``p_fn(x)`` in the port over the tensors of
    ``pp`` (which require gradients)."""
    jd = getattr(jnp, dtype)
    out, vjp = jax.vjp(r_fn, rp, jnp.asarray(x, jd))
    rgp, rgx = vjp(jnp.asarray(dy, jd).astype(out.dtype))
    xt = torch.as_tensor(x).to(getattr(torch, dtype)).requires_grad_(True)
    y = p_fn(xt)
    y.backward(torch.as_tensor(dy).to(y.dtype))
    leaves, treedef = tree_flatten(pp)
    port = {"x": xt.grad,
            "p": tree_unflatten(treedef, [t.grad for t in leaves])}
    return {"x": rgx, "p": rgp}, port


def _trainable(tree):
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [t.detach().clone().requires_grad_(True)
                                    for t in leaves])


def test_moe_layers_gradients_match_reference_bfloat16_layer_by_layer():
    """bfloat16 MoE, each layer alone from the same input: a rounding at
    another place can reroute a token through the whole model, so the
    layers are held one by one (as the serving tests hold them)."""
    rcfg, cfg = _configs("qwen2-moe-a2.7b", "bfloat16")
    rp, params = _shared_params(rcfg, cfg)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    pos = np.arange(16, dtype=np.int32)[None].repeat(2, 0)
    for i, layer in enumerate(params.layers):
        rl = jax.tree.map(lambda a: a[i], rp["layers"])
        dy = rng.standard_normal(x.shape).astype(np.float32)

        def r_fn(p, xx):
            return r_transformer.decoder_layer(rcfg, p, xx,
                                               jnp.asarray(pos))[0]

        want, got = _layer_grads(
            r_fn, rl, lambda xx: layer(cfg, xx, torch.as_tensor(pos))[0],
            layer.reference_tree(), x, dy, "bfloat16")
        assert _rel(np.asarray(want["x"], np.float32),
                    got["x"].float().numpy()) <= BF16_REL
        for path, w, g in _leaf_pairs(want["p"], got["p"]):
            assert _rel(w, g) <= BF16_REL, (i, path, _rel(w, g))


@pytest.mark.parametrize("kind", ["rec", "attn"])
def test_recurrentgemma_blocks_gradients_match_reference_bfloat16(kind):
    """recurrentgemma's random init has attention logits of about +-140,
    so its bfloat16 model is not comparable whole between two
    implementations (a rounding flips a one-hot softmax); its blocks are
    held one by one from the same input, at a moderate input scale."""
    rcfg, cfg = _configs("recurrentgemma-9b", "bfloat16")
    rp, params = _shared_params(rcfg, cfg)
    i = list(cfg.block_pattern).index(kind)
    name = f"b{i}_{kind}"
    rb = jax.tree.map(lambda a: a[0], rp["groups"][name])
    pb = cm.index_tree(params.param_tree()["groups"], 0)[name]
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((2, 16, cfg.d_model)) * 0.5).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    pos = np.arange(16, dtype=np.int32)[None].repeat(2, 0)
    pb = _trainable(pb)
    if kind == "rec":
        r_fn = lambda p, xx: r_rglru.rec_block(rcfg, p, xx)  # noqa: E731
        p_fn = lambda xx: p_rglru.rec_block(cfg, pb, xx)     # noqa: E731
    else:
        r_fn = lambda p, xx: r_rglru.attn_block(  # noqa: E731
            rcfg, p, xx, jnp.asarray(pos))
        p_fn = lambda xx: p_rglru.attn_block(  # noqa: E731
            cfg, pb, xx, torch.as_tensor(pos))
    want, got = _layer_grads(r_fn, rb, p_fn, pb, x, dy, "bfloat16")
    assert _rel(np.asarray(want["x"], np.float32),
                got["x"].float().numpy()) <= BF16_REL
    for path, w, g in _leaf_pairs(want["p"], got["p"]):
        assert _rel(w, g) <= BF16_REL, (path, _rel(w, g))
