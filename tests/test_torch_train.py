"""The port's loss and gradients held against the reference's.

``repro_torch.models.loss_fn`` and every gradient leaf (autograd, with the
kernels' plain versions on the CPU) against
``jax.value_and_grad(repro.models.loss_fn)`` with the smoke configs'
``kernel_impl="xla"``, on the same weights (the reference's init from
``PRNGKey(0)``, carried across with ``params_from_reference``) and the same
numpy tokens, in float32 (bfloat16: ``tests/test_torch_train_bf16.py``).
The train steps, microbatches, remat, restarts and the CLI are in
``tests/test_torch_train_steps.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import models as RM
from repro.configs import get_smoke_config as r_smoke

from repro_torch import models as M
from repro_torch.configs import get_smoke_config
from repro_torch.utils.tree import tree_flatten

ARCHS = ["tinyllama-1.1b", "qwen3-4b", "qwen2-moe-a2.7b", "mamba2-370m",
         "recurrentgemma-9b", "internvl2-26b", "musicgen-large"]
#: float32: the two frameworks differ in summation order only (the
#: smoke configs' leaves agree to 2e-5 of their largest magnitude).
F32 = dict(rtol=1e-4, scale_atol=1e-4)


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


def _hold_f32(path, want, got):
    assert got.shape == want.shape, path
    np.testing.assert_allclose(
        got, want, rtol=F32["rtol"],
        atol=F32["scale_atol"] * max(float(np.abs(want).max()), 1e-30),
        err_msg=path)


def _loss_and_grads(rcfg, cfg, toks):
    rp, params = _shared_params(rcfg, cfg)
    (rloss, rmet), rgrads = jax.value_and_grad(
        lambda p: RM.loss_fn(rcfg, p, {"tokens": jnp.asarray(toks)}),
        has_aux=True)(rp)
    grads = M.bind_grads(cfg, params)
    loss, met = M.loss_fn(cfg, params, {"tokens": torch.as_tensor(toks)})
    loss.backward()
    return (rloss, rmet, rgrads), (loss, met, grads)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_reference_float32(arch):
    rcfg, cfg = _configs(arch, "float32")
    # (2, 24, Cb) for a codebook model
    shape = (2, 24) + ((cfg.num_codebooks,) if cfg.num_codebooks > 1 else ())
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, shape).astype(np.int32)
    (rloss, rmet, rgrads), (loss, met, grads) = _loss_and_grads(rcfg, cfg,
                                                                toks)
    assert float(loss) == pytest.approx(float(rloss), rel=1e-5)
    assert float(met["nll"]) == pytest.approx(float(rmet["nll"]), rel=1e-5)
    assert float(met["aux"]) == pytest.approx(float(rmet["aux"]), rel=1e-5,
                                              abs=1e-7)
    for path, want, got in _leaf_pairs(rgrads, grads):
        _hold_f32(path, want, got)
