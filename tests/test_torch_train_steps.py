"""The port's train steps, microbatches, remat, restarts and training
driver, on the CPU, held against the reference where it has a
counterpart (``repro.train.make_train_step`` from the same state and
batches) and against the behaviours of ``tests/test_system.py`` and
``tests/test_models_smoke.py``."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as r_smoke
from repro.optim import AdamWConfig as RAdamWConfig
from repro.train import TrainState as RTrainState
from repro.train import make_train_step as r_make_train_step

from repro_torch import models as M
from repro_torch.configs import get_smoke_config
from repro_torch.core import MiB, ZNSDeviceSpec
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.kernels import ops
from repro_torch.models import common as cm
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import ZonedCheckpointStore
from repro_torch.train import TrainState, make_train_step
from repro_torch.utils.tree import tree_flatten

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")
SMALL_SPEC = ZNSDeviceSpec(zone_size_bytes=8 * MiB, zone_cap_bytes=4 * MiB,
                           num_zones=128, max_open_zones=6,
                           max_active_zones=8)
#: Three AdamW steps from the same state.  Step 1: the gradients agree to
#: 2e-5 of each leaf's scale (summation order), so m and v do.  AdamW moves
#: each parameter by about lr * m / sqrt(v) a step, and where a gradient
#: element is near 0 that ratio magnifies the difference: the parameters
#: also get 1e-2 of the learning rate.  Steps 2-3 start from parameters
#: that already differ, and the embedding's gradient (summed over the
#: Zipf-distributed tokens) moves most: 6e-4 of its scale at step 3.
STEP_TOL = dict(rtol=1e-4, scale_atol=(1e-4, 2e-3, 2e-3))
LR = 3e-3


def _hold(path, want, got, step, extra=0.0):
    np.testing.assert_allclose(
        got, want, rtol=STEP_TOL["rtol"],
        atol=STEP_TOL["scale_atol"][step]
        * max(float(np.abs(want).max()), 1e-30) + extra, err_msg=path)


def _pairs(ref_tree, port_tree):
    paths, _ = jax.tree_util.tree_flatten_with_path(ref_tree)
    port, _ = tree_flatten(port_tree)
    assert len(paths) == len(port)
    for (path, r), p in zip(paths, port):
        yield (jax.tree_util.keystr(path), np.asarray(r, np.float32),
               p.detach().float().numpy())


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen3-4b"])
def test_three_train_steps_match_reference(arch):
    # float32 activations: bfloat16 would hold the two frameworks' rounding
    rcfg = dataclasses.replace(r_smoke(arch), dtype="float32")
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    ropt = RAdamWConfig(lr=LR, warmup_steps=2, total_steps=10)
    opt = AdamWConfig(lr=LR, warmup_steps=2, total_steps=10)
    rstate = RTrainState.create(rcfg, jax.random.PRNGKey(0))
    state = M.train_state_from_reference(
        cfg, jax.tree.map(np.asarray, rstate), device="cpu")
    rstep = jax.jit(r_make_train_step(rcfg, ropt))
    step = make_train_step(cfg, opt)
    data = TokenPipeline(DataConfig(cfg.vocab_size, seq_len=24,
                                    global_batch=4))
    for i in range(3):
        batch = next(data)
        rstate, rmet = rstep(rstate, jax.tree.map(jnp.asarray, batch))
        state, met = step(state, batch)
        assert state.step == int(rstate.step) == i + 1
        # step 1 starts from the same state; later steps from parameters
        # a fraction of a step apart, which move tinyllama's grad norm ~2e-4
        for key in ("loss", "nll", "grad_norm"):
            assert float(met[key]) == pytest.approx(
                float(rmet[key]), rel=1e-4 if i == 0 else 1e-3), key
        assert float(met["lr"]) == pytest.approx(float(rmet["lr"]),
                                                 rel=1e-6)
        for name, rt, pt in (("params", rstate.params,
                              state.params.param_tree()),
                             ("m", rstate.opt["m"], state.opt["m"]),
                             ("v", rstate.opt["v"], state.opt["v"])):
            for path, want, got in _pairs(rt, pt):
                _hold(f"step {i + 1} {name}{path}", want, got, i,
                      1e-2 * LR if name == "params" else 0.0)


def test_train_state_round_trips_through_the_reference_layout():
    cfg = get_smoke_config("qwen2-moe-a2.7b")
    state = TrainState.create(cfg, torch.Generator().manual_seed(3),
                              device="cpu")
    for leaf in tree_flatten(state.opt)[0]:
        leaf.normal_()
    state.step = 7
    tree = M.train_state_to_reference(state)
    back = M.train_state_from_reference(cfg, tree, device="cpu")
    assert back.step == 7
    assert all(p.requires_grad for p in back.params.parameters())
    for a, b in zip(tree_flatten(state.tree())[0],
                    tree_flatten(back.tree())[0]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_microbatched_train_step_matches_single():
    """tests/test_models_smoke.py's check: the same data split in two
    microbatches gives the same loss and, with gradients averaged, the
    same parameters."""
    cfg = dataclasses.replace(get_smoke_config("tinyllama-1.1b"),
                              remat="none")
    batch = {"tokens": np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 32)).astype(np.int32)}
    out = []
    for mb in (1, 2):
        state = TrainState.create(cfg, torch.Generator().manual_seed(7),
                                  device="cpu")
        state, met = make_train_step(cfg, AdamWConfig(warmup_steps=0),
                                     microbatches=mb)(state, batch)
        out.append((met, np.concatenate([
            t.detach().numpy().ravel()
            for t in tree_flatten(state.params.param_tree())[0]])))
    (m1, p1), (m2, p2) = out
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-4)
    np.testing.assert_allclose(p1, p2, atol=5e-4)


def test_remat_full_and_none_give_equal_gradients(monkeypatch):
    """Rematerialisation changes what is stored, not what is computed:
    equal gradients; the layers' forwards run as often as
    ``layer_forward_runs`` says (2 layers in one block of 2: 5 runs; 2
    without remat)."""
    calls = []
    plain = ops._rms.rmsnorm_torch
    monkeypatch.setattr(ops._rms, "rmsnorm_torch",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    batch = {"tokens": torch.as_tensor(np.random.default_rng(1).integers(
        0, 128, (2, 24)))}
    grads, norms = [], []
    for remat in ("none", "full"):
        cfg = dataclasses.replace(get_smoke_config("qwen3-4b"), remat=remat)
        params = M.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
        params.requires_grad_(True)
        g = M.bind_grads(cfg, params)
        calls.clear()
        M.loss_fn(cfg, params, batch)[0].backward()
        norms.append(len(calls))
        grads.append(tree_flatten(g)[0])
    for a, b in zip(*grads):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                                   atol=1e-7 * float(a.abs().max()))
    # per layer forward: ln1, ln2, q_norm, k_norm; plus the final norm
    runs = [cm.layer_forward_runs(dataclasses.replace(cfg, remat=r), 2)
            for r in ("none", "full")]
    assert runs == [2, 5]
    assert norms == [4 * n + 1 for n in runs]


def test_training_reduces_loss():
    """tests/test_system.py's check on the port: 40 smoke steps."""
    cfg = get_smoke_config("tinyllama-1.1b")
    data = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                    global_batch=8))
    state = TrainState.create(cfg, torch.Generator().manual_seed(7),
                              device="cpu")
    step = make_train_step(cfg, AdamWConfig(lr=3e-3, warmup_steps=5,
                                            total_steps=60,
                                            weight_decay=0.0))
    losses = []
    for _ in range(40):
        state, metrics = step(state, next(data))
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2


def test_checkpoint_restart_resumes_bit_exact(tmp_path):
    """tests/test_system.py's restart through the port's store: run 6
    steps checkpointing at 3; restore at 3 into a fresh state and replay
    3..5; every parameter equals the uninterrupted run's bit for bit."""
    cfg = get_smoke_config("qwen3-4b")
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4)
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=0))
    store = ZonedCheckpointStore(str(tmp_path), n_hosts=2, spec=SMALL_SPEC,
                                 device="cpu")
    data = TokenPipeline(dcfg)
    state = TrainState.create(cfg, torch.Generator().manual_seed(7),
                              device="cpu")
    for i in range(6):
        if i == 3:
            store.save(3, state.tree(),
                       extra_meta={"data": data.state_dict()})
        state, _ = step(state, next(data))
    fresh = TrainState.create(cfg, torch.Generator().manual_seed(99),
                              device="cpu")
    restored, manifest = store.restore(3, fresh.tree())
    fresh.load(restored)
    assert fresh.step == 3
    data2 = TokenPipeline(dcfg)
    data2.load_state_dict(manifest["meta"]["data"])
    for _ in range(3):
        fresh, _ = step(fresh, next(data2))
    for a, b in zip(tree_flatten(state.tree())[0],
                    tree_flatten(fresh.tree())[0]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_train_driver_runs_and_restarts_on_cpu(tmp_path):
    """``python -m repro_torch.launch.train --smoke --device cpu`` exits 0,
    checkpoints through the store, and a second run restores from the
    latest step."""
    env = dict(os.environ, PYTHONPATH=SRC)
    args = [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
            "--device", "cpu", "--batch", "2", "--seq-len", "16",
            "--log-every", "2", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2"]
    first = subprocess.run(args + ["--steps", "4"], capture_output=True,
                           text=True, env=env, timeout=300)
    assert first.returncode == 0, first.stderr
    assert "[train] ckpt@4" in first.stdout
    assert "[train] done" in first.stdout
    second = subprocess.run(args + ["--steps", "6"], capture_output=True,
                            text=True, env=env, timeout=300)
    assert second.returncode == 0, second.stderr
    assert "[train] restored step 4" in second.stdout
    assert "[train] step 6 " in second.stdout


def test_recurrent_families_train_on_the_cpu():
    """The ssm and hybrid families train through the plain versions on
    the CPU (their kernels' backward is queued for the card)."""
    for arch in ("mamba2-370m", "recurrentgemma-9b"):
        cfg = get_smoke_config(arch)
        state = TrainState.create(cfg, torch.Generator().manual_seed(0),
                                  device="cpu")
        step = make_train_step(cfg, AdamWConfig(lr=3e-3, warmup_steps=0))
        batch = {"tokens": np.random.default_rng(0).integers(
            0, cfg.vocab_size, (2, 16)).astype(np.int32)}
        state, met = step(state, batch)
        assert state.step == 1 and np.isfinite(float(met["loss"]))
        assert float(met["grad_norm"]) > 0


def test_a_train_step_frees_its_gradient_buffers(monkeypatch):
    """The gradient buffers die when the step returns, not when the
    garbage collector next runs: a reference cycle that held them (a
    closure that calls itself, over a list of the leaves) kept a whole
    second set alive into the next step (4.4 GB at tinyllama-1.1b)."""
    import gc
    import weakref
    from repro_torch.utils.tree import tree_leaves, tree_unflatten
    cfg = get_smoke_config("tinyllama-1.1b")
    state = TrainState.create(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    step = make_train_step(cfg, AdamWConfig(lr=LR, warmup_steps=0))
    tokens = {"tokens": np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16))}
    refs = []
    bind = M.bind_grads

    def spy(cfg_, params):
        grads = bind(cfg_, params)
        refs.extend(weakref.ref(g) for g in tree_leaves(grads))
        return grads

    monkeypatch.setattr(M, "bind_grads", spy)
    enabled = gc.isenabled()
    gc.disable()
    try:
        for _ in range(2):          # the first step also runs imports
            refs.clear()
            state, _ = step(state, tokens)
            assert refs and all(r() is None for r in refs)
        # the tree helpers hold no leaf past their return
        leaf = torch.zeros(3)
        ref = weakref.ref(leaf)
        leaves, treedef = tree_flatten({"a": [leaf, None], "b": (leaf,)})
        tree = tree_unflatten(treedef, leaves)
        del leaf, leaves, tree
        assert ref() is None
    finally:
        if enabled:
            gc.enable()
