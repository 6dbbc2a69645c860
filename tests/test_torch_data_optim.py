"""The port's data pipeline and AdamW held against ``repro.data`` and
``repro.optim``, and the behaviours of ``tests/test_data_optim_runtime.py``
on the port."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.data import DataConfig as RDataConfig
from repro.data import TokenPipeline as RTokenPipeline
from repro.data.pipeline import global_batch_at as r_global_batch_at
from repro.optim import AdamWConfig as RAdamWConfig
from repro.optim import adamw_update as r_adamw_update
from repro.optim import clip_by_global_norm as r_clip
from repro.optim import init_opt_state as r_init_opt_state
from repro.optim import schedule_lr as r_schedule_lr

from repro_torch.data import DataConfig, TokenPipeline, global_batch_at
from repro_torch.optim import (
    AdamWConfig, adamw_update, clip_by_global_norm, global_norm,
    init_opt_state, schedule_lr,
)
from repro_torch.utils.tree import tree_flatten

#: AdamW in float32 in both frameworks: the same formulas, rounded
#: alike up to the order of a few float32 operations (and the norm's sum).
OPT_TOL = dict(rtol=1e-6, atol=1e-7)


# -- data: bit-equal to the reference ------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(vocab_size=128, seq_len=16, global_batch=8),
    dict(vocab_size=1000, seq_len=33, global_batch=6, seed=7, zipf_a=1.1),
    dict(vocab_size=64, seq_len=8, global_batch=4, num_codebooks=4),
])
def test_pipeline_batches_bit_equal_to_reference(kw):
    for shard, num_shards in ((0, 1), (0, 3), (2, 3), (1, 4)):
        if num_shards > kw["global_batch"]:
            continue
        mine = TokenPipeline(DataConfig(**kw), shard=shard,
                             num_shards=num_shards)
        ref = RTokenPipeline(RDataConfig(**kw), shard=shard,
                             num_shards=num_shards)
        for _ in range(3):
            a, b = next(mine)["tokens"], next(ref)["tokens"]
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        assert mine.state_dict() == ref.state_dict()
    cfg = dict(kw)
    np.testing.assert_array_equal(
        global_batch_at(DataConfig(**cfg), 5)["tokens"],
        r_global_batch_at(RDataConfig(**cfg), 5)["tokens"])


def test_pipeline_reshard_and_resume_bit_equal_to_reference():
    kw = dict(vocab_size=64, seq_len=8, global_batch=12)
    mine = TokenPipeline(DataConfig(**kw), shard=0, num_shards=4)
    ref = RTokenPipeline(RDataConfig(**kw), shard=0, num_shards=4)
    for _ in range(5):
        next(mine), next(ref)
    a, b = mine.reshard(1, 5), ref.reshard(1, 5)
    assert a.state.step == b.state.step == 5
    np.testing.assert_array_equal(next(a)["tokens"], next(b)["tokens"])
    c = TokenPipeline(DataConfig(**kw))
    c.load_state_dict({"step": 9})
    np.testing.assert_array_equal(next(c)["tokens"],
                                  RTokenPipeline(RDataConfig(**kw))
                                  .batch_at(9)["tokens"])


# -- data: the reference's behaviours ------------------------------------------
def test_pipeline_deterministic_and_resumable():
    cfg = DataConfig(vocab_size=128, seq_len=16, global_batch=8)
    p1 = TokenPipeline(cfg)
    batches = [next(p1) for _ in range(3)]
    p2 = TokenPipeline(cfg)
    p2.load_state_dict({"step": 2})
    np.testing.assert_array_equal(next(p2)["tokens"], batches[2]["tokens"])


def test_pipeline_sharding_partitions_global_batch():
    cfg = DataConfig(vocab_size=64, seq_len=8, global_batch=8)
    shards = [TokenPipeline(cfg, shard=s, num_shards=4).batch_at(0)["tokens"]
              for s in range(4)]
    assert all(s.shape == (2, 8) for s in shards)
    assert not np.array_equal(shards[0], shards[1])


def test_pipeline_elastic_reshard_preserves_step():
    cfg = DataConfig(vocab_size=64, seq_len=8, global_batch=12)
    p = TokenPipeline(cfg, shard=0, num_shards=4)
    for _ in range(5):
        next(p)
    q = p.reshard(shard=1, num_shards=3)
    assert q.state.step == 5
    assert q.batch_at(5)["tokens"].shape == (4, 8)


def test_token_distribution_is_zipfish():
    cfg = DataConfig(vocab_size=1000, seq_len=256, global_batch=16)
    toks = TokenPipeline(cfg).batch_at(0)["tokens"].ravel()
    counts = np.bincount(toks, minlength=1000)
    assert counts.max() / len(toks) > 5.0 / 1000


def test_pipeline_refuses_more_shards_than_rows():
    with pytest.raises(ValueError):
        TokenPipeline(DataConfig(vocab_size=8, seq_len=4, global_batch=2),
                      num_shards=3)


# -- optimizer: against the reference -------------------------------------------
def _random_tree(rng, scale=1.0):
    return {"embed": {"w": rng.standard_normal((6, 4)) * scale},
            "layers": {"a": rng.standard_normal((3, 5)) * scale,
                       "b": rng.standard_normal((7,)) * scale}}


def _jax(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tree)


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict)
            else torch.as_tensor(np.asarray(v, np.float32)) for k, v in
            tree.items()}


def _close(port_tree, ref_tree, tol=OPT_TOL):
    a, _ = tree_flatten(port_tree)
    b = jax.tree.leaves(ref_tree)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), **tol)


@pytest.mark.parametrize("schedule", ["cosine", "constant"])
@pytest.mark.parametrize("warmup", [0, 5])
def test_schedule_lr_matches_reference(schedule, warmup):
    kw = dict(lr=2e-3, warmup_steps=warmup, total_steps=40, min_lr_frac=0.1,
              schedule=schedule)
    for step in (0, 1, 4, 5, 6, 20, 39, 40, 55):
        got = schedule_lr(AdamWConfig(**kw), step)
        want = r_schedule_lr(RAdamWConfig(**kw), jnp.int32(step))
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(float(want), rel=1e-6, abs=1e-12)


@pytest.mark.parametrize("scale", [1e-3, 1.0, 30.0])
def test_clip_by_global_norm_matches_reference(scale):
    tree = _random_tree(np.random.default_rng(int(scale * 10)), scale)
    got, norm = clip_by_global_norm(_torch(tree), 1.0)
    want, rnorm = r_clip(_jax(tree), 1.0)
    assert float(norm) == pytest.approx(float(rnorm), rel=1e-6)
    assert float(global_norm(_torch(tree))) == pytest.approx(float(rnorm),
                                                             rel=1e-6)
    _close(got, want)


@pytest.mark.parametrize("wd,clip", [(0.1, 1.0), (0.0, 1e9), (0.5, 0.3)])
def test_adamw_update_matches_reference_over_steps(wd, clip):
    rng = np.random.default_rng(5)
    params = _random_tree(rng)
    kw = dict(lr=1e-2, weight_decay=wd, clip_norm=clip, warmup_steps=2,
              total_steps=10)
    p, rp = _torch(params), _jax(params)
    st, rst = init_opt_state(p), r_init_opt_state(rp)
    for step in range(4):
        grads = _random_tree(rng, 2.0)
        p, st, met = adamw_update(AdamWConfig(**kw), p, _torch(grads), st,
                                  step)
        rp, rst, rmet = r_adamw_update(RAdamWConfig(**kw), rp, _jax(grads),
                                       rst, jnp.int32(step))
        assert float(met["grad_norm"]) == pytest.approx(
            float(rmet["grad_norm"]), rel=1e-6)
        assert float(met["lr"]) == pytest.approx(float(rmet["lr"]),
                                                 rel=1e-6)
        _close(p, rp)
        _close(st["m"], rst["m"])
        _close(st["v"], rst["v"])


def test_adamw_updates_in_place():
    p = {"w": torch.ones(3)}
    before = p["w"]
    st = init_opt_state(p)
    m_before = st["m"]["w"]
    p2, st2, _ = adamw_update(AdamWConfig(warmup_steps=0), p,
                              {"w": torch.full((3,), 0.5)}, st, 0)
    assert p2["w"] is before and st2["m"]["w"] is m_before
    assert not torch.equal(before, torch.ones(3))


# -- optimizer: the reference's behaviours --------------------------------------
def test_adamw_matches_manual_reference():
    cfg = AdamWConfig(lr=0.1, beta1=0.9, beta2=0.99, eps=1e-8,
                      weight_decay=0.0, clip_norm=1e9, warmup_steps=0,
                      schedule="constant")
    p = {"w": torch.tensor([1.0, -2.0])}
    g = {"w": torch.tensor([0.5, 0.5])}
    new_p, _, _ = adamw_update(cfg, p, g, init_opt_state(p), 0)
    m = 0.1 * 0.5
    v = 0.01 * 0.25
    expect = 1.0 - 0.1 * (m / (1 - 0.9)) / (np.sqrt(v / (1 - 0.99)) + 1e-8)
    assert float(new_p["w"][0]) == pytest.approx(expect, rel=1e-5)


def test_weight_decay_decoupled():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.5, clip_norm=1e9,
                      warmup_steps=0, schedule="constant")
    p = {"w": torch.tensor([2.0])}
    new_p, _, _ = adamw_update(cfg, p, {"w": torch.tensor([0.0])},
                               init_opt_state(p), 0)
    assert float(new_p["w"][0]) == pytest.approx(2.0 - 0.1 * 0.5 * 2.0)


def test_clip_by_global_norm():
    g = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(5.0)
    total = np.hypot(float(clipped["a"][0]), float(clipped["b"][0]))
    assert total == pytest.approx(1.0, rel=1e-5)


def test_lr_schedule_warmup_and_cosine():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=110,
                      min_lr_frac=0.1)
    assert float(schedule_lr(cfg, 0)) == pytest.approx(0.0)
    assert float(schedule_lr(cfg, 10)) == pytest.approx(1.0)
    assert float(schedule_lr(cfg, 110)) == pytest.approx(0.1, rel=1e-3)
