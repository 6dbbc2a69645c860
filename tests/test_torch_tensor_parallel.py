"""Tensor parallelism over the ``model`` axis: a rank computes only its
attention heads, MLP columns, vocabulary block, RG-LRU channels and
Mamba2 heads, and under ``seq_parallel`` holds its block of the sequence
between the sublayers (``repro_torch.distributed.tensor_parallel``,
``rank_local``'s gathered specs, ``ctx.ModelCut``).

One module fixture runs the reference in a subprocess (eight virtual CPU
devices) and, meanwhile, the port on eight gloo CPU ranks of the (2, 4)
("data", "model") mesh under ``make_rules(data_axes=("data",))``: the
rows cut over ``data``, heads, MLP columns, vocabulary and channels over
``model``.  Held here:

* every smoke family's rank-local train step in float32 against the
  reference's sharded ``jax.value_and_grad`` of ``loss_fn`` on the same
  mesh, weights and tokens (``jax.jit`` with the state's and the
  batch's shardings): the loss within ``LOSS_REL``, the gradient blocks
  at ``tests/test_torch_train.py``'s float32 tolerance between the
  frameworks (``F32``);
* tinyllama-1.1b, qwen2-moe-a2.7b, recurrentgemma-9b and mamba2-370m
  with ``seq_parallel`` (Megatron's sequence parallelism) on the port's
  side, held against the same reference entries (its ``constrain`` is a
  no-op outside ``axis_rules``, and sequence parallelism changes no
  value) and against the one-rank step, as below;
* every family's step against the port's one-rank step on each rank, in
  float64, so that only a wrong term can exceed the constants: the loss
  within ``LOSS_REL``, each gradient block within ``GRAD_REL`` of its
  leaf's largest magnitude, params, ``m`` and ``v`` after the step
  within ``STATE_ATOL`` (in float32 the one-rank step itself differs
  from its float64 step by more than ``GRAD_REL``, up to 6.6e-05 of a
  leaf's largest magnitude in tinyllama's smoke config,
  ``scripts/f32_rounding_gap.py``: a column and row product summed in
  another order moves the float32 gradient by as much);
* the collectives: the ``"tp"`` site's counts and result bytes equal to
  ``tensor_parallel.step_collectives``, the ``"state"`` all-gathers to
  ``rank_local.forward_gathers`` and the ``"grad"`` sums to
  ``rank_local.backward_sums``, per family;
* grouped-query attention with local heads: a rank's query heads fewer
  than a key head's group, as many, more, and neither a multiple nor a
  divisor; widths that the model extent does not divide stay whole;
* Megatron's operators, the vocabulary-parallel lookup, loss and
  argmax (a tie across blocks) against plain autograd on one rank;
* serving under ``make_rules(fsdp=False, data_axes=("data",))``: a
  rank holds its ``model`` blocks (``rank_local.serve_blocks``) and
  gathers nothing a token; qwen3-4b, qwen2-moe-a2.7b,
  recurrentgemma-9b and mamba2-370m (on its heads, the cache its heads'
  state) through the serve steps against the one-rank steps in float64,
  tokens equal and logits within ``SERVE_REL``;
* a remat recompute run on a fresh thread computes the same blocks;
* the dry run: a smoke train cell's flops a rank equal
  ``tensor_parallel.train_flops`` (tinyllama and mamba2, with and
  without ``seq_parallel``).
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest
import torch

from repro_torch import models as M
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.distributed import ctx as dctx
from repro_torch.distributed import launch, rank_local
from repro_torch.distributed import sharding as sh
from repro_torch.distributed import tensor_parallel as tpar
from repro_torch.distributed.mesh import (
    AbstractMesh, Mesh, all_gather_dim, cut)
from repro_torch.models import common as cm
from repro_torch.optim import AdamWConfig
from repro_torch.serve import make_prefill_step, make_serve_step
from repro_torch.serve.step import serving_cut
from repro_torch.train import TrainState, gradients, make_train_step
from repro_torch.utils.comm_stats import record_collectives
from repro_torch.utils.tree import tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 8
MESH = (2, 4)
#: Seconds either side may go without progress before it is killed.
TIMEOUT = 240
#: port against port (float64): test_torch_batch_cut.py's constants
LOSS_REL = 1e-6
GRAD_REL = 1e-5
STATE_ATOL = 2e-3
#: serving, port against port (float64: recurrentgemma's smoke decode in
#: float32 is 4.6e-05 off its float64 decode on one rank,
#: scripts/f32_rounding_gap.py): logits relative to their largest
#: magnitude
SERVE_REL = 1e-5
#: the port's gradient blocks against the reference's in float32
#: (test_torch_train.py's): the frameworks differ in summation order, by
#: up to 1.2e-4 of a leaf's largest magnitude here (recurrentgemma's smoke
#: model), above GRAD_REL; the loss is held at LOSS_REL
F32 = dict(rtol=1e-4, scale_atol=1e-4)
ARCHS = ["tinyllama-1.1b", "qwen3-4b", "qwen2-moe-a2.7b", "mamba2-370m",
         "recurrentgemma-9b", "internvl2-26b", "musicgen-large"]
#: the families run again with seq_parallel (case "<arch>-sp")
SP_ARCHS = ["tinyllama-1.1b", "qwen2-moe-a2.7b", "recurrentgemma-9b",
            "mamba2-370m"]
CASES = ARCHS + [f"{arch}-sp" for arch in SP_ARCHS]
#: local query heads against a key head's group on model 4: (name, heads,
#: key heads) with the heads a rank holds fewer than, as many as, more
#: than rep, and neither a multiple nor a divisor of it
GQA = [("fewer", 4, 1), ("equal", 8, 4), ("more", 16, 8), ("neither", 24, 6)]
#: (arch, prompt length, max_seq)
SERVE = [("qwen3-4b", 10, 64), ("qwen2-moe-a2.7b", 10, 64),
         ("recurrentgemma-9b", 40, 64), ("mamba2-370m", 10, 64)]
OPT = AdamWConfig(lr=3e-3, warmup_steps=0, total_steps=10)
BATCH, SEQ = 8, 16


def _rules():
    return sh.make_rules(data_axes=("data",))


def _serve_rules():
    return sh.make_rules(fsdp=False, data_axes=("data",))


def _config(arch, dtype="float32", **over):
    """``arch``'s smoke config; a case ``"<arch>-sp"`` with
    ``seq_parallel``."""
    if arch.endswith("-sp"):
        arch, over = arch[:-3], dict(over, seq_parallel=True)
    return dataclasses.replace(get_smoke_config(arch), dtype=dtype,
                               param_dtype=("float64" if dtype == "float64"
                                            else "float32"), **over)


def _tokens(cfg, seed: int, batch: int = BATCH, seq: int = SEQ):
    shape = (batch, seq) + ((cfg.num_codebooks,)
                            if cfg.num_codebooks > 1 else ())
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape))


def _state(cfg) -> TrainState:
    return TrainState.create(cfg, torch.Generator().manual_seed(0),
                             device="cpu")


def _units(cfg) -> int:
    return (cfg.num_layers // len(cfg.block_pattern)
            if cfg.family == "hybrid" else cfg.num_layers)


def _sums(rec, site) -> tuple:
    st = rec.stats(site)
    return sum(st.count.values()), int(st.total_result_bytes)


# -- the port's ranks ---------------------------------------------------------
def _f32_case(mesh, arch) -> dict:
    """The float32 TP step's loss and gradient blocks (held against the
    reference in the test) and its collectives."""
    cfg = _config(arch)
    layout = rank_local.layout_for(cfg, mesh, _rules())
    local = rank_local.shard_state(cfg, _state(cfg), layout)
    with record_collectives() as rec:
        m, g = gradients(cfg, local, {"tokens": _tokens(cfg, 1)})
    tp = layout.model_cut()
    return {"loss": float(m["loss"]),
            "grads": [t.numpy() for t in tree_leaves(g)],
            "model_cut": tp.axes if tp is not None else (),
            "tp": _sums(rec, "tp"), "state": _sums(rec, "state"),
            "grad": _sums(rec, "grad"),
            "body": _sums(rec, "body")[0] + _sums(rec, "boundary")[0]}


def _grad_err(mesh, layout, g1, g2) -> float:
    worst = 0.0
    for a, b, s in zip(tree_leaves(g1), tree_leaves(g2),
                       rank_local.spec_leaves(g2, layout.specs.params)):
        want = cut(mesh, a, s).double()
        scale = float(want.abs().max())
        err = float((b.double() - want).abs().max())
        worst = max(worst, err / scale if scale > 0 else err)
    return worst


def _f64_case(mesh, cfg, step: bool = True) -> dict:
    """The TP step against the one-rank step in float64: the loss, the
    gradient blocks, and with ``step`` the state after the step."""
    layout = rank_local.layout_for(cfg, mesh, _rules())
    batch = {"tokens": _tokens(cfg, 2)}
    one = _state(cfg)
    local = rank_local.shard_state(cfg, _state(cfg), layout)
    m1, g1 = gradients(cfg, one, batch)
    with record_collectives() as rec:
        m2, g2 = gradients(cfg, local, batch)
    out = {"loss": (float(m1["loss"]), float(m2["loss"])),
           "grad_rel": _grad_err(mesh, layout, g1, g2),
           "tp": _sums(rec, "tp"),
           "names": sorted(tpar.local_names(cfg, mesh, _rules())),
           "whole": [path for path, spec, g in rank_local._pairs(
               layout.specs.params, layout.gather_specs())
               if tuple(spec) == tuple(g)[:len(spec)]
               and path[-1] in ("w_gate", "w_up", "w_down", "embedding",
                                "lm_head")]}
    del g1, g2
    if not step:
        return out
    one, _ = make_train_step(cfg, OPT)(one, batch)
    local, _ = make_train_step(cfg, OPT)(local, batch)
    worst = 0.0
    for a, b, s in zip(
            tree_leaves({"params": one.params.param_tree(), "opt": one.opt}),
            tree_leaves({"params": local.params.param_tree(),
                         "opt": local.opt}),
            rank_local.spec_leaves(
                {"params": local.params.param_tree(), "opt": local.opt},
                {"params": layout.specs.params, "opt": layout.specs.opt})):
        worst = max(worst, float((b.detach() - cut(mesh, a, s).detach())
                                 .abs().max()))
    out["state_err"] = worst
    return out


def _operators(mesh) -> dict:
    """Megatron's operators and the vocabulary-parallel pieces on this
    rank's blocks against plain autograd of the whole (float64): the
    largest absolute difference of each value and gradient."""
    tp = dctx.ModelCut(mesh, ("model",))
    n, i = tp.n, tp.index
    g = torch.Generator().manual_seed(0)
    f64 = dict(dtype=torch.float64, generator=g)
    x, w1, w2 = (torch.randn(6, 8, **f64), torch.randn(8, 12, **f64),
                 torch.randn(12, 8, **f64))
    c = torch.randn(6, 8, **f64)
    out = {}
    # a column product, then a row product
    xs, w1s, w2s = (t.clone().requires_grad_() for t in (x, w1, w2))
    y = torch.tanh(xs @ w1s) @ w2s
    (y * c).sum().backward()
    b = 12 // n
    xb = x.clone().requires_grad_()
    w1b = w1[:, i * b:(i + 1) * b].clone().requires_grad_()
    w2b = w2[i * b:(i + 1) * b].clone().requires_grad_()
    yb = tpar.reduce_out(tp, torch.tanh(tpar.copy_in(tp, xb) @ w1b) @ w2b)
    (yb * c).sum().backward()
    y, yb = y.detach(), yb.detach()
    out["column_row"] = max(
        float((yb - y).abs().max()), float((xb.grad - xs.grad).abs().max()),
        float((w1b.grad - w1s.grad[:, i * b:(i + 1) * b]).abs().max()),
        float((w2b.grad - w2s.grad[i * b:(i + 1) * b]).abs().max()))
    # the lookup: V 16 rows, 4 a rank
    table = torch.randn(16, 8, **f64)
    toks = torch.randint(0, 16, (3, 5), generator=g)
    ts = table.clone().requires_grad_()
    e = ts[toks]
    (e * torch.ones_like(e).cumsum(-1)).sum().backward()
    v = 16 // n
    tb = table[i * v:(i + 1) * v].clone().requires_grad_()
    eb = tpar.reduce_out(tp, tpar.embed(tp, tb, toks))
    (eb * torch.ones_like(eb).cumsum(-1)).sum().backward()
    e, eb = e.detach(), eb.detach()
    out["embed"] = max(float((eb - e).abs().max()),
                       float((tb.grad - ts.grad[i * v:(i + 1) * v])
                             .abs().max()))
    # the loss: logsumexp - target logit, the maximum detached
    logits = torch.randn(3, 5, 16, **f64) * 4
    ls = logits.clone().requires_grad_()
    lmax = ls.amax(-1, keepdim=True).detach()
    per = (torch.log(torch.exp(ls - lmax).sum(-1)) + lmax[..., 0]
           - torch.gather(ls, -1, toks[..., None])[..., 0])
    per.mean().backward()
    lb = logits[..., i * v:(i + 1) * v].clone().requires_grad_()
    perb = tpar.cross_entropy(tp, lb, toks)
    perb.mean().backward()
    per, perb = per.detach(), perb.detach()
    out["loss"] = max(float((perb - per).abs().max()),
                      float((lb.grad - ls.grad[..., i * v:(i + 1) * v])
                            .abs().max()))
    # the argmax: ties inside a block and across blocks go to the lowest
    # global index
    arg = torch.randn(4, 16, **f64)
    arg[0, 2] = arg[0, 9] = 50.0                # across blocks 0 and 2
    arg[1, 13] = 50.0                           # one maximum, block 3
    arg[2, 5] = arg[2, 6] = 50.0                # inside block 1
    arg[3, 7] = arg[3, 11] = arg[3, 15] = 50.0  # blocks 1, 2, 3
    got = tpar.argmax(tp, arg[:, i * v:(i + 1) * v])
    out["argmax"] = (got.tolist(), torch.argmax(arg, -1).tolist())
    return out


def _remat_thread(mesh) -> bool:
    """tinyllama's TP gradient (float64, remat full, blocks of layers)
    with the backward on this thread and on a fresh one (an empty
    context, as the autograd engine's device thread): bit-equal."""
    cfg = _config("tinyllama-1.1b", "float64", num_layers=4)
    layout = rank_local.layout_for(cfg, mesh, _rules())
    local = rank_local.shard_state(cfg, _state(cfg), layout)
    row = layout.row_cut(cfg, {"tokens": _tokens(cfg, 3)})
    toks = row.take(_tokens(cfg, 3))
    got, errors = [], []
    for thread in (False, True):
        grads = M.bind_grads(cfg, local.params)

        def backward(loss):
            try:
                loss.backward()
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(repr(e))
        with dctx.row_cut(row), dctx.model_cut(layout.model_cut()):
            loss, _ = M.loss_fn(cfg, local.params, {"tokens": toks})
            if not thread:
                backward(loss)
        if thread:
            t = threading.Thread(target=backward, args=(loss,))
            t.start()
            t.join()
        for p in local.params.parameters():
            p.grad = None
        got.append([g.clone() for g in tree_leaves(grads)])
    return not errors and all(torch.equal(a, b) for a, b in zip(*got))


def _gather_logits(mesh, c, logits, tp):
    """The global logits from a rank's rows and vocabulary block."""
    if tp is not None:
        logits = all_gather_dim(mesh, logits, tp.axes, logits.dim() - 1)
    return logits if c is None else c.gather(logits)


def _serve(mesh, arch, prompt_len, max_seq) -> dict:
    """Prefill and two decode steps through the serve steps, a rank's
    blocks of the parameters under the no-FSDP rules, against the
    one-rank steps, float64: the tokens, and a third step's logits."""
    cfg = _config(arch, "float64")
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    rules = _serve_rules()
    layout = rank_local.layout_for(cfg, mesh, rules)
    blocks = rank_local.serve_blocks(cfg, params, layout)
    prompt = _tokens(cfg, 3, batch=4, seq=prompt_len)
    runs = {}
    for name, p in (("one", params), ("tp", blocks)):
        ctx = (dctx.axis_rules(mesh, rules) if name == "tp"
               else dctx.row_cut(None))
        with ctx, record_collectives() as rec:
            tok, cache = make_prefill_step(cfg, max_seq)(p, prompt)
            toks = [tok]
            step = make_serve_step(cfg, max_seq)
            for k in range(2):
                tok, cache = step(p, cache, tok, prompt_len + k)
                toks.append(tok)
            c = serving_cut(cfg, 4, max_seq)
            tp = layout.model_cut() if name == "tp" else None
            with dctx.row_cut(c), dctx.model_cut(tp):
                logits, _ = M.decode_step(
                    cfg, p, cache, tok if c is None else c.take(tok),
                    prompt_len + 2)
                logits = _gather_logits(mesh, c, logits, tp)
        runs[name] = (torch.stack(toks, 1), logits, _sums(rec, "state"),
                      _sums(rec, "tp"))
    one, got = runs["one"], runs["tp"]
    return {"tokens_equal": torch.equal(one[0], got[0]),
            "logits_rel": float((got[1] - one[1]).abs().max()
                                / one[1].abs().max()),
            "state": got[2], "tp": got[3],
            "model_cut": layout.model_cut().axes,
            "held": sum(t.numel() for t in blocks.parameters()),
            "whole": sum(t.numel() for t in params.parameters())}


def _port_rank(rank, report):
    torch.set_num_threads(1)
    mesh = Mesh(MESH, ("data", "model"), backend="gloo", device="cpu")
    out = {"f32": {}, "f64": {}, "gqa": {}}
    for case in CASES:
        out["f32"][case] = _f32_case(mesh, case)
        out["f64"][case] = _f64_case(mesh, _config(case, "float64"))
        report(f"rank {rank}: {case}")
    for name, h, k in GQA:
        out["gqa"][name] = _f64_case(mesh, _config(
            "tinyllama-1.1b", "float64", num_heads=h, num_kv_heads=k),
            step=False)
    out["whole"] = _f64_case(mesh, _config(
        "tinyllama-1.1b", "float64", d_ff=126, vocab_size=130), step=False)
    out["operators"] = _operators(mesh)
    out["thread"] = _remat_thread(mesh)
    out["serve"] = {arch: _serve(mesh, arch, n, s) for arch, n, s in SERVE}
    return out


# -- the reference ------------------------------------------------------------
REFERENCE = """
import sys, dataclasses
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as PS
from repro.configs import get_smoke_config
from repro import models as RM
from repro.distributed import sharding as sh

x = dict(np.load(sys.argv[1]))
archs = sys.argv[3].split(",")
mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
rules = sh.make_rules(data_axes=("data",))
out = {}
for arch in archs:
    tree = {}
    for key, val in x.items():
        if key.startswith(arch + "/p/"):
            *path, leaf = key[len(arch) + 3:].split("/")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(val)
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    p_sh = sh.tree_shardings_for(tree, RM.logical_axes(cfg), mesh, rules)
    b_sh = {"tokens": NamedSharding(mesh, PS("data"))}
    fn = jax.value_and_grad(lambda p, b: RM.loss_fn(cfg, p, b), has_aux=True)
    with mesh:
        (loss, _), grads = jax.jit(fn, in_shardings=(p_sh, b_sh))(
            tree, {"tokens": jnp.asarray(x[arch + "/tokens"])})
    out[arch + "/loss"] = np.asarray(loss, np.float32)
    for i, g in enumerate(jax.tree.leaves(grads)):
        out[f"{arch}/g{i}"] = np.asarray(g, np.float32)
np.savez(sys.argv[2], **out)
"""


def _flat(tree, prefix):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _inputs() -> dict:
    x = {}
    for arch in ARCHS:
        cfg = _config(arch)
        x[f"{arch}/tokens"] = _tokens(cfg, 1).numpy().astype(np.int32)
        x.update(_flat(M.params_to_reference(_state(cfg).params),
                       f"{arch}/p/"))
    return x


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tensor_parallel")
    inpath, refpath = str(tmp / "inputs.npz"), str(tmp / "reference.npz")
    np.savez(inpath, **_inputs())
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    ref_proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REFERENCE), inpath, refpath,
         ",".join(ARCHS)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=REPO)
    try:
        port = launch.run(_port_rank, WORLD, backend="gloo", device="cpu",
                          timeout=TIMEOUT)
        _, err = ref_proc.communicate(timeout=TIMEOUT)
    finally:
        if ref_proc.poll() is None:
            ref_proc.kill()
            ref_proc.communicate()
    assert ref_proc.returncode == 0, err[-4000:]
    return dict(np.load(refpath)), port


def _block(a: np.ndarray, spec, rank: int) -> np.ndarray:
    """Rank ``rank``'s block of the global ``a`` under ``spec`` on the
    (2, 4) mesh."""
    coords = dict(zip(("data", "model"), np.unravel_index(rank, MESH)))
    shape = dict(zip(("data", "model"), MESH))
    for dim, e in enumerate(spec):
        if e is None:
            continue
        axes = (e,) if isinstance(e, str) else e
        idx, n = 0, 1
        for ax in axes:
            idx, n = idx * shape[ax] + int(coords[ax]), n * shape[ax]
        size = a.shape[dim] // n
        a = np.take(a, range(idx * size, (idx + 1) * size), axis=dim)
    return a


# -- the train step -----------------------------------------------------------
@pytest.mark.parametrize("arch", CASES)
def test_tp_step_matches_the_reference_sharded_step(sides, arch):
    """Each rank's loss and gradient blocks against the reference's
    sharded value_and_grad on the same mesh, float32 (a ``-sp`` case
    against the same entries as its arch's)."""
    ref, port = sides
    cfg = _config(arch)
    name = arch.removesuffix("-sp")
    layout = rank_local.layout_for(cfg, AbstractMesh(MESH, ("data",
                                                            "model")),
                                   _rules())
    specs = rank_local.spec_leaves(layout.specs.params,
                                   layout.specs.params)
    want_loss = float(ref[f"{name}/loss"])
    worst = 0.0
    for rank, got in enumerate(port):
        case = got["f32"][arch]
        assert case["model_cut"] == ("model",)
        assert abs(case["loss"] - want_loss) <= LOSS_REL * want_loss
        for i, (g, spec) in enumerate(zip(case["grads"], specs)):
            want = _block(ref[f"{name}/g{i}"], spec, rank)
            scale = float(np.abs(want).max())
            if scale > 0:
                worst = max(worst, float(np.abs(g - want).max()) / scale)
            np.testing.assert_allclose(
                g, want, rtol=F32["rtol"],
                atol=F32["scale_atol"] * max(float(np.abs(want).max()),
                                             1e-30),
                err_msg=f"{arch} rank {rank} leaf {i}")
    rel = abs(port[0]["f32"][arch]["loss"] - want_loss) / want_loss
    print(f"{arch}: loss rel {rel:.2e}, worst gradient block {worst:.2e} "
          f"of its leaf's largest magnitude")


@pytest.mark.parametrize("arch", CASES)
def test_tp_step_matches_one_rank(sides, arch):
    """Float64: every rank's loss, gradient blocks and state after the
    step against the one-rank step's."""
    for rank, got in enumerate(sides[1]):
        case = got["f64"][arch]
        a, b = case["loss"]
        assert abs(a - b) <= LOSS_REL * abs(a), (rank, a, b)
        assert case["grad_rel"] <= GRAD_REL, (rank, case["grad_rel"])
        assert case["state_err"] <= STATE_ATOL, (rank, case["state_err"])


@pytest.mark.parametrize("arch", CASES)
def test_collectives_are_the_arithmetic(sides, arch):
    """The step's ``"tp"`` collectives (row products' sums, column
    products' input gradients, the lookup and the loss; under
    ``seq_parallel`` the sequence's all-gathers and reduce-scatters) are
    ``step_collectives``; the weights' all-gathers over ``data`` only
    (Mamba2's ``in_proj`` and conv over ``model`` too) are
    ``forward_gathers`` a unit forward (the recomputes included); the
    gradient's sums over the rows are ``backward_sums``; nothing at the
    body or the boundary."""
    cfg = _config(arch)
    mesh = AbstractMesh(MESH, ("data", "model"))
    layout = rank_local.layout_for(cfg, mesh, _rules())
    names = tpar.local_names(cfg, mesh, _rules())
    units = _units(cfg)
    runs = cm.layer_forward_runs(cfg, units)
    g = rank_local.forward_gathers(cfg, layout)
    s = rank_local.backward_sums(cfg, layout, ("data",))
    want = {"tp": tpar.step_collectives(cfg, names, 4, BATCH // 2, SEQ),
            "state": (runs * g["unit"][0] + g["rest"][0],
                      runs * g["unit"][1] + g["rest"][1]),
            "grad": (units * s["unit"][0] + s["rest"][0] + s["whole"][0],
                     units * s["unit"][1] + s["rest"][1] + s["whole"][1])}
    for rank, got in enumerate(sides[1]):
        case = got["f32"][arch]
        for site in ("tp", "state", "grad"):
            assert case[site] == tuple(want[site]), (rank, site)
        assert case["body"] == 0
    assert want["tp"][0] > 0


@pytest.mark.parametrize("name", [c[0] for c in GQA])
def test_local_query_heads_against_their_key_heads(sides, name):
    """A rank's query heads and the key heads they use (H / 4 of rep =
    H / K: fewer, as many, more, neither a multiple nor a divisor): the
    one-rank step's, float64."""
    for rank, got in enumerate(sides[1]):
        case = got["gqa"][name]
        assert "heads" in case["names"]
        a, b = case["loss"]
        assert abs(a - b) <= LOSS_REL * abs(a), (rank, a, b)
        assert case["grad_rel"] <= GRAD_REL, (rank, case["grad_rel"])


def test_widths_that_do_not_divide_stay_whole(sides):
    """d_ff 126 and a vocabulary of 130 on model 4: the MLP and the
    embedding are gathered whole and computed whole, the heads cut; the
    one-rank step's, float64, with only the attention's collectives."""
    cfg = _config("tinyllama-1.1b", "float64", d_ff=126, vocab_size=130)
    mesh = AbstractMesh(MESH, ("data", "model"))
    names = tpar.local_names(cfg, mesh, _rules())
    for rank, got in enumerate(sides[1]):
        case = got["whole"]
        assert case["names"] == ["heads", "mlp", "vocab"]
        assert sorted(p[-1] for p in case["whole"]) == [
            "embedding", "lm_head", "w_down", "w_gate", "w_up"]
        a, b = case["loss"]
        assert abs(a - b) <= LOSS_REL * abs(a), (rank, a, b)
        assert case["grad_rel"] <= GRAD_REL, (rank, case["grad_rel"])
        assert case["tp"] == tpar.step_collectives(cfg, names, 4,
                                                   BATCH // 2, SEQ)
    c = tpar.collectives(cfg, names, 4, BATCH // 2, SEQ)
    assert c["unit"]["fwd"][0] == 1 and c["rest"]["fwd"][0] == 0


def test_megatron_operators_against_plain_autograd(sides):
    """copy-in / reduce-out around a column and a row product, the
    vocabulary-parallel lookup and loss: values and gradients within
    float64 rounding; the argmax gives torch.argmax's index, ties
    included."""
    for rank, got in enumerate(sides[1]):
        ops = got["operators"]
        for key in ("column_row", "embed", "loss"):
            assert ops[key] <= 1e-12, (rank, key, ops[key])
        got_arg, want_arg = ops["argmax"]
        assert got_arg == want_arg == [2, 13, 5, 7], rank


def test_remat_recompute_on_a_fresh_thread_computes_the_same_blocks(sides):
    """A backward started on a fresh thread (no context there) recomputes
    each checkpointed region under the forward's model cut: the gradient
    blocks bit-equal to the calling thread's."""
    assert all(got["thread"] for got in sides[1])


# -- serving ------------------------------------------------------------------
@pytest.mark.parametrize("arch", [s[0] for s in SERVE])
def test_serve_steps_on_model_blocks_match_one_rank(sides, arch):
    """A rank's ``model`` blocks under the no-FSDP rules: prefill and
    decode give the one-rank tokens and logits, and no weight is gathered
    over data (the MoE smoke's 6 routed experts do not divide model 4:
    held whole); Mamba2 on its heads, its ``in_proj`` and conv gathered
    over ``model``."""
    cfg = _config(arch)
    mesh = AbstractMesh(MESH, ("data", "model"))
    names = tpar.local_names(cfg, mesh, _serve_rules())
    # four forwards (the prefill, two decode steps, the last logits), each
    # reading every weight once: gathers of Mamba2's in_proj and conv
    # only
    f64 = _config(arch, "float64")
    g = rank_local.forward_gathers(
        f64, rank_local.layout_for(f64, mesh, _serve_rules()))
    want_state = tuple(4 * (_units(f64) * g["unit"][i] + g["rest"][i])
                       for i in (0, 1))
    assert (want_state[0] > 0) == (arch == "mamba2-370m")
    print(arch, "logits rel", [got["serve"][arch]["logits_rel"]
                               for got in sides[1]])
    for rank, got in enumerate(sides[1]):
        s = got["serve"][arch]
        assert s["model_cut"] == ("model",)
        assert s["tokens_equal"], rank
        assert s["logits_rel"] <= SERVE_REL, (rank, s["logits_rel"])
        assert s["held"] < s["whole"]
        assert s["state"] == want_state, rank
        assert s["tp"][0] > 0
    assert ({"ssm_inner", "vocab"} if arch == "mamba2-370m"
            else {"heads", "mlp", "vocab"}) <= names


def test_serve_collectives_are_the_arithmetic():
    """A decode step's ``"tp"`` collectives on the cut cache are
    ``serve_collectives`` (the dry run's trace on a fake world)."""
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.config import ShapeConfig
    args = D.parser().parse_args(["--arch", "-", "--shape", "-"])
    for kind, seq in (("prefill", 32), ("decode", 64)):
        cfg = get_smoke_config("qwen3-4b", kernel_impl="torch")
        with D.fake_world(8):
            mesh = make_mesh(MESH, ("data", "model"))
            rules = D._rules_for(mesh, args)
            with dctx.axis_rules(mesh, rules):
                trace, _ = D.lower_cell(cfg, ShapeConfig("t", kind, seq, 8),
                                        mesh, args)
        names = tpar.local_names(cfg, mesh, rules)
        want = tpar.serve_collectives(
            cfg, names, 4, 4, 1 if kind == "decode" else seq, kind,
            seq_cut=True)
        assert _sums(trace.collectives, "tp") == want, kind


# -- the dry run, rules and layouts -------------------------------------------
@pytest.mark.parametrize("over,mb", [
    ({}, 1), ({"remat": "none"}, 1), ({"num_layers": 4}, 2),
    ({"arch": "mamba2-370m"}, 1), ({"seq_parallel": True}, 1),
    ({"arch": "mamba2-370m", "seq_parallel": True, "remat": "none"}, 1)])
def test_dry_run_flops_are_the_tp_arithmetic(over, mb):
    """A smoke train cell on (2, 4): the products a rank traces are
    ``train_flops`` of its heads, columns and vocabulary block (k and v
    whole; Mamba2's heads, B and C whole), and its ``"tp"`` collectives
    ``step_collectives``; ``seq_parallel`` moves no product."""
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.config import ShapeConfig
    over = dict(over)
    cfg = dataclasses.replace(
        get_smoke_config(over.pop("arch", "tinyllama-1.1b"),
                         kernel_impl="torch"), **over)
    args = D.parser().parse_args(["--arch", "-", "--shape", "-",
                                  "--microbatches", str(mb)])
    sc = ShapeConfig("t", "train", 32, 8)
    with D.fake_world(8):
        mesh = make_mesh(MESH, ("data", "model"))
        rules = D._rules_for(mesh, args)
        with dctx.axis_rules(mesh, rules):
            trace, _ = D.lower_cell(cfg, sc, mesh, args)
            got = D.analyze(trace)
    names = tpar.local_names(cfg, mesh, rules)
    rows = sc.global_batch // mb // 2
    assert got["flops"] == tpar.train_flops(cfg, names, 4, rows, 32, mb)
    whole = tpar.train_flops(cfg, frozenset(), 1, rows, 32, mb)
    assert got["flops"] < whole
    tp = got["collectives_by_site"]["tp"]
    assert (sum(tp["count"].values()), sum(tp["result_bytes"].values())) \
        == tpar.step_collectives(cfg, names, 4, rows, 32, mb)
    if cfg.seq_parallel:
        assert got["flops"] == tpar.train_flops(
            dataclasses.replace(cfg, seq_parallel=False), names, 4, rows,
            32, mb)
        assert tp["count"].get("reduce-scatter", 0) > 0


def test_local_names_follow_the_rules():
    """Heads, MLP columns, the vocabulary, the RG-LRU's channels and
    Mamba2's heads are computed as blocks where the rules cut them over
    an axis of more than one rank, the heads under ring attention too
    (the ring trades a rank's heads for a sequence block) and under
    sequence parallelism (the same names); a rule set with no model
    entries keeps them whole, and so does an extent that does not divide
    the width (Mamba2's heads, its vocabulary).  Mamba2 reads
    ``out_proj`` and its norm as their blocks, ``in_proj`` and the conv
    whole."""
    mesh = AbstractMesh(MESH, ("data", "model"))
    dense = get_smoke_config("tinyllama-1.1b")
    hybrid = get_smoke_config("recurrentgemma-9b")
    assert tpar.local_names(dense, mesh, _rules()) == {"heads", "mlp",
                                                       "vocab"}
    assert tpar.local_names(hybrid, mesh, _rules()) == {
        "heads", "mlp", "vocab", "rnn"}
    none = sh.make_rules(fsdp_axes=("data", "model"), model_axis="tp")
    assert tpar.local_names(dense, mesh, none) == frozenset()
    ssm = get_smoke_config("mamba2-370m")
    assert tpar.local_names(ssm, mesh, _rules()) == {"ssm_inner", "vocab"}
    assert tpar.local_names(dataclasses.replace(dense, ring_attention=True),
                            mesh, _rules()) == {"heads", "mlp", "vocab"}
    for cfg in (dense, hybrid, ssm):
        sp = dataclasses.replace(cfg, seq_parallel=True)
        assert tpar.local_names(sp, mesh, _rules()) == \
            tpar.local_names(cfg, mesh, _rules())
    big = AbstractMesh((16, 16), ("data", "model"))
    full = get_config("mamba2-370m")
    # 32 heads on 16: 2 a rank; the tied 50,280 rows do not divide by 16,
    # so sanitize keeps the vocabulary whole
    names = tpar.local_names(full, big, _rules())
    assert names == {"ssm_inner", "vocab"}
    assert tpar._cut(full, names, 16)["ssm"] == 2
    assert tpar._cut(full, names, 16)["vocab"] == full.vocab_size
    assert tpar.local_names(dataclasses.replace(ssm, ssm_headdim=64),
                            mesh, _rules()) == {"vocab"}     # 2 heads
    g = rank_local.layout_for(ssm, mesh, _rules()).gather_specs()["layers"]
    PS = sh.PartitionSpec
    assert g["out_proj"] == PS(None, None, "data")
    assert g["norm"] == PS(None, None)
    assert g["in_proj"] == PS(None, "data", "model")
    assert g["conv_b"] == PS(None, "model")
    assert tpar.local_names(dense, AbstractMesh((8, 1), ("data", "model")),
                            _rules()) == frozenset()


def test_sequence_parallelism_applies_where_the_sequence_divides():
    """``seq_parallel`` under a model cut of 4: a sequence of 16 runs
    sequence-parallel; a decode step (1 position) or 18 positions run as
    TP alone (the reference's sanitize drops the axis); with ring
    attention or expert parallelism it raises, naming them."""
    mesh = AbstractMesh(MESH, ("data", "model"))
    dense = dataclasses.replace(get_smoke_config("tinyllama-1.1b"),
                                seq_parallel=True)
    moe = dataclasses.replace(get_smoke_config("qwen2-moe-a2.7b"),
                              seq_parallel=True)
    with dctx.model_cut(dctx.ModelCut(mesh, ("model",))):
        for cfg, seq, want in ((dense, 16, True), (dense, 1, False),
                               (dense, 18, False), (moe, 16, True)):
            with tpar.sequence_parallel(cfg, seq) as on:
                assert on == want
                assert (tpar.seq_cut() is not None) == want
        for over, name in (({"ring_attention": True}, "ring_attention"),
                           ({"moe_impl": "ep"}, "moe_impl='ep'")):
            with pytest.raises(ValueError, match=name):
                with tpar.sequence_parallel(
                        dataclasses.replace(moe, **over), 16):
                    pass
    with tpar.sequence_parallel(dense, 16) as on:      # no model cut
        assert not on


def test_a_model_leaf_is_gathered_over_its_other_axes_only():
    """``wq`` (D, H, Dh) on ("data", "model"): gathered over data, read
    as its block of heads; ``wk`` (no axis on model) gathered whole; the
    layout's model cut is the model axis; a forward's gathers are the
    block grown over data."""
    mesh = AbstractMesh(MESH, ("data", "model"))
    cfg = get_smoke_config("tinyllama-1.1b")
    layout = rank_local.layout_for(cfg, mesh, _rules())
    PS = sh.PartitionSpec
    attn = layout.gather_specs()["layers"]["attn"]
    assert layout.specs.params["layers"]["attn"]["wq"] == \
        PS(None, "data", "model")
    assert attn["wq"] == PS(None, "data", None)
    assert attn["wk"] == layout.specs.params["layers"]["attn"]["wk"]
    assert layout.model_cut() == dctx.ModelCut(mesh, ("model",))
    whole = rank_local.Layout(mesh, layout.specs, _rules())
    assert whole.model_cut() is None
    n, nbytes = rank_local.forward_gathers(cfg, layout)["unit"]
    n0, nbytes0 = rank_local.forward_gathers(cfg, whole)["unit"]
    assert n < n0 and nbytes < nbytes0


@pytest.mark.parametrize("spec,rows,want", [
    # gathered over both axes: the model dim cut (every rank along model
    # holds the same cotangent), the data dim reduce-scattered
    (("data", "model"), ("data",),
     [("cut", 1, ("model",)), ("reduce-scatter", 0, ("data",))]),
    # the model dim is the rank's block already (its gathered spec): only
    # the data dim's sum
    (("data", None), ("data",), [("reduce-scatter", 0, ("data",))]),
    # an entry that mixes the row axis with model: all-reduce, then cut
    ((("data", "model"), None), ("data",),
     [("all-reduce", None, ("data",)), ("cut", 0, ("data", "model"))]),
    # sharded over model only, gathered: a cut and the rows' all-reduce
    ((None, "model"), ("data",),
     [("cut", 1, ("model",)), ("all-reduce", None, ("data",))]),
])
def test_sum_plan_of_a_gathered_spec(spec, rows, want):
    """The gather's backward plan on the spec a leaf is gathered by: a
    dim the rank computes a block of is left out of it, so its cotangent
    is never cut again."""
    mesh = AbstractMesh(MESH, ("data", "model"))
    assert rank_local._sum_plan(mesh, sh.PartitionSpec(*spec), rows) == want
