"""A rank computes only its rows of the batch: the port's train step and
serving on gloo CPU ranks with the batch cut over the mesh's data axes
(``rank_local.Layout.row_cut``, ``serve.step.serving_cut``,
``distributed.ctx.RowCut``).

One module fixture runs the reference in a subprocess (one CPU device)
and, meanwhile, the port on eight gloo CPU ranks; every rank reports its
own numbers.  Held here:

* port against port on the (2, 4) ("data", "model") mesh, each rank on
  its 4 rows of the batch of 8, under rules that cut the rows over
  ``data`` and put nothing on ``model``: every smoke family's rank-local
  step
  against the port's one-rank step on the same weights and tokens, in
  float32 (in bfloat16 a weight's gradient over a rank's rows is rounded
  to bfloat16 before the sum over the ranks, one rounding more than the
  one-rank step takes): the loss within ``LOSS_REL``, each gradient
  block within ``GRAD_REL`` of its leaf's largest magnitude; params,
  ``m`` and ``v`` after the step within the reference gate's
  ``STATE_ATOL`` (AdamW's first update is close to ``lr * sign(g)``, so
  an element whose gradient is near 0 may move the other way), and how
  many entries differ by more than 1e-6 is reported; the gradient's sums
  (the ``"grad"`` site) as ``rank_local.backward_sums`` counts them;
* in bfloat16, tinyllama's rows-cut steps bit-equal to the one-rank
  steps with the batch in two microbatches of a rank's rows (which round
  each gradient where the cut does): losses and gradient blocks, the
  norm to its summation order;
* the MoE with a capacity that drops tokens: each rank's routing of its
  rows keeps the entries, and gives them the slots, of the one-rank
  routing of the whole batch; the router's gradient from ``aux`` alone
  against the one-rank one (``aux`` is the same on every rank: its
  ``psum``'s backward is a ``psum``);
* a batch that does not divide an axis (3 rows on data 2; 2 rows on the
  (2, 2, 2) ("pod", "data", "model") mesh, which cut over ``pod`` only):
  the rows stay whole over that axis and the gradient is the one-rank
  step's, not counted twice;
* expert parallelism and ring attention in a rows-cut step under
  ``axis_rules``: against the same world's step on global tensors, and
  ``remat="full"`` bit-equal to ``remat="none"``;
* the reference's seq-sharded decode (``tests/test_multidevice.py``):
  qwen3-4b's smoke decode at position 3 with the cache cut ``(None,
  "data", None, "model")`` on (2, 4) against the reference's replicated
  decode within 2e-3 (float32 in both); and per family, prefill and two
  decode steps through the serve steps under ``axis_rules`` against the
  one-rank ones, tokens equal and logits within ``SERVE_REL``.

This module imports neither JAX nor ``repro`` (only the reference's
subprocess does).
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import models as M
from repro_torch.configs import get_smoke_config
from repro_torch.distributed import ctx as dctx
from repro_torch.distributed import launch, rank_local
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.mesh import Mesh, cut
from repro_torch.optim import AdamWConfig
from repro_torch.serve import make_prefill_step, make_serve_step
from repro_torch.serve.step import cache_specs, serving_cut
from repro_torch.train import TrainState, gradients, make_train_step
from repro_torch.utils.comm_stats import record_collectives
from repro_torch.utils.tree import tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 8
MESH = (2, 4)
#: Seconds either side may go without progress before it is killed.
TIMEOUT = 240
#: port against port, float32: the loss (a mean over the ranks' means of
#: equal row blocks) and each gradient block (summed over the ranks in
#: another order), relative to the leaf's largest magnitude
LOSS_REL = 1e-6
GRAD_REL = 1e-5
#: the state after the step: the reference gate's parameter tolerance
STATE_ATOL = 2e-3
#: the reference's seq-sharded decode test's tolerance
DECODE_ATOL = 2e-3
#: serving, port against port, float32: logits relative to their largest
#: magnitude (the decode's softmax combined over the cache's blocks)
SERVE_REL = 1e-5
ARCHS = ["tinyllama-1.1b", "qwen3-4b", "qwen2-moe-a2.7b", "mamba2-370m",
         "recurrentgemma-9b", "internvl2-26b", "musicgen-large"]
#: (name, arch, config overrides, microbatches)
CASES = [(a, a, {}, 1) for a in ARCHS] + [
    ("tinyllama-1.1b/remat-none", "tinyllama-1.1b", {"remat": "none"}, 1),
    ("tinyllama-1.1b/microbatches-2", "tinyllama-1.1b", {}, 2),
    ("qwen2-moe-a2.7b/drops", "qwen2-moe-a2.7b",
     {"moe_capacity_factor": 0.5}, 1)]
#: serving families: (arch, prompt length, max_seq)
#: (recurrentgemma's prefill returns a cache of min(window, prompt) slots,
#: as the reference's: a prompt past its window of 32 keeps the window)
SERVE = [("qwen3-4b", 10, 64), ("qwen2-moe-a2.7b", 10, 64),
         ("mamba2-370m", 10, 64), ("recurrentgemma-9b", 40, 64)]
OPT = AdamWConfig(lr=3e-3, warmup_steps=0, total_steps=10)


def _rules():
    """The rows cut over ``data`` and nothing on ``model`` (the
    reference's ``make_rules`` with its model axis one the mesh lacks):
    every weight is gathered whole, so a rank's rows are computed as the
    one-rank step computes them; the ranks along ``model`` computing
    blocks of the heads and columns are
    ``tests/test_torch_tensor_parallel.py``'s."""
    return sh.make_rules(data_axes=("data",), model_axis="tp")


def _config(arch, **over):
    return dataclasses.replace(get_smoke_config(arch), dtype="float32",
                               **over)


def _tokens(cfg, seed: int, batch: int = 8, seq: int = 16):
    shape = (batch, seq) + ((cfg.num_codebooks,)
                            if cfg.num_codebooks > 1 else ())
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape))


def _state(cfg) -> TrainState:
    return TrainState.create(cfg, torch.Generator().manual_seed(0),
                             device="cpu")


def _state_leaves(state):
    return tree_leaves({"params": state.params.param_tree(),
                        "opt": state.opt})


def _state_specs(layout, state):
    return rank_local.spec_leaves(
        {"params": state.params.param_tree(), "opt": state.opt},
        {"params": layout.specs.params, "opt": layout.specs.opt})


def _grad_err(mesh, layout, g1, g2) -> float:
    """The largest gradient-block error over the leaves, relative to each
    leaf's largest magnitude."""
    worst = 0.0
    for a, b, s in zip(tree_leaves(g1), tree_leaves(g2),
                       rank_local.spec_leaves(g2, layout.specs.params)):
        want = cut(mesh, a, s).double()
        scale = float(want.abs().max())
        err = float((b.double() - want).abs().max())
        worst = max(worst, err / scale if scale > 0 else err)
    return worst


def _cut_case(mesh, rules, cfg, tokens, microbatches) -> dict:
    """A rank-local step on ``mesh`` against the one-rank step: the loss,
    the gradient blocks, the state after the step and the gradient's
    sums."""
    layout = rank_local.layout_for(cfg, mesh, rules)
    one = _state(cfg)
    local = rank_local.shard_state(cfg, _state(cfg), layout)
    batch = {"tokens": tokens}
    m1, g1 = gradients(cfg, one, batch, microbatches=microbatches)
    with record_collectives() as rec:
        m2, g2 = gradients(cfg, local, batch, microbatches=microbatches)
    row_cut = layout.row_cut(cfg, batch, microbatches)
    out = {"rows": row_cut.rows if row_cut is not None else (),
           "loss": (float(m1["loss"]), float(m2["loss"])),
           "grad_rel": _grad_err(mesh, layout, g1, g2),
           "grad_site": (rec.stats("grad").count,
                         rec.stats("grad").result_bytes),
           "rows_site": rec.stats("rows").count}
    del g1, g2
    step = make_train_step(cfg, OPT, microbatches=microbatches)
    one, _ = step(one, batch)
    local, _ = step(local, batch)
    worst, n_big, n_all = 0.0, 0, 0
    for a, b, s in zip(_state_leaves(one), _state_leaves(local),
                       _state_specs(layout, local)):
        diff = (b.detach().double() - cut(mesh, a, s).detach().double()).abs()
        worst = max(worst, float(diff.max()))
        n_big += int((diff > 1e-6).sum())
        n_all += diff.numel()
    out.update(state_err=worst, state_big=n_big, state_n=n_all)
    return out


def _two_microbatches(mesh, rules) -> list:
    """tinyllama's smoke config (bfloat16 activations), 4 layers in blocks
    of 2, three steps of phase 18's schedule (2 warmup steps): the rows
    cut against the one-rank step with the batch in two microbatches,
    slice i the rows of data index i, which rounds every gradient where
    the cut does: per step, whether the losses, norms and every gradient
    block are bit-equal."""
    cfg = dataclasses.replace(get_smoke_config("tinyllama-1.1b"),
                              num_layers=4)
    layout = rank_local.layout_for(cfg, mesh, rules)
    opt = AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=8)
    one = TrainState.create(cfg, torch.Generator().manual_seed(0),
                            device="cpu", weight_std=0.02)
    local = rank_local.init_state(cfg, layout,
                                  torch.Generator().manual_seed(0),
                                  device="cpu", weight_std=0.02)
    two, cut_step = (make_train_step(cfg, opt, microbatches=2),
                     make_train_step(cfg, opt))
    out = []
    for i in range(3):
        batch = {"tokens": _tokens(cfg, 20 + i, seq=32)}
        m1, g1 = gradients(cfg, one, batch, microbatches=2)
        m2, g2 = gradients(cfg, local, batch)
        grads = all(torch.equal(cut(mesh, a, s), b) for a, b, s in zip(
            tree_leaves(g1), tree_leaves(g2),
            rank_local.spec_leaves(g2, layout.specs.params)))
        del g1, g2
        one, n1 = two(one, batch)
        local, n2 = cut_step(local, batch)
        out.append({"grads": grads,
                    "loss": bool(torch.equal(n1["loss"], n2["loss"])),
                    "norm_rel": float(abs(n1["grad_norm"] - n2["grad_norm"])
                                      / n1["grad_norm"])})
    return out


def _moe_routing(mesh, rules) -> dict:
    """qwen2-moe's smoke config with a capacity that drops tokens: each
    layer's routing of this rank's rows against the one-rank routing of
    the whole batch, entry by entry in global token order; the router's
    gradient from ``aux`` alone."""
    cfg = _config("qwen2-moe-a2.7b", moe_capacity_factor=0.5)
    layout = rank_local.layout_for(cfg, mesh, rules)
    tokens = _tokens(cfg, 7)
    one = _state(cfg)
    local = rank_local.shard_state(cfg, _state(cfg), layout)
    row_cut = layout.row_cut(cfg, {"tokens": tokens})
    routes = []
    for model, toks, c in ((one.params, tokens, None),
                           (local.params, row_cut.take(tokens), row_cut)):
        for layer in model.layers:
            layer.routing = []
        with torch.no_grad(), dctx.row_cut(c):
            M.forward(cfg, model, toks)
        routes.append([layer.routing[0] for layer in model.layers])
        for layer in model.layers:
            layer.routing = None
    t_local = row_cut.take(tokens).numel()
    first = (t_local * cfg.moe_top_k) * \
        int(np.ravel_multi_index(
            [mesh.coords[a] for a in row_cut.rows],
            [mesh.shape[a] for a in row_cut.rows]))
    out = {"layers": [], "dropped": 0}
    for r1, r2 in zip(*routes):
        # each entry (token, pick) of the sorted order, by global index
        def table(r, offset):
            entry = r.order + offset
            return {int(e): (int(s), bool(v)) for e, s, v in
                    zip(entry, r.slot, r.valid)}
        whole, mine = table(r1, 0), table(r2, first)
        out["layers"].append(all(whole[e] == mine[e] for e in mine))
        out["dropped"] += sum(not v for _, v in whole.values())
    # the router's gradient from aux alone
    grads = []
    for state, toks, c in ((one, tokens, None),
                           (local, row_cut.take(tokens), row_cut)):
        g = M.bind_grads(cfg, state.params)
        with dctx.row_cut(c):
            _, aux = M.train_forward(cfg, state.params, toks)
            aux.backward()
        if c is not None:
            rank_local.sum_rows(g, layout, c)
        for p in state.params.parameters():
            p.grad = None
        grads.append(g["layers"]["moe"]["router"])
    spec = layout.specs.params["layers"]["moe"]["router"]
    want = cut(mesh, grads[0], spec)
    out["router_rel"] = float((grads[1] - want).abs().max()
                              / want.abs().max())
    return out


def _replicated_rows(world_mesh3, mesh, rules) -> dict:
    """Batches that do not divide a data axis: 3 rows on (2, 4), whose
    data axis then cuts nothing; 2 rows on (2, 2, 2) with rules over
    ("pod", "data"), cut over pod only."""
    cfg = _config("tinyllama-1.1b")
    out = {}
    for name, m, r, b in (("3 rows on (2, 4)", mesh, rules, 3),
                          ("2 rows on (2, 2, 2)", world_mesh3,
                           sh.make_rules(model_axis="tp"), 2)):
        out[name] = _cut_case(m, r, cfg, _tokens(cfg, 5, batch=b), 1)
    return out


def _parallel(mesh, rules) -> dict:
    """Expert parallelism and ring attention in a rows-cut step under
    ``axis_rules``: against the same world's gradient of the global
    batch on global tensors (each rank the whole model, the shard_maps
    cutting the rows), and remat full bit-equal to remat none."""
    out = {}
    cases = (("ep", _config("qwen2-moe-a2.7b", moe_impl="ep",
                            moe_expert_pad=2, moe_capacity_factor=8.0)),
             ("ring", _config("qwen3-4b", ring_attention=True)))
    for name, cfg in cases:
        tokens = _tokens(cfg, 11, seq=32)
        batch = {"tokens": tokens}
        layout = rank_local.layout_for(cfg, mesh, rules)
        with dctx.axis_rules(mesh, rules):
            m1, g1 = gradients(cfg, _state(cfg), batch)
            res = {}
            for remat in ("full", "none"):
                c = dataclasses.replace(cfg, remat=remat)
                local = rank_local.shard_state(c, _state(c), layout)
                with record_collectives() as rec:
                    m2, g2 = gradients(c, local, batch)
                res[remat] = (m2, g2, rec.stats("body").count)
        out[name] = {
            "loss": (float(m1["loss"]), float(res["full"][0]["loss"])),
            "grad_rel": _grad_err(mesh, layout, g1, res["full"][1]),
            "remat_equal": all(
                torch.equal(a, b) for a, b in
                zip(tree_leaves(res["full"][1]), tree_leaves(res["none"][1])))
            and torch.equal(res["full"][0]["loss"], res["none"][0]["loss"]),
            "body": (res["full"][2], res["none"][2])}
    return out


def _decode_vs_reference(mesh, x) -> dict:
    """The reference test's seq-sharded decode: the cache cut (None,
    "data", None, "model") on (2, 4), qwen3-4b's smoke weights, 4
    sequences, a 64-slot cache, position 3; the logits of every row."""
    cfg = _config("qwen3-4b")
    params = M.params_from_reference(cfg, _unflat(x, "p/"), device="cpu")
    tok = torch.from_numpy(x["tok"]).long()
    with dctx.axis_rules(mesh, sh.DEFAULT_RULES):
        c = serving_cut(cfg, 4, 64)
        cache = {k: torch.zeros(tuple(v.shape)) for k, v in _block_cache(
            cfg, mesh, sh.DEFAULT_RULES, 4, 64).items()}
        with dctx.row_cut(c):
            logits, _ = M.decode_step(cfg, params, cache, c.take(tok), 3)
        logits = c.gather(logits)
    return {"cut": (c.rows, c.seq), "cache": tuple(cache["k"].shape),
            "logits": logits.numpy()}


def _block_cache(cfg, mesh, rules, batch, max_seq) -> dict:
    """This rank's block of an empty cache under ``rules`` (meta)."""
    return rank_local.block_spec(M.cache_spec(cfg, batch, max_seq),
                                 cache_specs(cfg, batch, max_seq, mesh,
                                             rules), mesh)


def _serve(mesh, arch, prompt_len, max_seq) -> dict:
    """Prefill and two decode steps through the serve steps under
    ``axis_rules`` (the cache this rank's block) against the one-rank
    steps: the tokens, and the last step's logits through the model's
    ``decode_step`` under the same cut."""
    cfg = _config(arch)
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    prompt = _tokens(cfg, 3, batch=4, seq=prompt_len)
    runs = {}
    for name, rules in (("one", None), ("cut", sh.DEFAULT_RULES)):
        ctx = (dctx.axis_rules(mesh, rules) if rules is not None
               else dctx.row_cut(None))
        with ctx:
            tok, cache = make_prefill_step(cfg, max_seq)(params, prompt)
            toks = [tok]
            step = make_serve_step(cfg, max_seq)
            for i in range(2):
                tok, cache = step(params, cache, tok, prompt_len + i)
                toks.append(tok)
            c = serving_cut(cfg, 4, max_seq)
            with dctx.row_cut(c):
                logits, _ = M.decode_step(
                    cfg, params, cache, tok if c is None else c.take(tok),
                    prompt_len + 2)
            if c is not None:
                logits = c.gather(logits)
        runs[name] = (torch.stack(toks, 1), logits,
                      None if c is None else (c.rows, c.seq),
                      [t.numel() for t in tree_leaves(cache)])
    one, got = runs["one"], runs["cut"]
    return {"tokens_equal": torch.equal(one[0], got[0]),
            "logits_rel": float((got[1] - one[1]).abs().max()
                                / one[1].abs().max()),
            "cut": got[2],
            "cache_shares": sorted({a // b for a, b in zip(one[3], got[3])})}


def _unflat(x: dict, prefix: str) -> dict:
    out: dict = {}
    for key, val in x.items():
        if key.startswith(prefix):
            *path, leaf = key[len(prefix):].split("/")
            node = out
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = val
    return out


def _port_rank(rank, report, inpath):
    torch.set_num_threads(1)
    x = dict(np.load(inpath))
    mesh = Mesh(MESH, ("data", "model"), backend="gloo", device="cpu")
    mesh3 = Mesh((2, 2, 2), ("pod", "data", "model"), backend="gloo",
                 device="cpu")
    out = {"cases": {}}
    for name, arch, over, mb in CASES:
        cfg = _config(arch, **over)
        out["cases"][name] = _cut_case(mesh, _rules(), cfg,
                                       _tokens(cfg, len(name)), mb)
        report(f"rank {rank}: {name}")
    out["two_microbatches"] = _two_microbatches(mesh, _rules())
    out["moe"] = _moe_routing(mesh, _rules())
    out["replicated"] = _replicated_rows(mesh3, mesh, _rules())
    out["parallel"] = _parallel(mesh, _rules())
    report(f"rank {rank}: ep and ring")
    out["decode"] = _decode_vs_reference(mesh, x)
    out["serve"] = {arch: _serve(mesh, arch, n, s) for arch, n, s in SERVE}
    return out


REFERENCE = """
import sys, dataclasses
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_smoke_config
from repro import models as M

x = dict(np.load(sys.argv[1]))
def tree(prefix):
    out = {}
    for key, val in x.items():
        if key.startswith(prefix):
            *path, leaf = key[len(prefix):].split("/")
            node = out
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(val)
    return out
cfg = dataclasses.replace(get_smoke_config("qwen3-4b"), dtype="float32")
cache = M.init_cache(cfg, 4, 64)
lg0, _ = M.decode_step(cfg, tree("p/"), cache, jnp.asarray(x["tok"]),
                       jnp.int32(3))
np.savez(sys.argv[2], logits=np.asarray(lg0, np.float32))
"""


def _flat(tree, prefix):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _inputs() -> dict:
    cfg = _config("qwen3-4b")
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    x = {"tok": np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4,)).astype(np.int32)}
    x.update(_flat(M.params_to_reference(params), "p/"))
    return x


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("batch_cut")
    inpath, refpath = str(tmp / "inputs.npz"), str(tmp / "reference.npz")
    np.savez(inpath, **_inputs())
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    ref_proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REFERENCE), inpath, refpath],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=REPO)
    try:
        port = launch.run(_port_rank, WORLD, backend="gloo", device="cpu",
                          args=(inpath,), timeout=TIMEOUT)
        _, err = ref_proc.communicate(timeout=TIMEOUT)
    finally:
        if ref_proc.poll() is None:
            ref_proc.kill()
            ref_proc.communicate()
    assert ref_proc.returncode == 0, err[-4000:]
    return dict(np.load(refpath)), port


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_rows_cut_step_matches_one_rank(sides, name):
    """Every rank's loss and gradient blocks against the one-rank step's
    on its 4 of the 8 rows; the state after the step at the gate's
    tolerance, with the count of entries off by more than 1e-6."""
    for rank, got in enumerate(sides[1]):
        case = got["cases"][name]
        assert case["rows"] == ("data",)
        a, b = case["loss"]
        assert abs(a - b) <= LOSS_REL * abs(a), (rank, a, b)
        assert case["grad_rel"] <= GRAD_REL, (rank, case["grad_rel"])
        assert case["state_err"] <= STATE_ATOL, (rank, case["state_err"])
        print(f"{name} rank {rank}: loss rel {abs(a - b) / abs(a):.2e}, "
              f"grad {case['grad_rel']:.2e}, state max abs err "
              f"{case['state_err']:.2e}, {case['state_big']} of "
              f"{case['state_n']} entries beyond 1e-6")


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_gradient_sums_are_the_arithmetic(sides, name):
    """The ``"grad"`` site's collectives: a read's backward as
    ``rank_local.backward_sums`` counts it, once a read of the forward
    (not of a recompute), a unit read once a layer (or pattern group),
    the leaves held whole once a step; the metrics' mean is the one
    ``"rows"`` all-reduce of a dense step."""
    _, arch, over, mb = next(c for c in CASES if c[0] == name)
    cfg = _config(arch, **over)
    from repro_torch.distributed.mesh import AbstractMesh
    mesh = AbstractMesh(MESH, ("data", "model"))
    layout = rank_local.Layout(mesh, rank_local.specs_for(cfg, mesh,
                                                          _rules()))
    n = rank_local.backward_sums(cfg, layout, ("data",))
    units = (cfg.num_layers // len(cfg.block_pattern)
             if cfg.family == "hybrid" else cfg.num_layers)
    want_n = mb * (units * n["unit"][0] + n["rest"][0]) + n["whole"][0]
    want_b = mb * (units * n["unit"][1] + n["rest"][1]) + n["whole"][1]
    count, nbytes = sides[1][0]["cases"][name]["grad_site"]
    assert sum(count.values()) == want_n > 0
    assert sum(nbytes.values()) == want_b
    assert count["reduce-scatter"] > 0
    if not cfg.moe_num_experts:
        assert sides[1][0]["cases"][name]["rows_site"]["all-reduce"] == 1


def test_rows_cut_is_the_two_microbatch_step_bit_for_bit(sides):
    """In bfloat16 the cut rounds each weight's gradient a rank's rows at
    a time; the one-rank step with those rows as its microbatches rounds
    the same, and the two agree bit for bit through three steps (losses
    and every gradient block; the norm, summed over blocks in another
    order, within ``LOSS_REL``)."""
    for rank, got in enumerate(sides[1]):
        for step in got["two_microbatches"]:
            assert step["grads"] and step["loss"], (rank, step)
            assert step["norm_rel"] <= LOSS_REL, (rank, step)


def test_moe_routes_over_the_global_batch(sides):
    """Dropped tokens: each rank's kept entries and their slots are the
    one-rank routing's; the router's gradient from aux alone matches."""
    for rank, got in enumerate(sides[1]):
        moe = got["moe"]
        assert moe["dropped"] > 0
        assert all(moe["layers"]), (rank, moe["layers"])
        assert moe["router_rel"] <= GRAD_REL, (rank, moe["router_rel"])


@pytest.mark.parametrize("name", ["3 rows on (2, 4)", "2 rows on (2, 2, 2)"])
def test_rows_that_do_not_divide_stay_whole(sides, name):
    """A batch that does not divide an axis is not cut over it, and the
    gradient is not summed over it: the one-rank step's."""
    want_rows = {"3 rows on (2, 4)": (), "2 rows on (2, 2, 2)": ("pod",)}
    for rank, got in enumerate(sides[1]):
        case = got["replicated"][name]
        assert case["rows"] == want_rows[name]
        a, b = case["loss"]
        assert abs(a - b) <= LOSS_REL * abs(a), (rank, a, b)
        assert case["grad_rel"] <= GRAD_REL, (rank, case["grad_rel"])
        assert case["state_err"] <= STATE_ATOL


@pytest.mark.parametrize("name", ["ep", "ring"])
def test_parallel_rows_cut_step_matches_global(sides, name):
    """EP and ring attention on their rows: the global step's loss and
    gradient; remat full bit-equal to remat none, whose body collectives
    the recompute repeats."""
    for rank, got in enumerate(sides[1]):
        case = got["parallel"][name]
        a, b = case["loss"]
        assert abs(a - b) <= LOSS_REL * abs(a), (rank, a, b)
        assert case["grad_rel"] <= GRAD_REL, (rank, case["grad_rel"])
        assert case["remat_equal"], rank
        full, none = case["body"]
        kind = "all-to-all" if name == "ep" else "collective-permute"
        assert full[kind] > none[kind] > 0


def test_seq_sharded_decode_matches_reference(sides):
    """tests/test_multidevice.py's seq-sharded decode, the port's cache
    cut (None, "data", None, "model") on 8 ranks against the reference's
    replicated decode."""
    ref, port = sides
    for rank, got in enumerate(port):
        d = got["decode"]
        assert d["cut"] == (("data",), ("model",))
        assert d["cache"][1] == 2 and d["cache"][3] == 16
        np.testing.assert_allclose(d["logits"], ref["logits"],
                                   atol=DECODE_ATOL)


@pytest.mark.parametrize("arch", [s[0] for s in SERVE])
def test_serve_steps_on_a_cut_cache_match_one_rank(sides, arch):
    """Prefill and decode through the serve steps with the batch cut over
    data and the cache's slots over model (the recurrent caches on their
    rows only) against the one-rank steps."""
    for rank, got in enumerate(sides[1]):
        s = got["serve"][arch]
        assert s["cut"] == (("data",), () if arch == "mamba2-370m"
                            else ("model",))
        assert s["tokens_equal"], rank
        assert s["logits_rel"] <= SERVE_REL, (rank, s["logits_rel"])
        # each leaf a half (rows) or an eighth (rows and slots)
        assert s["cache_shares"] == {"qwen3-4b": [8],
                                     "qwen2-moe-a2.7b": [8],
                                     "mamba2-370m": [2],
                                     "recurrentgemma-9b": [2, 8]}[arch]


def test_layout_row_cut_sanitizes_the_batch():
    """The batch's specs are ``tree_shardings_for`` of its shapes and
    ``batch_logical_axes``: a batch that divides the data axis is cut
    over it, one that does not is not, a microbatch's rows decide."""
    from repro_torch.distributed.mesh import AbstractMesh
    cfg = get_smoke_config("internvl2-26b")
    mesh = AbstractMesh(MESH, ("data", "model"))
    layout = rank_local.layout_for(cfg, mesh, _rules())
    batch = {"tokens": np.zeros((8, 16), np.int32),
             "frontend_inputs": np.zeros((8, cfg.num_patches, cfg.d_model),
                                         np.float32)}
    specs = layout.batch_specs(cfg, batch)
    assert specs["tokens"] == sh.PartitionSpec("data")
    assert specs["frontend_inputs"] == sh.PartitionSpec("data")
    assert layout.row_cut(cfg, batch).rows == ("data",)
    assert layout.row_cut(cfg, batch, microbatches=8) is None
    assert layout.row_cut(cfg, {"tokens": np.zeros((3, 4))}) is None
    with pytest.raises(ValueError, match="logical axes"):
        layout.row_cut(cfg, {"labels": np.zeros((8, 4))})
