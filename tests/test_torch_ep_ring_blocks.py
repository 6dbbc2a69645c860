"""Expert parallelism and ring attention on a rank's blocks: under rules
that cut ``experts`` or ``heads`` over ``model``, a rank reads its block
of the expert weights and computes on it as it is
(``moe_parallel.moe_ffn_ep``, ``mesh.shard_map``'s ``held``), and under
ring attention computes its query heads and trades them for a sequence
block (``ring_attention.ring_attention_heads``), with no gather of a
weight over ``model`` and no permute of K/V (every rank holds them
whole).

One module fixture runs the reference in a subprocess (eight virtual CPU
devices) and, meanwhile, the port on eight gloo CPU ranks of the (2, 4)
("data", "model") mesh under ``make_rules(data_axes=("data",))``:
qwen2-moe-a2.7b's smoke config with ``moe_impl="ep"`` and
``moe_expert_pad=2`` (8 experts, 2 a rank) and qwen3-4b's with
``ring_attention=True``.  Held here:

* each rank's loss and gradient blocks in float32 against the
  reference's sharded ``jax.value_and_grad`` under its ``axis_rules``
  (its own expert parallelism and ring), at
  ``tests/test_torch_tensor_parallel.py``'s ``LOSS_REL`` and ``F32``;
* in float64, the loss at ``LOSS_REL``, the gradient blocks at
  ``GRAD_REL`` and params, ``m`` and ``v`` after a step at
  ``STATE_ATOL``: the ring against the port's one-rank step; expert
  parallelism against the same world's step on the one-rank state
  (global tensors) under ``axis_rules`` (a check of one layout against
  another: its ``aux`` is the mean of the data ranks' local ``aux``, the
  reference's schedule, which no one-rank routing computes), and, with
  the aux loss's weight 0, against the one-rank step;
* EP on blocks bit-equal to the EP step of a layout that gathers the
  experts whole over ``model`` (float32: loss, gradient blocks, the
  state after a step); the ring on heads against a layout that gathers
  the heads whole, within ``LOSS_REL`` and ``F32`` (``wo``'s row
  product is a sum of the ranks' partial products there);
* the collectives: ``"state"``, ``"grad"`` and ``"tp"`` equal to
  ``rank_local.forward_gathers``, ``backward_sums`` and
  ``tensor_parallel.step_collectives``; EP's all-to-alls and aux means
  at ``"body"`` as the recompute implies, the ring on heads none; at
  ``"boundary"`` no all-gather (no expert weight's gradient gathered,
  nothing from the ring);
* GQA under the ring with a rank's query heads fewer than a key head's
  group, as many, and more;
* a remat recompute on a fresh thread computing the same blocks;
* serving under ``make_rules(fsdp=False, data_axes=("data",))``:
  qwen2-moe EP on its expert blocks (a decode token gathers nothing)
  and qwen3-4b's prefill with the ring on heads, tokens equal to the
  one-rank steps and logits within ``SERVE_REL`` (float64);
* a smoke dry-run cell each of EP and ring: a rank's argument bytes its
  blocks', its ``"state"`` gathers ``forward_gathers``' and its flops
  ``tensor_parallel.train_flops``.
"""
import dataclasses
import functools
import math
import os
import subprocess
import sys
import textwrap
import threading
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch import models as M
from repro_torch.configs import get_smoke_config
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
from repro_torch.utils.comm_stats import COLLECTIVES, record_collectives
from repro_torch.utils.tree import tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 8
MESH = (2, 4)
#: Seconds either side may go without progress before it is killed.
TIMEOUT = 240
#: tests/test_torch_tensor_parallel.py's constants
LOSS_REL = 1e-6
GRAD_REL = 1e-5
STATE_ATOL = 2e-3
SERVE_REL = 1e-5
F32 = dict(rtol=1e-4, scale_atol=1e-4)
#: (name, overrides of the smoke config): 8 experts with the pad, 2 a
#: rank; a capacity that drops nothing, so that the routing of a rank's
#: tokens keeps what the one-rank routing keeps
CASES = {
    "ep": ("qwen2-moe-a2.7b", dict(moe_impl="ep", moe_expert_pad=2,
                                   moe_capacity_factor=8.0)),
    "ring": ("qwen3-4b", dict(ring_attention=True)),
}
#: the dim each case's earlier layout gathers whole over model
WHOLE = {"ep": "experts", "ring": "heads"}
#: a rank's query heads against a key head's group under the ring on
#: model 4: (name, heads, key heads), H / 4 fewer than, as many as and
#: more than H / K
GQA = [("fewer", 4, 2), ("equal", 8, 4), ("more", 16, 8)]
OPT = AdamWConfig(lr=3e-3, warmup_steps=0, total_steps=10)
BATCH, SEQ = 8, 16


def _rules():
    return sh.make_rules(data_axes=("data",))


def _serve_rules():
    return sh.make_rules(fsdp=False, data_axes=("data",))


def _config(name, dtype="float32", **over):
    arch, case = CASES[name]
    return dataclasses.replace(
        get_smoke_config(arch), dtype=dtype,
        param_dtype="float64" if dtype == "float64" else "float32",
        **{**case, **over})


def _tokens(cfg, seed: int, batch: int = BATCH, seq: int = SEQ):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, seq)))


def _state(cfg) -> TrainState:
    return TrainState.create(cfg, torch.Generator().manual_seed(0),
                             device="cpu")


def _layout(cfg, mesh, rules, whole=None):
    """The layout under ``rules``; with ``whole``, the one that gathers
    that logical axis whole over ``model`` too (the earlier layout)."""
    if whole is None:
        return rank_local.layout_for(cfg, mesh, rules)
    specs = rank_local.specs_for(cfg, mesh, rules)
    names = tpar.local_names(cfg, mesh, rules) - {whole}
    return rank_local.Layout(mesh, specs, rules, rank_local.gathered_specs(
        cfg, specs.params, mesh, rules, names))


def _sums(rec, site) -> tuple:
    st = rec.stats(site)
    return sum(st.count.values()), int(st.total_result_bytes)


def _by_kind(rec, site) -> dict:
    st = rec.stats(site)
    return {k: (st.count[k], int(st.result_bytes[k])) for k in COLLECTIVES}


def _state_leaves(state) -> list:
    return tree_leaves({"params": state.params.param_tree(),
                        "opt": state.opt})


def _block_err(mesh, layout, want_tree, got_tree, state=False) -> float:
    """The largest gap of a rank's blocks ``got_tree`` to its blocks of
    the global ``want_tree``: relative to each leaf's largest magnitude,
    or absolute (``state``)."""
    specs = (rank_local.spec_leaves(got_tree, {"params": layout.specs.params,
                                               "opt": layout.specs.opt})
             if state else
             rank_local.spec_leaves(got_tree, layout.specs.params))
    worst = 0.0
    for a, b, s in zip(tree_leaves(want_tree), tree_leaves(got_tree), specs):
        want = cut(mesh, a.detach(), s).double()
        err = float((b.detach().double() - want).abs().max())
        scale = 1.0 if state else float(want.abs().max())
        worst = max(worst, err / scale if scale > 0 else err)
    return worst


# -- the port's ranks ---------------------------------------------------------
def _f32_case(mesh, name) -> dict:
    """The float32 step on blocks: its loss, gradient blocks and
    collectives; the same step on the earlier layout (the dim gathered
    whole), and a train step on each."""
    cfg = _config(name)
    batch = {"tokens": _tokens(cfg, 1)}
    out = {}
    with dctx.axis_rules(mesh, _rules()):
        for form in ("blocks", "whole"):
            layout = _layout(cfg, mesh, _rules(),
                             None if form == "blocks" else WHOLE[name])
            local = rank_local.shard_state(cfg, _state(cfg), layout)
            with record_collectives() as rec:
                m, g = gradients(cfg, local, batch)
            res = {"loss": m["loss"].clone(), "grads": [
                t.clone() for t in tree_leaves(g)]}
            if form == "blocks":
                tp = layout.model_cut()
                res.update(
                    model_cut=tp.axes if tp is not None else (),
                    names=sorted(tpar.local_names(cfg, mesh, _rules())),
                    tp=_sums(rec, "tp"), state=_sums(rec, "state"),
                    grad=_sums(rec, "grad"), body=_by_kind(rec, "body"),
                    boundary=_by_kind(rec, "boundary"))
            local, _ = make_train_step(cfg, OPT)(local, batch)
            res["after"] = [t.detach().clone() for t in _state_leaves(local)]
            out[form] = res
    blocks, whole = out["blocks"], out["whole"]
    pairs = list(zip(blocks["grads"], whole["grads"]))
    return {
        "loss": float(blocks["loss"]),
        "grads": [t.numpy() for t in blocks["grads"]],
        "equal": (torch.equal(blocks["loss"], whole["loss"])
                  and all(torch.equal(a, b) for a, b in pairs)
                  and all(torch.equal(a, b) for a, b in
                          zip(blocks["after"], whole["after"]))),
        "whole_loss": float(whole["loss"]),
        "whole_grad_rel": max(
            float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            for a, b in pairs),
        **{k: blocks[k] for k in ("model_cut", "names", "tp", "state",
                                  "grad", "body", "boundary")}}


def _f64_case(mesh, cfg, step: bool = True, same_world=None) -> dict:
    """The step on blocks in float64 against the one-rank step (with
    ``same_world``, by default for EP: the one-rank state's step under
    ``axis_rules``): the loss, the gradient blocks, and with ``step`` the
    state after the step."""
    layout = rank_local.layout_for(cfg, mesh, _rules())
    batch = {"tokens": _tokens(cfg, 2)}
    one = _state(cfg)
    local = rank_local.shard_state(cfg, _state(cfg), layout)
    if same_world is None:
        same_world = cfg.moe_impl == "ep"

    def arbiter():
        return (dctx.axis_rules(mesh, _rules()) if same_world
                else dctx.row_cut(None))
    with arbiter():
        m1, g1 = gradients(cfg, one, batch)
    with dctx.axis_rules(mesh, _rules()):
        m2, g2 = gradients(cfg, local, batch)
    out = {"loss": (float(m1["loss"]), float(m2["loss"])),
           "grad_rel": _block_err(mesh, layout, g1, g2),
           "names": sorted(tpar.local_names(cfg, mesh, _rules()))}
    del g1, g2
    if step:
        with arbiter():
            one, _ = make_train_step(cfg, OPT)(one, batch)
        with dctx.axis_rules(mesh, _rules()):
            local, _ = make_train_step(cfg, OPT)(local, batch)
        out["state_err"] = _block_err(
            mesh, layout, {"params": one.params.param_tree(), "opt": one.opt},
            {"params": local.params.param_tree(), "opt": local.opt},
            state=True)
    return out


def _remat_thread(mesh, name) -> bool:
    """The gradient blocks (float64, remat full, layer by layer) with the
    backward on this thread and on a fresh one (an empty context, as the
    autograd engine's device thread): bit-equal."""
    cfg = _config(name, "float64", remat_block=1)
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
        with dctx.axis_rules(mesh, _rules()), dctx.row_cut(row), \
                dctx.model_cut(layout.model_cut()):
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


def _serve(mesh, name, prompt_len, max_seq) -> dict:
    """Prefill and two decode steps through the serve steps, a rank's
    blocks under the no-FSDP rules, against the one-rank steps, float64:
    the tokens, a third step's logits, and the collectives of a decode
    step."""
    cfg = _config(name, "float64")
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    rules = _serve_rules()
    layout = rank_local.layout_for(cfg, mesh, rules)
    blocks = rank_local.serve_blocks(cfg, params, layout)
    prompt = _tokens(cfg, 3, batch=4, seq=prompt_len)
    runs = {}
    for which, p in (("one", params), ("blocks", blocks)):
        ctx = (dctx.axis_rules(mesh, rules) if which == "blocks"
               else dctx.row_cut(None))
        with ctx:
            with record_collectives() as rec_pre:
                tok, cache = make_prefill_step(cfg, max_seq)(p, prompt)
            toks = [tok]
            step = make_serve_step(cfg, max_seq)
            with record_collectives() as rec:
                for k in range(2):
                    tok, cache = step(p, cache, tok, prompt_len + k)
                    toks.append(tok)
            c = serving_cut(cfg, 4, max_seq)
            tp = layout.model_cut() if which == "blocks" else None
            with dctx.row_cut(c), dctx.model_cut(tp):
                logits, _ = M.decode_step(
                    cfg, p, cache, tok if c is None else c.take(tok),
                    prompt_len + 2)
                if tp is not None:
                    logits = all_gather_dim(mesh, logits, tp.axes,
                                            logits.dim() - 1)
                logits = logits if c is None else c.gather(logits)
        runs[which] = dict(tokens=torch.stack(toks, 1), logits=logits,
                           decode_state=_sums(rec, "state"),
                           prefill_state=_sums(rec_pre, "state"),
                           prefill_tp=_by_kind(rec_pre, "tp"),
                           prefill_body=_by_kind(rec_pre, "body"))
    one, got = runs["one"], runs["blocks"]
    return {"tokens_equal": torch.equal(one["tokens"], got["tokens"]),
            "logits_rel": float((got["logits"] - one["logits"]).abs().max()
                                / one["logits"].abs().max()),
            "names": sorted(tpar.local_names(cfg, mesh, rules)),
            "held": sum(t.numel() for t in blocks.parameters()),
            "whole": sum(t.numel() for t in params.parameters()),
            **{k: got[k] for k in ("decode_state", "prefill_state",
                                   "prefill_tp", "prefill_body")}}


def _port_rank(rank, report):
    torch.set_num_threads(1)
    mesh = Mesh(MESH, ("data", "model"), backend="gloo", device="cpu")
    out = {"f32": {}, "f64": {}, "gqa": {}, "thread": {}}
    for name in CASES:
        out["f32"][name] = _f32_case(mesh, name)
        out["f64"][name] = _f64_case(mesh, _config(name, "float64"))
        out["thread"][name] = _remat_thread(mesh, name)
        report(f"rank {rank}: {name}")
    # the nll alone: every routing of the same tokens computes it alike
    with mock.patch.object(M, "loss_fn",
                           functools.partial(M.loss_fn, aux_weight=0.0)):
        out["f64_no_aux"] = _f64_case(mesh, _config("ep", "float64"),
                                      same_world=False)
    for name, h, k in GQA:
        out["gqa"][name] = _f64_case(mesh, _config(
            "ring", "float64", num_heads=h, num_kv_heads=k), step=False)
    out["serve"] = {name: _serve(mesh, name, 16, 64) for name in CASES}
    return out


# -- the reference ------------------------------------------------------------
REFERENCE = """
import sys, dataclasses, json
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as PS
from repro.configs import get_smoke_config
from repro import models as RM
from repro.distributed import ctx as rctx
from repro.distributed import sharding as sh

x = dict(np.load(sys.argv[1]))
cases = json.loads(sys.argv[3])
mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
rules = sh.make_rules(data_axes=("data",))
out = {}
for name, (arch, over) in cases.items():
    tree = {}
    for key, val in x.items():
        if key.startswith(name + "/p/"):
            *path, leaf = key[len(name) + 3:].split("/")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(val)
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                              **over)
    p_sh = sh.tree_shardings_for(tree, RM.logical_axes(cfg), mesh, rules)
    b_sh = {"tokens": NamedSharding(mesh, PS("data"))}
    fn = jax.value_and_grad(lambda p, b: RM.loss_fn(cfg, p, b), has_aux=True)
    with mesh, rctx.axis_rules(mesh, rules):
        (loss, _), grads = jax.jit(fn, in_shardings=(p_sh, b_sh))(
            tree, {"tokens": jnp.asarray(x[name + "/tokens"])})
    out[name + "/loss"] = np.asarray(loss, np.float32)
    for i, g in enumerate(jax.tree.leaves(grads)):
        out[f"{name}/g{i}"] = np.asarray(g, np.float32)
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
    for name in CASES:
        cfg = _config(name)
        x[f"{name}/tokens"] = _tokens(cfg, 1).numpy().astype(np.int32)
        x.update(_flat(M.params_to_reference(_state(cfg).params),
                       f"{name}/p/"))
    return x


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    import json
    tmp = tmp_path_factory.mktemp("ep_ring_blocks")
    inpath, refpath = str(tmp / "inputs.npz"), str(tmp / "reference.npz")
    np.savez(inpath, **_inputs())
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    ref_proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REFERENCE), inpath, refpath,
         json.dumps(CASES)],
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


def _abstract():
    return AbstractMesh(MESH, ("data", "model"))


# -- the train step -----------------------------------------------------------
@pytest.mark.parametrize("name", list(CASES))
def test_step_on_blocks_matches_the_reference_sharded_step(sides, name):
    """Each rank's loss and gradient blocks against the reference's
    sharded value_and_grad, its expert parallelism or ring under its
    axis_rules on the same mesh, float32."""
    ref, port = sides
    cfg = _config(name)
    layout = rank_local.layout_for(cfg, _abstract(), _rules())
    specs = rank_local.spec_leaves(layout.specs.params, layout.specs.params)
    want_loss = float(ref[f"{name}/loss"])
    for rank, got in enumerate(port):
        case = got["f32"][name]
        assert case["model_cut"] == ("model",)
        assert WHOLE[name] in case["names"]
        assert abs(case["loss"] - want_loss) <= LOSS_REL * want_loss
        for i, (g, spec) in enumerate(zip(case["grads"], specs)):
            want = _block(ref[f"{name}/g{i}"], spec, rank)
            np.testing.assert_allclose(
                g, want, rtol=F32["rtol"],
                atol=F32["scale_atol"] * max(float(np.abs(want).max()),
                                             1e-30),
                err_msg=f"{name} rank {rank} leaf {i}")


@pytest.mark.parametrize("name", list(CASES))
def test_step_on_blocks_matches_one_rank_in_float64(sides, name):
    """Float64: every rank's loss, gradient blocks and state after the
    step against the one-rank state's step (for EP under axis_rules: its
    aux is a mean of the data ranks' local aux)."""
    for rank, got in enumerate(sides[1]):
        case = got["f64"][name]
        assert WHOLE[name] in case["names"]
        a, b = case["loss"]
        assert abs(a - b) <= LOSS_REL * abs(a), (rank, a, b)
        assert case["grad_rel"] <= GRAD_REL, (rank, case["grad_rel"])
        assert case["state_err"] <= STATE_ATOL, (rank, case["state_err"])


def test_ep_on_blocks_matches_one_rank_without_aux_in_float64(sides):
    """With the aux loss's weight 0 (the nll alone, which every routing
    of the same tokens computes alike where nothing is dropped), EP on
    the rank's expert blocks against the port's one-rank step, float64:
    the loss, the gradient blocks and the state after the step."""
    for rank, got in enumerate(sides[1]):
        case = got["f64_no_aux"]
        assert "experts" in case["names"]
        a, b = case["loss"]
        assert abs(a - b) <= LOSS_REL * abs(a), (rank, a, b)
        assert case["grad_rel"] <= GRAD_REL, (rank, case["grad_rel"])
        assert case["state_err"] <= STATE_ATOL, (rank, case["state_err"])


def test_ep_on_blocks_is_the_whole_expert_layout_bit_for_bit(sides):
    """EP on the rank's expert blocks against the layout that gathers the
    experts whole over model (the shard_map cutting them): the same
    products and sums, so the loss, every gradient block and the state
    after a step are bit-equal (float32)."""
    for rank, got in enumerate(sides[1]):
        assert got["f32"]["ep"]["equal"], rank


def test_ring_on_heads_matches_the_whole_heads_layout(sides):
    """The ring on the rank's query heads against the layout that gathers
    the heads whole (the ring on every head): ``wo``'s product is a sum
    of the ranks' partial products, so the two agree to float32
    rounding."""
    for rank, got in enumerate(sides[1]):
        case = got["f32"]["ring"]
        a, b = case["loss"], case["whole_loss"]
        assert abs(a - b) <= LOSS_REL * abs(b), (rank, a, b)
        assert case["whole_grad_rel"] <= F32["scale_atol"], \
            (rank, case["whole_grad_rel"])


def _body_want(cfg, rows: int, seq: int) -> dict:
    """The ``"body"`` collectives of a train step a rank, by kind
    ``(count, result bytes)``: each layer forward (the recomputes
    included) and each layer backward runs EP's two all-to-alls of its
    ``(E + pad, cap, D)`` buffer and one all-reduce of the aux loss (its
    mean over the data ranks; the backward's psum); the ring on heads
    none (a rank reads every K/V block from its own copy)."""
    L = cfg.num_layers
    runs = cm.layer_forward_runs(cfg, L) + L
    act = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    out = {k: (0, 0) for k in COLLECTIVES}
    if cfg.moe_impl == "ep":
        et = cfg.moe_num_experts + cfg.moe_expert_pad
        cap = max(math.ceil(rows * seq * cfg.moe_top_k / cfg.moe_num_experts
                            * cfg.moe_capacity_factor), 8)
        buf = et * cap * cfg.d_model * act
        out["all-to-all"] = (2 * runs, 2 * runs * buf)
        out["all-reduce"] = (runs, 4 * runs)
    return out


def _boundary_want(cfg, rows: int, seq: int) -> dict:
    """The ``"boundary"`` collectives of a train step a rank: EP's
    backward all-reduces its input's and its float32 router's cotangents
    over ``model`` (each rank along it routes the same rows), once a
    layer backward; no all-gather (the expert blocks' gradients are the
    blocks'); the ring on heads none."""
    out = {k: (0, 0) for k in COLLECTIVES}
    if cfg.moe_impl == "ep":
        act = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
        L = cfg.num_layers
        each = rows * seq * cfg.d_model * act \
            + cfg.d_model * cfg.moe_num_experts * 4
        out["all-reduce"] = (2 * L, L * each)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_collectives_are_the_arithmetic(sides, name):
    """``"tp"`` is ``step_collectives`` (the ring's head exchanges among
    them), ``"state"`` ``forward_gathers`` a unit forward, ``"grad"``
    ``backward_sums``; the body's and the boundary's as
    :func:`_body_want` and :func:`_boundary_want` count them."""
    cfg = _config(name)
    mesh = _abstract()
    layout = rank_local.layout_for(cfg, mesh, _rules())
    names = tpar.local_names(cfg, mesh, _rules())
    L = cfg.num_layers
    runs = cm.layer_forward_runs(cfg, L)
    g = rank_local.forward_gathers(cfg, layout)
    s = rank_local.backward_sums(cfg, layout, ("data",))
    rows = BATCH // 2
    want = {"tp": tpar.step_collectives(cfg, names, 4, rows, SEQ),
            "state": (runs * g["unit"][0] + g["rest"][0],
                      runs * g["unit"][1] + g["rest"][1]),
            "grad": (L * s["unit"][0] + s["rest"][0] + s["whole"][0],
                     L * s["unit"][1] + s["rest"][1] + s["whole"][1])}
    body = _body_want(cfg, rows, SEQ)
    edge = _boundary_want(cfg, rows, SEQ)
    for rank, got in enumerate(sides[1]):
        case = got["f32"][name]
        for site in ("tp", "state", "grad"):
            assert case[site] == tuple(want[site]), (rank, site)
        assert case["body"] == body, rank
        assert case["boundary"] == edge, rank
        assert case["boundary"]["all-gather"] == (0, 0)
    # the ring's two exchanges of a rank's (rows, H / 4, S, Dh) a forward
    # and a backward; EP's all-to-alls are the body's, none at "tp"
    c = tpar.collectives(cfg, names, 4, rows, SEQ)
    plain = tpar.collectives(dataclasses.replace(
        cfg, ring_attention=False, moe_impl="gspmd"), names, 4, rows, SEQ)
    ring = 2 * rows * (cfg.num_heads // 4) * SEQ * cfg.head_dim * 4
    k = 1 if name == "ring" else 0
    for way in ("fwd", "bwd"):
        assert c["unit"][way][0] == plain["unit"][way][0] + 2 * k
        assert c["unit"][way][1] == plain["unit"][way][1] + ring * k


@pytest.mark.parametrize("name", [c[0] for c in GQA])
def test_ring_local_query_heads_against_their_key_heads(sides, name):
    """Under the ring, a rank's H / 4 query heads fewer than a key head's
    group, as many and more: the one-rank step's, float64."""
    for rank, got in enumerate(sides[1]):
        case = got["gqa"][name]
        assert "heads" in case["names"]
        a, b = case["loss"]
        assert abs(a - b) <= LOSS_REL * abs(a), (rank, a, b)
        assert case["grad_rel"] <= GRAD_REL, (rank, case["grad_rel"])


@pytest.mark.parametrize("name", list(CASES))
def test_remat_recompute_on_a_fresh_thread_computes_the_same_blocks(
        sides, name):
    """A backward started on a fresh thread (no context there) recomputes
    each layer under the forward's axis rules, row cut and model cut:
    the gradient blocks bit-equal to the calling thread's."""
    assert all(got["thread"][name] for got in sides[1])


# -- serving ------------------------------------------------------------------
@pytest.mark.parametrize("name", list(CASES))
def test_serve_steps_on_blocks_match_one_rank(sides, name):
    """A rank's ``model`` blocks under the no-FSDP rules (EP's experts, the
    ring's heads among them): prefill and decode give the one-rank
    tokens and logits, and no weight is gathered; the ring's prefill
    trades the heads for sequence blocks at the tp site, two all-to-alls
    a layer, and permutes nothing."""
    cfg = _config(name, "float64")
    for rank, got in enumerate(sides[1]):
        s = got["serve"][name]
        assert WHOLE[name] in s["names"]
        assert s["tokens_equal"], rank
        assert s["logits_rel"] <= SERVE_REL, (rank, s["logits_rel"])
        assert s["held"] < s["whole"]
        assert s["decode_state"] == (0, 0), rank
        assert s["prefill_state"] == (0, 0), rank
        if name == "ring":
            assert s["prefill_tp"]["all-to-all"][0] == 2 * cfg.num_layers
            assert s["prefill_body"]["collective-permute"] == (0, 0)
        else:
            assert s["prefill_body"]["all-to-all"][0] == 2 * cfg.num_layers


def test_serve_prefill_collectives_are_the_arithmetic():
    """The ring's prefill on heads: its ``"tp"`` collectives are
    ``serve_collectives`` (the dry run's trace on a fake world)."""
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.config import ShapeConfig
    args = D.parser().parse_args(["--arch", "-", "--shape", "-"])
    cfg = dataclasses.replace(_config("ring"), kernel_impl="torch")
    with D.fake_world(8):
        mesh = make_mesh(MESH, ("data", "model"))
        rules = D._rules_for(mesh, args)
        with dctx.axis_rules(mesh, rules):
            trace, _ = D.lower_cell(cfg, ShapeConfig("t", "prefill", 32, 8),
                                    mesh, args)
    names = tpar.local_names(cfg, mesh, rules)
    assert "heads" in names
    assert _sums(trace.collectives, "tp") == tpar.serve_collectives(
        cfg, names, 4, 4, 32, "prefill", seq_cut=True)


# -- the dry run and the rules ------------------------------------------------
@pytest.mark.parametrize("name", list(CASES))
def test_dry_run_cell_is_the_arithmetic(name):
    """A smoke train cell on (2, 4): a rank holds its blocks (argument
    bytes a device's share), its ``"state"`` gathers are
    ``forward_gathers`` a unit forward and its ``"tp"`` collectives
    ``step_collectives``; the ring's flops are ``train_flops`` of its
    heads; nothing at the boundary is an all-gather."""
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.config import ShapeConfig
    cfg = dataclasses.replace(_config(name), kernel_impl="torch")
    args = D.parser().parse_args(["--arch", "-", "--shape", "-",
                                  "--microbatches", "1"])
    sc = ShapeConfig("t", "train", 32, 8)
    with D.fake_world(8):
        mesh = make_mesh(MESH, ("data", "model"))
        rules = D._rules_for(mesh, args)
        with dctx.axis_rules(mesh, rules):
            trace, _ = D.lower_cell(cfg, sc, mesh, args)
            got = D.analyze(trace)
    layout = rank_local.layout_for(cfg, mesh, rules)
    names = tpar.local_names(cfg, mesh, rules)
    assert WHOLE[name] in names
    mem = got["memory"]
    assert mem["argument_bytes"] == mem["sharded_argument_bytes"]
    by_site = got["collectives_by_site"]
    st = by_site["state"]
    assert (sum(st["count"].values()), sum(st["result_bytes"].values())) == \
        rank_local.step_gathers(cfg, layout)
    tp = by_site["tp"]
    rows = sc.global_batch // 2
    assert (sum(tp["count"].values()), sum(tp["result_bytes"].values())) == \
        tpar.step_collectives(cfg, names, 4, rows, 32)
    assert by_site["boundary"]["count"]["all-gather"] == 0
    if name == "ring":
        assert got["flops"] == tpar.train_flops(cfg, names, 4, rows, 32)


def test_local_names_cut_experts_and_keep_heads_under_the_ring():
    """Under expert parallelism the experts are a rank's block where the
    rules cut them over model (not under the gspmd MoE, nor under rules
    with expert_parallel off); under ring attention the heads stay cut.
    A layer's gathers are fewer and smaller than those of the layout
    that gathers them whole."""
    mesh = _abstract()
    ep, ring = _config("ep"), _config("ring")
    assert tpar.local_names(ep, mesh, _rules()) == {
        "experts", "heads", "mlp", "vocab"}
    assert "experts" not in tpar.local_names(
        dataclasses.replace(ep, moe_impl="gspmd"), mesh, _rules())
    assert "experts" not in tpar.local_names(
        ep, mesh, sh.make_rules(data_axes=("data",), expert_parallel=False))
    assert tpar.local_names(ring, mesh, _rules()) == {"heads", "mlp",
                                                      "vocab"}
    for name, cfg in (("ep", ep), ("ring", ring)):
        new = rank_local.forward_gathers(
            cfg, _layout(cfg, mesh, _rules()))["unit"]
        old = rank_local.forward_gathers(
            cfg, _layout(cfg, mesh, _rules(), WHOLE[name]))["unit"]
        assert new[0] < old[0] and new[1] < old[1], name


def test_sum_plan_leaves_an_expert_block_alone():
    """An expert leaf (layers, experts, embed, expert_mlp) on (data,
    model) is gathered by (None, None, data, None): its gradient's plan
    reduce-scatters the embed dim over data and never cuts the experts'
    dim."""
    mesh = _abstract()
    cfg = _config("ep")
    layout = rank_local.layout_for(cfg, mesh, _rules())
    PS = sh.PartitionSpec
    moe = layout.gather_specs()["layers"]["moe"]
    assert layout.specs.params["layers"]["moe"]["w_gate"] == \
        PS(None, "model", "data")
    assert tuple(moe["w_gate"]) == (None, None, "data")
    assert rank_local._sum_plan(mesh, PS(*moe["w_gate"][1:]), ("data",)) \
        == [("reduce-scatter", 1, ("data",))]


def test_expert_block_needs_the_model_cut():
    """A block of the experts outside a model cut raises, as a block of
    any width does (``tensor_parallel.split``)."""
    from repro_torch.distributed.moe_parallel import moe_ffn_ep
    cfg = _config("ep")
    p = {"router": torch.zeros(cfg.d_model, cfg.moe_num_experts),
         "w_gate": torch.zeros(2, cfg.d_model, cfg.moe_d_ff),
         "w_up": torch.zeros(2, cfg.d_model, cfg.moe_d_ff),
         "w_down": torch.zeros(2, cfg.moe_d_ff, cfg.d_model)}
    with pytest.raises(ValueError, match="model cut"):
        moe_ffn_ep(cfg, AbstractMesh((2, 4), ("data", "model")), p,
                   torch.zeros(2, 4, cfg.d_model))
