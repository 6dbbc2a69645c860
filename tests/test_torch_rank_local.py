"""The port's rank-local training state
(``repro_torch.distributed.rank_local``) on eight gloo CPU ranks.

Each rank holds only its blocks of ``params``, ``m`` and ``v`` under
``tree_shardings_for(state_spec(cfg), state_logical_axes(cfg), mesh,
rules)`` on a ("data", "model") mesh with
``make_rules(data_axes=("data",))`` (the strict cases below: another
rule set), gathers a weight where the step reads it, and gets its
gradient back as blocks.  Held here:

* the reference's gate (``tests/test_multidevice.py``'s sharded train
  step): the reference runs as that test runs it, in a subprocess with
  eight virtual devices, tinyllama-1.1b's smoke config with
  ``remat="none"``, a batch of 8 x 32, ``AdamWConfig(warmup_steps=0)``,
  under ``jax.jit`` with the state's shardings and the batch on
  ``"data"``; the port runs the same step rank-local on the (2, 4) mesh,
  each rank on its 4 rows of the batch (the gradient summed over
  ``"data"``), on the same weights (carried across with
  ``models.convert``) and tokens; the loss within 5e-3 relative and the
  first parameter leaf within atol 2e-3, that test's own tolerances;
* port against port on the (1, 8) mesh, whose data axis of one rank
  cuts no rows, under rules that shard every weight over both axes and
  nothing over ``model`` (so no rank computes a block of the heads or
  columns): every smoke family's rank-local step against the port's
  one-rank step on the same weights and tokens, on each rank: the loss
  and every gradient block bit-equal (the gathered weights are the same
  numbers), params, ``m`` and ``v`` after the step within 1e-6 of each
  leaf's largest magnitude (the global norm sums in another order);
  tinyllama also with ``remat="none"`` and with two microbatches (the
  same steps with the rows cut on (2, 4): ``test_torch_batch_cut.py``);
* the memory: the storages a rank's state holds sum to its blocks'
  bytes (the dry run's ``_sharded_bytes``), so no global storage is
  kept alive;
* the gathers: a remat step all-gathers each layer's sharded leaves once
  a layer forward (``layer_forward_runs``), the recompute included;
* checkpoints: on (2, 4), the rows cut, three steps in a row against two
  steps, a save, a fresh world that restores, and one step, bit for
  bit; a save at step 0 writes the bytes (the manifest's sha256) of the
  one-rank save of that state.

The reference's subprocess and the port's first world start at once in a
module-scoped fixture; the restoring world follows.  This module imports
neither JAX nor ``repro``, so the spawned ranks, which import it, stay
light.
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
from repro_torch.distributed import launch, rank_local
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.mesh import Mesh, cut
from repro_torch.models import common as cm
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import ZonedCheckpointStore
from repro_torch.train import (
    TrainState, make_train_step, state_logical_axes, state_spec)
from repro_torch.utils.comm_stats import record_collectives
from repro_torch.utils.tree import tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 8
MESH = (2, 4)
#: the strict cases' mesh: a data axis of one rank, so no rows are cut
STRICT_MESH = (1, 8)
#: Seconds either side may go without progress before it is killed.
TIMEOUT = 240
#: The reference's gate (tests/test_multidevice.py): bfloat16
#: activations, so the loss agrees to O(1e-3) relative across frameworks
GATE_LOSS_REL = 5e-3
GATE_PARAM_ATOL = 2e-3
#: params, m and v after a rank-local step against the one-rank step,
#: relative to each leaf's largest magnitude: the global norm is summed in
#: another order, and where the clip scale moves by an ulp, an element
#: that the update brings near zero moves by much more than an ulp of
#: itself (mamba2's smoke in_proj: 6.6e-5 of an element of 7.1e-6 in a
#: leaf scaled 0.57)
STATE_RTOL = 1e-6
ARCHS = ["tinyllama-1.1b", "qwen3-4b", "qwen2-moe-a2.7b", "mamba2-370m",
         "recurrentgemma-9b", "internvl2-26b", "musicgen-large"]
#: (name, arch, config overrides, microbatches)
CASES = [(a, a, {}, 1) for a in ARCHS] + [
    ("tinyllama-1.1b/remat-none", "tinyllama-1.1b", {"remat": "none"}, 1),
    ("tinyllama-1.1b/microbatches-2", "tinyllama-1.1b", {}, 2)]
OPT = AdamWConfig(lr=3e-3, warmup_steps=0, total_steps=10)
#: the restart's store
N_HOSTS = 2


def _rules():
    return sh.make_rules(data_axes=("data",))


def _strict_rules():
    """The strict cases' rules: FSDP over both axes and nothing on
    ``model`` (the reference's ``make_rules`` with its model axis one the
    mesh lacks), so every weight is gathered whole and the gathered
    weights are the one-rank step's numbers; under ``_rules()`` the ranks
    along ``model`` compute blocks of the heads and columns
    (``tests/test_torch_tensor_parallel.py``)."""
    return sh.make_rules(data_axes=("data",), fsdp_axes=("data", "model"),
                         model_axis="tp")


def _gate_config():
    return dataclasses.replace(get_smoke_config("tinyllama-1.1b"),
                               remat="none")


def _tokens(cfg, seed: int, batch: int = 8, seq: int = 16):
    shape = (batch, seq) + ((cfg.num_codebooks,)
                            if cfg.num_codebooks > 1 else ())
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape))


def _state(cfg, seed: int = 0) -> TrainState:
    return TrainState.create(cfg, torch.Generator().manual_seed(seed),
                             device="cpu")


def _grads(cfg, state, tokens, microbatches: int):
    """``(loss, gradient tree)`` of the step's backward, as
    ``make_train_step`` takes it (microbatches accumulated and
    scaled)."""
    model = state.params
    grads = M.bind_grads(cfg, model)
    n = tokens.shape[0] // microbatches
    total = 0.0
    for i in range(microbatches):
        loss, _ = M.loss_fn(cfg, model, {"tokens": tokens[i * n:(i + 1) * n]})
        loss.backward()
        total = total + loss.detach()
    if microbatches > 1:
        for g in tree_leaves(grads):
            g.mul_(1.0 / microbatches)
        total = total / microbatches
    for p in model.parameters():
        p.grad = None
    return total, grads


def _state_leaves(state):
    return tree_leaves({"params": state.params.param_tree(),
                        "opt": state.opt})


def _state_specs(state):
    layout = rank_local.layout_of(state.params)
    return rank_local.spec_leaves(
        {"params": state.params.param_tree(), "opt": state.opt},
        {"params": layout.specs.params, "opt": layout.specs.opt})


def _storages_bytes(state) -> int:
    """The bytes of the distinct storages a state's tensors hold."""
    seen = {}
    for t in list(state.params.parameters()) + _state_leaves(state):
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def _strict_case(mesh, name, arch, over, microbatches) -> dict:
    cfg = dataclasses.replace(get_smoke_config(arch), **over)
    layout = rank_local.layout_for(cfg, mesh, _strict_rules())
    tokens = _tokens(cfg, seed=len(name))
    one = _state(cfg)
    local = rank_local.shard_state(cfg, _state(cfg), layout)
    l1, g1 = _grads(cfg, one, tokens, microbatches)
    with record_collectives() as rec:
        l2, g2 = _grads(cfg, local, tokens, microbatches)
    gspecs = rank_local.spec_leaves(g2, layout.specs.params)
    out = {"loss_equal": bool(torch.equal(l1, l2)),
           "grad_blocks_equal": [
               bool(torch.equal(cut(mesh, a, s), b))
               for a, b, s in zip(tree_leaves(g1), tree_leaves(g2), gspecs)],
           "gathers": rec.stats("state").count["all-gather"],
           "other_collectives": sum(rec.stats(site).total_result_bytes
                                    for site in ("body", "boundary", "grad",
                                                 "rows"))}
    step = make_train_step(cfg, OPT, microbatches=microbatches)
    one, m1 = step(one, {"tokens": tokens})
    local, m2 = step(local, {"tokens": tokens})
    out["step_loss_equal"] = bool(torch.equal(m1["loss"], m2["loss"]))
    out["grad_norm"] = (float(m1["grad_norm"]), float(m2["grad_norm"]))
    worst = 0.0
    for a, b, s in zip(_state_leaves(one), _state_leaves(local),
                       _state_specs(local)):
        want = cut(mesh, a, s).detach().double()
        got = b.detach().double()
        scale = float(want.abs().max())
        if scale > 0:
            worst = max(worst, float((got - want).abs().max()) / scale)
    out["state_rel_err"] = worst
    # the memory a rank holds: its blocks, and no global storage
    from repro_torch.launch.dryrun import _sharded_bytes
    spec, axes = state_spec(cfg), state_logical_axes(cfg)
    out["held_bytes"] = _storages_bytes(local)
    out["block_bytes"] = sum(
        _sharded_bytes(getattr(spec, k), getattr(axes, k), mesh,
                       _strict_rules())
        for k in ("params", "opt"))
    out["global_bytes"] = sum(t.nbytes for t in tree_leaves(
        {"params": spec.params, "opt": spec.opt}))
    # the gathers of one forward with no gradient, and the spec's count
    # of a unit's (a layer's, or a pattern group's) and the rest's
    with torch.no_grad(), record_collectives() as rec:
        M.forward(cfg, local.params, tokens[:tokens.shape[0] // microbatches])
    out["forward_gathers"] = rec.stats("state").count["all-gather"]
    out["spec_gathers"] = {k: n for k, (n, _) in
                           rank_local.forward_gathers(cfg, layout).items()}
    return out


def _gate(mesh, x) -> dict:
    cfg = _gate_config()
    tree = {"step": x["gate_step"], "params": _unflat(x, "p/"),
            "opt": {"m": _unflat(x, "m/"), "v": _unflat(x, "v/")}}
    state = M.train_state_from_reference(cfg, tree, device="cpu")
    layout = rank_local.layout_for(cfg, mesh, _rules())
    state = rank_local.shard_state(cfg, state, layout)
    step = make_train_step(cfg, AdamWConfig(warmup_steps=0))
    state, metrics = step(state, {"tokens": torch.from_numpy(
        x["gate_tokens"]).long()})
    host = rank_local.host_tree(state)
    if host is None:
        return {}
    return {"loss": float(metrics["loss"]),
            "leaf0": tree_leaves(host["params"])[0].float().numpy()}


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


def _restart_config():
    return get_smoke_config("tinyllama-1.1b")


def _batch(cfg, i: int) -> dict:
    return {"tokens": _tokens(cfg, seed=100 + i)}


def _host_bytes(tree) -> list:
    return [t.contiguous().view(torch.uint8).numpy().tobytes()
            if isinstance(t, torch.Tensor) else np.asarray(t).tobytes()
            for t in tree_leaves(tree)]


def _port_rank(rank, report, inpath, root):
    torch.set_num_threads(1)
    x = dict(np.load(inpath))
    mesh = Mesh(MESH, ("data", "model"), backend="gloo", device="cpu")
    strict = Mesh(STRICT_MESH, ("data", "model"), backend="gloo",
                  device="cpu")
    out = {"gate": _gate(mesh, x), "cases": {}}
    for name, arch, over, mb in CASES:
        out["cases"][name] = _strict_case(strict, name, arch, over, mb)
        report(f"rank {rank}: {name}")
    # checkpoints: a save at step 0; three steps in a row; two and a save
    cfg = _restart_config()
    layout = rank_local.layout_for(cfg, mesh, _rules())
    step = make_train_step(cfg, OPT)
    state = rank_local.init_state(cfg, layout, torch.Generator().manual_seed(0),
                                  device="cpu")
    saved0 = rank_local.save(
        ZonedCheckpointStore(os.path.join(root, "step0"), N_HOSTS,
                             device="cpu"), 0, state)
    for i in range(3):
        state, _ = step(state, _batch(cfg, i))
        if i == 1:
            rank_local.save(ZonedCheckpointStore(
                os.path.join(root, "restart"), N_HOSTS, device="cpu"),
                2, state)
    host = rank_local.host_tree(state)
    if rank == 0:
        out["saved0"] = saved0["manifest"]["hosts"]
        out["three_steps"] = _host_bytes(host)
    return out if rank == 0 else None


def _restore_rank(rank, report, root):
    torch.set_num_threads(1)
    mesh = Mesh(MESH, ("data", "model"), backend="gloo", device="cpu")
    cfg = _restart_config()
    layout = rank_local.layout_for(cfg, mesh, _rules())
    state = rank_local.init_state(cfg, layout,
                                  torch.Generator().manual_seed(99),
                                  device="cpu")
    store = ZonedCheckpointStore(os.path.join(root, "restart"), N_HOSTS,
                                 device="cpu")
    restored, _ = store.restore(store.latest_step(), state.tree())
    state.load(restored)
    state, _ = make_train_step(cfg, OPT)(state, _batch(cfg, state.step))
    host = rank_local.host_tree(state)
    return {"step": state.step, "bytes": _host_bytes(host)} \
        if rank == 0 else None


REFERENCE = """
import sys
import numpy as np, jax, jax.numpy as jnp, dataclasses
from jax.sharding import Mesh, NamedSharding, PartitionSpec as PS
from repro.configs import get_smoke_config
from repro.optim import AdamWConfig
from repro.train import TrainState, make_train_step, state_logical_axes, state_spec
from repro.distributed import sharding as sh

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
cfg = dataclasses.replace(get_smoke_config("tinyllama-1.1b"), remat="none")
state = TrainState(step=jnp.asarray(x["gate_step"]), params=tree("p/"),
                   opt={"m": tree("m/"), "v": tree("v/")})
toks = jnp.asarray(x["gate_tokens"])
step = make_train_step(cfg, AdamWConfig(warmup_steps=0))
mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
rules = sh.make_rules(data_axes=("data",))
st_sh = sh.tree_shardings_for(state_spec(cfg), state_logical_axes(cfg), mesh, rules)
b_sh = {"tokens": NamedSharding(mesh, PS("data"))}
with mesh:
    s2, m2 = jax.jit(step, in_shardings=(st_sh, b_sh),
                     out_shardings=(st_sh, None))(state, {"tokens": toks})
np.savez(sys.argv[2], loss=np.asarray(m2["loss"], np.float32),
         leaf0=np.asarray(jax.tree.leaves(s2.params)[0], np.float32))
"""


def _flat(tree, prefix):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _inputs() -> dict:
    cfg = _gate_config()
    ref = M.train_state_to_reference(_state(cfg))
    x = {"gate_step": ref["step"],
         "gate_tokens": np.random.default_rng(0).integers(
             0, cfg.vocab_size, (8, 32)).astype(np.int32)}
    for name, tree in (("p/", ref["params"]), ("m/", ref["opt"]["m"]),
                       ("v/", ref["opt"]["v"])):
        x.update(_flat(tree, name))
    return x


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rank_local")
    inpath, refpath = str(tmp / "inputs.npz"), str(tmp / "reference.npz")
    np.savez(inpath, **_inputs())
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    ref_proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REFERENCE), inpath, refpath],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=REPO)
    try:
        port = launch.run(_port_rank, WORLD, backend="gloo", device="cpu",
                          args=(inpath, str(tmp)), timeout=TIMEOUT)[0]
        port["restored"] = launch.run(_restore_rank, WORLD, backend="gloo",
                                      device="cpu", args=(str(tmp),),
                                      timeout=TIMEOUT)[0]
        _, err = ref_proc.communicate(timeout=TIMEOUT)
    finally:
        if ref_proc.poll() is None:
            ref_proc.kill()
            ref_proc.communicate()
    assert ref_proc.returncode == 0, err[-4000:]
    return dict(np.load(refpath)), port, str(tmp)


def test_rank_local_step_meets_the_reference_sharded_step(sides):
    """tests/test_multidevice.py's gate, with the port's rank-local step
    in place of the reference's single-device one."""
    ref, port, _ = sides
    want, got = float(ref["loss"]), port["gate"]["loss"]
    assert abs(got - want) / want < GATE_LOSS_REL, (got, want)
    np.testing.assert_allclose(port["gate"]["leaf0"], ref["leaf0"],
                               atol=GATE_PARAM_ATOL)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_loss_and_gradient_blocks_bit_equal_one_rank(sides, name):
    case = sides[1]["cases"][name]
    assert case["loss_equal"] and case["step_loss_equal"]
    assert case["grad_blocks_equal"] and all(case["grad_blocks_equal"])
    # the global norm: each element once, summed in another order
    a, b = case["grad_norm"]
    assert abs(a - b) <= STATE_RTOL * a


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_state_after_the_step_matches_one_rank(sides, name):
    assert sides[1]["cases"][name]["state_rel_err"] <= STATE_RTOL


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_a_rank_holds_only_its_blocks(sides, name):
    """Rank 0's live state storages sum to its blocks' bytes: no global
    storage (a view kept of a global tensor) stays alive."""
    case = sides[1]["cases"][name]
    assert case["held_bytes"] == case["block_bytes"]
    assert case["block_bytes"] < case["global_bytes"]


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_a_step_gathers_each_layer_once_a_layer_forward(sides, name):
    """A forward reads each leaf where it uses it (the layers' inside
    their checkpointed regions); a step gathers each unit's leaves once a
    unit forward, the remat recomputes' included (``layer_forward_runs``),
    and the gathers' backward is no collective: nothing else is."""
    _, arch, over, mb = next(c for c in CASES if c[0] == name)
    cfg = dataclasses.replace(get_smoke_config(arch), **over)
    case = sides[1]["cases"][name]
    units = (cfg.num_layers // len(cfg.block_pattern)
             if cfg.family == "hybrid" else cfg.num_layers)
    n = case["spec_gathers"]
    assert n["unit"] > 0
    assert case["forward_gathers"] == units * n["unit"] + n["rest"]
    runs = cm.layer_forward_runs(cfg, units)
    assert case["gathers"] == mb * (case["forward_gathers"]
                                    + (runs - units) * n["unit"])
    # a data axis of one rank cuts no rows: no gradient sum either
    assert case["other_collectives"] == 0


def test_restart_from_a_rank_local_checkpoint_is_bit_exact(sides):
    """Two steps, a save, a fresh world (another seed) that restores, and
    one step: the blocks equal three steps in a row, bit for bit."""
    port = sides[1]
    assert port["restored"]["step"] == 3
    assert port["restored"]["bytes"] == port["three_steps"]


def test_step0_save_writes_the_one_rank_save_bytes(sides):
    """Rank 0 writes the reference's layout: the same files as the
    one-rank save of the same state (sha256 of each host's file)."""
    _, port, tmp = sides
    cfg = _restart_config()
    store = ZonedCheckpointStore(os.path.join(tmp, "one_rank"), N_HOSTS,
                                 device="cpu")
    want = store.save(0, _state(cfg).tree())["manifest"]["hosts"]
    got = port["saved0"]
    assert [h["sha256"] for h in got.values()] == \
        [h["sha256"] for h in want.values()]
    assert [h["bytes"] for h in got.values()] == \
        [h["bytes"] for h in want.values()]


def test_block_shapes_and_replicas():
    """Blocks divide each sharded dim by its axes' extent; a replicated
    leaf is held whole, on every rank."""
    from repro_torch.distributed.mesh import AbstractMesh
    mesh = AbstractMesh((2, 4), ("data", "model"))
    layout = rank_local.Layout(mesh, None)
    PS = sh.PartitionSpec
    assert rank_local.block_shape(mesh, (8, 12, 3), PS("data", "model")) \
        == (4, 3, 3)
    assert rank_local.block_shape(mesh, (8, 12), PS(("data", "model"))) == \
        (1, 12)
    assert rank_local.block_shape(mesh, (8,), PS()) == (8,)
    assert layout.replicas(PS()) == 8
    assert layout.replicas(PS("model")) == 2
    assert layout.replicas(PS(None, ("data", "model"))) == 1
    with pytest.raises(ValueError, match="divide"):
        rank_local.block_shape(mesh, (6,), PS("model"))


def test_state_specs_are_tree_shardings_for_the_state():
    """The specs rank_local stores by are ``tree_shardings_for`` of the
    state's fields, as the reference maps its registered dataclass."""
    from repro_torch.distributed.mesh import AbstractMesh
    from repro_torch.train import state_logical_axes
    cfg = get_smoke_config("mamba2-370m")
    mesh = AbstractMesh(MESH, ("data", "model"))
    specs = rank_local.specs_for(cfg, mesh, _rules())
    assert isinstance(specs, TrainState)
    want = sh.tree_shardings_for(state_spec(cfg).params,
                                 state_logical_axes(cfg).params, mesh,
                                 _rules())
    assert specs.params == want == specs.opt["m"] == specs.opt["v"]
    assert specs.step == sh.PartitionSpec()
    # three of mamba2's smoke leaves are replicated on (2, 4)
    whole = [p for p, _, s in rank_local._pairs(state_spec(cfg).params,
                                                 specs.params)
             if not any(e is not None for e in s)]
    assert len(whole) == 3, whole


def test_one_rank_mesh_parametrizes_nothing():
    """On a 1 x 1 mesh a rank-local state is the one-rank state: whole
    leaves, no parametrization, no collective in the step."""
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_mesh
    cfg = get_smoke_config("tinyllama-1.1b")
    with fake_world(1):
        mesh = make_mesh((1, 1), ("data", "model"))
        layout = rank_local.layout_for(cfg, mesh, _rules())
        local = rank_local.shard_state(cfg, _state(cfg), layout)
        assert not any(torch.nn.utils.parametrize.is_parametrized(m)
                       for m in local.params.modules())
        one = _state(cfg)
        step = make_train_step(cfg, OPT)
        tokens = {"tokens": _tokens(cfg, 0)}
        with record_collectives() as rec:
            local, m2 = step(local, tokens)
        one, m1 = step(one, tokens)
    assert torch.equal(m1["loss"], m2["loss"])
    assert rec.stats().count["all-gather"] == 0
    assert all(torch.equal(a, b) for a, b in zip(_state_leaves(one),
                                                  _state_leaves(local)))
