"""The port's dry run, specs, meshes, presets and roofline
(``repro_torch.launch``, ``repro_torch.configs.presets``,
``repro_torch.utils.comm_stats``) held against ``repro``'s.

The reference runs as its own tests run it: one subprocess with eight
virtual CPU devices (``XLA_FLAGS``, ``REPRO_DRYRUN_DEVICES=8``,
``REPRO_MESH_SHAPE=2x4``), started once for the file and read when a
test needs it.  It compiles tinyllama-1.1b's decode_32k cell and three
small cells (XLA's ``argument_bytes``), and ring attention, flash-decode
and the expert-parallel MoE (``collective_stats`` of the compiled HLO).
The port traces the same cells and programs on torch's ``fake`` process
group under ``FakeTensorMode`` in this process, and its CLI once in a
subprocess.  Spec, preset and roofline comparisons need no devices.
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import models as RM
from repro.configs import ARCH_IDS
from repro.configs import get_config as r_config
from repro.configs import get_optimized_config as r_optimized
from repro.configs import step_settings as r_step_settings
from repro.launch import roofline as RR
from repro.launch import specs as RSP
from repro.models.config import shapes_for as r_shapes_for
from repro.train import state_logical_axes as r_state_axes
from repro.train import state_spec as r_state_spec

from repro_torch import models as M
from repro_torch.configs import (
    get_config, get_optimized_config, get_smoke_config, step_settings)
from repro_torch.distributed import comm
from repro_torch.distributed.ctx import axis_rules
from repro_torch.distributed.flash_decode import flash_decode
from repro_torch.distributed.mesh import check_backend
from repro_torch.distributed.moe_parallel import moe_ffn_ep
from repro_torch.distributed.ring_attention import ring_attention
from repro_torch.launch import dryrun as D
from repro_torch.launch import roofline as R
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import data_axes, make_mesh, make_production_mesh
from repro_torch.models.config import SHAPES_BY_NAME, ShapeConfig, shapes_for
from repro_torch.models.moe import moe_spec
from repro_torch.train import state_logical_axes, state_spec
from repro_torch.utils import comm_stats
from repro_torch.utils.comm_stats import COLLECTIVES, record_collectives

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300
#: XLA's argument bytes of tinyllama-1.1b decode_32k on the 2x4 mesh
DECODE_ARG_BYTES = 12_395_925_764
#: Small cells (name, arch, ShapeConfig fields) for the argument bytes
SMALL = [("train", "tinyllama-1.1b", ("train_s", "train", 64, 8)),
         ("ssm_train", "mamba2-370m", ("train_s", "train", 128, 8)),
         ("hybrid_decode", "recurrentgemma-9b",
          ("decode_s", "decode", 256, 8))]
#: ring attention (B, Hq, Hkv, S, D) on (1, 4); flash-decode (B, K, rep,
#: S, D) on (2, 4); the EP MoE's tokens (B, S) on (2, 4)
RING = (2, 4, 2, 64, 32)
DECODE = (4, 2, 3, 256, 32)
EP_TOKENS = (4, 16)
#: the fit is an affine extrapolation of integers: exact
FIT_REL = 1e-9


def _ep_config(impl="ep"):
    return dataclasses.replace(
        get_smoke_config("qwen2-moe-a2.7b", dtype="float32"),
        moe_expert_pad=2, moe_capacity_factor=8.0, moe_impl=impl)


REFERENCE = """
import argparse, json, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.launch import dryrun as D
from repro.configs import get_smoke_config
from repro.distributed.ctx import axis_rules
from repro.distributed.flash_decode import flash_decode
from repro.distributed.moe_parallel import moe_ffn_ep
from repro.distributed.ring_attention import ring_attention
from repro.models.config import ShapeConfig
from repro.models.moe import moe_spec
from repro.utils.hlo import collective_stats

spec = json.loads(sys.argv[1])
args = argparse.Namespace(
    mode="full", out="", remat="", microbatches=8, no_fsdp=False,
    no_seqshard=False, no_ep=False, moe_impl="", moe_pad=0, sp=False,
    ring=False, remat_block=0, tag="")
out = {"cells": {}, "memory": {}, "flops": {}, "collectives": {}}
for shape in ("decode_32k", "long_500k"):
    r = D.run_cell("tinyllama-1.1b", shape, "single", args)
    r.pop("traceback", None)
    out["cells"][shape] = r
mesh = D.make_production_mesh()
rules = D._rules_for(mesh, args)
for name, arch, shp in spec["small"]:
    cfg = get_smoke_config(arch, kernel_impl="xla")
    with mesh, axis_rules(mesh, rules):
        compiled, _ = D.lower_cell(cfg, ShapeConfig(*shp), mesh, args)
    got = D.analyze(compiled)
    out["memory"][name] = got["memory"]
    out["flops"][name] = got["flops"]

def stats(f, *a):
    return collective_stats(jax.jit(f).lower(*a).compile().as_text()).as_dict()
f32 = lambda s: jax.ShapeDtypeStruct(tuple(s), jnp.float32)
m14 = Mesh(np.array(jax.devices()[:4]).reshape(1, 4), ("data", "model"))
b, hq, hkv, s, d = spec["ring"]
out["collectives"]["ring"] = stats(
    lambda q, k, v: ring_attention(m14, q, k, v, causal=True),
    f32((b, hq, s, d)), f32((b, hkv, s, d)), f32((b, hkv, s, d)))
b, k, rep, s, d = spec["decode"]
out["collectives"]["decode"] = stats(
    lambda q, ck, cv, pos: flash_decode(mesh, q, ck, cv, pos),
    f32((b, k, rep, d)), f32((b, k, s, d)), f32((b, k, s, d)),
    jax.ShapeDtypeStruct((), jnp.int32))
cfg = get_smoke_config("qwen2-moe-a2.7b", dtype="float32", moe_expert_pad=2,
                       moe_capacity_factor=8.0, moe_impl="ep")
p = {n: f32(leaf.shape) for n, leaf in moe_spec(cfg).items()
     if n in ("router", "w_gate", "w_up", "w_down")}
out["collectives"]["ep"] = stats(
    lambda p, x: moe_ffn_ep(cfg, mesh, p, x), p,
    f32(tuple(spec["ep_tokens"]) + (cfg.d_model,)))
print("JSON" + json.dumps(out))
"""


def _env(**extra) -> dict:
    env = dict(os.environ)
    env.update(PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu",
               REPRO_DRYRUN_DEVICES="8", REPRO_MESH_SHAPE="2x4")
    env.update(extra)
    return env


@pytest.fixture(scope="module", autouse=True)
def _reference_proc():
    """The reference's subprocess, started with the file's first test."""
    spec = {"small": SMALL, "ring": RING, "decode": DECODE,
            "ep_tokens": EP_TOKENS}
    proc = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, json.dumps(spec)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=8"))
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def ref(_reference_proc) -> dict:
    out, err = _reference_proc.communicate(timeout=TIMEOUT)
    assert _reference_proc.returncode == 0, err[-4000:]
    line = [x for x in out.splitlines() if x.startswith("JSON")][-1]
    return json.loads(line[4:])


def _args(**kw) -> argparse.Namespace:
    args = D.parser().parse_args(["--arch", "-", "--shape", "-"])
    return argparse.Namespace(**{**vars(args), **kw})


def _sds(x) -> tuple:
    return tuple(x.shape), str(np.dtype(x.dtype))


def _meta(t) -> tuple:
    assert t.device.type == "meta"
    return tuple(t.shape), str(t.dtype).replace("torch.", "")


def _paths(tree, prefix=()) -> dict:
    """``{path: leaf}`` over nested dicts (sorted keys)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_paths(tree[k], prefix + (k,)))
        return out
    return {prefix: tree}


# -- presets -------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_presets_match_reference(arch):
    assert dataclasses.asdict(get_optimized_config(arch)) == \
        dataclasses.asdict(r_optimized(arch))
    assert dataclasses.asdict(get_optimized_config(arch, remat="none")) == \
        dataclasses.asdict(r_optimized(arch, remat="none"))
    assert step_settings(arch) == r_step_settings(arch)


# -- specs ---------------------------------------------------------------------
def _cells():
    return [(a, s.name) for a in ARCH_IDS for s in shapes_for(get_config(a))]


@pytest.mark.parametrize("arch,shape", _cells())
def test_input_specs_match_reference(arch, shape):
    cfg, rcfg = get_config(arch), r_config(arch)
    assert [s.name for s in shapes_for(cfg)] == \
        [s.name for s in r_shapes_for(rcfg)]
    sc = SHAPES_BY_NAME[shape]
    got, want = _paths(SP.input_specs(cfg, sc)), \
        _paths(RSP.input_specs(rcfg, sc))
    assert list(got) == list(want)
    for path in got:
        assert _meta(got[path]) == _sds(want[path]), path
    if sc.kind == "decode":
        assert _paths(SP.decode_logical_axes(cfg)) == \
            _paths(RSP.decode_logical_axes(rcfg))
        assert {k: _meta(v) for k, v in _paths(M.cache_spec(
            cfg, sc.global_batch, sc.seq_len)).items()} == \
            {k: _sds(v) for k, v in _paths(RM.cache_spec(
                rcfg, sc.global_batch, sc.seq_len)).items()}
    else:
        assert SP.batch_logical_axes(cfg) == RSP.batch_logical_axes(rcfg)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_state_spec_matches_reference(arch):
    cfg, rcfg = get_config(arch), r_config(arch)
    st, rst = state_spec(cfg), r_state_spec(rcfg)
    assert _meta(st.step) == _sds(rst.step)
    for got, want in ((st.params, rst.params), (st.opt, rst.opt)):
        got, want = _paths(got), _paths(want)
        assert list(got) == list(want)
        assert all(_meta(got[p]) == _sds(want[p]) for p in got)
    ax, rax = state_logical_axes(cfg), r_state_axes(rcfg)
    assert ax.step is None and rax.step is None
    assert _paths(ax.params) == _paths(rax.params)
    assert _paths(ax.opt) == _paths(rax.opt)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen2-moe-a2.7b",
                                  "mamba2-370m", "recurrentgemma-9b",
                                  "musicgen-large", "internvl2-26b"])
def test_cache_spec_equals_init_cache(arch):
    cfg = get_smoke_config(arch)
    spec = _paths(M.cache_spec(cfg, 3, 40))
    real = _paths(M.init_cache(cfg, 3, 40, device="cpu"))
    assert list(spec) == list(real)
    for p in spec:
        assert spec[p].device.type == "meta"
        assert spec[p].shape == real[p].shape and \
            spec[p].dtype == real[p].dtype


# -- meshes --------------------------------------------------------------------
@pytest.mark.parametrize("multi,env,want", [
    (False, None, {"data": 16, "model": 16}),
    (True, None, {"pod": 2, "data": 16, "model": 16}),
    (False, "2x4", {"data": 2, "model": 4}),
    (True, "2x2x2", {"pod": 2, "data": 2, "model": 2}),
])
def test_production_mesh(monkeypatch, multi, env, want):
    for var in ("REPRO_MESH_SHAPE", "REPRO_MESH_SHAPE_MULTI"):
        monkeypatch.delenv(var, raising=False)
    if env:
        monkeypatch.setenv(
            "REPRO_MESH_SHAPE_MULTI" if multi else "REPRO_MESH_SHAPE", env)
    n = int(np.prod(list(want.values())))
    with D.fake_world(n):
        mesh = make_production_mesh(multi_pod=multi)
        assert mesh.shape == want and mesh.axis_names == tuple(want)
        assert mesh.backend == "fake" and mesh.rank == 0
        assert data_axes(mesh) == tuple(a for a in ("pod", "data")
                                        if a in want)
    with D.fake_world(n + 1), pytest.raises(RuntimeError, match="world"):
        make_production_mesh(multi_pod=multi)


def test_check_backend_accepts_fake():
    check_backend("fake", 512, "cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        check_backend("mpi", 2, "cpu")


# -- the collective recorder ---------------------------------------------------
def test_recorder_counts_semantic_kinds_only_inside():
    with D.fake_world(4):
        mesh = make_mesh((4,), ("model",))
        with FakeTensorMode():
            x = torch.empty((3, 5), dtype=torch.float32)
            comm.ppermute(mesh, x, "model", [(i, (i + 1) % 4)
                                            for i in range(4)])
            with record_collectives() as rec:
                comm.ppermute(mesh, x, "model", [(i, (i + 1) % 4)
                                                for i in range(4)])
                comm.psum(mesh, x, "model")
                comm.all_to_all(mesh, torch.empty((4, 2)), "model", 0, 1)
            comm.psum(mesh, x, "model")
    st = rec.stats()
    assert st.count == {"all-gather": 0, "all-reduce": 1,
                        "reduce-scatter": 0, "all-to-all": 1,
                        "collective-permute": 1}
    assert st.result_bytes["collective-permute"] == 60
    assert st.wire_bytes["all-reduce"] == 2 * 60
    assert st.result_bytes["all-to-all"] == 32
    assert set(st.as_dict()["count"]) == set(COLLECTIVES)


def test_recorder_takes_notes_from_other_threads():
    """The autograd engine runs a CUDA tensor's backward on a device
    thread of its own, which starts with an empty Python context: a
    collective noted there still counts."""
    with record_collectives() as rec:
        t = threading.Thread(
            target=comm_stats.note, args=("all-reduce", 8, 4, "boundary"))
        t.start()
        t.join()
    t = threading.Thread(target=comm_stats.note, args=("all-reduce", 8, 4))
    t.start()
    t.join()
    assert rec.records == [("all-reduce", 8, 4, "boundary")]


def test_a_collective_the_recorder_missed_fails_the_trace():
    meter = D._StepMeter()
    meter.collective_ops["c10d.allreduce_.default"] += 1
    with record_collectives() as rec:
        pass
    with pytest.raises(RuntimeError, match="collective recorder"):
        D._check_recorded(rec, meter)
    rec.note("all-reduce", 8, 4, "body")
    D._check_recorded(rec, meter)


def _port_collectives(world, shape, axes, fn) -> dict:
    with D.fake_world(world):
        mesh = make_mesh(shape, axes)
        with FakeTensorMode(), record_collectives() as rec:
            fn(mesh)
    return rec.stats("body").as_dict()


def _f32(*shape):
    return torch.empty(shape, dtype=torch.float32)


def test_collectives_match_xla(ref):
    """Result bytes per kind equal XLA's on the explicit-collective
    programs; counts differ only where XLA sends K and V of a ring step
    as two permutes (the port stacks them into one) or combines the
    flash-decode all-reduces."""
    b, hq, hkv, s, d = RING
    ring = _port_collectives(4, (1, 4), ("data", "model"), lambda m:
                             ring_attention(m, _f32(b, hq, s, d),
                                            _f32(b, hkv, s, d),
                                            _f32(b, hkv, s, d)))
    b, k, rep, s, d = DECODE
    dec = _port_collectives(8, (2, 4), ("data", "model"), lambda m:
                            flash_decode(m, _f32(b, k, rep, d),
                                         _f32(b, k, s, d), _f32(b, k, s, d),
                                         s - 1))
    cfg = _ep_config()
    shapes = {n: leaf.shape for n, leaf in moe_spec(cfg).items()
              if n in ("router", "w_gate", "w_up", "w_down")}
    ep = _port_collectives(8, (2, 4), ("data", "model"), lambda m:
                           moe_ffn_ep(cfg, m, {n: _f32(*s) for n, s in
                                               shapes.items()},
                                      _f32(*EP_TOKENS, cfg.d_model)))
    for name, got in (("ring", ring), ("decode", dec), ("ep", ep)):
        want = ref["collectives"][name]
        assert got["result_bytes"] == want["result_bytes"], name
        assert got["wire_bytes"] == want["wire_bytes"], name
    # counts: the ring's three steps are one stacked K/V permute each in
    # the port, one or two (K, V) in XLA's program
    assert ring["count"]["collective-permute"] == 3
    assert ref["collectives"]["ring"]["count"]["collective-permute"] in (3, 6)
    # flash-decode: pmax + two psums (XLA may combine the psums)
    assert dec["count"]["all-reduce"] == 3
    assert 1 <= ref["collectives"]["decode"]["count"]["all-reduce"] <= 3
    # EP: two all-to-alls and the aux pmean, as XLA's
    assert ep["count"] == ref["collectives"]["ep"]["count"]


# -- the dry run ---------------------------------------------------------------
def _trace_small(cells, microbatches=8):
    """``analyze`` of lower_cell of each ``(cfg, ShapeConfig)`` on one fake
    world of 8 ranks, mesh (2, 4)."""
    args = _args(microbatches=microbatches)
    out = []
    with D.fake_world(8):
        mesh = make_mesh((2, 4), ("data", "model"))
        with axis_rules(mesh, D._rules_for(mesh, args)):
            for cfg, sc in cells:
                trace, _ = D.lower_cell(cfg, sc, mesh, args)
                out.append(D.analyze(trace))
    return out


def _row_blocks(cfg, sc, microbatches) -> int:
    """The blocks the (2, 4) mesh's data axis cuts the cell's rows into,
    as the steps cut them (a train step a microbatch's rows, the serve
    steps the batch); 1 where they do not divide it."""
    from repro_torch.distributed import rank_local
    from repro_torch.distributed.mesh import AbstractMesh
    from repro_torch.serve.step import serving_cut
    mesh = AbstractMesh((2, 4), ("data", "model"))
    rules = D._rules_for(mesh, _args())
    if sc.kind == "train":
        c = rank_local.layout_for(cfg, mesh, rules).row_cut(
            cfg, SP.batch_specs(cfg, sc), microbatches)
    else:
        with axis_rules(mesh, rules):
            c = serving_cut(cfg, sc.global_batch, sc.seq_len)
    return c.n_rows if c is not None else 1


def _model_blocks(cfg) -> int:
    """The blocks the (2, 4) mesh's model axis cuts the cell's heads,
    MLP columns and vocabulary into (``tensor_parallel.local_names``): 4,
    or 1 where the family computes them whole."""
    from repro_torch.distributed import tensor_parallel as tpar
    from repro_torch.distributed.mesh import AbstractMesh
    mesh = AbstractMesh((2, 4), ("data", "model"))
    return 4 if tpar.local_names(cfg, mesh, D._rules_for(mesh, _args())) \
        else 1


def _model_ratio(name, cfg, sc, flops, rows=1) -> None:
    """Records the traced flops of a rank against its share of 6 N D
    (train) or 2 N D: its ``rows`` (:func:`_row_blocks`) and its blocks
    of the model axis (:func:`_model_blocks`).  Remat, the plain
    attention's masked scores and the key and value products (whole on
    every rank) put a training step with remat full above 1."""
    model = M.model_flops(cfg, sc.tokens if sc.kind != "decode"
                          else sc.global_batch, sc.kind) / (
        rows * _model_blocks(cfg))
    ratio = flops / model
    print(f"{name} {sc.kind}: traced flops / model flops {ratio:.4f}")
    if sc.kind == "train" and cfg.remat == "full":
        assert ratio >= 1.0


def test_sharded_argument_bytes_equal_xla(ref):
    cells = [(get_smoke_config(arch, kernel_impl="torch"), ShapeConfig(*shp))
             for _, arch, shp in SMALL]
    for (name, _, _), (cfg, sc), got in zip(SMALL, cells,
                                            _trace_small(cells)):
        want = ref["memory"][name]["argument_bytes"]
        assert got["memory"]["sharded_argument_bytes"] == want, name
        assert got["memory"]["argument_bytes"] >= want
        # rank 0 traces the global step (products only); XLA costs a
        # device's share (products and elementwise work; a training
        # cell's microbatch scan too, so only decode compares like for
        # like)
        ratio = got["flops"] / (ref["flops"][name] * 8)
        print(f"{name}: traced flops / (XLA's flops x 8 devices) "
              f"{ratio:.4f}")
        assert ratio > 0
        _model_ratio(name, cfg, sc, got["flops"], _row_blocks(cfg, sc, 8))
    assert ref["cells"]["decode_32k"]["full"]["memory"]["argument_bytes"] \
        == DECODE_ARG_BYTES


@pytest.mark.parametrize("name", [n for n, _, shp in SMALL
                                  if shp[1] == "train"])
def test_rank_local_argument_bytes_are_xla_s_and_the_batch_gap(ref, name):
    """Rank 0 holds its blocks of params, m and v
    (``distributed.rank_local``) and the whole batch (a rank computes the
    global step): XLA's argument_bytes plus the batch's global bytes less
    its share, to the byte; the blocks' gathers are recorded at the
    "state" site, and nothing else gathers."""
    from repro_torch.distributed.mesh import AbstractMesh
    _, arch, shp = next(c for c in SMALL if c[0] == name)
    cfg, sc = get_smoke_config(arch, kernel_impl="torch"), ShapeConfig(*shp)
    got = _trace_small([(cfg, sc)])[0]
    mesh = AbstractMesh((2, 4), ("data", "model"))
    batch = SP.batch_specs(cfg, sc)
    gap = sum(t.nbytes for t in batch.values()) - D._sharded_bytes(
        batch, SP.batch_logical_axes(cfg), mesh, D._rules_for(mesh, _args()))
    assert gap > 0
    assert got["memory"]["argument_bytes"] == \
        ref["memory"][name]["argument_bytes"] + gap
    by_site = got["collectives_by_site"]
    assert by_site["state"]["count"]["all-gather"] > 0
    assert by_site["body"]["count"]["all-gather"] == 0
    assert by_site["boundary"]["count"]["all-gather"] == 0


def test_rows_cut_argument_bytes_and_flops_are_a_rank_s(ref):
    """Two microbatches of 4 rows divide the data axis: rank 0 holds
    exactly XLA's argument_bytes (its rows of the batch, no gap), traces
    half the products of the same step whose microbatches of one row
    stay whole (8 microbatches), within 0.5%, and sums the gradient over
    "data" at the "grad" site as ``rank_local.backward_sums`` counts."""
    from repro_torch.distributed import rank_local
    from repro_torch.distributed.mesh import AbstractMesh
    _, arch, shp = SMALL[0]
    cfg, sc = get_smoke_config(arch, kernel_impl="torch"), ShapeConfig(*shp)
    whole = _trace_small([(cfg, sc)], microbatches=8)[0]
    rows = _trace_small([(cfg, sc)], microbatches=2)[0]
    assert (_row_blocks(cfg, sc, 8), _row_blocks(cfg, sc, 2)) == (1, 2)
    assert rows["memory"]["argument_bytes"] == \
        rows["memory"]["sharded_argument_bytes"] == \
        ref["memory"]["train"]["argument_bytes"]
    assert whole["memory"]["argument_bytes"] > \
        rows["memory"]["argument_bytes"]
    assert abs(whole["flops"] / rows["flops"] - 2) <= 2 * 0.005
    mesh = AbstractMesh((2, 4), ("data", "model"))
    layout = rank_local.layout_for(cfg, mesh, D._rules_for(mesh, _args()))
    n = rank_local.backward_sums(cfg, layout, ("data",))
    grad = rows["collectives_by_site"]["grad"]
    assert sum(grad["count"].values()) == \
        2 * (cfg.num_layers * n["unit"][0] + n["rest"][0]) + n["whole"][0]
    assert whole["collectives_by_site"]["grad"]["total_result_bytes"] == 0


def test_dryrun_cli_matches_reference(ref, tmp_path):
    """The acceptance command, on a CPU-only machine: 8 fake ranks, 2x4."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "tinyllama-1.1b", "--shape", "decode_32k", "--mesh", "single",
         "--mode", "full", "--out", str(tmp_path)],
        capture_output=True, text=True, env=_env(), timeout=TIMEOUT,
        cwd=REPO)
    assert out.returncode == 0, out.stderr[-4000:]
    assert f"sharded_argument_bytes={DECODE_ARG_BYTES}" in out.stdout
    assert "gap=" in out.stdout
    with open(tmp_path / "tinyllama-1.1b_decode_32k_single.json") as f:
        got = json.load(f)
    want = ref["cells"]["decode_32k"]
    assert set(want) <= set(got)
    for section in ("full", "full/memory", "full/collectives"):
        g, w = got, want
        for k in section.split("/"):
            g, w = g[k], w[k]
        assert set(w) <= set(g), section
    for k in ("params", "active_params", "model_flops", "mesh_shape",
              "status"):
        assert got[k] == want[k], k
    mem = got["full"]["memory"]
    assert mem["sharded_argument_bytes"] == DECODE_ARG_BYTES
    # a rank holds what a device holds under the shardings: its block of
    # the cache (rows over data, slots over model) and of the tokens
    assert mem["argument_bytes"] == DECODE_ARG_BYTES
    # the KV cache block is updated in place: it aliases its input
    cache = M.cache_spec(get_config("tinyllama-1.1b"), 128, 32768)
    assert mem["alias_bytes"] >= sum(t.nbytes for t in cache.values()) // 8
    # the rank's 64 of the 128 rows and its quarter of the heads, MLP
    # columns and vocabulary, every query head attending over its 8,192
    # slots
    assert got["full"]["flops"] > got["model_flops"] / (
        2 * _model_blocks(get_config("tinyllama-1.1b")))
    print(f"decode_32k: traced flops / (XLA's flops x 8 devices) "
          f"{got['full']['flops'] / (want['full']['flops'] * 8):.4f}")
    cfg, sc = get_config("tinyllama-1.1b"), SHAPES_BY_NAME["decode_32k"]
    _model_ratio("tinyllama-1.1b", cfg, sc, got["full"]["flops"],
                 _row_blocks(cfg, sc, 1))
    # the parameters are rank 0's blocks (distributed.rank_local), each
    # gathered where the step reads it, at the "state" site, as XLA's
    # program gathers its sharded weights; the cut's collectives at the
    # "rows" site: each layer's softmax combined over the slots' blocks
    # (a pmax and two psums) and the next tokens gathered; nothing else
    by_site = got["full"]["collectives_by_site"]
    assert by_site["state"]["count"]["all-gather"] > 0
    rows = by_site["rows"]["count"]
    assert rows["all-reduce"] == 3 * get_config("tinyllama-1.1b").num_layers
    assert rows["all-gather"] == 1
    for kind in COLLECTIVES:
        assert by_site["body"]["count"][kind] == 0
        assert by_site["boundary"]["count"][kind] == 0
        assert by_site["grad"]["count"][kind] == 0
        if kind not in ("all-gather", "all-reduce"):
            assert got["full"]["collectives"]["count"][kind] == 0
    long = D.run_cell("tinyllama-1.1b", "long_500k", "single", _args())
    assert long == ref["cells"]["long_500k"]


FIT_CELLS = [
    # blocked remat (12 layers, blocks of 4): depths 4 and 8
    ("tinyllama-1.1b", dict(num_layers=12), ("t", "train", 32, 4), (4, 8)),
    ("tinyllama-1.1b", dict(num_layers=12), ("d", "decode", 64, 4), (2, 3)),
    # 7 layers, no block divides: layer checkpoints, the reference's depths
    ("tinyllama-1.1b", dict(num_layers=7), ("t", "train", 32, 4), (2, 3)),
    # the hybrid's 6 groups of 3 in blocks of 2, plus its 2-layer tail
    ("recurrentgemma-9b", dict(num_layers=20, remat_block=2),
     ("t", "train", 32, 4), (8, 14)),
]


@pytest.mark.parametrize("arch,over,shape,depths", FIT_CELLS)
def test_fit_equals_full_trace(arch, over, shape, depths):
    cfg = get_smoke_config(arch, kernel_impl="torch", **over)
    sc = ShapeConfig(*shape)
    args = _args(microbatches=1)
    with D.fake_world(8):
        mesh = make_mesh((2, 4), ("data", "model"))
        with axis_rules(mesh, D._rules_for(mesh, args)):
            trace, _ = D.lower_cell(cfg, sc, mesh, args)
            full = D.analyze(trace)
            fit = D.run_fit(cfg, sc, mesh, args)
    assert fit["depths"] == list(depths)
    for key in ("flops", "bytes_accessed"):
        assert abs(fit[key] - full[key]) <= FIT_REL * full[key], key
    _model_ratio(f"{arch} {over}", cfg, sc, full["flops"],
                 _row_blocks(cfg, sc, 1))


def test_moe_train_step_traces_and_two_families_in_a_row():
    """qwen2-moe's smoke train step traces (its routing counts have a
    static shape), then two more families in the same process."""
    sc = ShapeConfig("t", "train", 32, 4)
    cells = [(get_smoke_config("qwen2-moe-a2.7b", kernel_impl="torch"), sc),
             (get_smoke_config("mamba2-370m", kernel_impl="torch"),
              ShapeConfig("t", "train", 64, 4)),
             (get_smoke_config("recurrentgemma-9b", kernel_impl="torch"),
              sc)]
    for (cfg, sc), got in zip(cells, _trace_small(cells, microbatches=2)):
        assert got["flops"] > 0 and got["memory"]["temp_bytes"] > 0
        _model_ratio(cfg.name, cfg, sc, got["flops"], _row_blocks(cfg, sc, 2))
        # the train step updates the state in place
        assert got["memory"]["alias_bytes"] > 0


@pytest.mark.parametrize("device", sorted({D.TRACE_DEVICE, "cpu"}))
def test_backward_collectives_are_recorded(monkeypatch, device):
    """The expert-parallel MoE's train step, remat full layer by layer:
    each layer's forward runs twice (the step, then its recompute) and its
    backward once more, reversing every all-to-all and psum'ing the aux
    loss's cotangent, so the body's collectives are three times the
    forward's, in count and in bytes.  shard_map's boundary all-reduces
    (the cotangent of a cut over the axes its spec leaves out) exist only
    in the backward."""
    monkeypatch.setattr(D, "TRACE_DEVICE", device)
    cfg = dataclasses.replace(_ep_config(), kernel_impl="torch",
                              num_layers=2, remat="full", remat_block=1)
    train, fwd = _trace_small([(cfg, ShapeConfig("t", "train", 32, 4)),
                               (cfg, ShapeConfig("t", "prefill", 32, 4))],
                              microbatches=1)
    tb, fb = (x["collectives_by_site"]["body"] for x in (train, fwd))
    assert fb["count"]["all-to-all"] == 2 * cfg.num_layers
    for kind in COLLECTIVES:
        assert tb["count"][kind] == 3 * fb["count"][kind], kind
        assert tb["result_bytes"][kind] == 3 * fb["result_bytes"][kind], kind
    te, fe = (x["collectives_by_site"]["boundary"] for x in (train, fwd))
    assert fe["count"]["all-reduce"] == 0 < te["count"]["all-reduce"]


def test_analyze_names_the_device_a_trace_claimed(monkeypatch):
    """``lower_cell(device=)`` traces on that device whatever the module's
    default, and ``analyze`` labels the trace with it."""
    monkeypatch.setattr(D, "TRACE_DEVICE", "meta")
    cfg = dataclasses.replace(get_smoke_config("tinyllama-1.1b"),
                              kernel_impl="torch", num_layers=1)
    args = _args(microbatches=1)
    with D.fake_world(8):
        mesh = make_mesh((2, 4), ("data", "model"))
        with axis_rules(mesh, D._rules_for(mesh, args)):
            trace, _ = D.lower_cell(cfg, ShapeConfig("t", "prefill", 32, 4),
                                    mesh, args, device="cpu")
    assert trace.device == D.analyze(trace)["trace_device"] == "cpu"


def test_remat_recompute_keeps_the_sharding_context_off_thread():
    """The autograd engine recomputes a CUDA tensor's remat region on a
    device thread of its own, which starts with an empty Python context.
    A backward started from a fresh thread (the engine runs a CPU
    tensor's there) stands in for it: the recompute still runs under the
    forward's ``axis_rules`` (expert parallelism, the same shapes), and
    records the collectives a backward on the calling thread records."""
    cfg = dataclasses.replace(_ep_config(), kernel_impl="torch",
                              num_layers=2, remat="full", remat_block=1)
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    params.requires_grad_(True)
    batch = {"tokens": torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 32)).astype(np.int64))}
    args = _args(microbatches=1)
    got, errors = [], []

    def backward(loss):
        try:
            loss.backward()
        except Exception as e:  # noqa: BLE001 — re-raised on this thread
            errors.append(e)
    with D.fake_world(8):
        mesh = make_mesh((2, 4), ("data", "model"))
        with axis_rules(mesh, D._rules_for(mesh, args)):
            for thread in (False, True):
                with record_collectives() as rec:
                    loss, _ = M.loss_fn(cfg, params, batch)
                    if thread:
                        t = threading.Thread(target=backward, args=(loss,))
                        t.start()
                        t.join()
                    else:
                        backward(loss)
                got.append(rec.stats().as_dict())
    assert not errors, errors
    assert got[0] == got[1]
    assert got[1]["count"]["all-to-all"] == 3 * 2 * cfg.num_layers


FORWARD = """
import sys, numpy as np, torch
from repro_torch import models as M
from repro_torch.configs import get_smoke_config
cfg = get_smoke_config("tinyllama-1.1b")
params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
toks = torch.from_numpy(np.random.default_rng(0).integers(
    0, cfg.vocab_size, (2, 16)).astype(np.int64))
logits, _ = M.forward(cfg, params, toks)
np.save(sys.argv[1], logits.float().numpy())
"""


def test_real_forward_after_a_fake_trace_is_bit_equal(tmp_path):
    """A fake trace leaves no fake tensor in a cache: a real forward in
    the same process equals one in a fresh process bit for bit."""
    fresh = tmp_path / "fresh.npy"
    subprocess.run([sys.executable, "-c", FORWARD, str(fresh)], check=True,
                   env=_env(), timeout=TIMEOUT, cwd=REPO)
    cfg = get_smoke_config("tinyllama-1.1b")
    _trace_small([(dataclasses.replace(cfg, kernel_impl="torch"),
                   ShapeConfig("p", "prefill", 16, 2))])
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int64))
    logits, _ = M.forward(cfg, params, toks)
    want = np.load(fresh)
    got = logits.float().numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_step_meter_counts_bytes_and_peak():
    with FakeTensorMode():
        x = torch.empty((256,), dtype=torch.float32)         # 1 KiB
        meter = D._StepMeter()
        meter.hold(x)
        with meter:
            y = x * 2                                         # +1 KiB
            z = y.view(16, 16)                                # a view
            del y
            w = z + 1                                         # +1 KiB
            del z, w
            v = x.sum()
            # a shape spec on the meta device (the serve steps' cache
            # spec) holds and moves nothing
            spec = torch.zeros((1 << 20,), device="meta")
    assert meter.peak - 1024 == 2048
    # mul, add: 2 x (1 KiB in + 1 KiB out); sum: 1 KiB in + 4 B out
    assert meter.bytes_accessed == 2 * 2048 + 1024 + 4
    del v, spec


# -- the roofline --------------------------------------------------------------
def _records(ref) -> list:
    base = ref["cells"]["decode_32k"]
    fit = dict(base, shape="train_4k", model_flops=1e18,
               fit={"flops": 3e15, "bytes_accessed": 2e13,
                    "collective_wire_bytes": {"all-reduce": 4e11,
                                              "all-gather": 1e10}})
    skipped = ref["cells"]["long_500k"]
    err = dict(base, shape="prefill_32k", status="error")
    multi = dict(base, mesh="multi",
                 mesh_shape={"pod": 2, "data": 2, "model": 2})
    return [base, fit, skipped, err, multi]


def _write(records, d):
    d.mkdir(parents=True, exist_ok=True)
    for i, r in enumerate(records):
        (d / f"c{i}.json").write_text(json.dumps(r))


def test_roofline_equals_reference_at_its_constants(ref, tmp_path,
                                                    monkeypatch, capsys):
    recs = _records(ref)
    _write(recs, tmp_path / "a")
    _write([dict(recs[1], fit=None)], tmp_path / "b")
    for name, value in (("PEAK_FLOPS", RR.PEAK_FLOPS),
                        ("HBM_BW", RR.HBM_BW), ("LINK_BW", RR.ICI_BW)):
        monkeypatch.setattr(R, name, value)
    dirs = [str(tmp_path / "a"), str(tmp_path / "b")]
    assert R.load_cells(dirs) == RR.load_cells(dirs)
    for r in recs:
        assert R.roofline_row(r) == RR.roofline_row(r)
    for mesh in ("single", "multi"):
        R.main(["--in", *dirs, "--mesh", mesh,
                "--csv", str(tmp_path / "p.csv")])
        sys.argv = ["roofline", "--in", *dirs, "--mesh", mesh,
                    "--csv", str(tmp_path / "r.csv")]
        RR.main()
        assert (tmp_path / "p.csv").read_text() == \
            (tmp_path / "r.csv").read_text()
    capsys.readouterr()


def test_roofline_terms_scale_by_the_constants(ref):
    for r in _records(ref):
        got, want = R.roofline_row(r), RR.roofline_row(r)
        if want is None:
            assert got is None
            continue
        for term, ours, theirs in (("t_compute_s", R.PEAK_FLOPS,
                                    RR.PEAK_FLOPS),
                                   ("t_memory_s", R.HBM_BW, RR.HBM_BW),
                                   ("t_collective_s", R.LINK_BW, RR.ICI_BW)):
            assert got[term] == pytest.approx(want[term] * theirs / ours,
                                              rel=1e-12), term
        assert got["useful_flop_ratio"] == want["useful_flop_ratio"]
    assert R.PEAK_FLOPS == R.PEAK_OPS_PER_S["bfloat16"]


def test_dryrun_writes_outside_the_reference_reports():
    assert D.parser().get_default("out") == "reports/dryrun_torch"
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert "reports/dryrun_torch/" in f.read().split()


def test_collective_sites_are_kept_apart():
    """shard_map's boundary (every rank holds the global tensors) records
    apart from the body's collectives."""
    b, hq, hkv, s, d = RING
    with D.fake_world(4):
        mesh = make_mesh((1, 4), ("data", "model"))
        with FakeTensorMode(), record_collectives() as rec:
            ring_attention(mesh, _f32(b, hq, s, d), _f32(b, hkv, s, d),
                           _f32(b, hkv, s, d))
    body, edge = rec.stats("body"), rec.stats("boundary")
    assert body.count["all-gather"] == 0
    # the output gathered over "data" (a group of 1: the block) and then
    # over "model" (the whole output)
    assert edge.count["all-gather"] == 2
    assert edge.result_bytes["all-gather"] == b * hq * s * d * 4 * 5 // 4
    assert rec.stats().total_result_bytes == \
        body.total_result_bytes + edge.total_result_bytes


def test_optimized_cell_uses_the_presets():
    args = _args(optimized=True)
    cfg = D.cell_config("qwen2-moe-a2.7b", args)
    assert cfg.moe_impl == "ep" and cfg.moe_expert_pad == 4
    assert cfg.kernel_impl == "torch"
