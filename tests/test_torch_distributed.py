"""The port's ``repro_torch.distributed`` held against ``repro.distributed``.

The same numpy inputs (from seeds) go through the reference, run as its
own tests run it (a subprocess with eight virtual CPU devices,
``XLA_FLAGS=--xla_force_host_platform_device_count=8``, meshes (2, 4)
and (4,)), and through the port on ``gloo`` ranks on the CPU at the
same meshes (``repro_torch.distributed.launch.run``: a world of eight
ranks for the (2, 4) mesh, then one of four for the (4,) meshes).  The
reference and the port start once for the file, at once, in a
module-scoped fixture; a world that stops reporting for
``TIMEOUT`` seconds is killed and fails the tests.  Covered: the
in-body collectives (``ppermute``, tiled ``all_to_all``, with their
gradients), ring attention (and its gradient against ``jax.grad``
through the reference's ring), flash-decode, the EP dispatch buffer and
the EP MoE logits, GPipe (forward and gradient), the compressed psum
with error feedback, and the two model call sites (qwen3's smoke forward
with ``ring_attention=True`` under a context, qwen2-moe's with
``moe_impl="ep"``).  Tolerances are those of the reference's own tests
(``test_ring_attention.py``, ``test_distributed_modules.py``,
``test_pipeline.py``).  This module imports neither JAX nor ``repro``
(only the reference's subprocess does), so the spawned ranks, which
import it, stay light; the model weights come from the port's init,
carried to the reference with ``params_to_reference``.
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
from repro_torch.distributed import comm, launch
from repro_torch.distributed import ctx as dctx
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.collectives import (
    compressed_psum_reference, ef_compressed_psum, init_error_state)
from repro_torch.distributed.flash_decode import flash_decode
from repro_torch.distributed.mesh import (
    AbstractMesh, Mesh, check_backend, shard_map)
from repro_torch.distributed.moe_parallel import _local_dispatch, moe_ffn_ep
from repro_torch.distributed.pipeline import (
    gpipe, stack_stage_fn, stages_from_stack)
from repro_torch.distributed.ring_attention import ring_attention
from repro_torch.distributed.sharding import PartitionSpec as PS
from repro_torch.kernels import ref

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 8
#: Seconds either side may go without progress before it is killed.
TIMEOUT = 180

RING_TOL = 2e-5
DECODE_TOL = 1e-4
EP_TOL = 1e-3
GPIPE_TOL = 1e-5
GPIPE_GRAD_TOL = 1e-4
#: bf16 wire: gloo rounds each partial sum to bfloat16, in its own order
EF_TOL = {"bf16": 2e-2, "int8": 1e-4}
#: The reference's model-level ring test: bfloat16 smoke activations
MODEL_TOL = 0.05
#: Collectives move values exactly; their float32 gradients too
COMM_TOL = 1e-6
#: Ring attention's gradient: float32, summed in another order than
#: jax's (the forward's 2e-5, on inputs of unit scale)
RING_GRAD_TOL = 1e-4

RING_SHAPES = [(2, 4, 2, 64, 32), (2, 8, 1, 128, 16)]
PP = [(i, (i + 1) % 4) for i in range(4)]


def _ep_configs():
    """The reference test's EP configs, in float32: the two frameworks'
    bfloat16 roundings fall at other places and reroute tokens (as
    test_torch_moe.py finds), so only float32 compares across them."""
    base = get_smoke_config("qwen2-moe-a2.7b", dtype="float32")
    gs = dataclasses.replace(base, moe_expert_pad=2, moe_capacity_factor=8.0)
    return gs, dataclasses.replace(gs, moe_impl="ep")


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    f32 = np.float32
    x = {}
    for i, (b, hq, hkv, s, d) in enumerate(RING_SHAPES):
        x[f"ring_q{i}"] = rng.standard_normal((b, hq, s, d)).astype(f32)
        x[f"ring_k{i}"] = rng.standard_normal((b, hkv, s, d)).astype(f32)
        x[f"ring_v{i}"] = rng.standard_normal((b, hkv, s, d)).astype(f32)
    B, K, rep, S, D = 4, 2, 3, 64, 32
    x["dec_q"] = rng.standard_normal((B, K, rep, D)).astype(f32)
    x["dec_k"] = rng.standard_normal((B, K, S, D)).astype(f32)
    x["dec_v"] = rng.standard_normal((B, K, S, D)).astype(f32)
    x["dec_pos"] = np.int32(37)
    x["pipe_w"] = (rng.standard_normal((8, 16, 16)) * 0.2).astype(f32)
    x["pipe_x"] = rng.standard_normal((6, 4, 16)).astype(f32)
    x["ef_g"] = np.stack([rng.standard_normal((8, 16)) * (i + 1)
                          for i in range(4)]).astype(f32)
    x["ef_steps"] = (np.random.default_rng(1).standard_normal((30, 4, 16))
                     * 0.01).astype(f32)
    x["comm_x"] = rng.standard_normal((4, 8, 6)).astype(f32)
    x["comm_w"] = rng.standard_normal((4, 8, 6)).astype(f32)
    x["a2a_x"] = rng.standard_normal((2, 8, 4, 3)).astype(f32)
    x["a2a_w"] = rng.standard_normal((2, 8, 16, 3)).astype(f32)
    x["qwen_toks"] = rng.integers(0, 128, (4, 64)).astype(np.int32)
    x["moe_toks"] = rng.integers(0, 128, (4, 32)).astype(np.int32)
    # the EP dispatch: 40 tokens, with ties (equal logits) and drops
    logits = rng.standard_normal((40, 6)).astype(f32)
    logits[::5] = 0.5
    x["disp_logits"] = logits
    x["disp_xf"] = rng.standard_normal((40, 64)).astype(f32)
    for name, cfg in (("qwen", get_smoke_config("qwen3-4b")),
                      ("moe", _ep_configs()[0])):
        params = M.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
        for path, leaf in _flat(M.params_to_reference(params)):
            x[f"{name}_p/{path}"] = leaf
    return x


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _tree(x: dict, name: str) -> dict:
    out: dict = {}
    for key, val in x.items():
        if key.startswith(f"{name}_p/"):
            *path, leaf = key[len(name) + 3:].split("/")
            node = out
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = val
    return out


# -- the reference, in a subprocess with eight virtual devices ---------------
REFERENCE = """
import dataclasses, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as PS
from jax.experimental.shard_map import shard_map
from repro import models as M
from repro.configs import get_smoke_config
from repro.distributed import ctx as dctx, sharding as sh
from repro.distributed.collectives import (
    ef_compressed_psum, compressed_psum_reference)
from repro.distributed.flash_decode import flash_decode
from repro.distributed.moe_parallel import _local_dispatch
from repro.distributed.pipeline import gpipe, stack_stage_fn, stages_from_stack
from repro.distributed.ring_attention import ring_attention
from repro.kernels import ref

x = dict(np.load(sys.argv[1]))
out = {}
devs = np.array(jax.devices())
mesh = Mesh(devs.reshape(2, 4), ("data", "model"))
mesh4 = lambda name: Mesh(devs[:4].reshape(4,), (name,))

def tree(name):
    t = {}
    for key, val in x.items():
        if key.startswith(name + "_p/"):
            *path, leaf = key[len(name) + 3:].split("/")
            node = t
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(val)
    return t

# the in-body collectives and their transposes
pp = [(i, (i + 1) % 4) for i in range(4)]
f_pp = shard_map(lambda a: jax.lax.ppermute(a, "model", pp), mesh=mesh,
                 in_specs=PS("data", "model"), out_specs=PS("data", "model"),
                 check_rep=False)
f_a2a = shard_map(lambda a: jax.lax.all_to_all(a, "model", 1, 2, tiled=True),
                  mesh=mesh, in_specs=PS("data"),
                  out_specs=PS("data", "model"), check_rep=False)
for name, f in (("comm", f_pp), ("a2a", f_a2a)):
    a, w = jnp.asarray(x[name + "_x"]), jnp.asarray(x[name + "_w"])
    out[name + "_out"] = f(a)
    out[name + "_dx"] = jax.grad(lambda a: jnp.sum(f(a) * w))(a)

ring = jax.jit(lambda q, k, v: ring_attention(mesh, q, k, v, causal=True))
for i in range(2):
    q, k, v = (jnp.asarray(x[f"ring_{n}{i}"]) for n in "qkv")
    out[f"ring_out{i}"] = ring(q, k, v)
    out[f"ring_dense{i}"] = ref.attention_ref(q, k, v, causal=True)
q, k, v = (jnp.asarray(x[f"ring_{n}0"]) for n in "qkv")
out["ring_dq"], out["ring_dk"], out["ring_dv"] = jax.jit(jax.grad(
    lambda q, k, v: jnp.sum(ring(q, k, v) ** 2), argnums=(0, 1, 2)))(q, k, v)

cfg0 = get_smoke_config("qwen3-4b")
cfg1 = dataclasses.replace(cfg0, ring_attention=True)
params, toks = tree("qwen"), jnp.asarray(x["qwen_toks"])
out["qwen_off"] = M.forward(cfg0, params, toks)[0].astype(jnp.float32)
rules = sh.make_rules(data_axes=("data",))
with mesh, dctx.axis_rules(mesh, rules):
    out["qwen_ring"] = jax.jit(lambda p, t: M.forward(cfg1, p, t))(
        params, toks)[0].astype(jnp.float32)

out["dec_out"] = jax.jit(lambda *a: flash_decode(mesh, *a))(
    jnp.asarray(x["dec_q"]), jnp.asarray(x["dec_k"]),
    jnp.asarray(x["dec_v"]), jnp.int32(x["dec_pos"]))

base = get_smoke_config("qwen2-moe-a2.7b", dtype="float32")
cfg_gs = dataclasses.replace(base, moe_expert_pad=2, moe_capacity_factor=8.0)
cfg_ep = dataclasses.replace(cfg_gs, moe_impl="ep")
params, toks = tree("moe"), jnp.asarray(x["moe_toks"])
out["moe_gs"], out["moe_gs_aux"] = M.forward(cfg_gs, params, toks)
with mesh, dctx.axis_rules(mesh, rules):
    out["moe_ep"], out["moe_ep_aux"] = jax.jit(
        lambda p, t: M.forward(cfg_ep, p, t))(params, toks)
buf, (slot, tok_s, gate_s, valid), aux = _local_dispatch(
    cfg_gs, jnp.asarray(x["disp_logits"]), jnp.asarray(x["disp_xf"]), 8)
out.update(disp_buf=buf, disp_slot=slot, disp_tok=tok_s, disp_gate=gate_s,
           disp_valid=valid, disp_aux=aux)

def layer(w, h):
    return jnp.tanh(h @ w)
ws, xm = jnp.asarray(x["pipe_w"]), jnp.asarray(x["pipe_x"])
pmesh = mesh4("pipe")
stages = stages_from_stack(ws, 4)
pipe = jax.jit(lambda st: gpipe(pmesh, stack_stage_fn(layer), st, xm))
out["pipe_out"] = pipe(stages)
out["pipe_grad"] = jax.jit(jax.grad(lambda st: jnp.sum(pipe(st) ** 2)))(
    stages)

pod = mesh4("pod")
per_pod = [jnp.asarray(g) for g in x["ef_g"]]
for method in ("bf16", "int8"):
    o, e = jax.jit(lambda g, e: ef_compressed_psum(pod, g, e, method=method))(
        {"g": jnp.asarray(x["ef_g"])},
        {"g": jnp.zeros((4, 8, 16), jnp.float32)})
    out[f"ef_{method}"], out[f"ef_{method}_err"] = o["g"], e["g"]
    out[f"ef_{method}_oracle"] = compressed_psum_reference(per_pod, method)
def drift(steps):
    err = {"g": jnp.zeros((4, 16), jnp.float32)}
    acc = jnp.zeros(16)
    for i in range(steps.shape[0]):
        o, err = ef_compressed_psum(pod, {"g": steps[i]}, err, method="int8")
        acc = acc + o["g"]
    return acc
out["ef_acc"] = jax.jit(drift)(jnp.asarray(x["ef_steps"]))
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
"""


# -- the port, on eight gloo ranks, then on four --------------------------------
def _load(inpath):
    torch.set_num_threads(1)
    x = dict(np.load(inpath))
    return x, {k: torch.from_numpy(np.asarray(v)) for k, v in x.items()}


def _rank0(rank, out):
    if rank != 0:
        return None
    return {k: v.detach().float().numpy() if v.is_floating_point()
            else v.numpy() for k, v in out.items()}


def _port_rank(rank, report, inpath):
    """The (2, 4) mesh's cases, on eight ranks."""
    x, t = _load(inpath)
    mesh = Mesh((2, 4), ("data", "model"), backend="gloo", device="cpu")
    out = {}

    f_pp = shard_map(lambda a: comm.ppermute(mesh, a, "model", PP), mesh,
                     in_specs=(PS("data", "model"),),
                     out_specs=PS("data", "model"))
    f_a2a = shard_map(lambda a: comm.all_to_all(mesh, a, "model", 1, 2),
                      mesh, in_specs=(PS("data"),),
                      out_specs=PS("data", "model"))
    for name, f in (("comm", f_pp), ("a2a", f_a2a)):
        a = t[name + "_x"].clone().requires_grad_(True)
        y = f(a)
        (y * t[name + "_w"]).sum().backward()
        out[name + "_out"], out[name + "_dx"] = y.detach(), a.grad

    for i in range(2):
        q, k, v = (t[f"ring_{n}{i}"] for n in "qkv")
        out[f"ring_out{i}"] = ring_attention(mesh, q, k, v, causal=True)
        out[f"ring_dense{i}"] = ref.attention_ref(q, k, v, causal=True)
    q, k, v = (t[f"ring_{n}0"].clone().requires_grad_(True) for n in "qkv")
    (ring_attention(mesh, q, k, v, causal=True) ** 2).sum().backward()
    out["ring_dq"], out["ring_dk"], out["ring_dv"] = q.grad, k.grad, v.grad

    cfg0 = get_smoke_config("qwen3-4b")
    cfg1 = dataclasses.replace(cfg0, ring_attention=True)
    params = M.params_from_reference(cfg0, _tree(x, "qwen"), device="cpu")
    toks = t["qwen_toks"].long()
    rules = sh.make_rules(data_axes=("data",))
    with torch.no_grad():
        out["qwen_off"] = M.forward(cfg0, params, toks)[0].float()
        with dctx.axis_rules(mesh, rules):
            out["qwen_ring"] = M.forward(cfg1, params, toks)[0].float()

        out["dec_out"] = flash_decode(mesh, t["dec_q"], t["dec_k"],
                                      t["dec_v"], int(x["dec_pos"]))

        cfg_gs, cfg_ep = _ep_configs()
        params = M.params_from_reference(cfg_gs, _tree(x, "moe"),
                                         device="cpu")
        toks = t["moe_toks"].long()
        out["moe_gs"], out["moe_gs_aux"] = M.forward(cfg_gs, params, toks)
        with dctx.axis_rules(mesh, rules):
            out["moe_ep"], out["moe_ep_aux"] = M.forward(cfg_ep, params,
                                                         toks)
    report(f"rank {rank} done")
    return _rank0(rank, out)


def _port_rank4(rank, report, inpath):
    """The (4,) meshes' cases (GPipe, the compressed psum), on four ranks."""
    x, t = _load(inpath)
    pmesh = Mesh((4,), ("pipe",), backend="gloo", device="cpu")
    pod = Mesh((4,), ("pod",), backend="gloo", device="cpu")
    out = {}
    stages = stages_from_stack(t["pipe_w"], 4).requires_grad_(True)
    y = gpipe(pmesh, stack_stage_fn(lambda w, h: torch.tanh(h @ w)),
              stages, t["pipe_x"])
    (y ** 2).sum().backward()
    out["pipe_out"], out["pipe_grad"] = y.detach(), stages.grad

    for method in ("bf16", "int8"):
        o, e = ef_compressed_psum(
            pod, {"g": t["ef_g"]}, init_error_state({"g": t["ef_g"]}),
            method=method)
        out[f"ef_{method}"], out[f"ef_{method}_err"] = o["g"], e["g"]
        out[f"ef_{method}_oracle"] = compressed_psum_reference(
            list(t["ef_g"]), method)
    err = {"g": torch.zeros(4, 16)}
    acc = torch.zeros(16)
    for g in t["ef_steps"]:
        o, err = ef_compressed_psum(pod, {"g": g}, err, method="int8")
        acc = acc + o["g"]
    out["ef_acc"] = acc
    report(f"rank {rank} done")
    return _rank0(rank, out)


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist")
    inpath, refpath = str(tmp / "inputs.npz"), str(tmp / "reference.npz")
    x = _inputs()
    np.savez(inpath, **x)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    ref_proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REFERENCE), inpath, refpath],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=REPO)
    try:
        port = launch.run(_port_rank, WORLD, backend="gloo", device="cpu",
                          args=(inpath,), timeout=TIMEOUT)[0]
        port.update(launch.run(_port_rank4, 4, backend="gloo", device="cpu",
                               args=(inpath,), timeout=TIMEOUT)[0])
        _, err = ref_proc.communicate(timeout=TIMEOUT)
    finally:
        if ref_proc.poll() is None:
            ref_proc.kill()
            ref_proc.communicate()
    assert ref_proc.returncode == 0, err[-4000:]
    return x, dict(np.load(refpath)), port


def _err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b))) if a.size else 0.0


# -- the in-body collectives --------------------------------------------------
@pytest.mark.parametrize("op", ["comm", "a2a"])
@pytest.mark.parametrize("what", ["out", "dx"])
def test_collective_and_its_gradient_match_reference(sides, op, what):
    """ppermute and tiled all_to_all over the model axis of (2, 4), and
    the gradient of sum(out * w) back through them."""
    _, r, p = sides
    assert _err(p[f"{op}_{what}"], r[f"{op}_{what}"]) <= COMM_TOL


# -- ring attention -------------------------------------------------------------
@pytest.mark.parametrize("i", range(len(RING_SHAPES)))
def test_ring_attention_matches_reference_and_dense(sides, i):
    _, r, p = sides
    assert _err(p[f"ring_out{i}"], r[f"ring_out{i}"]) < RING_TOL
    assert _err(p[f"ring_out{i}"], p[f"ring_dense{i}"]) < RING_TOL
    assert _err(p[f"ring_dense{i}"], r[f"ring_dense{i}"]) < RING_TOL


@pytest.mark.parametrize("arg", ["dq", "dk", "dv"])
def test_ring_attention_gradient_matches_jax_grad(sides, arg):
    """d sum(out^2) through the ring (ppermute's inverse permutation),
    against jax.grad through the reference's ring and against autograd
    through the dense oracle."""
    x, r, p = sides
    q, k, v = (torch.from_numpy(x[f"ring_{n}0"]).requires_grad_(True)
               for n in "qkv")
    (ref.attention_ref(q, k, v, causal=True) ** 2).sum().backward()
    dense = {"dq": q.grad, "dk": k.grad, "dv": v.grad}[arg].numpy()
    assert _err(p[f"ring_{arg}"], r[f"ring_{arg}"]) < RING_GRAD_TOL
    assert _err(p[f"ring_{arg}"], dense) < RING_GRAD_TOL


def test_qwen3_forward_with_ring_under_context(sides):
    """The model call site: qwen3's smoke forward with ring_attention=True
    under axis_rules on (2, 4) against the flag-off forward, and against
    the reference's flagged forward (the reference test's 0.05)."""
    _, r, p = sides
    assert _err(p["qwen_ring"], p["qwen_off"]) < MODEL_TOL
    assert _err(p["qwen_ring"], r["qwen_ring"]) < MODEL_TOL
    assert _err(p["qwen_off"], r["qwen_off"]) < MODEL_TOL


@pytest.mark.parametrize("arch", ["qwen3-4b", "tinyllama-1.1b"])
def test_ring_attention_flag_without_context_runs_the_kernel_path(arch):
    """ring_attention=True with no sharding context (or a mesh with no
    "model" axis, or S not dividing by it) falls through to the ordinary
    attention, as the reference's full_attention does; it raised before."""
    cfg0 = get_smoke_config(arch)
    cfg1 = dataclasses.replace(cfg0, ring_attention=True)
    params = M.init_params(cfg0, torch.Generator().manual_seed(0),
                           device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg0.vocab_size, (2, 24)))
    with torch.no_grad():
        want = M.forward(cfg0, params, toks)[0]
        assert torch.equal(M.forward(cfg1, params, toks)[0], want)
        for mesh in (AbstractMesh((4,), ("data",)),
                     AbstractMesh((2, 5), ("data", "model"))):
            with dctx.axis_rules(mesh, sh.make_rules(data_axes=("data",))):
                assert torch.equal(M.forward(cfg1, params, toks)[0], want)


# -- flash-decode ------------------------------------------------------------------
def test_flash_decode_matches_reference_and_dense(sides):
    x, r, p = sides
    q, ck, cv = (torch.from_numpy(x[k]) for k in ("dec_q", "dec_k", "dec_v"))
    logits = torch.einsum("bkrd,bksd->bkrs", q, ck) / np.sqrt(q.shape[-1])
    valid = torch.arange(ck.shape[2]) <= int(x["dec_pos"])
    logits = torch.where(valid[None, None, None], logits, -1e30)
    want = torch.einsum("bkrs,bksd->bkrd", torch.softmax(logits, -1), cv)
    assert _err(p["dec_out"], want.numpy()) < DECODE_TOL
    assert _err(p["dec_out"], r["dec_out"]) < DECODE_TOL


# -- expert-parallel MoE -------------------------------------------------------------
@pytest.mark.parametrize("what", ["buf", "slot", "tok", "gate", "valid",
                                  "aux"])
def test_ep_dispatch_matches_reference(sides, what):
    """_local_dispatch on the same router logits (ties, drops at cap 8):
    the (E_padded, cap, D) buffer and the combine metadata."""
    x, r, _ = sides
    cfg, _ = _ep_configs()
    buf, rt, aux = _local_dispatch(cfg, torch.from_numpy(x["disp_logits"]),
                                   torch.from_numpy(x["disp_xf"]), 8)
    got = {"buf": buf, "slot": rt.slot, "tok": rt.order // cfg.moe_top_k,
           "gate": rt.gate_vals.reshape(-1)[rt.order], "valid": rt.valid,
           "aux": aux}[what].numpy()
    want = r[f"disp_{what}"]
    if what in ("slot", "tok", "valid"):
        np.testing.assert_array_equal(got, want)
    else:
        assert _err(got, want) < 1e-6
    if what == "valid":
        assert not want.all()            # the case has drops


@pytest.mark.parametrize("what", ["logits", "aux"])
def test_ep_moe_matches_gspmd_and_reference(sides, what):
    """moe_impl="ep" under axis_rules on (2, 4) against moe_ffn on the
    same weights (no drops at capacity factor 8), and both against the
    reference's.  The aux loss is held against the reference's only: EP
    takes the mean over data ranks of each rank's loss, a mean of
    products, which is not the loss of all tokens at once."""
    _, r, p = sides
    sfx = "" if what == "logits" else "_aux"
    if what == "logits":
        assert _err(p["moe_ep"], p["moe_gs"]) < EP_TOL
    assert _err(p[f"moe_ep{sfx}"], r[f"moe_ep{sfx}"]) < EP_TOL
    assert _err(p[f"moe_gs{sfx}"], r[f"moe_gs{sfx}"]) < EP_TOL


def test_ep_raises_when_experts_do_not_divide():
    cfg = dataclasses.replace(_ep_configs()[1], moe_expert_pad=0)
    with pytest.raises(ValueError, match="moe_expert_pad"):
        moe_ffn_ep(cfg, AbstractMesh((2, 4), ("data", "model")), {},
                   torch.zeros(4, 8, 64))


# -- GPipe ---------------------------------------------------------------------------
def test_gpipe_forward_matches_reference_and_sequential(sides):
    x, r, p = sides
    ws, xm = torch.from_numpy(x["pipe_w"]), torch.from_numpy(x["pipe_x"])
    seq = []
    for mb in xm:
        for w in ws:
            mb = torch.tanh(mb @ w)
        seq.append(mb)
    assert _err(p["pipe_out"], torch.stack(seq).numpy()) < GPIPE_TOL
    assert _err(p["pipe_out"], r["pipe_out"]) < GPIPE_TOL


def test_gpipe_gradient_matches_reference_and_sequential(sides):
    """The psum that hands the last stage's output to every rank keeps
    the gradient at one loss's: it equals the sequential stack's."""
    x, r, p = sides
    ws = torch.from_numpy(x["pipe_w"]).requires_grad_(True)
    xm = torch.from_numpy(x["pipe_x"])
    total = 0
    for mb in xm:
        for i in range(ws.shape[0]):
            mb = torch.tanh(mb @ ws[i])
        total = total + (mb ** 2).sum()
    total.backward()
    seq = ws.grad.reshape(4, 2, 16, 16).numpy()
    assert _err(p["pipe_grad"], seq) < GPIPE_GRAD_TOL
    assert _err(p["pipe_grad"], r["pipe_grad"]) < GPIPE_GRAD_TOL


# -- compressed collectives -------------------------------------------------------------
@pytest.mark.parametrize("method", ["bf16", "int8"])
def test_ef_compressed_psum_matches_oracle_and_reference(sides, method):
    _, r, p = sides
    tol = EF_TOL[method]
    assert _err(p[f"ef_{method}"], p[f"ef_{method}_oracle"]) < tol
    assert _err(p[f"ef_{method}"], r[f"ef_{method}"]) < tol
    assert _err(p[f"ef_{method}_oracle"], r[f"ef_{method}_oracle"]) < 1e-6


@pytest.mark.parametrize("method", ["bf16", "int8"])
def test_ef_error_state_is_the_quantization_residual(sides, method):
    """Each pod's carried residual: x - dequantized(x), per pod."""
    x, r, p = sides
    err = p[f"ef_{method}_err"]
    assert err.shape == x["ef_g"].shape and np.abs(err).max() > 0
    assert _err(err, r[f"ef_{method}_err"]) < EF_TOL["int8"]


def test_ef_accumulated_error_is_bounded(sides):
    """30 int8 steps at scale 0.01: the accumulated update stays within
    0.2 relative of the exact mean, as in the reference's test."""
    x, r, p = sides
    true = x["ef_steps"].astype(np.float64).mean(1).sum(0)
    rel = np.abs(p["ef_acc"] - true).max() / np.abs(true).max()
    assert rel < 0.2, rel
    assert _err(p["ef_acc"], r["ef_acc"]) < 1e-4


# -- launching and backends -------------------------------------------------------------
def test_nccl_refuses_more_ranks_than_gpus():
    with pytest.raises(ValueError, match="backend='gloo'"):
        check_backend("nccl", torch.cuda.device_count() + 2, "cuda")
    with pytest.raises(ValueError, match="gloo"):
        check_backend("nccl", 1, "cpu")


def _fail_rank(rank, report):
    if rank == 1:
        raise RuntimeError("rank one fails")
    torch.distributed.barrier()


def _hang_rank(rank, report):
    report("started")
    if rank == 1:
        import time
        time.sleep(600)
    torch.distributed.barrier()


def test_launch_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank one fails"):
        launch.run(_fail_rank, 2, backend="gloo", device="cpu", timeout=60)


def test_launch_kills_a_world_that_stops_reporting():
    seen = []
    with pytest.raises((TimeoutError, RuntimeError)):
        launch.run(_hang_rank, 2, backend="gloo", device="cpu", timeout=12,
                   on_message=lambda r, m: seen.append(r))
    assert sorted(seen) == [0, 1]
