"""Multi-pod dry run: trace one rank's step of every (architecture x
input shape x mesh) cell with no allocation; record its flops, bytes,
memory and collective traffic.

The port of ``repro.launch.dryrun``, with the same flags, cells and JSON
layout.  Where the reference lowers and compiles each cell against
``ShapeDtypeStruct`` inputs and reads XLA's analyses, here:

* the process joins torch's ``fake`` process group with as many ranks as
  the mesh has (:func:`fake_world`; its collectives move nothing) and
  builds the mesh on it as rank 0;
* rank 0's step runs once under ``FakeTensorMode`` inside
  ``axis_rules(mesh, rules)``, its inputs fake tensors made from
  :func:`repro_torch.train.state_spec` and :mod:`repro_torch.launch.specs`
  on :data:`TRACE_DEVICE`, with ``kernel_impl="torch"`` (the plain
  versions, as the reference forces ``"xla"``).  Nothing is allocated on
  any device and nothing is compiled.

What :func:`analyze` reports, all of it from rank 0's trace:

* ``flops``: ``torch.utils.flop_counter.FlopCounterMode`` (products
  only; XLA also counts elementwise work);
* ``bytes_accessed``: the sum over the trace's ops of their input and
  output bytes (views, allocations and collectives move none);
* ``memory.argument_bytes``: the bytes rank 0 holds on its device as
  the step's inputs.  The parameters (and a train step's ``m`` and
  ``v``) are rank 0's blocks under the cell's shardings
  (:mod:`repro_torch.distributed.rank_local`: fake blocks, each weight
  gathered where the step reads it); a decode cell's cache is rank 0's
  block (``cache_logical_axes``: rows over the data axes, slots over
  ``cache_seq``'s); the batch and a decode cell's tokens are handed to
  the step whole, as the reference's ``jit`` takes them, and the step
  copies only rank 0's rows to the device, which is what counts; the
  position is held whole.  ``memory.sharded_argument_bytes`` is what a
  device holds under the shardings (``tree_shardings_for``), which is
  XLA's ``argument_bytes``: the two are equal;
* ``memory.temp_bytes``: the traced peak of live bytes less those held
  at entry, the gathered weights among them; ``output_bytes`` and
  ``alias_bytes`` (outputs that share an input's storage: the state
  updated in place);
* ``collectives``: :mod:`repro_torch.utils.comm_stats`, fed by the
  port's collective layer.

A rank computes only its rows of the batch (the train step's
``Layout.row_cut``, the serve steps' ``serving_cut``) and only its
blocks of the products the rules cut over ``model`` (attention heads,
under ring attention too, MLP columns, the vocabulary, the RG-LRU's
channels, Mamba2's heads: :mod:`repro_torch.distributed.tensor_parallel`,
whose collectives, the ring's exchanges of heads for sequence blocks
and ``--sp``'s gathers and reduce-scatters of the sequence among them,
are recorded at the ``"tp"`` site and whose ``train_flops`` is a dense
or Mamba2 rank's traced products), so rank 0's flops are its rows'
share of the global step's less what the ``model`` axis cuts; the key
and value products (``kv_heads`` map to no axis) and the MoE's routed
experts under ``moe_impl="gspmd"`` stay whole on every rank along
``model`` (under expert parallelism a rank holds and computes its
experts' block).

``--mode fit`` keeps the reference's affine extrapolation in depth
(:func:`run_fit`).  torch traces the layer loop whole, so ``full`` is
exact at depth already; the fit stays so that the report and the
roofline's ``fit`` source keep their meaning.  torch's recompute
schedule depends on the remat block (``layer_forward_runs``), so a
training cell's fit variants keep the full depth's block: their depths
are one and two blocks (of layers, or of pattern groups for the hybrid
family), which makes the fit equal the full trace.

One process holds one fake world: the CLI runs one cell; a caller that
runs several in one process gets the world torn down after each
(:func:`run_cell`).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k \\
      --mesh single --mode both --out reports/dryrun_torch
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch import models as M
from repro_torch.configs import get_config
from repro_torch.distributed import rank_local
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.ctx import axis_rules
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import (
    data_axes, make_production_mesh, production_shape)
from repro_torch.models.common import _auto_block
from repro_torch.models.config import SHAPES_BY_NAME, shapes_for
from repro_torch.optim import AdamWConfig
from repro_torch.serve import make_prefill_step, make_serve_step
from repro_torch.serve.step import cache_block, serving_cut
from repro_torch.train import (
    TrainState, make_train_step, state_logical_axes, state_spec)
from repro_torch.utils import comm_stats
from repro_torch.utils.comm_stats import record_collectives

#: Where the fake tensors claim to live: the card where torch is built
#: with CUDA; else the CPU (a CPU-only build cannot index a fake CUDA
#: tensor: its indexing takes a CUDA device guard it lacks).  The plain
#: versions run the same ops on either.
TRACE_DEVICE = "cuda" if torch.backends.cuda.is_built() else "cpu"

aten = torch.ops.aten
#: ops that move no bytes: they allocate, alias or read a scalar; and
#: ops without a tensor output (metadata queries) move none either
_NO_BYTES = {aten.detach.default, aten.empty.memory_format,
             aten.empty_like.default, aten.empty_strided.default,
             aten.lift_fresh.default, aten._local_scalar_dense.default}
#: metadata queries (``prim.device``) and collectives (the collective term)
_NO_BYTES_NAMESPACES = ("prim", "c10d", "_c10d_functional")
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional")
#: the c10d op that carries each kind the port's collective layer records
_TRANSPORT = {"all-gather": "c10d.allgather_.default",
              "all-reduce": "c10d.allreduce_.default",
              "reduce-scatter": "c10d._reduce_scatter_base_.default",
              "all-to-all": "c10d.alltoall_base_.default",
              "collective-permute": "c10d.alltoall_base_.default"}


@contextlib.contextmanager
def fake_world(world_size: int):
    """This process as rank 0 of a ``fake`` process group of
    ``world_size`` ranks, torn down on exit."""
    # importing the module registers the backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is initialised already; the dry "
                           "run needs its own fake world")
    dist.init_process_group("fake", rank=0, world_size=world_size,
                            store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


def _world_for(shape) -> int:
    n = math.prod(shape)
    pool = os.environ.get("REPRO_DRYRUN_DEVICES")
    if pool and int(pool) < n:
        raise RuntimeError(f"need {n} ranks for mesh {shape}, "
                           f"REPRO_DRYRUN_DEVICES={pool}")
    return n


def _on_a_device(tree) -> list:
    """The tensors of ``tree`` but those on the ``meta`` device: a step's
    shape specs (the serve steps' ``M.cache_spec``) hold and move no
    bytes."""
    return [t for t in pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor) and t.device.type != "meta"]


class _StepMeter(TorchDispatchMode):
    """Bytes accessed, live bytes by storage, and the collective ops, over
    the ops it sees (a dispatch mode: it sees the backward's too, on
    whichever thread the autograd engine runs it)."""

    def __init__(self):
        super().__init__()
        self.bytes_accessed = 0
        self.collective_ops = collections.Counter()
        self.live = 0
        self.peak = 0
        self._held = WeakIdKeyDictionary()

    def hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st in self._held:
            return
        n = st.nbytes()
        self._held[st] = n
        weakref.finalize(st, self._release, n)
        self.live += n
        self.peak = max(self.peak, self.live)

    def _release(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace in _COLLECTIVE_NAMESPACES:
            self.collective_ops[str(func)] += 1
        outs = _on_a_device(out)
        if outs and not (func.is_view or func in _NO_BYTES
                         or func.namespace in _NO_BYTES_NAMESPACES):
            ins = _on_a_device((args, kwargs))
            self.bytes_accessed += sum(t.nbytes for t in ins) \
                + sum(t.nbytes for t in outs)
        for t in outs:
            self.hold(t)
        return out


@dataclasses.dataclass
class Trace:
    """What one traced step measured (the port's ``compiled``)."""
    flops: float
    bytes_accessed: float
    argument_bytes: int
    sharded_argument_bytes: int
    temp_bytes: int
    output_bytes: int
    alias_bytes: int
    collectives: object          # comm_stats.CollectiveRecorder
    device: str                  # the device the fake tensors claimed


def _rules_for(mesh, args):
    return sh.make_rules(
        fsdp=not args.no_fsdp,
        seq_shard_cache=not args.no_seqshard,
        expert_parallel=not args.no_ep,
        data_axes=data_axes(mesh))


def _leaves(tree) -> list:
    """The leaves of nested dicts, lists and tuples (a PartitionSpec is a
    leaf)."""
    if isinstance(tree, sh.PartitionSpec):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _sharded_bytes(shape_tree, axes_tree, mesh, rules) -> int:
    """Per-device bytes of ``shape_tree``'s meta tensors under their
    sanitized specs (``axes_tree`` None: replicated)."""
    if axes_tree is None:
        return sum(t.nbytes for t in _leaves(shape_tree))
    specs = sh.tree_shardings_for(shape_tree, axes_tree, mesh, rules)
    total = 0
    for t, spec in zip(_leaves(shape_tree), _leaves(specs)):
        total += t.nbytes // math.prod(mesh.extent(e) for e in spec
                                       if e is not None)
    return total


def _fake(tree, dev):
    """``tree``'s meta tensors as fake tensors on ``dev`` (inside the
    fake mode)."""
    if isinstance(tree, dict):
        return {k: _fake(v, dev) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=tree.dtype, device=dev)


def _inputs(cfg, shape, st):
    """``(meta trees, their logical axes)`` of the cell's step inputs, as
    pairs (for the argument bytes), in the step's argument order; ``st``
    is :func:`state_spec`'s (global shapes)."""
    st_ax = state_logical_axes(cfg)
    if shape.kind == "train":
        return [(st.params, st_ax.params), (st.opt, st_ax.opt),
                (st.step, None),
                (SP.batch_specs(cfg, shape), SP.batch_logical_axes(cfg))]
    if shape.kind == "prefill":
        return [(st.params, st_ax.params),
                (SP.batch_specs(cfg, shape), SP.batch_logical_axes(cfg))]
    d, d_ax = SP.decode_specs(cfg, shape), SP.decode_logical_axes(cfg)
    return [(st.params, st_ax.params), (d["cache"], d_ax["cache"]),
            (d["tokens"], d_ax["tokens"]), (d["pos"], None)]


def _cache_blocks(cfg, shape, mesh, rules) -> dict:
    """A decode cell's cache as meta tensors of rank 0's blocks
    (:func:`repro_torch.serve.step.cache_block`)."""
    return cache_block(cfg, shape.global_batch, shape.seq_len, mesh, rules)


def _held_bytes(cfg, shape, st, blocks, layout, microbatches) -> int:
    """The bytes rank 0 holds on its device as the step's inputs: the
    state's blocks (``blocks``, :func:`rank_local.block_spec`'s
    ``TrainState``), a decode cell's cache block, the rows of the batch
    or tokens that the step copies to the device (the train step's
    ``Layout.row_cut``, the serve steps' ``serving_cut``), and the
    position."""
    held = _leaves(blocks.params)
    if shape.kind == "train":
        held += _leaves(blocks.opt) + [st.step]
        rows = SP.batch_specs(cfg, shape)
        cut = layout.row_cut(cfg, rows, microbatches)
    else:
        cut = serving_cut(cfg, shape.global_batch, shape.seq_len)
        if shape.kind == "prefill":
            rows = SP.batch_specs(cfg, shape)
        else:
            d = SP.decode_specs(cfg, shape)
            held += _leaves(_cache_blocks(cfg, shape, layout.mesh,
                                          layout.rules)) + [d["pos"]]
            rows = {"tokens": d["tokens"]}
    n = cut.n_rows if cut is not None else 1
    return sum(t.nbytes for t in held) + sum(t.nbytes // n
                                             for t in _leaves(rows))


def _check_recorded(rec, meter) -> None:
    """Every collective op the trace dispatched was recorded as one kind:
    a collective that bypassed the collective layer, or a record lost
    off the calling thread, fails the cell."""
    recorded = collections.Counter(_TRANSPORT[kind]
                                   for kind, *_ in rec.records)
    if recorded != meter.collective_ops:
        raise RuntimeError(
            f"the collective recorder holds {dict(recorded)}, the trace "
            f"dispatched {dict(meter.collective_ops)}")


def lower_cell(cfg, shape, mesh, args, device=None):
    """Trace rank 0's step of one cell under ``FakeTensorMode`` (inside
    the caller's ``axis_rules``); returns ``(Trace, {"trace_s",
    "compile_s"})``.  ``shape`` is a :class:`ShapeConfig`; the fake
    tensors claim ``device`` (default :data:`TRACE_DEVICE`)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    rules = _rules_for(mesh, args)
    st = state_spec(cfg)
    layout = rank_local.layout_for(cfg, mesh, rules)
    blocks = TrainState(
        step=st.step,
        params=rank_local.block_spec(st.params, layout.specs.params, mesh),
        opt={k: rank_local.block_spec(st.opt[k], layout.specs.opt[k], mesh)
             for k in ("m", "v")})
    pairs = _inputs(cfg, shape, st)
    arg_bytes = _held_bytes(cfg, shape, st, blocks, layout,
                            args.microbatches)
    sharded = sum(_sharded_bytes(tree, ax, mesh, rules) for tree, ax in pairs)
    dev = TRACE_DEVICE if device is None else device
    t0 = time.perf_counter()
    with FakeTensorMode():
        params = rank_local.model_from_blocks(
            cfg, _fake(blocks.params, dev), layout)
        if shape.kind == "train":
            state = TrainState.of(params, opt=_fake(blocks.opt, dev))
            batch = _fake(SP.batch_specs(cfg, shape), dev)
            step = make_train_step(cfg, AdamWConfig(),
                                   microbatches=args.microbatches)
            inputs = [state.params.param_tree(), state.opt, batch]
            run = lambda: step(state, batch)                  # noqa: E731
        elif shape.kind == "prefill":
            batch = _fake(SP.batch_specs(cfg, shape), dev)
            pstep = make_prefill_step(cfg, shape.seq_len)
            inputs = [params.param_tree(), batch]
            run = lambda: pstep(params, batch["tokens"],      # noqa: E731
                                batch.get("frontend_inputs"))
        else:
            d = SP.decode_specs(cfg, shape)
            cache = _fake(_cache_blocks(cfg, shape, mesh, rules), dev)
            tokens = _fake(d["tokens"], dev)
            sstep = make_serve_step(cfg, shape.seq_len)
            inputs = [params.param_tree(), cache, tokens]
            # the cache is read whole under a mask: the position changes
            # no shape and no cost
            run = lambda: sstep(params, cache, tokens,       # noqa: E731
                                shape.seq_len - 1)
        held = _leaves(inputs)
        # storages by id: every one stays alive (held) while ids are read
        entry = {id(s): s for s in (t.untyped_storage() for t in held)}
        meter = _StepMeter()
        for t in held:
            meter.hold(t)
        with record_collectives() as rec, FlopCounterMode(display=False) \
                as fc, meter:
            out = run()
        _check_recorded(rec, meter)
        outs = [t for t in pytree.tree_leaves(
            (out[0].tree() if isinstance(out[0], TrainState) else out[0],
             out[1])) if isinstance(t, torch.Tensor)]
        seen = {id(s): s for s in (t.untyped_storage() for t in outs)}
        trace = Trace(
            flops=float(fc.get_total_flops()),
            bytes_accessed=float(meter.bytes_accessed),
            argument_bytes=int(arg_bytes), sharded_argument_bytes=int(sharded),
            temp_bytes=int(meter.peak
                           - sum(s.nbytes() for s in entry.values())),
            output_bytes=int(sum(s.nbytes() for s in seen.values())),
            alias_bytes=int(sum(s.nbytes() for k, s in seen.items()
                                if k in entry)),
            collectives=rec, device=str(dev))
        del out, outs, held, inputs, run, entry, seen
    return trace, {"trace_s": time.perf_counter() - t0, "compile_s": 0.0}


def analyze(trace: Trace) -> dict:
    rec = trace.collectives
    return {
        "memory": {
            "argument_bytes": trace.argument_bytes,
            "sharded_argument_bytes": trace.sharded_argument_bytes,
            "output_bytes": trace.output_bytes,
            "temp_bytes": trace.temp_bytes,
            "alias_bytes": trace.alias_bytes,
            "code_bytes": 0,
        },
        "flops": trace.flops,
        "bytes_accessed": trace.bytes_accessed,
        "collectives": rec.stats().as_dict(),
        "collectives_by_site": {s: rec.stats(s).as_dict()
                                for s in comm_stats.SITES},
        "trace_device": trace.device,
    }


def _units(cfg) -> int:
    """The repeated units of depth: layers, or the hybrid's pattern
    groups."""
    if cfg.family == "hybrid":
        return cfg.num_layers // len(cfg.block_pattern)
    return cfg.num_layers


def _remat_block(cfg, shape):
    """The remat block (in units) of a training cell's full-depth step, 1
    if it checkpoints layer by layer, None when nothing is recomputed."""
    if shape.kind != "train" or cfg.remat == "none":
        return None
    n = _units(cfg)
    k = cfg.remat_block or _auto_block(n)
    return k if k > 1 and n % k == 0 else 1


def _fit_depths(cfg, shape=None):
    """``(l1, l2, units, u1, u2)``: two small depths for the affine fit,
    honoring pattern groups, as the reference's; a training cell with
    blocked remat takes one and two blocks (see the module docstring)."""
    k = _remat_block(cfg, shape) if shape is not None else None
    if cfg.family == "hybrid":
        plen = len(cfg.block_pattern)
        groups, tail = cfg.num_layers // plen, cfg.num_layers % plen
        u1, u2 = (k, 2 * k) if k and k > 1 else (1, 2)
        return u1 * plen + tail, u2 * plen + tail, groups, u1, u2
    if k and k > 1:
        return k, 2 * k, cfg.num_layers, k, 2 * k
    return 2, 3, cfg.num_layers, 2, 3


def run_fit(cfg, shape, mesh, args) -> dict:
    """Affine-in-depth extrapolation of flops/bytes/collectives from two
    small variants at ``microbatches=1``, as the reference's."""
    l1, l2, units, u1, u2 = _fit_depths(cfg, shape)
    k = _remat_block(cfg, shape)
    pin = {} if k is None else {"remat_block": k}
    fit_args = argparse.Namespace(**{**vars(args), "microbatches": 1})
    results = []
    for ldepth in (l1, l2):
        c = dataclasses.replace(cfg, num_layers=ldepth, scan_layers=False,
                                **pin)
        trace, _ = lower_cell(c, shape, mesh, fit_args)
        results.append(analyze(trace))

    def extrap(f):
        a, b = f(results[0]), f(results[1])
        slope = (b - a) / (u2 - u1)
        return a + slope * (units - u1)
    coll_kinds = results[0]["collectives"]["result_bytes"].keys()
    return {
        "depths": [l1, l2], "units": units,
        "flops": extrap(lambda r: r["flops"]),
        "bytes_accessed": extrap(lambda r: r["bytes_accessed"]),
        "collective_result_bytes": {
            k: extrap(lambda r, k=k: r["collectives"]["result_bytes"][k])
            for k in coll_kinds},
        "collective_wire_bytes": {
            k: extrap(lambda r, k=k: r["collectives"]["wire_bytes"][k])
            for k in coll_kinds},
        "small_runs": results,
    }


def cell_config(arch: str, args):
    overrides = {"kernel_impl": "torch"}
    if args.remat:
        overrides["remat"] = args.remat
    if getattr(args, "moe_impl", ""):
        overrides["moe_impl"] = args.moe_impl
    if getattr(args, "moe_pad", 0):
        overrides["moe_expert_pad"] = args.moe_pad
    if getattr(args, "remat_block", 0):
        overrides["remat_block"] = args.remat_block
    if getattr(args, "sp", False):
        overrides["seq_parallel"] = True
    if getattr(args, "ring", False):
        overrides["ring_attention"] = True
    if getattr(args, "optimized", False):
        from repro_torch.configs import get_optimized_config
        return get_optimized_config(arch, **overrides)
    return get_config(arch, **overrides)


def run_cell(arch: str, shape_name: str, mesh_kind: str, args) -> dict:
    cfg = cell_config(arch, args)
    if getattr(args, "optimized", False):
        from repro_torch.configs import step_settings
        args = argparse.Namespace(**{**vars(args), **step_settings(arch)})
    shape = SHAPES_BY_NAME[shape_name]
    if shape not in shapes_for(cfg):
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "skipped",
                "reason": "long_500k requires sub-quadratic attention "
                          "(full-attention arch; see DESIGN.md)"}
    multi = mesh_kind == "multi"
    mshape, _ = production_shape(multi_pod=multi)
    out = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "params": M.count_params(cfg),
           "active_params": M.count_active_params(cfg),
           "model_flops": M.model_flops(
               cfg, shape.tokens if shape.kind != "decode"
               else shape.global_batch, shape.kind)}
    try:
        with fake_world(_world_for(mshape)):
            mesh = make_production_mesh(multi_pod=multi)
            out["mesh_shape"] = dict(mesh.shape)
            rules = _rules_for(mesh, args)
            with axis_rules(mesh, rules):
                if args.mode in ("full", "both"):
                    trace, info = lower_cell(cfg, shape, mesh, args)
                    out["full"] = analyze(trace)
                    out["full"].update(info)
                    del trace
                if args.mode in ("fit", "both") and mesh_kind == "single":
                    out["fit"] = run_fit(cfg, shape, mesh, args)
        out["status"] = "ok"
    except Exception as e:  # noqa: BLE001 — report, don't crash the sweep
        out["status"] = "error"
        out["error"] = f"{type(e).__name__}: {e}"
        out["traceback"] = traceback.format_exc()
    return out


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", choices=("single", "multi"), default="single")
    ap.add_argument("--mode", choices=("full", "fit", "both"), default="both")
    ap.add_argument("--out", default="reports/dryrun_torch")
    ap.add_argument("--remat", default="")
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--no-seqshard", action="store_true")
    ap.add_argument("--no-ep", action="store_true")
    ap.add_argument("--moe-impl", default="", dest="moe_impl")
    ap.add_argument("--moe-pad", type=int, default=0, dest="moe_pad")
    ap.add_argument("--sp", action="store_true")
    ap.add_argument("--ring", action="store_true")
    ap.add_argument("--remat-block", type=int, default=0, dest="remat_block")
    # the port's one flag that the reference's CLI lacks
    ap.add_argument("--optimized", action="store_true",
                    help="the arch's presets (configs.get_optimized_config "
                         "and step_settings); the port's only flag beyond "
                         "the reference's")
    ap.add_argument("--tag", default="")
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    res = run_cell(args.arch, args.shape, args.mesh, args)
    os.makedirs(args.out, exist_ok=True)
    tag = f".{args.tag}" if args.tag else ""
    path = os.path.join(
        args.out, f"{args.arch}_{args.shape}_{args.mesh}{tag}.json")
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    status = res["status"]
    extra = ""
    if status == "ok" and "full" in res:
        mem = res["full"]["memory"]
        held, sharded = mem["argument_bytes"], mem["sharded_argument_bytes"]
        per_dev = (held + mem["temp_bytes"]) / 2**30
        extra = (f" mem/dev={per_dev:.2f}GiB trace={res['full']['trace_s']:.1f}s"
                 f" argument_bytes={held} (held by a rank: its state"
                 f" and cache blocks, its rows of the batch)"
                 f" sharded_argument_bytes={sharded} (a device's"
                 f" under the shardings) gap={held - sharded}"
                 f" ({held / max(sharded, 1):.2f}x)")
    print(f"[dryrun] {args.arch} {args.shape} {args.mesh}: {status}{extra}")
    if status == "error":
        print(res["error"])
        raise SystemExit(1)
    return res


if __name__ == "__main__":
    main()
