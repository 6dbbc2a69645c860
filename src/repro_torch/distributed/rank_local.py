"""Rank-local training state: each rank stores only its blocks.

The reference trains on a mesh by handing ``jax.jit`` the state's
shardings (``in_shardings`` / ``out_shardings`` from
``tree_shardings_for(state_spec(cfg), state_logical_axes(cfg), mesh,
rules)``): each device then stores only its block of every leaf of
``params``, ``m`` and ``v``, and GSPMD inserts the all-gathers where a
weight is used.  This module has no counterpart in ``repro``; it is that
partitioner's work, written out for ``torch.distributed`` ranks:

* :func:`shard_state` and :func:`init_state` give a
  :class:`repro_torch.train.TrainState` whose parameter module, ``m`` and
  ``v`` hold this rank's blocks under the specs (:class:`Layout`) as
  contiguous copies that own their memory (:func:`cut_block`; a
  ``mesh.cut`` view would keep the global storage alive).  The layers'
  parameters stay views of the stacked blocks (``block[i]``: the
  ``layers`` and ``layer_groups`` axes map to no mesh axis).  A leaf
  whose spec is replicated is held whole.
* Every parameter whose block is not the whole tensor is gathered where
  it is read (``torch.nn.utils.parametrize``): each attribute access runs
  :class:`_GatherBlock`, one all-gather over each sharded dim that the
  rank does not compute a block of
  (:func:`repro_torch.distributed.mesh.all_gather_dim`, recorded at the
  ``"state"`` site of :mod:`repro_torch.utils.comm_stats`).  A dim that
  the rules cut over ``model`` and that the rank computes a block of
  (:func:`repro_torch.distributed.tensor_parallel.local_names`: attention
  heads, MLP columns, the vocabulary, the RG-LRU's channels, Mamba2's
  heads (but its ``in_proj`` and conv, whose blocks are not whole heads),
  the MoE's experts under expert parallelism) is not gathered: the leaf
  reads as
  its ``model`` block, whole over its other axes
  (:attr:`Layout.gathered`: the specs it is gathered by), and the
  step runs under :meth:`Layout.model_cut`, on which the model code
  computes its blocks.  A leaf sharded over nothing else reads as its
  block with no collective.  A layer's weights are gathered where its
  forward reads them, inside its checkpointed region, so a remat
  recompute gathers them again and the backward holds no gathered
  weight past its layer (ZeRO-3's schedule); the ``embed`` group's
  where the forward uses it (a tied embedding, read twice, is gathered
  twice).  Expert parallelism reads its block of the experts and
  computes on it as it is (its ``shard_map`` neither cuts it nor sums
  its gradient over ``model``); ring attention computes the rank's
  query heads and trades them for a sequence block
  (:func:`repro_torch.distributed.ring_attention.ring_attention_heads`):
  neither gathers a weight over ``model``.
* A rank computes only its rows of the batch, as GSPMD partitions the
  reference's step with the batch on ``"data"``: :meth:`Layout.row_cut`
  resolves the batch's specs (``tree_shardings_for`` of its shapes and
  ``batch_logical_axes``, sanitized, so a batch that does not divide an
  axis stays whole over it) and gives the mesh axes of more than one
  rank that cut its rows (a :class:`repro_torch.distributed.ctx
  .RowCut`); the train step cuts the rows before the copy to the device
  and runs under it.  The loss is a mean over equal row blocks, so the
  global gradient is the sum of the ranks' gradients over those axes
  divided by their extent.
* The gather's backward makes that sum (``"grad"`` site): it reads the
  row axes from the current cut when the gather runs, then cuts the
  dims it gathered over axes where the rows are replicated (every rank
  there holds the same cotangent; a dim the rank computes a block of is
  its block already), all-reduces over the row axes the weight is not
  sharded on, and reduce-scatters each dim sharded over row axes
  (:func:`repro_torch.distributed.mesh.reduce_scatter_dim`), so that
  each rank keeps its block of the sum (:func:`_sum_plan`).  It sums
  over exactly the row axes, never over an axis where the rows are
  replicated, which would count those rows twice.  Outside a cut it is
  this rank's block of the cotangent, with no collective.  The gather
  holds its mesh, spec and row axes itself and reads no ambient context
  in its backward: a remat recompute may run on the autograd engine's
  device thread, where no :func:`repro_torch.distributed.ctx.axis_rules`
  is set.
* A leaf that gathers nothing (held whole, or cut over ``model`` only)
  is not parametrized, so :func:`sum_rows` all-reduces its gradient
  over the row axes after the backward, leaf by leaf in the tree's order
  on every rank.
* :func:`global_norm` sums each element of the gradient once: each
  leaf's sum of squares over its block, divided by the number of ranks
  holding that block (a power of two, so the division is exact), summed
  over leaves and all-reduced once over the world.
* :func:`save` writes a checkpoint leaf by leaf through host memory:
  each rank's block goes to rank 0's host, which assembles the global
  leaf and writes the reference's layout, so a checkpoint from any world
  restores into any other; :meth:`TrainState.load` cuts each rank's
  block from a restored tree as a copy.

Every rank calls these functions, and runs the step, in the same order:
the gathers are collectives.  On a mesh where a spec spans no axis of
more than one rank, nothing is parametrized and nothing is gathered: a
1 x 1 mesh runs the one-rank step as it is.  The serve steps take a
rank's blocks too (:func:`serve_blocks`): under rules that shard no
weight over the data axes (the reference's ``--no-fsdp``), a rank holds
only its ``model`` blocks and gathers nothing a token.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.nn.utils import parametrize

from . import sharding as sh
from .ctx import ModelCut, RowCut, local_axes, spanning
from .mesh import (
    _axes, _block, _local, all_gather_dim, all_reduce, reduce_scatter_dim)
from .sharding import PartitionSpec


@dataclasses.dataclass
class Layout:
    """Where a rank-local state's blocks lie: the mesh and the state's
    spec tree (a :class:`repro_torch.train.TrainState` of
    PartitionSpecs, as :func:`specs_for` gives it)."""

    mesh: object
    specs: object
    rules: sh.Rules = sh.DEFAULT_RULES
    #: the specs each parameter leaf is gathered by: ``specs.params``
    #: less the dims the rank computes a block of (None: all gathered)
    gathered: object = None

    def gather_specs(self):
        """:attr:`gathered`, or the parameters' specs where it is None."""
        return self.specs.params if self.gathered is None \
            else self.gathered

    def model_cut(self) -> Optional[ModelCut]:
        """The :class:`repro_torch.distributed.ctx.ModelCut` the model
        computes its blocks on: the axes of the dims that are not
        gathered; None where every leaf is gathered whole."""
        found = set()
        for _, spec, g in _pairs(self.specs.params, self.gather_specs()):
            for dim, e in enumerate(spec):
                if (len(g) <= dim or g[dim] is None) and \
                        spanning(self.mesh, e):
                    found.add(spanning(self.mesh, e))
        if len(found) > 1:
            raise ValueError(f"the leaves cut over model are cut over "
                             f"different axes: {sorted(found)}")
        return ModelCut(self.mesh, found.pop()) if found else None

    def replicas(self, spec) -> int:
        """The number of ranks holding the same block under ``spec``."""
        return self.mesh.size // math.prod(
            self.mesh.extent(e) for e in spec if e is not None)

    def batch_specs(self, cfg, batch: dict, microbatches: int = 1) -> dict:
        """The specs of a microbatch of the global ``batch`` (a dict of
        arrays, as the train step takes it, split into ``microbatches``
        slices of rows): ``tree_shardings_for`` of its shapes and the
        reference's ``batch_logical_axes``, sanitized against them."""
        from repro_torch.launch.specs import batch_logical_axes
        axes = batch_logical_axes(cfg)
        extra = set(batch) - set(axes)
        if extra:
            raise ValueError(f"batch keys {sorted(extra)} have no logical "
                             f"axes (batch_logical_axes: {sorted(axes)})")
        shapes = {}
        for k, v in batch.items():
            b = v.shape[0]
            if b % microbatches:
                raise ValueError(f"batch {b} does not split into "
                                 f"{microbatches} microbatches")
            shapes[k] = (b // microbatches,) + tuple(v.shape[1:])
        return sh.tree_shardings_for(shapes, {k: axes[k] for k in batch},
                                     self.mesh, self.rules)

    def row_cut(self, cfg, batch: dict,
                microbatches: int = 1) -> Optional[RowCut]:
        """The rows this rank computes of each microbatch of the global
        ``batch``: the mesh axes of more than one rank over which
        :meth:`batch_specs` cuts every leaf's dim 0; None when none
        does."""
        specs = self.batch_specs(cfg, batch, microbatches)
        rows = {spanning(self.mesh, s[0] if len(s) else None)
                for s in specs.values()}
        if len(rows) != 1:
            raise ValueError(f"the batch's leaves cut their rows over "
                             f"different axes: {specs}")
        rows = rows.pop()
        return RowCut(self.mesh, rows) if rows else None


def specs_for(cfg, mesh, rules: sh.Rules = sh.DEFAULT_RULES):
    """The train state's specs, as the reference's ``in_shardings``
    (``tree_shardings_for(state_spec(cfg), state_logical_axes(cfg), mesh,
    rules)``, its registered dataclass mapped field by field): a
    :class:`repro_torch.train.TrainState` of PartitionSpecs, the step
    replicated."""
    from repro_torch.train import TrainState, state_logical_axes, state_spec
    spec, axes = state_spec(cfg), state_logical_axes(cfg)
    return TrainState(step=PartitionSpec(), **{
        k: sh.tree_shardings_for(getattr(spec, k), getattr(axes, k), mesh,
                                 rules) for k in ("params", "opt")})


def gathered_specs(cfg, specs, mesh, rules, names=None) -> dict:
    """The parameters' specs ``specs`` less each dim whose logical axis
    the rank computes a block of (``names``; None:
    :func:`repro_torch.distributed.tensor_parallel.local_names`; a leaf
    by leaf decision, :func:`repro_torch.distributed.tensor_parallel
    .computes_block`: Mamba2's ``in_proj`` and conv are gathered whole
    on its cut heads): the specs the leaves are gathered by.  A ``names``
    without some of them gives a layout that gathers those dims whole too
    (``Layout(mesh, specs, rules, gathered)``)."""
    from repro_torch import models as M
    from .tensor_parallel import computes_block, local_names
    if names is None:
        names = local_names(cfg, mesh, rules)

    def drop(spec, axes, path):
        return PartitionSpec(*(None if computes_block(path, name, names)
                               else e for e, name in zip(spec, axes)))

    def walk(tree, axes, path):
        if isinstance(tree, dict):
            return {k: walk(tree[k], axes[k], path + (k,))
                    for k in sorted(tree)}
        return drop(tree, axes, path)
    return walk(specs, M.logical_axes(cfg), ())


def layout_for(cfg, mesh, rules: sh.Rules = sh.DEFAULT_RULES) -> Layout:
    specs = specs_for(cfg, mesh, rules)
    return Layout(mesh, specs, rules,
                  gathered_specs(cfg, specs.params, mesh, rules))


def layout_of(params) -> Optional[Layout]:
    """The :class:`Layout` of a rank-local parameter module, None for a
    module that holds the global tensors."""
    return getattr(params, "rank_local_layout", None)


def _pairs(tree, specs, prefix=()):
    """``(path, leaf, spec)`` over a tree of dicts and its spec tree, in
    :func:`repro_torch.utils.tree.tree_flatten`'s (sorted-key) order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _pairs(tree[k], specs[k], prefix + (k,))
    else:
        yield prefix, tree, specs


def spec_leaves(tree, specs) -> list:
    """The specs of ``tree``'s leaves, in
    :func:`repro_torch.utils.tree.tree_leaves`' order."""
    return [spec for _, _, spec in _pairs(tree, specs)]


def _map(fn, tree, specs):
    """``fn(leaf, spec)`` over the tree, leaf by leaf in sorted-key order
    (every rank the same)."""
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], specs[k]) for k in sorted(tree)}
    return fn(tree, specs)


def _gathers(mesh, spec) -> bool:
    return any(e is not None and mesh.extent(e) > 1 for e in spec)


def block_shape(mesh, shape, spec) -> tuple:
    """The shape of one rank's block of a ``shape`` tensor under
    ``spec``."""
    out = list(shape)
    for dim, axes in enumerate(spec):
        if axes is not None:
            n = mesh.extent(axes)
            if out[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(shape)} does not "
                                 f"divide by mesh axes {_axes(axes)}")
            out[dim] //= n
    return tuple(out)


def _reads(cfg) -> dict:
    """How often a forward reads a leaf, where not once: the tied
    embedding (the table and the head: twice), the audio model's extra
    codebook tables (once a codebook) and the VLM's patch projection (read
    only with frontend inputs: never here)."""
    return {("embed", "embedding"): 2 if cfg.tie_embeddings else 1,
            ("embed", "codebook_embed"): cfg.num_codebooks - 1,
            ("embed", "patch_proj"): 0}


def _local_shape(mesh, shape, spec, gspec) -> tuple:
    """``shape`` with each dim the rank computes a block of (sharded in
    ``spec``, not in ``gspec``) cut to its block."""
    out = list(shape)
    for dim, e in enumerate(spec):
        if e is not None and (len(gspec) <= dim or gspec[dim] is None):
            out[dim] //= mesh.extent(e)
    return tuple(out)


def _tally(cfg, layout: Layout, count) -> dict:
    """``count(shape, spec, element size) -> (n, bytes)`` of one read of
    each leaf (a unit's leaves without their stacked dim; ``shape`` the
    leaf's as it reads, its ``model`` blocks cut; ``spec`` the one it is
    gathered by), times its reads, summed as ``{"unit": (n, bytes),
    "rest": (n, bytes)}``."""
    from repro_torch.train import state_spec
    reads = _reads(cfg)
    out = {"unit": [0, 0], "rest": [0, 0]}
    for path, t, spec in _pairs(state_spec(cfg).params, layout.specs.params):
        gspec = _leaf(layout.gather_specs(), path)
        unit = path[0] in ("layers", "groups")
        shape = _local_shape(layout.mesh, t.shape, spec, gspec)
        shape, gspec = (shape[1:], gspec[1:]) if unit else (shape, gspec)
        n, nbytes = count(tuple(shape), gspec, t.element_size())
        tally = out["unit" if unit else "rest"]
        tally[0] += reads.get(path, 1) * n
        tally[1] += reads.get(path, 1) * nbytes
    return {k: tuple(v) for k, v in out.items()}


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def forward_gathers(cfg, layout: Layout) -> dict:
    """The all-gathers one forward over a batch of tokens takes on a
    rank-local state of ``cfg``, and their result bytes: ``{"unit": (n,
    bytes), "rest": (n, bytes)}``, ``unit`` for one read of a layer's (or
    a pattern group's) leaves, ``rest`` for the other leaves' reads.  A
    read of a leaf gathers its block over each dim sharded over more than
    one rank that the rank does not compute a block of
    (:attr:`Layout.gathered`), in dim order, each result the block grown
    by the dims gathered so far.  A forward reads each leaf once, but those of
    :func:`_reads`.  A step reads a unit once a unit forward, the remat
    recomputes included
    (:func:`repro_torch.models.common.layer_forward_runs`)."""
    mesh = layout.mesh

    def count(shape, spec, size):
        block = list(block_shape(mesh, shape, spec))
        n = nbytes = 0
        for dim, axes in enumerate(spec):
            if axes is not None and mesh.extent(axes) > 1:
                block[dim] *= mesh.extent(axes)
                n += 1
                nbytes += math.prod(block) * size
        return n, nbytes
    return _tally(cfg, layout, count)


def step_gathers(cfg, layout: Layout) -> tuple:
    """``(count, result bytes)`` of the ``"state"`` site of one train
    step on a rank-local state of ``cfg``: a unit's reads once a unit
    forward, the remat recomputes included, the other leaves' once
    (:func:`forward_gathers`), and :func:`global_norm`'s all-reduce of a
    float32 scalar."""
    from repro_torch.models.common import layer_forward_runs

    from .tensor_parallel import _units
    runs = layer_forward_runs(cfg, _units(cfg)[0])
    g = forward_gathers(cfg, layout)
    return (runs * g["unit"][0] + g["rest"][0] + 1,
            runs * g["unit"][1] + g["rest"][1] + 4)


def backward_sums(cfg, layout: Layout, rows) -> dict:
    """The gradient's sums over the row axes ``rows`` (``"grad"`` site)
    that one backward over a forward of a rank-local state takes, and
    their result bytes: ``{"unit": (n, bytes), "rest": (n, bytes)}`` of
    the gathers' backwards, as :func:`forward_gathers` counts reads (a
    read's backward runs once, the recomputes' none), and ``"whole"``:
    :func:`sum_rows`' all-reduces of the leaves that gather nothing, once
    a step.
    A reduce-scatter's bytes are its result's, the block; an
    all-reduce's its operand's."""
    from repro_torch.train import state_spec
    mesh = layout.mesh

    def count(shape, spec, size):
        if not _gathers(mesh, spec):
            return 0, 0
        shape, n, nbytes = list(shape), 0, 0
        for kind, dim, axes in _sum_plan(mesh, spec, rows):
            if kind != "all-reduce":
                shape[dim] //= mesh.extent(axes)
            if kind != "cut":
                n += 1
                nbytes += math.prod(shape) * size
        return n, nbytes
    out = _tally(cfg, layout, count)
    whole = [math.prod(_local_shape(mesh, t.shape, spec, g))
             * t.element_size()
             for (_, t, spec), g in zip(
                 _pairs(state_spec(cfg).params, layout.specs.params),
                 spec_leaves(layout.specs.params, layout.gather_specs()))
             if rows and not _gathers(mesh, g)]
    out["whole"] = (len(whole), sum(whole))
    return out


def block_spec(tree, specs, mesh):
    """``tree``'s tensors (meta or real) as ``meta`` tensors of their
    blocks' shapes and dtypes: a rank's state with nothing allocated."""
    return _map(lambda t, s: torch.empty(block_shape(mesh, t.shape, s),
                                         dtype=t.dtype, device="meta"),
                tree, specs)


def cut_block(mesh, x: torch.Tensor, spec) -> torch.Tensor:
    """This rank's block of the global ``x``, a contiguous copy that owns
    its memory (a view would keep the global storage alive)."""
    return _local(mesh, x.detach(), spec).clone(
        memory_format=torch.contiguous_format)


def cut_tree(tree, specs, mesh) -> dict:
    """Every leaf's block (:func:`cut_block`), leaf by leaf: ``tree``'s
    leaves are popped as they are cut, so a caller that holds no other
    reference frees each global leaf before the next is cut."""
    out = {}
    for k in sorted(tree):
        v = tree.pop(k)
        out[k] = (cut_tree(v, specs[k], mesh) if isinstance(v, dict)
                  else cut_block(mesh, v, specs[k]))
        del v
    return out


def _sum_plan(mesh, spec, rows) -> list:
    """The steps that turn a gathered weight's cotangent (the gradient of
    this rank's rows) into this rank's block of its sum over the row axes
    ``rows``: ``(kind, dim, axes)``, in order.  First ``"cut"`` each dim
    sharded over axes where the rows are replicated (every rank along
    them holds the same cotangent); then ``"all-reduce"`` over the row
    axes the weight is not sharded on; then each dim sharded over row
    axes: a ``"reduce-scatter"``, or, where its entry mixes row axes with
    others, an all-reduce over its row axes and a cut.  Axes of one rank
    take no step.  ``spec`` is the one the weight is gathered by
    (:attr:`Layout.gathered`): a dim the rank computes a block of is None
    there, and its cotangent is that block already, so it is not cut."""
    rows = set(rows)
    dims = [(dim, tuple(a for a in _axes(e) if mesh.shape[a] > 1))
            for dim, e in enumerate(spec)]
    steps = [("cut", dim, ax) for dim, ax in dims if ax and not rows & set(ax)]
    used = {a for _, ax in dims for a in ax}
    rest = tuple(a for a in mesh.axis_names if a in rows and a not in used)
    if rest:
        steps.append(("all-reduce", None, rest))
    for dim, ax in dims:
        if not rows & set(ax):
            continue
        if set(ax) <= rows:
            steps.append(("reduce-scatter", dim, ax))
        else:
            steps += [("all-reduce", None,
                       tuple(a for a in ax if a in rows)), ("cut", dim, ax)]
    return steps


def _sum_block(mesh, g, spec, rows):
    """:func:`_sum_plan` run on the cotangent ``g``, divided by the row
    blocks' number: this rank's block of the global gradient."""
    for kind, dim, axes in _sum_plan(mesh, spec, rows):
        if kind == "cut":
            start, size = _block(mesh, g.shape[dim], axes, "cut")
            g = g.narrow(dim, start, size)
        elif kind == "all-reduce":
            g = all_reduce(mesh, g, axes, site="grad")
        else:
            g = reduce_scatter_dim(mesh, g, axes, dim, site="grad")
    return g / mesh.extent(tuple(rows))


class _GatherBlock(torch.autograd.Function):
    """A block to the tensor whole over ``spec``'s axes (the global
    tensor, or its ``model`` block where the spec leaves that dim
    out); the backward is this rank's block of
    the cotangent summed over the row axes ``rows`` (:func:`_sum_block`),
    or with no row axes the block itself (every rank holds the same
    cotangent), no collective."""

    @staticmethod
    def forward(ctx, block, mesh, spec, rows):
        ctx.mesh, ctx.spec, ctx.rows = mesh, spec, rows
        x = block
        for dim, axes in enumerate(spec):
            if axes is not None and mesh.extent(axes) > 1:
                x = all_gather_dim(mesh, x, axes, dim, site="state")
        return x

    @staticmethod
    def backward(ctx, g):
        if ctx.rows:
            return _sum_block(ctx.mesh, g, ctx.spec, ctx.rows), None, None, \
                None
        return _local(ctx.mesh, g, ctx.spec), None, None, None


class _Gathered(nn.Module):
    """The parametrization: a parameter's block read whole over its
    gathered spec's axes, under the row cut current where it is read."""

    def __init__(self, mesh, spec: PartitionSpec):
        super().__init__()
        self.mesh, self.spec = mesh, spec

    def forward(self, block):
        return _GatherBlock.apply(block, self.mesh, self.spec,
                                  local_axes(self.mesh))


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def model_from_blocks(cfg, blocks: dict, layout: Layout) -> nn.Module:
    """The family's module over a tree of blocks (the parameters' part of
    ``layout.specs``): its parameters are views of the blocks, and every
    one whose gathered spec (:attr:`Layout.gathered`) spans more than
    one rank is gathered at each access."""
    from repro_torch import models as M
    model = M.model_from_tree(cfg, blocks)
    mesh = layout.mesh
    leaf_spec = {_storage_key(leaf): (leaf, spec) for _, leaf, spec in
                 _pairs(blocks, layout.gather_specs())}
    for mod in list(model.modules()):
        for name, p in list(mod.named_parameters(recurse=False)):
            leaf, spec = leaf_spec[_storage_key(p)]
            if p.dim() < leaf.dim():        # a layer's view of the stack
                spec = PartitionSpec(*spec[1:])
            if _gathers(mesh, spec):
                parametrize.register_parametrization(
                    mod, name, _Gathered(mesh, spec), unsafe=True)
    model.rank_local_layout = layout
    return model


def serve_blocks(cfg, params, layout: Layout) -> nn.Module:
    """A serving model of this rank's blocks of ``params`` (a model of
    global tensors, freed once the caller drops it) under ``layout``
    (:func:`layout_for`: only its parameters' part is read): frozen
    parameters, gathered where :attr:`Layout.gathered` shards them, the
    rest the rank's ``model`` blocks.  The serve steps run it under
    :meth:`Layout.model_cut`."""
    blocks = _map(lambda t, s: cut_block(layout.mesh, t, s),
                  params.param_tree(), layout.specs.params)
    return model_from_blocks(cfg, blocks, layout).requires_grad_(False)


def init_state(cfg, layout: Layout, generator=None, *, device,
               weight_std: Optional[float] = None):
    """A rank-local :class:`repro_torch.train.TrainState` at step 0: the
    global parameters drawn from ``generator`` as
    :func:`repro_torch.models.init_params` draws them (the same values
    on every rank), cut to this rank's blocks leaf by leaf and freed;
    ``m`` and ``v`` zero blocks."""
    from repro_torch import models as M
    from repro_torch.train import TrainState
    tree = M.init_params(cfg, generator, device=device,
                         weight_std=weight_std).param_tree()
    blocks = cut_tree(tree, layout.specs.params, layout.mesh)
    return TrainState.of(model_from_blocks(cfg, blocks, layout))


def shard_state(cfg, state, layout: Layout):
    """``state`` (global tensors) as a rank-local state: this rank's
    blocks of the parameters, ``m`` and ``v`` as contiguous copies, the
    same step.  The global tensors are freed once the caller drops
    ``state``."""
    from repro_torch.train import TrainState
    mesh, specs = layout.mesh, layout.specs
    blocks = _map(lambda t, s: cut_block(mesh, t, s),
                  state.params.param_tree(), specs.params)
    opt = {k: _map(lambda t, s: cut_block(mesh, t, s), state.opt[k],
                   specs.opt[k]) for k in ("m", "v")}
    return TrainState.of(model_from_blocks(cfg, blocks, layout),
                         step=state.step, opt=opt)


def sum_rows(grads: dict, layout: Layout, cut: Optional[RowCut]) -> None:
    """After the backward of a step on ``cut``'s rows: each gradient leaf
    that gathers nothing (held whole or cut over ``model`` only, so no
    backward summed it)
    all-reduced over the row axes and divided by the row blocks' number,
    in place, leaf by leaf in the tree's order on every rank."""
    if cut is None or not cut.rows:
        return
    for _, g, spec in _pairs(grads, layout.gather_specs()):
        if not _gathers(layout.mesh, spec):
            g.copy_(all_reduce(layout.mesh, g, cut.rows, site="grad")
                    / cut.n_rows)


def global_norm(grads: dict, layout: Layout) -> torch.Tensor:
    """The global norm of the gradient whose blocks ``grads`` holds
    (the parameters' spec tree's shape): each element counted once."""
    sums = [torch.sum(torch.square(g.float())) / layout.replicas(spec)
            for _, g, spec in _pairs(grads, layout.specs.params)]
    total = all_reduce(layout.mesh, torch.sum(torch.stack(sums)),
                       layout.mesh.axis_names, site="state")
    return torch.sqrt(total)


def _gather_leaf(mesh, block: torch.Tensor, spec):
    """The global leaf on rank 0's host from every rank's block; None on
    the others."""
    local = block.detach().cpu().contiguous()
    parts = ([torch.empty_like(local) for _ in range(mesh.size)]
             if mesh.rank == 0 else None)
    dist.gather(local, parts, dst=0)
    if mesh.rank != 0:
        return None
    shape = list(local.shape)
    for dim, axes in enumerate(spec):
        if axes is not None:
            shape[dim] *= mesh.extent(axes)
    out = torch.empty(shape, dtype=local.dtype)
    for r, part in enumerate(parts):
        coords = dict(zip(mesh.axis_names,
                          np.unravel_index(r, mesh.ranks.shape)))
        view = out
        for dim, axes in enumerate(spec):
            if axes is not None:
                i = 0
                for a in _axes(axes):
                    i = i * mesh.shape[a] + int(coords[a])
                view = view.narrow(dim, i * part.shape[dim], part.shape[dim])
        view.copy_(part)
    return out


def host_tree(state) -> Optional[dict]:
    """The rank-local ``state`` as a one-rank state holds it: ``{"params",
    "opt", "step"}`` of global host tensors on rank 0 (None on the
    others), gathered leaf by leaf through host memory, so that no leaf
    is ever whole on a device.  Every rank calls it, in a world on
    ``gloo`` (the host tensors' backend: ranks that share a card, or the
    CPU's)."""
    layout = layout_of(state.params)
    mesh, specs = layout.mesh, layout.specs
    gather = lambda t, s: _gather_leaf(mesh, t, s)             # noqa: E731
    params = _map(gather, state.params.param_tree(), specs.params)
    opt = {k: _map(gather, state.opt[k], specs.opt[k]) for k in ("m", "v")}
    if mesh.rank != 0:
        return None
    return {"params": params, "opt": opt,
            "step": np.asarray(state.step, np.int32)}


def save(store, step: int, state):
    """Save a rank-local ``state`` to ``store``
    (:class:`repro_torch.runtime.ZonedCheckpointStore`): rank 0 writes the
    files a one-rank save of the same state writes; returns its
    ``store.save`` result there, None on the other ranks.  Every rank
    calls it."""
    tree = host_tree(state)
    out = store.save(step, tree) if tree is not None else None
    dist.barrier()
    return out
