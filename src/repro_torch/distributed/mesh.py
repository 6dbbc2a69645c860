"""Meshes of ranks: the counterpart of ``jax.sharding.Mesh`` and of
``shard_map``'s boundary.

A :class:`Mesh` lays the ranks of a ``torch.distributed`` world out on
named axes, row-major as ``np.array(jax.devices())
.reshape(shape)`` lays out devices, and holds one process group for
every set of its axes.  :func:`shard_map` runs a body the way
``jax.experimental.shard_map.shard_map`` does, with ranks in place of
devices:

* the body's inputs are global tensors, as the reference's functions
  take global arrays (a rank-local train state,
  :mod:`repro_torch.distributed.rank_local`, stores only its blocks and
  gathers a weight where the step reads it, so a body is handed the
  gathered tensor), or, along the axes a caller names (``local``,
  ``held``), this rank's block already: its rows of the batch, its
  block of the experts or of the query heads;
* each rank cuts its own block from them by its mesh coordinates and the
  ``in_specs`` (:func:`cut`: a view, not a copy: it keeps the global
  storage alive, so storing by blocks needs a copy,
  :func:`repro_torch.distributed.rank_local.cut_block`);
* the body runs on the blocks with the explicit collectives of
  :mod:`repro_torch.distributed.comm`;
* each rank rebuilds the global outputs from the ``out_specs``
  (:func:`gather`: an all-gather over the sharded axes; an output
  replicated over an axis is this rank's copy).

Gradients follow ``shard_map``'s transpose with ``check_rep=False``: the
cut's backward all-gathers the blocks' gradients and sums them over the
axes the input is replicated on; the gather's backward takes this rank's
block of the global cotangent and divides it by the extent of the axes
the output is replicated on.  A loss computed alike on every rank so
gets one gradient, not one a rank.  Every rank must run the same
collectives in the same order, in the forward and in the backward: a
body branches on its rank only through values (``torch.where``), never
around a collective or around what feeds one.

The backend is an explicit argument.  NCCL takes one GPU a rank, so a
mesh with more ranks than GPUs raises on it; ranks that share a card run
on ``gloo``, which takes CUDA tensors in ``all_reduce``, ``all_gather``
and ``all_to_all_single`` and stages them through the host.  The dry
run (:mod:`repro_torch.launch.dryrun`) builds meshes on torch's ``fake``
backend, whose collectives move nothing.  Nothing here switches backend.

Every collective here and in :mod:`repro_torch.distributed.comm` is
reported to :mod:`repro_torch.utils.comm_stats` (recorded only inside its
``record_collectives``).
"""
from __future__ import annotations

import itertools
import math
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.utils import comm_stats
from .sharding import PartitionSpec


class AbstractMesh:
    """Axis names and extents only: enough for the spec logic of
    :mod:`repro_torch.distributed.sharding`, as ``jax.sharding
    .AbstractMesh`` is for the reference's."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {tuple(shape)} and axes "
                             f"{tuple(axis_names)} differ in length")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated mesh axis in {tuple(axis_names)}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def extent(self, axes) -> int:
        """The number of ranks along ``axes`` (a name or a tuple)."""
        return math.prod(self.shape[a] for a in _axes(axes))

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.shape})"


def _axes(axes) -> tuple:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def check_backend(backend: str, world_size: int, device) -> None:
    """Raise unless ``world_size`` ranks can run on ``backend`` with their
    tensors on ``device``."""
    device = torch.device(device)
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("backend='nccl' needs CUDA tensors; use "
                             "backend='gloo' for tensors on the CPU")
        if world_size > torch.cuda.device_count():
            raise ValueError(
                f"backend='nccl' takes one GPU a rank: {world_size} ranks, "
                f"{torch.cuda.device_count()} GPU(s); ranks that share a "
                f"card run on backend='gloo'")
    elif backend not in ("gloo", "fake"):
        raise ValueError(f"unknown backend {backend!r}; expected 'gloo' or "
                         f"'nccl' ('fake' is the dry run's: "
                         f"repro_torch.launch.dryrun)")


class Mesh(AbstractMesh):
    """The ranks of the default process group on named axes, row-major.

    Building a mesh is collective: every rank of the world calls it with
    the same arguments.
    """

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *,
                 backend: str, device):
        super().__init__(shape, axis_names)
        if not dist.is_initialized():
            raise RuntimeError("Mesh needs torch.distributed's default "
                               "process group (repro_torch.distributed"
                               ".launch.init_world)")
        world = dist.get_world_size()
        if world != self.size:
            raise ValueError(f"mesh {self.shape} needs {self.size} ranks, "
                             f"the world has {world}")
        if dist.get_backend() != backend:
            raise ValueError(f"backend={backend!r}, but the default process "
                             f"group runs {dist.get_backend()!r}")
        check_backend(backend, world, device)
        self.backend = backend
        self.device = torch.device(device)
        self.ranks = np.arange(world).reshape(tuple(self.shape.values()))
        self.rank = dist.get_rank()
        where = np.unravel_index(self.rank, self.ranks.shape)
        self.coords = dict(zip(self.axis_names, (int(i) for i in where)))
        # one group for every set of axes: members in the set's row-major
        # order (mesh order); each built on every rank of the world
        self._groups = {}
        names = self.axis_names
        for k in range(1, len(names) + 1):
            for sub in itertools.combinations(range(len(names)), k):
                grid = np.moveaxis(self.ranks, sub, range(len(sub)))
                grid = grid.reshape(math.prod(grid.shape[:k]), -1)
                for col in range(grid.shape[1]):
                    members = [int(r) for r in grid[:, col]]
                    pg = dist.new_group(sorted(members), backend=backend)
                    if self.rank in members:
                        self._groups[tuple(names[i] for i in sub)] = (
                            pg, members)

    def group(self, axes):
        """``(process group, group rank of the member at each linear index
        over axes)``: the ranks that share this rank's coordinates on every
        other axis.  ``axes`` in any order; the linear index is row-major
        over them in the order given."""
        axes = _axes(axes)
        key = tuple(a for a in self.axis_names if a in axes)
        if len(key) != len(axes):
            raise ValueError(f"axes {axes} not all in mesh {self.shape}")
        pg, members = self._groups[key]
        by_rank = sorted(members)
        # members are in mesh order; re-index them in the order given
        grid = np.asarray(members).reshape([self.shape[a] for a in key])
        grid = np.transpose(grid, [key.index(a) for a in axes]).reshape(-1)
        return pg, [by_rank.index(int(r)) for r in grid]


def axis_index(mesh: Mesh, axes) -> int:
    """This rank's linear index along ``axes`` (row-major in the order
    given): ``jax.lax.axis_index``."""
    i = 0
    for a in _axes(axes):
        i = i * mesh.shape[a] + mesh.coords[a]
    return i


def _block(mesh: Mesh, dim_size: int, axes, what) -> tuple:
    n = mesh.extent(axes)
    if dim_size % n:
        raise ValueError(f"{what}: size {dim_size} does not divide by mesh "
                         f"axes {_axes(axes)} ({n} ranks)")
    size = dim_size // n
    return axis_index(mesh, axes) * size, size


def _unmentioned(mesh: Mesh, spec, local=()) -> tuple:
    used = {a for e in spec for a in _axes(e)} | set(local)
    return tuple(a for a in mesh.axis_names if a not in used)


def _drop_local(spec, local) -> PartitionSpec:
    """``spec`` without the entries over ``local``: the axes along which a
    tensor is already this rank's block.  An entry that mixes local axes
    with others is refused."""
    out = []
    for e in spec:
        ax = set(_axes(e))
        if ax and ax <= set(local):
            out.append(None)
        elif ax & set(local):
            raise ValueError(f"spec entry {e!r} mixes the local axes "
                             f"{tuple(local)} with others")
        else:
            out.append(e)
    return PartitionSpec(*out)


def _local(mesh: Mesh, x: torch.Tensor, spec) -> torch.Tensor:
    for dim, axes in enumerate(spec):
        if axes is not None:
            start, size = _block(mesh, x.shape[dim], axes, "cut")
            x = x.narrow(dim, start, size)
    return x


def all_gather_dim(mesh: Mesh, x: torch.Tensor, axes, dim: int, *,
                   site: str = "body"):
    """The blocks of ``x`` held along ``axes``, concatenated on ``dim`` in
    linear-index order.  ``site``: what :mod:`repro_torch.utils.comm_stats`
    records it as."""
    pg, order = mesh.group(axes)
    x = x.contiguous()
    comm_stats.note("all-gather", x.nbytes * len(order), len(order), site)
    parts = [torch.empty_like(x) for _ in order]
    dist.all_gather(parts, x, group=pg)
    return torch.cat([parts[r] for r in order], dim=dim)


#: ``reduce_scatter_single`` where torch has it (it replaces the
#: deprecated ``reduce_scatter_tensor``, the same collective)
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def reduce_scatter_dim(mesh: Mesh, x: torch.Tensor, axes, dim: int, *,
                       site: str = "body"):
    """``x`` summed over the ranks along ``axes`` and cut on ``dim``: this
    rank's block of the sum, the block of its linear index along ``axes``
    (the inverse of :func:`all_gather_dim`).  ``site``: what
    :mod:`repro_torch.utils.comm_stats` records it as."""
    pg, order = mesh.group(axes)
    n = len(order)
    if x.shape[dim] % n:
        raise ValueError(f"reduce-scatter over {_axes(axes)} ({n} ranks): "
                         f"dim {dim} of {tuple(x.shape)} does not divide")
    # gloo takes the blocks concatenated on dim 0, in group-rank order
    chunks = x.movedim(dim, 0).chunk(n, dim=0)
    by_rank = [None] * n
    for j, r in enumerate(order):
        by_rank[r] = chunks[j]
    send = torch.cat(by_rank)
    out = torch.empty_like(by_rank[0], memory_format=torch.contiguous_format)
    comm_stats.note("reduce-scatter", out.nbytes, n, site)
    _reduce_scatter(out, send, group=pg)
    return out.movedim(0, dim)


def all_reduce(mesh: Mesh, x: torch.Tensor, axes, op=dist.ReduceOp.SUM, *,
               site: str = "body"):
    """``x`` reduced over ``axes`` (a new tensor)."""
    pg, order = mesh.group(axes)
    out = x.contiguous().clone()
    comm_stats.note("all-reduce", out.nbytes, len(order), site)
    dist.all_reduce(out, op=op, group=pg)
    return out


def _global(mesh: Mesh, x: torch.Tensor, spec) -> torch.Tensor:
    for dim, axes in enumerate(spec):
        if axes is not None:
            x = all_gather_dim(mesh, x, axes, dim, site="boundary")
    return x


class _Cut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, spec, local):
        ctx.mesh, ctx.spec, ctx.local = mesh, spec, local
        return _local(mesh, x, spec)

    @staticmethod
    def backward(ctx, g):
        rest = _unmentioned(ctx.mesh, ctx.spec, ctx.local)
        if rest:
            g = all_reduce(ctx.mesh, g, rest, site="boundary")
        return _global(ctx.mesh, g, ctx.spec), None, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, spec, local):
        ctx.mesh, ctx.spec, ctx.local = mesh, spec, local
        return _global(mesh, x, spec)

    @staticmethod
    def backward(ctx, g):
        n = ctx.mesh.extent(_unmentioned(ctx.mesh, ctx.spec, ctx.local))
        g = _local(ctx.mesh, g, ctx.spec)
        return (g / n if n > 1 else g), None, None, None


def _spec(spec) -> PartitionSpec:
    return spec if isinstance(spec, PartitionSpec) else PartitionSpec(*spec)


def cut(mesh: Mesh, x: torch.Tensor, spec, local=()) -> torch.Tensor:
    """This rank's block of the global ``x`` under ``spec`` (a view).
    ``local``: mesh axes along which ``x`` is this rank's block already
    (its rows of a batch cut over them): not cut again, and its gradient
    not summed over them."""
    spec = _spec(spec)
    if len(spec) > x.dim():
        raise ValueError(f"spec {spec} has more entries than x has dims "
                         f"({tuple(x.shape)})")
    local = tuple(local)
    return _Cut.apply(x, mesh, _drop_local(spec, local), local)


def gather(mesh: Mesh, x: torch.Tensor, spec, local=()) -> torch.Tensor:
    """The global tensor whose blocks under ``spec`` the ranks hold; along
    the ``local`` axes each rank keeps its own block (see :func:`cut`)."""
    local = tuple(local)
    return _Gather.apply(x, mesh, _drop_local(_spec(spec), local), local)


def shard_map(body, mesh: Mesh, in_specs, out_specs, *, local=(),
              held=None):
    """``body`` over this rank's blocks of global inputs, giving global
    outputs.  ``in_specs`` has one spec an argument (an argument that is
    not a tensor, such as a Python int, passes as it is); ``out_specs``
    is one spec, or a tuple of them for a body returning a tuple.
    ``local``: mesh axes along which the arguments and the outputs are
    this rank's blocks already (a rank that holds only its rows of the
    batch, :class:`repro_torch.distributed.ctx.RowCut`, or its query
    heads): the specs' entries over them neither cut nor gather, and no
    gradient sums over them.  ``held`` (one tuple of mesh axes an
    argument): more such axes for one argument alone, along which it is
    this rank's own already (its block of the experts on ``model``,
    :class:`repro_torch.distributed.ctx.ModelCut`): it is neither cut
    nor gathered along them, and its gradient is not summed over
    them."""
    held = tuple(map(_axes, held)) if held is not None \
        else ((),) * len(in_specs)
    if len(held) != len(in_specs):
        raise ValueError(f"held {held}: one entry an argument")
    local = tuple(local)

    def run(*args):
        if len(args) != len(in_specs):
            raise ValueError(f"{len(args)} arguments, {len(in_specs)} "
                             f"in_specs")
        local_args = [cut(mesh, a, s, local + h)
                      if isinstance(a, torch.Tensor) else a
                      for a, s, h in zip(args, in_specs, held)]
        out = body(*local_args)
        if isinstance(out_specs, PartitionSpec):
            return gather(mesh, out, out_specs, local)
        if len(out) != len(out_specs):
            raise ValueError(f"body returned {len(out)} outputs, "
                             f"{len(out_specs)} out_specs")
        return tuple(gather(mesh, o, s, local)
                     for o, s in zip(out, out_specs))

    return run
