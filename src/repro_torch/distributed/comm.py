"""Collectives inside a :func:`repro_torch.distributed.mesh.shard_map`
body: the port of ``jax.lax.ppermute``, ``psum``, ``pmean``, ``pmax`` and
tiled ``all_to_all``.

Each takes the mesh and one or more of its axis names, and works over the
ranks that share this rank's coordinates on the other axes.  Those that
carry a gradient are ``torch.autograd.Function``\\ s with JAX's transposes:
``ppermute``'s backward is the inverse permutation, ``all_to_all``'s the
reverse exchange, and ``psum``'s a ``psum`` of the cotangents (the
cotangent of a replicated output is already divided by the ranks holding
it at the ``shard_map`` boundary, so the sum restores it once, and a
psum'd value that feeds the same loss on every rank gets its gradient
once).  ``pmax`` carries none, as its uses (a softmax's running maximum)
cancel out of the result.

Every exchange is one ``all_to_all_single`` (ppermute: each rank's split
is its whole block, sent to one peer) and every reduction one
``all_reduce``: the two collectives, with ``all_gather``, that ``gloo``
runs on CUDA tensors.  Each counts in :mod:`repro_torch.utils.comm_stats`
as its semantic kind (a ``ppermute`` as a collective-permute).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch.utils import comm_stats
from .mesh import Mesh, all_reduce, axis_index


def _exchange(mesh: Mesh, x: torch.Tensor, axis: str, perm) -> torch.Tensor:
    pg, order = mesh.group(axis)
    me = axis_index(mesh, axis)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    flat = x.contiguous().view(1, -1)
    send = [0] * len(order)
    recv = [0] * len(order)
    if dst:
        send[order[dst[0]]] = 1
    if src:
        recv[order[src[0]]] = 1
    out = flat.new_empty((len(src), flat.shape[1]))
    comm_stats.note("collective-permute", x.nbytes, len(order))
    dist.all_to_all_single(out, flat[:len(dst)], recv, send, group=pg)
    return out.view(x.shape) if src else torch.zeros_like(x)


def _check_perm(mesh: Mesh, axis: str, perm) -> tuple:
    perm = tuple((int(s), int(d)) for s, d in perm)
    n = mesh.shape[axis]
    srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts) or \
            not all(0 <= i < n for i in srcs + dsts):
        raise ValueError(f"ppermute over {axis!r} ({n} ranks): {perm} is not "
                         f"a partial permutation")
    return perm


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.mesh, ctx.axis, ctx.perm = mesh, axis, perm
        return _exchange(mesh, x, axis, perm)

    @staticmethod
    def backward(ctx, g):
        inverse = tuple((d, s) for s, d in ctx.perm)
        return _exchange(ctx.mesh, g, ctx.axis, inverse), None, None, None


def ppermute(mesh: Mesh, x: torch.Tensor, axis: str,
             perm: Sequence[tuple]) -> torch.Tensor:
    """``x`` from the rank at ``src`` for each ``(src, dst)`` pair of axis
    indices; zeros where no pair names this rank as ``dst``."""
    return _PPermute.apply(x, mesh, axis, _check_perm(mesh, axis, perm))


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, site):
        ctx.mesh, ctx.axes, ctx.site = mesh, axes, site
        return all_reduce(mesh, x, axes, site=site)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(ctx.mesh, g, ctx.axes, site=ctx.site), None, None, \
            None


def psum(mesh: Mesh, x: torch.Tensor, axes, *,
         site: str = "body") -> torch.Tensor:
    """The sum of ``x`` over ``axes`` (a name or a tuple), on each rank.
    ``site``: what :mod:`repro_torch.utils.comm_stats` records it as."""
    return _PSum.apply(x, mesh, axes, site)


def pmean(mesh: Mesh, x: torch.Tensor, axes, *,
          site: str = "body") -> torch.Tensor:
    return psum(mesh, x, axes, site=site) / mesh.extent(axes)


def pmax(mesh: Mesh, x: torch.Tensor, axes, *,
         site: str = "body") -> torch.Tensor:
    """The maximum of ``x`` over ``axes``; carries no gradient."""
    return all_reduce(mesh, x.detach(), axes, op=dist.ReduceOp.MAX,
                      site=site)


def _tiled(mesh: Mesh, x: torch.Tensor, axis: str, split_axis: int,
           concat_axis: int, site: str) -> torch.Tensor:
    pg, order = mesh.group(axis)
    n = len(order)
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all over {axis!r} ({n} ranks): dim "
                         f"{split_axis} of {tuple(x.shape)} does not divide")
    chunks = x.chunk(n, dim=split_axis)
    by_rank = [None] * n
    for j, r in enumerate(order):
        by_rank[r] = chunks[j]
    send = torch.stack(by_rank)
    recv = torch.empty_like(send)
    comm_stats.note("all-to-all", send.nbytes, n, site)
    dist.all_to_all_single(recv, send, group=pg)
    return torch.cat([recv[r] for r in order], dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_axis, concat_axis, site):
        ctx.args = (mesh, axis, split_axis, concat_axis, site)
        return _tiled(mesh, x, axis, split_axis, concat_axis, site)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, split_axis, concat_axis, site = ctx.args
        return (_tiled(mesh, g, axis, concat_axis, split_axis, site),
                None, None, None, None, None)


def all_to_all(mesh: Mesh, x: torch.Tensor, axis: str, split_axis: int,
               concat_axis: int, *, site: str = "body") -> torch.Tensor:
    """Tiled all-to-all: ``x``'s ``split_axis`` in as many chunks as
    ``axis`` has ranks, chunk j to the rank of index j, and the chunks
    received concatenated on ``concat_axis`` in the senders' order
    (``jax.lax.all_to_all(..., tiled=True)``).  ``site``: what
    :mod:`repro_torch.utils.comm_stats` records it as (its backward's
    exchange too)."""
    return _AllToAll.apply(x, mesh, axis, split_axis, concat_axis, site)
