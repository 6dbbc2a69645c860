"""GPipe-style pipeline parallelism over a mesh axis.

The port of ``repro.distributed.pipeline``.  Stages are layer blocks
sharded over a ``pipe`` mesh axis; microbatches stream through the
classic (M + n_stages - 1)-tick schedule and activations hop stages with
:func:`repro_torch.distributed.comm.ppermute`.  The last stage's outputs
reach every rank by a ``psum``.  ``ppermute`` and ``psum`` carry their
gradients, so autograd through :func:`gpipe` runs the backward pipeline
schedule: GPipe without a hand-written backward.

Which input a stage takes, and which outputs count, depends on its rank.
As in the reference it is a select on values (``torch.where``), not a
branch: every rank then runs the same collectives in the same order in
the backward too, which a branch around a ``ppermute``'s result would
break.
"""
from __future__ import annotations

import torch

from repro_torch.utils.tree import tree_flatten, tree_unflatten

from . import comm
from .mesh import Mesh, axis_index, shard_map
from .sharding import PartitionSpec as PS


def gpipe(mesh: Mesh, stage_fn, stage_params, x_microbatches, *,
          axis: str = "pipe"):
    """Run ``stage_fn`` as a pipeline over ``axis``.

    stage_fn(params_slice, x) -> y, where params_slice is one stage's
    params (leading stage dim stripped).
    stage_params: tree (nested dicts) with leading dim n_stages on every
    leaf.  x_microbatches: (M, mb, ...) microbatched inputs (replicated).
    Returns (M, mb, ...) outputs of the final stage, on every rank.
    """
    n = mesh.shape[axis]
    m = x_microbatches.shape[0]
    ticks = m + n - 1
    leaves, treedef = tree_flatten(stage_params)

    def body(*args):
        params_local, x_mb = args[:-1], args[-1]
        first = torch.tensor(axis_index(mesh, axis) == 0,
                             device=x_mb.device)
        last = torch.tensor(axis_index(mesh, axis) == n - 1,
                            device=x_mb.device)
        params_one = tree_unflatten(treedef, [a[0] for a in params_local])
        zero = torch.zeros_like(x_mb[0])
        recv = zero
        outs = []
        perm = [(i, (i + 1) % n) for i in range(n)]
        for t in range(ticks):
            feed = x_mb[t] if t < m else zero
            out = stage_fn(params_one, torch.where(first, feed, recv))
            if t >= n - 1:
                # the last stage emits microbatch t-(n-1)
                outs.append(torch.where(last, out, torch.zeros_like(out)))
            if t != ticks - 1:
                recv = comm.ppermute(mesh, out, axis, perm)
        # the last stage's result to every rank
        return comm.psum(mesh, torch.stack(outs), axis)

    in_specs = tuple(PS(axis) for _ in leaves) + (PS(),)
    return shard_map(body, mesh, in_specs=in_specs,
                     out_specs=PS())(*leaves, x_microbatches)


def stages_from_stack(layers, n_stages: int):
    """Reshape a (L, ...)-stacked layer tree into (n_stages, L/n, ...)."""
    def split(a):
        l = a.shape[0]
        if l % n_stages:
            raise ValueError(f"{l} layers do not split into {n_stages} "
                             f"stages")
        return a.reshape((n_stages, l // n_stages) + tuple(a.shape[1:]))
    leaves, treedef = tree_flatten(layers)
    return tree_unflatten(treedef, [split(a) for a in leaves])


def stack_stage_fn(layer_fn):
    """Lift a per-layer fn into a per-stage fn (a loop over the stage's
    layer slice)."""
    def stage(params_stage, x):
        leaves, treedef = tree_flatten(params_stage)
        for i in range(leaves[0].shape[0]):
            x = layer_fn(tree_unflatten(treedef, [a[i] for a in leaves]), x)
        return x
    return stage
