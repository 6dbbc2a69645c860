"""Compressed cross-pod gradient collectives with error feedback.

The port of ``repro.distributed.collectives``.  ``ef_compressed_psum``
halves (bf16) or quarters (int8, with a shared pmax scale, summed in
int32) the wire bytes of the pod-axis gradient all-reduce; the
quantization residual is carried in an error-feedback buffer a pod, so
the *accumulated* gradient stays unbiased (EF-SGD/EF21-style).  The bf16
sum is the backend's: gloo adds bfloat16 values in its own order,
rounding each partial sum, which is not XLA's order either (hence the
reference's 2e-2 against :func:`compressed_psum_reference`).
"""
from __future__ import annotations

import torch

from repro_torch.utils.tree import tree_flatten, tree_leaves, tree_unflatten

from . import comm
from .mesh import Mesh, shard_map
from .sharding import PartitionSpec as PS


def init_error_state(grads):
    leaves, treedef = tree_flatten(grads)
    return tree_unflatten(treedef, [
        torch.zeros(g.shape, dtype=torch.float32, device=g.device)
        for g in leaves])


def _compress_psum_leaf(mesh: Mesh, g, e, axis, method):
    """One leaf: returns (psum-ed g_hat, new error)."""
    x = g.float() + e
    if method == "bf16":
        q = x.to(torch.bfloat16)
        err = x - q.float()
        out = comm.psum(mesh, q, axis).float()
        return out, err
    if method == "int8":
        # divisions by tensors: on a card torch divides by a Python number
        # as a product with its reciprocal, which rounds otherwise than
        # the reference's division
        scale = comm.pmax(mesh, torch.amax(torch.abs(x)), axis) \
            / x.new_tensor(127.0)
        scale = torch.clamp(scale, min=1e-12)
        q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
        err = x - q.float() * scale
        out = comm.psum(mesh, q.to(torch.int32), axis).float()
        return out * scale, err
    raise ValueError(method)


def ef_compressed_psum(mesh: Mesh, grads, error_state, *, axis: str = "pod",
                       method: str = "bf16", mean: bool = True):
    """All-reduce ``grads`` over ``axis`` with compression + error feedback.

    grads/error_state leaves carry a leading pod dimension of extent
    ``mesh.shape[axis]`` (each pod's partial gradient / residual).
    Returns (reduced grads without the pod dim, per-pod new error state).
    """
    if method not in ("bf16", "int8"):
        raise ValueError(method)
    n = mesh.shape[axis]
    leaves, treedef = tree_flatten(grads)
    eleaves = tree_leaves(error_state)

    def body(*args):
        k = len(args) // 2
        outs, errs = [], []
        for g, e in zip(args[:k], args[k:]):
            o, ne = _compress_psum_leaf(mesh, g[0], e[0], axis, method)
            outs.append(o / n if mean else o)
            errs.append(ne[None])
        return tuple(outs) + tuple(errs)

    # reduced outputs are identical on every rank (replicated out_specs);
    # error states stay per pod (PS(axis)): each pod carries its own
    # quantization residual into the next step
    res = shard_map(
        body, mesh,
        in_specs=tuple(PS(axis) for _ in range(2 * len(leaves))),
        out_specs=tuple(PS() for _ in leaves)
        + tuple(PS(axis) for _ in leaves),
    )(*leaves, *eleaves)
    k = len(leaves)
    return tree_unflatten(treedef, res[:k]), tree_unflatten(treedef, res[k:])


def compressed_psum_reference(grads_per_pod, method: str = "bf16"):
    """Single-process oracle: what the compressed all-reduce computes for a
    list of per-pod gradients."""
    n = len(grads_per_pod)
    if method == "bf16":
        q = [g.to(torch.bfloat16).float() for g in grads_per_pod]
        return sum(q) / n
    if method == "int8":
        scale = max(float(torch.amax(torch.abs(g)))
                    for g in grads_per_pod) / 127.0
        scale = grads_per_pod[0].new_tensor(max(scale, 1e-12))
        q = [torch.round(torch.clamp(g / scale, -127, 127)) * scale
             for g in grads_per_pod]
        return sum(q) / n
    raise ValueError(method)
