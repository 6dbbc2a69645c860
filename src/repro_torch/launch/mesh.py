"""Production mesh construction: the port of ``repro.launch.mesh``.

Functions, not module-level constants, so importing this module never
touches a process group.  The production meshes are (16, 16) ("data",
"model"), 256 ranks, and (2, 16, 16) ("pod", "data", "model"), 512 ranks
for the multi-pod dry run.  A mesh is the port's
:class:`repro_torch.distributed.mesh.Mesh` over the default process
group, which must hold exactly the mesh's ranks (a port mesh spans its
whole world); the dry run gives it torch's ``fake`` backend with that
many ranks (:func:`repro_torch.launch.dryrun.fake_world`).
"""
from __future__ import annotations

import math
import os

import torch.distributed as dist

from repro_torch.distributed.mesh import Mesh


def production_shape(*, multi_pod: bool = False) -> tuple:
    """``(shape, axes)`` of the production mesh, after the test hooks
    ``REPRO_MESH_SHAPE`` / ``REPRO_MESH_SHAPE_MULTI`` (e.g. "2x4" /
    "2x2x4"), which shrink it without changing any other code path."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    env = os.environ.get(
        "REPRO_MESH_SHAPE_MULTI" if multi_pod else "REPRO_MESH_SHAPE")
    if env:
        shape = tuple(int(x) for x in env.split("x"))
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {shape} does not fit axes {axes}")
    return shape, axes


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape, axes = production_shape(multi_pod=multi_pod)
    n = math.prod(shape)
    if not dist.is_initialized() or dist.get_world_size() != n:
        have = dist.get_world_size() if dist.is_initialized() else 0
        raise RuntimeError(
            f"need a world of {n} ranks for mesh {shape}, have {have}; the "
            f"dry run starts one on the fake backend "
            f"(repro_torch.launch.dryrun.fake_world)")
    return make_mesh(shape, axes)


def make_mesh(shape, axes) -> Mesh:
    """A mesh of the default process group's ranks, on its backend."""
    return Mesh(shape, axes, backend=dist.get_backend(), device="cpu")


def data_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)
