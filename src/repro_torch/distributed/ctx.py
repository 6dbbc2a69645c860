"""Ambient sharding context: lets model code express *logical* activation
shardings without threading a mesh through every call.

The port of ``repro.distributed.ctx``.  Launch code enters
``axis_rules(mesh, rules)``; model layers call ``constrain(x, (..logical
axes..))``, which resolves and sanitizes the spec as the reference does.
The reference then applies ``with_sharding_constraint``, a placement hint
for GSPMD that leaves the values alone; torch has no such partitioner, so
here the hint is resolved (an axis with no rule raises, as there) and
``x`` comes back unchanged.  The context also tells
:func:`repro_torch.models.common.full_attention` and
:func:`repro_torch.models.moe.moe_block` which mesh to run ring attention
and expert parallelism on.  Outside any context (unit tests, one device)
every call is a no-op.

A second context, :func:`row_cut`, says that this rank holds only its
rows of the batch (a :class:`RowCut`): the train step enters it where a
rank-local state cuts the batch over the mesh's data axes, and the serve
steps where a sharding context cuts the batch and the decode cache.
Model code reads it through :func:`current_cut`: the MoE routes over the
global batch, expert parallelism and ring attention take the rows as
they are, and the decode attention combines its cache's blocks of slots.

A third context, :func:`model_cut`, says that this rank holds only its
blocks of the weights that the rules cut over the ``model`` axis (a
:class:`ModelCut`: the mesh axes and this rank's index along them): the
train step enters it for a rank-local state whose layout cuts such
leaves, the serve steps for parameters held as such blocks.  Model code
reads it through :func:`current_model_cut` where a weight's shape is a
block of its width (:mod:`repro_torch.distributed.tensor_parallel`):
ring attention on a rank's query heads and expert parallelism on its
experts among them.
:func:`snapshot` and :func:`restored` carry all three contexts into a
remat recompute, which may run on a thread that has none of them, so
that it computes the same blocks.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Optional, Sequence

import torch

from . import sharding as sh

_CTX = contextvars.ContextVar("repro_torch_sharding_ctx", default=None)
_CUT = contextvars.ContextVar("repro_torch_row_cut", default=None)
_MODEL = contextvars.ContextVar("repro_torch_model_cut", default=None)


@dataclasses.dataclass(frozen=True)
class RowCut:
    """What a rank holds of a batch on ``mesh``: the rows of its linear
    index along the mesh axes ``rows`` (in equal blocks, rank-major), and
    of a decode cache the block of slots of its index along ``seq``.  Only
    axes of more than one rank are named: an empty ``rows`` cuts
    nothing."""

    mesh: object
    rows: tuple = ()
    seq: tuple = ()

    @property
    def n_rows(self) -> int:
        """The number of row blocks: the extent of ``rows``."""
        return self.mesh.extent(self.rows)

    def take(self, x):
        """This rank's rows of the global ``x`` (a view: its dim 0 cut)."""
        from .mesh import _block
        start, size = _block(self.mesh, x.shape[0], self.rows, "rows")
        return x.narrow(0, start, size)

    def gather(self, x):
        """The global batch from every rank's rows ``x`` (an all-gather
        over ``rows``)."""
        from .mesh import all_gather_dim
        if not self.rows:
            return x
        return all_gather_dim(self.mesh, x, self.rows, 0, site="rows")

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of ``x`` over the row blocks (``x`` a value of this
        rank's rows that averages equal blocks), with no gradient."""
        from .mesh import all_reduce
        if not self.rows:
            return x
        return all_reduce(self.mesh, x.detach(), self.rows,
                          site="rows") / self.n_rows


@dataclasses.dataclass(frozen=True)
class ModelCut:
    """The weights a rank holds of the ``model`` axis on ``mesh``: the
    block of its linear index along the mesh axes ``axes`` (of more than
    one rank) of every width the rules cut over them: attention heads,
    MLP columns, the vocabulary, the RG-LRU's channels, Mamba2's heads,
    the experts.  ``seq``: Megatron's sequence parallelism is on, and
    the residual stream between the sublayers is the rank's block of the
    sequence along the same axes
    (:func:`repro_torch.distributed.tensor_parallel.sequence_parallel`)."""

    mesh: object
    axes: tuple
    seq: bool = False

    @property
    def n(self) -> int:
        """The number of blocks: the extent of ``axes``."""
        return self.mesh.extent(self.axes)

    @property
    def index(self) -> int:
        """This rank's block: its linear index along ``axes``."""
        from .mesh import axis_index
        return axis_index(self.mesh, self.axes)


def spanning(mesh, axes) -> tuple:
    """The axes of ``axes`` (a spec entry: a name, a tuple or None) that
    span more than one rank of ``mesh``."""
    if axes is None:
        return ()
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return tuple(a for a in axes if mesh.shape[a] > 1)


@contextlib.contextmanager
def row_cut(cut: Optional[RowCut]):
    """Run the block with ``cut`` as the rank's :class:`RowCut` (None: the
    rank holds the global batch)."""
    token = _CUT.set(cut)
    try:
        yield
    finally:
        _CUT.reset(token)


def current_cut() -> Optional[RowCut]:
    """The innermost :func:`row_cut`'s :class:`RowCut`, or None."""
    return _CUT.get()


@contextlib.contextmanager
def model_cut(cut: Optional[ModelCut]):
    """Run the block with ``cut`` as the rank's :class:`ModelCut` (None:
    the rank holds its weights whole)."""
    token = _MODEL.set(cut)
    try:
        yield
    finally:
        _MODEL.reset(token)


def current_model_cut() -> Optional[ModelCut]:
    """The innermost :func:`model_cut`'s :class:`ModelCut`, or None."""
    return _MODEL.get()


def local_axes(mesh) -> tuple:
    """The axes along which the tensors of a body on ``mesh`` are this
    rank's rows already (a ``shard_map``'s ``local``): the current cut's
    row axes.  Rows cut on another mesh raise: a body would cut them
    again."""
    cut = _CUT.get()
    if cut is None or not cut.rows:
        return ()
    if cut.mesh is not mesh:
        raise ValueError(f"the rows are cut on {cut.mesh}, the body runs on "
                         f"{mesh}: build both from one Mesh")
    return cut.rows


def snapshot() -> tuple:
    """The three contexts as they stand: ``(axis rules, row cut, model
    cut)``."""
    return _CTX.get(), _CUT.get(), _MODEL.get()


@contextlib.contextmanager
def restored(snap: tuple):
    """Run the block under a :func:`snapshot`'s contexts."""
    t1, t2, t3 = _CTX.set(snap[0]), _CUT.set(snap[1]), _MODEL.set(snap[2])
    try:
        yield
    finally:
        _MODEL.reset(t3)
        _CUT.reset(t2)
        _CTX.reset(t1)


@contextlib.contextmanager
def axis_rules(mesh, rules: sh.Rules = sh.DEFAULT_RULES):
    token = _CTX.set((mesh, rules))
    try:
        yield
    finally:
        _CTX.reset(token)


def current():
    """``(mesh, rules)`` of the innermost :func:`axis_rules`, or None."""
    return _CTX.get()


def constrain(x, axes: Sequence[Optional[str]]):
    """``x``, after resolving the sharding its logical ``axes`` imply
    (mesh axes that don't divide a dim are dropped, as ``sanitize``
    does)."""
    ctx = _CTX.get()
    if ctx is None:
        return x
    mesh, rules = ctx
    spec = sh.spec_from_axes(tuple(axes), rules, mesh)
    sh.sanitize([x], [spec], mesh)
    return x
