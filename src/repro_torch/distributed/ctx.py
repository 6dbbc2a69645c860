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
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Sequence

from . import sharding as sh

_CTX = contextvars.ContextVar("repro_torch_sharding_ctx", default=None)


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
