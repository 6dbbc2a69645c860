"""Small pytree helpers over nested dicts, lists and tuples.

The port of ``repro.utils.tree`` (``tree_bytes``, ``tree_count``) and of
the ``jax.tree.flatten`` / ``unflatten`` pair that the checkpoint store
relies on.  Leaves come out in jax's order: a dict's children by sorted
key (an ``OrderedDict``'s in insertion order), a list's or tuple's in
order, and ``None`` is an empty subtree.  ``torch.utils._pytree`` keeps
a dict's insertion order, so it does not give that order.  Any other
object (a tensor, an array, a number) is a leaf.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TreeDef:
    """A tree's structure: ``kind`` (``"leaf"``, ``"none"`` or the
    container type), the dict keys in flatten order, the children."""

    kind: Any
    keys: Tuple = ()
    children: Tuple = ()

    @property
    def num_leaves(self) -> int:
        if self.kind == "leaf":
            return 1
        return sum(c.num_leaves for c in self.children)


_LEAF = TreeDef("leaf")


def _keys(node: dict) -> list:
    return list(node) if isinstance(node, collections.OrderedDict) \
        else sorted(node)


def _walk(node, leaves: list) -> TreeDef:
    if node is None:
        return TreeDef("none")
    if isinstance(node, dict):
        keys = _keys(node)
        return TreeDef(type(node), tuple(keys),
                       tuple(_walk(node[k], leaves) for k in keys))
    if isinstance(node, (list, tuple)):
        return TreeDef(type(node), (), tuple(_walk(c, leaves) for c in node))
    leaves.append(node)
    return _LEAF


def tree_flatten(tree) -> tuple:
    """``(leaves, treedef)`` in ``jax.tree.flatten``'s leaf order.  The
    walk is a module-level function, not a closure that calls itself: such
    a closure is a reference cycle, which would keep the leaves alive until
    the garbage collector runs (a training step's gradient buffers past
    the step's end)."""
    leaves: list = []
    return leaves, _walk(tree, leaves)


def _build(d: TreeDef, it):
    if d.kind == "leaf":
        return next(it)
    if d.kind == "none":
        return None
    vals = [_build(c, it) for c in d.children]
    if issubclass(d.kind, dict):
        return d.kind(zip(d.keys, vals))
    if hasattr(d.kind, "_fields"):                     # a namedtuple
        return d.kind(*vals)
    return d.kind(vals)


def tree_unflatten(treedef: TreeDef, leaves):
    """The tree of ``treedef``'s structure holding ``leaves`` in order."""
    leaves = list(leaves)
    if len(leaves) != treedef.num_leaves:
        raise ValueError(f"{len(leaves)} leaves for a tree of "
                         f"{treedef.num_leaves}")
    return _build(treedef, iter(leaves))


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[0]


def _shape_itemsize(x) -> tuple:
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), x.element_size()
    a = np.asarray(x)
    return a.shape, a.dtype.itemsize


def tree_bytes(tree) -> int:
    total = 0
    for x in tree_leaves(tree):
        shape, itemsize = _shape_itemsize(x)
        total += int(np.prod(shape)) * itemsize
    return int(total)


def tree_count(tree) -> int:
    return int(sum(np.prod(_shape_itemsize(x)[0])
                   for x in tree_leaves(tree)))
