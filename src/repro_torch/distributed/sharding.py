"""Logical-axis sharding rules -> PartitionSpecs.

The port of ``repro.distributed.sharding``.  Model code annotates
parameters and activations with *logical* axis names (the ``P`` spec
trees of :mod:`repro_torch.models.common`); this module maps them onto
physical mesh axes.  Rules are ordered; the first matching rule whose
mesh axes are all still unused in the current PartitionSpec wins (a mesh
axis may appear at most once per spec, the MaxText/t5x resolution
scheme).

Default placement:
  TP  over "model":  vocab, q-heads, mlp hidden, experts, ssm/rnn inner
  FSDP over "data":  the embed (d_model) dim of weight matrices
  DP  over ("pod", "data"): batch
  decode KV cache:   cache_seq over "model" (flash-decode style)

Spec logic needs only a mesh's axis names and extents
(:class:`repro_torch.distributed.mesh.AbstractMesh`).  torch has no
``NamedSharding``: :func:`tree_shardings_for` returns the sanitized specs,
which :func:`repro_torch.distributed.mesh.shard_map` takes as they are.
Trees are nested dicts and lists; anything else is a leaf.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

Rules = tuple[tuple[str, tuple[str, ...]], ...]


class PartitionSpec(tuple):
    """One entry a tensor dimension: a mesh axis name, a tuple of them, or
    None (replicated).  A tuple, so that it compares entry for entry with
    ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


PS = PartitionSpec


def make_rules(*, fsdp: bool = True, seq_shard_cache: bool = True,
               expert_parallel: bool = True,
               data_axes: tuple[str, ...] = ("pod", "data"),
               fsdp_axes: Optional[tuple[str, ...]] = None,
               model_axis: str = "model") -> Rules:
    m = (model_axis,)
    # FSDP shards weights over every batch axis (pod included): ZeRO-3
    # across the full fleet, so optimizer state scales 1/chips.
    fsdp_axes = fsdp_axes if fsdp_axes is not None else data_axes
    rules = [
        ("batch", data_axes),
        ("vocab", m),
        ("heads", m),
        ("mlp", m),
        ("ssm_inner", m),
        ("rnn", m),
        ("experts", m if expert_parallel else ()),
        ("expert_mlp", () if expert_parallel else m),
        ("experts_r", m if not expert_parallel else ()),
        ("cache_seq", m if seq_shard_cache else ()),
        ("embed", fsdp_axes if fsdp else ()),
        ("act_embed", ()),
        ("layers", ()),
        ("layer_groups", ()),
        ("kv_heads", ()),
        ("head_dim", ()),
        ("seq", ()),
        ("seq_sp", m),
        ("conv", ()),
        ("ssm_heads", ()),
        ("ssm_state", ()),
        ("rnn_blocks", ()),
        ("rnn_in", ()),
        ("rnn_out", ()),
        ("embed_in", ()),
        ("codebooks", ()),
    ]
    return tuple((k, tuple(v)) for k, v in rules)


DEFAULT_RULES = make_rules()


def spec_from_axes(axes: Optional[Sequence[Optional[str]]],
                   rules: Rules = DEFAULT_RULES,
                   mesh=None) -> PartitionSpec:
    """Resolve one logical-axes tuple to a PartitionSpec.

    Mesh axes already used by an earlier dim are skipped (replicate), as
    are rules whose mesh axes don't exist in ``mesh`` (e.g. no "pod" axis
    on the single-pod mesh).
    """
    if axes is None:
        return PS()
    rule_map = dict(rules)
    used: set[str] = set()
    out = []
    mesh_axes = set(mesh.axis_names) if mesh is not None else None
    for ax in axes:
        if ax is None:
            out.append(None)
            continue
        if ax not in rule_map:
            raise KeyError(f"no sharding rule for logical axis {ax!r}")
        cand = [a for a in rule_map[ax]
                if a not in used and (mesh_axes is None or a in mesh_axes)]
        if not cand:
            out.append(None)
        elif len(cand) == 1:
            used.add(cand[0])
            out.append(cand[0])
        else:
            used.update(cand)
            out.append(tuple(cand))
    while out and out[-1] is None:      # trim trailing Nones (cosmetic)
        out.pop()
    return PS(*out)


def _is_axes(x) -> bool:
    return x is None or (isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x))


def _map(fn, tree, *rest, is_leaf=lambda x: False):
    """``fn`` over the leaves of ``tree`` (nested dicts and lists), with
    the matching subtrees of ``rest`` taken whole at each leaf."""
    if not is_leaf(tree):
        if isinstance(tree, dict):
            return {k: _map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
                    for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_specs(axes_tree, rules: Rules = DEFAULT_RULES, mesh=None):
    """Map a tree of logical-axes tuples to PartitionSpecs."""
    return _map(lambda axes: spec_from_axes(axes, rules, mesh), axes_tree,
                is_leaf=_is_axes)


def shardable(dim: int, mesh, axes) -> bool:
    """True if ``dim`` divides by the mesh extent of ``axes``."""
    if axes is None:
        return True
    axes = (axes,) if isinstance(axes, str) else axes
    n = int(np.prod([mesh.shape[a] for a in axes]))
    return dim % n == 0


def _shape(x) -> tuple:
    return tuple(getattr(x, "shape", x))


def validate_specs(shape_tree, spec_tree, mesh) -> None:
    """Raise if any spec doesn't divide its array shape on ``mesh``.
    ``shape_tree``'s leaves are shapes or objects with a ``shape``."""
    def check(shape, spec):
        shape = _shape(shape)
        for i, axes in enumerate(spec):
            if axes is None:
                continue
            if not shardable(shape[i], mesh, axes):
                raise ValueError(
                    f"dim {i} of shape {shape} not divisible by mesh "
                    f"axes {axes} ({dict(mesh.shape)})")
    _map(check, shape_tree, spec_tree, is_leaf=_is_shape_leaf)


def _is_shape_leaf(x) -> bool:
    return not isinstance(x, (dict, list))


# ---------------------------------------------------------------------------
# Sanitization: drop mesh axes that don't divide the dim (e.g. kv_heads=8 on
# model=16, batch=1 on data=16).  The spec is the *intent*; sanitize
# resolves per-(arch, shape) feasibility.
# ---------------------------------------------------------------------------
def sanitize(shape_tree, spec_tree, mesh):
    def fix(shape, spec):
        shape = _shape(shape)
        out = []
        for i, axes in enumerate(spec):
            if i >= len(shape):
                break
            if axes is None:
                out.append(None)
                continue
            tup = (axes,) if isinstance(axes, str) else tuple(axes)
            # greedily keep the largest prefix of axes that divides
            keep = []
            rem = shape[i]
            for a in tup:
                ext = mesh.shape[a]
                if rem % ext == 0:
                    keep.append(a)
                    rem //= ext
            if not keep:
                out.append(None)
            elif len(keep) == 1:
                out.append(keep[0])
            else:
                out.append(tuple(keep))
        while out and out[-1] is None:
            out.pop()
        return PS(*out)

    return _map(fix, shape_tree, spec_tree, is_leaf=_is_shape_leaf)


def tree_shardings_for(shape_tree, axes_tree, mesh,
                       rules: Rules = DEFAULT_RULES):
    """Specs resolved from rules, then sanitized against actual shapes
    (the reference wraps them in ``NamedSharding``; here they are the
    specs themselves)."""
    return sanitize(shape_tree, tree_specs(axes_tree, rules, mesh), mesh)
