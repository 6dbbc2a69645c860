"""Placement policies: object -> the servers holding its shard slots.

A policy is a function ``(obj, n_shards, n_servers, seed) -> row`` of
``n_shards`` **distinct** server ids.  Policies live in a shared
warn-on-collision :class:`repro_torch.core.registry.Registry` (same semantics
as the host layer's policy registries) so experiments and external code
can plug in new layouts::

    >>> from repro_torch.cluster import placement_map, register_placement
    >>> @register_placement("all-on-zero", replace=True)
    ... def _p(obj, n_shards, n_servers, seed):
    ...     return list(range(n_shards))        # ignore obj: slots 0..n-1
    >>> placement_map([7, 8], 3, 8, policy="all-on-zero").tolist()
    [[0, 1, 2], [0, 1, 2]]
    >>> from repro_torch.cluster.placement import PLACEMENTS
    >>> PLACEMENTS.unregister("all-on-zero")

Built-ins:

* ``round-robin`` — slot ``s`` of object ``o`` on server ``(o + s) % S``;
  adjacent objects shift by one, spreading primaries evenly.
* ``strided`` — like round-robin but objects start at ``(o * 7) % S``,
  decorrelating consecutive objects that share a gateway.
* ``grouped`` — servers are carved into ``S // n`` fixed placement
  groups; an object's whole stripe lives in one group (small recovery
  blast radius, worse load spread — the classic copyset trade-off).
* ``hashed`` — pseudo-random distinct servers per object (seeded, so
  runs are reproducible).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core.registry import Registry

PLACEMENTS = Registry("placement policy")


def register_placement(name: str, fn=None, *, replace: bool = False):
    """Register a placement policy; usable as a decorator."""
    return PLACEMENTS.register(name, fn, replace=replace)


def available_placements() -> tuple:
    return PLACEMENTS.available()


@register_placement("round-robin")
def _round_robin(obj: int, n_shards: int, n_servers: int, seed: int):
    return (obj + np.arange(n_shards)) % n_servers


@register_placement("strided")
def _strided(obj: int, n_shards: int, n_servers: int, seed: int):
    return ((obj * 7) % n_servers + np.arange(n_shards)) % n_servers


@register_placement("grouped")
def _grouped(obj: int, n_shards: int, n_servers: int, seed: int):
    n_groups = max(n_servers // n_shards, 1)
    start = (obj % n_groups) * n_shards
    return (start + np.arange(n_shards)) % n_servers


@register_placement("hashed")
def _hashed(obj: int, n_shards: int, n_servers: int, seed: int):
    rng = np.random.default_rng([seed, obj])
    return rng.permutation(n_servers)[:n_shards]


def placement_map(objects: Sequence[int], n_shards: int, n_servers: int, *,
                  policy: str = "round-robin", seed: int = 0) -> np.ndarray:
    """``(len(objects), n_shards)`` int array of server ids.

    Validates that every row holds distinct servers (a stripe must not
    co-locate two of its shards, or redundancy is silently lost).
    """
    if n_shards > n_servers:
        raise ValueError(f"cannot place {n_shards} distinct shards on "
                         f"{n_servers} servers")
    fn = PLACEMENTS.get(policy)
    rows = np.empty((len(objects), n_shards), dtype=np.int64)
    for i, obj in enumerate(objects):
        row = np.asarray(fn(int(obj), n_shards, n_servers, seed),
                         dtype=np.int64)
        if row.shape != (n_shards,):
            raise ValueError(f"policy {policy!r} returned shape {row.shape}; "
                             f"expected ({n_shards},)")
        if np.any(row < 0) or np.any(row >= n_servers):
            raise ValueError(f"policy {policy!r} placed object {obj} outside "
                             f"[0, {n_servers})")
        if len(np.unique(row)) != n_shards:
            raise ValueError(f"policy {policy!r} co-located shards of object "
                             f"{obj}: {row.tolist()}")
        rows[i] = row
    return rows
