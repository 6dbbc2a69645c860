"""Elastic scaling: deterministic resharding plans when the healthy host
set changes (the port's own copy of ``repro.runtime.elastic``, host
Python and numpy, unchanged).

The data pipeline is pure-functional in (step, shard, num_shards), so
elasticity reduces to (1) choosing a new data-shard layout, (2) remapping
checkpoint shard ownership, and (3) picking the largest feasible mesh for
the surviving chips.  All three are deterministic given the healthy set,
so every surviving host computes the identical plan with no coordinator.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ReshardPlan:
    old_hosts: tuple
    new_hosts: tuple
    # data pipeline: host -> (shard, num_shards)
    data_shards: dict
    # checkpoint restore: new host -> list of old shard ids to load
    shard_ownership: dict
    # mesh proposal: (data, model) extents for the surviving chip count
    mesh_shape: tuple


def largest_mesh(n_chips: int, *, model_parallel: int = 16,
                 chips_per_host: int = 4) -> tuple:
    """Largest (data, model) mesh using at most n_chips, keeping TP fixed
    (model-parallel degree is a property of the model fit, not the fleet)."""
    usable = (n_chips // model_parallel) * model_parallel
    if usable == 0:
        raise ValueError(f"fewer than {model_parallel} chips left")
    return (usable // model_parallel, model_parallel)


def make_reshard_plan(old_hosts, new_hosts, *, model_parallel: int = 16,
                      chips_per_host: int = 4) -> ReshardPlan:
    old_hosts = tuple(sorted(old_hosts))
    new_hosts = tuple(sorted(new_hosts))
    if not new_hosts:
        raise ValueError("cannot reshard onto an empty healthy host set")
    n = len(new_hosts)
    data_shards = {h: (i, n) for i, h in enumerate(new_hosts)}
    # old shard ids were 0..len(old)-1; round-robin them over new hosts
    ownership = {h: [] for h in new_hosts}
    for old_shard in range(len(old_hosts)):
        ownership[new_hosts[old_shard % n]].append(old_shard)
    mesh = largest_mesh(n * chips_per_host, model_parallel=model_parallel,
                        chips_per_host=chips_per_host)
    return ReshardPlan(old_hosts, new_hosts, data_shards, ownership, mesh)


def validate_plan(plan: ReshardPlan) -> None:
    shards = [s for lst in plan.shard_ownership.values() for s in lst]
    if sorted(shards) != list(range(len(plan.old_hosts))):
        raise AssertionError("shard ownership must cover every old shard once")
    ranks = sorted(s for s, _ in plan.data_shards.values())
    if ranks != list(range(len(plan.new_hosts))):
        raise AssertionError("data shards must be a permutation of ranks")
