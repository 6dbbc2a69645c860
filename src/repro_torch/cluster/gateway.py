"""Gateway: object PUT/GET/DELETE streams -> striped shard requests.

The gateway is the cluster's protocol head: it owns the placement map
(policy-driven, see :mod:`repro_torch.cluster.placement`), cuts each object
op into per-server :class:`ShardOp`\\ s under the cluster's
:class:`~repro_torch.cluster.codec.RedundancyScheme`, and charges the EC
codec cost (encode on PUT, decode on reconstruction GET).  The result
is a pure *plan* — a list of :class:`OpPlan` — consumed identically by
the chain-program compiler and the event-engine oracle, so both model
the same cluster by construction.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import MiB

from .placement import placement_map
from .spec import OP_DELETE, OP_GET, OP_PUT, ClusterSpec, ObjectOp


@dataclasses.dataclass(frozen=True)
class ShardOp:
    """One shard-granular request from a gateway to a storage server."""

    op_seq: int         # owning object op (index into the op stream)
    slot: int           # slot in the object's placement row
    server: int
    write: bool         # True: shard write (PUT); False: shard read (GET)
    nbytes: int         # padded shard payload bytes (0 = metadata-only)


@dataclasses.dataclass(frozen=True)
class OpPlan:
    """An object op resolved to its shard fan-out + codec costs."""

    op: ObjectOp
    shards: Tuple[ShardOp, ...]
    encode_us: float    # gateway-side EC encode (PUT), 0 otherwise
    decode_us: float    # gateway-side EC reconstruction decode (GET)


class Gateway:
    """Plans object ops against a fixed placement map.

    ``down`` (a server id) switches the gateway to degraded mode:
    PUTs skip the dead server's slot, GETs fail over per the scheme
    (replica failover, or full-stripe EC reconstruction reads).
    """

    def __init__(self, spec: ClusterSpec, rows: Dict[int, np.ndarray]):
        self.spec = spec
        self.rows = rows            # object id -> placement row

    def plan(self, op: ObjectOp, *, down: Optional[int] = None) -> OpPlan:
        scheme = self.spec.scheme
        servers = self.rows[op.obj]
        sb = scheme.shard_bytes(op.nbytes)
        if op.kind == OP_PUT:
            slots = scheme.write_slots(servers, down)
            enc = (self.spec.gateway.encode_us_per_mib * op.nbytes / MiB
                   if scheme.kind == "ec" and scheme.m > 0 else 0.0)
            shards = tuple(ShardOp(op.seq, s, int(servers[s]), True, sb)
                           for s in slots)
            return OpPlan(op=op, shards=shards, encode_us=enc, decode_us=0.0)
        if op.kind == OP_GET:
            slots, decode = scheme.read_slots(servers, down)
            dec = (self.spec.gateway.decode_us_per_mib * op.nbytes / MiB
                   if decode else 0.0)
            shards = tuple(ShardOp(op.seq, s, int(servers[s]), False, sb)
                           for s in slots)
            return OpPlan(op=op, shards=shards, encode_us=0.0, decode_us=dec)
        if op.kind == OP_DELETE:
            slots = scheme.write_slots(servers, down)   # all live replicas
            shards = tuple(ShardOp(op.seq, s, int(servers[s]), True, 0)
                           for s in slots)
            return OpPlan(op=op, shards=shards, encode_us=0.0, decode_us=0.0)
        raise ValueError(f"unknown op kind {op.kind}")


def plan_workload(spec: ClusterSpec, ops: Sequence[ObjectOp], *,
                  seed: int = 0, down: Optional[int] = None) -> List[OpPlan]:
    """Placement + shard planning for a whole op stream.

    Returns one :class:`OpPlan` per op, in canonical op order.  The
    placement map is computed once over the distinct object ids, so a
    GET sees exactly the row its PUT wrote.
    """
    if down is not None and not 0 <= down < spec.n_servers:
        raise ValueError(f"down server {down} outside [0, {spec.n_servers})")
    objs = sorted({op.obj for op in ops})
    rows_arr = placement_map(objs, spec.scheme.n_shards, spec.n_servers,
                             policy=spec.placement, seed=seed)
    rows = {obj: rows_arr[i] for i, obj in enumerate(objs)}
    gw = Gateway(spec, rows)
    return [gw.plan(op, down=down) for op in ops]
