"""Cluster topology + workload declarations.

A cluster is ``n_gateways`` protocol gateways in front of ``n_servers``
storage servers, each server backed by one ZNS device through the host
layer's :class:`repro_torch.host.LogStructuredVolume`.  Every knob the cluster
compiler consumes lives in one frozen :class:`ClusterSpec` so compiled
programs are deterministic in ``(spec, workload, degraded_server)``.

Latency building blocks (all microseconds):

* NIC serialization — ``nbytes * wire_overhead`` over a full-duplex
  link (independent tx/rx lanes, capacity 1 each);
* one-way network latency — a pure-delay hop (infinite parallelism);
* CPU stages — a fixed per-request cost on a ``cpu_cores``-wide pool
  (homogeneous by construction so the compiled pool chains stay inside
  the chain-program exactness envelope; erasure-coding encode/decode
  costs are charged on dedicated no-pool events instead);
* the device itself — the calibrated :mod:`repro_torch.core` latency model,
  via each server's log-structured volume.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core import ArrivalProcess, KiB, MiB, ZNSDeviceSpec

from .codec import RedundancyScheme, erasure

#: Per-server device geometry: ZN540 ratios (cap < size, 14 open/active)
#: at 1/32 zone scale, mirroring ``repro_torch.host.HOST_SCENARIO_SPEC`` so a
#: 16-server rack stays cheap to simulate on either backend.
CLUSTER_DEVICE_SPEC = ZNSDeviceSpec(
    name="ZN540-cluster-1/32",
    zone_size_bytes=64 * MiB, zone_cap_bytes=48 * MiB, num_zones=64,
    max_open_zones=14, max_active_zones=14)


def _wire_us(nbytes: float, gbps: float, overhead: float) -> float:
    # bytes -> us at `gbps` line rate: nbytes * 8 bits / (gbps * 1e3 bits/us)
    return float(nbytes) * overhead * 8.0e-3 / float(gbps)


@dataclasses.dataclass(frozen=True)
class NetworkSpec:
    """NIC + fabric model shared by every hop in the cluster."""

    gw_nic_gbps: float = 100.0      # gateway NIC line rate
    srv_nic_gbps: float = 25.0      # storage-server NIC line rate
    one_way_us: float = 5.0         # fabric latency per direction
    wire_overhead: float = 1.05     # framing/headers on payload bytes
    req_bytes: int = 4 * KiB        # request/ack control-message size

    def gw_tx_us(self, nbytes: float) -> float:
        return _wire_us(nbytes, self.gw_nic_gbps, self.wire_overhead)

    def srv_tx_us(self, nbytes: float) -> float:
        return _wire_us(nbytes, self.srv_nic_gbps, self.wire_overhead)


@dataclasses.dataclass(frozen=True)
class GatewaySpec:
    """Gateway service stages (request parsing, striping, EC codec)."""

    cpu_cores: int = 2
    cpu_us: float = 15.0            # per-op request handling (all op kinds)
    encode_us_per_mib: float = 20.0  # EC encode, charged per object MiB
    decode_us_per_mib: float = 40.0  # EC reconstruct-decode, per object MiB


@dataclasses.dataclass(frozen=True)
class ServerSpec:
    """Storage-server service stages + writeback buffer."""

    cpu_cores: int = 2
    cpu_us: float = 10.0            # per-shard request handling (all kinds)
    writeback_bytes: int = 32 * MiB  # buffer capacity (inserts stall when full)
    flush_chunk: int = 1 * MiB      # device append granularity of the flusher
    flush_qd: int = 4               # flusher queue depth (lag-qd append chain)


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """One rack: gateways, servers, the fabric, and the redundancy plan.

    ``durability`` selects the PUT acknowledgement point:
    ``"writeback"`` acks once the shard is in the server's buffer (the
    flush to flash is asynchronous but still backpressures through the
    buffer-capacity gate); ``"write-through"`` acks only after the
    device append covering the shard's bytes completes.
    """

    n_gateways: int = 2
    n_servers: int = 8
    scheme: RedundancyScheme = erasure(4, 2)
    placement: str = "round-robin"
    network: NetworkSpec = NetworkSpec()
    gateway: GatewaySpec = GatewaySpec()
    server: ServerSpec = ServerSpec()
    device_spec: ZNSDeviceSpec = CLUSTER_DEVICE_SPEC
    durability: str = "writeback"

    def __post_init__(self):
        if self.n_gateways < 1 or self.n_servers < 1:
            raise ValueError("cluster needs >= 1 gateway and >= 1 server")
        if self.scheme.n_shards > self.n_servers:
            raise ValueError(
                f"scheme {self.scheme.name} places {self.scheme.n_shards} "
                f"shards but the cluster has only {self.n_servers} servers")
        if self.durability not in ("writeback", "write-through"):
            raise ValueError(f"unknown durability {self.durability!r}; "
                             f"expected writeback | write-through")
        if self.server.writeback_bytes < 2 * self.server.flush_chunk:
            raise ValueError("writeback buffer must hold >= 2 flush chunks")


# ---------------------------------------------------------------------------
# Workload: closed-loop object op streams
# ---------------------------------------------------------------------------
#: Object-op kinds (compiler-internal integer coding).
OP_PUT, OP_GET, OP_DELETE = 0, 1, 2
OP_NAMES = ("put", "get", "delete")


@dataclasses.dataclass(frozen=True)
class ObjectOp:
    """One client-issued object operation."""

    seq: int            # global op index (canonical order)
    client: int
    gateway: int
    kind: int           # OP_PUT | OP_GET | OP_DELETE
    obj: int            # global object id
    nbytes: int
    issue: float        # earliest issue time (us); closed loop gates the rest


@dataclasses.dataclass(frozen=True)
class ClusterWorkload:
    """Closed-loop users issuing PUT/GET/DELETE object streams.

    Each user (client) runs ``ops_per_user`` operations at queue depth
    ``qd``: the first is always a PUT, later slots draw GET (probability
    ``get_fraction``, over the user's own already-completed objects),
    DELETE (``delete_fraction``), else a fresh PUT.  Object sizes are
    uniform (``object_bytes``) so every network/CPU/device service class
    stays homogeneous and the compiled cluster program is *exact*
    against the event-engine oracle.  Deterministic in ``seed``.

    ``arrival`` stamps *open-loop offered load* onto the op stream: the
    canonical interleaved order gets explicit issue times from the
    :class:`repro_torch.core.ArrivalProcess` instead of ``issue=0`` (pair it
    with ``qd >= ops_per_user`` so the per-client closed-loop edges
    vanish and the rack sees the arrival clock alone — that is what
    :func:`repro_torch.cluster.plan_capacity`'s ``rate_ladder`` mode does).
    """

    n_users: int = 8
    ops_per_user: int = 8
    object_bytes: int = 2 * MiB
    get_fraction: float = 0.4
    delete_fraction: float = 0.0
    qd: int = 1
    seed: int = 0
    arrival: Optional[ArrivalProcess] = None

    def __post_init__(self):
        if self.n_users < 1 or self.ops_per_user < 1:
            raise ValueError("need >= 1 user and >= 1 op per user")
        if self.qd < 1:
            raise ValueError("qd must be >= 1")
        if not 0.0 <= self.get_fraction + self.delete_fraction <= 1.0:
            raise ValueError("get_fraction + delete_fraction must be in "
                             "[0, 1]")

    def build(self, n_gateways: int) -> List[ObjectOp]:
        """Generate the op stream; clients map to gateways round-robin
        and per-client slots interleave across clients so the canonical
        order is fair.  A GET/DELETE only targets objects whose PUT sits
        at least ``qd`` slots earlier on the same client (closed-loop
        read-your-writes: the PUT's completion is guaranteed to gate
        it).  Open-loop streams (``arrival`` set) use a window of one
        slot instead — the op mix must not collapse to all-PUTs when
        the planner raises ``qd`` to disable the closed-loop edges, and
        shard-level consistency is enforced by the compiler's
        ``seq``/``wb_data``/``rd_data`` edges regardless."""
        rng = np.random.default_rng(self.seed)
        window = 1 if self.arrival is not None else self.qd
        per_client: List[List[Tuple[int, int, int]]] = []
        next_obj = 0
        for c in range(self.n_users):
            ops: List[Tuple[int, int, int]] = []
            live: List[Tuple[int, int]] = []     # (obj, put slot)
            for slot in range(self.ops_per_user):
                readable = [o for o, s in live if s <= slot - window]
                r = float(rng.random())
                if slot > 0 and readable and r < self.get_fraction:
                    obj = readable[int(rng.integers(len(readable)))]
                    ops.append((OP_GET, obj, self.object_bytes))
                elif slot > 0 and readable and \
                        r < self.get_fraction + self.delete_fraction:
                    obj = readable[int(rng.integers(len(readable)))]
                    live = [(o, s) for o, s in live if o != obj]
                    ops.append((OP_DELETE, obj, 0))
                else:
                    obj = next_obj
                    next_obj += 1
                    live.append((obj, slot))
                    ops.append((OP_PUT, obj, self.object_bytes))
            per_client.append(ops)
        n_ops = self.n_users * self.ops_per_user
        times = (self.arrival.issue_times(n_ops, size=self.object_bytes)
                 if self.arrival is not None else np.zeros(n_ops))
        out: List[ObjectOp] = []
        for slot in range(self.ops_per_user):
            for c in range(self.n_users):
                kind, obj, nbytes = per_client[c][slot]
                out.append(ObjectOp(
                    seq=len(out), client=c, gateway=c % n_gateways,
                    kind=kind, obj=obj, nbytes=nbytes,
                    issue=float(times[len(out)])))
        return out
