"""Storage server: NIC/CPU stages + writeback buffer over one volume.

A :class:`StorageServer` owns the per-server state the cluster compiler
and the event-engine oracle both consume:

* **shard log** — inserts append shard payloads to a per-server byte
  log (``cum`` bytes); each shard's ``[lo, hi)`` range is remembered so
  GETs and durability gates can find the flush that covers it;
* **writeback buffer** — ``writeback_bytes`` of staging RAM.  The
  flusher writes the log to flash in ``flush_chunk`` units (a
  sequential log: flushes retire in log order, ``flush_qd`` deep);
  an insert that would overflow the buffer stalls until enough chunks
  flushed (:meth:`room_gate`);
* **device** — flush chunks land in the server's
  :class:`repro_torch.host.LogStructuredVolume` (zone allocation, open-zone
  limits and capacity enforced live by the host layer); service times
  come from the volume device's calibrated latency model, jitter-free.

The server never schedules anything itself — it answers the structural
questions ("which flush covers byte ``hi``?", "how many chunks must
drain before this insert fits?") from which the compiler builds chain
families and the oracle builds DAG edges.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import OpType, Trace, compute_service_times
from repro_torch.core.torch_device import DEFAULT_DEVICE
from repro_torch.host import LogStructuredVolume

from .spec import ClusterSpec


class StorageServer:
    """Per-server shard log + writeback-buffer geometry + device leaf."""

    def __init__(self, sid: int, spec: ClusterSpec, *,
                 device=DEFAULT_DEVICE):
        # ``device``: where the volume's own device session would solve
        # (the cluster compiler reads only its zone state and latency
        # model; the cluster's solves take their device separately)
        self.sid = sid
        self.spec = spec
        self.volume = LogStructuredVolume(
            spec.device_spec, device=device, policy="greedy-open",
            stripe_bytes=spec.server.flush_chunk,
            append_qd=spec.server.flush_qd)
        self.cum = 0                              # bytes inserted so far
        self.inserts: List[int] = []              # cum_after per insert
        self._ranges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        self.n_flush = 0
        self._svc_cache: Dict[Tuple[int, int], float] = {}

    # -- shard log -----------------------------------------------------------
    def insert_shard(self, obj: int, slot: int, nbytes: int
                     ) -> Tuple[int, int]:
        """Append a shard to the log; returns its ``[lo, hi)`` range."""
        lo, hi = self.cum, self.cum + int(nbytes)
        self.cum = hi
        self.inserts.append(hi)
        self._ranges[(obj, slot)] = (lo, hi)
        return lo, hi

    def shard_range(self, obj: int, slot: int) -> Tuple[int, int]:
        return self._ranges[(obj, slot)]

    # -- writeback geometry --------------------------------------------------
    @property
    def chunk(self) -> int:
        return self.spec.server.flush_chunk

    def covering_flush(self, hi: int) -> Optional[int]:
        """Flush index whose completion puts log bytes ``[0, hi)`` on
        flash (``None`` for empty ranges)."""
        return (hi - 1) // self.chunk if hi > 0 else None

    def room_gate(self, cum_after: int) -> Optional[int]:
        """Flush that must complete before the insert ending at
        ``cum_after`` fits in the buffer (``None``: fits immediately)."""
        over = cum_after - self.spec.server.writeback_bytes
        if over <= 0:
            return None
        return -(-over // self.chunk) - 1

    def data_gate_inserts(self) -> np.ndarray:
        """Per flush ``f``: index of the insert whose completion makes
        chunk ``f`` flushable.

        Writeback mode flushes full chunks: the gate is the first
        insert reaching ``min((f+1)*chunk, total)``.  Write-through
        mode force-flushes partials — every insert demands durability,
        so chunk ``f`` is flushable once its *first* byte lands (the
        first insert past ``f*chunk``); this is also what keeps the
        durability ack of an insert from waiting on a later op's bytes
        (which the closed loop may be holding back — a deadlock)."""
        if self.n_flush == 0:
            return np.zeros(0, dtype=np.int64)
        cum = np.asarray(self.inserts, dtype=np.int64)
        f = np.arange(self.n_flush)
        if self.spec.durability == "write-through":
            return np.searchsorted(cum, f * self.chunk, side="right")
        ends = np.minimum((f + 1) * self.chunk, self.cum)
        return np.searchsorted(cum, ends, side="left")

    def chunk_filled(self, hi: int) -> bool:
        """True when the chunk covering log byte ``hi - 1`` is already
        flushable given the inserts *so far* — i.e., a read of that
        byte can be served from flash; otherwise the bytes are still
        writeback-buffer-resident and a read is served from RAM."""
        g = self.covering_flush(hi)
        if g is None:
            return False
        if self.spec.durability == "write-through":
            return self.cum > g * self.chunk
        return self.cum >= (g + 1) * self.chunk

    def finalize(self) -> int:
        """Close the log: fix the flush count and land every chunk in
        the volume (allocator/zone state advances; chunks are padded to
        uniform ``flush_chunk`` so the append pool stays single-class).
        Returns the flush count."""
        self.n_flush = -(-self.cum // self.chunk) if self.cum > 0 else 0
        for f in range(self.n_flush):
            self.volume.write(f"wb-{self.sid}-{f}", self.chunk, stream=0)
        return self.n_flush

    # -- device service times ------------------------------------------------
    def _svc(self, op: OpType, nbytes: int) -> float:
        key = (int(op), int(nbytes))
        if key not in self._svc_cache:
            tr = Trace.build(op=[int(op)], zone=[0], size=[int(nbytes)],
                             issue=[0.0])
            self._svc_cache[key] = float(compute_service_times(
                tr, self.volume.device.lat, jitter=False)[0])
        return self._svc_cache[key]

    def append_svc(self) -> float:
        """Jitter-free device service time of one flush-chunk append."""
        return self._svc(OpType.APPEND, self.chunk)

    def read_svc(self, nbytes: int) -> float:
        """Jitter-free device service time of one shard read."""
        return self._svc(OpType.READ, nbytes)

    def __repr__(self) -> str:
        return (f"StorageServer(sid={self.sid}, cum={self.cum}, "
                f"flushes={self.n_flush})")
