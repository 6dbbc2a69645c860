"""Collective-traffic accounting: the counterpart of ``repro.utils.hlo``.

The reference reads every collective instruction, with its result shape,
out of XLA's compiled HLO (``collective_stats(hlo_text)``).  torch has no
compiled program to read, so here the port's own collective layer
reports each collective as it runs: :mod:`repro_torch.distributed.comm`
(``ppermute``, ``psum`` / ``pmean`` / ``pmax``, ``all_to_all``) and
:func:`repro_torch.distributed.mesh.all_gather_dim` /
:func:`~repro_torch.distributed.mesh.all_reduce`, through which every
collective of the port passes.  :func:`record_collectives` is a context
manager; outside one nothing is recorded.  The active recorder is held
by the module, not by a context variable: the autograd engine runs a CUDA
tensor's backward on a device thread of its own, which starts with an
empty Python context, and the backward's collectives must count too.

Each collective counts as its semantic kind, not its transport:
``comm.ppermute`` runs as one ``all_to_all_single`` but counts as a
collective-permute.  Result bytes are those of XLA's result shape (the
gathered tensor for an all-gather, the operand for the other kinds) and
wire bytes use the reference's ring factors:

* all-gather:          wire ~ result
* all-reduce:          wire ~ 2 x result
* reduce-scatter:      wire ~ n x result (n the group size)
* all-to-all:          wire ~ result
* collective-permute:  wire ~ result

Each record also carries its *site*: ``"body"`` for a collective of a
``shard_map`` body, ``"boundary"`` for the all-gathers and all-reduces
at :func:`~repro_torch.distributed.mesh.shard_map`'s boundary, which
exist because every rank holds the global tensors (an XLA program keeps
its arrays sharded there and has no such collective), ``"state"``
for those of a rank-local train state
(:mod:`repro_torch.distributed.rank_local`: a weight's all-gathers where
the step reads it, and the gradient norm's all-reduce), which GSPMD
inserts into an XLA program of sharded state, ``"grad"`` for the
gradient's sums over the batch axes where a rank computes only its rows
of the batch (a gathered weight's reduce-scatter or all-reduce in the
backward, a whole leaf's all-reduce after it), and ``"rows"`` for the
other collectives that cutting the rows brings (the step's metrics
averaged over the batch axes, the MoE routing's counts and load sums
over the global batch, the decode's softmax combined over the cache's
blocks of slots, the next tokens gathered back to the global batch).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
SITES = ("body", "boundary", "state", "grad", "rows", "tp")

_WIRE_FACTOR = {
    "all-gather": 1.0,
    "all-reduce": 2.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


@dataclasses.dataclass
class CollectiveStats:
    count: dict
    result_bytes: dict
    wire_bytes: dict

    @property
    def total_result_bytes(self) -> float:
        return float(sum(self.result_bytes.values()))

    @property
    def total_wire_bytes(self) -> float:
        return float(sum(self.wire_bytes.values()))

    def as_dict(self) -> dict:
        return {"count": self.count, "result_bytes": self.result_bytes,
                "wire_bytes": self.wire_bytes,
                "total_result_bytes": self.total_result_bytes,
                "total_wire_bytes": self.total_wire_bytes}


class CollectiveRecorder:
    """The collectives run inside one :func:`record_collectives`."""

    def __init__(self):
        self.records: list = []     # (kind, result bytes, group size, site)

    def note(self, kind: str, result_bytes: int, group_size: int,
             site: str) -> None:
        if kind not in COLLECTIVES or site not in SITES:
            raise ValueError(f"collective {kind!r} at site {site!r}")
        self.records.append((kind, int(result_bytes), int(group_size), site))

    def stats(self, site: Optional[str] = None) -> CollectiveStats:
        """The records (of one site, or all) as the reference's
        :class:`CollectiveStats`."""
        count = {k: 0 for k in COLLECTIVES}
        rbytes = {k: 0.0 for k in COLLECTIVES}
        wbytes = {k: 0.0 for k in COLLECTIVES}
        for kind, nbytes, gsize, where in self.records:
            if site is not None and where != site:
                continue
            count[kind] += 1
            rbytes[kind] += nbytes
            if kind == "reduce-scatter":
                wbytes[kind] += nbytes * gsize
            else:
                wbytes[kind] += nbytes * _WIRE_FACTOR[kind]
        return CollectiveStats(count, rbytes, wbytes)


#: the recorders entered and not yet left, innermost last; every thread
#: records to the innermost
_ACTIVE: list = []
_LOCK = threading.Lock()


@contextlib.contextmanager
def record_collectives():
    """Record every collective of the port run inside the block, on any
    thread; yields the :class:`CollectiveRecorder`."""
    rec = CollectiveRecorder()
    with _LOCK:
        _ACTIVE.append(rec)
    try:
        yield rec
    finally:
        with _LOCK:
            _ACTIVE.remove(rec)


def note(kind: str, result_bytes: int, group_size: int,
         site: str = "body") -> None:
    """Called by the collective layer for each collective it runs; a
    no-op outside :func:`record_collectives`."""
    with _LOCK:
        if _ACTIVE:
            _ACTIVE[-1].note(kind, result_bytes, group_size, site)
