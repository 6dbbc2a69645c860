"""Striping and redundancy codecs: how an object becomes shards.

Two families of :class:`RedundancyScheme`:

* ``rep`` — ``k``-way striping with ``m`` extra full copies per data
  shard (``n = k * (m + 1)`` shard slots, no codec cost);
* ``ec`` — ``k + m`` systematic erasure coding (``k`` data shards plus
  ``m`` parity shards; encode on PUT, decode only on reconstruction).

The byte layout is the same for both: an object of ``B`` bytes is cut
into ``k`` logical data shards of ``ceil(B / k)`` bytes each (the last
may be short; shards are padded to the uniform size on the wire and on
flash so every service class stays homogeneous).  ``shard_ranges``
partitions ``[0, B)`` — every object byte lives in exactly one data
shard, which the property suite in ``tests/test_cluster.py`` asserts.

Example::

    >>> from repro_torch.cluster import erasure, replication
    >>> ec = erasure(4, 2)
    >>> ec.name, ec.n_shards
    ('ec4+2', 6)
    >>> ec.shard_ranges(10)          # 10 bytes over k=4 data shards
    [(0, 3), (3, 6), (6, 9), (9, 10)]
    >>> rep = replication(2, copies=3)
    >>> rep.name, rep.n_shards       # 2 stripes x 3 copies
    ('rep3-k2', 6)
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class RedundancyScheme:
    """``kind="rep"``: ``m`` extra copies; ``kind="ec"``: ``m`` parity."""

    kind: str        # "rep" | "ec"
    k: int           # stripe width (logical data shards)
    m: int           # redundancy degree (extra copies / parity shards)

    def __post_init__(self):
        if self.kind not in ("rep", "ec"):
            raise ValueError(f"unknown scheme kind {self.kind!r}")
        if self.k < 1:
            raise ValueError("stripe width k must be >= 1")
        if self.m < 0:
            raise ValueError("redundancy m must be >= 0")

    @property
    def n_shards(self) -> int:
        """Physical shard slots per object (placement-map row width)."""
        if self.kind == "rep":
            return self.k * (self.m + 1)
        return self.k + self.m

    @property
    def name(self) -> str:
        if self.kind == "rep":
            return f"rep{self.m + 1}-k{self.k}"
        return f"ec{self.k}+{self.m}"

    # -- byte layout --------------------------------------------------
    def shard_bytes(self, nbytes: int) -> int:
        """Uniform (padded) per-shard size on the wire and on flash."""
        return -(-int(nbytes) // self.k) if nbytes > 0 else 0

    def shard_ranges(self, nbytes: int) -> List[Tuple[int, int]]:
        """Partition of ``[0, nbytes)`` into the k logical data shards
        (half-open byte ranges; tail shards may be empty)."""
        sb = self.shard_bytes(nbytes)
        return [(min(j * sb, nbytes), min((j + 1) * sb, nbytes))
                for j in range(self.k)]

    def shard_of_byte(self, nbytes: int, offset: int) -> int:
        """Logical data shard holding object byte ``offset``."""
        if not 0 <= offset < nbytes:
            raise ValueError(f"offset {offset} outside object [0, {nbytes})")
        return int(offset) // self.shard_bytes(nbytes)

    # -- slot geometry ------------------------------------------------
    # Slot s of the placement row holds: rep -> copy (s % (m+1)) of data
    # shard (s // (m+1)); ec -> data shard s when s < k, else parity.
    def slot_is_data(self, slot: int) -> bool:
        if self.kind == "rep":
            return slot % (self.m + 1) == 0   # canonical (primary) copy
        return slot < self.k

    def copy_slots(self, j: int) -> List[int]:
        """Slots holding (a copy of) logical data shard ``j``."""
        if self.kind == "rep":
            base = j * (self.m + 1)
            return list(range(base, base + self.m + 1))
        return [j]

    # -- request planning ---------------------------------------------
    def write_slots(self, servers, down: Optional[int] = None) -> List[int]:
        """Slots a PUT writes: all of them, minus a down server's
        (degraded writes land on the survivors at reduced durability)."""
        return [s for s in range(self.n_shards)
                if down is None or servers[s] != down]

    def read_slots(self, servers, down: Optional[int] = None
                   ) -> Tuple[List[int], bool]:
        """``(slots, decode)`` a GET reads.

        Normal mode reads the k primary data slots.  Degraded mode
        (server ``down`` holds one of them): ``rep`` fails over to the
        next surviving copy of the affected shard; ``ec`` falls back to
        a conservative full-stripe reconstruction read of every
        surviving slot (k-1 data + m parity) plus a decode — touching
        exactly ``m`` servers beyond the normal-mode set.
        """
        primary = [self.copy_slots(j)[0] for j in range(self.k)]
        if down is None or all(servers[s] != down for s in primary):
            return primary, False
        if self.kind == "rep":
            out = []
            for j in range(self.k):
                alive = [s for s in self.copy_slots(j) if servers[s] != down]
                if not alive:
                    raise ValueError(f"data shard {j} unrecoverable: every "
                                     f"copy lives on down server {down}")
                out.append(alive[0])
            return out, False
        if self.m == 0:
            raise ValueError("ec with m=0 cannot reconstruct a lost shard")
        survivors = [s for s in range(self.n_shards) if servers[s] != down]
        return survivors, True


def parse_scheme(name: str) -> RedundancyScheme:
    """Inverse of :attr:`RedundancyScheme.name`.

    >>> parse_scheme("ec4+2")
    RedundancyScheme(kind='ec', k=4, m=2)
    >>> parse_scheme("rep3-k2").name
    'rep3-k2'
    """
    s = name.strip().lower()
    try:
        if s.startswith("ec"):
            k, m = s[2:].split("+")
            return erasure(int(k), int(m))
        if s.startswith("rep"):
            copies, k = s[3:].split("-k")
            return replication(int(k), copies=int(copies))
    except (ValueError, TypeError):
        pass
    raise ValueError(
        f"unknown scheme {name!r}; expected 'ec<k>+<m>' (e.g. ec4+2) or "
        f"'rep<copies>-k<k>' (e.g. rep3-k2)")


def erasure(k: int, m: int) -> RedundancyScheme:
    """``k`` data + ``m`` parity systematic erasure code."""
    return RedundancyScheme(kind="ec", k=k, m=m)


def replication(k: int, copies: int = 2) -> RedundancyScheme:
    """``k``-way striping, each data shard stored ``copies`` times."""
    if copies < 1:
        raise ValueError("copies must be >= 1")
    return RedundancyScheme(kind="rep", k=k, m=copies - 1)
