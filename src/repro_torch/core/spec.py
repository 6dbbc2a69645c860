"""Device geometry and operation vocabulary for the ZNS device model.

Mirrors the benchmarking environment of the paper (Tab. II): a Western
Digital Ultrastar DC ZN540 1TB large-zone ZNS SSD, plus the conventional
Ultrastar DC SN640 used as the §III-F comparison baseline.
"""
from __future__ import annotations

import dataclasses
import enum

KiB = 1024
MiB = 1024 * KiB
GiB = 1024 * MiB


class OpType(enum.IntEnum):
    """I/O and zone-management operations (§II-B)."""

    READ = 0
    WRITE = 1
    APPEND = 2
    RESET = 3
    FINISH = 4
    OPEN = 5
    CLOSE = 6


#: Operations that move a zone's write pointer.
WRITE_LIKE = (OpType.WRITE, OpType.APPEND)
#: Zone-management operations (no data transfer).
MGMT_OPS = (OpType.RESET, OpType.FINISH, OpType.OPEN, OpType.CLOSE)


class Stack(enum.IntEnum):
    """Host storage stacks benchmarked in the paper (§III-A)."""

    SPDK = 0
    KERNEL_NONE = 1          # io_uring, scheduler = none
    KERNEL_MQ_DEADLINE = 2   # io_uring, scheduler = mq-deadline


class LBAFormat(enum.IntEnum):
    """NVMe namespace LBA formats evaluated in Fig. 2a."""

    LBA_512 = 0
    LBA_4K = 1

    @property
    def block_bytes(self) -> int:
        return 512 if self is LBAFormat.LBA_512 else 4 * KiB


class ZoneState(enum.IntEnum):
    """Zone state machine states (Fig. 1)."""

    EMPTY = 0
    IMPLICIT_OPEN = 1
    EXPLICIT_OPEN = 2
    CLOSED = 3
    FULL = 4
    READ_ONLY = 5
    OFFLINE = 6


OPEN_STATES = (ZoneState.IMPLICIT_OPEN, ZoneState.EXPLICIT_OPEN)
ACTIVE_STATES = OPEN_STATES + (ZoneState.CLOSED,)


@dataclasses.dataclass(frozen=True)
class ZNSDeviceSpec:
    """Geometry + structural limits of a ZNS device.

    Defaults are the ZN540 exactly as reported in Tab. II.
    """

    name: str = "WD-Ultrastar-DC-ZN540"
    zone_size_bytes: int = 2048 * MiB       # LBA-address span of a zone
    zone_cap_bytes: int = 1077 * MiB        # writable capacity of a zone
    num_zones: int = 904
    max_open_zones: int = 14
    max_active_zones: int = 14
    lba_format: LBAFormat = LBAFormat.LBA_4K
    # Device-level limits observed in §III-C/D.
    peak_write_bw_bytes: float = 1155 * MiB          # Fig. 4c plateau
    peak_read_bw_bytes: float = 1740 * MiB           # 424 KIOPS x 4 KiB
    # Internal parallel units ("channels") implied by the scaling curves.
    append_parallelism: int = 2    # Obs#6: append saturates at 132 KIOPS (2 x 66)
    write_parallelism: int = 14    # inter-zone writes scale to ~max open zones
    read_parallelism: int = 30     # 424 KIOPS @ ~70 us/req flash read latency
    reset_parallelism: int = 1     # resets are serialized metadata updates

    @property
    def capacity_bytes(self) -> int:
        return self.zone_cap_bytes * self.num_zones

    def zone_of(self, lba_bytes: int) -> int:
        return lba_bytes // self.zone_size_bytes

    def zone_start(self, zone: int) -> int:
        return zone * self.zone_size_bytes


@dataclasses.dataclass(frozen=True)
class ConvDeviceSpec:
    """Conventional (non-zoned) NVMe SSD — the §III-F baseline (SN640)."""

    name: str = "WD-Ultrastar-DC-SN640"
    capacity_bytes: int = 960 * 10**9
    peak_write_bw_bytes: float = 1155 * MiB   # paper matches peaks for both
    peak_read_bw_bytes: float = 1740 * MiB
    overprovision_frac: float = 0.07
    gc_write_amp_knee: float = 0.60           # utilization where GC starts biting
    read_parallelism: int = 30
    write_parallelism: int = 14


def spec_from_dict(d) -> ZNSDeviceSpec:
    """Build a :class:`ZNSDeviceSpec` from a ``{field: value}`` mapping
    (e.g. ``dataclasses.asdict`` of an equivalent spec record); enum
    fields are converted by value."""
    names = {f.name for f in dataclasses.fields(ZNSDeviceSpec)}
    if set(d) != names:
        raise ValueError(f"spec fields: missing {sorted(names - set(d))}, "
                         f"unexpected {sorted(set(d) - names)}")
    kw = dict(d)
    kw["lba_format"] = LBAFormat(int(kw["lba_format"]))
    return ZNSDeviceSpec(**kw)


ZN540 = ZNSDeviceSpec()
SN640 = ConvDeviceSpec()
