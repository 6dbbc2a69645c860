"""Every calibration constant, traceable to a paper anchor.

The paper reports exact numbers for a subset of configurations (those are
used verbatim as anchors) and trends for the rest (those are interpolated,
with the chosen interpolation documented next to each table).  Benchmarks in
``benchmarks/`` re-derive the paper's figures from the model built on these
constants; ``tests/test_paper_claims.py`` asserts the anchors round-trip.

All latencies are in **microseconds** unless suffixed ``_ms``.
"""
from __future__ import annotations

from .spec import KiB, MiB, LBAFormat, OpType, Stack

US_PER_S = 1e6

# ---------------------------------------------------------------------------
# §III-C  (Fig. 2, Fig. 3): QD=1 service latencies, SPDK, 4 KiB LBA format.
#
# Anchors:
#   write  4 KiB SPDK            = 11.36 us   (Obs#2/#4)
#   append 8 KiB SPDK            = 14.02 us   (Obs#4; 23.42% over write)
#   write  85 KIOPS @ 4&8 KiB    -> 11.76 us  (Obs#3; QD1 => svc = 1/IOPS)
#   append 66 KIOPS @ 4 KiB      -> 15.15 us  (Obs#3)
#   append 69 KIOPS @ 8 KiB      -> 14.49 us  (Obs#3; Fig2b reports 14.02)
#   bytes-throughput saturates for >=32 KiB requests (Obs#3/#8, ~1155 MiB/s)
#
# Between anchors we interpolate linearly in request size; beyond the table
# service time grows proportionally to size (bandwidth-limited regime).
# ---------------------------------------------------------------------------

# size_bytes -> service us  (SPDK, LBA_4K)
WRITE_SVC_TABLE_US = {
    4 * KiB: 11.36,
    8 * KiB: 11.76,     # still ~85 KIOPS (Obs#3)
    16 * KiB: 14.20,    # IOPS starts to fall; ~70 KIOPS
    32 * KiB: 27.10,    # 32 KiB / 27.1us = 1.15 GiB/s ~ device limit (Obs#8)
    64 * KiB: 54.20,
    128 * KiB: 108.40,
}
APPEND_SVC_TABLE_US = {
    4 * KiB: 15.15,     # 66 KIOPS (Obs#3)
    8 * KiB: 14.02,     # lowest append latency (Obs#4)
    16 * KiB: 16.80,
    32 * KiB: 29.70,    # converges to bandwidth-limited regime (Obs#8)
    64 * KiB: 56.80,
    128 * KiB: 111.00,
}
# Flash read: paper gives read-only p95 = 81.41 us (Obs#11) and 424 KIOPS at
# QD128 (Obs#7).  Mean flash read svc ~= 70 us with ~30 parallel dies gives
# 30/70us = 428 KIOPS saturation and a QD1 latency consistent with p95.
READ_SVC_TABLE_US = {
    4 * KiB: 70.0,
    8 * KiB: 72.0,
    16 * KiB: 76.0,
    32 * KiB: 84.0,
    64 * KiB: 100.0,
    128 * KiB: 132.0,
}

# Stack overheads added on top of SPDK service time (Obs#2).
STACK_OVERHEAD_US = {
    Stack.SPDK: 0.0,
    Stack.KERNEL_NONE: 1.26,          # 12.62 - 11.36
    Stack.KERNEL_MQ_DEADLINE: 3.11,   # 14.47 - 11.36 (1.85us scheduler + io_uring)
}

# LBA-format penalty multipliers (Obs#1: "sometimes by as much as a factor
# of two").  4 KiB format is the baseline; the 512 B format penalizes small
# requests most (firmware not optimized for small I/O).
LBA512_PENALTY = {
    OpType.WRITE: 1.95,
    OpType.APPEND: 1.60,
    OpType.READ: 1.35,
}

# ---------------------------------------------------------------------------
# §III-D (Fig. 4): concurrency scaling saturation caps (KIOPS for 4 KiB).
#
#   read   424 KIOPS @ QD128 intra-zone (Obs#7)
#   write  293 KIOPS @ QD32 intra-zone with mq-deadline merging (Obs#7)
#   write  186 KIOPS inter-zone via SPDK (no merging; Obs#7)
#   append 132 KIOPS at concurrency 4, intra == inter (Obs#6)
#   4 KiB inter-zone writes peak at 726.74 MiB/s (Obs#8)
# ---------------------------------------------------------------------------
READ_IOPS_CAP = 424_000.0
WRITE_INTRA_MERGED_IOPS_CAP = 293_000.0
WRITE_INTER_IOPS_CAP = 186_000.0
APPEND_IOPS_CAP = 132_000.0

# mq-deadline merging (Obs#7): sequential same-zone writes are merged into
# larger requests; 92.35% of ops merged at QD16.  We model the merge factor
# (requests per merged super-request) as min(max(qd // 2, 1), MERGE_MAX).
MERGE_MAX = 8                      # 8 x 4 KiB = 32 KiB super-writes
MERGE_FRACTION_AT_QD16 = 0.9235    # validation anchor

# ---------------------------------------------------------------------------
# §III-E (Fig. 5): zone-management operation costs.
# ---------------------------------------------------------------------------
OPEN_LAT_US = 9.56        # Obs#9
CLOSE_LAT_US = 11.01      # Obs#9
IMPLICIT_OPEN_FIRST_WRITE_PENALTY_US = 2.02    # Obs#9
IMPLICIT_OPEN_FIRST_APPEND_PENALTY_US = 2.83   # Obs#9

# reset latency vs occupancy (Fig. 5a) — piecewise-linear anchors
# (occupancy fraction -> ms).  0%/50%/100% anchors are from the text;
# intermediate points follow the figure's monotone trend.
RESET_LAT_MS_TABLE = {
    0.0: 0.40,
    0.0005: 0.52,   # "1 page"
    0.0625: 2.10,
    0.125: 3.70,
    0.25: 6.60,
    0.50: 11.60,    # Obs#10 anchor
    1.00: 16.19,    # Obs#10 anchor
}
# Resetting a finished zone is cheaper: 26.58% less at 50% occupancy
# (Obs#10).  Applied as a multiplicative discount.
RESET_FINISHED_DISCOUNT = 1.0 - 0.2658

# finish latency vs occupancy (Fig. 5b).  Physical model: finishing
# programs the *remaining* capacity (or equivalent mapping work), linear in
# (1 - occupancy) — consistent with the reported linearity <0.1%..25% — plus
# a metadata floor.  Anchors: 907.51 ms @ <0.1%, 3.07 ms @ 100% (Obs#10).
FINISH_LAT_FLOOR_MS = 3.07
FINISH_LAT_SPAN_MS = 907.51 - 3.07     # cost of programming a ~empty zone

# ---------------------------------------------------------------------------
# §III-F (Fig. 6): interference & the conventional-SSD GC baseline.
# ---------------------------------------------------------------------------
PEAK_WRITE_BW_MIBS = 1155.0           # measured peak (both devices)
ZNS_READ_P95_UNDER_WRITES_MS = 98.04  # Obs#11 anchor
CONV_READ_P95_UNDER_WRITES_MS = 299.89
READONLY_READ_P95_US = 81.41

# Conventional GC model: above the dirty-block knee, the FTL steals write
# bandwidth in bursts, producing Fig. 6a's sawtooth between ~0 and peak.
CONV_GC_PERIOD_S = 18.0       # sawtooth period at full-rate writes
CONV_GC_DUTY = 0.45           # fraction of the period spent in deep GC
CONV_GC_FLOOR_MIBS = 40.0     # throughput floor during GC stalls

# ---------------------------------------------------------------------------
# §III-G (Fig. 7): reset-interference coupling.
#
# p95 reset latency of full zones: 17.94 ms isolated; inflated by concurrent
# I/O (Obs#13), while resets leave I/O unaffected (Obs#12).
# ---------------------------------------------------------------------------
RESET_P95_ISOLATED_MS = 17.94
RESET_INFLATION = {
    OpType.READ: 1.5611,     # -> 28.00 ms
    OpType.WRITE: 1.7842,    # -> 32.00 ms
    OpType.APPEND: 1.7550,   # -> 31.48 ms
}

# Lognormal-ish tail shape used to turn mean latencies into distributions;
# sigma chosen so mean->p95 matches the reset anchors (16.19 mean, 17.94 p95).
RESET_TAIL_SIGMA = 0.0623


def interp_table(table: dict, x: float) -> float:
    """Piecewise-linear interpolation with proportional extrapolation."""
    keys = sorted(table)
    if x <= keys[0]:
        return table[keys[0]]
    if x >= keys[-1]:
        # bandwidth-limited regime: scale the last point proportionally
        return table[keys[-1]] * (x / keys[-1])
    for lo, hi in zip(keys, keys[1:]):
        if lo <= x <= hi:
            f = (x - lo) / (hi - lo)
            return table[lo] * (1 - f) + table[hi] * f
    raise AssertionError


def interp_table_clamped(table: dict, x: float) -> float:
    """Piecewise-linear interpolation, clamped at both ends (no extrapolation)."""
    keys = sorted(table)
    if x <= keys[0]:
        return table[keys[0]]
    if x >= keys[-1]:
        return table[keys[-1]]
    return interp_table(table, x)
