"""Checkpoint-engine hillclimb: hypothesis -> change -> measure -> validate.

The port of ``scripts/zns_hillclimb.py``: the same scenario, rows and
numbers.  Scenario: a 405B-class TrainState (bf16 params + f32 moments
~ 4 TB) checkpointed from 512 hosts, 7.9 GiB/host, each host owning one
ZN540.  The metric is the end-to-end checkpoint *cycle*: payload write +
commit + zone reclaim, with the fleet wall time = straggler (p-max over
hosts).  Each row's payload write is one launch of the
``zns_event_scan`` kernel on the card (``--device cpu``: its plain
version on the CPU); the latency model and the fleet's jitter are host
numpy.

Host-time jitter: hosts see +/- lognormal service variation (fio-style
run-to-run sigma ~6%, paper Tab. II methodology: 3 repeats) plus a 2%
chance of a 2-4x degraded device (aging / thermal).

  PYTHONPATH=src python scripts/zns_hillclimb_torch.py [--device cpu]
"""
import sys, os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import argparse

import numpy as np

from repro_torch.core import KiB, MiB, GiB, OpType
from repro_torch.core.torch_device import DEFAULT_DEVICE, resolve_device
from repro_torch.runtime.zns_store import ZnsHostDevice

N_HOSTS = 512
SHARD = int(7.9 * GiB)
NAIVE = "naive: 4KiB appends QD1, serial GC, no redundancy"

#: The rows: (name, cycle's keywords).
ROWS = (
    (NAIVE, dict(stripe=4 * KiB, qd=1, zones=1, redundancy=False,
                 concurrent_gc=False)),
    ("paper R1-R5: 1MiB QD4, concurrent GC",
     dict(stripe=1 * MiB, qd=4, zones=1, redundancy=False,
          concurrent_gc=True)),
    ("+ straggler mitigation (backup writes)",
     dict(stripe=1 * MiB, qd=4, zones=1, redundancy=True,
          concurrent_gc=True)),
    ("+ 4MiB stripes (fewer requests)",
     dict(stripe=4 * MiB, qd=4, zones=1, redundancy=True,
          concurrent_gc=True)),
    ("ablate: manifest via append (violates R1)",
     dict(stripe=4 * MiB, qd=4, zones=1, redundancy=True,
          concurrent_gc=True, manifest_op=OpType.APPEND)),
    ("ablate: serial GC (ignores Obs#12)",
     dict(stripe=4 * MiB, qd=4, zones=1, redundancy=True,
          concurrent_gc=False)),
)


def fleet_wall(per_host_s: float, *, redundancy: bool, straggler_factor=1.5,
               n=N_HOSTS, seed=0):
    rng = np.random.default_rng(seed)
    jitter = np.exp(0.06 * rng.standard_normal(n))
    degraded = rng.uniform(size=n) < 0.02
    times = per_host_s * jitter * np.where(degraded,
                                           rng.uniform(2, 4, n), 1.0)
    if redundancy:
        med = np.median(times)
        # backup write kicks in at deadline; backup host re-writes the
        # shard at full speed -> capped at deadline + median
        dl = med * straggler_factor
        times = np.where(times > dl, dl + med, times)
    return float(np.max(times)), float(np.median(times))


def cycle(name, *, stripe, qd, zones, redundancy, concurrent_gc,
          manifest_op=OpType.WRITE, device=DEFAULT_DEVICE) -> dict:
    """One row: prints it; returns its numbers unrounded."""
    dev = ZnsHostDevice(0, stripe_bytes=stripe, append_qd=qd,
                        concurrent_zones=zones, device=device)
    zns = dev.device            # the ZnsDevice session handle
    write_s, n_req = dev.simulate_payload_write(SHARD)
    man_us = float(zns.io_latency_us(manifest_op, 4 * KiB))
    # reclaim: the zones of the previous checkpoint of equal size
    n_zones = int(np.ceil(SHARD / zns.spec.zone_cap_bytes))
    occ = 1.0
    reset_us = float(np.asarray(zns.reset_latency_us(occ)).mean()) * n_zones
    if concurrent_gc:
        reset_us *= zns.lat.reset_inflation([OpType.APPEND])
        host_s = max(write_s, reset_us / 1e6) + man_us / 1e6
    else:
        host_s = write_s + reset_us / 1e6 + man_us / 1e6
    wall, med = fleet_wall(host_s, redundancy=redundancy)
    bw = SHARD / write_s / MiB
    print(f"{name:52s} host={host_s:6.2f}s wall_p100={wall:6.2f}s "
          f"med={med:6.2f}s bw={bw:5.0f}MiB/s req={n_req}")
    return {"host_s": host_s, "wall": wall, "med": med, "bw": bw,
            "req": n_req}


def run(*, device=DEFAULT_DEVICE) -> dict:
    """Prints the reference's table; returns ``rows`` (name -> cycle's
    numbers), ``base`` and ``best``."""
    device = resolve_device(device)
    print(f"fleet: {N_HOSTS} hosts x {SHARD/GiB:.1f} GiB shards "
          f"(405B-class state)\n")
    rows = {name: cycle(name, device=device, **kw) for name, kw in ROWS}
    base = rows[NAIVE]["wall"]
    best = min(r["wall"] for r in rows.values())
    print(f"\nnaive -> best: {base:.2f}s -> {best:.2f}s "
          f"({base/best:.1f}x)")
    return {"rows": rows, "base": base, "best": best}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="where the payload scans run (default: the card)")
    args = ap.parse_args(argv)
    return run(device=args.device)


if __name__ == "__main__":
    main()
