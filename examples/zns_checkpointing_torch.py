"""The paper's technique in action: checkpoint-policy comparison on the
calibrated ZN540 model + conventional-SSD contrast (Obs#11).

The port of ``examples/zns_checkpointing.py``: the same policies, lines
and numbers.  Each policy's payload write is modeled by one launch of
the ``zns_event_scan`` kernel on the card (``--device cpu``: its plain
version on the CPU); the reclaim row and the write-pressure scenarios
are host numpy, as in the reference.

  PYTHONPATH=src python examples/zns_checkpointing_torch.py
  PYTHONPATH=src python examples/zns_checkpointing_torch.py --device cpu
"""
import argparse

from repro_torch.core import MiB, ConvDevice, ZnsDevice
from repro_torch.core.calibration import PEAK_WRITE_BW_MIBS
from repro_torch.core.torch_device import DEFAULT_DEVICE, resolve_device
from repro_torch.runtime.zns_store import ZnsHostDevice

SHARD = 4 * 1024 * MiB      # 4 GiB per-host checkpoint shard

POLICIES = {
    "R2: 1MiB appends @QD4 (paper)": dict(stripe_bytes=1 * MiB,
                                          append_qd=4),
    "4KiB appends @QD1 (naive)": dict(stripe_bytes=4 * 1024, append_qd=1),
    "64KiB appends @QD4": dict(stripe_bytes=64 * 1024, append_qd=4),
    "4MiB appends @QD4 (tuned)": dict(stripe_bytes=4 * MiB, append_qd=4),
}


def run(*, device=DEFAULT_DEVICE) -> dict:
    """Prints the reference's report; returns its numbers unrounded:
    ``policies`` (name -> (modeled seconds, appends)), ``gc_s``,
    ``fill_s``, ``zones_reset`` and the two pressure results."""
    device = resolve_device(device)
    out = {"policies": {}}
    print("== ZNS checkpoint write policies (per-host, 4 GiB shard) ==")
    for name, kw in POLICIES.items():
        dev = ZnsHostDevice(0, device=device, **kw)
        t, n = dev.simulate_payload_write(SHARD)
        out["policies"][name] = (t, n)
        print(f"  {name:38s} wall={t:6.2f}s  bw={SHARD/t/MiB:7.0f} MiB/s "
              f"({n} appends)")

    print("\n== reclaim (reset) vs refill cost — R5 ==")
    dev = ZnsHostDevice(0, device=device)
    entries = dev.plan(SHARD)
    dev.apply_writes(entries)
    full = [e.zone for e in entries if dev.zm.state(e.zone).name == "FULL"]
    dev.schedule_reset(full)
    gc_s = dev.run_gc(concurrent_io=True)
    fill_s = SHARD / (PEAK_WRITE_BW_MIBS * MiB)
    out.update(gc_s=gc_s, fill_s=fill_s, zones_reset=len(full))
    print(f"  reset {len(full)} zones under I/O: {gc_s*1e3:.1f} ms "
          f"(~{gc_s/fill_s*100:.1f}% of fill time; paper says ~1%)")

    print("\n== why not a conventional SSD? (Obs#11) ==")
    conv = ConvDevice().run_write_pressure(rate_mibs=PEAK_WRITE_BW_MIBS,
                                           duration_s=60)
    zns = ZnsDevice(device=device).run_write_pressure(
        rate_mibs=PEAK_WRITE_BW_MIBS, duration_s=60)
    out.update(conv=conv, zns=zns)
    print(f"  write-throughput CV:  conv={conv.write_cv:.2f}"
          f"  zns={zns.write_cv:.2f}")
    print(f"  read p95 under writes: conv={conv.read_lat_p95_us/1e3:.0f} ms"
          f"  zns={zns.read_lat_p95_us/1e3:.0f} ms")
    print("  -> training-data reads next to checkpoint writes need ZNS-class"
          " isolation")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="where the payload scans run (default: the card)")
    args = ap.parse_args(argv)
    return run(device=args.device)


if __name__ == "__main__":
    main()
