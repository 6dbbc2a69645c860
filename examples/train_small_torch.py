"""End-to-end driver: train a ~100M-param llama-family model for a few
hundred steps with ZNS checkpointing, then kill/restore to prove
fault-tolerant resume.

The port of ``examples/train_small.py``, with the same flags and lines.
The default (fast) trims width so the CPU finishes in minutes; pass
--full-100m for the full ~100M variant.  The config takes
``kernel_impl="auto"`` where the reference's says ``"xla"``: on the card
every RMSNorm and attention, forward and backward, is a hand-written
kernel, and on the CPU the plain versions run, the same arithmetic as
``"xla"``.  The checkpoint is saved through the ZNS store: its modeled
device time is one launch of the batched ``zns_event_scan`` kernel a
save on the card.  Weights are the port's random init from seed 0 (the
reference draws from ``PRNGKey(0)``); :func:`run` takes a state, e.g.
the reference's carried across with
``repro_torch.models.train_state_from_reference``.  The process exits
with 1 unless the loss improves, as the reference's does.

  PYTHONPATH=src python examples/train_small_torch.py
  PYTHONPATH=src python examples/train_small_torch.py --device cpu
  PYTHONPATH=src python examples/train_small_torch.py --full-100m
"""
import argparse
import dataclasses
import shutil
import sys
import tempfile

import numpy as np
import torch

from repro_torch import models as M
from repro_torch.configs import get_config
from repro_torch.core.torch_device import DEFAULT_DEVICE, resolve_device
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import ZonedCheckpointStore
from repro_torch.train import TrainState, make_train_step


def model_config(full_100m: bool):
    base = get_config("tinyllama-1.1b", kernel_impl="auto")
    if full_100m:
        # ~100M params: 12L x 768 with a 16k vocab
        return dataclasses.replace(
            base, num_layers=12, d_model=768, num_heads=12, num_kv_heads=4,
            head_dim=64, d_ff=2048, vocab_size=16384)
    return dataclasses.replace(
        base, num_layers=4, d_model=256, num_heads=8, num_kv_heads=4,
        head_dim=32, d_ff=688, vocab_size=2048)


def run(cfg, state=None, *, steps: int = 300, device=DEFAULT_DEVICE) -> dict:
    """Trains ``steps`` steps from ``state`` (default: the port's init from
    seed 0), checkpointing and restoring at half; prints as the reference
    does and returns ``losses``, ``first``, ``last``, ``improved``,
    ``saved`` (the store's save result), ``restored_step`` and ``state``."""
    dev = resolve_device(device)
    print(f"params: {M.count_params(cfg)/1e6:.1f}M")
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=128, global_batch=8)
    opt = AdamWConfig(lr=3e-3, warmup_steps=30, total_steps=steps)
    ckpt_dir = tempfile.mkdtemp(prefix="zns_ckpt_")
    store = ZonedCheckpointStore(ckpt_dir, n_hosts=2, device=dev)

    data = TokenPipeline(dcfg)
    if state is None:
        state = TrainState.create(cfg, torch.Generator(dev).manual_seed(0),
                                  device=dev)
    step = make_train_step(cfg, opt)

    half = steps // 2
    losses = []
    for i in range(half):
        state, metrics = step(state, next(data))
        losses.append(float(metrics["loss"]))
        if i % 25 == 0:
            print(f"step {i}: loss={losses[-1]:.4f}")
    out = store.save(half, state.tree(),
                     extra_meta={"data": data.state_dict()})
    print(f"checkpoint@{half}: modeled ZNS wall {out['wall_seconds']:.2f}s, "
          f"host bw {out['reports'][0].bandwidth_mibs:.0f} MiB/s")

    # --- simulate a crash: rebuild everything from the store ------------
    del state, data
    fresh = TrainState.create(cfg, torch.Generator(dev).manual_seed(123),
                              device=dev)
    restored, manifest = store.restore(half, fresh.tree())
    state = fresh.load(restored)
    data = TokenPipeline(dcfg)
    data.load_state_dict(manifest["meta"]["data"])
    restored_step = state.step
    print(f"restored at step {restored_step}; resuming")

    for i in range(half, steps):
        state, metrics = step(state, next(data))
        losses.append(float(metrics["loss"]))
        if i % 25 == 0:
            print(f"step {i}: loss={losses[-1]:.4f}")
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    print(f"loss: {first:.4f} -> {last:.4f} "
          f"({'OK' if last < first else 'NO IMPROVEMENT'})")
    shutil.rmtree(ckpt_dir)
    return {"losses": losses, "first": float(first), "last": float(last),
            "improved": bool(last < first), "saved": out,
            "restored_step": restored_step, "state": state}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full-100m", action="store_true")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="where the model trains (default: the card)")
    args = ap.parse_args(argv)
    return run(model_config(args.full_100m), steps=args.steps,
               device=args.device)


if __name__ == "__main__":
    sys.exit(0 if main()["improved"] else 1)
