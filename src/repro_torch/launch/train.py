"""Training driver, on one card by default.

The port of ``repro.launch.train``, with the same flags plus
``--device`` and ``--init-std``: the data pipeline, AdamW, the
rematerialised train step,
the ZNS checkpoint store (the paper's technique; on a card each save's
modeled device time is one launch of the batched max-plus scan kernel)
and restart from the latest checkpoint.  ``--smoke`` takes the arch's
reduced config; ``--d-model`` (with ``--d-ff`` and ``--layers``) cuts a
full config to another width or depth.  ``--init-std S`` draws every
weight matrix from N(0, S) (0.02 is the llama family's published
``initializer_range``) instead of the reference's fan-in rule, which
takes the heads axis as the fan-in of a (D, H, Dh) projection: at full
depth that init's gradients grow about 5x a layer (a norm of ~1e16 at
tinyllama's 22 layers), and clipping them to 1.0 leaves every other
gradient below AdamW's eps.  Every arch trains on the card with the
defaults, on the kernels' backward: ``--arch mamba2-370m`` (the SSD
scan's backward kernels) and ``--arch recurrentgemma-9b`` (the linear
recurrence's, and attention's at D 256 with the window) too.

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --smoke --steps 200 --ckpt-dir /tmp/ckpt --ckpt-every 50
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --steps 20
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import models as M
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.torch_device import DEFAULT_DEVICE, resolve_device
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import RestartBudget, ZonedCheckpointStore
from repro_torch.train import TrainState, make_train_step


def build(args):
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    if args.d_model:
        cfg = dataclasses.replace(
            cfg, d_model=args.d_model, d_ff=args.d_ff or args.d_model * 3,
            num_layers=args.layers or cfg.num_layers,
            head_dim=args.d_model // cfg.num_heads)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                      global_batch=args.batch,
                      num_codebooks=cfg.num_codebooks)
    opt = AdamWConfig(lr=args.lr, warmup_steps=args.warmup,
                      total_steps=args.steps)
    return cfg, dcfg, opt


def main(argv=None) -> dict:
    """Runs the driver; returns ``{"state", "losses", "grad_norms",
    "steps", "seconds"}`` (``steps``: those run here, after any
    restore)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--d-ff", type=int, default=0)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    ap.add_argument("--init-std", type=float, default=0.0,
                    help="every weight matrix N(0, std); 0: the "
                         "reference's fan-in rule")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg, dcfg, opt = build(args)
    n = M.count_params(cfg)
    print(f"[train] arch={cfg.name} params={n/1e6:.1f}M "
          f"tokens/step={dcfg.seq_len * dcfg.global_batch}")

    data = TokenPipeline(dcfg)
    state = TrainState.create(cfg, torch.Generator(dev).manual_seed(args.seed),
                              device=dev, weight_std=args.init_std or None)
    step_fn = make_train_step(cfg, opt, microbatches=args.microbatches)
    store = None
    if args.ckpt_dir:
        store = ZonedCheckpointStore(args.ckpt_dir, n_hosts=1, device=dev)
        latest = store.latest_step()
        if latest is not None:
            restored, manifest = store.restore(latest, state.tree())
            state.load(restored)
            data.load_state_dict(manifest["meta"]["data"])
            print(f"[train] restored step {latest} "
                  f"(modeled ckpt wall {manifest['modeled_wall_seconds']:.2f}s)")

    budget = RestartBudget()      # noqa: F841 (the reference's policy)
    t0 = t_start = time.time()
    losses, grad_norms = [], []
    start_step = state.step
    for i in range(start_step, args.steps):
        state, metrics = step_fn(state, next(data))
        losses.append(float(metrics["loss"]))
        grad_norms.append(float(metrics["grad_norm"]))
        if (i + 1) % args.log_every == 0:
            tps = dcfg.seq_len * dcfg.global_batch * args.log_every \
                / (time.time() - t0)
            t0 = time.time()
            print(f"[train] step {i+1} loss={losses[-1]:.4f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"gnorm={float(metrics['grad_norm']):.2f} tok/s={tps:.0f}")
        if store and (i + 1) % args.ckpt_every == 0:
            out = store.save(i + 1, state.tree(),
                             extra_meta={"data": data.state_dict()})
            store.gc(keep_last=2)
            print(f"[train] ckpt@{i+1} modeled_wall={out['wall_seconds']:.2f}s"
                  f" (zns append path)")
    seconds = time.time() - t_start
    if losses:
        print(f"[train] done: first-5 loss {np.mean(losses[:5]):.4f} -> "
              f"last-5 {np.mean(losses[-5:]):.4f}")
    return {"state": state, "losses": losses, "grad_norms": grad_norms,
            "steps": len(losses), "seconds": seconds}


if __name__ == "__main__":
    main()
