"""Quickstart: build a reduced model, run a few train steps, then decode.

The port of ``examples/quickstart.py``: qwen3-4b's smoke config, 20
AdamW steps on the token pipeline, then 8 greedy tokens, printed as the
reference prints them.  The reference's smoke config selects its plain
oracles (``kernel_impl="xla"``); here the config takes
``kernel_impl="auto"``, which on the card runs the hand-written kernels
(RMSNorm and flash attention, forward and backward) and on the CPU the
plain versions, the same arithmetic as ``"xla"``.  Weights are the
port's random init from seed 0 (the reference draws from
``PRNGKey(0)``, so the printed losses and tokens are those of another
init; :func:`run` takes a state, e.g. the reference's carried across
with ``repro_torch.models.train_state_from_reference``).

  PYTHONPATH=src python examples/quickstart_torch.py
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import models as M
from repro_torch.configs import get_smoke_config
from repro_torch.core.torch_device import DEFAULT_DEVICE, resolve_device
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.optim import AdamWConfig
from repro_torch.serve import make_serve_step
from repro_torch.train import TrainState, make_train_step


def config(kernel_impl: str = "auto"):
    """qwen3-4b's smoke config on ``kernel_impl`` (``"auto"``: the
    kernels on the card; ``"xla"``: the plain versions anywhere)."""
    return dataclasses.replace(get_smoke_config("qwen3-4b"),
                               kernel_impl=kernel_impl)


def run(cfg=None, state=None, *, device=DEFAULT_DEVICE) -> dict:
    """Trains 20 steps from ``state`` (default: the port's init from seed
    0 on ``device``) and decodes 8 greedy tokens; prints as the reference
    does and returns ``losses`` (all 20), ``tokens`` ((2, 8) numpy) and
    ``state``."""
    dev = resolve_device(device)
    cfg = config() if cfg is None else cfg
    print(f"model: {cfg.name} ({M.count_params(cfg)/1e6:.2f}M params, "
          f"family={cfg.family})")

    data = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                    global_batch=8))
    if state is None:
        state = TrainState.create(cfg, torch.Generator(dev).manual_seed(0),
                                  device=dev)
    step = make_train_step(cfg, AdamWConfig(lr=3e-3, warmup_steps=10))
    losses = []
    for i in range(20):
        state, metrics = step(state, next(data))
        losses.append(float(metrics["loss"]))
        if i % 5 == 0:
            print(f"step {i}: loss={losses[-1]:.4f}")

    # serve a few greedy tokens
    serve = make_serve_step(cfg)
    cache = M.init_cache(cfg, 2, 64, device=dev)
    tok = torch.tensor([1, 2], dtype=torch.int32, device=dev)
    out = []
    for pos in range(8):
        tok, cache = serve(state.params, cache, tok, pos)
        out.append(tok.cpu().numpy())
    tokens = np.stack(out, 1)
    print("greedy tokens:", tokens)
    return {"losses": losses, "tokens": tokens, "state": state}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="where the model runs (default: the card)")
    args = ap.parse_args(argv)
    return run(device=args.device)


if __name__ == "__main__":
    main()
