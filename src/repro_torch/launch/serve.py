"""Serving driver: continuous-batching greedy decode over a reduced or
full config, on one card by default.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-26b \\
      --smoke
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
      --requests 4 --batch 2 --max-new 4

The port of ``repro.launch.serve`` for the dense, moe, ssm, hybrid and
vlm families (arctic-480b fits no card: ``--smoke`` only; internvl2-26b
serves text only, as the reference does; its float32 weights at full
size, 79.6 GB, fit no 80 GB card).  The audio family raises
``ValueError``: the driver feeds one token a slot and musicgen takes
``num_codebooks`` (the reference's driver fails on it too).  The same
request stream (prompt lengths and tokens from
``numpy.random.default_rng(seed)``), the same admission, and one decode
step per position for the whole batch.  The cache each step returns is
the one the next step takes (the dense and moe families write their KV
cache in place; the recurrent families return new states).  Like the reference,
each step passes one ``pos`` (the oldest slot's age) for every slot,
prompts are fed one token per step, and a recycled slot's cache (KV or
recurrent state) is not cleared.  Weights are a random init from
``--seed``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import models as M
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.torch_device import DEFAULT_DEVICE, resolve_device
from repro_torch.serve import make_serve_step


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    if cfg.num_codebooks > 1:
        raise ValueError(
            f"{cfg.name}: the serving driver feeds one token per slot, and "
            f"the model takes {cfg.num_codebooks} codebook tokens a position "
            f"(num_codebooks); drive it through serve.greedy_generate")
    params = M.init_params(cfg, torch.Generator(dev).manual_seed(args.seed),
                           device=dev)
    serve = make_serve_step(cfg)
    rng = np.random.default_rng(args.seed)

    cache = M.init_cache(cfg, args.batch, args.max_seq, device=dev)
    queue = [rng.integers(1, cfg.vocab_size,
                          size=int(rng.integers(4, 16)))
             for _ in range(args.requests)]
    cur = np.zeros(args.batch, np.int64)
    age = np.zeros(args.batch, int)
    active: list = [None] * args.batch
    done = 0
    next_id = 0

    def admit(slot):
        nonlocal next_id
        if not queue:
            active[slot] = None
            return
        prompt = queue.pop(0)
        active[slot] = [next_id, list(prompt), 0]
        next_id += 1
        age[slot] = 0
        cur[slot] = int(prompt[0])

    for s in range(args.batch):
        admit(s)

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    steps = 0
    while done < args.requests and steps < 100_000:
        tok, cache = serve(params, cache, torch.as_tensor(cur, device=dev),
                           int(age.max()))
        tok = tok.cpu().numpy()
        steps += 1
        for s in range(args.batch):
            if active[s] is None:
                continue
            rid, prompt, ngen = active[s]
            age[s] += 1
            if age[s] < len(prompt):
                cur[s] = int(prompt[age[s]])
                continue
            active[s][2] = ngen + 1
            if active[s][2] >= args.max_new or int(tok[s]) == 0:
                done += 1
                admit(s)
            else:
                cur[s] = int(tok[s])
    dt = time.perf_counter() - t0
    stats = {"requests": args.requests, "done": done, "steps": steps,
             "seconds": dt, "tok_per_s": steps * args.batch / dt,
             "batch": args.batch, "device": str(dev)}
    print(f"[serve] {done}/{args.requests} requests, {steps} decode steps, "
          f"{stats['tok_per_s']:.1f} tok/s (batch={args.batch}, {dev})")
    return stats


if __name__ == "__main__":
    main()
