#!/usr/bin/env python3
"""The SSD scan's backward of one source tree, timed and held on the card.

    python scripts/ssd_bwd_ab.py [--src DIR] [--dtype bfloat16|float32]
                                 [--layers 48] [--reps 5]

Needs a CUDA card and ``nvcc``.  ``--src`` is a ``src`` directory holding
``repro_torch`` (default: this checkout's), e.g. an unpacked ``git
archive`` of an earlier commit, whose kernels build into that tree's own
``build/kernels/``.  To compare two trees on one card, run parent, change,
change, parent in one call.  Prints, after the card's name and power
limit:

- ``ssd_chunk_scan_bwd`` at mamba2-370m's training shape (x (4, 2,048, 32,
  64), B/C (4, 2,048, 1, 128), chunk 128) in ``--dtype`` (bfloat16 by
  default: the tensor-core instance; float32: the float32-core one), on
  ``chip_smoke.py`` phase 2's inputs: the median of ``--reps`` CUDA-event
  timings with the L2 flushed, and the device ms by kernel
  (``chip_smoke.kernel_split``), the split of the backward's time;
- in bfloat16, mamba2-370m's first-step gradients at ``--layers`` layers
  (weights N(0, 0.02) from seed 0, 4 x 2,048 tokens), kernels against
  the plain versions: the largest relative (Frobenius) gap over the
  leaves, as ``chip_smoke.py`` phase 23 prints it (``--layers 0``, or
  float32: not taken).

The last line is a JSON object with these numbers.
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    ap.add_argument("--layers", type=int, default=48)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("ssd_bwd_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch import models as M
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.kernels import ssd_chunk_scan as kssd
    from repro_torch.utils import tree_leaves
    import repro_torch
    print(f"ssd_bwd_ab: {os.path.dirname(repro_torch.__file__)}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    cuda = torch.device("cuda")
    gen = torch.Generator(cuda).manual_seed(0)

    def randn(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=cuda)
                * scale).to(dtype)

    # phase 2's inputs at mamba2-370m's training shape
    t, h, p, n, chunk = 2048, 32, 64, 128, 128
    dtype = getattr(torch, args.dtype)
    x = randn((4, t, h, p), dtype, 0.5)
    dt = torch.rand((4, t, h), generator=gen, device=cuda) * 0.099 + 0.001
    A = -(torch.rand((h,), generator=gen, device=cuda) * 1.5 + 0.5)
    Bm = randn((4, t, 1, n), dtype, 0.3)
    Cm = randn((4, t, 1, n), dtype, 0.3)
    dy = randn((4, t, h, p), dtype)
    ds = randn((4, h, p, n), torch.float32, 0.1)
    ins = (x, dt, A, Bm, Cm, dy, ds)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float64, device=cuda)

    def bwd():
        return kssd.ssd_chunk_scan_bwd(*ins, chunk=chunk)

    ms = cs.time_ms(bwd, reps=args.reps, flush=flush)
    split = cs.kernel_split(bwd, "ssd_bwd")
    print(f"ssd_chunk_scan_bwd {args.dtype} x {tuple(x.shape)}: {ms:.4f} ms "
          f"(median of {args.reps}, L2 flushed); device ms by kernel "
          f"{split}")
    del ins, x, dt, A, Bm, Cm, dy, ds, flush
    torch.cuda.empty_cache()
    out = {"dtype": args.dtype, "bwd_ms": ms, "kernel_ms": split,
           "card": smi.stdout.strip()}
    if args.layers == 0 or args.dtype == "float32":
        print(json.dumps(out))
        return 0

    cfg = dataclasses.replace(get_config("mamba2-370m"),
                              num_layers=args.layers)
    tree = M.init_params(cfg, torch.Generator(cuda).manual_seed(0),
                         device=cuda, weight_std=cs.INIT_STD).param_tree()
    batch = {"tokens": torch.as_tensor(TokenPipeline(DataConfig(
        cfg.vocab_size, 2048, 4)).batch_at(0)["tokens"], device=cuda)}

    def grads(c):
        model = M.Mamba2(c, tree)
        model.requires_grad_(True)
        g = M.bind_grads(c, model)
        loss, _ = M.loss_fn(c, model, batch)
        loss.backward()
        return float(loss.detach()), tree_leaves(g)

    l_k, g_k = grads(cfg)
    l_p, g_p = grads(dataclasses.replace(cfg, kernel_impl="torch"))
    gap = max(float((a - b).float().norm()
                    / b.float().norm().clamp_min(1e-30))
              for a, b in zip(g_k, g_p))
    print(f"mamba2-370m bfloat16 first-step gradients at {args.layers} "
          f"layers, kernels vs plain: loss {l_k!r} vs {l_p!r}; largest "
          f"relative gap over the leaves {gap:.4e}")
    out.update(layers=args.layers, bf16_grad_gap=gap)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
