#!/usr/bin/env python3
"""How far a float32 step sits from the same step in float64, one rank.

    PYTHONPATH=src python scripts/f32_rounding_gap.py [--archs A,B,...]

For each smoke config it draws the weights once (seed 0), runs the
train step's backward (``train.gradients``) on the same 8 x 16 tokens in
float32 and in float64 (the float32 weights cast up), and prints the
largest gradient difference of any leaf relative to that leaf's largest
magnitude; then a prefill and three decode steps of the serve steps
(4 x 10 tokens, recurrentgemma-9b 4 x 40) in both, and the last step's
logits' largest difference relative to their largest magnitude.  This
is the floor of any float32 comparison of two orderings of the same
sums: ``tests/test_torch_tensor_parallel.py`` holds the tensor-parallel
step against the one-rank step in float64 where this gap exceeds its
tolerance.  CPU only, plain versions (``kernel_impl="xla"``).
"""
import argparse
import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

ARCHS = ["tinyllama-1.1b", "qwen3-4b", "qwen2-moe-a2.7b", "mamba2-370m",
         "recurrentgemma-9b", "internvl2-26b", "musicgen-large"]
SERVE = {"qwen3-4b": 10, "qwen2-moe-a2.7b": 10, "recurrentgemma-9b": 40}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--archs", default=",".join(ARCHS))
    args = ap.parse_args()
    import numpy as np
    import torch
    from repro_torch import models as M
    from repro_torch.configs import get_smoke_config
    from repro_torch.serve import make_prefill_step, make_serve_step
    from repro_torch.train import TrainState, gradients
    from repro_torch.utils.tree import tree_leaves

    def config(arch, dtype):
        return dataclasses.replace(get_smoke_config(arch), dtype=dtype,
                                   param_dtype=dtype)

    def cast(src, dst):
        with torch.no_grad():
            for a, b in zip(tree_leaves(dst.param_tree()),
                            tree_leaves(src.param_tree())):
                a.copy_(b.to(a.dtype))

    for arch in args.archs.split(","):
        c32, c64 = config(arch, "float32"), config(arch, "float64")
        shape = (8, 16) + ((c32.num_codebooks,)
                           if c32.num_codebooks > 1 else ())
        toks = {"tokens": torch.from_numpy(np.random.default_rng(2).integers(
            0, c32.vocab_size, shape))}
        s32 = TrainState.create(c32, torch.Generator().manual_seed(0),
                                device="cpu")
        s64 = TrainState.create(c64, torch.Generator().manual_seed(0),
                                device="cpu")
        cast(s32.params, s64.params)
        _, g32 = gradients(c32, s32, toks)
        _, g64 = gradients(c64, s64, toks)
        gap = max(float((a.double() - b).abs().max() / b.abs().max())
                  for a, b in zip(tree_leaves(g32), tree_leaves(g64))
                  if float(b.abs().max()) > 0)
        line = f"{arch}: gradient gap {gap:.3e} of a leaf's largest magnitude"
        if arch in SERVE:
            n = SERVE[arch]
            prompt = torch.from_numpy(np.random.default_rng(3).integers(
                0, c32.vocab_size, (4, n)))
            logits = []
            for cfg, state in ((c32, s32), (c64, s64)):
                params = state.params.requires_grad_(False)
                tok, cache = make_prefill_step(cfg, 64)(params, prompt)
                step = make_serve_step(cfg, 64)
                for i in range(2):
                    tok, cache = step(params, cache, tok, n + i)
                with torch.inference_mode():
                    out, _ = M.decode_step(cfg, params, cache, tok, n + 2)
                logits.append(out.double())
            lgap = float((logits[0] - logits[1]).abs().max()
                         / logits[1].abs().max())
            line += f"; decode logits gap {lgap:.3e}"
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
