#!/usr/bin/env python3
"""Where a bfloat16 decoder layer's kernels and plain versions part, piece
by piece, against the same layer in float32.

    PYTHONPATH=src python scripts/bf16_layer_precision.py \\
        [--arch internvl2-26b] [--batch 2] [--seq 1024]

Needs a CUDA card.  At the arch's published width (one layer, bfloat16
weights and activations, every weight matrix N(0, 0.02) from seed 0) on
a (batch, seq) prompt from ``default_rng(0)`` (for the VLM also the stub
patch embeddings over its first positions), it runs the first decoder
layer's pieces from the plain path's input: the first RMSNorm, the
attention core (flash-attention kernel, plain version, SDPA), the output
projection, the residual, the second RMSNorm and the MLP.  For each piece
it prints the largest |value|, the largest difference kernels vs plain,
and the largest difference of each from the piece in float32 on the same
input.  The card's name and power limit lead the output.
"""
import argparse
import dataclasses
import os
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import models as M  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import common as mc  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internvl2-26b")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=1024)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bf16_layer_precision: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    cuda = torch.device("cuda")
    cfg = get_config(args.arch, num_layers=1, param_dtype="bfloat16",
                     dtype="bfloat16", kernel_impl="cuda")
    plain = dataclasses.replace(cfg, kernel_impl="torch")
    f32 = dataclasses.replace(plain, dtype="float32")
    params = M.init_params(cfg, torch.Generator(cuda).manual_seed(0),
                           device=cuda, weight_std=0.02)
    rng = np.random.default_rng(0)
    cb = (cfg.num_codebooks,) if cfg.num_codebooks > 1 else ()
    prompt = torch.as_tensor(rng.integers(
        1, cfg.vocab_size, (args.batch, args.seq) + cb), device=cuda)
    patches = None
    if cfg.frontend == "vision_stub":
        patches = torch.as_tensor(rng.standard_normal(
            (args.batch, cfg.num_patches, cfg.d_model)),
            dtype=torch.float32).to(cuda, torch.bfloat16)
    layer = params.layers[0]
    pos = torch.arange(args.seq, dtype=torch.int32,
                       device=cuda).expand(args.batch, args.seq)

    def line(name, kern, pln, exact):
        k, p, e = kern.float(), pln.float(), exact.float()
        print(f"{name}: max |x| {float(e.abs().max()):.3f}; kernels vs "
              f"plain {float((k - p).abs().max()):.4e}; to float32: kernels "
              f"{float((k - e).abs().max()):.4e}, plain "
              f"{float((p - e).abs().max()):.4e}", flush=True)

    with torch.inference_mode():
        x = mc.apply_frontend(cfg, params.embed, mc.embed_tokens(
            cfg, params.embed, prompt, torch.bfloat16), patches)
        xf = x.float()
        h = mc.rmsnorm(plain, layer.ln1, x)
        line("first RMSNorm", mc.rmsnorm(cfg, layer.ln1, x), h,
             mc.rmsnorm(f32, layer.ln1, xf))
        q, k, v = (t.movedim(2, 1) for t in mc.attn_qkv(plain, layer.attn, h,
                                                        pos))
        core = ops.attention(q, k, v, impl="cuda")
        core_p = ops.attention(q, k, v, impl="torch")
        exact = ops.attention(q.float(), k.float(), v.float(), impl="torch")
        line("attention core", core, core_p, exact)
        sdpa = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=True)
        print(f"attention core, SDPA to float32: "
              f"{float((sdpa.float() - exact).abs().max()):.4e}")
        wo = layer.attn["wo"]
        proj = [torch.einsum("bshk,hkd->bsd", c.movedim(1, 2), wo.to(c.dtype))
                for c in (core, core_p, exact)]
        line("output projection", *proj)
        y = [x + proj[0], x + proj[1], xf + proj[2]]
        line("residual", *y)
        n = [mc.rmsnorm(plain, layer.ln2, t) for t in y[:2]]
        line("second RMSNorm (plain, on each residual)", *n,
             mc.rmsnorm(f32, layer.ln2, y[2]))
        line("MLP (on each second RMSNorm)",
             *(mc.mlp(layer.mlp, t) for t in n),
             mc.mlp(layer.mlp, mc.rmsnorm(f32, layer.ln2, y[2])))
        out = [layer(c, t, pos)[0] for c, t in ((cfg, x), (plain, x),
                                                (f32, xf))]
        line("whole layer", *out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
