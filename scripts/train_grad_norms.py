#!/usr/bin/env python3
"""The first training step's gradient norm of tinyllama-1.1b by depth and
init, with the kernels and with their plain versions.

    PYTHONPATH=src python scripts/train_grad_norms.py [--layers 2,22]

Needs a CUDA card.  For each depth (full width: d_model 2,048, 32/4
heads), each init (``reference``: the reference's fan-in rule, which
takes the heads axis as the fan-in of a (D, H, Dh) projection;
``0.02``: every weight matrix N(0, 0.02)) and each of bfloat16 and
float32 activations, it prints the loss and the global gradient norm of
``models.loss_fn`` on the first batch of 4 x 2,048 tokens from
``TokenPipeline``, through the CUDA kernels (``kernel_impl="auto"``) and
through the plain versions (``"torch"``), weights from seed 0, remat
full.  The card's name and power limit lead the output.
"""
import argparse
import dataclasses
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import models as M  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.optim import global_norm  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", default="2,22")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_grad_norms: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    cuda = torch.device("cuda")
    base = get_config("tinyllama-1.1b")
    toks = torch.as_tensor(TokenPipeline(DataConfig(
        base.vocab_size, 2048, 4)).batch_at(0)["tokens"], device=cuda)
    for n in (int(x) for x in args.layers.split(",")):
        for std in (None, 0.02):
            cfg0 = dataclasses.replace(base, num_layers=n)
            tree = M.init_params(cfg0, torch.Generator(cuda).manual_seed(0),
                                 device=cuda, weight_std=std).param_tree()
            for dtype in ("bfloat16", "float32"):
                for impl in ("auto", "torch"):
                    cfg = dataclasses.replace(cfg0, dtype=dtype,
                                              kernel_impl=impl)
                    params = M.Transformer(cfg, tree)
                    params.requires_grad_(True)
                    grads = M.bind_grads(cfg, params)
                    loss, _ = M.loss_fn(cfg, params, {"tokens": toks})
                    loss.backward()
                    print(f"layers {n} init {std or 'reference'} {dtype} "
                          f"{'kernels' if impl == 'auto' else 'plain'}: "
                          f"loss {float(loss.detach())!r}, grad norm "
                          f"{float(global_norm(grads))!r}", flush=True)
                    del params, grads, loss
                    torch.cuda.empty_cache()
            del tree
    return 0


if __name__ == "__main__":
    sys.exit(main())
