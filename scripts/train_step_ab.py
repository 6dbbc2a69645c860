#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 18 (training tinyllama-1.1b at full size) in
two checkouts of the port, A B B A on one card.

    python scripts/train_step_ab.py ROOT_A ROOT_B

Needs a CUDA card.  Each run is a process of its own that imports
``repro_torch`` from one checkout's ``src`` and does what phase 18 does:
``launch.train.main`` for 8 steps (seed 0, every weight matrix N(0,
0.02), bfloat16 activations, remat full, 4 x 2,048 tokens from
``TokenPipeline``, lr 3e-3, 2 warmup steps), the peak memory counted from
its start, then two more steps on the 9th batch, each timed between two
device synchronisations, and a third with the peak counted from its
start while the state is held.  The kernels of both checkouts are built
first, at once.  The card's name and power limit, and the torch build,
lead the output; each run prints one JSON line: the checkout,
``peak_bytes`` (phase 18's
reading), ``held_bytes`` (allocated when the 8 steps are done: the state
and what else stays), ``step_peak_bytes`` (the lone step's peak),
``step_ms`` (the two timed steps), ``wall_s`` (the 8 steps) and the
losses and gradient norms.
"""
import json
import os
import subprocess
import sys

KERNELS = ("rmsnorm", "flash_attention")


def _env(root: str) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(root, "src")
    return env


def one(root: str) -> dict:
    """Phase 18 in this process, on ``root``'s port."""
    import time

    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.launch import train as ltrain
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import make_train_step

    cfg = get_config("tinyllama-1.1b")
    args = ["--arch", "tinyllama-1.1b", "--batch", "4", "--seq-len", "2048",
            "--lr", "3e-3", "--warmup", "2", "--log-every", "1",
            "--init-std", "0.02", "--steps", "8", "--seed", "0"]
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    res = ltrain.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    held = torch.cuda.memory_allocated()
    state = res.pop("state")
    step = make_train_step(cfg, AdamWConfig(lr=3e-3, warmup_steps=2,
                                            total_steps=8))
    batch = TokenPipeline(DataConfig(cfg.vocab_size, 2048, 4)).batch_at(8)
    step_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
    torch.cuda.reset_peak_memory_stats()
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    return dict(root=root, peak_bytes=peak, held_bytes=held,
                step_peak_bytes=torch.cuda.max_memory_allocated(),
                step_ms=step_ms, wall_s=wall,
                losses=[float(x) for x in res["losses"]],
                grad_norms=[float(x) for x in res.get("grad_norms", [])],
                finite=bool(np.isfinite(res["losses"]).all()))


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(one(sys.argv[2])), flush=True)
        return 0
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("train_step_ab: needs a CUDA device", file=sys.stderr)
        return 2
    a, b = (os.path.abspath(r) for r in sys.argv[1:])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    build = ("from repro_torch.kernels import _build; "
             f"_build.build({list(KERNELS)!r})")
    procs = [subprocess.Popen([sys.executable, "-c", build], env=_env(r),
                              cwd=r) for r in (a, b)]
    if any(p.wait() != 0 for p in procs):
        print("train_step_ab: a kernel build failed", file=sys.stderr)
        return 1
    rc = 0
    for root in (a, b, b, a):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", root],
            env=_env(root), cwd=root, capture_output=True, text=True,
            timeout=900)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or not lines:
            print(f"train_step_ab: {root} failed:\n{proc.stderr[-3000:]}",
                  file=sys.stderr)
            rc = 1
            continue
        print(lines[-1], flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
