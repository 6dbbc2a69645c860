#!/usr/bin/env python3
"""``chip_smoke.py``'s phases 25 and 26 alone, for a quick look at the
distributed sub-phases (25a-25l) and the dry run on a CUDA card.

    python scripts/dist_phases.py              # phases 25 and 26
    python scripts/dist_phases.py --only 25    # phase 25 alone

It builds the kernels (``kernels._build.build()``), runs what the phases
are held against as ``chip_smoke.py`` runs it (phase 18's eight steps of
tinyllama-1.1b through ``launch.train``, its two timed steps and its
state's leaves; 25h's two-microbatch reference; phase 23's four steps of
mamba2-370m, which 25m is held against), then
``chip_smoke.phase25`` and ``chip_smoke.phase26``, which print their
lines and exit non-zero on a failed hold.  The kernels' launch counts
and the JSON lines of the full script are not printed.  Needs a CUDA
card; the four gloo ranks spawn from here, so the entry point is
guarded.
"""
import argparse
import gc
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def phase18_reference() -> dict:
    """Phase 18's run and what phases 25h and 26a read of it."""
    import torch

    import chip_smoke as cs
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.launch import train as ltrain
    from repro_torch.optim import AdamWConfig
    from repro_torch.configs import get_config
    from repro_torch.train import make_train_step

    train_args = ["--arch", "tinyllama-1.1b", "--batch", "4", "--seq-len",
                  "2048", "--lr", "3e-3", "--warmup", "2", "--log-every",
                  "1", "--init-std", str(cs.INIT_STD)]
    torch.cuda.reset_peak_memory_stats()
    res = ltrain.main(train_args + ["--steps", "8", "--seed", "0"])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    state = res["state"]
    cfg = get_config("tinyllama-1.1b")
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
    p18 = dict(batch=4, seq=2048, step_ms=min(step_ms),
               peak_bytes=peak * 1e9,
               batch_bytes=sum(torch.as_tensor(v).nbytes
                               for v in batch.values()),
               leaves={path: leaf.nbytes for name, tree in (
                   ("params", state.params.param_tree()),
                   ("m", state.opt["m"]), ("v", state.opt["v"]))
                   for path, leaf in cs._leaf_paths(tree, name)})
    p25 = dict(losses=res["losses"][:cs.RL_STEPS],
               grad_norms=res["grad_norms"][:cs.RL_STEPS], peak_gb=peak)
    del res, state, step
    gc.collect()
    torch.cuda.empty_cache()
    p25["mb2"] = cs.rl_reference(train_args)
    print(f"[18] losses {p25['losses']}, grad norms {p25['grad_norms']}, "
          f"step {p18['step_ms']:.1f} ms, peak {peak:.2f} GB", flush=True)
    return p18, p25


def phase23_reference() -> dict:
    """Phase 23's four mamba2-370m steps: their losses and norms."""
    import torch

    import chip_smoke as cs
    from repro_torch.launch import train as ltrain
    res = ltrain.main(cs.recurrent_argv("23", "mamba2-370m", 4, 2048))
    p23 = dict(losses=res["losses"], grad_norms=res["grad_norms"])
    del res
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[23] losses {p23['losses']}, grad norms {p23['grad_norms']}",
          flush=True)
    return p23


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=("25", "26"), default=None,
                    help="run one of the two phases")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("dist_phases: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build
    t = time.perf_counter()
    _build.build()
    print(f"[1] kernels built in {time.perf_counter() - t:.1f} s",
          flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(card, flush=True)
    p18, p25 = phase18_reference()
    if args.only is None:
        cs.start_early_dryruns()
    if args.only in (None, "25"):
        print(f"[25] launches {cs.phase25(p25, phase23_reference())}",
              flush=True)
    if args.only in (None, "26"):
        cs.phase26(card, p18)
    print(f"[total] {time.perf_counter() - t:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
