#!/usr/bin/env python3
"""Where a rows-cut train step leaves the one-rank step that rounds as it
does: ``chip_smoke.py`` phase 25h's training of tinyllama-1.1b at full
size on four gloo ranks of one card, mesh (2, 2), each rank on its 2 of
the batch's 4 rows, beside rank 0's one-rank step with the same 4 rows
in two microbatches of a rank's 2 (the same bfloat16 gradient roundings).

    python scripts/rows_cut_probe.py            # on a CUDA card
    python scripts/rows_cut_probe.py --cpu      # the smoke config, CPU

Needs a CUDA card unless ``--cpu``.  Both sides start from seed 0 (every
weight matrix N(0, 0.02)) and take phase 18's schedule (lr 3e-3, 2 warmup
steps of 8) on ``TokenPipeline``'s batches.  For each of three steps rank
0 prints both losses, for every gradient leaf how many entries of its
block differ and the largest difference against the leaf's largest
magnitude, both gradient norms, and then how many entries of each state
leaf (``opt`` m and v, then ``params``, in tree order) differ after the
update.
"""
import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def rank_fn(rank, report, cpu: bool):
    import torch
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.distributed import rank_local
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed.mesh import Mesh, cut
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainState, gradients, make_train_step
    from repro_torch.utils.tree import tree_leaves

    dev = torch.device("cpu" if cpu else "cuda")
    mesh = Mesh((2, 2), ("data", "model"), backend="gloo", device=dev)
    # phase 25h's rules: nothing on "model", every weight gathered whole
    rules = sh.make_rules(data_axes=("data",), fsdp_axes=("data", "model"),
                          model_axis="tp")
    cfg = (get_smoke_config("tinyllama-1.1b") if cpu
           else get_config("tinyllama-1.1b"))
    layout = rank_local.layout_for(cfg, mesh, rules)
    opt = AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=8)
    local = rank_local.init_state(cfg, layout,
                                  torch.Generator(dev).manual_seed(0),
                                  device=dev, weight_std=0.02)
    one = (TrainState.create(cfg, torch.Generator(dev).manual_seed(0),
                             device=dev, weight_std=0.02)
           if rank == 0 else None)
    data = TokenPipeline(DataConfig(cfg.vocab_size, 64 if cpu else 2048, 4))
    step_cut = make_train_step(cfg, opt)
    step_two = make_train_step(cfg, opt, microbatches=2)

    def state(s):
        return {"o": s.opt, "p": s.params.param_tree()}

    for i in range(3):
        batch = next(data)
        m2, g2 = gradients(cfg, local, batch)
        lines = [f"step {i + 1}: rows cut loss {float(m2['loss'])!r}"]
        if rank == 0:
            m1, g1 = gradients(cfg, one, batch, microbatches=2)
            lines.append(f"two microbatches loss {float(m1['loss'])!r}")
            specs = rank_local.spec_leaves(g2, layout.specs.params)
            for k, (a, b, s) in enumerate(zip(tree_leaves(g1),
                                              tree_leaves(g2), specs)):
                want = cut(mesh, a, s)
                d = (want - b).abs()
                lines.append(f"gradient leaf {k} {tuple(b.shape)}: "
                             f"{int((d > 0).sum())} of {b.numel()} differ, "
                             f"max {float(d.max()):.3e} of "
                             f"{float(want.abs().max()):.3e}")
            del g1
        del g2
        local, n2 = step_cut(local, batch)
        if rank == 0:
            one, n1 = step_two(one, batch)
            lines.append(f"grad norms rows cut {float(n2['grad_norm'])!r}, "
                         f"two microbatches {float(n1['grad_norm'])!r}")
            specs = rank_local.spec_leaves(
                state(local), {"o": layout.specs.opt,
                               "p": layout.specs.params})
            for k, (a, b, s) in enumerate(zip(tree_leaves(state(one)),
                                              tree_leaves(state(local)),
                                              specs)):
                lines.append(f"state leaf {k}: "
                             f"{int((cut(mesh, a, s) != b).sum())} differ")
        report("\n".join(lines) if rank == 0 else None)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="the smoke config on gloo CPU ranks")
    args = ap.parse_args(argv)
    import subprocess
    from repro_torch.distributed import launch
    if not args.cpu:
        from repro_torch.kernels import _build
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True)
        print(smi.stdout.strip(), flush=True)
        _build.build()
    t = time.time()
    launch.run(rank_fn, 4, backend="gloo", device="cpu" if args.cpu
               else "cuda", timeout=600, args=(args.cpu,),
               on_message=lambda r, m: print(m, flush=True) if m else None)
    print(f"took {time.time() - t:.1f} s")


if __name__ == "__main__":
    main()
