#!/usr/bin/env python3
"""The attention backward of one source tree, timed and held on the card.

    python scripts/attn_bwd_ab.py [--src DIR] [--reps 5]

Needs a CUDA card and ``nvcc``.  ``--src`` is a ``src`` directory holding
``repro_torch`` (default: this checkout's), e.g. an unpacked ``git
archive`` of an earlier commit, whose kernels build into that tree's own
``build/kernels/``.  To compare two trees on one card, run parent, change,
change, parent in one call.  Prints, after the card's name and power
limit, for each shape and dtype (``chip_smoke.py`` phase 2's inputs):
recurrentgemma-9b's (1 x 16/1 heads x 4,096 tokens, D 256, window
2,048), tinyllama-1.1b's (4 x 32/4 x 2,048, D 64) and qwen3-4b's (1 x
32/8 x 2,048, D 128), all causal, in bfloat16 and float32:

- ``flash_attention_bwd``: the median of ``--reps`` CUDA-event timings
  with the L2 flushed, and the device ms by kernel
  (``chip_smoke.kernel_split``);
- its largest error against the plain backward, as a share of the plain
  gradient's largest magnitude;
- the query-head groups G of the tree's plan, where it has one;
- SDPA's backward through autograd on the same inputs (the library's
  time beside the kernel's);

and, once, a hash of the SASS of each bfloat16 backward function of the
tree's built library (``cuobjdump -sass``), so that two trees' outputs
show which instances changed.

The last line is a JSON object with these numbers.
"""
import argparse
import hashlib
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (name, (B, Hq, Hkv, T, D), window)
SHAPES = (("recurrentgemma", (1, 16, 1, 4096, 256), 2048),
          ("tinyllama", (4, 32, 4, 2048, 64), None),
          ("qwen3", (1, 32, 8, 2048, 128), None))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(0, ROOT)
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("attn_bwd_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ref as kref
    import repro_torch
    print(f"attn_bwd_ab: {os.path.dirname(repro_torch.__file__)}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    cuda = torch.device("cuda")
    gen = torch.Generator(cuda).manual_seed(1)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float64, device=cuda)
    out = {"card": smi.stdout.strip(), "rows": {}}
    for name, (b, hq, hkv, t, d), window in SHAPES:
        for dname in ("bfloat16", "float32"):
            dtype = getattr(torch, dname)

            def randn(shape):
                return torch.randn(shape, generator=gen,
                                   device=cuda).to(dtype)

            q, k, v = randn((b, hq, t, d)), randn((b, hkv, t, d)), \
                randn((b, hkv, t, d))
            do = randn((b, hq, t, d))
            o, lse = kfa.flash_attention(q, k, v, window=window,
                                         return_lse=True)

            def bwd():
                return kfa.flash_attention_bwd(q, k, v, o, do, lse,
                                               window=window)

            got = bwd()
            want = kfa.attention_bwd_torch(q, k, v, o, do, lse,
                                           window=window)
            err = max(float((a.float() - w.float()).abs().max()
                            / w.float().abs().max())
                      for a, w in zip(got, want))
            del want
            ms = cs.time_ms(bwd, reps=args.reps, flush=flush)
            split = cs.kernel_split(bwd, "bwd_")
            plan = getattr(kfa.flash_attention_bwd, "last_plan", None)
            groups = plan.groups if plan is not None else None
            mask = (None if window is None else
                    kref.attention_mask(t, t, True, window, cuda))
            ql, kl, vl = (x.detach().requires_grad_(True) for x in (q, k, v))
            lo = F.scaled_dot_product_attention(
                ql, kl, vl, attn_mask=mask, is_causal=mask is None,
                enable_gqa=True)
            lms = cs.time_ms(lambda: torch.autograd.grad(
                lo, (ql, kl, vl), do, retain_graph=True), reps=args.reps,
                flush=flush)
            print(f"{name} {dname} q {tuple(q.shape)} k {tuple(k.shape)} "
                  f"window {window}: {ms:.4f} ms (median of {args.reps}, "
                  f"L2 flushed), G {groups}, SDPA's backward {lms:.4f} ms "
                  f"({ms / lms:.2f}x); largest error against the plain "
                  f"backward {err:.3e} of its largest gradient; device ms "
                  f"by kernel {split}")
            out["rows"][f"{name} {dname}"] = dict(
                ms=ms, library_ms=lms, groups=groups, rel_err=err,
                kernel_ms=split)
            del q, k, v, do, o, lse, got, ql, kl, vl, lo
            torch.cuda.empty_cache()
    out["sass"] = sass_hashes(cs, _build)
    print(f"SASS sha256 by bfloat16 backward function: {out['sass']}")
    print(json.dumps(out))
    return 0


def sass_hashes(cs, build) -> dict:
    """{function: sha256 of its SASS listing} for the bfloat16 backward's
    dK/dV and dQ functions of the built flash-attention library."""
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass",
                           str(build.library_path("flash_attention"))],
                          capture_output=True, text=True, timeout=300).stdout
    bodies, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = cs.kernel_name(m.group(1))
            bodies[fn] = []
        elif fn is not None:
            bodies[fn].append(line)
    return {f: hashlib.sha256("\n".join(b).encode()).hexdigest()[:16]
            for f, b in sorted(bodies.items())
            if f.startswith(("bwd_dkdv_wgmma", "bwd_dq_wgmma"))}


if __name__ == "__main__":
    sys.exit(main())
