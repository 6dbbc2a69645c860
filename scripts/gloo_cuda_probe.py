#!/usr/bin/env python3
"""Which ``gloo`` collectives take CUDA tensors, on ranks that share one
card.

    python3 scripts/gloo_cuda_probe.py [--world 2] [--device cuda:0]

Starts a world of ``--world`` ranks on ``gloo`` with their tensors on
``--device`` (``repro_torch.distributed.launch``) and tries, in one
world, ``all_reduce`` (SUM, MAX), ``all_gather``, ``all_to_all_single``
(even splits, and the one-peer splits of a ppermute), ``broadcast``,
``all_gather_into_tensor`` and ``reduce_scatter_tensor`` in float32,
bfloat16 and int32, checking each result's values; then ``send`` /
``recv`` in a world of its own (a backend that reads a device pointer as
a host one can kill the process).  Prints one line a probe, ``ok`` or
the error, and a JSON summary last.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.distributed import launch  # noqa: E402

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int32": torch.int32}


def _probes(rank: int, n: int, dev: torch.device, dt: torch.dtype):
    def full(shape, v):
        return torch.full(shape, v, dtype=dt, device=dev)

    def all_reduce(op, want):
        x = full((5,), rank + 1)
        dist.all_reduce(x, op=op)
        return bool((x == want).all())

    def all_gather():
        parts = [full((3,), -1) for _ in range(n)]
        dist.all_gather(parts, full((3,), rank))
        return all(bool((p == i).all()) for i, p in enumerate(parts))

    def all_to_all():
        out = full((n, 2), -1)
        dist.all_to_all_single(out, torch.arange(n, device=dev).to(dt)
                               .repeat_interleave(2).view(n, 2) + 10 * rank)
        return all(bool((out[i] == 10 * i + rank).all()) for i in range(n))

    def ppermute():
        send, recv = [0] * n, [0] * n
        send[(rank + 1) % n], recv[(rank - 1) % n] = 1, 1
        out = full((1, 4), -1)
        dist.all_to_all_single(out, full((1, 4), rank), recv, send)
        return bool((out == (rank - 1) % n).all())

    def broadcast():
        x = full((4,), rank + 7)
        dist.broadcast(x, 0)
        return bool((x == 7).all())

    def gather_tensor():
        out = full((n * 2,), -1)
        dist.all_gather_into_tensor(out, full((2,), rank))
        return bool((out.view(n, 2)[:, 0] == torch.arange(n, device=dev)
                     .to(dt)).all())

    def reduce_scatter():
        out = full((2,), -1)
        dist.reduce_scatter_tensor(out, full((2 * n,), 1))
        return bool((out == n).all())

    return {"all_reduce SUM": lambda: all_reduce(dist.ReduceOp.SUM,
                                                 n * (n + 1) // 2),
            "all_reduce MAX": lambda: all_reduce(dist.ReduceOp.MAX, n),
            "all_gather": all_gather,
            "all_to_all_single": all_to_all,
            "all_to_all_single one peer": ppermute,
            "broadcast": broadcast,
            "all_gather_into_tensor": gather_tensor,
            "reduce_scatter_tensor": reduce_scatter}


def _collectives(rank, report, device):
    dev = torch.device(device)
    n = dist.get_world_size()
    out = {}
    for dname, dt in DTYPES.items():
        for name, fn in _probes(rank, n, dev, dt).items():
            try:
                res = "ok" if fn() else "wrong values"
            except (RuntimeError, ValueError, TypeError) as e:
                res = f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            out[f"{name} {dname}"] = res
            report(f"{name} {dname}: {res}")
    return out


def _send_recv(rank, report, device):
    x = torch.full((4,), float(rank + 1), device=device)
    try:
        if rank == 0:
            dist.send(x, 1)
        elif rank == 1:
            dist.recv(x, 0)
        res = "ok" if rank != 1 or bool((x == 1).all()) else "wrong values"
    except (RuntimeError, ValueError, TypeError) as e:
        res = f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"
    return f"rank {rank} ({'send' if rank == 0 else 'recv'}): {res}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--timeout", type=float, default=60.0)
    args = ap.parse_args()
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device", file=sys.stderr)
        return 2
    summary = launch.run(_collectives, args.world, backend="gloo",
                         device=args.device, args=(args.device,),
                         timeout=args.timeout,
                         on_message=lambda r, m: r == 0 and print(
                             m, flush=True))[0]
    try:
        res = "; ".join(launch.run(_send_recv, 2, backend="gloo",
                                   device=args.device, args=(args.device,),
                                   timeout=args.timeout))
    except (RuntimeError, TimeoutError) as e:
        res = f"world failed: {str(e).splitlines()[0][:160]}"
    summary["send/recv float32"] = res
    print(f"send/recv float32: {res}")
    print(json.dumps({"device": args.device, "world": args.world,
                      "torch": torch.__version__, "probes": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
