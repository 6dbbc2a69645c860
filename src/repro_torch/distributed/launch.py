"""Start a world of ranks as processes on this host.

``torch.distributed`` learns of its world only from its caller:
:func:`init_world` gives ``init_process_group`` the address, the world
size and the rank, and :func:`run` starts ``world_size`` processes with
the ``spawn`` start method (a parent that has initialised CUDA cannot
``fork``), each on a free ``tcp://localhost`` port it picks by binding
port 0.  Ranks report to the parent through a queue; :func:`run` raises
when a rank fails, and kills every rank when none reports for
``timeout`` seconds (a rank stuck in a collective whose peer died), so a
hung world costs its caller at most that long.
"""
from __future__ import annotations

import datetime
import queue as _queue
import socket
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import check_backend


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_world(rank: int, world_size: int, init_method: str, *,
               backend: str, device, timeout: float = 180.0) -> None:
    """Join the default process group; collectives fail after
    ``timeout`` seconds instead of waiting for a dead peer forever."""
    check_backend(backend, world_size, device)
    device = torch.device(device)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout))


def _worker(rank, world_size, init_method, backend, device, timeout, fn,
            args, q):
    try:
        init_world(rank, world_size, init_method, backend=backend,
                   device=device, timeout=timeout)
        try:
            result = fn(rank, lambda msg: q.put(("msg", rank, msg)), *args)
        finally:
            dist.destroy_process_group()
        q.put(("done", rank, result))
    except BaseException:      # reported to the parent, which fails
        q.put(("error", rank, traceback.format_exc()))
        raise


def _failures(q, world_size: int, rank: int, tb: str,
              grace: float = 5.0) -> str:
    """Every failure the ranks report within ``grace`` seconds of the
    first: a peer's failure in a collective often arrives before the
    cause's own."""
    errors = {rank: tb}
    end = time.monotonic() + grace
    while len(errors) < world_size:
        try:
            kind, r, payload = q.get(timeout=max(end - time.monotonic(), 0))
        except _queue.Empty:
            break
        if kind == "error":
            errors[r] = payload
    return "\n".join(f"rank {r} of {world_size} failed:\n{errors[r]}"
                     for r in sorted(errors))


def run(fn, world_size: int, *, backend: str, device, args=(),
        timeout: float = 180.0, on_message=None) -> list:
    """Run ``fn(rank, report, *args)`` on ``world_size`` new processes that
    form a world on ``backend``, tensors on ``device``; returns each
    rank's result, by rank.

    ``fn`` must be importable by name (a module-level function) and its
    arguments and result picklable.  ``report(obj)`` sends ``obj`` to the
    parent, which passes ``(rank, obj)`` to ``on_message``.  Raises
    ``RuntimeError`` with the failed ranks' tracebacks when a rank fails,
    and
    ``TimeoutError`` when no rank reports for ``timeout`` seconds (also
    the collectives' own timeout); every process is stopped before it
    returns or raises.
    """
    check_backend(backend, world_size, device)
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    init_method = f"tcp://127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=_worker, daemon=True,
                         args=(r, world_size, init_method, backend,
                               str(device), timeout, fn, args, q))
             for r in range(world_size)]
    for p in procs:
        p.start()
    results, pending = {}, set(range(world_size))
    try:
        while pending:
            deadline = time.monotonic() + timeout
            while True:
                try:
                    kind, rank, payload = q.get(timeout=1.0)
                    break
                except _queue.Empty:
                    dead = [r for r in pending if procs[r].exitcode
                            not in (None, 0)]
                    if dead:
                        raise RuntimeError(
                            f"rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} without reporting")
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"no report from ranks {sorted(pending)} of "
                            f"{world_size} in {timeout:.0f} s")
            if kind == "msg":
                if on_message is not None:
                    on_message(rank, payload)
            elif kind == "error":
                raise RuntimeError(_failures(q, world_size, rank, payload))
            else:
                results[rank] = payload
                pending.discard(rank)
        for p in procs:
            p.join(timeout)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(10)
        q.close()
    return [results[r] for r in range(world_size)]
