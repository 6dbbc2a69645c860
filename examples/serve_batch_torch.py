"""Serve a small model with batched requests: continuous-batching-style
loop where finished sequences are replaced by queued prompts.

The port of ``examples/serve_batch.py``: tinyllama-1.1b's smoke config,
12 requests from ``default_rng(0)`` in 4 slots, printed as the reference
prints them.  As in the reference, each step passes one ``pos`` (the
oldest slot's age) for the whole batch, and a recycled slot's cache is
not cleared (``repro_torch.launch.serve`` copies both on purpose).  The
config takes ``kernel_impl="auto"`` where the reference's says
``"xla"``: the hand-written kernels on the card (RMSNorm; attention
where a step runs it through the kernel), the plain versions on the
CPU, the same arithmetic as ``"xla"``.  Weights are the port's random
init from seed 0, not the reference's ``PRNGKey(0)`` draw, so the
served tokens differ from the reference's output; :func:`run` takes
parameters, e.g. the reference's carried across with
``repro_torch.models.params_from_reference``.

  PYTHONPATH=src python examples/serve_batch_torch.py [--device cpu]
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import models as M
from repro_torch.configs import get_smoke_config
from repro_torch.core.torch_device import DEFAULT_DEVICE, resolve_device
from repro_torch.serve import make_serve_step

BATCH = 4
MAX_SEQ = 64
EOS = 0
N_REQUESTS = 12
MAX_NEW = 24


def config():
    """tinyllama-1.1b's smoke config on the kernels (``"auto"``)."""
    return dataclasses.replace(get_smoke_config("tinyllama-1.1b"),
                               kernel_impl="auto")


def run(cfg=None, params=None, *, device=DEFAULT_DEVICE) -> dict:
    """Serves the 12 requests; prints as the reference does and returns
    ``done``, ``steps`` and ``outputs`` (request id -> generated
    tokens)."""
    dev = resolve_device(device)
    cfg = config() if cfg is None else cfg
    if params is None:
        params = M.init_params(cfg, torch.Generator(dev).manual_seed(0),
                               device=dev)
    serve = make_serve_step(cfg)

    rng = np.random.default_rng(0)
    queue = [rng.integers(1, cfg.vocab_size, size=rng.integers(4, 12))
             for _ in range(N_REQUESTS)]
    # slot state
    cache = M.init_cache(cfg, BATCH, MAX_SEQ, device=dev)
    cur = np.zeros(BATCH, np.int32)
    age = np.zeros(BATCH, int)
    active = [None] * BATCH
    outputs = {}
    done = 0
    step_count = 0

    def admit(slot):
        if not queue:
            active[slot] = None
            return
        req_id = N_REQUESTS - len(queue)
        prompt = queue.pop(0)
        active[slot] = (req_id, list(prompt), [])
        age[slot] = 0
        cur[slot] = int(prompt[0])

    for s in range(BATCH):
        admit(s)

    while done < N_REQUESTS and step_count < 2000:
        pos = int(age.max())
        tok, cache = serve(params, cache, torch.as_tensor(cur, device=dev),
                           pos)
        tok = tok.cpu().numpy()
        step_count += 1
        for s in range(BATCH):
            if active[s] is None:
                continue
            req_id, prompt, gen = active[s]
            age[s] += 1
            if age[s] < len(prompt):           # still force-feeding prompt
                cur[s] = int(prompt[age[s]])
                continue
            gen.append(int(tok[s]))
            if int(tok[s]) == EOS or len(gen) >= MAX_NEW:
                outputs[req_id] = gen
                done += 1
                admit(s)
            else:
                cur[s] = int(tok[s])
    print(f"served {done}/{N_REQUESTS} requests in {step_count} decode steps "
          f"(batch={BATCH})")
    for rid in sorted(outputs)[:4]:
        print(f"  req {rid}: {len(outputs[rid])} tokens "
              f"{outputs[rid][:8]}...")
    assert done == N_REQUESTS
    return {"done": done, "steps": step_count, "outputs": outputs}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="where the model runs (default: the card)")
    args = ap.parse_args(argv)
    return run(device=args.device)


if __name__ == "__main__":
    main()
