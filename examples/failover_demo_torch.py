"""Failure detection -> elastic reshard -> resume, on a simulated fleet.

The port of ``examples/failover_demo.py``: the same fleet, events and
text.  The failure detector, straggler policy, reshard plan and token
pipelines are host numpy in the port as in the reference, so nothing
here runs on a device; ``--device`` is checked as every entry point of
the port checks it (the card unless ``--device cpu``).

  PYTHONPATH=src python examples/failover_demo_torch.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core.torch_device import DEFAULT_DEVICE, resolve_device
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.runtime import (
    FailureDetector, HostState, StragglerPolicy, make_reshard_plan,
    validate_plan,
)


def run(*, device=DEFAULT_DEVICE) -> dict:
    """Prints the reference's events; returns ``plan`` (the reshard plan,
    or None) and ``pipes`` (the hosts' pipelines after it)."""
    resolve_device(device)
    n_hosts = 8
    fd = FailureDetector(n_hosts, lease_s=10.0)
    sp = StragglerPolicy(factor=1.5)
    dcfg = DataConfig(vocab_size=1024, seq_len=32, global_batch=64)
    pipes = {h: TokenPipeline(dcfg, shard=h, num_shards=n_hosts)
             for h in range(n_hosts)}

    plan = None
    clock = 0.0
    for step in range(6):
        clock += 12.0
        for h in range(n_hosts):
            if h == 5 and step >= 2:
                continue            # host 5 stops heartbeating
            fd.heartbeat(h, clock)
        changes = fd.tick(clock + 1.0)
        durations = {h: 1.0 + 0.1 * np.random.default_rng(h).random()
                     for h in fd.healthy_hosts()}
        if step == 4:
            durations[2] = 5.0      # host 2 straggles
        for d in durations.values():
            sp.observe(d)
        backups = sp.mitigate(durations)
        for h, st in changes.items():
            print(f"t={clock:5.1f}s host {h} -> {st.value}")
        if backups:
            print(f"t={clock:5.1f}s straggler backups: {backups}")
        dead = [h for h, i in fd.hosts.items() if i.state is HostState.DEAD]
        if dead:
            healthy = fd.healthy_hosts()
            plan = make_reshard_plan(list(range(n_hosts)), healthy,
                                     model_parallel=4)
            validate_plan(plan)
            print(f"t={clock:5.1f}s RESHARD: {len(healthy)} hosts, "
                  f"mesh {plan.mesh_shape}, "
                  f"shard ownership {plan.shard_ownership}")
            pipes = {h: pipes[h].reshard(plan.data_shards[h][0],
                                         len(healthy))
                     for h in healthy}
            # every host resumes at the same step with the new layout
            steps = {h: p.state.step for h, p in pipes.items()}
            assert len(set(steps.values())) == 1
            print(f"t={clock:5.1f}s pipelines resharded at step "
                  f"{next(iter(steps.values()))}; resuming")
            break
    print("failover demo complete")
    return {"plan": plan, "pipes": pipes}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="checked only: the demo is host numpy")
    args = ap.parse_args(argv)
    return run(device=args.device)


if __name__ == "__main__":
    main()
