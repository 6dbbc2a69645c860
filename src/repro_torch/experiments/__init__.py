"""Observation registry + fleet-batched experiment runner, ported.

The paper's contribution is 13 key observations about ZNS SSD behavior;
this package makes each one an executable :class:`Experiment` (device
spec + latency profile + workload sweep + metric extractors + a
``check`` asserting the qualitative claim) and runs any subset of them
as **one** batched :class:`repro_torch.core.DeviceFleet` computation:
on the card, one launch of the CUDA ``zns_fixpoint`` kernel.  Two
scenario extensions (obs14/obs15, :mod:`repro_torch.experiments.traffic`)
replay the interference observations under open-loop arrival processes.

    python -m repro_torch.experiments run --all        # all 15, one fleet sweep
    python -m repro_torch.experiments run --all --device cpu
    python -m repro_torch.experiments list             # what's registered

    >>> from repro_torch.experiments import ExperimentRunner
    >>> res = ExperimentRunner(["obs13"], device="cpu").run()[0]
    >>> res.passed, round(res.metrics["write_inflation_pct"], 2)
    (True, 78.42)

Importing the package needs no CUDA device; running with the default
``device="cuda"`` does.  `docs/observations.md` maps every observation
to its registry entry, model knobs, and tests.
"""
from .registry import (  # noqa: F401
    Check, Experiment, SweepPoint, all_experiments, get_experiment,
    register_experiment, resolve_experiments, unregister_experiment,
)
from .runner import (  # noqa: F401
    DEFAULT_OUT_DIR, ExperimentContext, ExperimentResult, ExperimentRunner,
    render_report,
)
from . import observations  # noqa: F401  (populates the registry)
from . import traffic  # noqa: F401  (obs14/obs15 open-loop scenarios)
