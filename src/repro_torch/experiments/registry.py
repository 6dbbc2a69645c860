"""Declarative observation registry.

Each of the paper's 13 key observations is encoded as one
:class:`Experiment`: a device configuration, a set of
:class:`SweepPoint` workloads (``WorkloadSpec`` + latency-parameter
profile + seed), a metric extractor, and an executable ``check`` that
asserts the observation's *qualitative* claim against the extracted
metrics.  The :class:`repro_torch.experiments.ExperimentRunner` lowers
every registered experiment's sweep points onto a single batched
:class:`repro_torch.core.DeviceFleet` call, so "run the whole
characterization matrix" is one fixpoint solve on the device.  The
registry is this package's own: it never sees the reference package's
entries, even in one process.

Example::

    >>> from repro_torch.experiments import all_experiments, get_experiment
    >>> len(all_experiments())
    15
    >>> get_experiment("obs4").title
    'Appends have higher latency than writes'
    >>> get_experiment(4) is get_experiment("obs04_append_vs_write")
    True
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

from repro_torch.core import LatencyParams, WorkloadSpec, ZNSDeviceSpec
from repro_torch.core.registry import Registry


@dataclasses.dataclass(frozen=True)
class SweepPoint:
    """One (device, workload, seed) simulation of an experiment's sweep.

    ``params=None`` uses the calibrated ZN540 latency profile; emulator
    A/B points name a :data:`repro_torch.core.emulator_models.EMULATOR_PROFILES`
    entry via ``params``.
    """

    label: str
    workload: WorkloadSpec
    spec: ZNSDeviceSpec = dataclasses.field(default_factory=ZNSDeviceSpec)
    params: Optional[LatencyParams] = None
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class Check:
    """One verdict of an experiment's ``check``: a named sub-claim, a
    boolean outcome, and a human-readable detail string."""

    name: str
    ok: bool
    detail: str

    def __str__(self) -> str:
        return f"[{'PASS' if self.ok else 'FAIL'}] {self.name}: {self.detail}"


#: ``extract(ctx) -> {metric: value}`` where ``ctx`` is the runner's
#: :class:`repro_torch.experiments.runner.ExperimentContext`.
ExtractFn = Callable[[object], Dict[str, float]]
#: ``check(metrics) -> (Check, ...)`` — pure over the metric dict.
CheckFn = Callable[[Dict[str, float]], Tuple[Check, ...]]


@dataclasses.dataclass(frozen=True)
class Experiment:
    """One paper observation as an executable, fleet-batchable unit.

    ``knobs`` names the :class:`repro_torch.core.LatencyParams` fields /
    :mod:`repro_torch.core.calibration` anchors that govern the observation
    (the docs tree maps observation -> knob -> test via this field);
    ``tests`` points at the asserting test functions.
    """

    name: str                       # registry key, e.g. "obs04_append_vs_write"
    obs: int                        # 1..13 the paper's numbering; 14+ are
    #                                 scenario extensions built on the model
    title: str
    claim: str                      # the paper's qualitative claim
    figure: str                     # paper figure/section it reproduces
    points: Tuple[SweepPoint, ...]
    extract: ExtractFn
    check: CheckFn
    knobs: Tuple[str, ...] = ()
    tests: Tuple[str, ...] = ()

    def __post_init__(self):
        if self.obs < 1:
            raise ValueError(f"obs must be >= 1, got {self.obs}")
        labels = [p.label for p in self.points]
        if len(set(labels)) != len(labels):
            raise ValueError(f"{self.name}: duplicate sweep-point labels "
                             f"{labels}")


_REGISTRY: Registry = Registry("experiment")


def register_experiment(exp: Experiment, *, replace: bool = False
                        ) -> Experiment:
    """Add an experiment to the registry (warns on name collisions via
    the shared :class:`repro_torch.core.registry.Registry`, mirroring
    :func:`repro_torch.core.register_backend`)."""
    return _REGISTRY.register(exp.name, exp, replace=replace)


def unregister_experiment(name: str) -> None:
    _REGISTRY.unregister(name)


def get_experiment(key) -> Experiment:
    """Look up by registry name (``"obs04_append_vs_write"``), observation
    number (``4`` or ``"obs4"``/``"obs04"``), or unique name substring."""
    if isinstance(key, Experiment):
        return key
    if isinstance(key, int) or (isinstance(key, str) and key.isdigit()):
        num = int(key)
        for exp in _REGISTRY.values():
            if exp.obs == num:
                return exp
        raise KeyError(f"no experiment registered for observation {num}")
    key = str(key)
    if key in _REGISTRY:
        return _REGISTRY[key]
    if key.lower().startswith("obs"):
        tail = key[3:].lstrip("0_")
        if tail.isdigit():
            return get_experiment(int(tail))
    matches = [e for n, e in _REGISTRY.items() if key in n]
    if len(matches) == 1:
        return matches[0]
    raise KeyError(
        f"unknown experiment {key!r} "
        f"({'ambiguous' if matches else 'no match'}); registered: "
        f"{sorted(_REGISTRY)}")


def all_experiments() -> Tuple[Experiment, ...]:
    """Every registered experiment, ordered by observation number."""
    return tuple(sorted(_REGISTRY.values(), key=lambda e: (e.obs, e.name)))


def resolve_experiments(keys: Optional[Sequence] = None
                        ) -> Tuple[Experiment, ...]:
    """``None`` -> all; else each key through :func:`get_experiment`."""
    if keys is None:
        return all_experiments()
    return tuple(get_experiment(k) for k in keys)
