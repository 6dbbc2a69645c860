"""Fleet-batched experiment runner + artifact emission.

The runner flattens every selected experiment's sweep points into one
list, builds a single heterogeneous :class:`repro_torch.core.DeviceFleet`
(one member per point — specs and latency-parameter records may differ
per point), and solves the whole characterization matrix with one
batched fleet call instead of N sequential device runs.  On the
``vectorized`` backend every sweep point lowers on the host into one
fleet-level :class:`repro_torch.core.ChainProgram` solved by a single
fused fixpoint on ``device`` (one launch of the CUDA ``zns_fixpoint``
kernel on the card; compiled programs are cached, so re-running a
selection skips re-lowering); the ``event`` backend degrades to a
per-point loop on the host with identical semantics.  Per-experiment
results surface the fixpoint's convergence diagnostics
(``ExperimentResult.converged``).

``device`` defaults to ``"cuda"`` and, without CUDA, :meth:`run` raises
whatever the backend; pass ``device="cpu"`` to run on the CPU.

    >>> from repro_torch.experiments import ExperimentRunner
    >>> runner = ExperimentRunner(["obs4"], backend="event", device="cpu")
    >>> [r.passed for r in runner.run()]
    [True]
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import DeviceFleet, LatencyModel, RunResult, ZnsDevice
from repro_torch.core.torch_device import DEFAULT_DEVICE

from .registry import Check, Experiment, resolve_experiments

#: Default artifact directory of the runner and of the CLI (``python -m
#: repro_torch.experiments``); ``build/`` is not tracked, and the
#: reference's fixtures under ``results/experiments`` are never written.
DEFAULT_OUT_DIR = os.path.join("build", "experiments")


@dataclasses.dataclass
class ExperimentContext:
    """What an experiment's ``extract`` callback sees: the per-point
    simulation results plus a single-device session for closed-form
    metrics (``ctx.device.steady_state`` etc.)."""

    experiment: Experiment
    results: Dict[str, RunResult]    # sweep-point label -> result
    device: ZnsDevice                # session on the experiment's device
    backend: str

    def __getitem__(self, label: str) -> RunResult:
        if label not in self.results:
            raise KeyError(
                f"{self.experiment.name}: unknown sweep point {label!r}; "
                f"have {sorted(self.results)}")
        return self.results[label]


@dataclasses.dataclass
class ExperimentResult:
    """One experiment's extracted metrics + check verdicts."""

    experiment: Experiment
    backend: str
    metrics: Dict[str, float]
    checks: Tuple[Check, ...]
    n_requests: int
    #: False if any sweep point's fixpoint exhausted its budget (the
    #: chain-program backends surface convergence; the event engine is
    #: always converged).
    converged: bool = True

    @property
    def name(self) -> str:
        return self.experiment.name

    @property
    def obs(self) -> int:
        return self.experiment.obs

    @property
    def passed(self) -> bool:
        return all(c.ok for c in self.checks)

    def to_json(self) -> Dict:
        """JSON-ready dict (non-finite floats become ``None``)."""
        clean = {k: (float(v) if math.isfinite(v) else None)
                 for k, v in self.metrics.items()}
        exp = self.experiment
        return {
            "name": exp.name, "obs": exp.obs, "title": exp.title,
            "claim": exp.claim, "figure": exp.figure,
            "knobs": list(exp.knobs), "tests": list(exp.tests),
            "backend": self.backend, "n_requests": self.n_requests,
            "passed": bool(self.passed), "converged": bool(self.converged),
            "metrics": clean,
            "checks": [{"name": c.name, "ok": bool(c.ok), "detail": c.detail}
                       for c in self.checks],
        }


class ExperimentRunner:
    """Run a set of registry experiments as one batched fleet sweep.

    ``experiments=None`` selects the full registry (all 15 observations).
    ``jitter=False`` by default so extracted metrics are deterministic
    and ``check()`` verdicts are reproducible on both backends.
    ``device`` is the fleet's and every experiment session's device.
    """

    def __init__(self, experiments: Optional[Sequence] = None, *,
                 backend: str = "vectorized", jitter: bool = False,
                 seed: int = 0, device=DEFAULT_DEVICE):
        self.experiments = resolve_experiments(experiments)
        self.backend = backend
        self.jitter = jitter
        self.seed = seed
        self.device = device
        #: The last :meth:`run`'s :class:`FleetRunResult` (compile and
        #: solve statistics of its one fleet call).
        self.last_fleet = None

    def fleet(self) -> Tuple[DeviceFleet, list, List[int]]:
        """The run's one :class:`DeviceFleet` (a member per sweep point,
        in registry order, on ``device``), each member's workload and
        each member's seed."""
        points = [pt for exp in self.experiments for pt in exp.points]
        fleet = DeviceFleet(
            [(pt.spec, pt.params) if pt.params is not None else pt.spec
             for pt in points], device=self.device)
        return (fleet, [pt.workload for pt in points],
                [self.seed + pt.seed for pt in points])

    def run(self) -> List[ExperimentResult]:
        """One fleet-batched simulation of every sweep point, then
        per-experiment extraction and checks."""
        if not any(exp.points for exp in self.experiments):
            return []
        fleet, workloads, seeds = self.fleet()
        fres = fleet.run(workloads, backend=self.backend, seeds=seeds,
                         jitter=self.jitter)
        self.last_fleet = fres
        out: List[ExperimentResult] = []
        i = 0
        for exp in self.experiments:
            results = {pt.label: fres[i + j]
                       for j, pt in enumerate(exp.points)}
            i += len(exp.points)
            first = exp.points[0]
            dev = ZnsDevice(first.spec,
                            lat=LatencyModel(first.spec, first.params)
                            if first.params is not None else None,
                            device=self.device)
            ctx = ExperimentContext(experiment=exp, results=results,
                                    device=dev, backend=fres.backend)
            metrics = exp.extract(ctx)
            checks = tuple(exp.check(metrics))
            out.append(ExperimentResult(
                experiment=exp, backend=fres.backend, metrics=metrics,
                checks=checks,
                n_requests=sum(len(r) for r in results.values()),
                converged=all(r.converged for r in results.values())))
        return out

    # -- artifacts -----------------------------------------------------------
    def write_artifacts(self, results: Sequence[ExperimentResult],
                        out_dir: str = DEFAULT_OUT_DIR) -> Dict[str, str]:
        """Emit per-experiment JSON + a rendered markdown report.

        Returns ``{artifact name: path}``; the report cross-links
        ``docs/observations.md`` (the observation -> code map).
        """
        os.makedirs(out_dir, exist_ok=True)
        paths: Dict[str, str] = {}
        for res in results:
            p = os.path.join(out_dir, f"{res.name}.json")
            with open(p, "w") as f:
                json.dump(res.to_json(), f, indent=1, sort_keys=True)
            paths[res.name] = p
        report = os.path.join(out_dir, "report.md")
        with open(report, "w") as f:
            f.write(render_report(results, out_dir=out_dir))
        paths["report"] = report
        return paths


def _docs_link(out_dir: str) -> str:
    """Relative link from the artifact dir to docs/observations.md (falls
    back to the repo-root-relative path when the docs tree isn't nearby)."""
    here = os.path.abspath(out_dir)
    probe = here
    for _ in range(6):
        cand = os.path.join(probe, "docs", "observations.md")
        if os.path.exists(cand):
            return os.path.relpath(cand, here)
        probe = os.path.dirname(probe)
    return "docs/observations.md"


def render_report(results: Sequence[ExperimentResult], *,
                  out_dir: str = DEFAULT_OUT_DIR) -> str:
    """Markdown report: one row per observation, check details below."""
    docs = _docs_link(out_dir)
    n_pass = sum(r.passed for r in results)
    backend = results[0].backend if results else "-"
    lines = [
        "# ZNS observation experiments — run report",
        "",
        f"Backend: `{backend}` · experiments: {len(results)} · "
        f"passed: {n_pass}/{len(results)}",
        "",
        f"Each experiment is one entry of the observation registry "
        f"(`repro_torch.experiments`); see [{docs}]({docs}) for the full "
        f"observation → workload → model-knob map.",
        "",
        "| Obs | Experiment | Paper ref | Requests | Checks | Status |",
        "| --- | --- | --- | --- | --- | --- |",
    ]
    for r in results:
        ok = sum(c.ok for c in r.checks)
        status = "✅ pass" if r.passed else "❌ FAIL"
        lines.append(
            f"| #{r.obs} | [`{r.name}`]({r.name}.json) | {r.experiment.figure}"
            f" | {r.n_requests} | {ok}/{len(r.checks)} | {status} |")
    for r in results:
        lines += ["", f"## Obs#{r.obs} — {r.experiment.title}", "",
                  f"> {r.experiment.claim}", ""]
        for c in r.checks:
            mark = "✅" if c.ok else "❌"
            lines.append(f"- {mark} **{c.name}** — {c.detail}")
    stale = [r.name for r in results if not r.converged]
    if stale:
        lines += [
            "",
            f"> ⚠️ **Fixpoint did not converge** for: "
            f"{', '.join(f'`{n}`' for n in stale)} — metrics above are "
            f"lower bounds from an exhausted sweep budget, not steady-state "
            f"values. Re-run with a larger `sweeps` budget.",
        ]
    lines.append("")
    return "\n".join(lines)
