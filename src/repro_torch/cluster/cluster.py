"""Cluster facade: spec + workload -> compiled run -> object metrics.

    >>> from repro_torch.cluster import Cluster, ClusterSpec, ClusterWorkload
    >>> from repro_torch.cluster import erasure
    >>> spec = ClusterSpec(n_gateways=1, n_servers=4, scheme=erasure(2, 1))
    >>> res = Cluster(spec, device="cpu").run(
    ...     ClusterWorkload(n_users=2, ops_per_user=2))
    >>> res.converged and res.n_ops == 4
    True
    >>> res.latency_stats().n
    4
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.core import LatencyStats
from repro_torch.core.metrics import violation_rate
from repro_torch.core.torch_device import DEFAULT_DEVICE

from .compiler import (MAX_REFINE, CompiledCluster, build_graph,
                       compile_graph, op_latencies)
from .oracle import simulate_graph
from .spec import ClusterSpec, ClusterWorkload


@dataclasses.dataclass
class ClusterRunResult:
    """Object-level results of one cluster run (program or oracle)."""

    spec: ClusterSpec
    workload: ClusterWorkload
    compiled: CompiledCluster
    comp: np.ndarray            # per-event completions used for metrics
    converged: bool
    sweeps_used: int
    down: Optional[int] = None
    engine: str = "program"     # "program" | "oracle"

    @property
    def n_ops(self) -> int:
        return len(self.compiled.graph.op_tail)

    def op_latencies(self) -> np.ndarray:
        return op_latencies(self.compiled.graph, self.comp)

    def latency_stats(self) -> LatencyStats:
        return LatencyStats.from_samples(self.op_latencies())

    def makespan_us(self) -> float:
        return float(self.comp.max()) if len(self.comp) else 0.0

    def objects_per_sec(self) -> float:
        span = self.makespan_us()
        return self.n_ops / span * 1e6 if span > 0 else 0.0

    def slo_violation_rate(self, threshold_us: float) -> float:
        return violation_rate(self.op_latencies(), threshold_us)

    def summary(self) -> Dict[str, float]:
        lat = self.latency_stats()
        return {
            "n_ops": float(self.n_ops),
            "objects_per_sec": self.objects_per_sec(),
            "makespan_us": self.makespan_us(),
            "lat_mean_us": lat.mean_us, "lat_p50_us": lat.p50_us,
            "lat_p95_us": lat.p95_us, "lat_p99_us": lat.p99_us,
            "lat_p999_us": lat.p999_us,
            "converged": float(self.converged),
        }


class Cluster:
    """One rack, ready to compile and run workloads.

    :meth:`run` lowers the whole request flow to a single
    :class:`repro_torch.core.ChainProgram` and solves it on ``device``
    (``"cuda"`` by default, which raises without CUDA; ``"cpu"`` runs
    the plain versions); :meth:`run_oracle` runs the same event graph
    through the greedy per-server event engine on the host (small
    configs; differential testing).
    """

    def __init__(self, spec: Optional[ClusterSpec] = None, *,
                 device=DEFAULT_DEVICE):
        self.spec = spec if spec is not None else ClusterSpec()
        self.device = device

    def compile(self, workload: ClusterWorkload, *,
                down: Optional[int] = None, sweeps: int = 512,
                fixpoint: str = "auto", scan_backend: str = "auto",
                max_refine: int = MAX_REFINE,
                comp0=None) -> CompiledCluster:
        ops = workload.build(self.spec.n_gateways)
        graph = build_graph(self.spec, ops, qd=workload.qd, down=down,
                            seed=workload.seed, device=self.device)
        return compile_graph(graph, sweeps=sweeps, fixpoint=fixpoint,
                             scan_backend=scan_backend,
                             max_refine=max_refine, comp0=comp0,
                             device=self.device)

    def run(self, workload: ClusterWorkload, *, down: Optional[int] = None,
            sweeps: int = 512, fixpoint: str = "auto",
            scan_backend: str = "auto",
            max_refine: int = MAX_REFINE) -> ClusterRunResult:
        compiled = self.compile(workload, down=down, sweeps=sweeps,
                                fixpoint=fixpoint, scan_backend=scan_backend,
                                max_refine=max_refine)
        return ClusterRunResult(
            spec=self.spec, workload=workload, compiled=compiled,
            comp=compiled.comp, converged=compiled.converged,
            sweeps_used=compiled.sweeps_used, down=down, engine="program")

    def run_oracle(self, workload: ClusterWorkload, *,
                   down: Optional[int] = None) -> ClusterRunResult:
        ops = workload.build(self.spec.n_gateways)
        graph = build_graph(self.spec, ops, qd=workload.qd, down=down,
                            seed=workload.seed, device=self.device)
        comp = simulate_graph(graph)
        compiled = CompiledCluster(graph=graph, program=None, comp=comp,
                                   sweeps_used=0, converged=True)
        return ClusterRunResult(
            spec=self.spec, workload=workload, compiled=compiled, comp=comp,
            converged=True, sweeps_used=0, down=down, engine="oracle")
