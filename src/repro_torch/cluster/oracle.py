"""Differential oracle: greedy event-engine simulation of a cluster.

Runs the same :class:`~repro_torch.cluster.compiler.ClusterGraph` the chain
compiler lowers, but as a classical discrete-event simulation — a
priority queue of ready events keyed ``(ready, issue, index)`` (the
chain compiler's FIFO tie-breaking), one min-heap of server free times
per FIFO resource, and the fixed DAG (flow paths, gate edges, and the
sequential-log lag edges) as precedence.  Because a completion is never
earlier than its predecessors' ready times, pop order is nondecreasing
in ``ready`` and the greedy schedule is the exact M-server FIFO
solution — the reference the compiled program must match to float
tolerance on every config whose replayed chains froze
(``order_stable``), multi-class service mixes included (see
``tests/test_cluster.py``).  The oracle is a *test oracle only*: no
production path falls back to it.

This is the "per-server Python composition loop" the cluster bench
gates against: O(n log n) Python per config, versus one vectorized
fused-fixpoint solve for the whole concatenated sweep.
"""
from __future__ import annotations

import heapq
from typing import Dict, List

import numpy as np

from .compiler import ClusterGraph, _quantize


def simulate_graph(graph: ClusterGraph) -> np.ndarray:
    """Greedy completions (us, per event) of a cluster event graph."""
    n = graph.n
    edges = graph.dag_edges()
    succs: List[List[int]] = [[] for _ in range(n)]
    indeg = np.zeros(n, dtype=np.int64)
    for a, b in edges:
        succs[a].append(int(b))
        indeg[b] += 1
    # FIFO resource membership (at most one per event in this model;
    # ordered resources are already lag edges in the DAG).
    res_of = np.full(n, -1, dtype=np.int64)
    heaps: List[List[float]] = []
    for res in graph.resources:
        if res.ordered:
            continue
        rid = len(heaps)
        heaps.append([0.0] * res.cap)
        for m in res.members:
            if res_of[m] != -1:
                raise ValueError(
                    f"event {m} belongs to two FIFO resources; the "
                    f"oracle models at most one per event")
            res_of[m] = rid
    issue, svc = graph.issue, graph.svc
    q = _quantize               # shared pop-key grid (see compiler)
    ready = issue.copy()
    comp = np.zeros(n, dtype=np.float64)
    pq = [(float(q(issue[e])), issue[e], e)
          for e in range(n) if indeg[e] == 0]
    heapq.heapify(pq)
    done = 0
    while pq:
        _key, _isu, e = heapq.heappop(pq)
        start = ready[e]
        rid = res_of[e]
        if rid != -1:
            free = heapq.heappop(heaps[rid])
            start = max(start, free)
        c = start + svc[e]
        comp[e] = c
        if rid != -1:
            heapq.heappush(heaps[rid], c)
        done += 1
        for s in succs[e]:
            ready[s] = max(ready[s], c)
            indeg[s] -= 1
            if indeg[s] == 0:
                heapq.heappush(
                    pq, (float(q(max(ready[s], issue[s]))), issue[s], s))
    if done != n:
        raise ValueError(f"cluster graph has a dependency cycle: only "
                         f"{done}/{n} events completed")
    return comp


def oracle_op_latencies(graph: ClusterGraph) -> np.ndarray:
    """Per-object-op latencies under the greedy oracle schedule."""
    from .compiler import op_latencies
    return op_latencies(graph, simulate_graph(graph))


def touched_servers(graph: ClusterGraph, op_seq: int) -> set:
    """Servers an op's shard requests touch (for the degraded-mode
    blast-radius property: EC reconstruction adds exactly m)."""
    return {sh.server for sh in graph.plans[op_seq].shards}


def per_server_event_counts(graph: ClusterGraph) -> Dict[int, int]:
    """Device-event count per server (reads + flush appends)."""
    out = {r: 0 for r in range(len(graph.servers))}
    for res in graph.resources:
        if res.label.startswith(("dev_read/r", "dev_append/r")):
            out[int(res.label.split("/r")[1])] += len(res.members)
    return out
