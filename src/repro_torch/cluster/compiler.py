"""Cluster request flows -> one fleet-level :class:`ChainProgram`.

Lowering runs in two steps shared with the differential oracle:

1. :func:`build_graph` — expand every planned object op into its
   per-stage *event graph*: gateway CPU, EC encode, NIC tx, fabric
   link, server NIC rx, server CPU/buffer insert, device read, flush
   appends, ack path, and the op-level join; plus the structural
   couplings (closed-loop clients, writeback data/room gates,
   durability acks, read-after-flush).  The graph is a plain DAG +
   resource declaration — no schedule, no times beyond per-event
   ``issue``/``svc``.
2. :func:`compile_graph` — lower the graph to chain families:

   * each per-shard flow path becomes one chain in a per-slot family
     (``flow/s{j}`` — the op's fan-out head and join appear once per
     slot family, so family-scatter uniqueness holds);
   * every gate edge becomes a 2-chain, greedily colored into
     occurrence-split families (``wb_room/0``, ``wb_room/1``, ...);
   * *ordered* resources (the sequential-log flusher and its device
     append pool: chunks retire in log order) become round-robin
     lag-``cap`` chains in member order — exact for any service times;
   * *FIFO* resources (CPU pools, NIC lanes, device read pool) are
     replayed greedily in event-heap pop order ``(ready, issue,
     index)``: each pop takes the least-loaded server (min free time),
     exactly like the oracle's free-time heaps, and the per-server pop
     sequences become coupling chains.  ``ready`` depends on
     completions, so the compiler iterates: solve, recompute ``ready``
     from the DAG, re-replay, until the chains reach a fixpoint
     (``refine_used`` solves, ``order_stable``).  A stable replay
     reproduces the greedy event engine exactly for *any* service mix
     — multi-class pools included — so ``exact`` is simply
     ``order_stable``; exhaustion warns with the flapping pool labels
     (``unstable_pools``).

The compiled per-config programs are pure data: the capacity planner
concatenates dozens of them (:func:`repro_torch.core.concat_programs`) and
solves the whole rack sweep in ONE :func:`repro_torch.core.solve_program`
call.  Every solve here runs on ``device=`` (``"cuda"`` by default, which
raises without CUDA): with the default ``fixpoint="auto"`` that is one
launch of the CUDA fixpoint kernel a solve, and its plain PyTorch
version on the CPU; ``fixpoint="loop"`` runs the host loop around the
batched scan.  Graph building, the FIFO replay and the refinement loop
run on the host.
"""
from __future__ import annotations

import dataclasses
import heapq
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import ChainProgram, build_program, solve_program
from repro_torch.core.chain_program import unjustified_slots
from repro_torch.core.torch_device import DEFAULT_DEVICE

from .gateway import OpPlan, plan_workload
from .server import StorageServer
from .spec import ClusterSpec, ObjectOp

#: Refinement budget: pop-order fixpoints on closed-loop cluster flows
#: settle within ~10 solves on contended racks (each solve pushes order
#: corrections one coupling hop further); the cap guards rare ties.
MAX_REFINE = 24

#: FIFO pop keys are snapped to this grid (us) before ordering, in the
#: compiler AND the oracle: the two engines accumulate float64 sums in
#: different orders, so genuinely-tied ready times can differ by ~1e-9
#: us and flip a queue order.  On the shared grid both sides see the
#: same ties and break them identically (issue, then event index).
READY_QUANTUM_US = 1e-6


def _quantize(t: np.ndarray) -> np.ndarray:
    return np.round(np.asarray(t) / READY_QUANTUM_US) * READY_QUANTUM_US


@dataclasses.dataclass
class Resource:
    """A service pool: ``cap`` servers over ``members`` (event ids).

    ``ordered=True`` pins the retire order to the member list (the
    sequential-log flusher and its append pool); otherwise members are
    served FIFO in event-heap pop order.
    """

    label: str
    cap: int
    members: List[int] = dataclasses.field(default_factory=list)
    ordered: bool = False


@dataclasses.dataclass
class ClusterGraph:
    """The shared contract between compiler and oracle."""

    issue: np.ndarray                   # (n,) earliest event issue (us)
    svc: np.ndarray                     # (n,) jitter-free service (us)
    labels: List[str]                   # per-event stage tag (debug)
    paths: List[Tuple[str, List[List[int]]]]   # flow families
    edges: List[Tuple[str, int, int]]   # gate edges (name, pred, succ)
    resources: List[Resource]
    op_head: np.ndarray                 # (n_ops,) first event per op
    op_tail: np.ndarray                 # (n_ops,) completion event per op
    servers: List[StorageServer]
    plans: List[OpPlan]
    #: (n_ops, 2) contiguous [start, end) event slice of each op, in
    #: plan order — the warm-ladder slot mapping joins rungs on these.
    op_slices: Optional[np.ndarray] = None
    #: (client, per-client slot) identity of each op, in plan order.
    op_keys: Optional[List[Tuple[int, int]]] = None

    @property
    def n(self) -> int:
        return len(self.issue)

    def dag_edges(self) -> np.ndarray:
        """All fixed precedence edges ``(pred, succ)``: path links, gate
        edges, and ordered-resource lag edges (deduplicated)."""
        out = []
        for _label, chains in self.paths:
            for c in chains:
                out.extend(zip(c[:-1], c[1:]))
        for _name, a, b in self.edges:
            out.append((a, b))
        for res in self.resources:
            if res.ordered:
                m = res.members
                out.extend((m[i - res.cap], m[i])
                           for i in range(res.cap, len(m)))
        if not out:
            return np.zeros((0, 2), dtype=np.int64)
        return np.unique(np.asarray(out, dtype=np.int64), axis=0)


class _GraphBuilder:
    def __init__(self):
        self.issue: List[float] = []
        self.svc: List[float] = []
        self.labels: List[str] = []
        self.resources: Dict[str, Resource] = {}
        self.edges: List[Tuple[str, int, int]] = []
        self.paths: Dict[str, List[List[int]]] = {}

    def ev(self, label: str, svc: float, *, issue: float = 0.0,
           res: Optional[str] = None, cap: int = 1,
           ordered: bool = False) -> int:
        idx = len(self.issue)
        self.issue.append(float(issue))
        self.svc.append(float(svc))
        self.labels.append(label)
        if res is not None:
            self.join_resource(idx, res, cap, ordered)
        return idx

    def join_resource(self, idx: int, res: str, cap: int,
                      ordered: bool = False) -> None:
        r = self.resources.setdefault(
            res, Resource(label=res, cap=int(cap), ordered=ordered))
        r.members.append(idx)


def build_graph(spec: ClusterSpec, ops: Sequence[ObjectOp], *, qd: int = 1,
                down: Optional[int] = None, seed: int = 0,
                plans: Optional[List[OpPlan]] = None,
                device=DEFAULT_DEVICE) -> ClusterGraph:
    """Expand planned object ops into the cluster event graph.

    ``qd`` is the clients' closed-loop depth: op ``i`` of a client is
    gated on the ack (join) of its op ``i - qd``.  ``device`` is handed
    to the servers' volumes; building the graph runs on the host.
    """
    if plans is None:
        plans = plan_workload(spec, ops, seed=seed, down=down)
    net, gw, srv = spec.network, spec.gateway, spec.server
    b = _GraphBuilder()
    servers = [StorageServer(r, spec, device=device)
               for r in range(spec.n_servers)]
    op_head = np.zeros(len(ops), dtype=np.int64)
    op_tail = np.zeros(len(ops), dtype=np.int64)
    # Deferred per-server gates, resolved once flush counts are known:
    room_gates: List[Tuple[int, int, int]] = []   # (server, insert_ev, hi)
    ack_gates: List[Tuple[int, int, int]] = []    # (server, stx_ev, hi)
    read_gates: List[Tuple[int, int, int]] = []   # (server, dread_ev, hi)
    insert_evs: Dict[int, List[int]] = {r: [] for r in range(spec.n_servers)}
    op_slices = np.zeros((len(ops), 2), dtype=np.int64)
    op_keys: List[Tuple[int, int]] = [(0, 0)] * len(ops)
    client_slot: Dict[int, int] = {}

    for plan in plans:
        op = plan.op
        slot = client_slot.get(op.client, 0)
        client_slot[op.client] = slot + 1
        op_keys[op.seq] = (int(op.client), slot)
        op_slices[op.seq, 0] = len(b.issue)
        g = op.gateway
        head = b.ev("gw_cpu", gw.cpu_us, issue=op.issue,
                    res=f"gw_cpu/g{g}", cap=gw.cpu_cores)
        op_head[op.seq] = head
        src = head
        if plan.encode_us > 0.0:
            enc = b.ev("enc", plan.encode_us)
            b.edges.append(("enc", head, enc))
            src = enc
        join = b.ev("join", plan.decode_us)
        op_tail[op.seq] = join
        for sh in plan.shards:
            r = sh.server
            sv = servers[r]
            if sh.write:
                payload = sh.nbytes + net.req_bytes
                gtx = b.ev("gw_tx", net.gw_tx_us(payload),
                           res=f"gw_tx/g{g}", cap=1)
                lnk = b.ev("link", net.one_way_us)
                srx = b.ev("srv_rx", net.srv_tx_us(payload),
                           res=f"srv_rx/r{r}", cap=1)
                scpu = b.ev("insert", srv.cpu_us,
                            res=f"srv_cpu/r{r}", cap=srv.cpu_cores)
                stx = b.ev("srv_tx", net.srv_tx_us(net.req_bytes),
                           res=f"srv_tx/r{r}", cap=1)
                if sh.nbytes > 0:
                    if sh.nbytes > srv.writeback_bytes - srv.flush_chunk:
                        raise ValueError(
                            f"shard of {sh.nbytes} bytes cannot stage in "
                            f"a {srv.writeback_bytes}-byte writeback "
                            f"buffer (needs headroom of one flush chunk)")
                    _lo, hi = sv.insert_shard(op.obj, sh.slot, sh.nbytes)
                    insert_evs[r].append(scpu)
                    if sv.room_gate(hi) is not None:
                        room_gates.append((r, scpu, hi))
                    if spec.durability == "write-through":
                        ack_gates.append((r, stx, hi))
                lnk2 = b.ev("link", net.one_way_us)
                grx = b.ev("gw_rx", net.gw_tx_us(net.req_bytes),
                           res=f"gw_rx/g{g}", cap=1)
                chain = [src, gtx, lnk, srx, scpu, stx, lnk2, grx, join]
            else:
                resp = sh.nbytes + net.req_bytes
                gtx = b.ev("gw_tx", net.gw_tx_us(net.req_bytes),
                           res=f"gw_tx/g{g}", cap=1)
                lnk = b.ev("link", net.one_way_us)
                srx = b.ev("srv_rx", net.srv_tx_us(net.req_bytes),
                           res=f"srv_rx/r{r}", cap=1)
                scpu = b.ev("srv_cpu", srv.cpu_us,
                            res=f"srv_cpu/r{r}", cap=srv.cpu_cores)
                _lo, hi = sv.shard_range(op.obj, sh.slot)
                mid = []
                if sv.chunk_filled(hi):
                    # Bytes already flushable: read from flash (gated
                    # on the covering flush below).
                    dread = b.ev("dev_read", sv.read_svc(sh.nbytes),
                                 res=f"dev_read/r{r}",
                                 cap=spec.device_spec.read_parallelism)
                    read_gates.append((r, dread, hi))
                    mid = [dread]
                # else: the shard is still writeback-buffer resident —
                # served from RAM, no device event.
                stx = b.ev("srv_tx", net.srv_tx_us(resp),
                           res=f"srv_tx/r{r}", cap=1)
                lnk2 = b.ev("link", net.one_way_us)
                grx = b.ev("gw_rx", net.gw_tx_us(resp),
                           res=f"gw_rx/g{g}", cap=1)
                chain = [src, gtx, lnk, srx, scpu, *mid, stx, lnk2, grx,
                         join]
            b.paths.setdefault(f"flow/s{sh.slot}", []).append(chain)
        op_slices[op.seq, 1] = len(b.issue)

    # Closed loop: client op i waits for the ack of its op i - qd, and
    # clients prepare requests in program order (op i's gateway stage
    # follows op i-1's) — together these give read-your-writes at any
    # queue depth.
    per_client: Dict[int, List[int]] = {}
    for op in ops:
        per_client.setdefault(op.client, []).append(op.seq)
    for seqs in per_client.values():
        for i in range(1, len(seqs)):
            b.edges.append(("seq", int(op_head[seqs[i - 1]]),
                            int(op_head[seqs[i]])))
        for i in range(qd, len(seqs)):
            b.edges.append(("closed", int(op_tail[seqs[i - qd]]),
                            int(op_head[seqs[i]])))

    # Flushes: sequential log, one append per chunk, retiring in log
    # order (flush_qd deep through the device append pool).
    flush_evs: Dict[int, List[int]] = {}
    for r, sv in enumerate(servers):
        n_flush = sv.finalize()
        evs = []
        for _f in range(n_flush):
            fl = b.ev("flush", sv.append_svc(),
                      res=f"flush_q/r{r}", cap=srv.flush_qd, ordered=True)
            b.join_resource(fl, f"dev_append/r{r}",
                            spec.device_spec.append_parallelism,
                            ordered=True)
            evs.append(fl)
        flush_evs[r] = evs
        # wb_data: chunk f flushable once the insert filling it lands.
        for f, ins_idx in enumerate(sv.data_gate_inserts()):
            b.edges.append(("wb_data", insert_evs[r][int(ins_idx)], evs[f]))
    for r, scpu, hi in room_gates:
        b.edges.append(("wb_room",
                        flush_evs[r][servers[r].room_gate(hi)], scpu))
    for r, stx, hi in ack_gates:
        b.edges.append(("wt_ack",
                        flush_evs[r][servers[r].covering_flush(hi)], stx))
    for r, dread, hi in read_gates:
        b.edges.append(("rd_data",
                        flush_evs[r][servers[r].covering_flush(hi)], dread))

    return ClusterGraph(
        issue=np.asarray(b.issue, dtype=np.float64),
        svc=np.asarray(b.svc, dtype=np.float64),
        labels=b.labels,
        paths=sorted(b.paths.items()),
        edges=b.edges,
        resources=[b.resources[k] for k in sorted(b.resources)],
        op_head=op_head, op_tail=op_tail,
        servers=servers, plans=list(plans),
        op_slices=op_slices, op_keys=op_keys)


def edge_families(edges: Sequence[Tuple[str, int, int]]
                  ) -> List[Tuple[str, List[np.ndarray]]]:
    """Greedy edge coloring: 2-chains grouped into ``{name}/{occ}``
    families so no event repeats within a family."""
    occ: Dict[Tuple[str, int], int] = {}
    fams: Dict[str, List[np.ndarray]] = {}
    for name, a, b in edges:
        o = max(occ.get((name, a), 0), occ.get((name, b), 0))
        fams.setdefault(f"{name}/{o}", []).append(
            np.asarray([a, b], dtype=np.int64))
        occ[(name, a)] = occ[(name, b)] = o + 1
    return sorted(fams.items())


def _lag_chains(members: np.ndarray, cap: int) -> List[np.ndarray]:
    """Round-robin split: lag-``cap`` over the given member order.
    Used for *ordered* resources only, where retiring in member order
    is the resource's definition (the oracle models them as DAG lag
    edges, so round-robin is exact by construction)."""
    return [members[j::cap] for j in range(min(cap, len(members)))]


def _fifo_replay_chains(res: "Resource", graph: ClusterGraph,
                        ready: np.ndarray) -> List[np.ndarray]:
    """Greedy server assignment for one FIFO resource.

    Members are walked in event-heap pop order ``(quantized ready,
    issue, index)``; each pop takes the least-loaded server — min free
    time, exactly the oracle's per-resource free-time heap — and
    pushes ``max(free, ready) + svc`` back.  The per-server pop
    sequences become coupling chains.  Greedy ``min(free)`` depends
    only on the free-time *multiset*, so once ``ready`` is consistent
    with the solved completions the chains reproduce the oracle's
    begins exactly, for any mix of service classes."""
    m = np.asarray(res.members, dtype=np.int64)
    m = m[np.lexsort((m, graph.issue[m], _quantize(ready[m])))]
    heap = [(0.0, j) for j in range(res.cap)]
    chains: List[List[int]] = [[] for _ in range(res.cap)]
    for e, r, s in zip(m.tolist(), ready[m].tolist(),
                       graph.svc[m].tolist()):
        free, j = heap[0]
        heapq.heapreplace(heap, (max(free, r) + s, j))
        chains[j].append(e)
    return [np.asarray(c, dtype=np.int64) for c in chains if c]


def _chains_equal(a: List[np.ndarray], b: List[np.ndarray]) -> bool:
    return len(a) == len(b) and all(np.array_equal(x, y)
                                    for x, y in zip(a, b))


def _graph_ready(graph: ClusterGraph, edges: np.ndarray,
                 comp: np.ndarray) -> np.ndarray:
    """Event-heap pop keys: ``max(issue, DAG predecessors' comps)``."""
    ready = graph.issue.copy()
    if len(edges):
        np.maximum.at(ready, edges[:, 1], comp[edges[:, 0]])
    return ready


@dataclasses.dataclass
class CompiledCluster:
    """One cluster configuration lowered to a solvable program."""

    graph: ClusterGraph
    program: ChainProgram
    comp: np.ndarray          # completions from the final refinement solve
    sweeps_used: int
    converged: bool
    #: True when a caller-provided ``comp0`` warm start survived the
    #: tightness verification (False: cold, or verification fell back).
    warm_start_used: bool = False
    #: Final replayed FIFO pop-order chains (one list per contended
    #: unordered resource, in ``graph.resources`` order).  On a reused
    #: graph (identical slot indexing — e.g. a rate ladder's re-stamped
    #: rung) they are a valid ``chains0`` first iterate for the next
    #: :func:`compile_graph` call.
    fifo_chains: Optional[Tuple[Tuple[np.ndarray, ...], ...]] = None

    def op_latencies(self) -> np.ndarray:
        """Per-object-op latency: join completion minus the instant the
        closed loop let the op issue (``ready`` of its head event)."""
        return op_latencies(self.graph, self.comp)

    def makespan_us(self) -> float:
        return float(self.comp.max()) if len(self.comp) else 0.0


def op_latencies(graph: ClusterGraph, comp: np.ndarray) -> np.ndarray:
    """Per-op latency under completions ``comp`` (program or oracle)."""
    ready = _graph_ready(graph, graph.dag_edges(), comp)
    return comp[graph.op_tail] - ready[graph.op_head]


def _warm_refined_solve(program: ChainProgram, graph: ClusterGraph,
                        boot_comp: np.ndarray, cand: np.ndarray, *,
                        sweeps: int, fixpoint: str, scan_backend: str,
                        device=DEFAULT_DEVICE, max_rounds: int = 4):
    """One refined solve warm-started from ``max(boot_comp, cand)``,
    repaired slot-wise until provably exact.

    The candidate is not a certified lower bound, so the warm result is
    checked for tightness; any unjustified slot is necessarily one the
    candidate pushed above the least fixpoint (``boot_comp`` is a
    certified lower bound and converged scatters are justified by their
    predecessors), so those slots are dropped from the candidate and
    the solve re-runs.  Each round either ends tight — the positive
    service times make a tight point *the* least fixpoint, identical to
    a cold solve — or strictly shrinks the candidate.  After
    ``max_rounds`` (or a non-converged solve) the candidate is
    abandoned and the solve falls back to ``boot_comp`` alone.

    Returns ``(comp, used, converged, cand | None, warm_ok)``; the
    returned candidate keeps the pruning, so later refinement
    iterations skip the slots that already proved anomalous.
    """
    for rnd in range(max_rounds):
        comp, used, converged = solve_program(
            program, graph.svc, sweeps=sweeps, fixpoint=fixpoint,
            scan_backend=scan_backend, warn=False,
            comp0=np.maximum(boot_comp, cand), device=device)
        if not converged:
            break
        bad = unjustified_slots(program, graph.svc, comp)
        if bad.size == 0:
            return comp, used, converged, cand, True
        cand = np.array(cand, copy=True)
        cand[bad] = -np.inf
        if graph.op_slices is not None and len(graph.op_slices):
            # An anomalous slot rarely travels alone — its op's whole
            # chain is usually inflated with it, and unjustified_slots
            # only exposes the chain's *sources* (the rest is "justified"
            # by an inflated predecessor), which would unravel one slot
            # per round.  Dropping the enclosing op slices collapses the
            # repair to one or two rounds.
            starts = graph.op_slices[:, 0]
            op = np.searchsorted(starts, bad, side="right") - 1
            op = op[(op >= 0) & (bad < graph.op_slices[op, 1])]
            for s, e in graph.op_slices[np.unique(op)]:
                cand[s:e] = -np.inf
        if rnd >= 1:
            # Anomalies surviving a surgical round cascade: pruning an
            # inflated op exposes the next op it was justifying, two
            # slots at a time, past any round budget.  A converged
            # ``comp`` is a topological potential (service times are
            # positive, so every chain edge strictly increases it), so
            # the whole cascade lives at or above the earliest anomaly
            # — drop every candidate entry there in one cut.
            cand[cand >= comp[bad].min()] = -np.inf
    comp, used, converged = solve_program(
        program, graph.svc, sweeps=sweeps, fixpoint=fixpoint,
        scan_backend=scan_backend, warn=False, comp0=boot_comp,
        device=device)
    return comp, used, converged, None, False


def compile_graph(graph: ClusterGraph, *, sweeps: int = 512,
                  fixpoint: str = "auto", scan_backend: str = "auto",
                  max_refine: int = MAX_REFINE,
                  comp0: Optional[np.ndarray] = None,
                  order_seed: Optional[np.ndarray] = None,
                  chains0: Optional[Sequence[Sequence[np.ndarray]]] = None,
                  device=DEFAULT_DEVICE) -> CompiledCluster:
    """Lower a cluster graph to a ChainProgram, refining FIFO pop
    orders to their fixpoint (see module docstring).

    Every solve (the bootstrap, each refinement and each warm repair
    round) is one :func:`repro_torch.core.solve_program` call on
    ``device`` with the ``fixpoint`` driver.

    ``comp0`` carries candidate completion lower bounds (e.g. the
    previous capacity-ladder rung's completions mapped onto this
    graph's events).  The bootstrap solve ignores them — the DAG-only
    fixpoint sits *below* any contended solution, so a previous rung's
    completions would overshoot it — and the candidate instead seeds
    every *refined* solve as ``max(boot_comp, comp0)``.  Ladder rungs
    are not provably monotone (a bigger rung's greedy schedule can
    anomalously finish an op earlier), so each warm refined solve is
    accepted only once it is provably tight: every service time is
    positive, so a tight point is *the* least fixpoint, identical to
    the cold result.  Anomalous candidate slots are pruned and
    re-solved rather than discarding the whole candidate (see
    :func:`_warm_refined_solve`); ``warm_start_used`` reports whether
    the candidate survived.

    ``order_seed`` (completion estimates on this graph's slots, any
    coverage, exactness not required) seeds the initial FIFO pop-order
    estimate so refinement starts near the previous rung's replay
    orders instead of the contention-free bootstrap's.  It biases only
    the refinement *trajectory*, never a solved value.
    Refinement solves always warm-start from at least the bootstrap
    completions: the DAG-only constraints are a subset of every refined
    program's, so the bootstrap fixpoint is a valid lower bound.

    ``chains0`` (a previous compile's ``fifo_chains`` on a graph with
    identical slot indexing, e.g. the re-stamped previous rung of a
    rate ladder) replaces the first iteration's *replayed* chains
    outright, starting the trajectory at the previous rung's actual
    pop orders instead of a time-scale estimate of them (and skipping
    one replay walk).  When the rungs pop identically refinement
    confirms stability in two iterations; when they drift the usual
    replay loop takes over.  Like ``order_seed`` it biases only the
    trajectory: the accepted program still has to replay its own
    chains verbatim.
    """
    static: List[Tuple[str, List[np.ndarray]]] = []
    for label, chains in graph.paths:
        static.append((label, [np.asarray(c, dtype=np.int64)
                               for c in chains]))
    static.extend(edge_families(graph.edges))
    fifo_res: List[Resource] = []
    for res in graph.resources:
        if len(res.members) <= res.cap:
            continue                       # never queues: no chain needed
        if res.ordered:
            static.append((res.label, _lag_chains(
                np.asarray(res.members, dtype=np.int64), res.cap)))
        else:
            fifo_res.append(res)
    # Service-class metadata (diagnostics only: the greedy replay is
    # exact for any mix once the chains freeze).
    multiclass = tuple(sorted(
        res.label for res in fifo_res
        if res.cap > 1 and len(np.unique(graph.svc[res.members])) > 1))
    dag = graph.dag_edges()

    # Bootstrap pop-order estimates from a contention-free solve: the
    # DAG-only program (paths, gates, sequential-log lags — no FIFO
    # chains) is acyclic, so its fixpoint always converges, and its
    # completions order events by pure dependency depth.  Starting the
    # FIFO chains from index order instead can thread a chain against
    # the DAG and make the first refinement solve cyclic (divergent).
    base = build_program(graph.issue, graph.svc, static)
    cand = None if comp0 is None else np.array(comp0, dtype=np.float64)
    warm_used = False
    comp, used, converged = solve_program(
        base, graph.svc, sweeps=sweeps, fixpoint=fixpoint,
        scan_backend=scan_backend, warn=False, device=device)
    boot_comp = comp
    # ``order_seed`` seeds the *initial* pop-order estimate: the
    # previous rung's completions rank the contended events far closer
    # to this rung's replay fixpoint than the contention-free bootstrap
    # does, so refinement starts within a hop or two of its fixpoint
    # instead of re-discovering the queue orders from scratch.  The
    # loop's stability criterion (replayed chains reproduce themselves)
    # is unchanged — the seed only moves the starting point.  Slots the
    # seed does not cover fall back to the bootstrap completions.
    ready = _graph_ready(graph, dag, comp if order_seed is None
                         else np.maximum(comp, order_seed))
    prev_chains: Optional[List[List[np.ndarray]]] = None
    program: ChainProgram = base
    refine_used, order_stable = 0, not fifo_res
    for it in range(max_refine + 1):
        if it == 0 and chains0 is not None and len(chains0) == len(fifo_res):
            rchains = [[np.asarray(c, dtype=np.int64) for c in ch]
                       for ch in chains0]
        else:
            rchains = [_fifo_replay_chains(r, graph, ready)
                       for r in fifo_res]
        if prev_chains is not None and \
                all(_chains_equal(a, p)
                    for a, p in zip(rchains, prev_chains)):
            order_stable = True
            break
        fams = list(static)
        for r, ch in zip(fifo_res, rchains):
            fams.append((r.label, ch))
        program = build_program(
            graph.issue, graph.svc, fams,
            exact=False, multiclass_pools=multiclass)
        if cand is None:
            comp, used, converged = solve_program(
                program, graph.svc, sweeps=sweeps, fixpoint=fixpoint,
                scan_backend=scan_backend, warn=False, comp0=boot_comp,
                device=device)
        else:
            comp, used, converged, cand, ok = _warm_refined_solve(
                program, graph, boot_comp, cand, sweeps=sweeps,
                fixpoint=fixpoint, scan_backend=scan_backend, device=device)
            warm_used = warm_used or ok
        refine_used = it + 1
        ready = _graph_ready(graph, dag, comp)
        prev_chains = rchains
    unstable: List[str] = []
    if not order_stable:
        # Budget exhausted: report which FIFO pools are still flapping
        # instead of silently downgrading the program to ``exact=False``.
        nxt = [_fifo_replay_chains(r, graph, ready) for r in fifo_res]
        unstable = [r.label for r, a, p in
                    zip(fifo_res, nxt, prev_chains or nxt)
                    if not _chains_equal(a, p)] or \
            [r.label for r in fifo_res]
        warnings.warn(
            f"cluster order refinement exhausted max_refine={max_refine} "
            f"without pop-order fixpoint; unstable FIFO pools: "
            f"{', '.join(unstable)} — program marked order_stable=False "
            f"(raise max_refine on Cluster.run/compile_graph, or pass "
            f"--max-refine on the CLI)", RuntimeWarning, stacklevel=2)
    program = dataclasses.replace(
        program, refine_used=refine_used, order_stable=order_stable,
        exact=bool(order_stable), unstable_pools=tuple(unstable))
    return CompiledCluster(graph=graph, program=program, comp=comp,
                           sweeps_used=used, converged=bool(converged),
                           warm_start_used=warm_used,
                           fifo_chains=tuple(tuple(ch) for ch in rchains))
