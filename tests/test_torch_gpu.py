"""The port's CUDA kernels held against their plain PyTorch versions on
the card, and the serving path with the kernels against it with the plain
versions.  Every test here is marked ``gpu`` and skips without a CUDA
device; the file imports only ``repro_torch``, so it runs on a machine
without JAX::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import ctypes

import numpy as np
import pytest
import torch

from repro_torch import models as M
from repro_torch.configs import get_smoke_config
from repro_torch.core import DeviceFleet, KiB, OpType, WorkloadSpec, \
    ZnsDevice, compile_fleet_program, compile_program, compute_service_times
from repro_torch.distributed import comm, launch
from repro_torch.distributed.mesh import Mesh, shard_map
from repro_torch.distributed.ring_attention import ring_attention
from repro_torch.distributed.sharding import PartitionSpec as PS
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as pfa
from repro_torch.kernels import linear_recurrence as plr
from repro_torch.kernels import ops, ref, zns_event_scan as pscan
from repro_torch.kernels import rmsnorm as prms
from repro_torch.kernels import ssd_chunk_scan as pssd
from repro_torch.kernels import zns_fixpoint as pfix
from repro_torch.serve import greedy_generate

F32_SCAN = dict(rtol=1e-5, atol=1e-2)
F32_FIX = dict(rtol=2e-5, atol=1e-2)
F64 = dict(rtol=1e-12, atol=1e-9)
#: The reference kernel tests' tolerances (tests/test_kernels.py).
ATTN_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
RMS_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
#: SSD scan, kernel against plain version: both compute in float32 and
#: differ in summation order only (the reference's atol 1e-3); in
#: bfloat16 y may differ by one rounding step (2^-7 relative).
SSD_TOL = {torch.float32: dict(rtol=0.0, atol=1e-3),
           torch.bfloat16: dict(rtol=1e-2, atol=2e-2)}
#: Linear recurrence: the reference kernel test's tolerance.
LR_TOL = dict(rtol=1e-3, atol=2e-3)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _scan_inputs(rng, shape):
    issue = np.sort(rng.uniform(0, 1e5, shape), axis=-1)
    svc = rng.uniform(1, 50, shape)
    seg = rng.uniform(size=shape) < 0.05
    seg[..., 0] = True
    return issue, svc, seg


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_SCAN),
                                       (torch.float64, F64)])
@pytest.mark.parametrize("bsz,n", [(1, 7), (3, 1000), (4, 70_000)])
def test_scan_kernel_matches_plain_on_card(cuda_device, dtype, tol, bsz, n):
    issue, svc, seg = _scan_inputs(np.random.default_rng(n), (bsz, n))
    args = [torch.as_tensor(x, dtype=dtype, device=cuda_device)
            for x in (issue, svc)] + [torch.as_tensor(seg,
                                                      device=cuda_device)]
    before = pscan.zns_event_scan_batched.launches
    got = ops.zns_event_scan_batched(*args, impl="cuda")
    want = ops.zns_event_scan_batched(*args, impl="torch")
    torch.cuda.synchronize()
    assert pscan.zns_event_scan_batched.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **tol)
    row = ops.zns_event_scan(*[a[-1] for a in args], impl="cuda")
    np.testing.assert_array_equal(row.cpu().numpy(), got[-1].cpu().numpy())


def _program(case: str):
    dev = ZnsDevice(device="cpu")
    if case == "pool-resets":
        wl = WorkloadSpec()
        for t in range(3):
            wl = wl.appends(n=60, size=8 * KiB, qd=2, zone=t * 4, nzones=4)
        wl = wl.resets(n=8, occupancy=1.0, nzones=8, zone=600)
    elif case == "padding":
        wl = (WorkloadSpec()
              .appends(n=40, size=8 * KiB, qd=4, zone=0, nzones=4)
              .appends(n=64, size=8 * KiB, qd=4, zone=4, nzones=4))
    else:
        wl = (WorkloadSpec()
              .writes(n=6000, size=4 * KiB, qd=4, zone=0)
              .reads(n=6000, size=4 * KiB, qd=16, zone=100, nzones=64)
              .resets(n=10, occupancy=1.0, io_ctx=OpType.WRITE))
    return compile_program(wl.build(), dev.spec, dev.lat, cache=False)


@pytest.mark.parametrize("case", ["pool-resets", "padding", "readme-mix"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fixpoint_kernel_matches_plain_on_card(cuda_device, case, dtype):
    prog = _program(case)
    svc = prog.svc0_flat
    packed = pfix.pack_blocks([b.rows_view() for b in prog.families],
                              prog.n_flat, cuda_device)
    c0 = torch.as_tensor(prog.issue_flat + svc, dtype=dtype,
                         device=cuda_device)
    s = torch.as_tensor(svc, dtype=dtype, device=cuda_device)
    before = pfix.zns_fixpoint.launches
    got = ops.zns_fixpoint(c0, s, packed, sweeps=16, impl="cuda")
    want = ops.zns_fixpoint(c0, s, packed, sweeps=16, impl="torch")
    assert pfix.zns_fixpoint.launches == before + 1
    tol = F64 if dtype == torch.float64 else F32_FIX
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].cpu().numpy(),
                               **tol)
    assert got[2] == want[2] and got[2]
    if dtype == torch.float64:
        assert got[1] == want[1]


#: Elements a tile of the CUDA scan (``csrc/zns_event_scan.cu``).
SCAN_TILE = 2048


def _heads(kind, n, rng):
    seg = np.zeros(n, dtype=bool)
    if kind == "every":
        seg[:] = True
    elif kind == "tile_starts":
        seg[::SCAN_TILE] = True
    elif kind == "first_only":
        seg[0] = True
    else:
        seg = rng.uniform(size=n) < 0.01
    return seg


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_SCAN),
                                       (torch.float64, F64)])
@pytest.mark.parametrize("heads", ["every", "tile_starts", "first_only",
                                   "random"])
@pytest.mark.parametrize("n", [1, SCAN_TILE - 1, SCAN_TILE, SCAN_TILE + 1,
                               5_000_000])
def test_scan_kernel_tile_edges_match_plain_on_card(cuda_device, n, heads,
                                                    dtype, tol):
    """Rows of one element, one tile +- 1, and longer than one resident
    round of the grid (5M elements: 2,442 tiles on 792 resident blocks);
    heads everywhere (in float32 the -1e30 sentinel then sums over every
    element), at tile starts only, or at element 0 only.  The 1-D call
    equals the batched call's row bit for bit, and two calls are
    bit-equal."""
    rng = np.random.default_rng(n)
    issue = np.sort(rng.uniform(0, 1e6, (2, n)), axis=-1)
    svc = rng.uniform(1, 50, (2, n))
    seg = np.stack([_heads("random", n, rng), _heads(heads, n, rng)])
    args = [torch.as_tensor(x, dtype=dtype, device=cuda_device)
            for x in (issue, svc)] + [torch.as_tensor(seg,
                                                      device=cuda_device)]
    got = ops.zns_event_scan_batched(*args, impl="cuda")
    want = ops.zns_event_scan_batched(*args, impl="torch")
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **tol)
    row = ops.zns_event_scan(*[a[-1] for a in args], impl="cuda")
    assert torch.equal(row, got[-1])
    assert torch.equal(ops.zns_event_scan(*[a[-1] for a in args],
                                          impl="cuda"), row)
    launch = pscan.zns_event_scan.last_launch
    assert launch["grid"] == min(-(-n // SCAN_TILE),
                                 launch["resident_blocks"])


def test_scan_kernel_matches_sequential_oracle_on_card(cuda_device):
    """Float64 against the port's sequential oracle, not the doubling
    plain version."""
    rng = np.random.default_rng(3)
    issue = np.sort(rng.uniform(0, 1e5, 20_000))
    svc = rng.uniform(1, 50, 20_000)
    seg = rng.uniform(size=20_000) < 0.003
    args = [torch.as_tensor(x, device=cuda_device) for x in (issue, svc, seg)]
    got = ops.zns_event_scan(*args, impl="cuda")
    want = ops.zns_event_scan(*[a.cpu() for a in args], impl="ref")
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **F64)


def _contended_fleet_program():
    """Phase 5's program of chip_smoke.py: a contended ours / nvmevirt /
    femu fleet of multi-class append pools with resets (5 blocks)."""
    wl = WorkloadSpec()
    for t in range(4):
        wl = wl.appends(n=5000, size=8 * KiB, qd=4, zone=t * 4, nzones=4)
        wl = wl.appends(n=5000, size=64 * KiB, qd=4, zone=t * 4, nzones=4)
    wl = wl.resets(n=200, occupancy=1.0, nzones=200, io_ctx=OpType.APPEND,
                   zone=500)
    fleet = DeviceFleet.from_profiles(["ours", "nvmevirt", "femu"],
                                      device="cpu")
    traces = fleet._lower(wl, "replicate")
    prog = compile_fleet_program(traces, fleet.specs,
                                 [d.lat for d in fleet.devices], jitter=True,
                                 seeds=[0, 1, 2], cache=False)
    svc = np.concatenate([
        compute_service_times(traces[b], fleet.devices[b].lat,
                              seed=b)[prog.orders[b]] for b in range(3)])
    return prog.issue_flat, svc, [b.rows_view() for b in prog.families]


def _chains(rows, length, start, stride):
    """(rows, length) gather indices start + stride * k of disjoint
    chains, heads at every row start."""
    g = start + stride * np.arange(rows * length).reshape(rows, length)
    h = np.zeros((rows, length), dtype=bool)
    h[:, 0] = True
    return g.astype(np.int32), h


def _hand_program(case, rng):
    """Small programs built by hand: ``one-sweep`` (two blocks over
    disjoint slots, so no block re-activates another), ``single`` (one
    block), ``empty-family`` (a block of zero rows between two real
    ones, which share slots)."""
    if case == "one-sweep":
        n = 2 * 40 * 50
        blocks = [_chains(40, 50, 0, 2), _chains(40, 50, 1, 2)]
    elif case == "single":
        n = 64 * 300
        blocks = [_chains(64, 300, 0, 1)]
    else:
        n = 30 * 70
        # rows of 70 consecutive slots, and a second block linking slot 60
        # of rows 0-2 to slot 5 of the next row (re-activating block 0)
        links = (70 * np.arange(3)[:, None] + [60, 75]).astype(np.int32)
        hl = np.array([[True, False]] * 3)
        blocks = [_chains(30, 70, 0, 1),
                  (np.zeros((0, 5), np.int32), np.zeros((0, 5), bool)),
                  (links, hl)]
    issue = np.sort(rng.uniform(0, 1e4, n))
    svc = rng.uniform(1, 50, n)
    return issue, svc, blocks


def _solve_both(cuda_device, issue, svc, blocks, sweeps, dtype):
    packed = pfix.pack_blocks(blocks, len(issue), cuda_device)
    c0 = torch.as_tensor(issue + svc, dtype=dtype, device=cuda_device)
    s = torch.as_tensor(svc, dtype=dtype, device=cuda_device)
    got = ops.zns_fixpoint(c0, s, packed, sweeps=sweeps, impl="cuda")
    want = ops.zns_fixpoint(c0, s, packed, sweeps=sweeps, impl="torch")
    tol = F64 if dtype == torch.float64 else F32_FIX
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].cpu().numpy(),
                               **tol)
    if dtype == torch.float64:
        assert (got[1], got[2]) == (want[1], want[2])
    return got, want


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fixpoint_kernel_contended_fleet_program_on_card(cuda_device, dtype):
    """Phase 5's program at its budget of 64 sweeps: the same sweeps and
    convergence as the plain version, converged."""
    issue, svc, blocks = _contended_fleet_program()
    got, want = _solve_both(cuda_device, issue, svc, blocks, 64, dtype)
    assert got[2] and want[2]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["one-sweep", "single", "empty-family"])
def test_fixpoint_kernel_hand_programs_on_card(cuda_device, case, dtype):
    got, want = _solve_both(cuda_device,
                            *_hand_program(case, np.random.default_rng(7)),
                            16, dtype)
    assert got[2]
    if case in ("one-sweep", "single"):
        assert got[1] == want[1] == 1


#: Block shapes around the fixpoint kernel's 2,048-lane tile: rows of up
#: to a tile pack ``2048 // L`` to a tile, longer rows span tiles.
PACKED_SHAPES = ((5000, 1), (3000, 2), (1000, 3), (77, 5), (9, 700),
                 (5, 1023), (4, 1024), (3, 1025), (2, 2047), (2, 2048),
                 (2, 2049), (1, 4097))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fixpoint_kernel_packed_rows_on_card(cuda_device, dtype):
    """Blocks of every shape around the tile, each over its own slots in
    a random order, with random segment heads (a row's first lane not
    always one): the kernel packs the short rows, and its completions,
    sweeps and convergence equal the plain version's.  (The runner's
    program, above, has packed blocks that re-activate each other.)"""
    rng = np.random.default_rng(17)
    blocks, n = [], 0
    for rows, length in PACKED_SHAPES:
        g = n + rng.permutation(rows * length).reshape(rows, length)
        n += rows * length
        blocks.append((g.astype(np.int32),
                       rng.uniform(size=(rows, length)) < 0.05))
    issue = np.sort(rng.uniform(0, 1e5, n))
    svc = rng.uniform(1, 50, n)
    got, want = _solve_both(cuda_device, issue, svc, blocks, 64, dtype)
    assert got[2] and want[2]
    assert pfix.zns_fixpoint.last_launch["grid"] == max(
        pfix.block_tiles(r, l, 2048) for r, l in PACKED_SHAPES)


def test_fixpoint_kernel_budget_runs_out_on_card(cuda_device):
    """One sweep of a program that needs two: not converged, and equal to
    the plain version's one sweep (completions, sweeps, flag)."""
    prog = _program("readme-mix")
    svc = prog.svc0_flat
    blocks = [b.rows_view() for b in prog.families]
    full, _ = _solve_both(cuda_device, prog.issue_flat, svc, blocks, 16,
                          torch.float64)
    assert full[1] >= 2
    got, want = _solve_both(cuda_device, prog.issue_flat, svc, blocks, 1,
                            torch.float64)
    assert got[1] == 1 and not got[2] and not want[2]


def test_fixpoint_kernel_block_counts_in_any_order_on_card(cuda_device):
    """Solves of 5, 1, 3 and again 5 blocks in one process: each launch
    fits its shared memory (the kernel's opt-in is not narrowed by an
    earlier, smaller solve)."""
    rng = np.random.default_rng(9)
    progs = [_contended_fleet_program(), _hand_program("single", rng),
             _hand_program("empty-family", rng)]
    for issue, svc, blocks in progs + progs[:1]:
        got, _ = _solve_both(cuda_device, issue, svc, blocks, 64,
                             torch.float64)
        assert got[2]


@pytest.mark.parametrize("sweeps", [8, 64])
def test_fixpoint_solve_is_one_device_kernel_on_card(cuda_device, sweeps):
    """torch.profiler sees one device kernel a solve, whatever the sweep
    budget (the state read back is a copy, not a kernel).  The profiler
    can miss every device event of a profiled window (seen on the card),
    so three solves are profiled, as for the sharded solve: none may show
    more than one kernel, and at least one must show exactly the
    fixpoint kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    issue, svc, blocks = _contended_fleet_program()
    packed = pfix.pack_blocks(blocks, len(issue), cuda_device)
    c0 = torch.as_tensor(issue + svc, device=cuda_device)
    s = torch.as_tensor(svc, device=cuda_device)
    ops.zns_fixpoint(c0, s, packed, sweeps=sweeps, impl="cuda")
    torch.cuda.synchronize()
    seen = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            ops.zns_fixpoint(c0, s, packed, sweeps=sweeps, impl="cuda")
            torch.cuda.synchronize()
        seen.append([e.name for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     and not e.name.startswith(("Memcpy", "Memset"))])
    assert all(len(k) <= 1 for k in seen), seen
    assert any(len(k) == 1 and "fp_solve_kernel" in k[0] for k in seen), seen


def test_sharded_solve_is_one_device_kernel_on_card(cuda_device):
    """One stacked solve is one launch and one device kernel, that of the
    instance stack_launch picked.  The profiler can miss every device event
    of a profiled window (seen on the card), so three solves are profiled:
    none may show more than one kernel, and at least one must show exactly
    the fixpoint kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(2)
    shards = _shards_of_shapes(rng, [PACKED_SHAPES[:4], PACKED_SHAPES[4:]],
                               (True, True))
    packed = pfix.pack_shards([(b, len(i), None) for i, _, b in shards],
                              cuda_device)
    c0 = torch.zeros(packed.total, dtype=torch.float64, device=cuda_device)
    for (i, s, _), b in zip(shards, packed.base):
        c0[b:b + len(i)] = torch.as_tensor(i + s)
    sv = torch.ones_like(c0)
    ops.zns_fixpoint_sharded(c0, sv, packed, sweeps=16, impl="cuda")
    torch.cuda.synchronize()
    seen = []
    for _ in range(3):
        before = pfix.zns_fixpoint_sharded.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            ops.zns_fixpoint_sharded(c0, sv, packed, sweeps=16, impl="cuda")
            torch.cuda.synchronize()
        assert pfix.zns_fixpoint_sharded.launches == before + 1
        seen.append([e.name for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     and not e.name.startswith(("Memcpy", "Memset"))])
    assert all(len(k) <= 1 for k in seen), seen
    kernel = {"cluster": "fp_cluster_kernel", "grid": "fp_stack_kernel"}[
        pfix.zns_fixpoint_sharded.last_launch["instance"]]
    assert any(len(k) == 1 and kernel in k[0] for k in seen), seen


def test_device_run_matches_host_loop_on_card(cuda_device):
    dev = ZnsDevice(device=cuda_device)
    wl = (WorkloadSpec()
          .writes(n=3000, size=4 * KiB, qd=4, zone=0)
          .reads(n=3000, size=4 * KiB, qd=16, zone=100, nzones=64)
          .resets(n=10, occupancy=1.0, io_ctx=OpType.WRITE))
    got = dev.run(wl, backend="vectorized")
    want = dev.run(wl, backend="vectorized", fixpoint="loop",
                   scan_backend="numpy")
    assert got.solve_stats.driver == "cuda" and got.converged
    np.testing.assert_allclose(got.sim.complete, want.sim.complete, **F64)


@pytest.mark.parametrize("b,hq,hkv,tq,tk,d,window", [
    (1, 4, 4, 128, 128, 64, None),     # causal, tq == tk
    (2, 8, 2, 100, 100, 64, None),     # GQA, ragged tiles
    (1, 4, 1, 64, 256, 128, None),     # tq < tk, end-aligned
    (1, 2, 2, 1, 300, 128, None),      # one decode-like query
    (2, 4, 2, 37, 37, 32, None),
    (1, 4, 2, 200, 200, 16, None),
    (1, 8, 2, 512, 512, 64, 256),      # local window
    (1, 4, 2, 100, 160, 32, 16),       # window with tq < tk
    (2, 4, 1, 200, 200, 256, None),    # recurrentgemma's head dim
    (1, 4, 1, 300, 300, 256, 128),     # ... with a local window
    (1, 2, 1, 129, 129, 128, None),    # one row past a 128-row q tile
    (1, 4, 2, 191, 320, 64, None),     # ragged q and k tiles, tq < tk
    (1, 4, 2, 300, 300, 128, 100),     # window edge inside a K tile
    (1, 2, 1, 129, 190, 256, None),    # D 256, ragged lengths
    (2, 2, 1, 191, 191, 256, 77),      # D 256, ragged, window mid-tile
    (1, 4, 2, 200, 70, 64, None),      # tq > tk: the first rows see no key
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain_on_card(cuda_device, b, hq, hkv,
                                                      tq, tk, d, window,
                                                      dtype):
    rng = np.random.default_rng(tq * 7 + tk + d)
    q, k, v = (torch.as_tensor(rng.standard_normal(s), dtype=torch.float32)
               .to(cuda_device, dtype) for s in
               ((b, hq, tq, d), (b, hkv, tk, d), (b, hkv, tk, d)))
    before = pfa.flash_attention.launches
    got = ops.attention(q, k, v, window=window, impl="cuda")
    want = ops.attention(q, k, v, window=window, impl="torch")
    torch.cuda.synchronize()
    assert pfa.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               atol=ATTN_TOL[dtype])


def test_flash_attention_kernel_takes_strided_views_on_card(cuda_device):
    """The model's (B, S, H, D) -> (B, H, S, D) views go in uncopied and
    the output comes back in the same layout."""
    rng = np.random.default_rng(11)
    q, k, v = (torch.as_tensor(rng.standard_normal(s), dtype=torch.float32)
               .to(cuda_device).movedim(2, 1) for s in
               ((2, 70, 8, 64), (2, 70, 2, 64), (2, 70, 2, 64)))
    got = ops.attention(q, k, v, impl="cuda")
    want = ops.attention(q.contiguous(), k.contiguous(), v.contiguous(),
                         impl="torch")
    assert got.stride() == q.stride()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=2e-4)


@pytest.mark.parametrize("d", [16, 64, 128, 256])
def test_flash_attention_tile_products_match_matmul_on_card(cuda_device, d):
    """The bfloat16 kernel's two wgmma products on one 64-row tile (its
    swizzled tiles, descriptors and fragment layouts) against float32
    torch.matmul: S = q k^T (bf16 products are exact in float32; the sums
    differ in order), and O = bf16(S) v from the kernel's own S, so that a
    rounding flip of S cannot move O.  A layout fault moves values by
    O(1)."""
    rng = np.random.default_rng(d)
    q, k, v = (torch.as_tensor(rng.standard_normal((64, d)),
                               dtype=torch.float32).to(cuda_device,
                                                       torch.bfloat16)
               for _ in range(3))
    s, o = pfa.tile_products(q, k, v)
    torch.cuda.synchronize()
    s_want = q.float() @ k.float().T
    o_want = s.to(torch.bfloat16).float() @ v.float()
    np.testing.assert_allclose(s.cpu().numpy(), s_want.cpu().numpy(),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(o.cpu().numpy(), o_want.cpu().numpy(),
                               rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
def test_flash_attention_bwd_tile_products_match_matmul_on_card(cuda_device,
                                                                d):
    """The bfloat16 backward's register-A wgmma with an MN-major B over a
    64-row depth (the shape of P^T dO, dS^T Q and dS K a warpgroup): a
    float32 tile in the accumulator fragment's layout, rounded to bf16, times
    a (64, D) tile, against float32 torch.matmul of the same rounded
    operands (bf16 products are exact in float32; the sums differ in
    order).  A descriptor or layout fault moves values by O(1)."""
    rng = np.random.default_rng(d + 7)
    a = torch.as_tensor(rng.standard_normal((64, 64)),
                        dtype=torch.float32).to(cuda_device)
    b = torch.as_tensor(rng.standard_normal((64, d)),
                        dtype=torch.float32).to(cuda_device, torch.bfloat16)
    got = pfa.bwd_tile_products(a, b)
    torch.cuda.synchronize()
    want = a.cpu().to(torch.bfloat16).float() @ b.cpu().float()
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-3)


def test_flash_attention_rows_before_the_keys_are_zero_on_card(cuda_device):
    """tq > tk, causal: queries at positions below 0 see no key and write
    exactly 0 in bfloat16 as in float32."""
    rng = np.random.default_rng(5)
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (torch.as_tensor(rng.standard_normal(s),
                                   dtype=torch.float32).to(cuda_device, dtype)
                   for s in ((1, 4, 200, 128), (1, 2, 70, 128),
                             (1, 2, 70, 128)))
        got = ops.attention(q, k, v, impl="cuda")
        torch.cuda.synchronize()
        assert bool((got[:, :, :130] == 0).all())
        assert bool(got[:, :, 130:].abs().amax(-1).gt(0).all())


@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_attention_kernel_takes_bf16_strided_views_on_card(cuda_device,
                                                                 d):
    """bfloat16 (B, S, H, D) -> (B, H, S, D) views go in uncopied (16-byte
    aligned rows) and the output comes back in the same layout."""
    rng = np.random.default_rng(d + 1)
    q, k, v = (torch.as_tensor(rng.standard_normal(s), dtype=torch.float32)
               .to(cuda_device, torch.bfloat16).movedim(2, 1) for s in
               ((2, 150, 8, d), (2, 150, 2, d), (2, 150, 2, d)))
    assert pfa._fits(q) and pfa._fits(k) and pfa._fits(v)
    got = ops.attention(q, k, v, impl="cuda")
    want = ops.attention(q.contiguous(), k.contiguous(), v.contiguous(),
                         impl="torch")
    assert got.stride() == q.stride()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               atol=ATTN_TOL[torch.bfloat16])


def test_flash_attention_copies_misaligned_bf16_views_on_card(cuda_device):
    """A bfloat16 view whose rows do not start 16-byte aligned is copied to
    contiguous before the launch, and the result is unchanged."""
    rng = np.random.default_rng(3)
    flat = torch.as_tensor(rng.standard_normal(1 + 2 * 4 * 96 * 64),
                           dtype=torch.float32).to(cuda_device,
                                                   torch.bfloat16)
    q = flat[1:].view(2, 4, 96, 64)
    k = torch.as_tensor(rng.standard_normal((2, 2, 96, 64)),
                        dtype=torch.float32).to(cuda_device, torch.bfloat16)
    v = k.flip(2)
    assert not pfa._fits(q)
    got = ops.attention(q, k, v, window=40, impl="cuda")
    want = ops.attention(q, k, v, window=40, impl="torch")
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               atol=ATTN_TOL[torch.bfloat16])


#: Backward kernels against their plain versions on the same forward
#: outputs (o, lse): both compute in float32 and differ in summation order
#: (and by the last rounding to bfloat16).
BWD_TOL = {torch.float32: dict(rtol=1e-3, atol=1e-3),
           torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


def _attn_inputs(device, dtype, b, hq, hkv, tq, tk, d, seed):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal(s), dtype=torch.float32)
            .to(device, dtype) for s in ((b, hq, tq, d), (b, hkv, tk, d),
                                         (b, hkv, tk, d), (b, hq, tq, d))]


@pytest.mark.parametrize("b,hq,hkv,tq,tk,d,window,causal", [
    (1, 4, 4, 128, 128, 64, None, True),
    (2, 8, 2, 100, 100, 64, None, True),      # GQA 4, ragged tiles
    (1, 8, 1, 64, 256, 128, None, True),      # GQA 8, tq < tk
    (2, 4, 2, 37, 37, 32, None, True),
    (1, 4, 2, 200, 200, 16, None, True),
    (1, 8, 2, 512, 512, 64, 256, True),       # local window
    (1, 4, 2, 100, 160, 32, 16, True),        # window with tq < tk
    (1, 4, 2, 300, 300, 128, 100, True),      # window edge inside a tile
    (1, 4, 2, 200, 70, 64, None, True),       # tq > tk: rows see no key
    (1, 2, 1, 90, 90, 128, None, False),      # not causal
    (1, 32, 4, 256, 256, 64, None, True),     # tinyllama's heads
    (1, 16, 1, 512, 512, 256, 128, True),     # recurrentgemma's MQA, window
    (2, 4, 1, 200, 200, 256, None, True),     # D 256, ragged tiles
    (1, 4, 2, 300, 300, 256, 77, True),       # D 256, window edge mid-tile
    (1, 4, 1, 96, 160, 256, 40, True),        # D 256, tq < tk, window
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_bwd_kernel_matches_plain_on_card(cuda_device, b, hq, hkv,
                                                    tq, tk, d, window,
                                                    causal, dtype):
    q, k, v, do = _attn_inputs(cuda_device, dtype, b, hq, hkv, tq, tk, d,
                               tq + 3 * tk + d)
    out, lse = pfa.flash_attention(q, k, v, causal=causal, window=window,
                                   return_lse=True)
    _, lse_plain = pfa.attention_torch(q, k, v, causal=causal,
                                       window=window, return_lse=True)
    seen = torch.isfinite(lse_plain)
    assert bool((torch.isfinite(lse) == seen).all())
    np.testing.assert_allclose(lse[seen].cpu().numpy(),
                               lse_plain[seen].cpu().numpy(), atol=1e-4)
    before = pfa.flash_attention_bwd.launches
    got = pfa.flash_attention_bwd(q, k, v, out, do, lse, causal=causal,
                                  window=window)
    want = pfa.attention_bwd_torch(q, k, v, out, do, lse, causal=causal,
                                   window=window)
    torch.cuda.synchronize()
    assert pfa.flash_attention_bwd.launches == before + 1
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.dtype == dtype and g.shape == t.shape
        np.testing.assert_allclose(g.float().cpu().numpy(),
                                   w.float().cpu().numpy(), **BWD_TOL[dtype])
    if not bool(seen.all()):      # rows that see no key: dq is 0
        assert bool((got[0][~seen] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_bwd_kernel_takes_strided_views_on_card(cuda_device, dtype):
    """The model's (B, S, H, D) -> (B, H, S, D) views and a strided
    gradient go in uncopied; the gradients come back in the inputs'
    layouts."""
    q = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (2, 70, 8, 64)), dtype=torch.float32).to(cuda_device, dtype)
    k, v = (torch.as_tensor(np.random.default_rng(s).standard_normal(
        (2, 70, 2, 64)), dtype=torch.float32).to(cuda_device, dtype)
        for s in (2, 3))
    do = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (2, 70, 8, 64)), dtype=torch.float32).to(cuda_device, dtype)
    q, k, v, do = (t.movedim(2, 1) for t in (q, k, v, do))
    out, lse = pfa.flash_attention(q, k, v, return_lse=True)
    got = pfa.flash_attention_bwd(q, k, v, out, do, lse)
    want = pfa.attention_bwd_torch(*(t.contiguous() for t in (q, k, v, out,
                                                               do)), lse)
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.stride() == t.stride()
        np.testing.assert_allclose(g.float().cpu().numpy(),
                                   w.float().cpu().numpy(), **BWD_TOL[dtype])


def test_attention_bwd_kernel_copies_misaligned_bf16_views_on_card(
        cuda_device):
    """bfloat16 q and gradient views whose rows do not start 16-byte
    aligned are copied before the backward's launch; the gradients come
    back in q's shape and hold against the plain version."""
    rng = np.random.default_rng(6)

    def misaligned(shape):
        flat = torch.as_tensor(rng.standard_normal(1 + int(np.prod(shape))),
                               dtype=torch.float32).to(cuda_device,
                                                       torch.bfloat16)
        return flat[1:].view(shape)

    q, do = misaligned((2, 4, 96, 64)), misaligned((2, 4, 96, 64))
    k = torch.as_tensor(rng.standard_normal((2, 2, 96, 64)),
                        dtype=torch.float32).to(cuda_device, torch.bfloat16)
    v = k.flip(2)
    assert not pfa._fits(q) and not pfa._fits(do)
    out, lse = pfa.flash_attention(q, k, v, window=40, return_lse=True)
    got = pfa.flash_attention_bwd(q, k, v, out, do, lse, window=40)
    want = pfa.attention_bwd_torch(q, k, v, out, do, lse, window=40)
    torch.cuda.synchronize()
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.dtype == torch.bfloat16 and g.shape == t.shape
        np.testing.assert_allclose(g.float().cpu().numpy(),
                                   w.float().cpu().numpy(),
                                   **BWD_TOL[torch.bfloat16])


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_forward_lse_leaves_output_bit_equal_on_card(cuda_device,
                                                               d, dtype):
    """Asking the forward for lse changes no bit of its output."""
    q, k, v, _ = _attn_inputs(cuda_device, dtype, 2, 8, 2, 300, 300, d, d)
    plain = pfa.flash_attention(q, k, v, window=128)
    out, lse = pfa.flash_attention(q, k, v, window=128, return_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(plain, out)
    assert lse.dtype == torch.float32 and lse.shape == q.shape[:3]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_bwd_kernel_is_deterministic_on_card(cuda_device, dtype):
    """No atomics: two backwards of the same inputs are bit-equal."""
    q, k, v, do = _attn_inputs(cuda_device, dtype, 2, 32, 4, 512, 512, 64, 8)
    out, lse = pfa.flash_attention(q, k, v, return_lse=True)
    one = pfa.flash_attention_bwd(q, k, v, out, do, lse)
    two = pfa.flash_attention_bwd(q, k, v, out, do, lse)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(one, two))


def test_attention_function_under_checkpoint_on_card(cuda_device):
    """ops.attention on impl="cuda" inside torch.utils.checkpoint: the
    forward kernel runs twice (forward and recompute), the backward kernel
    once, and the gradients match plain autograd."""
    q0, k0, v0, do = _attn_inputs(cuda_device, torch.float32, 1, 8, 2, 150,
                                  150, 64, 21)

    def grads(impl, wrap):
        q, k, v = (t.clone().requires_grad_(True) for t in (q0, k0, v0))

        def f(q, k, v):
            return ops.attention(q, k, v, window=64, impl=impl) * 2.0

        out = (torch.utils.checkpoint.checkpoint(f, q, k, v,
                                                 use_reentrant=False)
               if wrap else f(q, k, v))
        out.backward(do)
        return q.grad, k.grad, v.grad

    fwd, bwd = pfa.flash_attention.launches, pfa.flash_attention_bwd.launches
    got = grads("cuda", True)
    torch.cuda.synchronize()
    assert pfa.flash_attention.launches - fwd == 2
    assert pfa.flash_attention_bwd.launches - bwd == 1
    want = grads("torch", False)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   **BWD_TOL[torch.float32])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_function_d256_window_mqa_on_card(cuda_device, dtype):
    """ops.attention on impl="cuda" at D 256 with a window and one KV head
    (recurrentgemma's attention): the backward kernel runs once, its
    gradients hold against plain autograd and are bit-equal run to run."""
    q0, k0, v0, do = _attn_inputs(cuda_device, dtype, 1, 8, 1, 320, 320,
                                  256, 3)

    def grads(impl):
        q, k, v = (t.clone().requires_grad_(True) for t in (q0, k0, v0))
        ops.attention(q, k, v, window=100, impl=impl).backward(do)
        return q.grad, k.grad, v.grad

    bwd = pfa.flash_attention_bwd.launches
    got, again = grads("cuda"), grads("cuda")
    torch.cuda.synchronize()
    assert pfa.flash_attention_bwd.launches - bwd == 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = grads("torch")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().cpu().numpy(),
                                   w.float().cpu().numpy(), **BWD_TOL[dtype])


#: Shapes where the dK/dV grid leaves SMs idle, so the plan splits each KV
#: head's query heads into G > 1 groups: MQA 16/1 at batch 1 with a window
#: (recurrentgemma's heads), GQA 8/2 at batch 1, ragged tails, tq < tk.
GROUPED_BWD = [
    (1, 16, 1, 1024, 1024, 256, 512),
    (1, 8, 2, 300, 300, 256, None),
    (1, 16, 1, 200, 200, 256, 64),
    (1, 8, 1, 96, 300, 256, 100),
    (1, 8, 2, 300, 300, 64, 128),
]


@pytest.mark.parametrize("b,hq,hkv,tq,tk,d,window", GROUPED_BWD)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_bwd_with_head_groups_matches_plain_on_card(
        cuda_device, b, hq, hkv, tq, tk, d, window, dtype):
    """G > 1 (float32 at every head dim, bfloat16 at D 256): the partial
    sums of the groups, added in group order, hold against the plain
    backward, and two runs are bit-equal."""
    q, k, v, do = _attn_inputs(cuda_device, dtype, b, hq, hkv, tq, tk, d,
                               tq + 5 * tk + d)
    out, lse = pfa.flash_attention(q, k, v, window=window, return_lse=True)
    got = pfa.flash_attention_bwd(q, k, v, out, do, lse, window=window)
    plan = pfa.flash_attention_bwd.last_plan
    again = pfa.flash_attention_bwd(q, k, v, out, do, lse, window=window)
    want = pfa.attention_bwd_torch(q, k, v, out, do, lse, window=window)
    torch.cuda.synchronize()
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert plan == pfa.attention_bwd_plan(b, hq, hkv, tq, tk, d, dtype, sms)
    assert plan.groups > 1 or (dtype == torch.bfloat16 and d <= 128)
    assert all(torch.equal(a, w) for a, w in zip(got, again))
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.dtype == dtype and g.shape == t.shape
        np.testing.assert_allclose(g.float().cpu().numpy(),
                                   w.float().cpu().numpy(), **BWD_TOL[dtype])


def test_attention_bwd_refuses_groups_that_do_not_divide_on_card(
        cuda_device):
    """The C entry refuses a G that does not divide Hq / Hkv, and G > 1
    where the bfloat16 instance takes no groups (D <= 128)."""
    fn = _build.load("flash_attention").flash_attention_bwd
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 11
                   + [ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    buf = torch.zeros(1 << 16, dtype=torch.float32, device=cuda_device)
    p = buf.data_ptr()
    strides = (ctypes.c_longlong * 24)(*([4096, 256, 64] * 8))
    for dtype, d, groups in ((0, 64, 3), (1, 256, 3), (1, 64, 2)):
        assert fn(dtype, d, *[p] * 11, groups, strides, 1, 4, 1, 4, 4, 1,
                  -1, 1.0, None) != 0, (dtype, d, groups)


def test_attention_bwd_smem_matches_the_source_on_card(cuda_device):
    fn = _build.load("flash_attention").flash_attention_bwd_smem
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        for d in pfa.BWD_HEAD_DIMS:
            tiles = pfa.bwd_tiles(d, dtype)
            assert fn(code, d, 0) == tiles.kv_smem, (dtype, d)
            assert fn(code, d, 1) == tiles.dq_smem, (dtype, d)


@pytest.mark.parametrize("shape", [(8192, 2048), (4 * 256 * 32, 128),
                                   (2, 9, 2560), (5, 100), (3, 64),
                                   (7, 2568), (2, 5, 4096), (3, 16384),
                                   # rows that are not a multiple of a
                                   # grid's rows, fewer rows than blocks,
                                   # one row; D 16,384 ends bf16's vector
                                   # path (float32's ends at 8,192)
                                   (3001, 2048), (5, 2048), (1, 2048),
                                   (10_001, 128), (3, 128), (1, 128),
                                   (300, 16384), (9, 8192)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_bwd_kernel_matches_plain_on_card(cuda_device, shape, dtype):
    rng = np.random.default_rng(shape[-1] + len(shape))
    x, dy = (torch.as_tensor(rng.standard_normal(shape),
                             dtype=torch.float32).to(cuda_device, dtype)
             for _ in range(2))
    w = torch.as_tensor(rng.standard_normal(shape[-1]) * 0.1,
                        dtype=torch.float32).to(cuda_device)
    before = prms.rmsnorm_bwd.launches
    dx, dw = prms.rmsnorm_bwd(x, w, dy)
    dx_p, dw_p = prms.rmsnorm_bwd_torch(x, w, dy)
    torch.cuda.synchronize()
    assert prms.rmsnorm_bwd.launches == before + 1
    assert dx.dtype == dtype and dx.shape == x.shape
    assert dw.dtype == torch.float32 and dw.shape == w.shape
    np.testing.assert_allclose(dx.float().cpu().numpy(),
                               dx_p.float().cpu().numpy(), **BWD_TOL[dtype])
    # dw sums a product over every row: relative to its scale
    rows = x.numel() // shape[-1]
    np.testing.assert_allclose(dw.cpu().numpy(), dw_p.cpu().numpy(),
                               rtol=1e-3, atol=1e-4 * rows ** 0.5)
    again = prms.rmsnorm_bwd(x, w, dy)
    assert torch.equal(again[0], dx) and torch.equal(again[1], dw)


@pytest.mark.parametrize("case", ["x-and-dy-misaligned", "dy-transposed"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_bwd_kernel_on_views_on_card(cuda_device, case, dtype):
    """x and dy one element past a 16-byte boundary take the scalar path;
    a transposed dy is made contiguous by the wrapper."""
    rows, d = 777, 2048
    rng = np.random.default_rng(77)

    def randn(shape):
        return torch.as_tensor(rng.standard_normal(shape),
                               dtype=torch.float32).to(cuda_device, dtype)

    if case == "x-and-dy-misaligned":
        x, dy = (randn(rows * d + 1)[1:].view(rows, d) for _ in range(2))
        assert x.data_ptr() % 16 and dy.data_ptr() % 16
    else:
        x, dy = randn((rows, d)), randn((d, rows)).t()
        assert not dy.is_contiguous()
    w = torch.as_tensor(rng.standard_normal(d) * 0.1,
                        dtype=torch.float32).to(cuda_device)
    before = prms.rmsnorm_bwd.launches
    dx, dw = prms.rmsnorm_bwd(x, w, dy)
    dx_p, dw_p = prms.rmsnorm_bwd_torch(x, w, dy)
    torch.cuda.synchronize()
    assert prms.rmsnorm_bwd.launches == before + 1
    np.testing.assert_allclose(dx.float().cpu().numpy(),
                               dx_p.float().cpu().numpy(), **BWD_TOL[dtype])
    np.testing.assert_allclose(dw.cpu().numpy(), dw_p.cpu().numpy(),
                               rtol=1e-3, atol=1e-4 * rows ** 0.5)
    again = prms.rmsnorm_bwd(x, w, dy)
    assert torch.equal(again[0], dx) and torch.equal(again[1], dw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_bwd_refuses_rows_above_16384_on_card(cuda_device, dtype):
    x = torch.ones((2, 16392), dtype=dtype, device=cuda_device)
    w = torch.zeros(16392, device=cuda_device)
    before = prms.rmsnorm_bwd.launches
    with pytest.raises(ValueError, match="16,384"):
        prms.rmsnorm_bwd(x, w, x)
    assert prms.rmsnorm_bwd.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_function_under_checkpoint_on_card(cuda_device, dtype):
    rng = np.random.default_rng(31)
    x0 = torch.as_tensor(rng.standard_normal((3, 40, 256)),
                         dtype=torch.float32).to(cuda_device, dtype)
    w0 = torch.as_tensor(rng.standard_normal(256) * 0.1,
                         dtype=torch.float32).to(cuda_device)
    dy = torch.as_tensor(rng.standard_normal((3, 40, 256)),
                         dtype=torch.float32).to(cuda_device, dtype)

    def grads(impl, wrap):
        x, w = x0.clone().requires_grad_(True), w0.clone().requires_grad_(True)

        def f(x, w):
            return ops.rmsnorm(x, w, impl=impl)

        out = (torch.utils.checkpoint.checkpoint(f, x, w,
                                                 use_reentrant=False)
               if wrap else f(x, w))
        out.backward(dy)
        return x.grad, w.grad

    fwd, bwd = prms.rmsnorm.launches, prms.rmsnorm_bwd.launches
    got = grads("cuda", True)
    torch.cuda.synchronize()
    assert (prms.rmsnorm.launches - fwd, prms.rmsnorm_bwd.launches - bwd) \
        == (2, 1)
    want = grads("torch", False)
    np.testing.assert_allclose(got[0].float().cpu().numpy(),
                               want[0].float().cpu().numpy(),
                               **BWD_TOL[dtype])
    np.testing.assert_allclose(got[1].cpu().numpy(), want[1].cpu().numpy(),
                               rtol=1e-3, atol=1e-2)


#: The recurrent backward kernels against their plain versions: both
#: compute in float32 and differ in summation order (gradients summed over
#: thousands of steps and heads), bfloat16 results by their last rounding
#: (2^-8 relative): rtol, and atol as a fraction of the tensor's largest
#: magnitude.
REC_BWD_TOL = {torch.float32: (1e-3, 1e-4), torch.bfloat16: (2e-2, 2e-3)}


def _hold_bwd(got, want, dtype, what):
    rtol, frac = REC_BWD_TOL[dtype]
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (what, i)
        w = w.float().cpu().numpy()
        np.testing.assert_allclose(g.float().cpu().numpy(), w, rtol=rtol,
                                   atol=frac * float(np.abs(w).max()),
                                   err_msg=f"{what} gradient {i}")


@pytest.mark.parametrize("shape", [(2, 300, 96), (1, 1000, 4096),
                                   (3, 77, 36)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_linear_recurrence_bwd_kernel_matches_plain_on_card(cuda_device,
                                                            shape, dtype):
    """linear_recurrence_bwd against its plain version (one launch a call,
    bit-equal run to run), and ops.linear_recurrence's Function on
    impl="cuda" against plain autograd; D 36 in bfloat16 takes the
    element-by-element copies."""
    rng = np.random.default_rng(sum(shape))
    a, b, dh = (torch.as_tensor(u, dtype=torch.float32).to(cuda_device, dtype)
                for u in (rng.uniform(0.6, 0.999, shape),
                          rng.standard_normal(shape),
                          rng.standard_normal(shape)))
    h = plr.linear_recurrence(a, b)
    before = plr.linear_recurrence_bwd.launches
    got = plr.linear_recurrence_bwd(a, h, dh)
    again = plr.linear_recurrence_bwd(a, h, dh)
    torch.cuda.synchronize()
    assert plr.linear_recurrence_bwd.launches == before + 2
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    assert all(g.dtype == dtype for g in got)
    _hold_bwd(got, plr.linear_recurrence_bwd_torch(a, h, dh), dtype,
              "linear_recurrence_bwd")

    def grads(impl):
        x, y = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
        ops.linear_recurrence(x, y, impl=impl).backward(dh)
        return x.grad, y.grad

    fwd = plr.linear_recurrence.launches
    got = grads("cuda")
    assert plr.linear_recurrence.launches == fwd + 1
    _hold_bwd(got, grads("torch"), dtype, "linear_recurrence Function")


@pytest.mark.parametrize("bb,t,h,p,g,n,chunk", [
    (2, 256, 4, 64, 1, 128, 128),    # mamba2-370m's P and N
    (1, 192, 8, 16, 2, 16, 64),      # G 2, the smoke config's P and N
    (2, 96, 4, 32, 4, 32, 32),       # G = H
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_bwd_kernel_matches_plain_on_card(cuda_device, bb, t, h, p, g,
                                              n, chunk, dtype):
    """ssd_chunk_scan_bwd (with a final state's gradient) against its plain
    version (one launch a call, bit-equal run to run), and ops.ssd_scan's
    Function on impl="cuda" against plain autograd."""
    rng = np.random.default_rng(t + p + n)

    def tensor(u, dt=dtype):
        return torch.as_tensor(u, dtype=torch.float32).to(cuda_device, dt)

    x = tensor(rng.standard_normal((bb, t, h, p)))
    dt = tensor(rng.uniform(0.001, 0.1, (bb, t, h)), torch.float32)
    A = tensor(-rng.uniform(0.5, 2.0, h), torch.float32)
    B, C = (tensor(rng.standard_normal((bb, t, g, n)) * 0.3) for _ in "BC")
    dy = tensor(rng.standard_normal((bb, t, h, p)))
    ds = tensor(rng.standard_normal((bb, h, p, n)), torch.float32)
    before = pssd.ssd_chunk_scan_bwd.launches
    got = pssd.ssd_chunk_scan_bwd(x, dt, A, B, C, dy, ds, chunk=chunk)
    again = pssd.ssd_chunk_scan_bwd(x, dt, A, B, C, dy, ds, chunk=chunk)
    torch.cuda.synchronize()
    assert pssd.ssd_chunk_scan_bwd.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert [u.dtype for u in got] == [dtype, torch.float32, torch.float32,
                                      dtype, dtype]
    _hold_bwd(got, pssd.ssd_bwd_torch(x, dt, A, B, C, dy, ds, chunk=chunk),
              dtype, "ssd_chunk_scan_bwd")

    def grads(impl):
        ins = [u.clone().requires_grad_(True) for u in (x, dt, A, B, C)]
        y, _ = ops.ssd_scan(*ins, chunk=chunk, impl=impl)
        y.backward(dy)
        return [u.grad for u in ins]

    _hold_bwd(grads("cuda"), grads("torch"), dtype, "ssd_scan Function")


def _ssd_bwd_args(rng, bb, t, h, p, g, n, device, dt_max=0.1,
                  a_max=2.0, offset=False, dtype=torch.bfloat16):
    """Seeded inputs of ssd_chunk_scan_bwd, x, dy, B and C in ``dtype``
    (dt, A and the final state's gradient in float32); ``offset``: x, dy,
    B and C start one element into their storage, off a 16-byte
    boundary."""
    def bf16(u):
        u = torch.as_tensor(u, dtype=torch.float32).to(device, dtype)
        if not offset:
            return u
        buf = torch.empty(u.numel() + 1, dtype=dtype, device=device)
        view = buf[1:].view(u.shape)
        view.copy_(u)
        return view

    def f32(u):
        return torch.as_tensor(u, dtype=torch.float32).to(device)

    x = bf16(rng.standard_normal((bb, t, h, p)))
    dt = f32(rng.uniform(0.001, dt_max, (bb, t, h)))
    A = f32(-np.linspace(0.5, a_max, h))
    B, C = (bf16(rng.standard_normal((bb, t, g, n)) * 0.3) for _ in "BC")
    dy = bf16(rng.standard_normal((bb, t, h, p)))
    ds = f32(rng.standard_normal((bb, h, p, n)))
    return x, dt, A, B, C, dy, ds


def _hold_mma_bwd(args, chunk):
    """The bfloat16 backward through its tensor-core instance (one launch
    a call, counted by both counters; two runs bit-equal) against its
    plain version and against autograd of the plain forward, at
    REC_BWD_TOL (chip_smoke.BWD_TOL["bfloat16"])."""
    x, dt, A, B, C, dy, ds = args
    assert pssd.bwd_instance(x.dtype, B.shape[3]) == "mma"
    fn = pssd.ssd_chunk_scan_bwd
    before = (fn.launches, fn.mma_launches)
    got = fn(*args, chunk=chunk)
    assert (fn.launches, fn.mma_launches) == (before[0] + 1, before[1] + 1)
    again = fn(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert (fn.launches, fn.mma_launches) == (before[0] + 2, before[1] + 2)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert [u.dtype for u in got] == [torch.bfloat16, torch.float32,
                                      torch.float32, torch.bfloat16,
                                      torch.bfloat16]
    assert all(bool(torch.isfinite(u).all()) for u in got)
    _hold_bwd(got, pssd.ssd_bwd_torch(*args, chunk=chunk), torch.bfloat16,
              "ssd_chunk_scan_bwd (mma)")
    req = [u.detach().clone().requires_grad_(True) for u in args[:5]]
    y, s = pssd.ssd_torch(*req, chunk=chunk)
    auto = torch.autograd.grad((y, s), req, (dy, ds))
    _hold_bwd(got, auto, torch.bfloat16,
              "ssd_chunk_scan_bwd (mma) against autograd")


@pytest.mark.parametrize("bb,t,h,p,g,n,chunk", [
    (2, 256, 4, 64, 1, 128, 128),    # mamba2-370m's P and N: dS staged
    (1, 256, 2, 128, 1, 128, 128),   # P = N = 128: dS read after the rows
    (1, 192, 8, 16, 2, 16, 64),      # G 2, chunk 64, the smoke P and N
    (2, 96, 4, 32, 4, 32, 32),       # G = H, chunk 32
    (1, 128, 4, 20, 2, 36, 64),      # P, N not multiples of 8 (pads 32, 64)
    (2, 64, 2, 128, 1, 16, 32),      # P 128, N 16
    (1, 256, 2, 48, 1, 100, 128),    # pads 64 and 128
])
def test_ssd_bwd_mma_kernel_matches_plain_on_card(cuda_device, bb, t, h, p,
                                                  g, n, chunk):
    """Every chunk length and padding of P and N through the bfloat16
    backward's tensor-core kernels."""
    args = _ssd_bwd_args(np.random.default_rng(t + p + n), bb, t, h, p, g, n,
                         cuda_device)
    _hold_mma_bwd(args, chunk)


def test_ssd_bwd_mma_kernel_takes_offset_views_on_card(cuda_device):
    """x, dy, B and C 2 bytes off a 16-byte boundary: the element-by-
    element loads."""
    args = _ssd_bwd_args(np.random.default_rng(7), 2, 256, 4, 64, 1, 128,
                         cuda_device, offset=True)
    assert args[0].data_ptr() % 16 == 2
    _hold_mma_bwd(args, 128)


def test_ssd_bwd_mma_kernel_strong_decay_on_card(cuda_device):
    """The inputs of test_ssd_kernel_strong_decay_on_card: dt up to 1 and
    A down to -16, cum below -1,000 inside a 128-step chunk, where
    exp(-cum) overflows float32."""
    rng = np.random.default_rng(16)
    args = _ssd_bwd_args(rng, 2, 384, 4, 64, 1, 128, cuda_device,
                         dt_max=1.0, a_max=16.0)
    dt, A = args[1].cpu().numpy(), args[2].cpu().numpy()
    cum = np.cumsum((dt * A).reshape(2, 3, 128, 4), axis=2)
    assert cum.min() < -1000.0
    _hold_mma_bwd(args, 128)


def test_ssd_mma_bwd_smem_matches_the_source_on_card(cuda_device):
    fn = _build.load("ssd_chunk_scan").ssd_chunk_scan_mma_bwd_smem
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_longlong
    for chunk in pssd.CHUNKS:
        for p in (4, 16, 36, 64, 100, 128):
            for n in (4, 16, 40, 64, 128):
                assert fn(chunk, p, n) == pssd.mma_bwd_smem_bytes(
                    chunk, p, n), (chunk, p, n)


def _hold_f32_bwd(args, chunk):
    """The float32 backward through its float32-core instance (one launch
    a call, no tensor-core launch; two runs bit-equal) against its plain
    version and against autograd of the plain forward, at REC_BWD_TOL
    (chip_smoke.BWD_TOL["float32"])."""
    x, dt, A, B, C, dy, ds = args
    assert pssd.bwd_instance(x.dtype, B.shape[3]) == "simt"
    fn = pssd.ssd_chunk_scan_bwd
    before = (fn.launches, fn.mma_launches)
    got = fn(*args, chunk=chunk)
    again = fn(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert (fn.launches, fn.mma_launches) == (before[0] + 2, before[1])
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(u.dtype == torch.float32 for u in got)
    assert all(bool(torch.isfinite(u).all()) for u in got)
    _hold_bwd(got, pssd.ssd_bwd_torch(*args, chunk=chunk), torch.float32,
              "ssd_chunk_scan_bwd (float32)")
    req = [u.detach().clone().requires_grad_(True) for u in args[:5]]
    y, s = pssd.ssd_torch(*req, chunk=chunk)
    auto = torch.autograd.grad((y, s), req, (dy, ds))
    _hold_bwd(got, auto, torch.float32,
              "ssd_chunk_scan_bwd (float32) against autograd")


@pytest.mark.parametrize("bb,t,h,p,g,n,chunk", [
    (2, 256, 4, 64, 1, 128, 128),    # mamba2-370m's P and N
    (1, 256, 2, 128, 1, 128, 128),   # P = N = 128: the walks' one stage
    (1, 192, 8, 16, 2, 16, 64),      # G 2, chunk 64, the smoke P and N
    (2, 96, 4, 32, 4, 32, 32),       # G = H, chunk 32
    (1, 128, 4, 20, 2, 36, 64),      # P, N not multiples of 8 (pads 32, 64)
    (2, 64, 2, 128, 1, 16, 32),      # P 128, N 16
    (1, 256, 2, 48, 1, 100, 128),    # pads 64 and 128
])
def test_ssd_bwd_f32_kernel_matches_plain_on_card(cuda_device, bb, t, h, p,
                                                  g, n, chunk):
    """Every chunk length and padding of P and N through the float32
    backward's register-tiled kernels (ssd_bwd_f32_walk, one launch of
    both walks, and ssd_bwd_f32_chunk)."""
    args = _ssd_bwd_args(np.random.default_rng(t + p + n), bb, t, h, p, g, n,
                         cuda_device, dtype=torch.float32)
    _hold_f32_bwd(args, chunk)


def test_ssd_bwd_f32_kernel_takes_offset_views_on_card(cuda_device):
    """x, dy, B and C 4 bytes off a 16-byte boundary: the element-by-
    element loads."""
    args = _ssd_bwd_args(np.random.default_rng(8), 2, 256, 4, 64, 1, 128,
                         cuda_device, offset=True, dtype=torch.float32)
    assert args[0].data_ptr() % 16 == 4
    _hold_f32_bwd(args, 128)


def test_ssd_bwd_f32_kernel_strong_decay_on_card(cuda_device):
    """The float32 backward where cum falls below -1,000 inside a 128-step
    chunk (dt up to 1, A down to -16), where exp(-cum) overflows float32."""
    rng = np.random.default_rng(16)
    args = _ssd_bwd_args(rng, 2, 384, 4, 64, 1, 128, cuda_device,
                         dt_max=1.0, a_max=16.0, dtype=torch.float32)
    dt, A = args[1].cpu().numpy(), args[2].cpu().numpy()
    cum = np.cumsum((dt * A).reshape(2, 3, 128, 4), axis=2)
    assert cum.min() < -1000.0
    _hold_f32_bwd(args, 128)


def test_ssd_f32_bwd_smem_matches_the_source_on_card(cuda_device):
    """The float32 backward's shared memory per block, as the library
    computes it, equals its Python mirror at every shape it takes."""
    fn = _build.load("ssd_chunk_scan").ssd_chunk_scan_f32_bwd_smem
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_longlong
    for chunk in pssd.CHUNKS:
        for p in (4, 16, 20, 36, 64, 96, 100, 128):
            for n in (4, 16, 40, 64, 100, 128):
                assert fn(chunk, p, n) == pssd.bwd_smem_bytes(
                    chunk, p, n), (chunk, p, n)


def _launch_counts(cfg, steps=1):
    """The kernels one training step of a smoke config launches, from
    layer_forward_runs: {counter: launches}."""
    from repro_torch.models import common as cm
    if cfg.family == "ssm":
        runs = cm.layer_forward_runs(cfg, cfg.num_layers)
        return {pssd.ssd_chunk_scan: runs,
                pssd.ssd_chunk_scan_bwd: cfg.num_layers,
                prms.rmsnorm: 2 * runs + 1,
                prms.rmsnorm_bwd: 2 * cfg.num_layers + 1}
    if cfg.family == "hybrid":
        k = len(cfg.block_pattern)
        groups, tail = divmod(cfg.num_layers, k)
        runs = cm.layer_forward_runs(cfg, groups)   # group forwards
        rec = cfg.block_pattern.count("rec")
        attn = k - rec
        return {plr.linear_recurrence: rec * runs + tail,
                plr.linear_recurrence_bwd: rec * groups + tail,
                pfa.flash_attention: attn * runs,
                pfa.flash_attention_bwd: attn * groups,
                prms.rmsnorm: 2 * k * runs + 2 * tail + 1,
                prms.rmsnorm_bwd: 2 * k * groups + 2 * tail + 1}
    norms = 4 if cfg.qk_norm else 2
    runs = cm.layer_forward_runs(cfg, cfg.num_layers)
    return {prms.rmsnorm: norms * runs + 1,
            prms.rmsnorm_bwd: norms * cfg.num_layers + 1,
            pfa.flash_attention: runs,
            pfa.flash_attention_bwd: cfg.num_layers}


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen3-4b",
                                  "internvl2-26b", "musicgen-large",
                                  "mamba2-370m", "recurrentgemma-9b"])
def test_smoke_model_gradients_kernels_match_plain_on_card(cuda_device, arch):
    """loss_fn's gradients through the kernels' Functions (remat full)
    against plain autograd, float32, every leaf within 1e-4 of its scale;
    the kernels launch as often as layer_forward_runs says (the ssm and
    hybrid families through the SSD scan's and the linear recurrence's
    backward kernels, and attention's at D 16 with the window)."""
    import dataclasses

    from repro_torch.utils import tree_leaves
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                              kernel_impl="auto")
    base = M.init_params(cfg, torch.Generator(cuda_device).manual_seed(0),
                         device=cuda_device, weight_std=0.02)
    tree, model = base.param_tree(), type(base)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 64) + _codebooks(cfg)), device=cuda_device)
    counts = _launch_counts(cfg)
    out = []
    for impl in ("auto", "torch"):
        c = dataclasses.replace(cfg, kernel_impl=impl)
        params = model(c, tree)
        params.requires_grad_(True)
        grads = M.bind_grads(c, params)
        before = {fn: fn.launches for fn in counts}
        M.loss_fn(c, params, {"tokens": toks})[0].backward()
        torch.cuda.synchronize()
        got = {fn.__name__: fn.launches - before[fn] for fn in counts}
        want = {fn.__name__: (n if impl == "auto" else 0)
                for fn, n in counts.items()}
        assert got == want, (impl, got, want)
        out.append(tree_leaves(grads))
    for a, b in zip(*out):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=1e-4,
                                   atol=1e-4 * float(b.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_takes_misaligned_rows_on_card(cuda_device, dtype):
    """x whose storage starts one element past a 16-byte boundary (the
    scalar path) matches the plain version."""
    rng = np.random.default_rng(9)
    flat = torch.as_tensor(rng.standard_normal(1 + 6 * 2560),
                           dtype=torch.float32).to(cuda_device, dtype)
    x = flat[1:].view(6, 2560)
    assert x.data_ptr() % 16 != 0
    w = torch.as_tensor(rng.standard_normal(2560) * 0.1,
                        dtype=torch.float32).to(cuda_device)
    got = ops.rmsnorm(x, w, impl="cuda")
    want = ops.rmsnorm(x, w, impl="torch")
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               atol=RMS_TOL[dtype])


@pytest.mark.parametrize("shape", [(4096, 128), (2, 9, 2560), (3, 2048),
                                   (5, 100), (7, 2568), (3, 4096),
                                   (2, 9, 1024)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_matches_plain_on_card(cuda_device, shape, dtype):
    rng = np.random.default_rng(shape[-1])
    x = torch.as_tensor(rng.standard_normal(shape),
                        dtype=torch.float32).to(cuda_device, dtype)
    w = torch.as_tensor(rng.standard_normal(shape[-1]) * 0.1,
                        dtype=torch.float32).to(cuda_device)
    before = prms.rmsnorm.launches
    got = ops.rmsnorm(x, w, impl="cuda")
    want = ops.rmsnorm(x, w, impl="torch")
    torch.cuda.synchronize()
    assert prms.rmsnorm.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               atol=RMS_TOL[dtype])


def _codebooks(cfg) -> tuple:
    """The trailing codebook axis of a codebook model's tokens, else ()."""
    return (cfg.num_codebooks,) if cfg.num_codebooks > 1 else ()


@pytest.mark.parametrize("arch", ["qwen3-4b", "tinyllama-1.1b",
                                  "internvl2-26b", "musicgen-large"])
def test_greedy_generate_kernels_match_plain_on_card(cuda_device, arch):
    """A 2-layer smoke config in float32: prefill logits and the greedy
    tokens ((B, steps, Cb) for musicgen) with the CUDA kernels equal those
    with the plain versions."""
    cfg = get_smoke_config(arch, dtype="float32", kernel_impl="cuda")
    plain = get_smoke_config(arch, dtype="float32", kernel_impl="torch")
    params = M.init_params(cfg, torch.Generator(cuda_device).manual_seed(0),
                           device=cuda_device)
    prompt = torch.as_tensor(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (2, 24) + _codebooks(cfg)), device=cuda_device)
    before = (pfa.flash_attention.launches, prms.rmsnorm.launches)
    got = greedy_generate(cfg, params, prompt, steps=6, max_seq=32)
    assert pfa.flash_attention.launches > before[0]
    assert prms.rmsnorm.launches > before[1]
    want = greedy_generate(plain, params, prompt, steps=6, max_seq=32)
    assert got.shape == (2, 6) + _codebooks(cfg)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    lg, _ = M.prefill(cfg, params, prompt, 32)
    lw, _ = M.prefill(plain, params, prompt, 32)
    np.testing.assert_allclose(lg.cpu().numpy(), lw.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_image_prefill_kernels_match_plain_on_card(cuda_device, dtype):
    """internvl2's smoke config with stub patch embeddings over the first
    positions: prefill logits and caches, and the next serve steps'
    logits, with the CUDA kernels against the plain versions (float32 at
    1e-4; bfloat16 at tests/test_torch_serve.py's BF16)."""
    tol = (dict(rtol=1e-4, atol=1e-4) if dtype == "float32"
           else dict(rtol=2e-2, atol=8e-2))
    cfg = get_smoke_config("internvl2-26b", dtype=dtype, kernel_impl="cuda")
    plain = get_smoke_config("internvl2-26b", dtype=dtype,
                             kernel_impl="torch")
    params = M.init_params(cfg, torch.Generator(cuda_device).manual_seed(0),
                           device=cuda_device, weight_std=0.02)
    rng = np.random.default_rng(0)
    prompt = torch.as_tensor(rng.integers(1, cfg.vocab_size, (2, 24)),
                             device=cuda_device)
    patches = torch.as_tensor(rng.standard_normal(
        (2, cfg.num_patches, cfg.d_model)), dtype=torch.float32).to(
            cuda_device, getattr(torch, dtype))
    nxt = torch.as_tensor(rng.integers(1, cfg.vocab_size, (3, 2)),
                          device=cuda_device)
    out = []
    for c in (cfg, plain):
        before = pfa.flash_attention.launches
        logits, cache = M.prefill(c, params, prompt, 32, patches)
        assert (pfa.flash_attention.launches > before) == (c is cfg)
        steps = [logits[:, -1]]
        for i in range(3):
            step, cache = M.decode_step(c, params, cache, nxt[i], 24 + i)
            steps.append(step)
        out.append((torch.stack(steps, 1), cache))
    (got, gc), (want, wc) = out
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **tol)
    for key in ("k", "v"):
        np.testing.assert_allclose(gc[key].float().cpu().numpy(),
                                   wc[key].float().cpu().numpy(), **tol)
    text, _ = M.prefill(cfg, params, prompt, 32)
    assert not torch.equal(text[:, -1], got[:, 0])


def _ssd_inputs(rng, b, t, h, p, g, n, dtype, device):
    x = rng.standard_normal((b, t, h, p)) * 0.5
    dt = rng.uniform(0.001, 0.1, (b, t, h))
    A = -rng.uniform(0.5, 2.0, h)
    B = rng.standard_normal((b, t, g, n)) * 0.3
    C = rng.standard_normal((b, t, g, n)) * 0.3
    cast = [dtype, torch.float32, torch.float32, dtype, dtype]
    return [torch.as_tensor(u, dtype=torch.float32).to(device, c)
            for u, c in zip((x, dt, A, B, C), cast)]


@pytest.mark.parametrize("b,t,h,p,g,n,chunk", [
    (1, 128, 4, 32, 2, 64, 64),
    (2, 256, 2, 16, 1, 32, 128),
    (1, 64, 2, 64, 2, 128, 32),
    (4, 2048, 32, 64, 1, 128, 128),    # mamba2-370m's prefill shape
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_matches_plain_on_card(cuda_device, b, t, h, p, g, n,
                                          chunk, dtype):
    args = _ssd_inputs(np.random.default_rng(t + p), b, t, h, p, g, n,
                       dtype, cuda_device)
    before = pssd.ssd_chunk_scan.launches
    y, s = ops.ssd_scan(*args, chunk=chunk, impl="cuda")
    yw, sw = ops.ssd_scan(*args, chunk=chunk, impl="torch")
    torch.cuda.synchronize()
    assert pssd.ssd_chunk_scan.launches == before + 1
    assert y.dtype == dtype and s.dtype == torch.float32
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               yw.float().cpu().numpy(), **SSD_TOL[dtype])
    np.testing.assert_allclose(s.cpu().numpy(), sw.cpu().numpy(),
                               **SSD_TOL[torch.float32])
    if t <= 256:       # the sequential oracle, at the reference's atol
        yr, sr = ref.ssd_ref(*args)
        np.testing.assert_allclose(y.float().cpu().numpy(),
                                   yr.float().cpu().numpy(),
                                   **SSD_TOL[dtype])
        np.testing.assert_allclose(s.cpu().numpy(), sr.cpu().numpy(),
                                   atol=1e-3)


def test_ssd_kernel_refuses_unsupported_shapes_on_card(cuda_device):
    args = _ssd_inputs(np.random.default_rng(0), 1, 96, 2, 16, 1, 16,
                       torch.float32, cuda_device)
    with pytest.raises(ValueError, match="chunk"):
        ops.ssd_scan(*args, chunk=64, impl="cuda")       # 96 % 64 != 0
    with pytest.raises(ValueError, match="chunk"):
        ops.ssd_scan(*args, chunk=48, impl="cuda")


@pytest.mark.parametrize("b,t,h,p,g,n,chunk,stages", [
    (1, 128, 2, 128, 1, 128, 128, 1),   # P = 128: the one-stage layout
    (1, 320, 2, 64, 1, 64, 64, 2),      # N = 64, T of 5 chunks
    (2, 64, 8, 32, 2, 32, 32, 2),       # G = 2 with H = 8, chunk 32
    (1, 64, 8, 64, 2, 128, 64, 2),      # T of 1 chunk, chunk 64
    (1, 160, 4, 20, 2, 36, 32, 2),      # P, N not multiples of 8
])
def test_ssd_mma_kernel_matches_plain_on_card(cuda_device, b, t, h, p, g, n,
                                              chunk, stages):
    """bfloat16 shapes of every layout go through the tensor-core
    instance (its own counter moves) and match the plain version and the
    sequential oracle."""
    args = _ssd_inputs(np.random.default_rng(t + p + n), b, t, h, p, g, n,
                       torch.bfloat16, cuda_device)
    assert pssd.instance(torch.bfloat16, n) == "mma"
    assert pssd.mma_stages(chunk, p, n) == stages
    before = (pssd.ssd_chunk_scan.launches, pssd.ssd_chunk_scan.mma_launches)
    y, s = ops.ssd_scan(*args, chunk=chunk, impl="cuda")
    yw, sw = ops.ssd_scan(*args, chunk=chunk, impl="torch")
    torch.cuda.synchronize()
    assert (pssd.ssd_chunk_scan.launches,
            pssd.ssd_chunk_scan.mma_launches) == (before[0] + 1,
                                                  before[1] + 1)
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               yw.float().cpu().numpy(),
                               **SSD_TOL[torch.bfloat16])
    np.testing.assert_allclose(s.cpu().numpy(), sw.cpu().numpy(),
                               **SSD_TOL[torch.float32])
    yr, sr = ref.ssd_ref(*args)
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               yr.float().cpu().numpy(),
                               **SSD_TOL[torch.bfloat16])
    np.testing.assert_allclose(s.cpu().numpy(), sr.cpu().numpy(), atol=1e-3)


def test_ssd_mma_stages_match_the_source_on_card(cuda_device):
    fn = _build.load("ssd_chunk_scan").ssd_chunk_scan_mma_stages
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    for chunk in pssd.CHUNKS:
        for p in (4, 16, 36, 64, 100, 128):
            for n in (4, 16, 40, 64, 128):
                assert fn(chunk, p, n) == pssd.mma_stages(chunk, p, n), (
                    chunk, p, n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_strong_decay_on_card(cuda_device, dtype):
    """dt up to 1 and A down to -16: cum falls below -1,000 inside a
    128-step chunk, where exp(-cum) overflows float32.  y and the state
    stay finite and match the plain version in both dtypes."""
    rng = np.random.default_rng(16)
    b, t, h, p, g, n = 2, 384, 4, 64, 1, 128
    x = rng.standard_normal((b, t, h, p)) * 0.5
    dt = rng.uniform(0.001, 1.0, (b, t, h))
    A = -np.linspace(0.5, 16.0, h)
    B = rng.standard_normal((b, t, g, n)) * 0.3
    C = rng.standard_normal((b, t, g, n)) * 0.3
    cum = np.cumsum((dt * A).reshape(b, t // 128, 128, h), axis=2)
    assert cum.min() < -1000.0
    cast = [dtype, torch.float32, torch.float32, dtype, dtype]
    args = [torch.as_tensor(u, dtype=torch.float32).to(cuda_device, c)
            for u, c in zip((x, dt, A, B, C), cast)]
    y, s = ops.ssd_scan(*args, chunk=128, impl="cuda")
    yw, sw = ops.ssd_scan(*args, chunk=128, impl="torch")
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               yw.float().cpu().numpy(), **SSD_TOL[dtype])
    np.testing.assert_allclose(s.cpu().numpy(), sw.cpu().numpy(),
                               **SSD_TOL[torch.float32])


@pytest.mark.parametrize("b,t,d", [(2, 64, 32), (1, 300, 16), (3, 1024, 8),
                                   (2, 3072, 4096)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_linear_recurrence_kernel_matches_plain_on_card(cuda_device, b, t, d,
                                                        dtype):
    rng = np.random.default_rng(t + d)
    a = torch.as_tensor(rng.uniform(0.6, 0.999, (b, t, d)),
                        dtype=torch.float32).to(cuda_device, dtype)
    x = torch.as_tensor(rng.standard_normal((b, t, d)),
                        dtype=torch.float32).to(cuda_device, dtype)
    before = plr.linear_recurrence.launches
    got = ops.linear_recurrence(a, x, impl="cuda")
    want = ops.linear_recurrence(a, x, impl="torch")
    torch.cuda.synchronize()
    assert plr.linear_recurrence.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    tol = LR_TOL if dtype == torch.float32 else dict(rtol=1e-2, atol=2e-2)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **tol)
    if dtype == torch.float32:
        # one rounded multiply and one rounded add a step, in the order of
        # the sequential oracle: equal to the last bit
        np.testing.assert_array_equal(
            got.cpu().numpy(), ref.linear_recurrence_ref(a, x).cpu().numpy())


@pytest.mark.parametrize("b,t,d,dtype", [
    (1, 3000, 4099, torch.float32),     # rows not 16-byte aligned
    (1, 3000, 4101, torch.bfloat16),
    (2, 3000, 4096, torch.float32),     # T not a multiple of the tile
    (2, 3000, 4096, torch.bfloat16),
])
def test_linear_recurrence_kernel_takes_ragged_shapes_on_card(cuda_device, b,
                                                              t, d, dtype):
    rng = np.random.default_rng(d)
    a = torch.as_tensor(rng.uniform(0.6, 0.999, (b, t, d)),
                        dtype=torch.float32).to(cuda_device, dtype)
    x = torch.as_tensor(rng.standard_normal((b, t, d)),
                        dtype=torch.float32).to(cuda_device, dtype)
    got = ops.linear_recurrence(a, x, impl="cuda")
    want = ops.linear_recurrence(a, x, impl="torch")
    torch.cuda.synchronize()
    tol = LR_TOL if dtype == torch.float32 else dict(rtol=1e-2, atol=2e-2)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **tol)
    if dtype == torch.float32:
        np.testing.assert_array_equal(
            got.cpu().numpy(), ref.linear_recurrence_ref(a, x).cpu().numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_linear_recurrence_kernel_takes_offset_and_strided_views_on_card(
        cuda_device, dtype):
    """A contiguous view one element past an aligned start (the kernel's
    element-wise copies) and a strided view (copied by the wrapper)."""
    b, t, d = 2, 700, 256
    rng = np.random.default_rng(7)
    flat_a = torch.as_tensor(rng.uniform(0.6, 0.999, b * t * d + 1),
                             dtype=torch.float32).to(cuda_device, dtype)
    flat_x = torch.as_tensor(rng.standard_normal(b * t * d + 1),
                             dtype=torch.float32).to(cuda_device, dtype)
    a = flat_a[1:].view(b, t, d)
    x = flat_x[1:].view(b, t, d)
    assert a.is_contiguous() and a.data_ptr() % 16 != 0
    wide_a = torch.as_tensor(rng.uniform(0.6, 0.999, (b, t, 2 * d)),
                             dtype=torch.float32).to(cuda_device, dtype)
    wide_x = torch.as_tensor(rng.standard_normal((b, t, 2 * d)),
                             dtype=torch.float32).to(cuda_device, dtype)
    tol = LR_TOL if dtype == torch.float32 else dict(rtol=1e-2, atol=2e-2)
    for u, v in ((a, x), (wide_a[:, :, 1::2], wide_x[:, :, 1::2])):
        got = ops.linear_recurrence(u, v, impl="cuda")
        want = ops.linear_recurrence(u, v, impl="torch")
        torch.cuda.synchronize()
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(), **tol)
        if dtype == torch.float32:
            np.testing.assert_array_equal(
                got.cpu().numpy(),
                ref.linear_recurrence_ref(u, v).cpu().numpy())


@pytest.mark.parametrize("arch,need", [
    ("mamba2-370m", ("ssd_chunk_scan", "rmsnorm")),
    ("recurrentgemma-9b", ("linear_recurrence", "flash_attention",
                           "rmsnorm")),
])
def test_recurrent_greedy_generate_kernels_match_plain_on_card(cuda_device,
                                                               arch, need):
    """The smoke configs in float32 on a 40-token prompt (mamba2: no chunk
    multiple; recurrentgemma: longer than the window): the prompt's
    kernels launch, and greedy tokens and prefill logits with the CUDA
    kernels equal those with the plain versions."""
    counters = {"ssd_chunk_scan": pssd.ssd_chunk_scan,
                "linear_recurrence": plr.linear_recurrence,
                "flash_attention": pfa.flash_attention,
                "rmsnorm": prms.rmsnorm}
    cfg = get_smoke_config(arch, dtype="float32", kernel_impl="cuda")
    plain = get_smoke_config(arch, dtype="float32", kernel_impl="torch")
    params = M.init_params(cfg, torch.Generator(cuda_device).manual_seed(0),
                           device=cuda_device)
    prompt = torch.as_tensor(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (2, 40)), device=cuda_device)
    before = {k: counters[k].launches for k in need}
    got = greedy_generate(cfg, params, prompt, steps=6, max_seq=64)
    for k in need:
        assert counters[k].launches > before[k], k
    want = greedy_generate(plain, params, prompt, steps=6, max_seq=64)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    lg, _ = M.prefill(cfg, params, prompt, 64)
    lw, _ = M.prefill(plain, params, prompt, 64)
    np.testing.assert_allclose(lg.cpu().numpy(), lw.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)


# -- the experiment runner on the card ---------------------------------------------
#: The runner against the fixtures of results/experiments (written by the
#: event engine): float64 solves agree to 1e-12, the metrics derived from
#: them are held at the exactness matrix's jitter-free rtol; obs14's
#: ``oracle_max_rel_diff`` is itself a relative difference, held
#: absolutely at the bound of its own check.
RUNNER_RTOL = 1e-9
RUNNER_ORACLE_ATOL = 1e-9


def _fixture_results():
    import glob
    import json
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = {}
    for path in glob.glob(os.path.join(root, "results", "experiments",
                                       "obs*.json")):
        with open(path) as f:
            data = json.load(f)
        out[data["name"]] = data
    return out


def test_experiment_runner_matches_fixtures_on_card(cuda_device):
    """All 15 observations in one fleet call on the CUDA fixpoint: one
    kernel launch, every check passed with the fixture's verdicts, every
    metric within rtol 1e-9 of the fixture."""
    from repro_torch.experiments import ExperimentRunner
    fixtures = _fixture_results()
    runner = ExperimentRunner(backend="vectorized", device=cuda_device)
    before = pfix.zns_fixpoint.launches
    results = runner.run()
    assert pfix.zns_fixpoint.launches == before + 1
    stats = runner.last_fleet.solve_stats
    assert stats.driver == "cuda" and stats.converged
    assert stats.n_blocks == 14
    assert len(results) == 15 == len(fixtures)
    for r in results:
        want = fixtures[r.name]
        assert r.backend == "vectorized" and r.passed and r.converged
        assert [(c.name, bool(c.ok)) for c in r.checks] \
            == [(c["name"], c["ok"]) for c in want["checks"]]
        assert set(r.metrics) == set(want["metrics"])
        for k, v in r.metrics.items():
            if k == "oracle_max_rel_diff":
                assert abs(v) <= RUNNER_ORACLE_ATOL
            else:
                np.testing.assert_allclose(v, want["metrics"][k],
                                           rtol=RUNNER_RTOL, atol=0,
                                           err_msg=f"{r.name}: {k}")


def _runner_program():
    from repro_torch.experiments import ExperimentRunner
    fleet, workloads, seeds = ExperimentRunner(device="cpu").fleet()
    prog = compile_fleet_program([w.build() for w in workloads],
                                 fleet.specs, [d.lat for d in fleet.devices],
                                 seeds=seeds, cache=False)
    return prog.issue_flat, prog.svc0_flat, [b.rows_view()
                                             for b in prog.families]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fixpoint_kernel_runner_program_on_card(cuda_device, dtype):
    """The runner's fleet program (46 members, 14 blocks, many short
    chains) at the runner's budget of 8 sweeps: the same sweeps and
    convergence as the plain version on the card, converged."""
    issue, svc, blocks = _runner_program()
    assert len(blocks) == 14
    got, want = _solve_both(cuda_device, issue, svc, blocks, 8, dtype)
    assert got[2] and want[2]


def test_fixpoint_kernel_14_blocks_between_3_block_solves_on_card(
        cuda_device):
    """A 3-block solve, the runner's 14-block solve, and a 3-block solve
    again in one process: the dynamic shared memory grows with the block
    count, and neither solve narrows the other's opt-in."""
    small = _hand_program("empty-family", np.random.default_rng(9))
    assert len(small[2]) == 3
    for issue, svc, blocks in (small, _runner_program(), small):
        got, _ = _solve_both(cuda_device, issue, svc, blocks, 8,
                             torch.float64)
        assert got[2]


# -- the stacked fixpoint: every shard of a plan in one launch ----------------
def _shards_of_shapes(rng, groups, links=()):
    """Shards whose blocks take the shapes of ``groups`` (one list of
    ``(rows, length)`` a shard; unequal block counts), each block over its
    own slots of the shard in a random order with random segment heads;
    ``links[s]`` adds to shard s a block of rows of 2 that tie the last
    lane of a row of its second block to the first lane of a row of its
    first, later issues feeding earlier ones (so the shard takes several
    sweeps)."""
    shards = []
    for s, shapes in enumerate(groups):
        blocks, n = [], 0
        for rows, length in shapes:
            g = n + rng.permutation(rows * length).reshape(rows, length)
            n += rows * length
            blocks.append((g.astype(np.int32),
                           rng.uniform(size=(rows, length)) < 0.05))
        if s < len(links) and links[s]:
            a, b = blocks[0][0], blocks[1][0]
            k = min(a.shape[0], b.shape[0], 40)
            pairs = np.stack([b[:k, -1], a[:k, 0]], axis=1)
            blocks.append((pairs.astype(np.int32),
                           np.array([[True, False]] * k)))
        issue = np.sort(rng.uniform(0, 1e5, n))
        svc = rng.uniform(1, 50, n)
        shards.append((issue, svc, blocks))
    return shards


def _solve_stack(cuda_device, shards, sweeps, dtype, instance=None):
    """Stacked kernel (the instance stack_launch picks, which must be
    ``instance`` where one is named), its plain version, and the
    single-program kernel on each shard: completions, sweeps and
    convergence agree shard by shard.  Returns the kernel's (used,
    converged)."""
    packed = pfix.pack_shards([(b, len(i), None) for i, _, b in shards],
                              cuda_device)
    init = np.full(packed.total, -np.inf)
    svc = np.zeros(packed.total)
    for (i, s, _), b in zip(shards, packed.base):
        init[b:b + len(i)] = i + s
        svc[b:b + len(i)] = s
    c0 = torch.as_tensor(init, dtype=dtype, device=cuda_device)
    sv = torch.as_tensor(svc, dtype=dtype, device=cuda_device)
    before = pfix.zns_fixpoint_sharded.launches
    got = ops.zns_fixpoint_sharded(c0, sv, packed, sweeps=sweeps,
                                   impl="cuda")
    assert pfix.zns_fixpoint_sharded.launches == before + 1
    launch = pfix.zns_fixpoint_sharded.last_launch
    want_shape = pfix.stack_launch(
        packed, pfix.cluster_fits(dtype, packed.F), pfix._lib().tile)
    assert launch["instance"] == want_shape["instance"]
    assert instance in (None, launch["instance"])
    want = ops.zns_fixpoint_sharded(c0, sv, packed, sweeps=sweeps,
                                    impl="torch")
    tol = F64 if dtype == torch.float64 else F32_FIX
    for k, ((i, s, blocks), b) in enumerate(zip(shards, packed.base)):
        n = len(i)
        one = ops.zns_fixpoint(c0[b:b + n], sv[b:b + n], blocks,
                               sweeps=sweeps, impl="cuda")
        for other, what in ((want[0][b:b + n], "plain"),
                            (one[0], "single kernel")):
            np.testing.assert_allclose(
                got[0][b:b + n].cpu().numpy(), other.cpu().numpy(), **tol,
                err_msg=f"shard {k} against the {what}")
        assert bool(got[2][k]) == bool(want[2][k]) == one[2]
        if dtype == torch.float64:
            assert got[1][k] == want[1][k] == one[1]
    return got[1], got[2]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sharded_kernel_matches_plain_on_card(cuda_device, dtype):
    """Three shards of 5, 3 and 6 blocks (1 to 4,097 lanes; two with a
    linking block, so they take several sweeps) in one launch: each
    shard equals the plain version and the single-program kernel."""
    rng = np.random.default_rng(23)
    groups = [PACKED_SHAPES[:5], PACKED_SHAPES[5:7], PACKED_SHAPES[6:]]
    used, conv = _solve_stack(cuda_device,
                              _shards_of_shapes(rng, groups, (True, False,
                                                              True)),
                              64, dtype)
    assert conv.all() and used[0] > 1 and used[2] > 1
    launch = pfix.zns_fixpoint_sharded.last_launch
    assert launch["shards"] == 3 and launch["slots"] == 7


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sharded_kernel_one_shard_on_card(cuda_device, dtype):
    """A stack of one shard is the single solve."""
    rng = np.random.default_rng(5)
    _solve_stack(cuda_device, _shards_of_shapes(rng, [PACKED_SHAPES[3:9]],
                                                (True,)), 16, dtype)


def test_sharded_kernel_shards_stop_on_their_own_on_card(cuda_device):
    """One shard converges in one sweep, one after several, and one runs
    out of a budget of 2 sweeps: every shard keeps its own count and
    convergence (the reference's lax.map of one while_loop a shard)."""
    rng = np.random.default_rng(11)
    easy = _shards_of_shapes(rng, [[(30, 50)]])[0]
    hand = _hand_program("empty-family", rng)
    hard = _contended_fleet_program()
    used, conv = _solve_stack(cuda_device, [easy, hand, hard], 2,
                              torch.float64)
    assert used[0] == 1 and conv[0]
    assert not conv[2] and used[2] == 2
    used, conv = _solve_stack(cuda_device, [easy, hand, hard], 64,
                              torch.float64)
    assert conv.all() and used[0] == 1 and used[2] > 2


#: A shard whose widest pass takes 40 tiles: three a block of 16, so
#: stack_launch sends a plan that holds it to the grid instance.
WIDE_GRID = [(40, 2000), (9, 200)]


@pytest.mark.parametrize("instance", ["cluster", "grid"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_stacked_instances_match_plain_on_card(cuda_device, instance,
                                               dtype):
    """Both instances on three shards of 5, 3 and 6 blocks (1 to 4,097
    lanes; the 4,097-lane row spans three tiles, so its carry crosses
    blocks of a cluster), two taking several sweeps, which take the
    cluster instance; with a fourth, 40-tile shard they take the grid
    instance.  Each shard equals the plain version and the single-program
    kernel, sweeps equal in float64."""
    rng = np.random.default_rng(23)
    groups = [PACKED_SHAPES[:5], PACKED_SHAPES[5:7], PACKED_SHAPES[6:]]
    links = (True, False, True)
    if instance == "grid":
        groups, links = groups + [WIDE_GRID], links + (True,)
    used, conv = _solve_stack(cuda_device,
                              _shards_of_shapes(rng, groups, links),
                              64, dtype, instance)
    assert conv.all() and used[0] > 1 and used[2] > 1


@pytest.mark.parametrize("instance", ["cluster", "grid"])
def test_stacked_instances_shards_stop_on_their_own_on_card(cuda_device,
                                                            instance):
    """Both instances: one shard converges in one sweep and another runs
    out of a budget of 2 sweeps, each with its own count.  With the contended
    fleet's program (96 tiles in a pass) the plan takes the grid
    instance; with a narrow linked shard instead, the cluster instance."""
    rng = np.random.default_rng(11)
    easy = _shards_of_shapes(rng, [[(30, 50)]])[0]
    hand = _hand_program("empty-family", rng)
    if instance == "grid":
        shards, out = [easy, hand, _contended_fleet_program()], 2
    else:
        linked = _shards_of_shapes(np.random.default_rng(23),
                                   [PACKED_SHAPES[:5]], (True,))[0]
        shards, out = [easy, hand, linked], 1
    used, conv = _solve_stack(cuda_device, shards, 2, torch.float64,
                              instance)
    assert used[0] == 1 and conv[0]
    assert not conv[out] and used[out] == 2


@pytest.mark.parametrize("instance,wide", [
    ("cluster", [(15, 4000), (30, 2000)]),
    ("grid", [(20, 4000), WIDE_GRID[0]])])
def test_stacked_wide_shard_among_narrow_on_card(cuda_device, instance,
                                                 wide):
    """One shard whose passes take 30 tiles (two a block of a cluster of
    16: their aggregates go through the cluster's slice of the scratch),
    or 40 (the grid instance), among six of one tile."""
    rng = np.random.default_rng(31)
    groups = [wide] + [[(9, 200), (3, 500)]] * 6
    used, conv = _solve_stack(cuda_device,
                              _shards_of_shapes(rng, groups, (True,)), 64,
                              torch.float64, instance)
    assert conv.all() and used[0] > 1
    assert pfix.zns_fixpoint_sharded.last_launch["widest"] == (
        30 if instance == "cluster" else 40)


def test_stacked_cluster_more_shards_than_clusters_on_card(cuda_device):
    """More shards than clusters fit on the card: the clusters take shard
    after shard (rounds > 1), and every shard still equals its plain
    version and the single-program kernel."""
    rng = np.random.default_rng(41)
    fits = pfix.cluster_fits(torch.float64, 2)
    S = 2 * max(fits.values()) + 3
    shards = _shards_of_shapes(rng, [[(4, 300), (2, 600)]] * S,
                               [s % 2 == 0 for s in range(S)])
    used, conv = _solve_stack(cuda_device, shards, 16, torch.float64)
    launch = pfix.zns_fixpoint_sharded.last_launch
    assert launch["instance"] == "cluster" and launch["rounds"] >= 2
    assert launch["clusters"] == pfix.cluster_fits(
        torch.float64, launch["slots"])[launch["cluster"]]
    assert conv.all()


def test_stacked_cluster_queries_match_their_mirrors_on_card(cuda_device):
    """The library's cluster occupancy for either size, and the launch a
    plan like phase 2's 16-shard one takes from it, as stack_launch
    computes it: clusters of 8, two tiles a block."""
    fits = pfix.cluster_fits(torch.float64, 7)
    assert set(fits) == set(pfix.CLUSTER_SIZES)
    assert all(n >= 1 for n in fits.values())
    assert fits[8] >= fits[16]
    rng = np.random.default_rng(3)
    shards = _shards_of_shapes(rng, [[(32, 750), (30, 858)]] * 16)
    packed = pfix.pack_shards([(b, len(i), None) for i, _, b in shards],
                              cuda_device)
    shape = pfix.stack_launch(packed, pfix.cluster_fits(torch.float64,
                                                        packed.F))
    assert (shape["instance"], shape["cluster"], shape["widest"]) == (
        "cluster", 8, 16)
    assert shape["clusters"] == min(16, pfix.cluster_fits(
        torch.float64, packed.F)[8])


def test_sharded_kernel_limits_match_the_library_on_card(cuda_device):
    lib = pfix._lib()
    assert lib.zns_fixpoint_max_shards() == pfix.MAX_SHARDS
    assert lib.zns_fixpoint_max_flags() == pfix.MAX_FLAGS


def test_sharded_and_windowed_solves_match_cuda_on_card(cuda_device):
    """solve_program's sharded driver (the mesh executor: one stacked
    launch for the runner's 16-shard plan) and windowed driver (one
    launch a window) against the single-program kernel."""
    from repro_torch.core import solve_program
    from repro_torch.core import shard as pshard
    from repro_torch.experiments import ExperimentRunner
    fleet, workloads, seeds = ExperimentRunner(device="cpu").fleet()
    prog = compile_fleet_program([w.build() for w in workloads],
                                 fleet.specs, [d.lat for d in fleet.devices],
                                 seeds=seeds, cache=False)
    assert pshard.shard_program(prog).n_shards == 16
    want, _, conv = solve_program(prog, prog.svc0_flat, fixpoint="cuda",
                                  device=cuda_device)
    assert conv
    before = pfix.zns_fixpoint_sharded.launches
    got, _, conv = solve_program(prog, prog.svc0_flat, fixpoint="sharded",
                                 device=cuda_device)
    assert conv and pfix.zns_fixpoint_sharded.launches == before + 1
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0.0)
    before = pfix.zns_fixpoint.launches
    got, _, conv = pshard.solve_program_windowed(
        prog, prog.svc0_flat, n_windows=4, device=cuda_device)
    assert conv and pfix.zns_fixpoint.launches == before + 4
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0.0)


def test_sharded_single_entry_program_runs_the_kernel_on_card(cuda_device):
    """fixpoint="sharded" on a one-entry program (the README quickstart's
    shape: a 1-shard plan) launches the single-program kernel on the card,
    bit-identical to fixpoint="cuda", and never the host loop."""
    from repro_torch.core import ZnsDevice, solve_program
    from repro_torch.core import shard as pshard
    wl = (WorkloadSpec().writes(n=20_000, size=4 * KiB, qd=4)
          .reads(n=20_000, size=4 * KiB, qd=16, zone=100, nzones=64))
    dev = ZnsDevice(device=cuda_device)
    prog = compile_fleet_program([wl.build()], [dev.spec], [dev.lat],
                                 cache=False)
    assert prog.n_devices == 1
    assert pshard.shard_program(prog).n_shards == 1
    want, u_want, conv = solve_program(prog, prog.svc0_flat,
                                       fixpoint="cuda", device=cuda_device)
    assert conv
    before = pfix.zns_fixpoint.launches
    got, u_got, conv = solve_program(prog, prog.svc0_flat,
                                     fixpoint="sharded", device=cuda_device)
    assert conv and pfix.zns_fixpoint.launches == before + 1
    assert u_got == u_want
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0.0)


def test_host_policies_one_launch_on_card(cuda_device):
    """compare_policies on the card: one fleet call, one fixpoint
    launch, rows within rtol 1e-9 of the host event engine's."""
    from repro_torch.host import compare_policies, rank_policies
    before = pfix.zns_fixpoint.launches
    rows = compare_policies(device=cuda_device)
    assert pfix.zns_fixpoint.launches == before + 1
    ev = compare_policies(backend="event", device="cpu")
    assert rank_policies(rows) == rank_policies(ev)
    for a, b in zip(rows, ev):
        for k in ("makespan_s", "user_bandwidth_mibs"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-9, atol=0)


def _same_cluster_entries(got, want):
    """Two plan_capacity reports' compiled entries: programs and FIFO pop
    orders exactly, completions to the float64 contract."""
    assert len(got.compiled) == len(want.compiled)
    for g, w in zip(got.compiled, want.compiled):
        assert (g.program.refine_used, g.program.order_stable) \
            == (w.program.refine_used, w.program.order_stable)
        assert len(g.fifo_chains) == len(w.fifo_chains)
        for gc, wc in zip(g.fifo_chains, w.fifo_chains):
            assert len(gc) == len(wc)
            assert all(np.array_equal(a, b) for a, b in zip(gc, wc))
        for gf, wf in zip(g.program.families, w.program.families):
            assert gf.label == wf.label
            assert np.array_equal(gf.gidx, wf.gidx)
            assert np.array_equal(gf.heads, wf.heads)
        np.testing.assert_allclose(g.comp, w.comp, **F64)
    np.testing.assert_allclose(got.comp, want.comp, **F64)


@pytest.mark.parametrize("mode", ["users", "rate-warm"])
def test_cluster_plan_capacity_matches_cpu_on_card(cuda_device, mode):
    """plan_capacity on the card against device="cpu": the same programs
    and pop orders, completions to rtol 1e-12, and one fixpoint launch a
    solve (each compile's bootstrap and refinements, and the fleet)."""
    from repro_torch.cluster import (ClusterConfig, ClusterSpec,
                                     ClusterWorkload, erasure,
                                     plan_capacity, replication)
    configs = [ClusterConfig(erasure(2, 1), "round-robin"),
               ClusterConfig(replication(2, copies=2), "hashed")]
    kw = dict(base_spec=ClusterSpec(n_gateways=2, n_servers=6),
              workload=ClusterWorkload(n_users=3, ops_per_user=3,
                                       object_bytes=1 << 20, seed=3),
              slo_us=20e3)
    if mode == "rate-warm":
        kw.update(rate_ladder=[2000.0, 8000.0, 32000.0], warm_ladder=True)
    before = pfix.zns_fixpoint.launches
    got = plan_capacity(configs, [2, 4], device=cuda_device, **kw)
    launches = pfix.zns_fixpoint.launches - before
    want = plan_capacity(configs, [2, 4], device="cpu", **kw)
    assert got.converged and got.to_json().keys() == want.to_json().keys()
    _same_cluster_entries(got, want)
    for gc, wc in zip(got.curves, want.curves):
        for gp, wp in zip(gc.points, wc.points):
            np.testing.assert_allclose(gp.lat.p99_us, wp.lat.p99_us, **F64)
    assert (got.warm_hits, got.warm_attempts) \
        == (want.warm_hits, want.warm_attempts)
    if mode == "users":
        assert launches == 1 + sum(1 + c.program.refine_used
                                   for c in got.compiled)
    else:
        assert launches > len(got.compiled)


def test_cluster_loop_driver_matches_cuda_on_card(cuda_device):
    """fixpoint="loop" on the card runs the batched scan kernel around the
    host loop and equals the cuda driver to rtol 1e-12."""
    from repro_torch.cluster import (Cluster, ClusterSpec, ClusterWorkload,
                                     erasure)
    spec = ClusterSpec(n_gateways=2, n_servers=6, scheme=erasure(3, 1))
    wl = ClusterWorkload(n_users=3, ops_per_user=4, object_bytes=1 << 20,
                         seed=3)
    before = pscan.zns_event_scan_batched.launches
    loop = Cluster(spec, device=cuda_device).run(wl, fixpoint="loop")
    assert pscan.zns_event_scan_batched.launches > before
    cuda = Cluster(spec, device=cuda_device).run(wl)
    assert loop.converged and cuda.converged
    for a, b in zip(loop.compiled.fifo_chains, cuda.compiled.fifo_chains):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    np.testing.assert_allclose(loop.comp, cuda.comp, **F64)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "arctic-480b"])
def test_moe_greedy_generate_kernels_match_plain_on_card(cuda_device, arch):
    """The MoE smoke configs in float32 on the card: the greedy tokens with
    the CUDA kernels (attention, RMSNorm; the dispatch and expert products
    are torch ops) equal those with the plain versions, the prefill
    logits agree, and both runs route every token alike."""
    cfg = get_smoke_config(arch, dtype="float32", kernel_impl="cuda")
    plain = get_smoke_config(arch, dtype="float32", kernel_impl="torch")
    params = M.init_params(cfg, torch.Generator(cuda_device).manual_seed(0),
                           device=cuda_device)
    prompt = torch.as_tensor(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (2, 24)), device=cuda_device)
    before = (pfa.flash_attention.launches, prms.rmsnorm.launches)
    got = greedy_generate(cfg, params, prompt, steps=6, max_seq=32)
    assert pfa.flash_attention.launches > before[0]
    assert prms.rmsnorm.launches > before[1]
    want = greedy_generate(plain, params, prompt, steps=6, max_seq=32)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    routes = []
    for c in (cfg, plain):
        for layer in params.layers:
            layer.routing = []
        lg, _ = M.prefill(c, params, prompt, 32)
        routes.append([ly.routing[0].expert_idx.cpu() for ly in params.layers])
        routes[-1].append(lg.cpu().numpy())
    for a, b in zip(routes[0][:-1], routes[1][:-1]):
        assert torch.equal(a, b)
    np.testing.assert_allclose(routes[0][-1], routes[1][-1], rtol=1e-4,
                               atol=1e-4)


def test_checkpoint_save_is_one_batched_scan_on_card(cuda_device, tmp_path):
    """ZonedCheckpointStore.save on the card: one launch of the batched
    scan kernel for all hosts, a manifest (bytes, zones, sha256, modeled
    seconds) equal to the same save on the CPU, a bit-exact restore; and
    one host's payload write is one launch of the scan kernel, within
    1e-12 of the CPU's."""
    from repro_torch.core import MiB
    from repro_torch.runtime import ZnsHostDevice, ZonedCheckpointStore
    rng = np.random.default_rng(0)
    tree = {"w": torch.as_tensor(rng.standard_normal((64, 1000)),
                                 dtype=torch.float32, device=cuda_device),
            "b": torch.as_tensor(rng.standard_normal((10, 7)),
                                 device=cuda_device).to(torch.bfloat16),
            "n": {"s": torch.arange(5, device=cuda_device)}}
    out = {}
    for dev in (cuda_device, "cpu"):
        store = ZonedCheckpointStore(str(tmp_path / str(dev)), 4,
                                     stripe_bytes=64 * 1024, device=dev)
        before = (pscan.zns_event_scan_batched.launches,
                  pscan.zns_event_scan.launches)
        out[str(dev)] = store.save(1, tree)["manifest"]
        after = (pscan.zns_event_scan_batched.launches,
                 pscan.zns_event_scan.launches)
        if dev is cuda_device:
            assert after == (before[0] + 1, before[1])
            restored, _ = store.restore(1, tree)
            for k in ("w", "b"):
                t = tree[k].cpu()
                if t.dtype == torch.bfloat16:
                    t = t.view(torch.int16)
                assert restored[k].tobytes() == t.numpy().tobytes()
        else:
            assert after == before
    got, want = out[str(cuda_device)], out["cpu"]
    for h, info in want["hosts"].items():
        assert got["hosts"][h] == info
    np.testing.assert_allclose(got["modeled_host_seconds"],
                               want["modeled_host_seconds"], rtol=1e-12,
                               atol=0)
    for kw in (dict(stripe_bytes=4 * 1024, append_qd=1),
               dict(stripe_bytes=1 * MiB, append_qd=4)):
        before = pscan.zns_event_scan.launches
        t, n = ZnsHostDevice(0, device=cuda_device,
                             **kw).simulate_payload_write(256 * MiB)
        assert pscan.zns_event_scan.launches == before + 1
        t_cpu, n_cpu = ZnsHostDevice(0, device="cpu",
                                     **kw).simulate_payload_write(256 * MiB)
        assert n == n_cpu
        np.testing.assert_allclose(t, t_cpu, rtol=1e-12, atol=0)


def _two_rank_ring(rank, report):
    """On each of two gloo ranks sharing cuda:0: ring attention and its
    gradient on a (1, 2) mesh against the plain attention's, and a
    ppermute's forward and backward against the block swap they are."""
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = Mesh((1, 2), ("data", "model"), backend="gloo", device="cuda")
    g = torch.Generator("cuda").manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g, device="cuda")
               for shape in ((2, 4, 128, 32), (2, 2, 128, 32),
                             (2, 2, 128, 32)))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = ring_attention(mesh, *leaves, causal=True)
    (out ** 2).sum().backward()
    want = ref.attention_ref(*plain, causal=True)
    (want ** 2).sum().backward()
    errs = {"ring": float((out - want).abs().max())}
    for name, a, b in zip("qkv", leaves, plain):
        errs[f"d{name}"] = float((a.grad - b.grad).abs().max()
                                 / b.grad.abs().max())
    a = torch.randn((3, 8), generator=g, device="cuda", requires_grad=True)
    w = torch.randn((3, 8), generator=g, device="cuda")
    swap = shard_map(lambda t: comm.ppermute(mesh, t, "model",
                                             [(0, 1), (1, 0)]),
                     mesh, in_specs=(PS(None, "model"),),
                     out_specs=PS(None, "model"))
    y = swap(a)
    (y * w).sum().backward()
    errs["ppermute"] = float((y - a.roll(4, dims=1)).abs().max())
    errs["ppermute_bwd"] = float((a.grad - w.roll(4, dims=1)).abs().max())
    return errs


def test_ring_attention_and_ppermute_on_two_gloo_ranks(cuda_device):
    """A 2-rank gloo world on one card (NCCL takes one GPU a rank)."""
    for errs in launch.run(_two_rank_ring, 2, backend="gloo",
                           device=cuda_device, timeout=180):
        assert errs["ring"] < 1e-4, errs
        assert max(errs[f"d{n}"] for n in "qkv") < 1e-4, errs
        assert errs["ppermute"] == 0 and errs["ppermute_bwd"] == 0, errs
