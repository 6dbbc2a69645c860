"""The port's CUDA kernels held against their plain PyTorch versions on
the card.  Every test here is marked ``gpu`` and skips without a CUDA
device; the file imports only ``repro_torch``, so it runs on a machine
without JAX::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import KiB, OpType, WorkloadSpec, ZnsDevice, \
    compile_program
from repro_torch.kernels import ops, zns_event_scan as pscan
from repro_torch.kernels import zns_fixpoint as pfix

F32_SCAN = dict(rtol=1e-5, atol=1e-2)
F32_FIX = dict(rtol=2e-5, atol=1e-2)
F64 = dict(rtol=1e-12, atol=1e-9)

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
