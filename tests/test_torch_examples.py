"""The port's examples and its ZNS hillclimb script (``examples/*_torch.py``,
``scripts/zns_hillclimb_torch.py``) held against the reference's files on
the CPU.  The reference runs as itself: its ``main`` with ``sys.argv``
patched and its standard output captured; the port's body runs on
``device="cpu"`` from the same inputs (for the models, the reference's
own init carried across with ``repro_torch.models``' converters)."""
import contextlib
import dataclasses
import importlib.util
import io
import os
import re
import sys
import tempfile

import jax
import numpy as np
import pytest

from repro import models as RM
from repro.configs import get_smoke_config as r_smoke
from repro.runtime import ZonedCheckpointStore as RStore
from repro.runtime.zns_store import ZnsHostDevice as RHost
from repro.train import TrainState as RTrainState

from repro_torch import models as M

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: The ZNS numbers: both run the same float64 arithmetic (the scans agree
#: to ~1e-16 of each other)
ZNS_REL = 1e-9
#: quickstart's printed losses (steps 0, 5, 10, 15) against the port's
#: from the reference's init, bfloat16 activations in both: the largest
#: relative difference read is 1.8e-4 (step 5), the printed 4 decimals
#: included
QS_LOSS_REL = 1e-3
#: train_small at its default width, 40 steps, bfloat16 activations: the
#: relative differences read are 6.0e-4 at step 0, 1.7e-2 at step 25
#: (24 AdamW steps on roundings at other places), 2.4e-3 and 4.0e-4 in
#: the first-10 and last-10 means
TS_LOSS_REL = {"step 0": 3e-3, "step 25": 5e-2, "first": 1e-2,
               "last": 1e-2}
_NUM = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?")


def _load(rel: str):
    """A file of the repo as a module (its ``__main__`` block does not
    run)."""
    name = "ex_" + re.sub(r"\W", "_", rel)
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _captured(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue()


def _reference(rel: str, argv, monkeypatch):
    """The reference file's ``main()`` as ``python <rel> <argv>`` runs it;
    returns ``(module, stdout, exit code)`` (None where ``main`` returns
    without ``sys.exit``)."""
    mod = _load(rel)
    monkeypatch.setattr(sys, "argv", [os.path.join(ROOT, rel), *argv])
    buf, code = io.StringIO(), None
    with contextlib.redirect_stdout(buf):
        try:
            mod.main()
        except SystemExit as e:
            code = e.code
    return mod, buf.getvalue(), code


def _same_numbers(got: str, want: str, rel: float = ZNS_REL) -> None:
    """The same text with every number within ``rel``."""
    assert _NUM.sub("#", got) == _NUM.sub("#", want), (got, want)
    g = [float(x) for x in _NUM.findall(got)]
    w = [float(x) for x in _NUM.findall(want)]
    assert len(g) == len(w)
    np.testing.assert_allclose(g, w, rtol=rel, atol=0)


@pytest.fixture
def payload_times(monkeypatch):
    """Records the reference's unrounded ``simulate_payload_write``
    results, in call order."""
    seen = []
    orig = RHost.simulate_payload_write

    def wrapped(self, nbytes):
        out = orig(self, nbytes)
        seen.append(out)
        return out

    monkeypatch.setattr(RHost, "simulate_payload_write", wrapped)
    return seen


def test_zns_checkpointing_matches_reference(monkeypatch, payload_times):
    _, want, _ = _reference("examples/zns_checkpointing.py", [],
                            monkeypatch)
    port = _load("examples/zns_checkpointing_torch.py")
    out, got = _captured(port.run, device="cpu")
    _same_numbers(got, want)
    assert len(payload_times) == len(out["policies"]) == 4
    for (t, n), (rt, rn) in zip(out["policies"].values(), payload_times):
        assert n == rn and t == pytest.approx(rt, rel=ZNS_REL, abs=0)
    assert out["zones_reset"] > 0 and out["gc_s"] > 0


def test_zns_hillclimb_matches_reference(monkeypatch, payload_times):
    ref = _load("scripts/zns_hillclimb.py")
    walls = []
    orig = ref.fleet_wall

    def fleet_wall(*a, **kw):
        walls.append(orig(*a, **kw))
        return walls[-1]

    monkeypatch.setattr(ref, "fleet_wall", fleet_wall)
    monkeypatch.setattr(sys, "argv", [ref.__file__])
    _, want = _captured(ref.main)
    port = _load("scripts/zns_hillclimb_torch.py")
    out, got = _captured(port.run, device="cpu")
    _same_numbers(got, want)
    rows = list(out["rows"].values())
    assert len(rows) == len(walls) == len(payload_times) == 6
    for row, (wall, med), (t, n) in zip(rows, walls, payload_times):
        assert row["wall"] == pytest.approx(wall, rel=ZNS_REL, abs=0)
        assert row["med"] == pytest.approx(med, rel=ZNS_REL, abs=0)
        assert row["req"] == n
    assert out["base"] / out["best"] == pytest.approx(125.65 / 17.50,
                                                      rel=1e-3)


def test_failover_demo_matches_reference(monkeypatch):
    _, want, _ = _reference("examples/failover_demo.py", [], monkeypatch)
    port = _load("examples/failover_demo_torch.py")
    out, got = _captured(port.run, device="cpu")
    assert got == want
    assert out["plan"] is not None and len(out["pipes"]) == 7


def test_quickstart_matches_reference(monkeypatch):
    _, want, _ = _reference("examples/quickstart.py", [], monkeypatch)
    port = _load("examples/quickstart_torch.py")
    cfg = port.config()
    rstate = RTrainState.create(r_smoke("qwen3-4b"), jax.random.PRNGKey(0))
    state = M.train_state_from_reference(
        cfg, jax.tree.map(np.asarray, rstate), device="cpu")
    out, got = _captured(port.run, cfg, state, device="cpu")
    assert got.splitlines()[0] == want.splitlines()[0]    # the model line
    steps = [(int(i), float(x)) for i, x in
             re.findall(r"^step (\d+): loss=([\d.]+)$", want, re.M)]
    assert [i for i, _ in steps] == [0, 5, 10, 15]
    for i, loss in steps:
        assert out["losses"][i] == pytest.approx(loss, rel=QS_LOSS_REL), i
    tokens = [int(x) for x in re.findall(r"\d+", want.split(
        "greedy tokens:")[1])]
    np.testing.assert_array_equal(out["tokens"].ravel(), tokens)
    assert out["tokens"].shape == (2, 8)


def _serve_lines(text: str) -> list:
    return [line for line in text.splitlines()
            if line.startswith(("served", "  req"))]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_serve_batch_matches_reference(monkeypatch, dtype):
    """float32: the same requests served, decode steps, and each printed
    request's length and first 8 tokens.  bfloat16 (the reference's smoke
    config as it is): both frameworks round every activation to 8
    mantissa bits at places that differ (``tests/test_torch_serve.py``
    holds greedy tokens in float32 only), so a request's tokens part
    after a few steps (and where one draws the end-of-sequence token);
    all 12 requests are served in both."""
    ref = _load("examples/serve_batch.py")
    rcfg = dataclasses.replace(r_smoke("tinyllama-1.1b"), dtype=dtype)
    if dtype != "bfloat16":
        monkeypatch.setattr(ref, "get_smoke_config", lambda name: rcfg)
    monkeypatch.setattr(sys, "argv", [ref.__file__])
    _, want = _captured(ref.main)
    port = _load("examples/serve_batch_torch.py")
    cfg = dataclasses.replace(port.config(), dtype=dtype)
    params = M.params_from_reference(cfg, jax.tree.map(
        np.asarray, RM.init_params(rcfg, jax.random.PRNGKey(0))),
        device="cpu")
    out, got = _captured(port.run, cfg, params, device="cpu")
    assert out["done"] == port.N_REQUESTS
    assert f"served {out['done']}/12 requests" in want
    if dtype == "float32":
        assert _serve_lines(got) == _serve_lines(want)
        assert len(_serve_lines(got)) == 5


def test_train_small_matches_reference(monkeypatch, tmp_path):
    saves = []
    orig = RStore.save

    def save(self, *a, **kw):
        saves.append(orig(self, *a, **kw))
        return saves[-1]

    monkeypatch.setattr(RStore, "save", save)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    ref, want, code = _reference("examples/train_small.py",
                                 ["--steps", "40"], monkeypatch)
    assert code == 0 and len(saves) == 1

    port = _load("examples/train_small_torch.py")
    cfg = port.model_config(False)
    rstate = RTrainState.create(ref.model_config(False),
                                jax.random.PRNGKey(0))
    state = M.train_state_from_reference(
        cfg, jax.tree.map(np.asarray, rstate), device="cpu")
    out, got = _captured(port.run, cfg, state, steps=40, device="cpu")
    assert os.listdir(tmp_path) == []        # both removed their directory
    assert got.splitlines()[0] == want.splitlines()[0]    # params: 4.0M
    steps = dict(re.findall(r"^step (\d+): loss=([\d.]+)$", want, re.M))
    assert sorted(steps, key=int) == ["0", "25"]
    for i in ("0", "25"):
        assert out["losses"][int(i)] == pytest.approx(
            float(steps[i]), rel=TS_LOSS_REL[f"step {i}"])
    first, last = map(float, re.search(r"^loss: ([\d.]+) -> ([\d.]+) \(OK\)$",
                                       want, re.M).groups())
    assert out["first"] == pytest.approx(first, rel=TS_LOSS_REL["first"])
    assert out["last"] == pytest.approx(last, rel=TS_LOSS_REL["last"])
    assert out["improved"]
    # the checkpoint: the same bytes, so the same modeled wall and host
    # bandwidth; the restored step
    rsave = saves[-1]
    assert out["saved"]["wall_seconds"] == pytest.approx(
        rsave["wall_seconds"], rel=ZNS_REL, abs=0)
    assert out["saved"]["reports"][0].bandwidth_mibs == pytest.approx(
        rsave["reports"][0].bandwidth_mibs, rel=ZNS_REL, abs=0)
    line = r"^checkpoint@20: .*$|^restored at step \d+; resuming$"
    assert re.findall(line, got, re.M) == re.findall(line, want, re.M)
    assert out["restored_step"] == 20
