"""The port's dry-run scripts (``scripts/make_experiments_tables_torch.py``,
``scripts/inspect_collectives_torch.py``) on the CPU, and what all eight
example and script files of the port import and where they run."""
import contextlib
import importlib.util
import io
import os
import re
import subprocess
import sys

import pytest

from repro_torch.launch import dryrun as D
from repro_torch.launch.roofline import load_cells, roofline_row

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
#: The port's example and script files, each with the arguments it needs
FILES = {
    "examples/quickstart_torch.py": [],
    "examples/serve_batch_torch.py": [],
    "examples/train_small_torch.py": [],
    "examples/zns_checkpointing_torch.py": [],
    "examples/failover_demo_torch.py": [],
    "scripts/zns_hillclimb_torch.py": [],
    "scripts/make_experiments_tables_torch.py": [],
    "scripts/inspect_collectives_torch.py": ["--arch", "tinyllama-1.1b",
                                             "--shape", "decode_32k"],
}
MESH_VARS = ("REPRO_MESH_SHAPE", "REPRO_MESH_SHAPE_MULTI",
             "REPRO_DRYRUN_DEVICES")


def _load(rel: str):
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


def _env():
    env = {k: v for k, v in os.environ.items() if k not in MESH_VARS}
    return dict(env, PYTHONPATH=SRC)


@pytest.mark.parametrize("rel", sorted(FILES))
def test_file_imports_no_jax_or_reference(rel):
    """Importing the file (its ``__main__`` block does not run) leaves no
    ``jax`` and no ``repro`` module in ``sys.modules``."""
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('m', {rel!r})\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "assert callable(mod.main)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "[]", out.stdout


@pytest.mark.parametrize("rel", sorted(FILES))
def test_file_raises_without_cuda_by_default(rel):
    """Run as a user runs it, without ``--device cpu``, on a host with no
    CUDA: the port's error, before any work on the CPU."""
    out = subprocess.run([sys.executable, rel, *FILES[rel]], cwd=ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert "repro_torch runs on a CUDA device by default" in out.stderr, \
        out.stderr[-3000:]
    assert out.stdout == ""


def _tables_row(text: str, arch: str, shape: str, heading: str) -> list:
    section = text.split(heading)[1].split("###")[0]
    rows = [line for line in section.splitlines()
            if line.startswith(f"| {arch} | {shape} |")]
    assert len(rows) == 1, section
    return [c.strip() for c in rows[0].strip("|").split("|")]


def test_make_experiments_tables_reads_the_dryrun_reports(tmp_path,
                                                          monkeypatch):
    """Two dry-run cells of the port (tinyllama-1.1b decode_32k on the
    single- and multi-pod meshes) under ``tmp_path``; every table row
    carries its cell's report and ``roofline_row``, and nothing is written
    under the repository's ``reports/``."""
    for var in MESH_VARS:
        monkeypatch.delenv(var, raising=False)
    reports = os.path.join(ROOT, "reports")
    before = sorted(os.walk(reports)) if os.path.isdir(reports) else None
    monkeypatch.chdir(tmp_path)
    for mesh in ("single", "multi"):
        _captured(D.main, ["--arch", "tinyllama-1.1b", "--shape",
                           "decode_32k", "--mesh", mesh, "--mode", "full"])
    assert sorted(os.listdir(tmp_path / "reports" / "dryrun_torch")) == [
        "tinyllama-1.1b_decode_32k_multi.json",
        "tinyllama-1.1b_decode_32k_single.json"]
    port = _load("scripts/make_experiments_tables_torch.py")
    # the default --in, relative to the working directory
    out, text = _captured(port.main, ["--device", "cpu"])
    cells = load_cells([str(tmp_path / "reports" / "dryrun_torch")])
    single = cells[("tinyllama-1.1b", "decode_32k", "single")]
    multi = cells[("tinyllama-1.1b", "decode_32k", "multi")]
    assert "single-pod 16x16 | multi-pod 2x16x16" in text
    assert "single-pod (256 ranks of the fake world), per-rank terms on " \
           "the H100 roofline" in text
    assert "note" not in text

    dry = _tables_row(text, "tinyllama-1.1b", "decode_32k", "§Dry-run")
    mem = [(c["full"]["memory"]["argument_bytes"]
            + c["full"]["memory"]["temp_bytes"]) / 2**30
           for c in (single, multi)]
    coll = single["full"]["collectives"]
    assert dry[2:5] == ["ok", "ok", f"{mem[0]:.1f} / {mem[1]:.1f}"]
    assert dry[5].startswith(f"{coll['total_wire_bytes'] / 1e9:.1f} (")

    row = roofline_row(single)
    assert out["rows"] == {("tinyllama-1.1b", "decode_32k"): row}
    roof = _tables_row(text, "tinyllama-1.1b", "decode_32k", "§Roofline")
    assert roof[2:] == [
        f"{row['t_compute_s']:.3g}", f"{row['t_memory_s']:.3g}",
        f"{row['t_collective_s']:.3g}", row["dominant"],
        f"{row['useful_flop_ratio']:.2f}",
        f"{row['roofline_fraction']:.3f}"]
    after = sorted(os.walk(reports)) if os.path.isdir(reports) else None
    assert after == before


def test_inspect_collectives_lists_the_trace_records(monkeypatch):
    """tinyllama-1.1b train_4k at depth 2 on the (16, 16) mesh: the total
    printed is the dry run's ``total_result_bytes``, the rows are the
    trace's records, largest first, and the count is theirs."""
    for var in MESH_VARS:
        monkeypatch.delenv(var, raising=False)
    port = _load("scripts/inspect_collectives_torch.py")
    out, text = _captured(port.main, [
        "--arch", "tinyllama-1.1b", "--shape", "train_4k", "--depth", "2",
        "--top", "10", "--device", "cpu"])
    records = out["trace"].collectives.records
    total = D.analyze(out["trace"])["collectives"]["total_result_bytes"]
    assert out["total"] == total > 0
    lines = text.splitlines()
    assert lines[0] == (f"# {len(records)} collectives, total result "
                        f"bytes/rank {total / 2**30:.3f} GiB (depth=2)")
    assert len(lines) == 1 + min(10, len(records))
    sizes = [r[1] for r in out["rows"]]
    assert sorted(out["rows"]) == sorted(records)
    assert sizes == sorted(sizes, reverse=True)
    for line, (kind, nbytes, group, site) in zip(lines[1:], out["rows"]):
        assert line == (f"{nbytes / 2**20:10.1f} MiB  {kind:18s} "
                        f"site={site} group={group}")
