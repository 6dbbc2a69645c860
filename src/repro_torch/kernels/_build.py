"""Build the CUDA sources under ``repro_torch/csrc`` and bind them.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with :mod:`ctypes`.  The
build runs at first use, into ``build/kernels/<name>-<hash>/`` at the
root of the checkout (the hash covers the source, every ``*.cuh`` header
and the flags, so an edited source rebuilds).  :func:`build` compiles
several sources at once, one ``nvcc`` process each.  A failed build
raises with the compiler's output; nothing falls back.

Nothing here runs at import time: the module imports on hosts without
CUDA, where only the kernels' plain PyTorch versions run.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
from typing import Dict, Sequence

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"

#: Every kernel source of the package, by stem.
SOURCES = ("zns_event_scan", "zns_fixpoint", "rmsnorm", "flash_attention",
           "linear_recurrence", "ssd_chunk_scan")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin or "
                           "/usr/local/cuda/bin); the CUDA kernels need the "
                           "CUDA toolkit")
    return path


def _digest(name: str) -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> pathlib.Path:
    """Where the built library of source ``name`` lives."""
    return BUILD_DIR / f"{name}-{_digest(name)}" / f"lib{name}.so"


def build(names: Sequence[str] = SOURCES) -> Dict[str, pathlib.Path]:
    """Compile every named source that is not built yet, all in parallel;
    returns ``{name: library path}``.  Raises ``RuntimeError`` with the
    compiler's output when any build fails.  Each build's ``nvcc`` output
    (``-Xptxas -v``: registers, shared memory, spills) is kept beside the
    library as ``build.log``."""
    paths = {n: library_path(n) for n in names}
    procs = {}
    for name, lib in paths.items():
        if lib.exists():
            continue
        lib.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=lib.parent, suffix=".so.tmp")
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        lib = paths[name]
        (lib.parent / "build.log").write_text(out)
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode})\n"
                          f"{out}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _LIBS[name] = lib
    return lib


def stream_handle(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as a pointer value
    (read without building a ``torch.cuda.Stream``, which costs about 10
    microseconds a launch)."""
    import torch
    index = device.index
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if index is None else index)
