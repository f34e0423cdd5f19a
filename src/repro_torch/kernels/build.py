"""Build the CUDA kernels in ``csrc/`` with ``nvcc`` on first use.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface, loaded with :mod:`ctypes`; no PyTorch headers are compiled, so
a build takes seconds. Libraries go to ``_build/`` next to this file (a
directory ``.gitignore`` lists), named by a hash of the sources and the
command line, so an edited source never loads a stale library.

``build_all()`` starts one ``nvcc`` per source at once and waits for all;
``load(name)`` builds one library if it is missing and returns it. Both
raise ``RuntimeError`` when ``nvcc`` is missing or a build fails.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("edpp_screen", "solver_step", "cd_gram", "group_screen")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default install location."""
    home = os.environ.get("CUDA_HOME")
    if home:
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def nvcc_command(name: str, out: Path) -> list[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out),
            str(CSRC / f"{name}.cu")]


def _start(name: str):
    """Start the build of one library; None if it is already built."""
    if name not in SOURCES:
        raise ValueError(f"unknown kernel source {name!r}; have {SOURCES}")
    out = library_path(name)
    if out.exists():
        return None
    if not Path(nvcc_path()).exists():
        raise RuntimeError(
            f"cannot build the CUDA kernel {name!r}: nvcc not found at "
            f"{nvcc_path()} (set CUDA_HOME). CPU tensors take the plain "
            f"PyTorch versions and need no build.")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(nvcc_command(name, tmp), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return name, out, tmp, proc


def _finish(job) -> str:
    name, out, tmp, proc = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)       # atomic: a concurrent builder sees old or new
    return log


def build_all() -> dict[str, str]:
    """Build every missing library, one ``nvcc`` per source, all at once.
    Returns ``{name: compiler output}`` for the libraries built."""
    jobs = [job for job in (_start(n) for n in SOURCES) if job is not None]
    logs = {}
    try:
        for job in jobs:
            logs[job[0]] = _finish(job)
    finally:
        for job in jobs:       # stop any nvcc left running after a failure
            if job[3].poll() is None:
                job[3].kill()
                job[3].wait()
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        job = _start(name)
        if job is not None:
            _finish(job)
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib
