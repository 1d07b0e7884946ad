"""Build the port's CUDA kernels at first use, with ``nvcc`` straight into a
shared library with a plain C interface (loaded through ``ctypes``).

Sources are the ``csrc/*.cu`` files of this package and the headers they
share (``csrc/*.cuh``), nothing else.  The build lands in ``kernels/_build/``
(listed in ``.gitignore``), keyed by a hash of the source, the headers and
the flags, so one checkout builds each kernel once and a changed source never
loads a stale library.  Several kernels build in
parallel: :func:`build_all` starts one ``nvcc`` per source at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = {"sweep": "sweep.cu", "packed_sweep": "packed_sweep.cu", "guard": "guard.cu"}
NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    # Optimize the template instantiations in parallel: packed_sweep.cu's
    # build drops from about 54 s to 26 s on the card's 8-core host.
    "--split-compile=0",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
]


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or refused a source."""


@dataclass
class Built:
    name: str
    path: Path
    seconds: float  # 0.0 when the library was already built
    log: str  # nvcc's output (``-Xptxas -v``: registers, shared memory, spills), kept beside it


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _target(name: str) -> Path:
    text = (CSRC / SOURCES[name]).read_bytes()
    text += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_all(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, Built]:
    """Build every named kernel that is not built yet, one ``nvcc`` each,
    all started together; raise :class:`KernelBuildError` on any failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    done: Dict[str, Built] = {}
    running = {}
    t0 = time.perf_counter()
    for name in names:
        target = _target(name)
        if target.exists():
            log = target.with_suffix(".log")
            done[name] = Built(name, target, 0.0, log.read_text() if log.exists() else "")
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        running[name] = (target, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failures = []
    for name, (target, tmp, proc) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        target.with_suffix(".log").write_text(log)
        os.replace(tmp, target)
        done[name] = Built(name, target, time.perf_counter() - t0, log)
    if failures:
        raise KernelBuildError("\n".join(failures))
    return done


_loaded: Dict[str, ctypes.CDLL] = {}


def load(name: str) -> ctypes.CDLL:
    """The named kernel's library, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = _loaded[name] = ctypes.CDLL(str(build_all([name])[name].path))
    return lib
