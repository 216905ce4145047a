"""Builds the port's CUDA sources (``igm_tpu_torch/csrc/*.cu``) with nvcc and
loads them through ctypes.

Each source becomes its own shared library with a plain C interface, built
at first use into ``igm_tpu_torch/_build/`` (ignored by git) under a name
keyed by a hash of the source and the flags, so an edited source is rebuilt
and an unchanged one is loaded as it is.  All sources are compiled at once,
one nvcc process each.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent
SOURCES = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.is_file():
        return str(path)
    raise RuntimeError("nvcc not found: put the CUDA toolkit's bin/ on PATH "
                       "or set CUDA_HOME")


def _target(src: Path) -> Path:
    key = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{key.hexdigest()[:16]}.so"


@functools.cache
def libraries() -> dict[str, ctypes.CDLL]:
    """Build (where not yet built) and load every kernel library, keyed by
    source stem.  Raises with nvcc's output if a build fails."""
    BUILD_DIR.mkdir(exist_ok=True)
    sources = sorted(SOURCES.glob("*.cu"))
    jobs = []
    for src in sources:
        target = _target(src)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        jobs.append((src, tmp, target, proc))
    failed = []
    for src, tmp, target, proc in jobs:
        output, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name}: nvcc exit {proc.returncode}\n{output}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {src.stem: ctypes.CDLL(str(_target(src))) for src in sources}


def library(name: str) -> ctypes.CDLL:
    return libraries()[name]
