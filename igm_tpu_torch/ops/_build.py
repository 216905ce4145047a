"""Builds the port's CUDA sources (``igm_tpu_torch/csrc/*.cu``) with nvcc and
loads them through ctypes.

Each source becomes its own shared library with a plain C interface, built
at first use into ``igm_tpu_torch/_build/`` (ignored by git) under a name
keyed by a hash of the source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source is rebuilt and an unchanged one is loaded as it
is.  All sources are compiled at once, one nvcc process each.  nvcc runs
with ``-Xptxas -v``: ptxas's report of each kernel's registers, shared
memory and spills is kept beside the library (``<library>.log``) and read
by :func:`resource_usage`.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent
SOURCES = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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
    headers = b"".join(h.read_bytes() for h in sorted(SOURCES.glob("*.cuh")))
    key = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode())
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
            target.with_suffix(".log").write_text(output)
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {src.stem: ctypes.CDLL(str(_target(src))) for src in sources}


def library(name: str) -> ctypes.CDLL:
    return libraries()[name]


def _kernel_name(symbol: str) -> str:
    """A kernel's name from its mangled symbol (namespaces dropped), with
    its template arguments: ``group_norm_mish_kernel<bf16, 8>``,
    ``fused_block_mma_kernel<true>``."""
    parts, i = [], 3 if symbol.startswith("_ZN") else 2
    while m := re.match(r"\d+", symbol[i:]):
        n, i = int(m.group()), i + m.end()
        parts.append(symbol[i:i + n])
        i += n
    if not parts:
        return symbol
    m = re.match(r"I((?:f|13__nv_bfloat16|Li\d+E|Lb[01]E)+)E", symbol[i:])
    if not m:
        return parts[-1]
    args = [{"f": "float", "13__nv_bfloat16": "bf16", "Lb0E": "false", "Lb1E": "true"}.get(
        a, a[2:-1]) for a in re.findall(r"f|13__nv_bfloat16|Li\d+E|Lb[01]E", m.group(1))]
    return f"{parts[-1]}<{', '.join(args)}>"


def resource_usage(name: str) -> dict[str, dict[str, int]]:
    """Each kernel of library ``name`` as ptxas reported it when it was
    built here: {kernel: {"registers", "stack_frame", "spill_stores",
    "spill_loads"}} (the last three in bytes); empty where the report is
    missing."""
    log = _target(SOURCES / f"{name}.cu").with_suffix(".log")
    if not log.exists():
        return {}
    out, current = {}, None
    for line in log.read_text().splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            current = out.setdefault(_kernel_name(m.group(1)), {})
        elif current is None:
            continue
        elif m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                            r"(\d+) bytes spill loads", line):
            current.update(stack_frame=int(m.group(1)), spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
        elif m := re.search(r"Used (\d+) registers", line):
            current["registers"] = int(m.group(1))
    return out
