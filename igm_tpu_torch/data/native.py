"""ctypes binding of the port's C++ host batcher (``csrc/batcher.cpp``):
counterpart of ``igm_tpu/data/native.py``.

``gather_rows`` copies an epoch's selected rows straight into one
contiguous buffer with up to 8 threads; ``shuffle_perm`` is the seeded
splitmix64 Fisher-Yates permutation, equal to ``igm_tpu``'s bit for bit.

The library is built at first use with ``g++ -O3 -std=c++17 -shared -fPIC
-pthread`` (``$CXX`` names another compiler) into ``igm_tpu_torch/_build/``
under a name keyed by a hash of the source and the command, as
``ops/_build.py`` builds the CUDA sources: written under a temporary name
and renamed into place, so processes that build at the same moment each
load a whole library.  Where ``igm_tpu`` falls back to numpy when the build
fails, the port raises with the compiler's output.  Nothing is built at
import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

PACKAGE = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE / "csrc" / "batcher.cpp"
BUILD_DIR = PACKAGE / "_build"
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
MAX_THREADS = 8


def build(source: Path = SOURCE, build_dir: Path = BUILD_DIR) -> Path:
    """The shared library of ``source`` in ``build_dir``, compiled unless
    already there.  Raises ``RuntimeError`` with the compiler's output when
    the compile fails."""
    cxx = os.environ.get("CXX", "g++")
    key = hashlib.sha256(source.read_bytes() + " ".join((cxx, *FLAGS)).encode())
    target = build_dir / f"{source.stem}-{key.hexdigest()[:16]}.so"
    if target.exists():
        return target
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run([cxx, *FLAGS, "-o", str(tmp), str(source)],
                              capture_output=True, text=True, timeout=300)
    except OSError as exc:
        raise RuntimeError(f"host batcher build failed: cannot run {cxx}: {exc}") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"host batcher build failed: {cxx} exit {proc.returncode}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)
    return target


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.igm_gather_rows.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32]
    lib.igm_gather_rows.restype = None
    lib.igm_shuffle_perm.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_uint64]
    lib.igm_shuffle_perm.restype = None
    return lib


def gather_rows(src: np.ndarray, indices: np.ndarray, n_threads: int = 0) -> np.ndarray:
    """``src[indices]`` as a new contiguous array: a memcpy a row, the rows
    split over ``n_threads`` threads (0: the CPU count, at most 8)."""
    idx = np.ascontiguousarray(indices, dtype=np.int64)
    src_c = np.ascontiguousarray(src)
    if len(idx) and (idx.min() < 0 or idx.max() >= len(src_c)):
        raise IndexError(f"row index out of range for {len(src_c)} rows")
    row_bytes = src_c.dtype.itemsize * int(np.prod(src_c.shape[1:], dtype=np.int64))
    dst = np.empty((len(idx),) + src_c.shape[1:], dtype=src_c.dtype)
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 1, MAX_THREADS)
    library().igm_gather_rows(
        src_c.ctypes.data_as(ctypes.c_void_p),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        dst.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(len(idx)), ctypes.c_int64(row_bytes), ctypes.c_int32(n_threads))
    return dst


def shuffle_perm(n: int, seed: int = 0) -> np.ndarray:
    """The seeded Fisher-Yates permutation of [0, n) (int64)."""
    out = np.empty((n,), dtype=np.int64)
    library().igm_shuffle_perm(out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                               ctypes.c_int64(n), ctypes.c_uint64(seed))
    return out
