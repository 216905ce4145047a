"""Where a CTA's time goes in a hand-written kernel, from phase stamps.

    python -m igm_tpu_torch.tools.kernel_stamps [--kernel group_norm_mish_bwd]
        [--dtype bfloat16]
    python -m igm_tpu_torch.tools.kernel_stamps --kernel nearest_codebook

Builds the kernel's source with ``-DIGM_STAMPS`` (``csrc/mma_sm90.cuh``
``IGM_STAMP``: thread 0 of each CTA writes ``%globaltimer`` at the kernel's
marked points) into a library of its own, points the wrapper at it, and runs
it on ``chip_smoke.py``'s shapes and inputs (its seeds, the argument sets
rotated as ``chip_smoke.time_ms`` rotates them, so that each call finds its
inputs in device memory).  The last call's CTAs (the stamp rows it changed)
give, per phase, the median time over the CTAs in us, the median life of a
CTA, the call's span from the first CTA's start to the last one's end, and
the quartiles of the CTAs' start times after the first (how the grid comes
in waves).  Prints the card's name and power limit, then one JSON line per
shape.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]

# kernel: (source, the phases between consecutive stamps)
KERNELS = {
    "group_norm_mish_bwd": ("group_norm_mish", [
        "x arrives", "statistics (group exchange)", "g arrives",
        "sweep 1 (group exchange)", "sweep 2 (dx)", "channel sums",
        "cluster channel exchange"]),
    "nearest_codebook": ("nearest_codebook", [
        "z and the first tile arrive", "the code tiles", "merge in the CTA",
        "merge over the cluster"]),
}
SLOTS, MAX_CTAS = 8, 4096       # csrc/mma_sm90.cuh kStampSlots, kStampCtas


def build(source: str) -> ctypes.CDLL:
    from igm_tpu_torch.ops import _build
    _build.BUILD_DIR.mkdir(exist_ok=True)
    out = _build.BUILD_DIR / f"{source}-stamps.so"
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-DIGM_STAMPS", "-o", str(out),
                           str(_build.SOURCES / f"{source}.cu")],
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc -DIGM_STAMPS {source}.cu:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(out))


def read(lib: ctypes.CDLL):
    import numpy as np
    buf = np.zeros((MAX_CTAS, SLOTS), np.uint64)
    err = lib.igm_stamps_read(ctypes.c_void_p(buf.ctypes.data), ctypes.c_int(MAX_CTAS))
    if err != 0:
        raise RuntimeError(f"igm_stamps_read: CUDA error {err}")
    return buf


def summary(before, after, phases: list[str]) -> dict:
    import numpy as np
    rows = after[(after != before).any(axis=1)].astype(np.int64)
    k = len(phases) + 1
    stamps = rows[:, :k]
    start = stamps[:, 0]
    d = np.diff(stamps, axis=1) / 1e3
    return {
        "ctas": int(len(rows)),
        "phase_us_median": {p: float(np.median(d[:, i])) for i, p in enumerate(phases)},
        "life_us_median": float(np.median((stamps[:, -1] - start) / 1e3)),
        "span_us": float((stamps[:, -1].max() - start.min()) / 1e3),
        "start_us_quartiles": [float(q) for q in
                               np.percentile((start - start.min()) / 1e3, [25, 50, 75, 100])],
    }


def cases(kernel: str, dtype):
    """(label, wrapper call, argument sets) at chip_smoke.py's shapes."""
    sys.path.insert(0, str(REPO))
    import chip_smoke as c
    if kernel == "group_norm_mish_bwd":
        from igm_tpu_torch.ops.groupnorm import group_norm_mish_bwd
        elt = torch.finfo(dtype).bits // 8
        for (h, w, ch), _ in c.GN_SHAPES:
            g = torch.Generator(device="cuda").manual_seed(h * 1000 + ch + 7)

            def make(i, h=h, w=w, ch=ch, g=g):
                x = (torch.randn(c.BATCH, h, w, ch, generator=g, device="cuda") * 2
                     + 0.5).to(dtype)
                gamma = torch.randn(ch, generator=g, device="cuda") * 0.1 + 1.0
                beta = torch.randn(ch, generator=g, device="cuda") * 0.1
                grad = torch.randn(c.BATCH, h, w, ch, generator=g, device="cuda").to(dtype)
                return x, gamma, beta, grad

            sets = c.rotation(make, 3 * c.BATCH * h * w * ch * elt)
            yield [c.BATCH, h, w, ch], (lambda *a: group_norm_mish_bwd(*a, 8)), sets
    else:
        from igm_tpu_torch.ops.vq import nearest_codebook
        for m, k, d in c.VQ_SHAPES:
            g = torch.Generator(device="cuda").manual_seed(m + k)

            def make(i, m=m, k=k, d=d, g=g):
                return (torch.randn(m, d, generator=g, device="cuda"),
                        torch.randn(k, d, generator=g, device="cuda"))

            yield [m, k, d], nearest_codebook, c.rotation(make, (m * d + k * d) * 4 + m * 4)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="group_norm_mish_bwd")
    ap.add_argument("--dtype", default="bfloat16", help="group_norm_mish_bwd's dtype")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_stamps: needs a CUDA card")
    from igm_tpu_torch.ops import _build, groupnorm, vq
    from igm_tpu_torch.tools.profiling import nvidia_smi
    print(nvidia_smi(), flush=True)
    source, phases = KERNELS[args.kernel]
    lib = build(source)
    lib.igm_stamps_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.igm_stamps_read.restype = ctypes.c_int
    plain_library = _build.library
    _build.library = lambda name: lib if name == source else plain_library(name)
    groupnorm._kernels.cache_clear()
    vq._kernel.cache_clear()
    try:
        for shape, fn, sets in cases(args.kernel, getattr(torch, args.dtype)):
            for a in sets:
                fn(*a)
            torch.cuda.synchronize()
            before = read(lib)
            fn(*sets[0])                       # the rotation has moved it out of L2
            torch.cuda.synchronize()
            dtype = args.dtype if args.kernel == "group_norm_mish_bwd" else "float32"
            print(json.dumps({"kernel": args.kernel, "dtype": dtype, "shape": shape,
                              **summary(before, read(lib), phases)}), flush=True)
    finally:
        _build.library = plain_library
        groupnorm._kernels.cache_clear()
        vq._kernel.cache_clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
