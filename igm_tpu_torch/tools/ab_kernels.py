"""Times the kernels of two checkouts of this repository on one card, in
turns: the base, this tree, this tree, the base (a b b a).

    python -m igm_tpu_torch.tools.ab_kernels --base logs/parent \
        --phase parity_gn_bwd:bfloat16 --phase parity_vq [--batch 64] [--vq-indices]

``--base`` is another checkout (e.g. the parent commit unpacked with ``git
archive`` into a gitignored directory).  Each run is a subprocess started in
its checkout's root that calls a parity phase of that checkout's
``chip_smoke.py``: ``--phase name:dtype`` calls ``phase(dtype)`` at the
phase's own batch, or ``phase(dtype, batch=B)`` with ``--batch B``, which
this tree's ``parity_gn``, ``parity_gn_bwd``, ``parity_la`` and
``parity_la_bwd`` take (with the seeds ``chip_smoke.py`` gives them there;
a checkout whose phase takes no batch fails); ``--phase name`` (no dtype,
e.g. ``parity_vq``) calls ``phase()``; ``--phase gn_bwd_split:bfloat16``
runs this tool's own profile of the GroupNorm+Mish backward wrapper in
either tree (the same code for both, so it reaches a checkout without it):
the device time of one call by kernel, at the flagship's shapes (batch
256) and the latent UNet's (batch 128), with ``split_us`` in its rows.  So a run imports that checkout's
``igm_tpu_torch`` and builds its kernels into that checkout's ``_build/``.
Prints the card's name and power limit, then one JSON line per run and
phase: the phase's rows (shape, dtype, route, kernel_ms, plain_ms,
block_ms, library_ms, bound_ms, max_abs_err, where the row has them) and its
total kernel time (``kernel_ms`` times ``calls_per_forward``, summed over
the timed rows: the calls of one UNet pass; rows without
``calls_per_forward``, as parity_vq's and parity_fused_block's, count
once).

``--vq-indices`` then builds the base's ``csrc/nearest_codebook.cu`` (the
same C interface) beside this tree's and runs both in one process on the
same inputs at each of ``chip_smoke.VQ_SHAPES``: parity_vq's inputs, and a
codebook of two copies of its first half (exact ties).  One JSON line per
input: the rows where the two builds' indices differ, and where each differs
from the plain version.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

CHILD = """
import json, sys, torch
import chip_smoke as c
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def gn_bwd_split(dtype):
    # the backward wrapper's device time by kernel (torch.profiler, 20 calls
    # on parity_gn_bwd's first argument set), at the flagship's shapes at
    # batch 256 and the latent UNet's at batch 128
    from torch.profiler import ProfilerActivity, profile
    from igm_tpu_torch.ops.groupnorm import group_norm_mish_bwd
    rows = []
    for batch, shapes, seed_add in ((c.BATCH, c.GN_SHAPES, 0),
                                    (c.LATENT_BATCH, c.LATENT_GN_SHAPES, c.LATENT_BATCH)):
        for (h, w, ch), calls in shapes:
            g = torch.Generator(device="cuda").manual_seed(h * 1000 + ch + 7 + seed_add)
            x = (torch.randn(batch, h, w, ch, generator=g, device="cuda") * 2 + 0.5).to(dtype)
            gamma = torch.randn(ch, generator=g, device="cuda") * 0.1 + 1.0
            beta = torch.randn(ch, generator=g, device="cuda") * 0.1
            grad = torch.randn(batch, h, w, ch, generator=g, device="cuda").to(dtype)
            group_norm_mish_bwd(x, gamma, beta, grad, 8)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    group_norm_mish_bwd(x, gamma, beta, grad, 8)
                torch.cuda.synchronize()
            split = {}
            for e in prof.events():
                if (e.device_type == torch.autograd.DeviceType.CUDA
                        and not getattr(e, "is_user_annotation", False)):
                    name = e.name.replace("(anonymous namespace)::", "").split("(")[0]
                    name = name.removeprefix("void ").split("::")[-1]
                    split[name] = split.get(name, 0.0) + e.time_range.elapsed_us() / 20
            rows.append(dict(shape=[batch, h, w, ch], calls_per_forward=calls,
                             kernel_ms=sum(split.values()) / 1e3, split_us=split))
    return rows


kwargs = {"batch": int(sys.argv[1])} if sys.argv[1] else {}
for spec in sys.argv[2:]:
    name, _, dtype = spec.partition(":")
    if name == "gn_bwd_split":
        rows = gn_bwd_split(getattr(torch, dtype))
    else:
        phase = getattr(c, name)
        rows = phase(getattr(torch, dtype), **kwargs) if dtype else phase()
    print("AB " + json.dumps({"phase": spec, "rows": rows}), flush=True)
"""


def run(tree: Path, batch: int | None, phases: list[str]) -> list[dict]:
    proc = subprocess.run([sys.executable, "-c", CHILD, str(batch or ""), *phases], cwd=tree,
                          capture_output=True, text=True, timeout=1800)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree}: exit {proc.returncode}\n{proc.stdout[-4000:]}"
                           f"\n{proc.stderr[-4000:]}")
    return [json.loads(line[3:]) for line in proc.stdout.splitlines()
            if line.startswith("AB ")]


def same_vq_indices(base: Path) -> list[dict]:
    """The base's nearest_codebook build against this tree's, in this process,
    on the same inputs (see the module's note)."""
    import ctypes

    import torch

    sys.path.insert(0, str(REPO))
    import chip_smoke
    from igm_tpu_torch.ops import _build
    from igm_tpu_torch.ops.vq import _e_sq, nearest_codebook, nearest_codebook_plain

    src = base / "igm_tpu_torch" / "csrc" / "nearest_codebook.cu"
    lib = base / "igm_tpu_torch" / "_build" / "nearest_codebook-base.so"
    lib.parent.mkdir(exist_ok=True)
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)], check=True,
                   capture_output=True, text=True, timeout=900)
    fn = ctypes.CDLL(str(lib)).igm_nearest_codebook_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = []
    for m, k, d in chip_smoke.VQ_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(m + k)      # parity_vq's inputs
        z = torch.randn(m, d, generator=g, device="cuda")
        e = torch.randn(k, d, generator=g, device="cuda")
        for label, book in (("parity_vq", e), ("two copies", torch.cat([e[:k // 2]] * 2))):
            got = nearest_codebook(z, book)
            base_idx = torch.empty_like(got)
            err = fn(z.data_ptr(), book.data_ptr(), _e_sq(book).data_ptr(), base_idx.data_ptr(),
                     m, book.shape[0], d, torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"base nearest_codebook: CUDA error {err}")
            plain = nearest_codebook_plain(z, book)
            torch.cuda.synchronize()
            out.append(dict(vq_indices=label, shape=[m, book.shape[0], d],
                            rows_differ_between_builds=int((got != base_idx).sum()),
                            rows_differ_from_plain=int((got != plain).sum()),
                            base_rows_differ_from_plain=int((base_idx != plain).sum())))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", required=True, type=Path, help="the other checkout's root")
    ap.add_argument("--phase", action="append", required=True,
                    help="a parity phase of chip_smoke.py and its dtype, e.g. "
                         "parity_gn:bfloat16, or a phase that takes none, e.g. parity_vq")
    ap.add_argument("--batch", type=int, default=None,
                    help="the phases' batch (default: their own, 256)")
    ap.add_argument("--vq-indices", action="store_true",
                    help="then compare the two trees' nearest_codebook indices in one process")
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    base = args.base.resolve()
    for i, (label, tree) in enumerate((("base", base), ("this", REPO), ("this", REPO),
                                       ("base", base))):
        for result in run(tree, args.batch, args.phase):
            rows = result["rows"]
            print(json.dumps({
                "run": i, "tree": label, "phase": result["phase"],
                "batch": rows[0]["shape"][0],
                "kernel_ms": sum(r["kernel_ms"] * r.get("calls_per_forward", 1) for r in rows
                                 if r.get("kernel_ms") is not None),
                "rows": [{k: r.get(k) for k in ("shape", "dtype", "route", "kernel_ms",
                                                "plain_ms", "block_ms", "library_ms", "bound_ms",
                                                "max_abs_err", "split_us") if k in r}
                         for r in rows]}), flush=True)
    if args.vq_indices:
        for line in same_vq_indices(base):
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
