#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (igm_tpu_torch) on one CUDA card and checks it.

    python3 chip_smoke.py

Phases, one JSON line each; a phase that fails raises and the script exits
non-zero:

  device  the card's name and power limit (nvidia-smi), torch and CUDA versions
  build   builds every kernel from igm_tpu_torch/csrc (one nvcc per source)
  parity  each kernel against its plain PyTorch version on the card, at the
          flagship shapes with batch 256, in bf16 and f32, with its time, the
          plain version's, the least time the card could take (bound) and,
          for GroupNorm+Mish, F.mish(F.group_norm(...)) as a yardstick
  unet    one full-width Unet forward (hidden 64, dim_mults [1,2,4], batch 8,
          f32, TF32 off) on the card against the same weights on the CPU,
          where the kernel wrappers take their plain versions; and the launch
          counts of one forward (25 GroupNorm+Mish, 6 linear attention)
  slice   experiment=ddpm/cifar10 composed through the port's config, bf16 on
          the card: DDIM-50 and the ancestral 1000-step chain at batch 64
          (sample_batch), then the sampling CLI to a PNG.  The kernels'
          launch counters are zeroed just before and read just after, and
          must show 25 and 6 launches per UNet forward.  Then a short f32
          ancestral chain on the card against the CPU.

Then a line with the card's name and power limit, one JSON line
{"kernels": [...]}, and last {"ok": true, "device": {...}}.  Without a CUDA
card the script exits non-zero and prints no result.
"""
from __future__ import annotations

import copy
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

HBM_BYTES_PER_S = 3.35e12            # H100 SXM device memory
PEAK_OPS = {"bfloat16": 989e12,      # dense bf16 tensor-core rate
            "float32": 67e12}        # float32 outside the tensor cores
BATCH = 256
# (H, W, C) of each GroupNorm+Mish call, and its calls per UNet forward
GN_SHAPES = [((32, 32, 64), 5), ((16, 16, 128), 4), ((8, 8, 256), 8),
             ((8, 8, 128), 4), ((16, 16, 64), 4)]
# N of each linear-attention call (C = 4 heads x 32), and its calls per forward
LA_SHAPES = [(1024, 1), (256, 2), (64, 3)]
LA_HEADS = 4
# operations per element of the fused GroupNorm+Mish: statistics 3, normalise
# and affine 4, Mish 8 (max, abs, exp, log1p, add, tanh, mul, and the negate)
GN_OPS_PER_ELEMENT = 15
SLEEP_CYCLES = 50_000_000            # ~25 ms: the host queues timed launches meanwhile
L2_BYTES = 50 * 2 ** 20


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def tolerance(dtype) -> tuple[float, float]:
    """(atol, rtol) of a kernel against its plain version on the same inputs.

    float32: the same f32 arithmetic summed in another order (the kernels'
    reductions run over up to 8192 elements per group or 1024 positions).
    bfloat16: both compute in f32 from the same bf16 inputs and round once,
    so f32-level differences can flip a rounding: one bf16 ulp, 2^-7 of the
    value.  Linear attention also rounds its context to bf16 before the
    read-out, where a flipped context entry moves the output by up to
    sum_d |q_d| ulp(ctx_de): the absolute term covers that."""
    import torch
    if dtype == torch.float32:
        return 1e-5, 1e-5
    return 1e-2, 2.0 ** -7


def time_ms(fn, arg_sets, iters: int = 30) -> float:
    """Device time of one call, from CUDA events around ``iters`` calls.

    The argument sets rotate so that their total size exceeds the 50 MB L2
    and each call finds its inputs in device memory, as the UNet's fresh
    conv outputs mostly are.  A spin kernel keeps the card busy while the
    host queues the timed calls, so host overhead does not enter the time."""
    import torch
    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def rotation(make, bytes_per_call: int) -> list:
    return [make(i) for i in range(max(2, math.ceil(2 * L2_BYTES / bytes_per_call)))]


def phase_device() -> str:
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[0]
    print(smi, flush=True)
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])
    return smi


def phase_build() -> None:
    from igm_tpu_torch.ops import _build
    t0 = time.perf_counter()
    libs = _build.libraries()
    emit("build", seconds=time.perf_counter() - t0, libraries=sorted(libs),
         flags=list(_build.NVCC_FLAGS))


def parity_gn(dtype) -> list[dict]:
    import torch
    import torch.nn.functional as F
    from igm_tpu_torch.ops.groupnorm import group_norm_mish, group_norm_mish_plain
    atol, rtol = tolerance(dtype)
    elt = torch.finfo(dtype).bits // 8
    rows = []
    for (h, w, c), calls in GN_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(h * 1000 + c)

        def make(i, h=h, w=w, c=c, g=g):
            x = (torch.randn(BATCH, h, w, c, generator=g, device="cuda") * 2
                 + 0.5).to(dtype)
            gamma = torch.randn(c, generator=g, device="cuda") * 0.1 + 1.0
            beta = torch.randn(c, generator=g, device="cuda") * 0.1
            return x, gamma, beta

        elements = BATCH * h * w * c
        nbytes = 2 * elements * elt + 2 * c * 4
        sets = rotation(make, nbytes)
        x, gamma, beta = sets[0]
        got = group_norm_mish(x, gamma, beta, 8)
        want = group_norm_mish_plain(x, gamma, beta, 8)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        ok = bool((err <= atol + rtol * want.float().abs()).all())
        check(ok, f"group_norm_mish {dtype} {h}x{w}x{c}: max err "
                  f"{err.max().item()} beyond atol {atol} rtol {rtol}")
        lib_sets = [(s[0].permute(0, 3, 1, 2), s[1].to(dtype), s[2].to(dtype))
                    for s in sets]
        bytes_s = nbytes / HBM_BYTES_PER_S
        ops_s = GN_OPS_PER_ELEMENT * elements / PEAK_OPS["float32"]
        rows.append(dict(
            kernel="group_norm_mish", dtype=str(dtype).split(".")[-1],
            shape=[BATCH, h, w, c], calls_per_forward=calls,
            max_abs_err=err.max().item(), atol=atol, rtol=rtol,
            kernel_ms=time_ms(lambda *a: group_norm_mish(*a, 8), sets),
            plain_ms=time_ms(lambda *a: group_norm_mish_plain(*a, 8), sets),
            library_ms=time_ms(
                lambda x, gm, bt: F.mish(F.group_norm(x, 8, gm, bt, 1e-5)),
                lib_sets),
            bound_ms=1e3 * max(bytes_s, ops_s),
            bound_by="bytes" if bytes_s >= ops_s else "operations"))
        emit("parity", **rows[-1])
    return rows


def parity_la(dtype) -> list[dict]:
    import torch
    from igm_tpu_torch.ops.linear_attention import (linear_attention_flat,
                                                    linear_attention_flat_plain)
    atol, rtol = tolerance(dtype)
    elt = torch.finfo(dtype).bits // 8
    c = LA_HEADS * 32
    rows = []
    for n, calls in LA_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(n)

        def make(i, n=n, g=g):
            return tuple(torch.randn(BATCH, n, c, generator=g, device="cuda")
                         .to(dtype) for _ in range(3))

        elements = BATCH * n * c
        nbytes = 4 * elements * elt
        sets = rotation(make, nbytes)
        q, k, v = sets[0]
        got = linear_attention_flat(q, k, v, LA_HEADS)
        want = linear_attention_flat_plain(q, k, v, LA_HEADS)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        ok = bool((err <= atol + rtol * want.float().abs()).all())
        check(ok, f"linear_attention {dtype} N={n}: max err {err.max().item()} "
                  f"beyond atol {atol} rtol {rtol}")
        # context and read-out: 2 * N * D * D each per (b, h); softmax 3 per k
        ops = 4 * BATCH * LA_HEADS * n * 32 * 32 + 3 * elements
        key = "bfloat16" if dtype == torch.bfloat16 else "float32"
        bytes_s = nbytes / HBM_BYTES_PER_S
        ops_s = ops / PEAK_OPS[key]
        rows.append(dict(
            kernel="linear_attention", dtype=key, shape=[BATCH, n, c],
            calls_per_forward=calls, max_abs_err=err.max().item(),
            atol=atol, rtol=rtol,
            kernel_ms=time_ms(lambda *a: linear_attention_flat(*a, LA_HEADS), sets),
            plain_ms=time_ms(lambda *a: linear_attention_flat_plain(*a, LA_HEADS),
                             sets),
            library_ms=None, bound_ms=1e3 * max(bytes_s, ops_s),
            bound_by="bytes" if bytes_s >= ops_s else "operations"))
        emit("parity", **rows[-1])
    return rows


def reset_counts() -> None:
    from igm_tpu_torch.ops.groupnorm import group_norm_mish
    from igm_tpu_torch.ops.linear_attention import linear_attention_flat
    group_norm_mish.launches = 0
    linear_attention_flat.launches = 0


def counts() -> tuple[int, int]:
    from igm_tpu_torch.ops.groupnorm import group_norm_mish
    from igm_tpu_torch.ops.linear_attention import linear_attention_flat
    return group_norm_mish.launches, linear_attention_flat.launches


def phase_unet() -> dict:
    import torch
    from igm_tpu_torch.networks.unet import Unet
    gen = torch.Generator().manual_seed(0)
    net = Unet(dim=64, dim_mults=(1, 2, 4), channels=3).eval()
    for m in net.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(gen)
    with torch.no_grad():                 # move GroupNorm/LayerNorm off 1 and 0
        for p in net.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    cpu_net = copy.deepcopy(net)
    net = net.to("cuda")
    x = torch.randn(8, 32, 32, 3, generator=gen)
    t = torch.randint(0, 1000, (8,), generator=gen).float()
    with torch.no_grad():
        reset_counts()
        got = net(x.cuda(), t.cuda())
        torch.cuda.synchronize()
        n_gn, n_la = counts()
        want = cpu_net(x, t)
    check((n_gn, n_la) == (25, 6),
          f"one forward launched {n_gn} GroupNorm+Mish and {n_la} linear "
          f"attention kernels, expected 25 and 6")
    err = (got.cpu() - want).abs().max().item()
    # float32 with TF32 off on both sides; cuDNN's and the CPU's conv
    # algorithms round differently, layer after layer, over ~40 layers
    atol = 1e-3
    check(math.isfinite(err) and err <= atol,
          f"unet forward: card vs CPU max err {err} beyond {atol}")
    row = dict(batch=8, dtype="float32", max_abs_err=err, atol=atol,
               output_abs_max=want.abs().max().item(),
               group_norm_mish_launches=n_gn, linear_attention_launches=n_la)
    emit("unet", **row)
    return row


def phase_slice() -> dict:
    import torch
    from PIL import Image
    from igm_tpu_torch.cli import sample_main
    from igm_tpu_torch.config import compose, instantiate

    overrides = ["experiment=ddpm/cifar10", "print_config=False"]
    cfg = compose(REPO / "configs", overrides)
    model = instantiate(cfg.model, datamodule=cfg.datamodule, device="cuda")
    check(model.compute_dtype == torch.bfloat16, "compute dtype is not bf16")
    n = int(model.hparams.sample_batch)
    steps = int(model.hparams.ddim_steps)
    model.ddim_sample(n, steps=2, generator=torch.Generator("cuda").manual_seed(9))
    torch.cuda.synchronize()                          # warm-up, not counted

    out = {"batch": n}
    reset_counts()
    for name, run, forwards in (
            ("ddim", lambda g: model.ddim_sample(n, steps=steps, generator=g), steps),
            ("ancestral", lambda g: model.sample(n, g), model.timesteps)):
        before = counts()
        t0 = time.perf_counter()
        x = run(torch.Generator("cuda").manual_seed(0))
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        gn, la = (a - b for a, b in zip(counts(), before))
        check(tuple(x.shape) == (n, 32, 32, 3), f"{name}: shape {tuple(x.shape)}")
        check(bool(torch.isfinite(x).all()), f"{name}: non-finite samples")
        check((gn, la) == (25 * forwards, 6 * forwards),
              f"{name}: {gn}/{la} launches for {forwards} forwards")
        out[name] = dict(steps=forwards, seconds=sec, images_per_s=n / sec,
                         group_norm_mish_launches=gn, linear_attention_launches=la)
        emit("slice", sampler=name, **out[name])

    before = counts()
    with tempfile.TemporaryDirectory() as tmp:
        png = Path(tmp) / "grid.png"
        t0 = time.perf_counter()
        sample_main([*overrides, "--n", str(n), "--sampler", "ddim", "--steps",
                     str(steps), "--out", str(png)])
        sec = time.perf_counter() - t0
        with Image.open(png) as img:
            size = img.size
    gn, la = (a - b for a, b in zip(counts(), before))
    check(size == (2 + 8 * 34, 2 + 8 * 34), f"cli grid size {size}")
    check((gn, la) == (25 * steps, 6 * steps), f"cli: {gn}/{la} launches")
    out["cli"] = dict(seconds=sec, grid=list(size), group_norm_mish_launches=gn,
                      linear_attention_launches=la)
    emit("slice", sampler="cli", **out["cli"])
    out["launches"] = counts()

    # the same config in f32: a short ancestral chain on the card (kernels)
    # against the CPU (plain versions), same weights, same injected noise
    f32 = [instantiate(cfg.model, datamodule=cfg.datamodule, device=d,
                       compute_dtype="float32") for d in ("cuda", "cpu")]
    gen = torch.Generator().manual_seed(1)
    shape, t_start = (4, 32, 32, 3), 10
    x_T = torch.randn(shape, generator=gen)
    noises = [torch.randn(shape, generator=gen) for _ in range(t_start)]
    got = f32[0].p_sample_loop(shape, t_start=t_start, init_x=x_T.cuda(),
                               noises=[z.cuda() for z in noises]).cpu()
    want = f32[1].p_sample_loop(shape, t_start=t_start, init_x=x_T, noises=noises)
    err = (got - want).abs().max().item()
    atol = 1e-3                                   # as the unet phase
    check(math.isfinite(err) and err <= atol,
          f"f32 chain: card vs CPU max err {err} beyond {atol}")
    out["reference"] = dict(steps=t_start, batch=shape[0], max_abs_err=err,
                            atol=atol)
    emit("slice", sampler="reference", **out["reference"])
    return out


def totals(rows: list[dict], key: str):
    vals = [r[key] for r in rows]
    if any(v is None for v in vals):
        return None
    return sum(v * r["calls_per_forward"] for v, r in zip(vals, rows))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import igm_tpu_torch  # noqa: F401  (fails here, before any output, without the repo)
    smi = phase_device()
    # float32 products and convs in full float32; the bf16 path ignores these
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    gn_rows = parity_gn(torch.bfloat16) + parity_gn(torch.float32)
    la_rows = parity_la(torch.bfloat16) + parity_la(torch.float32)
    phase_unet()
    sl = phase_slice()
    kernels = []
    for name, rows, source, replaces, launches in (
            ("group_norm_mish", gn_rows, "igm_tpu_torch/csrc/group_norm_mish.cu",
             "igm_tpu/ops/pallas_groupnorm.py:103", sl["launches"][0]),
            ("linear_attention", la_rows, "igm_tpu_torch/csrc/linear_attention.cu",
             "igm_tpu/ops/pallas_attention.py:45", sl["launches"][1])):
        main_rows = [r for r in rows if r["dtype"] == "bfloat16"]
        bytes_bound = all(r["bound_by"] == "bytes" for r in main_rows)
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches, max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=totals(main_rows, "kernel_ms"), plain_ms=totals(main_rows, "plain_ms"),
            bound_ms=totals(main_rows, "bound_ms"),
            bound_by="bytes" if bytes_bound else "operations",
            library_ms=totals(main_rows, "library_ms"),
            per="all calls of one UNet forward, batch 256, bf16"))
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
