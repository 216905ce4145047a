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
  parity  (backward) each backward kernel against its plain backward, at the
          same shapes, dtypes and timings; GroupNorm+Mish's yardstick is the
          autograd backward of F.mish(F.group_norm(...))
  train_unet  one f32 training step's loss and gradients (DDPM l1 loss, the
          full-width UNet, batch 8, TF32 off) on the card against the same
          weights, timesteps and noise on the CPU, and the launch counts of
          one forward and backward (25 + 25 GroupNorm+Mish, 6 + 6 linear
          attention)
  train   the training path: python -m igm_tpu_torch.train
          experiment=ddpm/cifar10 at full width in bf16 on synthetic data, in
          a temporary directory (2 epochs of 3 steps, DDIM validation): finite
          loss, a results/*.jpg grid, a checkpoint; then a run resumed from
          it that continues at the saved step; then a timed loop of the train
          step at batch 256 bf16 (train images/s).  Counters are zeroed just
          before this path and read just after.

Then a line with the card's name and power limit, one JSON line
{"kernels": [...]}, and last {"ok": true, "device": {...}}.  Without a CUDA
card the script exits non-zero and prints no result.
"""
from __future__ import annotations

import copy
import json
import math
import os
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
# its backward, once per element: statistics 3; normalise and affine 4;
# Mish' 16 (softplus 6, tanh 1, sigmoid 4, t + y*s*(1 - t*t) 5) and dy 1;
# the dgamma, dbeta and group sums 7; dx 4
GN_BWD_OPS_PER_ELEMENT = 35
# linear-attention backward per position of a head: the context, dctx, dq,
# dv and dk_sm are each a D x D product (2 D^2 operations); the softmax and
# dk ~8 per element
LA_BWD_PRODUCTS = 5
TRAIN_BATCH, TRAIN_STEPS = 256, 20
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


def grad_err(got, want) -> float:
    """Largest error of f32 parameter gradients relative to their largest
    value (they are sums over up to N*H*W products)."""
    return ((got - want).abs().max() / want.abs().max().clamp(min=1e-30)).item()


PARAM_GRAD_RTOL = 1e-4


def parity_gn_bwd(dtype) -> list[dict]:
    import torch
    import torch.nn.functional as F
    from igm_tpu_torch.ops.groupnorm import (group_norm_mish_bwd,
                                             group_norm_mish_bwd_plain)
    atol, rtol = tolerance(dtype)
    elt = torch.finfo(dtype).bits // 8
    rows = []
    for (h, w, c), calls in GN_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(h * 1000 + c + 7)

        def make(i, h=h, w=w, c=c, g=g):
            x = (torch.randn(BATCH, h, w, c, generator=g, device="cuda") * 2
                 + 0.5).to(dtype)
            gamma = torch.randn(c, generator=g, device="cuda") * 0.1 + 1.0
            beta = torch.randn(c, generator=g, device="cuda") * 0.1
            grad = torch.randn(BATCH, h, w, c, generator=g, device="cuda").to(dtype)
            return x, gamma, beta, grad

        elements = BATCH * h * w * c
        # reads x and g, writes dx; gamma, beta in and dgamma, dbeta out
        nbytes = 3 * elements * elt + 4 * c * 4
        sets = rotation(make, nbytes)
        got = group_norm_mish_bwd(*sets[0], 8)
        want = group_norm_mish_bwd_plain(*sets[0], 8)
        torch.cuda.synchronize()
        err = (got[0].float() - want[0].float()).abs()
        ok = bool((err <= atol + rtol * want[0].float().abs()).all())
        check(ok, f"group_norm_mish_bwd {dtype} {h}x{w}x{c}: dx max err "
                  f"{err.max().item()} beyond atol {atol} rtol {rtol}")
        perr = max(grad_err(got[i], want[i]) for i in (1, 2))
        check(perr <= PARAM_GRAD_RTOL, f"group_norm_mish_bwd {dtype} {h}x{w}x{c}: "
                                       f"dgamma/dbeta rel err {perr}")

        # the yardstick: autograd's backward through one forward graph per
        # argument set, kept for the repeated calls
        lib_sets = []
        for x, gm, bt, grad in sets:
            inputs = (x.permute(0, 3, 1, 2).detach().requires_grad_(),
                      gm.to(dtype).requires_grad_(), bt.to(dtype).requires_grad_())
            out = F.mish(F.group_norm(inputs[0], 8, inputs[1], inputs[2], 1e-5))
            lib_sets.append((out, inputs, grad.permute(0, 3, 1, 2)))

        def library(out, inputs, grad):
            return torch.autograd.grad(out, inputs, grad, retain_graph=True)

        bytes_s = nbytes / HBM_BYTES_PER_S
        ops_s = GN_BWD_OPS_PER_ELEMENT * elements / PEAK_OPS["float32"]
        rows.append(dict(
            kernel="group_norm_mish_bwd", dtype=str(dtype).split(".")[-1],
            shape=[BATCH, h, w, c], calls_per_forward=calls,
            max_abs_err=err.max().item(), atol=atol, rtol=rtol,
            dparam_rel_err=perr, dparam_rtol=PARAM_GRAD_RTOL,
            kernel_ms=time_ms(lambda *a: group_norm_mish_bwd(*a, 8), sets),
            plain_ms=time_ms(lambda *a: group_norm_mish_bwd_plain(*a, 8), sets),
            library_ms=time_ms(library, lib_sets),
            bound_ms=1e3 * max(bytes_s, ops_s),
            bound_by="bytes" if bytes_s >= ops_s else "operations"))
        emit("parity", **rows[-1])
        del lib_sets
    return rows


def parity_la_bwd(dtype) -> list[dict]:
    import torch
    from igm_tpu_torch.ops.linear_attention import (linear_attention_flat_bwd,
                                                    linear_attention_flat_bwd_plain)
    atol, rtol = tolerance(dtype)
    elt = torch.finfo(dtype).bits // 8
    c = LA_HEADS * 32
    rows = []
    for n, calls in LA_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(n + 7)

        def make(i, n=n, g=g):
            return tuple(torch.randn(BATCH, n, c, generator=g, device="cuda")
                         .to(dtype) for _ in range(4))

        elements = BATCH * n * c
        nbytes = 7 * elements * elt          # q, k, v, g in; dq, dk, dv out
        sets = rotation(make, nbytes)
        got = linear_attention_flat_bwd(*sets[0], LA_HEADS)
        want = linear_attention_flat_bwd_plain(*sets[0], LA_HEADS)
        torch.cuda.synchronize()
        err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
        ok = all(bool(((a.float() - b.float()).abs()
                       <= atol + rtol * b.float().abs()).all()) for a, b in zip(got, want))
        check(ok, f"linear_attention_bwd {dtype} N={n}: max err {err} beyond "
                  f"atol {atol} rtol {rtol}")
        ops = LA_BWD_PRODUCTS * 2 * BATCH * LA_HEADS * n * 32 * 32 + 8 * elements
        key = "bfloat16" if dtype == torch.bfloat16 else "float32"
        bytes_s = nbytes / HBM_BYTES_PER_S
        ops_s = ops / PEAK_OPS[key]
        rows.append(dict(
            kernel="linear_attention_bwd", dtype=key, shape=[BATCH, n, c],
            calls_per_forward=calls, max_abs_err=err, atol=atol, rtol=rtol,
            kernel_ms=time_ms(lambda *a: linear_attention_flat_bwd(*a, LA_HEADS), sets),
            plain_ms=time_ms(lambda *a: linear_attention_flat_bwd_plain(*a, LA_HEADS),
                             sets),
            library_ms=None, bound_ms=1e3 * max(bytes_s, ops_s),
            bound_by="bytes" if bytes_s >= ops_s else "operations"))
        emit("parity", **rows[-1])
    return rows


def _counters():
    from igm_tpu_torch.ops.groupnorm import group_norm_mish, group_norm_mish_bwd
    from igm_tpu_torch.ops.linear_attention import (linear_attention_flat,
                                                    linear_attention_flat_bwd)
    return (group_norm_mish, linear_attention_flat, group_norm_mish_bwd,
            linear_attention_flat_bwd)


def reset_counts() -> None:
    for fn in _counters():
        fn.launches = 0


def counts() -> tuple[int, int, int, int]:
    """Launches of (GroupNorm+Mish, linear attention, and their backwards)."""
    return tuple(fn.launches for fn in _counters())


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
        n_gn, n_la, n_gn_bwd, n_la_bwd = counts()
        want = cpu_net(x, t)
    check((n_gn, n_la, n_gn_bwd, n_la_bwd) == (25, 6, 0, 0),
          f"one forward launched {n_gn} GroupNorm+Mish and {n_la} linear "
          f"attention kernels and {n_gn_bwd} + {n_la_bwd} backwards, expected "
          f"25 and 6 and none")
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
        gn, la, *_ = (a - b for a, b in zip(counts(), before))
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
    gn, la, *_ = (a - b for a, b in zip(counts(), before))
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


def phase_train_unet() -> dict:
    """One f32 training step's loss and gradients, card against CPU."""
    import torch
    from igm_tpu_torch.config import compose, instantiate
    cfg = compose(REPO / "configs", ["experiment=ddpm/cifar10", "print_config=False"])
    models = [instantiate(cfg.model, datamodule=cfg.datamodule, device=d,
                          compute_dtype="float32") for d in ("cuda", "cpu")]
    gen = torch.Generator().manual_seed(3)
    weights = {k: v + 0.05 * torch.randn(v.shape, generator=gen)   # norms off 1, 0
               for k, v in models[1].modules.state_dict().items()}
    x0 = torch.rand(8, 32, 32, 3, generator=gen) * 2 - 1
    t = torch.randint(0, models[0].timesteps, (8,), generator=gen)
    noise = torch.randn(8, 32, 32, 3, generator=gen)
    out = []
    for model in models:
        dev = model.device
        model.modules.load_state_dict(weights)
        model.modules.train()
        reset_counts()
        loss, _ = model.loss(x0.to(dev), t.to(dev), noise.to(dev))
        grads = torch.autograd.grad(loss, list(model.modules["denoise"].parameters()))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            launches = counts()
        out.append((loss.item(), [g.cpu() for g in grads]))
        model.modules.eval()
    check(launches == (25, 6, 25, 6),
          f"one forward and backward launched {launches} (GroupNorm+Mish, linear "
          f"attention, their backwards), expected (25, 6, 25, 6)")
    (loss_card, g_card), (loss_cpu, g_cpu) = out
    # float32 with TF32 off on both sides: cuDNN's and the CPU's conv
    # algorithms round differently over ~40 layers forward and back (the
    # forward agrees to ~2e-5); gradients are held to 1e-3 of the largest
    # gradient entry plus 1% of each entry
    scale = max(g.abs().max().item() for g in g_cpu)
    atol, rtol, loss_rtol = 1e-3 * scale, 1e-2, 1e-4
    err = max(((a - b).abs() - rtol * b.abs()).max().item()
              for a, b in zip(g_card, g_cpu))
    rel = max(((a - b).abs().max() / scale).item() for a, b in zip(g_card, g_cpu))
    check(math.isfinite(loss_card) and abs(loss_card - loss_cpu) <= loss_rtol * abs(loss_cpu),
          f"train_unet: loss card {loss_card} vs CPU {loss_cpu}")
    check(err <= atol, f"train_unet: gradient error {err} beyond {atol}")
    row = dict(batch=8, dtype="float32", loss_card=loss_card, loss_cpu=loss_cpu,
               loss_rtol=loss_rtol, grad_max_abs_err_over_max_grad=rel,
               grad_atol_over_max_grad=1e-3, grad_rtol=rtol, max_grad=scale,
               parameters=len(g_cpu), launches=dict(zip(
                   ("group_norm_mish", "linear_attention", "group_norm_mish_bwd",
                    "linear_attention_bwd"), launches)))
    emit("train_unet", **row)
    return row


def _train_cli(tmp: Path, *overrides: str) -> float:
    """python -m igm_tpu_torch.train in ``tmp``: a run directory of its own
    under tmp/logs/runs, synthetic data, no TensorBoard."""
    from igm_tpu_torch.cli import train_main
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        return train_main(["experiment=ddpm/cifar10", "trainer.limit_train_batches=3",
                           "trainer.limit_val_batches=1",
                           "trainer.check_val_every_n_epoch=1",
                           "model.val_sampler=ddim", "logger=null",
                           "print_config=False", "optimized_metric=train_loss/loss",
                           f"datamodule.data_dir={tmp / 'data'}", *overrides])
    finally:
        os.chdir(cwd)


def phase_train() -> dict:
    """The training path; the caller zeroes the counters before it."""
    import torch
    from igm_tpu_torch.config import compose, instantiate
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        run = tmp / "logs" / "runs" / "ddpm" / "cifar10"
        for name, overrides, steps in (
                ("fit", ["trainer.max_epochs=2"], 6),
                ("resume", ["trainer.max_epochs=3",
                            f"trainer.resume={run / 'checkpoints'}"], 3)):
            before = counts()
            t0 = time.perf_counter()
            loss = _train_cli(tmp, *overrides)
            sec = time.perf_counter() - t0
            gn, la, gn_bwd, la_bwd = (a - b for a, b in zip(counts(), before))
            ckpts = sorted(p.name for p in (run / "checkpoints").iterdir())
            grids = sorted(p.name for p in (run / "results").iterdir())
            check(loss is not None and math.isfinite(loss), f"train {name}: loss {loss}")
            check((gn_bwd, la_bwd) == (25 * steps, 6 * steps),
                  f"train {name}: {gn_bwd}/{la_bwd} backward launches for {steps} steps")
            check(gn >= 25 * steps and la >= 6 * steps,
                  f"train {name}: {gn}/{la} forward launches for {steps} steps")
            out[name] = dict(steps=steps, seconds=sec, loss=loss, checkpoints=ckpts,
                             grids=grids, group_norm_mish_launches=gn,
                             linear_attention_launches=la,
                             group_norm_mish_bwd_launches=gn_bwd,
                             linear_attention_bwd_launches=la_bwd)
            emit("train", run=name, **out[name])
        # a checkpoint after each epoch; validation after each epoch
        check(out["fit"]["checkpoints"] == ["step_3.pt", "step_6.pt"]
              and out["fit"]["grids"] == ["0.jpg", "1.jpg"],
              f"train fit: checkpoints {out['fit']['checkpoints']}, "
              f"grids {out['fit']['grids']}")
        # resumed at step 6: one more epoch of 3 steps, not 9 from the start;
        # the newest two checkpoints are kept
        check(out["resume"]["checkpoints"] == ["step_6.pt", "step_9.pt"],
              f"train resume: checkpoints {out['resume']['checkpoints']}")

    # the train step at batch 256, bf16, timed as bench.py times igm_tpu's
    cfg = compose(REPO / "configs", ["experiment=ddpm/cifar10", "print_config=False"])
    model = instantiate(cfg.model, datamodule=cfg.datamodule, device="cuda")
    check(model.compute_dtype == torch.bfloat16, "compute dtype is not bf16")
    state = model.init_state(0)
    gen = torch.Generator("cuda").manual_seed(5)
    batch = (torch.randint(0, 256, (TRAIN_BATCH, 32, 32, 3), generator=gen,
                           device="cuda", dtype=torch.uint8),
             torch.zeros(TRAIN_BATCH, dtype=torch.int32, device="cuda"))
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as flop_counter:   # as the Trainer counts
        state, metrics = model.train_step(state, batch)
    flops = float(flop_counter.get_total_flops())
    for _ in range(2):                                   # warm-up
        state, metrics = model.train_step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = counts()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        state, metrics = model.train_step(state, batch)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = tuple(a - b for a, b in zip(counts(), before))
    loss = float(metrics["train_loss/loss"])
    check(math.isfinite(loss), f"timed train step: loss {loss}")
    check(launches == (25 * TRAIN_STEPS, 6 * TRAIN_STEPS, 25 * TRAIN_STEPS,
                       6 * TRAIN_STEPS), f"timed train step: launches {launches}")
    out["speed"] = dict(batch=TRAIN_BATCH, steps=TRAIN_STEPS, dtype="bfloat16",
                        seconds=sec, ms_per_step=1e3 * sec / TRAIN_STEPS,
                        images_per_s=TRAIN_BATCH * TRAIN_STEPS / sec, loss=loss,
                        flops_per_step=flops,
                        mfu=flops * TRAIN_STEPS / sec / PEAK_OPS["bfloat16"],
                        peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    emit("train", run="speed", **out["speed"])
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
    gn_bwd_rows = parity_gn_bwd(torch.bfloat16) + parity_gn_bwd(torch.float32)
    la_bwd_rows = parity_la_bwd(torch.bfloat16) + parity_la_bwd(torch.float32)
    phase_unet()
    sl = phase_slice()                  # the sampling path: zeroes, then reads
    phase_train_unet()
    reset_counts()                      # the training path
    tr = phase_train()
    tr_launches = counts()
    check(all(n > 0 for n in tr_launches),
          f"training path launched {tr_launches}: a kernel never ran")
    emit("train", run="path", launches=dict(zip(
        ("group_norm_mish", "linear_attention", "group_norm_mish_bwd",
         "linear_attention_bwd"), tr_launches)))
    kernels = []
    gn_src = "igm_tpu_torch/csrc/group_norm_mish.cu"
    la_src = "igm_tpu_torch/csrc/linear_attention.cu"
    for i, (name, rows, source, replaces, per) in enumerate((
            ("group_norm_mish", gn_rows, gn_src,
             "igm_tpu/ops/pallas_groupnorm.py:103", "forward"),
            ("linear_attention", la_rows, la_src,
             "igm_tpu/ops/pallas_attention.py:45", "forward"),
            ("group_norm_mish_bwd", gn_bwd_rows, gn_src,
             "igm_tpu/ops/pallas_groupnorm.py:132", "backward"),
            ("linear_attention_bwd", la_bwd_rows, la_src,
             "igm_tpu/ops/attention.py:99 (XLA custom VJP _flat_bwd)", "backward"))):
        main_rows = [r for r in rows if r["dtype"] == "bfloat16"]
        bytes_bound = all(r["bound_by"] == "bytes" for r in main_rows)
        by_path = {"sampling": sl["launches"][i], "training": tr_launches[i]}
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=totals(main_rows, "kernel_ms"), plain_ms=totals(main_rows, "plain_ms"),
            bound_ms=totals(main_rows, "bound_ms"),
            bound_by="bytes" if bytes_bound else "operations",
            library_ms=totals(main_rows, "library_ms"),
            per=f"all calls of one UNet {per}, batch 256, bf16"))
    emit("summary", train_images_per_s=tr["speed"]["images_per_s"],
         train_ms_per_step=tr["speed"]["ms_per_step"],
         ddim_images_per_s=sl["ddim"]["images_per_s"],
         ancestral_images_per_s=sl["ancestral"]["images_per_s"])
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
