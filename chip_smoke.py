#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (igm_tpu_torch) on one CUDA card and checks it.

    python3 chip_smoke.py [--only PHASE ...]

Phases, one JSON line each; a phase that fails raises and the script exits
non-zero (``--only`` runs the named phases alone after device and build,
and prints no result line):

  device  the card's name and power limit (nvidia-smi), torch and CUDA versions
  build   builds every kernel from igm_tpu_torch/csrc (one nvcc per source)
          and prints ptxas's registers and spill bytes of each kernel
  parity  each kernel against its plain PyTorch version on the card, at the
          flagship shapes with batch 256, in bf16 and f32, with its time, the
          plain version's, the least time the card could take (bound) and,
          for GroupNorm+Mish, F.mish(F.group_norm(...)) as a yardstick;
          GroupNorm+Mish also at the sampling batch 64 in bf16, at the
          flagship's five shapes and the latent UNet's three
  unet    one full-width Unet forward (hidden 64, dim_mults [1,2,4], batch 8,
          f32, TF32 off) on the card against the same weights on the CPU,
          where the kernel wrappers take their plain versions; and the launch
          counts of one forward (25 GroupNorm+Mish, 6 linear attention)
  slice   experiment=ddpm/cifar10 composed through the port's config, bf16 on
          the card: DDIM-50, DPM-Solver++ with dpm_steps (20) and the
          ancestral 1000-step chain at batch 64 (sample_batch), then the
          sampling CLI to PNGs: --sampler ddim, --sampler dpm, and --inpaint
          center on 8 validation images (RePaint over all 1000 steps; the
          known pixels of the results must equal the inputs bit for bit).
          The kernels' launch counters are zeroed just before and read just
          after, and must show 25 and 6 launches per UNet forward (one
          forward per timestep of the DPM grid).  Then a short f32 ancestral
          chain and a DPM-20 chain (karras grid) on the card against the CPU.
  parity  (backward) each backward kernel against its plain backward, at the
          same shapes, dtypes and timings; GroupNorm+Mish's yardstick is the
          autograd backward of F.mish(F.group_norm(...)), and its rows also
          cover the latent UNet's three shapes at batch 128 in bf16 and give
          each kernel's share of a call (kernel_split_us, torch.profiler)
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
  first_stage  one full-width VQ-VAE forward (experiment=vqvae/cifar10, f32,
          TF32 off, batch 8, a codebook drawn from the encoder's outputs) on
          the card against the same weights on the CPU: the reconstruction,
          the codes (equal but at near-ties), exactly one nearest_codebook
          launch
  latent  the VQ-VAE -> latent-DDPM chain, counters zeroed just before and
          read just after: the train CLI on experiment=vqvae/cifar10 (2
          epochs of 3 steps: loss, checkpoints, recon grids); on
          experiment=latent_ddpm/cifar10 with model.first_stage_ckpt (2
          epochs of 3 steps, DDIM validation, the calibrated latent scale),
          then a resume for 1 more epoch; the sampling CLI with --ckpt,
          DDIM-50 at batch 64 to a PNG; timed DDIM-50, DPM-20 and ancestral
          chains at batch 64 (bf16 denoiser, latent images/s); the sampling
          CLI with --ckpt and --inpaint center on 8 images (latent RePaint,
          known pixels exact); timed VQ-VAE and latent
          train steps at batch 128 (train images/s); a 10-step f32 latent
          chain and its decode on the card against the CPU.  Launches are
          checked exactly: 17 GroupNorm+Mish and 4 linear attention per
          latent-UNet forward, as many backward per latent train step, no
          nearest_codebook in a latent train step, one per decode and per
          VQ-VAE train step.
  tar     the TAR path (experiment=tar/mnist, model.flash_attention=dropout),
          counters zeroed just before and read just after: the dropout
          flash-attention parity rows (forward at rates 0 and 0.1, dq and
          dk/dv, B=128, S=785, H=4, D=64, bf16 and f32, one seed that wraps
          past 2**32, SDPA with dropout as the yardstick; every row names
          its design: bf16 on the tensor cores, f32 as FMAs);
          one TARNet forward, loss and f32 gradients (batch 8, dropout 0) on
          the card against the CPU; exact launches: 4/4/4 per train step, 4
          forwards at rate 0 per cal_loss (8 per validation batch), none per
          KV decode step; the
          train CLI (2 epochs of 3 steps, validation with samples and the
          masked completion), a resume, one epoch of experiment=tar/mnist_cond
          and the sampling CLI with --ckpt to a PNG; timed train steps at
          batch 128 bf16 with flash_attention=dropout and =off, and sample(64).
  fused_block  the bench tool's path (python -m
          igm_tpu_torch.tools.bench_fused_block, in-process, --iters 3),
          counters zeroed just before and read just after: every variant
          timed, the kernel within the bf16 tolerance of the plain version at
          each flagship level, and exactly 3 x (20 x (1 + 3) + 1) launches of
          the fused-block kernel (and of the Block's GroupNorm+Mish); no
          other path launches it.
  chain   graphed against eager (igm_tpu_torch/core/graphs.py): the train
          steps of the flagship (batch 256, bf16), the VQ-VAE (128, f32),
          the latent DDPM (128) and TAR (128, flash_attention=dropout), K
          graphed steps (the first call eager and captured, the second a
          replay) against K eager steps from the same state at K = 1 and 4:
          parameters, buffers, Adam moments and step counts, generator and
          step bit for bit, metrics equal to the eager steps' nan-mean, and
          exactly K steps' launches a replay; what steps_per_execution=auto
          resolves to at the config's batch and epoch (its probe restores
          the state bit for bit); eager against graphed steps at that K,
          a-b-b-a (ms/step, images/s), the eager step without cuDNN's
          deterministic algorithms, and the peak memory of each; DDIM-50
          and DPM-20 at batch 64 (flagship and latent) graphed against eager
          from the same x_T, bit for bit, a-b-b-a; the train CLI at
          trainer.steps_per_execution=3 and at 1 (3 epochs of 3 steps):
          the same checkpoint, bit for bit; and the host's cost of one
          graphed execution (dispatch, trainer.DISPATCH_S).
The sampling and training paths run their denoiser and train steps as CUDA
graphs (the counters add a graph's launches at every replay), and the CLI
runs resolve steps_per_execution=auto, whose probe trains 1 + AUTO_TIMED
steps on the state it then restores: the train, latent and tar phases
count those launches too.
The fused-block parity rows run with the other parity rows: the kernel
against block_fwd_plain at the three flagship levels (batch 256 bf16 and
batch 32 f32, with the kernel's, the plain version's and the UNet Block's
times and the bound) and tests/test_fused_block.py's four cases.
The nearest_codebook parity rows (f32, M x K x D = 8192 x 512 x 64, 4096 x
512 x 64 and a ragged 1000 x 500 x 64) run with the other parity rows: the
indices are equal except at near-ties (counted), with the kernel's time,
the plain version's, the bound and torch.cdist(z, e).argmin(1) as the
yardstick.

The kernels line carries, for the redesigned kernels (GroupNorm+Mish
forward and backward, the linear-attention forward and backward, rows 6-8,
nearest_codebook), their design and ptxas's registers and spills;
GroupNorm+Mish also its totals at batch 64 (``sampling_batch``: the
flagship's 25 calls, the latent UNet's 17), its backward and the linear
attention their latent UNet totals at batch 128, nearest_codebook its time
at each shape.

Every path names the kernels it must launch (PATH_KERNELS); each of those
must have launched at least once in that path's run.  Then the total time,
a line with the card's name and power limit, one JSON line {"kernels":
[...]} with every kernel's launches on every path, and last {"ok": true,
"device": {...}}.  Without a CUDA card the script exits non-zero and prints
no result.
"""
from __future__ import annotations

import copy
import gc
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
# the sampling batch (sample_batch), where most GroupNorm+Mish launches run,
# and the latent UNet's GroupNorm+Mish calls per forward (8x8x64 latents)
SAMPLE_BATCH = 64
LATENT_GN_SHAPES = [((8, 8, 64), 5), ((4, 4, 128), 8), ((4, 4, 64), 4)]
# the latent UNet's linear-attention calls per forward (8x8 and 4x4 latents),
# at its train batch: N = 16 packs 4 heads a CTA in both directions
LATENT_BATCH = 128
LATENT_LA_SHAPES = [(64, 1), (16, 3)]
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
VQ_TRAIN_BATCH = 128                 # the CIFAR-10 datamodule's batch
# (M, K, D) of the nearest-codebook search: the VQ-VAE train step (batch 128
# of 8x8 latents), a decode at batch 64, and a ragged case; then D past the
# resident kernel's 216 (the chunked kernel): model.latent_dim=256 at the
# train step, and 512 at a decode
VQ_SHAPES = [(8192, 512, 64), (4096, 512, 64), (1000, 500, 64), (8192, 512, 256),
             (4096, 512, 512)]
# N of bf16 linear attention past the tensor cores' 11,264 (the FMA kernel):
# the first, and a 128x128 UNet's first level (experiment=ddpm/celeba
# datamodule.width=128 datamodule.height=128), batch 2
LONG_LA_SHAPES = [(11265, 1), (16384, 1)]
LONG_LA_BATCH = 2
SLEEP_CYCLES = 50_000_000            # ~25 ms: the host queues timed launches meanwhile
L2_BYTES = 50 * 2 ** 20
# TAR (experiment=tar/mnist): a batch of 128 images of 28x28x1 binary pixels
# is S = 785 tokens; 4 heads of 64; attention-probs dropout 0.1
TAR_SHAPE = (128, 785, 4, 64)
TAR_RATE = 0.1
TAR_SEEDS = (20261016, 2 ** 32 - 5)  # the second wraps: seed + b*H + h passes 2**32
TAR_STEPS = 10
# the dropout hash's integer operations per live (query, key) pair, with the
# row term (qi * C1 ^ seed) and the column term (kj * C2) hoisted out of the
# pair loop, each with the first shift+xor round folded in (h ^ h >> 16
# distributes over the xor of the two terms): 1 xor of the two terms, 2
# shift+xor rounds (4), 2 multiplies, the compare and the select = 9, on the
# CUDA cores' int32 lanes: 132 SMs x 64 lanes x 1.98 GHz
HASH_OPS_PER_PAIR = 9
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# TARNet's f32 gradients, card against CPU, over the largest entry: 4x an
# H100's reading (1.07e-4) and 7x the CPU's own spread between two attention
# orders (5.7e-5), both at the same Dense_0 weight
GRAD_TOL = 4e-4
# the fused conv3x3+GroupNorm+Mish block (Pallas row 4): its f32 rows at a
# batch that keeps the phase short, held to the 3e-5 that
# tests/test_fused_block.py holds the Pallas kernel to against XLA
FUSED_F32_BATCH = 32
FUSED_F32_ATOL = 3e-5
# tests/test_fused_block.py's cases: (N, H, W, Cin, Cout, dtype)
FUSED_TEST_CASES = [(4, 8, 8, 16, 16, "float32"), (2, 6, 5, 8, 24, "float32"),
                    (2, 4, 4, 3, 16, "float32"), (2, 8, 8, 16, 16, "bfloat16")]
BENCH_ITERS = 3
INPAINT_N = 8


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


def phase_build() -> dict:
    """Builds every kernel library; returns ptxas's registers and spills of
    each kernel, by library."""
    from igm_tpu_torch.ops import _build
    t0 = time.perf_counter()
    libs = _build.libraries()
    usage = {lib: _build.resource_usage(lib) for lib in sorted(libs)}
    emit("build", seconds=time.perf_counter() - t0, libraries=sorted(libs),
         flags=list(_build.NVCC_FLAGS), ptxas=usage)
    return usage


def parity_gn(dtype, batch: int = BATCH, shapes=GN_SHAPES, model: str = "flagship") -> list[dict]:
    import torch
    import torch.nn.functional as F
    from igm_tpu_torch.ops.groupnorm import group_norm_mish, group_norm_mish_plain
    atol, rtol = tolerance(dtype)
    elt = torch.finfo(dtype).bits // 8
    rows = []
    for (h, w, c), calls in shapes:
        g = torch.Generator(device="cuda").manual_seed(
            h * 1000 + c + (0 if batch == BATCH else batch))

        def make(i, h=h, w=w, c=c, g=g):
            x = (torch.randn(batch, h, w, c, generator=g, device="cuda") * 2
                 + 0.5).to(dtype)
            gamma = torch.randn(c, generator=g, device="cuda") * 0.1 + 1.0
            beta = torch.randn(c, generator=g, device="cuda") * 0.1
            return x, gamma, beta

        elements = batch * h * w * c
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
            kernel="group_norm_mish", dtype=str(dtype).split(".")[-1], model=model,
            shape=[batch, h, w, c], calls_per_forward=calls,
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


def parity_la(dtype, batch: int = BATCH, shapes=LA_SHAPES,
              model: str = "flagship") -> list[dict]:
    import torch
    from igm_tpu_torch.ops.linear_attention import (fwd_on_tensor_cores,
                                                    linear_attention_flat,
                                                    linear_attention_flat_plain)
    atol, rtol = tolerance(dtype)
    elt = torch.finfo(dtype).bits // 8
    c = LA_HEADS * 32
    rows = []
    for n, calls in shapes:
        g = torch.Generator(device="cuda").manual_seed(n + (0 if batch == BATCH else batch))

        def make(i, n=n, g=g):
            return tuple(torch.randn(batch, n, c, generator=g, device="cuda")
                         .to(dtype) for _ in range(3))

        elements = batch * n * c
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
        ops = 4 * batch * LA_HEADS * n * 32 * 32 + 3 * elements
        key = "bfloat16" if dtype == torch.bfloat16 else "float32"
        bytes_s = nbytes / HBM_BYTES_PER_S
        ops_s = ops / PEAK_OPS[key]
        rows.append(dict(
            kernel="linear_attention", dtype=key, model=model, shape=[batch, n, c],
            calls_per_forward=calls, max_abs_err=err.max().item(),
            atol=atol, rtol=rtol,
            kernel_ms=time_ms(lambda *a: linear_attention_flat(*a, LA_HEADS), sets),
            plain_ms=time_ms(lambda *a: linear_attention_flat_plain(*a, LA_HEADS),
                             sets),
            library_ms=None, bound_ms=1e3 * max(bytes_s, ops_s),
            bound_by="bytes" if bytes_s >= ops_s else "operations",
            design=attention_design(dtype)["design"] if dtype != torch.bfloat16
            or fwd_on_tensor_cores(n) else "f32 FMA (bf16 past the tensor cores' N)"))
        emit("parity", **rows[-1])
    return rows


def grad_err(got, want) -> float:
    """Largest error of f32 parameter gradients relative to their largest
    value (they are sums over up to N*H*W products)."""
    return ((got - want).abs().max() / want.abs().max().clamp(min=1e-30)).item()


PARAM_GRAD_RTOL = 1e-4


def kernel_split_us(fn, args, iters: int = 20) -> dict[str, float]:
    """Device time of one call of ``fn(*args)`` by kernel (torch.profiler),
    in us: which share of a wrapper's call each of its kernels takes."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn(*args)
        torch.cuda.synchronize()
    split: dict[str, float] = {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            name = e.name.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].removeprefix("void ").split("::")[-1]
            split[name] = split.get(name, 0.0) + e.time_range.elapsed_us() / iters
    return split


def parity_gn_bwd(dtype, batch: int = BATCH, shapes=GN_SHAPES,
                  model: str = "flagship") -> list[dict]:
    import torch
    import torch.nn.functional as F
    from igm_tpu_torch.ops.groupnorm import (group_norm_mish_bwd,
                                             group_norm_mish_bwd_plain)
    atol, rtol = tolerance(dtype)
    elt = torch.finfo(dtype).bits // 8
    rows = []
    for (h, w, c), calls in shapes:
        g = torch.Generator(device="cuda").manual_seed(
            h * 1000 + c + 7 + (0 if batch == BATCH else batch))

        def make(i, h=h, w=w, c=c, g=g):
            x = (torch.randn(batch, h, w, c, generator=g, device="cuda") * 2
                 + 0.5).to(dtype)
            gamma = torch.randn(c, generator=g, device="cuda") * 0.1 + 1.0
            beta = torch.randn(c, generator=g, device="cuda") * 0.1
            grad = torch.randn(batch, h, w, c, generator=g, device="cuda").to(dtype)
            return x, gamma, beta, grad

        elements = batch * h * w * c
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
            kernel="group_norm_mish_bwd", dtype=str(dtype).split(".")[-1], model=model,
            shape=[batch, h, w, c], calls_per_forward=calls,
            max_abs_err=err.max().item(), atol=atol, rtol=rtol,
            dparam_rel_err=perr, dparam_rtol=PARAM_GRAD_RTOL,
            kernel_ms=time_ms(lambda *a: group_norm_mish_bwd(*a, 8), sets),
            plain_ms=time_ms(lambda *a: group_norm_mish_bwd_plain(*a, 8), sets),
            library_ms=time_ms(library, lib_sets),
            bound_ms=1e3 * max(bytes_s, ops_s),
            bound_by="bytes" if bytes_s >= ops_s else "operations",
            kernel_split_us=kernel_split_us(lambda *a: group_norm_mish_bwd(*a, 8), sets[0])))
        emit("parity", **rows[-1])
        del lib_sets
    return rows


def parity_la_bwd(dtype, batch: int = BATCH, shapes=LA_SHAPES,
                  model: str = "flagship") -> list[dict]:
    import torch
    from igm_tpu_torch.ops.linear_attention import (BF16_BWD_TC_MAX_N, bwd_on_tensor_cores,
                                                    linear_attention_flat_bwd,
                                                    linear_attention_flat_bwd_plain)
    # the Python constant is the built kernel's shape rule
    check(bwd_on_tensor_cores(BF16_BWD_TC_MAX_N)
          and not bwd_on_tensor_cores(BF16_BWD_TC_MAX_N + 1),
          f"BF16_BWD_TC_MAX_N = {BF16_BWD_TC_MAX_N} is not the kernel's rule")
    atol, rtol = tolerance(dtype)
    elt = torch.finfo(dtype).bits // 8
    c = LA_HEADS * 32
    rows = []
    for n, calls in shapes:
        g = torch.Generator(device="cuda").manual_seed(
            n + 7 + (0 if batch == BATCH else batch))

        def make(i, n=n, g=g):
            return tuple(torch.randn(batch, n, c, generator=g, device="cuda")
                         .to(dtype) for _ in range(4))

        elements = batch * n * c
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
        ops = LA_BWD_PRODUCTS * 2 * batch * LA_HEADS * n * 32 * 32 + 8 * elements
        key = "bfloat16" if dtype == torch.bfloat16 else "float32"
        bytes_s = nbytes / HBM_BYTES_PER_S
        ops_s = ops / PEAK_OPS[key]
        rows.append(dict(
            kernel="linear_attention_bwd", dtype=key, model=model, shape=[batch, n, c],
            calls_per_forward=calls, max_abs_err=err, atol=atol, rtol=rtol,
            kernel_ms=time_ms(lambda *a: linear_attention_flat_bwd(*a, LA_HEADS), sets),
            plain_ms=time_ms(lambda *a: linear_attention_flat_bwd_plain(*a, LA_HEADS),
                             sets),
            library_ms=None, bound_ms=1e3 * max(bytes_s, ops_s),
            bound_by="bytes" if bytes_s >= ops_s else "operations",
            design=attention_design(dtype)["design"]))
        emit("parity", **rows[-1])
    return rows


def fused_block_bound(n: int, h: int, w: int, ci: int, co: int, dtype) -> dict:
    """The least time of one fused-block call: its bytes (x read and the
    output written once, the weights and the three (Cout,) f32 vectors) over
    the memory rate, against its products (2 N H W 9 Cin Cout) at the rate of
    its type; the GroupNorm and Mish arithmetic adds under 2% and is left out."""
    import torch
    elt = torch.finfo(dtype).bits // 8
    nbytes = (n * h * w * (ci + co) + 9 * ci * co) * elt + 3 * co * 4
    key = "bfloat16" if dtype == torch.bfloat16 else "float32"
    bytes_s = nbytes / HBM_BYTES_PER_S
    ops_s = 2 * n * h * w * 9 * ci * co / PEAK_OPS[key]
    return dict(bytes=nbytes, bound_ms=1e3 * max(bytes_s, ops_s),
                bound_by="bytes" if bytes_s >= ops_s else "operations",
                bound_terms_ms={"bytes": 1e3 * bytes_s, "products": 1e3 * ops_s})


def parity_fused_block() -> list[dict]:
    """fused_block_fwd against block_fwd_plain: the bench tool's three
    flagship shapes at batch 256 in bf16 (timed: the kernel, the plain
    version, the UNet's cuDNN-conv Block and the bound) and at batch
    FUSED_F32_BATCH in f32, then tests/test_fused_block.py's four cases."""
    import numpy as np
    import torch
    from igm_tpu_torch.ops.fused_block import block_fwd_plain, fused_block_fwd
    from igm_tpu_torch.tools.bench_fused_block import SHAPES, unet_block
    rows = []
    cases = ([(BATCH, *s, "bfloat16") for s in SHAPES]
             + [(FUSED_F32_BATCH, *s, "float32") for s in SHAPES])
    for n, h, w, ci, co, dname in cases + FUSED_TEST_CASES:
        dtype = getattr(torch, dname)
        flagship = (h, w, ci, co) in SHAPES
        if flagship:
            g = torch.Generator(device="cuda").manual_seed(n * 1000 + h + co)

            def make(i, n=n, h=h, w=w, ci=ci, co=co, dtype=dtype, g=g):
                return (torch.randn(n, h, w, ci, generator=g, device="cuda").to(dtype),
                        (torch.randn(3, 3, ci, co, generator=g, device="cuda") * 0.05).to(dtype),
                        torch.randn(co, generator=g, device="cuda") * 0.1,
                        1 + torch.randn(co, generator=g, device="cuda") * 0.1,
                        torch.randn(co, generator=g, device="cuda") * 0.1)

            bound = fused_block_bound(n, h, w, ci, co, dtype)
            sets = rotation(make, bound["bytes"])
        else:                           # tests/test_fused_block.py's inputs
            rng = np.random.default_rng(0)
            arrays = (rng.normal(size=(n, h, w, ci)), rng.normal(size=(3, 3, ci, co)) * 0.1,
                      rng.normal(size=(co,)) * 0.1, 1 + rng.normal(size=(co,)) * 0.1,
                      rng.normal(size=(co,)) * 0.1)
            sets = [tuple(torch.tensor(np.asarray(a, np.float32), device="cuda").to(
                dtype if i < 2 else torch.float32) for i, a in enumerate(arrays))]
        got = fused_block_fwd(*sets[0])
        want = block_fwd_plain(*sets[0])
        torch.cuda.synchronize()
        atol, rtol = (FUSED_F32_ATOL, 0.0) if dtype == torch.float32 else tolerance(dtype)
        err = (got.float() - want.float()).abs()
        check(got.dtype == dtype and bool((err <= atol + rtol * want.float().abs()).all()),
              f"fused_block_fwd {dname} {n}x{h}x{w}x{ci}->{co}: max err "
              f"{err.max().item()} beyond atol {atol} rtol {rtol}")
        row = dict(kernel="fused_block_fwd", dtype=dname, shape=[n, h, w, ci, co],
                   max_abs_err=err.max().item(), atol=atol, rtol=rtol)
        if flagship:
            block = unet_block(*sets[0][1:], dtype)
            with torch.no_grad():
                row.update(
                    kernel_ms=time_ms(fused_block_fwd, sets),
                    plain_ms=time_ms(block_fwd_plain, sets),
                    block_ms=time_ms(lambda x, *_: block(x), sets),
                    library_ms=None, **{k: v for k, v in bound.items() if k != "bytes"})
        rows.append(row)
        emit("parity", **row)
    return rows


KERNELS = ("group_norm_mish", "linear_attention", "group_norm_mish_bwd",
           "linear_attention_bwd", "nearest_codebook", "dropout_attention_fwd",
           "dropout_attention_dq", "dropout_attention_dkv", "fused_block_fwd")
# the kernels each path must launch; the others may stay at 0 there
PATH_KERNELS = {
    "sampling": ("group_norm_mish", "linear_attention"),
    "training": ("group_norm_mish", "linear_attention", "group_norm_mish_bwd",
                 "linear_attention_bwd"),
    "latent": ("group_norm_mish", "linear_attention", "group_norm_mish_bwd",
               "linear_attention_bwd", "nearest_codebook"),
    "tar": ("dropout_attention_fwd", "dropout_attention_dq", "dropout_attention_dkv"),
    "fused_block": ("fused_block_fwd",),
}


def _counters():
    from igm_tpu_torch.ops.dropout_attention import (dropout_attention_dkv,
                                                     dropout_attention_dq,
                                                     dropout_attention_fwd)
    from igm_tpu_torch.ops.fused_block import fused_block_fwd
    from igm_tpu_torch.ops.groupnorm import group_norm_mish, group_norm_mish_bwd
    from igm_tpu_torch.ops.linear_attention import (linear_attention_flat,
                                                    linear_attention_flat_bwd)
    from igm_tpu_torch.ops.vq import nearest_codebook
    return (group_norm_mish, linear_attention_flat, group_norm_mish_bwd,
            linear_attention_flat_bwd, nearest_codebook, dropout_attention_fwd,
            dropout_attention_dq, dropout_attention_dkv, fused_block_fwd)


def expected(**named: int) -> tuple[int, ...]:
    """A counts() tuple: the named kernels' launches, 0 for the others."""
    unknown = set(named) - set(KERNELS)
    check(not unknown, f"unknown kernels {unknown}")
    return tuple(named.get(k, 0) for k in KERNELS)


def check_path(path: str, got: tuple[int, ...]) -> None:
    """Every kernel the path must launch launched at least once."""
    idle = [k for k, n in zip(KERNELS, got) if k in PATH_KERNELS[path] and n <= 0]
    check(not idle, f"{path} path launched {dict(zip(KERNELS, got))}: "
                    f"{idle} never ran")


def reset_counts() -> None:
    for fn in _counters():
        fn.launches = 0


def counts() -> tuple[int, ...]:
    """Launches of the kernels named in KERNELS, in that order."""
    return tuple(fn.launches for fn in _counters())


def since(before: tuple[int, ...]) -> tuple[int, ...]:
    return tuple(a - b for a, b in zip(counts(), before))


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
        n_gn, n_la, *_ = launched = counts()
        want = cpu_net(x, t)
    check(launched == expected(group_norm_mish=25, linear_attention=6),
          f"one forward launched {dict(zip(KERNELS, launched))}, expected 25 "
          f"GroupNorm+Mish and 6 linear attention and nothing else")
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

    dpm_steps = int(model.hparams.dpm_steps)
    # np.unique may shorten the grid: one forward per timestep that remains
    dpm_forwards = len(model._dpm_timesteps(dpm_steps, str(model.hparams.dpm_schedule)))
    out = {"batch": n}
    reset_counts()
    for name, run, forwards in (
            ("ddim", lambda g: model.ddim_sample(n, steps=steps, generator=g), steps),
            ("dpm", lambda g: model.dpm_sample(n, steps=dpm_steps, generator=g),
             dpm_forwards),
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

    # the sampling CLI: DDIM-50 and DPM-20 at batch 64, RePaint (one pass per
    # step over all T) on INPAINT_N validation images
    with tempfile.TemporaryDirectory() as tmp:
        for name, args, forwards, grid in (
                ("cli", ["--n", str(n), "--sampler", "ddim", "--steps", str(steps)], steps,
                 (2 + 8 * 34, 2 + 8 * 34)),
                ("cli_dpm", ["--n", str(n), "--sampler", "dpm"], dpm_forwards,
                 (2 + 8 * 34, 2 + 8 * 34)),
                ("cli_inpaint", ["--n", str(INPAINT_N), "--inpaint", "center",
                                 f"datamodule.data_dir={Path(tmp) / 'data'}"],
                 model.timesteps, (2 + 8 * 34, 2 + 2 * 34))):
            png = Path(tmp) / f"{name}.png"
            before = counts()
            t0 = time.perf_counter()
            imgs = sample_main([*overrides, *args, "--out", str(png)])
            sec = time.perf_counter() - t0
            with Image.open(png) as img:
                size = img.size
            gn, la, *_ = since(before)
            check(size == grid, f"{name} grid size {size}")
            check((gn, la) == (25 * forwards, 6 * forwards),
                  f"{name}: {gn}/{la} launches for {forwards} forwards")
            out[name] = dict(seconds=sec, grid=list(size), forwards=forwards,
                             group_norm_mish_launches=gn, linear_attention_launches=la)
            if name == "cli_inpaint":
                out[name].update(inpaint_known_pixels(imgs, INPAINT_N))
            emit("slice", sampler=name, **out[name])
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

    # DPM-20 in f32, card against CPU from the same x_T, on the karras grid:
    # its first step (sigma 80) divides the eps gap by sqrt(alphas_cumprod)
    # = 0.0125, where the uniform grid's t = 999 divides it by 4.9e-5
    x_T = torch.randn(shape, generator=gen)
    got = f32[0].dpm_sample(shape[0], steps=20, schedule="karras", x_T=x_T.cuda()).cpu()
    want = f32[1].dpm_sample(shape[0], steps=20, schedule="karras", x_T=x_T)
    err = (got - want).abs().max().item()
    check(math.isfinite(err) and err <= atol,
          f"f32 DPM-20: card vs CPU max err {err} beyond {atol}")
    out["reference_dpm"] = dict(steps=20, schedule="karras", batch=shape[0],
                                max_abs_err=err, atol=atol)
    emit("slice", sampler="reference_dpm", **out["reference_dpm"])
    return out


def inpaint_known_pixels(imgs, n: int) -> dict:
    """The --inpaint center grid's images: n masked inputs (holes 0), then n
    results, whose known pixels must equal the inputs' bit for bit."""
    import torch
    h, w = imgs.shape[1:3]
    known = torch.ones(h, w, dtype=torch.bool, device=imgs.device)
    known[h // 4: 3 * h // 4, w // 4: 3 * w // 4] = False
    masked, painted = imgs[:n], imgs[n:]
    check(tuple(imgs.shape[:1]) == (2 * n,) and bool(torch.isfinite(painted).all()),
          f"inpaint: {tuple(imgs.shape)} or non-finite results")
    check(torch.equal(painted[:, known], masked[:, known]),
          "inpaint: known pixels differ from the input")
    check(bool((masked[:, ~known] == 0).all()), "inpaint: holes not erased in the inputs")
    return dict(known_pixels=int(known.sum()) * n, known_pixels_equal=True,
                hole_abs_mean=painted[:, ~known].abs().mean().item())


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
    want_launches = expected(group_norm_mish=25, linear_attention=6,
                             group_norm_mish_bwd=25, linear_attention_bwd=6)
    check(launches == want_launches,
          f"one forward and backward launched {launches} ({', '.join(KERNELS)}), "
          f"expected {want_launches}")
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
               parameters=len(g_cpu), launches=dict(zip(KERNELS, launches)))
    emit("train_unet", **row)
    return row


def _train_cli(tmp: Path, *overrides: str, experiment: str = "ddpm/cifar10",
               metric: str = "train_loss/loss") -> float:
    """python -m igm_tpu_torch.train in ``tmp``: a run directory of its own
    under tmp/logs/runs, synthetic data, no TensorBoard."""
    from igm_tpu_torch.cli import train_main
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        return train_main([f"experiment={experiment}", "trainer.limit_train_batches=3",
                           "trainer.limit_val_batches=1",
                           "trainer.check_val_every_n_epoch=1", "logger=null",
                           "print_config=False", f"optimized_metric={metric}",
                           f"datamodule.data_dir={tmp / 'data'}", *overrides])
    finally:
        os.chdir(cwd)


def phase_train() -> dict:
    """The training path; the caller zeroes the counters before it."""
    import torch
    from igm_tpu_torch.config import compose, instantiate
    from igm_tpu_torch.core.trainer import AUTO_TIMED
    probe = 1 + AUTO_TIMED              # steps_per_execution=auto's timed steps
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
            loss = _train_cli(tmp, "model.val_sampler=ddim", *overrides)
            sec = time.perf_counter() - t0
            gn, la, gn_bwd, la_bwd, vq, *_ = since(before)
            ckpts = sorted(p.name for p in (run / "checkpoints").iterdir())
            grids = sorted(p.name for p in (run / "results").iterdir())
            check(loss is not None and math.isfinite(loss), f"train {name}: loss {loss}")
            check((gn_bwd, la_bwd) == (25 * (steps + probe), 6 * (steps + probe)),
                  f"train {name}: {gn_bwd}/{la_bwd} backward launches for {steps} steps "
                  f"and auto's {probe}")
            check(gn >= 25 * steps and la >= 6 * steps and vq == 0,
                  f"train {name}: {gn}/{la}/{vq} forward launches for {steps} steps")
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
    check(launches == expected(group_norm_mish=25 * TRAIN_STEPS,
                               linear_attention=6 * TRAIN_STEPS,
                               group_norm_mish_bwd=25 * TRAIN_STEPS,
                               linear_attention_bwd=6 * TRAIN_STEPS),
          f"timed train step: launches {launches}")
    out["speed"] = dict(batch=TRAIN_BATCH, steps=TRAIN_STEPS, dtype="bfloat16",
                        seconds=sec, ms_per_step=1e3 * sec / TRAIN_STEPS,
                        images_per_s=TRAIN_BATCH * TRAIN_STEPS / sec, loss=loss,
                        flops_per_step=flops,
                        mfu=flops * TRAIN_STEPS / sec / PEAK_OPS["bfloat16"],
                        peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    emit("train", run="speed", **out["speed"])
    return out


def parity_vq() -> list[dict]:
    """nearest_codebook against its plain version, f32, at the VQ-VAE train
    step's and the decode's shapes and a ragged one."""
    import torch
    from igm_tpu_torch.ops.vq import near_tie_gaps, nearest_codebook, nearest_codebook_plain
    rows = []
    for m, k, d in VQ_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(m + k)

        def make(i, m=m, k=k, d=d, g=g):
            return (torch.randn(m, d, generator=g, device="cuda"),
                    torch.randn(k, d, generator=g, device="cuda"))

        nbytes = (m * d + k * d) * 4 + m * 4          # z and e in, idx out
        sets = rotation(make, nbytes)
        z, e = sets[0]
        got = nearest_codebook(z, e)
        want = nearest_codebook_plain(z, e)
        torch.cuda.synchronize()
        n_diff, gap, abs_gap = near_tie_gaps(z, e, got, want)
        check(gap <= 1.0, f"nearest_codebook {m}x{k}x{d}: {n_diff} rows differ, "
                          f"largest score gap {gap} of the near-tie scale")
        bytes_s = nbytes / HBM_BYTES_PER_S
        ops_s = 2 * m * k * d / PEAK_OPS["float32"]
        rows.append(dict(
            kernel="nearest_codebook", dtype="float32", shape=[m, k, d],
            rows_differ=n_diff, near_tie_gap=gap, near_tie_rtol=1e-5,
            max_abs_err=abs_gap,          # score gap at the rows that differ
            kernel_ms=time_ms(nearest_codebook, sets),
            plain_ms=time_ms(nearest_codebook_plain, sets),
            library_ms=time_ms(lambda z, e: torch.cdist(z, e).argmin(1), sets),
            library="torch.cdist(z, e).argmin(1): two calls, the reference's formula",
            bound_ms=1e3 * max(bytes_s, ops_s),
            bound_by="bytes" if bytes_s >= ops_s else "operations",
            kernel_split_us=kernel_split_us(nearest_codebook, sets[0])))
        emit("parity", **rows[-1])
    return rows


def _first_stage_weights(model, gen, imgs):
    """Seeded weights with a codebook drawn from the encoder's own outputs (as
    a trained codebook lies among them), on the CPU."""
    import torch
    model.init_params(0)
    with torch.no_grad():
        z = model.modules["encoder"](model.preprocess(imgs)).reshape(-1, model.hparams.latent_dim)
        pick = torch.randint(0, len(z), (model.hparams.num_embeddings,), generator=gen)
        book = z[pick] + 0.05 * z.std() * torch.randn(
            model.hparams.num_embeddings, z.shape[1], generator=gen)
        model.modules["vq"].embedding.copy_(book)
    return {k: v.clone() for k, v in model.modules.state_dict().items()}


def phase_first_stage() -> dict:
    """One full-width VQ-VAE forward (f32, TF32 off, batch 8) on the card
    against the same weights on the CPU."""
    import torch
    from igm_tpu_torch.config import compose, instantiate
    from igm_tpu_torch.ops.vq import near_tie_gaps
    cfg = compose(REPO / "configs", ["experiment=vqvae/cifar10", "print_config=False"])
    models = [instantiate(cfg.model, datamodule=cfg.datamodule, device=d)
              for d in ("cuda", "cpu")]
    gen = torch.Generator().manual_seed(11)
    imgs = torch.randint(0, 256, (8, 32, 32, 3), generator=gen, dtype=torch.uint8)
    weights = _first_stage_weights(models[1], gen, imgs)
    models[0].modules.load_state_dict(weights)
    out = []
    for model in models:
        x = model.preprocess(imgs)
        reset_counts()
        recon = model.forward(None, x)
        if model.device.type == "cuda":
            torch.cuda.synchronize()
            launches = counts()
        with torch.no_grad():
            z = model.modules["encoder"](x)
            _, _, _, idx = model.modules["vq"](z, train=False)
        out.append((recon.cpu(), idx.cpu(), z.cpu()))
    (r_card, i_card, z_card), (r_cpu, i_cpu, z_cpu) = out
    check(launches == expected(nearest_codebook=1),
          f"first_stage: one forward launched {launches}")
    n_diff, gap, _ = near_tie_gaps(z_cpu.reshape(len(i_cpu), -1),
                                models[1].modules["vq"].embedding, i_card, i_cpu)
    check(gap <= 1.0, f"first_stage: {n_diff} codes differ beyond a near-tie ({gap})")
    # images whose codes all agree; a near-tie flip moves one code's whole patch
    same = (i_card == i_cpu).reshape(8, -1).all(dim=1)
    err = (r_card - r_cpu).abs()[same].max().item() if same.any() else 0.0
    # float32 with TF32 off on both sides over 10 conv layers; cuDNN's and the
    # CPU's algorithms (Winograd and FFT among cuDNN's) round differently
    atol = 5e-4
    check(math.isfinite(err) and err <= atol, f"first_stage recon: max err {err} > {atol}")
    row = dict(batch=8, dtype="float32", recon_max_abs_err=err, atol=atol,
               recon_abs_max=r_cpu.abs().max().item(), codes=len(i_cpu),
               codes_differ=n_diff, near_tie_gap=gap,
               images_compared=int(same.sum()), launches=dict(zip(KERNELS, launches)))
    emit("first_stage", **row)
    return row


def _latent_model(ckpt: Path, dtype: str = "auto", device: str = "cuda"):
    """experiment=latent_ddpm/cifar10 at full width with every module from the
    newest checkpoint in ``ckpt``."""
    from igm_tpu_torch.config import compose, instantiate
    from igm_tpu_torch.core.checkpoint import CheckpointManager
    cfg = compose(REPO / "configs", ["experiment=latent_ddpm/cifar10", "print_config=False"])
    model = instantiate(cfg.model, datamodule=cfg.datamodule, device=device,
                        compute_dtype=dtype)
    model.modules.load_state_dict(CheckpointManager(str(ckpt)).restore_raw()["params"])
    return model


def phase_latent() -> dict:
    """The VQ-VAE -> latent-DDPM chain through the CLIs, then timed loops;
    the caller zeroes the counters before it."""
    import torch
    from PIL import Image
    from igm_tpu_torch.cli import sample_main
    from igm_tpu_torch.config import compose, instantiate
    from igm_tpu_torch.core.trainer import AUTO_TIMED
    from igm_tpu_torch.ops.vq import near_tie_gaps, nearest_codebook
    probe = 1 + AUTO_TIMED              # steps_per_execution=auto's timed steps
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # 1. the first stage
        vq_run = tmp / "logs" / "runs" / "vqvae" / "cifar10"
        before = counts()
        t0 = time.perf_counter()
        loss = _train_cli(tmp, "trainer.max_epochs=2", experiment="vqvae/cifar10",
                          metric="train_loss/recon_loss")
        sec = time.perf_counter() - t0
        launches = since(before)
        ckpts = sorted(p.name for p in (vq_run / "checkpoints").iterdir())
        grids = sorted(p.name for p in (vq_run / "results").iterdir())
        check(loss is not None and math.isfinite(loss), f"vqvae fit: loss {loss}")
        check(ckpts == ["step_3.pt", "step_6.pt"] and grids == ["recon_0.jpg", "recon_1.jpg"],
              f"vqvae fit: checkpoints {ckpts}, grids {grids}")
        # one search per train step (6, and auto's), per validation forward (2)
        check(launches == expected(nearest_codebook=6 + probe + 2),
              f"vqvae fit: launches {launches}")
        out["vqvae_fit"] = dict(steps=6, seconds=sec, recon_loss=loss, checkpoints=ckpts,
                                grids=grids, launches=dict(zip(KERNELS, launches)))
        emit("latent", run="vqvae_fit", **out["vqvae_fit"])

        # 2. the latent DDPM on the frozen first stage, then a resume
        run = tmp / "logs" / "runs" / "latent_ddpm" / "cifar10"
        first_stage = f"model.first_stage_ckpt={vq_run / 'checkpoints'}"
        for name, overrides, steps in (
                ("fit", ["trainer.max_epochs=2"], 6),
                ("resume", ["trainer.max_epochs=3",
                            f"trainer.resume={run / 'checkpoints'}"], 3)):
            before = counts()
            t0 = time.perf_counter()
            loss = _train_cli(tmp, first_stage, "model.val_sampler=ddim", *overrides,
                              experiment="latent_ddpm/cifar10")
            sec = time.perf_counter() - t0
            gn, la, gn_bwd, la_bwd, vq, *_ = since(before)
            ckpts = sorted(p.name for p in (run / "checkpoints").iterdir())
            grids = sorted(p.name for p in (run / "results").iterdir())
            saved = torch.load(run / "checkpoints" / ckpts[-1], weights_only=True)
            scale = float(saved["params"]["latent.scale"])
            check(loss is not None and math.isfinite(loss), f"latent {name}: loss {loss}")
            check(math.isfinite(scale) and scale > 0 and scale != 1.0,
                  f"latent {name}: latent scale {scale} not calibrated")
            trained = steps + probe
            check((gn_bwd, la_bwd) == (17 * trained, 4 * trained),
                  f"latent {name}: {gn_bwd}/{la_bwd} backward launches for {steps} steps "
                  f"and auto's {probe}")
            # validation per epoch: recon, diffused and DDIM-50 samples, each decoded
            epochs = steps // 3
            check(gn == 17 * (trained + 50 * epochs) and la == 4 * (trained + 50 * epochs)
                  and vq == 3 * epochs,
                  f"latent {name}: {gn}/{la}/{vq} forward launches for {steps} steps")
            out[name] = dict(steps=steps, seconds=sec, loss=loss, latent_scale=scale,
                             checkpoints=ckpts, grids=grids,
                             launches=dict(zip(KERNELS, since(before))))
            emit("latent", run=name, **out[name])
        check(out["fit"]["checkpoints"] == ["step_3.pt", "step_6.pt"]
              and out["fit"]["grids"] == ["0.jpg", "1.jpg"],
              f"latent fit: checkpoints {out['fit']['checkpoints']}, "
              f"grids {out['fit']['grids']}")
        check(out["resume"]["checkpoints"] == ["step_6.pt", "step_9.pt"],
              f"latent resume: checkpoints {out['resume']['checkpoints']}")
        check(out["resume"]["latent_scale"] == out["fit"]["latent_scale"],
              "latent resume: the latent scale moved")

        # 3. the sampling CLI from the latent checkpoints, DDIM-50, batch 64
        overrides = ["experiment=latent_ddpm/cifar10"]
        png = tmp / "grid.png"
        before = counts()
        t0 = time.perf_counter()
        sample_main([*overrides, "--ckpt", str(run / "checkpoints"), "--n", "64",
                     "--sampler", "ddim", "--out", str(png)])
        sec = time.perf_counter() - t0
        launches = since(before)
        with Image.open(png) as img:
            size = img.size
        check(size == (2 + 8 * 34, 2 + 8 * 34), f"latent cli grid size {size}")
        check(launches == expected(group_norm_mish=17 * 50, linear_attention=4 * 50,
                                   nearest_codebook=1), f"latent cli: launches {launches}")
        out["cli"] = dict(seconds=sec, grid=list(size), launches=dict(zip(KERNELS, launches)))
        emit("latent", run="cli", **out["cli"])


        # 4. timed sampling, bf16 denoiser, batch 64, the trained weights
        model = _latent_model(run / "checkpoints")
        check(model.compute_dtype == torch.bfloat16, "latent compute dtype is not bf16")
        n = int(model.hparams.sample_batch)
        model.ddim_sample(n, steps=2, generator=torch.Generator("cuda").manual_seed(9))
        torch.cuda.synchronize()                              # warm-up
        dpm_steps = int(model.hparams.dpm_steps)
        dpm_forwards = len(model._dpm_timesteps(dpm_steps, str(model.hparams.dpm_schedule)))
        for name, fn, forwards in (
                ("ddim", lambda g: model.ddim_sample(n, steps=50, generator=g), 50),
                ("dpm", lambda g: model.dpm_sample(n, steps=dpm_steps, generator=g),
                 dpm_forwards),
                ("ancestral", lambda g: model.sample(n, g), model.timesteps)):
            before = counts()
            t0 = time.perf_counter()
            x = fn(torch.Generator("cuda").manual_seed(0))
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            launches = since(before)
            check(tuple(x.shape) == (n, 32, 32, 3) and bool(torch.isfinite(x).all()),
                  f"latent {name}: shape {tuple(x.shape)} or non-finite samples")
            check(launches == expected(group_norm_mish=17 * forwards,
                                       linear_attention=4 * forwards, nearest_codebook=1),
                  f"latent {name}: launches {launches} for {forwards} forwards")
            out[name] = dict(batch=n, steps=forwards, seconds=sec, images_per_s=n / sec,
                             launches=dict(zip(KERNELS, launches)))
            emit("latent", run=name, **out[name])

        # 4b. latent RePaint through the CLI: all T steps in latent space, the
        # encode and one decode, the known pixels composited back
        png = tmp / "inpaint.png"
        before = counts()
        t0 = time.perf_counter()
        imgs = sample_main([*overrides, "--ckpt", str(run / "checkpoints"), "--n",
                            str(INPAINT_N), "--inpaint", "center", "--out", str(png),
                            f"datamodule.data_dir={tmp / 'data'}"])
        sec = time.perf_counter() - t0
        launches = since(before)
        with Image.open(png) as img:
            size = img.size
        check(size == (2 + 8 * 34, 2 + 2 * 34), f"latent inpaint grid size {size}")
        steps_t = model.timesteps
        check(launches == expected(group_norm_mish=17 * steps_t, linear_attention=4 * steps_t,
                                   nearest_codebook=1), f"latent inpaint: launches {launches}")
        out["inpaint"] = dict(n=INPAINT_N, seconds=sec, grid=list(size),
                              launches=dict(zip(KERNELS, launches)),
                              **inpaint_known_pixels(imgs, INPAINT_N))
        emit("latent", run="inpaint", **out["inpaint"])

        # 5. timed train steps at the config's batch 128: the VQ-VAE and the
        # latent DDPM, with their launches per step
        cfg = compose(REPO / "configs", ["experiment=vqvae/cifar10", "print_config=False"])
        gen = torch.Generator("cuda").manual_seed(5)
        batch = (torch.randint(0, 256, (VQ_TRAIN_BATCH, 32, 32, 3), generator=gen,
                               device="cuda", dtype=torch.uint8),
                 torch.zeros(VQ_TRAIN_BATCH, dtype=torch.int32, device="cuda"))
        vq_model = instantiate(cfg.model, datamodule=cfg.datamodule, device="cuda")
        trained = {k: v.clone() for k, v in model.modules.state_dict().items()}
        for name, m, per_step in (
                ("vqvae_train", vq_model, expected(nearest_codebook=1)),
                ("latent_train", model, expected(group_norm_mish=17, linear_attention=4,
                                                 group_norm_mish_bwd=17,
                                                 linear_attention_bwd=4))):
            state = m.init_state(0)
            if m is model:                        # init_state redrew every module
                model.modules.load_state_dict(trained)
            for _ in range(2):
                state, metrics = m.train_step(state, batch)
            torch.cuda.synchronize()
            before = counts()
            t0 = time.perf_counter()
            for _ in range(TRAIN_STEPS):
                state, metrics = m.train_step(state, batch)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            launches = since(before)
            loss = {k: float(v) for k, v in metrics.items()}
            check(all(math.isfinite(v) for v in loss.values()), f"{name}: loss {loss}")
            check(launches == tuple(TRAIN_STEPS * c for c in per_step),
                  f"{name}: launches {launches} for {TRAIN_STEPS} steps")
            out[name] = dict(batch=VQ_TRAIN_BATCH, steps=TRAIN_STEPS, seconds=sec,
                             ms_per_step=1e3 * sec / TRAIN_STEPS,
                             images_per_s=VQ_TRAIN_BATCH * TRAIN_STEPS / sec, loss=loss,
                             launches_per_step=dict(zip(KERNELS, per_step)))
            emit("latent", run=name, **out[name])

        # 6. a short f32 latent chain and its decode, card against CPU, the
        # trained weights, the same injected noise
        f32 = [_latent_model(run / "checkpoints", "float32", d) for d in ("cuda", "cpu")]
    gen = torch.Generator().manual_seed(1)
    shape, t_start = (4, 8, 8, 64), 10
    x_T = torch.randn(shape, generator=gen)
    noises = [torch.randn(shape, generator=gen) for _ in range(t_start)]
    before = counts()
    z_card = f32[0].p_sample_loop(shape, t_start=t_start, init_x=x_T.cuda(),
                                  noises=[z.cuda() for z in noises])
    img_card = f32[0].decode(z_card).cpu()
    torch.cuda.synchronize()
    launches = since(before)
    z_cpu = f32[1].p_sample_loop(shape, t_start=t_start, init_x=x_T, noises=noises)
    img_cpu = f32[1].decode(z_cpu)
    check(launches == expected(group_norm_mish=17 * t_start, linear_attention=4 * t_start,
                               nearest_codebook=1),
          f"latent reference: launches {launches}")
    err = (z_card.cpu() - z_cpu).abs().max().item()
    atol = 1e-3                                   # as the slice phase's chain
    check(math.isfinite(err) and err <= atol, f"latent chain: card vs CPU {err} > {atol}")
    # the decode: codes equal but at near-ties; images whose codes all agree
    # within the first stage's tolerance
    z_q = (z_cpu / f32[1].scale).reshape(-1, shape[-1])
    book = f32[1].modules["vq"].embedding
    i_card = nearest_codebook((z_card / f32[0].scale).reshape(-1, shape[-1]).contiguous(),
                              f32[0].modules["vq"].embedding).cpu()
    i_cpu = nearest_codebook(z_q, book)
    n_diff, gap, _ = near_tie_gaps(z_q, book, i_card, i_cpu)
    check(gap <= 1.0, f"latent decode: {n_diff} codes differ beyond a near-tie ({gap})")
    same = (i_card == i_cpu).reshape(shape[0], -1).all(dim=1)
    img_err = (img_card - img_cpu).abs()[same].max().item() if same.any() else 0.0
    check(math.isfinite(img_err) and img_err <= 5e-4,
          f"latent decode: card vs CPU {img_err} > 5e-4 (as first_stage)")
    out["reference"] = dict(steps=t_start, batch=shape[0], latent_max_abs_err=err,
                            atol=atol, codes_differ=n_diff, near_tie_gap=gap,
                            image_max_abs_err=img_err, image_atol=5e-4,
                            images_compared=int(same.sum()),
                            launches=dict(zip(KERNELS, launches)))
    emit("latent", run="reference", **out["reference"])
    return out


def attention_bound(kind: str, dtype, rate: float) -> dict:
    """The least time of one dropout-attention kernel call at TAR_SHAPE: the
    largest of its bytes (each input read once, each output written once),
    its products over the causal half (the bf16 tensor cores, or f32 outside
    them) and, with dropout, the hash's integer operations."""
    import torch
    b, s, h, d = TAR_SHAPE
    elt = torch.finfo(dtype).bits // 8
    pairs = b * h * s * (s + 1) // 2                  # live (query, key) pairs
    # (B, S, H, D) tensors in and out, (B*H, S) float32 rows in and out, and
    # the products per pair: fwd q.k and p@v; dq adds do.v; dk/dv four
    tensors, rows, products = {"fwd": (4, 1, 2), "dq": (5, 2, 3), "dkv": (6, 2, 4)}[kind]
    key = "bfloat16" if dtype == torch.bfloat16 else "float32"
    terms = {"bytes": (tensors * b * s * h * d * elt + rows * b * h * s * 4) / HBM_BYTES_PER_S,
             "products": products * 2 * d * pairs / PEAK_OPS[key],
             "hash": HASH_OPS_PER_PAIR * pairs / INT32_OPS_PER_S if rate > 0 else 0.0}
    term = max(terms, key=terms.get)
    return dict(bound_ms=1e3 * terms[term],
                bound_by="bytes" if term == "bytes" else "operations", bound_term=term,
                bound_terms_ms={k: 1e3 * v for k, v in terms.items()})


def attention_design(dtype) -> dict:
    """How the forward, dq and dk/dv kernels (and the linear-attention
    forward) compute in ``dtype``: bf16 on the tensor cores (mma.sync, the
    redesigned kernels), float32 as FMAs on the CUDA cores (the first
    design, kept for the f32 checks)."""
    import torch
    if dtype == torch.bfloat16:
        return dict(design="mma.sync bf16", redesigned=True)
    return dict(design="f32 FMA", redesigned=False)


def parity_dropout_attention(dtype) -> list[dict]:
    """The dropout flash-attention kernels against their plain versions at
    TAR's shapes: the forward at rate 0 (evaluation) and 0.1 (training), the
    dq and dk/dv kernels at both rates, each also at a seed that wraps; lse,
    dq, dk and dv from the same inputs (the plain forward's lse and delta)."""
    import torch
    import torch.nn.functional as F
    from igm_tpu_torch.ops import dropout_attention as da
    atol, rtol = tolerance(dtype)
    key = "bfloat16" if dtype == torch.bfloat16 else "float32"
    g = torch.Generator(device="cuda").manual_seed(785)

    def make(i):
        return tuple(torch.randn(TAR_SHAPE, generator=g, device="cuda").to(dtype)
                     for _ in range(4))                            # q, k, v, do

    sets = rotation(make, 4 * math.prod(TAR_SHAPE) * torch.finfo(dtype).bits // 8)
    q, k, v, do = sets[0]

    def compare(name, got, want, tol) -> float:
        worst = 0.0
        for a, w in zip(got, want):
            err = (a.float() - w.float()).abs()
            worst = max(worst, err.max().item())
            check(bool((err <= tol[0] + tol[1] * w.float().abs()).all()),
                  f"{name} {key}: max err {err.max().item()} beyond atol {tol[0]} "
                  f"rtol {tol[1]}")
        return worst

    rows = []
    for rate, seed, timed in ((0.0, 0, True), (TAR_RATE, TAR_SEEDS[0], True),
                              (TAR_RATE, TAR_SEEDS[1], False)):
        sd = torch.tensor(seed, dtype=torch.int64, device="cuda")
        o, lse = da.dropout_attention_fwd(q, k, v, sd, rate)
        want_o, want_lse = da.dropout_attention_fwd_plain(q, k, v, sd, rate)
        grads_in = (q, k, v, do, want_lse, da.attention_delta(do, want_o), sd, rate)
        dq = da.dropout_attention_dq(*grads_in)
        dk, dv = da.dropout_attention_dkv(*grads_in)
        want_dq = da.dropout_attention_dq_plain(*grads_in)
        want_dk, want_dv = da.dropout_attention_dkv_plain(*grads_in)
        torch.cuda.synchronize()
        tag = f"rate {rate} seed {seed}"
        errs = {"fwd": compare(f"dropout_attention_fwd {tag}", [o], [want_o], (atol, rtol)),
                "dq": compare(f"dropout_attention_dq {tag}", [dq], [want_dq], (atol, rtol)),
                "dkv": compare(f"dropout_attention_dkv {tag}", [dk, dv], [want_dk, want_dv],
                               (atol, rtol))}
        lse_err = compare(f"dropout_attention_fwd lse {tag}", [lse], [want_lse],
                          tolerance(torch.float32))
        del o, lse, want_o, want_lse, grads_in, dq, dk, dv, want_dq, want_dk, want_dv
        times = {kind: dict(kernel_ms=None, plain_ms=None, library_ms=None)
                 for kind in errs}
        if timed:
            def sdpa(q, k, v, rate=rate):
                return F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    dropout_p=rate, is_causal=True)

            times["fwd"] = dict(
                kernel_ms=time_ms(lambda q, k, v, do: da.dropout_attention_fwd(
                    q, k, v, sd, rate), sets, iters=10),
                plain_ms=time_ms(lambda q, k, v, do: da.dropout_attention_fwd_plain(
                    q, k, v, sd, rate), sets, iters=3),
                library_ms=time_ms(lambda q, k, v, do: sdpa(q, k, v), sets, iters=10))
            # each set's lse and delta from the kernel forward; the yardstick
            # is SDPA's autograd backward (dq, dk and dv in one call), through
            # one forward graph per set, kept for the repeated calls
            bwd_sets, lib_sets = [], []
            for s_q, s_k, s_v, s_do in sets:
                s_o, s_lse = da.dropout_attention_fwd(s_q, s_k, s_v, sd, rate)
                bwd_sets.append((s_q, s_k, s_v, s_do, s_lse, da.attention_delta(s_do, s_o)))
                leaves = tuple(x.detach().requires_grad_() for x in (s_q, s_k, s_v))
                lib_sets.append((sdpa(*leaves), leaves, s_do.transpose(1, 2)))

            def library(out, leaves, grad):
                return torch.autograd.grad(out, leaves, grad, retain_graph=True)

            lib_ms = time_ms(library, lib_sets, iters=10)
            for kind, fn, plain in (("dq", da.dropout_attention_dq, da.dropout_attention_dq_plain),
                                    ("dkv", da.dropout_attention_dkv,
                                     da.dropout_attention_dkv_plain)):
                times[kind] = dict(
                    kernel_ms=time_ms(lambda *a, fn=fn: fn(*a, sd, rate), bwd_sets, iters=10),
                    plain_ms=time_ms(lambda *a, plain=plain: plain(*a, sd, rate), bwd_sets,
                                     iters=3),
                    library_ms=lib_ms)
            del bwd_sets, lib_sets
        for kind, err in errs.items():
            rows.append(dict(
                kernel=f"dropout_attention_{kind}", dtype=key, shape=list(TAR_SHAPE),
                rate=rate, seed=seed, max_abs_err=err, atol=atol, rtol=rtol,
                **({"lse_max_abs_err": lse_err} if kind == "fwd" else {}),
                **attention_design(dtype),
                **times[kind], **attention_bound(kind, dtype, rate)))
            emit("parity", **rows[-1])
    return rows


def _tar_model(device: str, *overrides: str, **kwargs):
    """experiment=tar/mnist at full width on ``device``."""
    from igm_tpu_torch.config import compose, instantiate
    cfg = compose(REPO / "configs", ["experiment=tar/mnist", "print_config=False", *overrides])
    return instantiate(cfg.model, datamodule=cfg.datamodule, device=device, **kwargs)


def phase_tar_reference() -> dict:
    """One full-width TARNet forward, loss and gradients in f32 (batch 8,
    dropout 0, TF32 off, flash_attention=dropout) on the card against the
    same weights and tokens on the CPU, where the kernel wrappers take their
    plain versions; and the CPU once more with flash_attention=off, whose
    attention sums in another order, to show the float32 spread."""
    import torch
    models = [_tar_model(d, flash_attention=mode, dropout=0.0, compute_dtype="float32")
              for d, mode in (("cuda", "dropout"), ("cpu", "dropout"), ("cpu", "off"))]
    gen = torch.Generator().manual_seed(17)
    weights = {k: v + 0.05 * torch.randn(v.shape, generator=gen)   # norms off 1, 0
               for k, v in models[1].net.state_dict().items()}
    tokens = torch.randint(0, 2, (8, models[1].seq_len), generator=gen)
    tokens[:, 0] = 0
    out = []
    for model in models:
        dev = model.device
        model.net.load_state_dict(weights)
        reset_counts()
        with torch.no_grad():
            logits = model.net(tokens.to(dev), train=False)
        loss = model.cal_loss(tokens.to(dev), train=True)
        grads = torch.autograd.grad(loss, list(model.net.parameters()))
        if model is models[0]:                        # the card
            torch.cuda.synchronize()
            launched = counts()
        out.append((logits.cpu(), loss.item(), [g.cpu() for g in grads]))
    # two forwards (logits, loss) and one backward, four layers each
    want = expected(dropout_attention_fwd=8, dropout_attention_dq=4, dropout_attention_dkv=4)
    check(launched == want, f"tar reference: launches {launched}, expected {want}")
    (l_card, loss_card, g_card), (l_cpu, loss_cpu, g_cpu), (_, _, g_off) = out
    # float32 with TF32 off on both sides, the products summed in other
    # orders over 4 post-LN layers: logits held to 1e-4 and the summed NLL
    # to 1e-5 of itself.  Gradients to GRAD_TOL of the largest gradient
    # entry: an FFN unit whose ReLU input lies within rounding of 0 switches
    # on in one order and off in the other, and takes its whole share of the
    # Dense_0 weight gradient with it (on the CPU alone, the `off` and
    # `dropout` attention orders differ there: ``cpu_orders_grad_rel``)
    logit_err = (l_card - l_cpu).abs().max().item()
    scale = max(g.abs().max().item() for g in g_cpu)
    names = [n for n, _ in models[1].net.named_parameters()]
    grad_rel, worst = max(((a - b).abs().max().item() / scale, n)
                          for a, b, n in zip(g_card, g_cpu, names))
    orders_rel, orders_worst = max(((a - b).abs().max().item() / scale, n)
                                   for a, b, n in zip(g_off, g_cpu, names))
    check(math.isfinite(logit_err) and logit_err <= 1e-4,
          f"tar reference: logits card vs CPU {logit_err} > 1e-4")
    check(abs(loss_card - loss_cpu) <= 1e-5 * abs(loss_cpu),
          f"tar reference: loss card {loss_card} vs CPU {loss_cpu}")
    check(grad_rel <= GRAD_TOL, f"tar reference: {worst} gradient {grad_rel} of the "
                                f"largest > {GRAD_TOL}")
    row = dict(batch=8, seq=models[1].seq_len, dtype="float32", logits_max_abs_err=logit_err,
               logits_atol=1e-4, loss_card=loss_card, loss_cpu=loss_cpu, loss_rtol=1e-5,
               grad_max_abs_err_over_max_grad=grad_rel, worst_gradient=worst,
               cpu_orders_grad_rel=orders_rel, cpu_orders_worst_gradient=orders_worst,
               grad_atol_over_max_grad=GRAD_TOL, max_grad=scale, parameters=len(g_cpu),
               launches=dict(zip(KERNELS, launched)))
    emit("tar", run="reference", **row)
    return row


def _tar_batch(n: int, gen):
    import torch
    return (torch.randint(0, 256, (n, 28, 28, 1), generator=gen, device="cuda",
                          dtype=torch.uint8),
            torch.randint(0, 10, (n,), generator=gen, device="cuda", dtype=torch.int32))


def _tar_launches(fwd: int = 0, bwd: int = 0) -> tuple[int, ...]:
    return expected(dropout_attention_fwd=fwd, dropout_attention_dq=bwd,
                    dropout_attention_dkv=bwd)


def phase_tar() -> dict:
    """The TAR path with flash_attention=dropout: exact launches per train
    step, validation batch and decode step, the CLIs, then timed loops; the
    caller zeroes the counters before it."""
    import torch
    from PIL import Image
    from igm_tpu_torch.cli import sample_main
    from igm_tpu_torch.core.trainer import AUTO_TIMED
    probe = 1 + AUTO_TIMED              # steps_per_execution=auto's timed steps
    out = {}
    n = TAR_SHAPE[0]
    batch = _tar_batch(n, torch.Generator("cuda").manual_seed(7))
    dropout = ["model.flash_attention=dropout"]

    # 1. launches per train step (4 layers: forward at rate 0.1, dq, dk/dv),
    # per validation batch (two cal_loss forwards at rate 0) and per KV
    # decode step (none: the decode attends over the cache in torch ops)
    model = _tar_model("cuda", *dropout)
    check(model.compute_dtype == torch.bfloat16, "tar compute dtype is not bf16")
    model.steps_per_epoch = 11
    state = model.init_state(0)
    per = {}
    before = counts()
    state, metrics = model.train_step(state, batch)
    torch.cuda.synchronize()
    per["train_step"] = since(before)
    before = counts()
    _, val = model.validation_step(state, batch, torch.Generator("cuda").manual_seed(1))
    torch.cuda.synchronize()
    per["validation_batch"] = since(before)
    tokens = model.img2tokens(model.preprocess(batch[0]), batch[1])
    model.net.init_cache(n, model.seq_len)
    before = counts()
    with torch.no_grad():
        logits = model.net.decode_step(tokens[:, :1], 0)
    torch.cuda.synchronize()
    per["decode_step"] = since(before)
    model.net.clear_cache()
    for name, want in (("train_step", _tar_launches(4, 4)),
                       ("validation_batch", _tar_launches(8)),
                       ("decode_step", _tar_launches())):
        check(per[name] == want, f"tar {name}: launches {per[name]}, expected {want}")
    values = [float(metrics["train_log/bpd"]), *map(float, val.values())]
    check(all(math.isfinite(x) for x in values) and bool(torch.isfinite(logits).all()),
          f"tar: non-finite bpd {values} or decode logits")
    out["launches"] = {k: dict(zip(KERNELS, v)) for k, v in per.items()}
    emit("tar", run="launches", **out["launches"])

    # 2. the train CLI: fit (validating every epoch: bpd, the sample and
    # masked-completion grids), resume and the class-conditional config
    # (no validation: its two 784-step KV decodes would double their time);
    # the sampling CLI from the class-conditional checkpoint
    no_val = ["trainer.limit_val_batches=0"]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for name, exp, overrides, steps, epochs in (
                ("fit", "tar/mnist", ["trainer.max_epochs=2"], 6, 2),
                ("resume", "tar/mnist", ["trainer.max_epochs=3", *no_val, "trainer.resume="
                 + str(tmp / "logs" / "runs" / "tar" / "mnist" / "checkpoints")], 3, 0),
                ("cond", "tar/mnist_cond", ["trainer.max_epochs=1", *no_val], 3, 0)):
            run = tmp / "logs" / "runs" / exp
            before = counts()
            t0 = time.perf_counter()
            metric = "val_log/bpd" if epochs else "train_log/bpd"
            bpd = _train_cli(tmp, *dropout, *overrides, experiment=exp, metric=metric)
            sec = time.perf_counter() - t0
            launched = since(before)
            ckpts = sorted(p.name for p in (run / "checkpoints").iterdir())
            grids = sorted(p.name for p in (run / "results").glob("*"))
            check(bpd is not None and math.isfinite(bpd), f"tar {name}: {metric} {bpd}")
            # one validation batch per validated epoch: its two cal_loss forwards
            want = _tar_launches(4 * (steps + probe) + 8 * epochs, 4 * (steps + probe))
            check(launched == want, f"tar {name}: launches {launched}, expected {want}")
            out[name] = dict(experiment=exp, steps=steps, seconds=sec, metric=metric, bpd=bpd,
                             checkpoints=ckpts, grids=grids,
                             launches=dict(zip(KERNELS, launched)))
            emit("tar", run=name, **out[name])
        fit_grids = sorted(["0.jpg", "1.jpg", "mask_image_0.jpg", "mask_image_1.jpg"])
        for name, ckpts, grids in (("fit", ["step_3.pt", "step_6.pt"], fit_grids),
                                   ("resume", ["step_6.pt", "step_9.pt"], fit_grids),
                                   ("cond", ["step_3.pt"], [])):
            check(out[name]["checkpoints"] == ckpts and out[name]["grids"] == grids,
                  f"tar {name}: checkpoints {out[name]['checkpoints']}, "
                  f"grids {out[name]['grids']}")

        png = tmp / "grid.png"
        before = counts()
        t0 = time.perf_counter()
        sample_main(["experiment=tar/mnist_cond", *dropout, "--ckpt",
                     str(tmp / "logs" / "runs" / "tar" / "mnist_cond" / "checkpoints"),
                     "--n", "64", "--out", str(png)])
        sec = time.perf_counter() - t0
        launched = since(before)
        with Image.open(png) as img:
            size = img.size
        check(size == (2 + 8 * 30, 2 + 8 * 30), f"tar cli grid size {size}")
        check(launched == _tar_launches(), f"tar cli: launches {launched}")
        out["cli"] = dict(seconds=sec, grid=list(size), launches=dict(zip(KERNELS, launched)))
        emit("tar", run="cli", **out["cli"])

    # 3. the train step at the config's batch 128, bf16, with the kernels
    # (flash_attention=dropout) and with the torch attention (off)
    for mode in ("dropout", "off"):
        m = model if mode == "dropout" else _tar_model("cuda", "model.flash_attention=off")
        m.steps_per_epoch = 11
        state = m.init_state(0)
        for _ in range(2):                                      # warm-up
            state, metrics = m.train_step(state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = counts()
        t0 = time.perf_counter()
        for _ in range(TAR_STEPS):
            state, metrics = m.train_step(state, batch)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launched = since(before)
        bpd = float(metrics["train_log/bpd"])
        want = _tar_launches(4 * TAR_STEPS, 4 * TAR_STEPS) if mode == "dropout" \
            else _tar_launches()
        check(math.isfinite(bpd), f"tar train {mode}: bpd {bpd}")
        check(launched == want, f"tar train {mode}: launches {launched}, expected {want}")
        out[f"train_{mode}"] = dict(
            flash_attention=mode, batch=n, steps=TAR_STEPS, dtype="bfloat16", seconds=sec,
            ms_per_step=1e3 * sec / TAR_STEPS, images_per_s=n * TAR_STEPS / sec, bpd=bpd,
            peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
            launches=dict(zip(KERNELS, launched)))
        emit("tar", run=f"train_{mode}", **out[f"train_{mode}"])
        del m, state

    # 4. sample(64): one KV decode step per position, no kernel launch
    before = counts()
    t0 = time.perf_counter()
    imgs = model.sample(64, torch.Generator("cuda").manual_seed(3))
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launched = since(before)
    check(tuple(imgs.shape) == (64, 28, 28, 1)
          and bool(((imgs == 0) | (imgs == 1)).all()), f"tar sample: {tuple(imgs.shape)}")
    check(launched == _tar_launches(), f"tar sample: launches {launched}")
    out["sample"] = dict(batch=64, decode_steps=model.seq_len - 1, seconds=sec,
                         images_per_s=64 / sec, ms_per_decode_step=1e3 * sec / (model.seq_len - 1))
    emit("tar", run="sample", **out["sample"])
    return out


def phase_fused_block() -> dict:
    """The bench tool's path, run in-process at --iters BENCH_ITERS: every
    variant line has a time, every shape's kernel output is within the bf16
    tolerance of the plain version's, and the kernel launched exactly
    DEPTH * (1 + iters) + 1 times per shape (the warm-up composition, the
    timed ones, one comparison), as did the Block's GroupNorm+Mish; the
    caller zeroes the counters before it."""
    import contextlib
    import io
    import torch
    from igm_tpu_torch.tools import bench_fused_block as bench
    before = counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        records = bench.main(["--iters", str(BENCH_ITERS)])
    sec = time.perf_counter() - t0
    launched = since(before)
    lines = [json.loads(x) for x in printed.getvalue().splitlines() if x.startswith("{")]
    check(lines == records, "bench_fused_block: printed lines differ from its records")
    atol, rtol = tolerance(torch.bfloat16)
    out = {}
    for h, w, ci, co in bench.SHAPES:
        shape = f"{BATCH}x{h}x{w}x{ci}->{co}"
        mine = [r for r in records if r["shape"] == shape]
        ms = {r["variant"]: r["ms"] for r in mine if "variant" in r}
        (diff,) = [r for r in mine if "variant" not in r]
        check(sorted(ms) == ["block", "cuda", "plain"]
              and all(math.isfinite(v) and v > 0 for v in ms.values()),
              f"bench_fused_block {shape}: times {ms}")
        limit = atol + rtol * diff["ref_abs_max"]
        check(diff["max_abs_diff"] is not None and diff["max_abs_diff"] <= limit,
              f"bench_fused_block {shape}: max_abs_diff {diff['max_abs_diff']} > {limit}")
        out[shape] = dict(ms=ms, max_abs_diff=diff["max_abs_diff"], limit=limit,
                          depth_max_abs_diff=diff["depth_max_abs_diff"],
                          block_max_abs_diff=diff["block_max_abs_diff"])
    per_shape = bench.DEPTH * (1 + BENCH_ITERS) + 1
    want = expected(fused_block_fwd=3 * per_shape, group_norm_mish=3 * per_shape)
    check(launched == want, f"bench_fused_block: launches {launched}, expected {want}")
    row = dict(iters=BENCH_ITERS, depth=bench.DEPTH, seconds=sec, shapes=out,
               launches=dict(zip(KERNELS, launched)))
    emit("fused_block", **row)
    return row


# ---------------------------------------------------------------- chain
# the four train steps the chain phase holds graphed against eager:
# (name, overrides, batch, launches per step)
CHAIN_MODELS = (
    ("flagship", ["experiment=ddpm/cifar10"], TRAIN_BATCH,
     dict(group_norm_mish=25, linear_attention=6, group_norm_mish_bwd=25,
          linear_attention_bwd=6)),
    ("vqvae", ["experiment=vqvae/cifar10"], VQ_TRAIN_BATCH, dict(nearest_codebook=1)),
    ("latent", ["experiment=latent_ddpm/cifar10"], LATENT_BATCH,
     dict(group_norm_mish=17, linear_attention=4, group_norm_mish_bwd=17,
          linear_attention_bwd=4)),
    ("tar", ["experiment=tar/mnist", "model.flash_attention=dropout"], TAR_SHAPE[0],
     dict(dropout_attention_fwd=4, dropout_attention_dq=4, dropout_attention_dkv=4)),
)
CHAIN_K = (1, 4)
CHAIN_TIMED_STEPS = 16               # per turn of the a-b-b-a timing
CHAIN_SAMPLE_BATCH = 64


def same_bits(a, b, path: str = "") -> list[str]:
    """The places where two nested state dicts differ (tensors bit for
    bit, on the CPU); empty when they are equal."""
    import torch
    if isinstance(a, torch.Tensor):
        a, b = a.detach().cpu(), b.detach().cpu()
        ok = a.shape == b.shape and a.dtype == b.dtype and torch.equal(
            a.view(torch.uint8) if a.dtype.is_floating_point and a.element_size() == 1 else a,
            b.view(torch.uint8) if b.dtype.is_floating_point and b.element_size() == 1 else b)
        if ok and a.dtype.is_floating_point:         # NaN bits too
            ok = bool((a.isnan() == b.isnan()).all())
        return [] if ok else [path]
    if isinstance(a, dict):
        if set(a) != set(b):
            return [f"{path}: keys"]
        return [d for k in a for d in same_bits(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return [f"{path}: length"]
        return [d for i, (x, y) in enumerate(zip(a, b)) for d in same_bits(x, y, f"{path}/{i}")]
    return [] if a == b else [f"{path}: {a!r} != {b!r}"]


def _chain_batches(model, n: int, k: int, seed: int):
    """k uint8 batches of n images (and labels) on the card, stacked."""
    import torch
    gen = torch.Generator("cuda").manual_seed(seed)
    imgs = torch.randint(0, 256, (k, n, model.height, model.width, model.channels),
                         generator=gen, device="cuda", dtype=torch.uint8)
    labels = torch.randint(0, 10, (k, n), generator=gen, device="cuda", dtype=torch.int32)
    return imgs, labels


def measure_dispatch() -> dict:
    """The host's cost of one graphed execution beyond its device work: a
    model whose train step is one small reduction, run through
    ``train_step_n`` (the chunk's copy into the graph's inputs, the launch,
    the metrics' copy out) back to back; the card idles, so the wall time
    per execution is the host's."""
    import torch
    from torch import nn
    from igm_tpu_torch.core.state import TrainState
    from igm_tpu_torch.models.base import BaseModel

    class Tiny(BaseModel):
        def train_step(self, state, batch):
            state.step += 1
            return state, {"loss": batch[0].float().mean()}

    model = Tiny({"width": 32, "height": 32, "channels": 3}, device="cuda")
    state = TrainState(nn.ModuleDict(), {}, torch.Generator("cuda").manual_seed(0))
    chunk = _chain_batches(model, TRAIN_BATCH, 1, 0)
    for _ in range(3):
        model.train_step_n(state, chunk)
    out = {}
    for name, graph in (("graphed", True), ("eager", False)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            model.train_step_n(state, chunk, graph=graph)
        torch.cuda.synchronize()
        out[f"{name}_s"] = (time.perf_counter() - t0) / 200
    return out


def _chain_model(name: str, overrides: list[str]):
    from igm_tpu_torch.config import compose, instantiate
    cfg = compose(REPO / "configs", [*overrides, "print_config=False"])
    model = instantiate(cfg.model, datamodule=cfg.datamodule, device="cuda")
    steps_per_epoch = 50_000 // int(cfg.datamodule.batch_size) if name != "tar" \
        else 60_000 // int(cfg.datamodule.batch_size)
    model.steps_per_epoch = steps_per_epoch
    return model, steps_per_epoch


def chain_train(name: str, overrides: list[str], batch: int, per_step: dict) -> dict:
    """K graphed steps against K eager steps from the same state, at K = 1
    and 4: the state bit for bit (parameters, buffers, Adam moments and
    step counts, generator, step) and the metrics equal to the eager steps'
    nan-mean; the launches of a replay exactly K steps'.  Then eager
    against graphed steps at the K ``auto`` resolves to, a-b-b-a, and the
    peak memory of each."""
    import numpy as np
    import torch
    from igm_tpu_torch.core.trainer import AUTO_TIMED, Trainer
    from igm_tpu_torch.models.base import merge_metrics
    model, steps_per_epoch = _chain_model(name, overrides)
    state = model.init_state(0)
    imgs, labels = _chain_batches(model, batch, max(CHAIN_K), 11)
    state, _ = model.train_step(state, (imgs[0], labels[0]))   # the Adam state exists
    start = state.snapshot()
    out = {"batch": batch, "steps_per_epoch": steps_per_epoch}
    for k in CHAIN_K:
        chunk = (imgs[:k], labels[:k])
        state.load_state_dict(start)
        eager = merge_metrics([model.train_step(state, (imgs[i], labels[i]))[1]
                               for i in range(k)])
        want = state.snapshot()
        runs = {}
        n_graphs = len(state.graphs)
        for run in ("warm_up", "replay"):     # the first call runs eagerly, then captures
            state.load_state_dict(start)
            check(len(state.graphs) == n_graphs + (run == "replay"),
                  f"chain {name} K={k}: {len(state.graphs)} graphs before the {run}")
            before = counts()
            _, metrics = model.train_step_n(state, chunk)
            torch.cuda.synchronize()
            launched = since(before)
            diff = same_bits(state.snapshot(), want) + same_bits(metrics, eager)
            check(not diff, f"chain {name} K={k} {run}: differs from eager at {diff[:8]}")
            check(launched == expected(**{kk: k * v for kk, v in per_step.items()}),
                  f"chain {name} K={k} {run}: launches {launched}")
            runs[run] = dict(launches=dict(zip(KERNELS, launched)))
        out[f"k{k}"] = dict(bit_equal=True, metrics={kk: float(v) for kk, v in eager.items()},
                            **runs)
        emit("chain", model=name, k=k, **out[f"k{k}"])

    # what auto resolves to at the config's batch and epoch
    state.load_state_dict(start)
    state.graphs.clear()
    trainer = Trainer(steps_per_execution="auto")
    train_arrays = (np.random.default_rng(0).integers(
        0, 256, (batch, model.height, model.width, model.channels), dtype=np.uint8),
        np.zeros(batch, dtype=np.int32))
    before = counts()
    k_auto = trainer._auto_steps_per_execution(model, state, train_arrays, batch,
                                               steps_per_epoch)
    probe = since(before)
    check(not same_bits(state.snapshot(), start), f"chain {name}: auto moved the state")
    check(probe == expected(**{kk: (1 + AUTO_TIMED) * v for kk, v in per_step.items()}),
          f"chain {name}: auto's probe launched {probe}")
    out["auto_k"] = k_auto

    # eager against graphed at auto's K, a-b-b-a, from the same state
    k = k_auto
    n_exec = max(1, CHAIN_TIMED_STEPS // k)
    chunk = (imgs[:1].expand(k, *imgs.shape[1:]).contiguous(),
             labels[:1].expand(k, *labels.shape[1:]).contiguous())
    model.train_step_n(state, chunk)                            # warm-up and capture
    times = {"eager": [], "graphed": []}
    for mode in ("eager", "graphed", "graphed", "eager"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_exec):
            state, metrics = model.train_step_n(state, chunk, graph=(mode == "graphed"))
        torch.cuda.synchronize()
        times[mode].append(1e3 * (time.perf_counter() - t0) / (n_exec * k))
    # device memory: the eager step's peak allocation above what lies
    # between steps, and what a captured graph keeps reserved (its private
    # pool: a step's activations, beside the eager cache)
    state.graphs.clear()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model.train_step_n(state, chunk, graph=False)
    torch.cuda.synchronize()
    eager_peak = torch.cuda.max_memory_allocated() - base
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    model.train_step_n(state, chunk)                 # eager first run, then the capture
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    peak = dict(eager_step_peak_gib=eager_peak / 2 ** 30,
                graph_pool_gib=(torch.cuda.memory_reserved() - reserved) / 2 ** 30)
    check(all(math.isfinite(float(v)) for v in metrics.values()),
          f"chain {name}: metrics {metrics}")
    # what cuDNN's deterministic algorithms cost: graphed steps (bound by the
    # card, not the host) captured without them
    torch.backends.cudnn.deterministic = False
    state.graphs.clear()
    model.train_step_n(state, chunk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_exec):
        model.train_step_n(state, chunk)
    torch.cuda.synchronize()
    times["graphed_nondeterministic"] = [1e3 * (time.perf_counter() - t0) / (n_exec * k)]
    torch.backends.cudnn.deterministic = True
    out["speed"] = dict(k=k, steps=n_exec * k, ms_per_step=times,
                        images_per_s={m: [batch * 1e3 / t for t in ts] for m, ts in times.items()},
                        peak_memory_gib=peak)
    emit("chain", model=name, run="speed", auto_k=k_auto, **out["speed"])
    del model, state
    torch.cuda.empty_cache()
    return out


def chain_samplers(name: str, model) -> dict:
    """DDIM-50 and DPM-20 at batch 64, graphed against eager from the same
    x_T: the samples bit for bit; images/s a-b-b-a."""
    import torch
    n = CHAIN_SAMPLE_BATCH
    x_T = torch.randn(model._sample_shape(n), generator=torch.Generator("cuda").manual_seed(4),
                      device="cuda")
    out = {}
    for sampler, run in (("ddim", lambda: model.ddim_sample(n, steps=50, x_T=x_T)),
                         ("dpm", lambda: model.dpm_sample(n, steps=20, x_T=x_T))):
        model.use_graphs = True
        run()                                               # warm-up and capture
        samples, sec = {}, {"eager": [], "graphed": []}
        for mode in ("eager", "graphed", "graphed", "eager"):
            model.use_graphs = mode == "graphed"
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            samples[mode] = run()
            torch.cuda.synchronize()
            sec[mode].append(time.perf_counter() - t0)
        model.use_graphs = True
        diff = same_bits(samples["graphed"], samples["eager"])
        check(not diff and bool(torch.isfinite(samples["graphed"]).all()),
              f"chain {name} {sampler}: graphed samples differ from eager")
        out[sampler] = dict(batch=n, bit_equal=True, seconds=sec,
                            images_per_s={m: [n / s for s in v] for m, v in sec.items()})
        emit("chain", model=name, sampler=sampler, **out[sampler])
    return out


def chain_cli() -> dict:
    """The train CLI at trainer.steps_per_execution=3 and at 1, 3 epochs of
    3 steps: the same checkpoints, bit for bit."""
    import torch
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for k in (1, 3):
            run = tmp / f"k{k}"
            run.mkdir()
            t0 = time.perf_counter()
            _train_cli(run, f"trainer.steps_per_execution={k}", "trainer.max_epochs=3",
                       "trainer.limit_val_batches=0")
            ckpt = run / "logs" / "runs" / "ddpm" / "cifar10" / "checkpoints"
            out[k] = dict(seconds=time.perf_counter() - t0,
                          checkpoints=sorted(p.name for p in ckpt.iterdir()),
                          saved=torch.load(ckpt / "step_9.pt", weights_only=True))
        diff = same_bits(out[3]["saved"], out[1]["saved"])
        check(out[1]["checkpoints"] == out[3]["checkpoints"] == ["step_6.pt", "step_9.pt"],
              f"chain cli: checkpoints {out[1]['checkpoints']}, {out[3]['checkpoints']}")
        check(not diff, f"chain cli: K=3 checkpoint differs from K=1 at {diff[:8]}")
    row = dict(steps=9, checkpoint_bit_equal=True,
               seconds={k: out[k]["seconds"] for k in (1, 3)})
    emit("chain", run="cli", **row)
    return row


def phase_chain() -> dict:
    """Graphed against eager: the four train steps, the samplers, the train
    CLI at K = 3; the host's cost of one execution; auto's K."""
    import torch
    out = {"dispatch": measure_dispatch()}
    emit("chain", run="dispatch", **out["dispatch"])
    for name, overrides, batch, per_step in CHAIN_MODELS:
        out[name] = chain_train(name, overrides, batch, per_step)
    for name, overrides in (("flagship", ["experiment=ddpm/cifar10"]),
                            ("latent", ["experiment=latent_ddpm/cifar10"])):
        model, _ = _chain_model(name, overrides)
        out[f"{name}_samplers"] = chain_samplers(name, model)
        del model
        torch.cuda.empty_cache()
    out["cli"] = chain_cli()
    return out


# the redesigned kernels of rows 1, 2, 3 and 5 and of _flat_bwd: (design,
# the prefix of their kernels' names in the ptxas report)
REDESIGNED = {
    "group_norm_mish": ("one pass: the slice staged in shared memory by cp.async, clusters "
                        "of up to 8 CTAs, Mish in closed form",
                        "group_norm_mish_onepass_kernel"),
    "group_norm_mish_bwd": ("one pass: x and g staged in shared memory by cp.async, clusters "
                            "of up to 8 CTAs, mish' in closed form once an element (dy kept "
                            "for dx: f32, or bf16 high and low parts), per-channel partials "
                            "in one round; the batch sum over 16 warps",
                            "group_norm_mish_bwd_onepass_kernel"),
    "nearest_codebook": ("f32 FMAs, 8 x 8 scores a thread from float4 loads, the z tile "
                         "resident, code tiles double-buffered by cp.async, the codebook "
                         "split over a cluster of up to 8 CTAs",
                         "nearest_codebook_kernel"),
    "linear_attention": ("mma.sync bf16", "linear_attention_mma_kernel"),
    "linear_attention_bwd": ("mma.sync bf16, f32 operands split into bf16 high and low",
                             "linear_attention_bwd_mma_kernel"),
}


def totals(rows: list[dict], key: str):
    vals = [r[key] for r in rows]
    if any(v is None for v in vals):
        return None
    return sum(v * r["calls_per_forward"] for v, r in zip(vals, rows))


T_START = time.perf_counter()


# phases that run alone with --only (a rehearsal of a changed phase)
ALONE = {"unet": lambda: phase_unet(), "slice": lambda: phase_slice(),
         "train_unet": lambda: phase_train_unet(), "train": lambda: phase_train(),
         "first_stage": lambda: phase_first_stage(), "latent": lambda: phase_latent(),
         "tar_reference": lambda: phase_tar_reference(), "tar": lambda: phase_tar(),
         "fused_block": lambda: phase_fused_block(), "chain": lambda: phase_chain(),
         "parity_vq": lambda: parity_vq()}


def main(argv=None) -> int:
    import argparse
    import torch
    parser = argparse.ArgumentParser(description="drive the port on one CUDA card")
    parser.add_argument("--only", nargs="+", choices=sorted(ALONE), default=None,
                        help="run these phases alone (after device and build) and stop; "
                             "prints no result line")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import igm_tpu_torch  # noqa: F401  (fails here, before any output, without the repo)
    smi = phase_device()
    # float32 products and convs in full float32 (the bf16 path ignores
    # these) and cuDNN's deterministic algorithms, as the CLIs run
    from igm_tpu_torch.utils.platform import set_numerics
    set_numerics()
    usage = phase_build()
    if args.only:
        for name in args.only:
            reset_counts()
            ALONE[name]()
        emit("only", phases=args.only, seconds=time.perf_counter() - T_START)
        return 0
    gn_rows = (parity_gn(torch.bfloat16) + parity_gn(torch.float32)
               + parity_gn(torch.bfloat16, SAMPLE_BATCH)
               + parity_gn(torch.bfloat16, SAMPLE_BATCH, LATENT_GN_SHAPES, "latent"))
    la_rows = [r for dtype in (torch.bfloat16, torch.float32)
               for r in parity_la(dtype)
               + parity_la(dtype, LATENT_BATCH, LATENT_LA_SHAPES, "latent")]
    la_rows += parity_la(torch.bfloat16, LONG_LA_BATCH, LONG_LA_SHAPES, "long")
    gn_bwd_rows = (parity_gn_bwd(torch.bfloat16) + parity_gn_bwd(torch.float32)
                   + parity_gn_bwd(torch.bfloat16, LATENT_BATCH, LATENT_GN_SHAPES, "latent"))
    la_bwd_rows = [r for dtype in (torch.bfloat16, torch.float32)
                   for r in parity_la_bwd(dtype)
                   + parity_la_bwd(dtype, LATENT_BATCH, LATENT_LA_SHAPES, "latent")]
    vq_rows = parity_vq()
    da_rows = parity_dropout_attention(torch.bfloat16) + parity_dropout_attention(torch.float32)
    fb_rows = parity_fused_block()
    phase_unet()
    sl = phase_slice()                  # the sampling path: zeroes, then reads
    check_path("sampling", sl["launches"])
    phase_train_unet()
    reset_counts()                      # the training path
    tr = phase_train()
    tr_launches = counts()
    check_path("training", tr_launches)
    emit("train", run="path", launches=dict(zip(KERNELS, tr_launches)))
    phase_first_stage()
    reset_counts()                      # the VQ-VAE -> latent-DDPM path
    lat = phase_latent()
    lat_launches = counts()
    check_path("latent", lat_launches)
    emit("latent", run="path", launches=dict(zip(KERNELS, lat_launches)))
    phase_tar_reference()
    reset_counts()                      # the TAR path
    tar = phase_tar()
    tar_launches = counts()
    check_path("tar", tar_launches)
    emit("tar", run="path", launches=dict(zip(KERNELS, tar_launches)))
    reset_counts()                      # the fused-block bench tool
    fb = phase_fused_block()
    fb_launches = counts()
    check_path("fused_block", fb_launches)
    path_launches = {"sampling": sl["launches"], "training": tr_launches,
                     "latent": lat_launches, "tar": tar_launches,
                     "fused_block": fb_launches}
    # row 4 is wired into no model: no other path may launch it
    fb_index = KERNELS.index("fused_block_fwd")
    elsewhere = {p: n[fb_index] for p, n in path_launches.items() if p != "fused_block"}
    check(not any(elsewhere.values()), f"fused_block_fwd launched on {elsewhere}")
    chain = phase_chain()               # graphed against eager

    def by_path(i: int) -> dict:
        return {path: n[i] for path, n in path_launches.items()}

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
        main_rows = [r for r in rows if r["dtype"] == "bfloat16"
                     and r["shape"][0] == BATCH and r.get("model", "flagship") == "flagship"]
        bytes_bound = all(r["bound_by"] == "bytes" for r in main_rows)
        # the redesigned kernels: their design and their ptxas report (the
        # other kernels' are in the build line)
        redesign = {}
        if name in REDESIGNED:
            design, prefix = REDESIGNED[name]
            redesign = dict(design=design, ptxas={
                k: v for k, v in usage[source.split("/")[-1][:-3]].items()
                if k.startswith(prefix)})
        if name == "group_norm_mish":        # the same at the sampling batch
            redesign["sampling_batch"] = {
                model: {key: totals([r for r in rows if r["shape"][0] == SAMPLE_BATCH
                                     and r["model"] == model], key)
                        for key in ("kernel_ms", "plain_ms", "library_ms", "bound_ms")}
                for model in ("flagship", "latent")}
        if name.startswith("linear_attention") or name == "group_norm_mish_bwd":
            # the latent UNet's calls
            redesign["latent"] = {
                key: totals([r for r in rows if r["dtype"] == "bfloat16"
                             and r["model"] == "latent"], key)
                for key in ("kernel_ms", "plain_ms", "library_ms", "bound_ms")}
        if name == "linear_attention":      # bf16 past the tensor cores: the FMA kernel
            redesign["long_n"] = [
                {key: r[key] for key in ("shape", "kernel_ms", "plain_ms", "bound_ms",
                                         "max_abs_err")}
                for r in rows if r["model"] == "long"]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(by_path(i).values()), launches_by_path=by_path(i),
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=totals(main_rows, "kernel_ms"), plain_ms=totals(main_rows, "plain_ms"),
            bound_ms=totals(main_rows, "bound_ms"),
            bound_by="bytes" if bytes_bound else "operations",
            library_ms=totals(main_rows, "library_ms"), **redesign,
            per=f"all calls of one UNet {per}, batch 256, bf16"))
    vq_main = vq_rows[0]
    kernels.append(dict(
        name="nearest_codebook", route="cuda",
        source="igm_tpu_torch/csrc/nearest_codebook.cu",
        replaces="igm_tpu/ops/pallas_vq.py:47", launches=sum(by_path(4).values()),
        launches_by_path=by_path(4), max_abs_err=max(r["max_abs_err"] for r in vq_rows),
        ms=vq_main["kernel_ms"], plain_ms=vq_main["plain_ms"],
        bound_ms=vq_main["bound_ms"], bound_by=vq_main["bound_by"],
        library_ms=vq_main["library_ms"], design=REDESIGNED["nearest_codebook"][0],
        ptxas={k: v for k, v in usage["nearest_codebook"].items()
               if k.startswith(REDESIGNED["nearest_codebook"][1])},
        shapes=[{key: r[key] for key in ("shape", "kernel_ms", "plain_ms", "library_ms",
                                         "bound_ms", "rows_differ")} for r in vq_rows],
        per="one call at M=8192, K=512, D=64 (a VQ-VAE train step at batch 128), f32; "
            "max_abs_err is the score gap at rows that differ; library_ms is "
            "torch.cdist(z, e).argmin(1), two calls"))
    for i, kind, replaces in ((5, "fwd", "igm_tpu/ops/pallas_dropout_attention.py:224"),
                              (6, "dq", "igm_tpu/ops/pallas_dropout_attention.py:288"),
                              (7, "dkv", "igm_tpu/ops/pallas_dropout_attention.py:309")):
        rows = [r for r in da_rows if r["kernel"] == KERNELS[i]]
        main = next(r for r in rows if r["dtype"] == "bfloat16" and r["rate"] == TAR_RATE
                    and r["kernel_ms"] is not None)
        kernels.append(dict(
            name=KERNELS[i], route="cuda", source="igm_tpu_torch/csrc/dropout_attention.cu",
            replaces=replaces, launches=sum(by_path(i).values()), launches_by_path=by_path(i),
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=main["kernel_ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
            bound_by=main["bound_by"], bound_term=main["bound_term"],
            library_ms=main["library_ms"], design=main["design"], ptxas={
                k: v for k, v in usage["dropout_attention"].items()
                if k.startswith(f"dropout_attention_{kind}_mma_kernel")},
            per=f"one call at B, S, H, D = {', '.join(map(str, TAR_SHAPE))}, bf16, rate "
                f"{TAR_RATE} (a TAR train step makes 4); library_ms is "
                + ("F.scaled_dot_product_attention with dropout" if kind == "fwd" else
                   "the autograd backward of that SDPA call, dq, dk and dv together")))
    fb_main = [r for r in fb_rows if r["dtype"] == "bfloat16" and "kernel_ms" in r]
    kernels.append(dict(
        name="fused_block_fwd", route="cuda", source="igm_tpu_torch/csrc/fused_block.cu",
        replaces="igm_tpu/ops/pallas_fused_block.py:105", launches=sum(by_path(fb_index).values()),
        launches_by_path=by_path(fb_index), max_abs_err=max(r["max_abs_err"] for r in fb_rows),
        ms=sum(r["kernel_ms"] for r in fb_main), plain_ms=sum(r["plain_ms"] for r in fb_main),
        block_ms=sum(r["block_ms"] for r in fb_main),
        bound_ms=sum(r["bound_ms"] for r in fb_main),
        bound_by="bytes" if sum(r["bound_terms_ms"]["bytes"] for r in fb_main)
        >= sum(r["bound_terms_ms"]["products"] for r in fb_main) else "operations",
        library_ms=None,
        per="one call at each of the three flagship levels (256x32x32x64->64, "
            "256x16x16x128->128, 256x8x8x256->256), bf16, summed; no one PyTorch call "
            "computes conv + GroupNorm + Mish, so library_ms is null; block_ms is the "
            "UNet's Block (cuDNN conv, then the GroupNorm+Mish kernel)"))
    emit("summary", train_images_per_s=tr["speed"]["images_per_s"],
         train_ms_per_step=tr["speed"]["ms_per_step"],
         ddim_images_per_s=sl["ddim"]["images_per_s"],
         ancestral_images_per_s=sl["ancestral"]["images_per_s"],
         dpm_images_per_s=sl["dpm"]["images_per_s"],
         latent_dpm_images_per_s=lat["dpm"]["images_per_s"],
         latent_ddim_images_per_s=lat["ddim"]["images_per_s"],
         latent_ancestral_images_per_s=lat["ancestral"]["images_per_s"],
         vqvae_train_images_per_s=lat["vqvae_train"]["images_per_s"],
         latent_train_images_per_s=lat["latent_train"]["images_per_s"],
         tar_train_images_per_s=tar["train_dropout"]["images_per_s"],
         tar_train_off_images_per_s=tar["train_off"]["images_per_s"],
         tar_train_dropout_over_off=tar["train_dropout"]["images_per_s"]
         / tar["train_off"]["images_per_s"],
         tar_sample_images_per_s=tar["sample"]["images_per_s"],
         dispatch_s=chain["dispatch"]["graphed_s"],
         auto_k={m: chain[m]["auto_k"] for m, *_ in CHAIN_MODELS},
         graphed_train_ms_per_step={m: chain[m]["speed"]["ms_per_step"] for m, *_ in CHAIN_MODELS},
         graphed_sampling_images_per_s={
             f"{m}_{s}": chain[f"{m}_samplers"][s]["images_per_s"]
             for m in ("flagship", "latent") for s in ("ddim", "dpm")},
         seconds=time.perf_counter() - T_START)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
