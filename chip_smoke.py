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
  dit     the DiT backbone, its Switch-MoE, EDM and flow matching, counters
          zeroed just before and read just after: the MoE DiT's routing at
          batch 4, card against CPU (igm_tpu_torch/tools/moe_routing.py:
          the tokens whose expert or kept slot differs, with their top-1
          router-logit margins); full-width DiT forwards
          (384 wide, 8 deep, 6 heads, batch 8, f32, TF32 off) on the card
          against the same weights on the CPU, the xla, flash and scan arms
          and an MoE DiT (8 experts every 2nd block, scatter); one f32
          train step's loss and gradients (batch 2) of the DDPM-DiT, EDM and
          flow on the DiT against the CPU; EDM's and flow's train steps on the
          flagship-width UNet (exactly 25 + 25 GroupNorm+Mish and 6 + 6
          linear attention); the train CLI on ddpm/cifar10_dit (DDIM
          validation), ddpm/cifar10_dit_v (DPM validation), edm/cifar10_dit
          and flow/cifar10_dit at full width and depth 2 (DIT_CLI; an epoch
          of 3 steps; flow's 2, then resumed) and the
          sampling CLI from their checkpoints (--sampler ddim, dpm, heun,
          the ODE); one block's attention core forward and backward at the
          train step's shapes, the xla arm and SDPA; the train step at
          batch 256 bf16 for attn=xla, attn=flash and the MoE DiT, graphed
          against eager a-b-b-a (ms, images/s, peak memory, a profile of
          each: idle share and device ms by group); DDIM-50 and DPM-20 on
          the DiT, EDM Heun-18 and flow Heun-50 on the DiT and the UNet at
          batch 64, graphed against eager a-b-b-a.  Every DiT run launches
          exactly no hand kernel; a UNet sampler 25 and 6 a forward.
  families  the score-SDE, consistency and distillation paths, counters
          zeroed just before and read just after: at full width in f32 (TF32
          off), batch 4, each family's train-step loss and gradients on the
          card against the CPU (score_sde/cifar10, consistency/cifar10,
          distill/mnist; the distillation target compared on its own below
          t = T-1 and the CPU's fed to both), a 4-level VE PC chain (1
          corrector), a 4-level VE ODE and 2-step consistency sampling from
          the same draws; exact launches: 25 + 25 and 6 + 6 a score-SDE
          step, 50 + 25 and 12 + 6 a consistency step, 51 + 17 and 12 + 4 a
          distillation step, 25 and 6 (17 and 4 on MNIST) a sampler forward;
          the train CLI (2 epochs of 3 steps; distill's then resumed) on the
          three experiments, distill/mnist from a ddpm/mnist teacher trained in the
          phase, and the sampling CLI from their checkpoints (the defaults,
          --sampler multistep, the student's --sampler ddim); each train step
          at batch 256 bf16 (distill 128) graphed against eager bit for bit
          and a-b-b-a (ms, images/s, peak memory, the graphed step's device
          busy time and idle share); VE PC-64, VE ODE-64, VP PC-64,
          consistency 1- and 2-step and the 8-step student at batch 64,
          graphed against eager, the samples bit for bit, a-b-b-a.
  likelihood  MADE, the gated PixelCNN and RealNVP (made/mnist,
          pixelcnn/mnist, pixelcnn/cifar10, realnvp/mnist, realnvp/cifar10),
          counters zeroed just before and read just after (no hand kernel on
          these paths: every count exactly 0): at full width in f32 (TF32
          off), batch 4, each train step's bpd and gradients on the card
          against the CPU; MADE's bf16 path (bf16 products, the output kernel
          and the Adam moments stored in bf16, counter-hash stochastic
          rounding): its bpd within 5e-3 of f32 on the same weights, 20 SR
          steps whose bpd falls, every masked entry of every kernel and
          moment exactly 0 after them, and the SR rounding of 2**20 values
          bit for bit as the CPU's; each train step at batch 128 graphed
          against eager bit for bit (MADE's SR seed draw included) and
          a-b-b-a (ms, images/s, peak memory, the graphed step's device busy
          time and idle share); MADE's optimizer update alone against its
          bound and its eager step by group; the samplers at batch 64 (MADE's
          784-step chain and PixelCNN's row sampler eager, RealNVP's inverse
          pass graphed against eager, bit for bit); the train CLI on one
          experiment of each model (made/mnist, pixelcnn/cifar10,
          realnvp/cifar10: 3 steps with the sample grid; realnvp's then a
          resume for 1) and the sampling CLI on realnvp/cifar10.
  vae     VAE, beta-VAE, cVAE and FactorVAE (vae/celeba, beta_vae/dsprites,
          factor_vae/dsprites, cvae/mnist, vae/mnist_mlp, composed from
          their experiment files at full width), counters zeroed just before
          and read just after (no hand kernel on these paths: every count
          exactly 0): in f32 (TF32 off), batch 8, from the same weights,
          batch and injected draws, the loss and every gradient on the card
          against the CPU, then one train step (both optimizers for
          FactorVAE): its metrics, parameters and BatchNorm buffers; each
          train step at batch 128 graphed against eager bit for bit
          (parameters, buffers, both optimizers) and a-b-b-a (ms, images/s,
          the graphed step's busy time, idle share and kernels per step; the
          eager step without cuDNN's deterministic algorithms, in turns);
          the decoder's sampling at batch 64 graphed against eager, bit for
          bit; the FID path's uint8 conversion and random features of 16
          CelebA validation images and a seeded InceptionV3 at batch 16 on
          the card against the CPU; the train CLI on each experiment (one
          epoch of 4 steps, 2 validation batches, the experiment's own
          callbacks: vae/celeba's FID logs metrics/fid_random_torch, the
          traversal grids are written) and the sampling CLI from its
          checkpoint; a fit with trainer.profile=true, whose trace must hold
          CUDA kernels.
  gan     the adversarial zoo, counters zeroed just before and read just
          after (no hand kernel on these paths: every count exactly 0): all
          33 zoo experiments and speed_gan composed at full width on the
          card, their parameters counted against a count from their
          configs; one experiment of each of the ten models and speed_gan
          (vanilla_gan/cifar10, lsgan/mlp_mnist, ggan/celeba, wgan/cifar10,
          wgan_gp/celeba, infogan/mnist, bigan/cifar10, vaegan/celeba,
          aae/mnist, age/celeba), batch 4, f32, one train step of each
          branch on the card against float64 on the CPU from the same
          weights, batch and injected draws (float64 on the card's side of
          any ReLU kink the two disagree on): the metrics (NaN where the
          branch did not run), every gradient of each update, the
          parameters each update leaves, the BatchNorm buffers; graphed
          against eager, bit for bit, over two periods and more at K = 1
          and at a K that is not a multiple of the period (parameters,
          buffers, optimizer
          states, generator, step, update counts, metrics with their NaNs;
          one graph per starting phase); the train step at the datamodule's
          batch over whole periods, graphed against eager a-b-b-a (ms,
          images/s, GFLOP a step, the graphed steps' busy time and idle
          share), sampling at batch 64 graphed against eager; the train CLI
          on each model's experiment (4 steps at K = 1, the experiment's own
          callbacks; infogan/mnist's epoch end logs its traversal grids) and
          the sampling CLI from its checkpoint; wgan/cifar10 resumed at
          step 4 (mid-period) ends where an uninterrupted run does, bit for
          bit.
  serve   the serving, evaluation and sweep tools, counters zeroed just
          before and read just after: experiment=ddpm/cifar10 at full width
          (bf16, seeded weights through --weights) exported with --sampler
          dpm --steps 20 --n 64 (python -m igm_tpu_torch.tools.export),
          served in this process (tools/serve.py: the warm-up captures the
          denoiser's graph), 20 sequential HTTP requests (exactly 25 and 6
          launches a DPM forward each, 500 and 120 a request), /stats, 8
          concurrent requests equal to the sequential ones, a PNG, 3 eager
          requests (graphs off) equal to the graphed ones and timed; the
          sampling CLI at the first 5 seeds equal to its response bit for
          bit; the --bench line (a server of its own, 20 requests); eval_fid
          on 256 DDIM fakes with the random backend; a two-job joblib grid
          multirun of a tiny vae/mnist_mlp whose workers (python -m
          igm_tpu_torch.train) train on the card.
  scores  the digit scorer's path: the packaged real digits made from the
          port's scans file (no scikit-learn); the digit classifier trained
          on the card (30 epochs, seed 0; validation accuracy > 0.90, its
          logits on the 360 validation scans against the same weights on
          the CPU); score_gallery over benchmarks/real_runs (read only: the
          port's scores beside the archived digit_scores.json, a report); a
          ddpm/cond_mnist fit on the real digits (2 epochs of 3 steps) with
          GifCallback writing video.gif; score_conditional --per-class 8 from
          its checkpoints, counters zeroed just before and read just after:
          exactly 17,000 GroupNorm+Mish and 4,000 linear attention (1000
          guided forwards at a doubled batch of 160); the host batcher built
          from csrc/batcher.cpp: a CIFAR-shaped epoch through epoch_batches
          equal to numpy's rows, and one batch's gather (256 CIFAR rows, 128
          MNIST rows) against numpy's, a-b-b-a.
  chain   graphed against eager (igm_tpu_torch/core/graphs.py): the train
          steps of the flagship (batch 256, bf16), the VQ-VAE (128, f32),
          the latent DDPM (128), TAR (128, flash_attention=dropout) and the
          DiT, dense and MoE (256, bf16, no hand kernel), K
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
  parallel  the data axis (igm_tpu_torch/parallel), counters zeroed just
          before and read just after (this process's and every rank's):
          (a) one NCCL rank in this process (a world-1 group through
          make_mesh): the flagship's graphed K = 1 train step at batch 256,
          bf16, 3 steps with the gradient and metric all-reduces inside the
          graph, bit for bit the ungrouped graphed steps from the same
          state, both timed graphed plain, NCCL, NCCL, plain; (b) two gloo
          ranks spawned on this card, eager: 2 steps each of the flagship
          (128 rows a rank against one process on 256), tar/mnist with
          flash_attention=dropout (the kernels' seed offset a rank) and
          vqvae/cifar10 with codebook_update=ema (the EMA counts and sums
          all-reduced): the ranks' states equal bit for bit, the metrics and
          every update's reduced gradients within PARALLEL_TOL of one
          process's, each rank's hand-kernel launches a step exactly the
          one-process step's; (c) DDIM-50 over 64 images through
          sample_sharded: on the NCCL rank bit for bit the one-process
          sampler, over the two gloo ranks bit for bit one process on each
          half of x_T and within PARALLEL_SAMPLE_MEAN_ATOL (mean absolute)
          of one process on 64; (d) the model axis and the MoE's global
          routing on the same two gloo ranks, 2 eager steps each against
          one process on the global batch (PARALLEL_MODEL_AXIS): FSDP
          (1, 2) on the full-width flagship at 256 bit for bit, exactly
          25 + 25 + 6 + 6 hand launches a rank a step, each rank's state
          under one process's; tensor (1, 2) on the full-width DiT in f32
          at 32 and the f32 MoE DiT at 16 on two data ranks (the same
          dropped tokens as one process) within PARALLEL_TOL; the pipeline
          (data 1, stage 2) at 2 microbatches and tensor + sequence (1, 2)
          on the full-width DiT in f32 at 32 (each rank's state under one
          process's) within PARALLEL_TOL.
  parallel_cards  (--only, on a host of more than one card; the default run
          leaves it out) one NCCL rank a card, spawned, each mesh of
          CARDS_CASES in turn (the data axis, FSDP (2, 2) on the flagship,
          tensor (2, 2) and composed (1, 2, 2) on the bf16 DiT, the MoE DiT
          on four data ranks, the pipeline (1, 4) and (2, 2) at 4
          microbatches and tensor + sequence (1, 4) and (2, 2) on the bf16
          DiT): the eager step against one process on card 0 on the whole
          global batch, 3 graphed steps with the collectives inside the
          graph (the pipeline's eager: Mesh.capturable; every rank's whole
          state equal bit for bit),
          the graphed step's ms a rank, images/s, state bytes and peak
          memory against one card's on the global batch; then the train
          CLI with trainer.devices=-1 for 2 epochs of 64 rows a rank (rank
          0's checkpoints at the steps one process reaches).
The sampling and training paths run their denoiser and train steps as CUDA
graphs (the counters add a graph's launches at every replay), and the CLI
runs resolve steps_per_execution=auto, whose probe trains 1 + AUTO_TIMED
steps on the state it then restores: the train, latent and tar phases
count those launches too.
The fused-block parity rows run with the other parity rows: the kernel
against block_fwd_plain at the three flagship levels (batch 256 bf16 and
batch 32 f32) and at two shapes the group kernel refused (2x64x64x16->128 and
1x128x128x8->64, the two-pass routes, bf16 and f32), with the kernel's, the
plain version's and the UNet Block's times and the bound, each row naming
its route; and tests/test_fused_block.py's four cases.
The nearest_codebook parity rows (f32, M x K x D = 8192 x 512 x 64, 4096 x
512 x 64, a ragged 1000 x 500 x 64, and past the resident kernel 8192 x 512
x 256 and 4096 x 512 x 512) run with the other parity rows: the
indices are equal except at near-ties (counted), with the kernel's time,
the plain version's, the bound and torch.cdist(z, e).argmin(1) as the
yardstick.

The kernels line carries, for the redesigned kernels (GroupNorm+Mish
forward and backward, the linear-attention forward and backward, rows 6-8,
nearest_codebook, the fused block), their design and ptxas's registers and
spills; the fused block also every timed row with its route;
GroupNorm+Mish also its totals at batch 64 (``sampling_batch``: the
flagship's 25 calls, the latent UNet's 17), its backward and the linear
attention their latent UNet totals at batch 128, nearest_codebook its time
at each shape.

Each phase's seconds follow it on a line of their own ({"phase": "seconds",
...}) and are kept in the summary line (``phase_seconds``).

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
# shapes the group kernel's block refused, now on the two-pass routes (timed, in both
# dtypes): a 64x64 level at Cout 128 (experiment=ddpm/celeba's first level
# width; cg 16 needed 2,048 threads) and a 128x128 level with Cin 8
FUSED_WIDE_SHAPES = [(2, 64, 64, 16, 128), (1, 128, 128, 8, 64)]
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
    flagship shapes at batch 256 in bf16 and at batch FUSED_F32_BATCH in f32,
    and FUSED_WIDE_SHAPES in both (timed: the kernel, the plain version, the
    UNet's cuDNN-conv Block and the bound), then tests/test_fused_block.py's
    four cases.  Each row names its route (ops.fused_block._route)."""
    import numpy as np
    import torch
    from igm_tpu_torch.ops.fused_block import _route, block_fwd_plain, fused_block_fwd
    from igm_tpu_torch.tools.bench_fused_block import SHAPES, unet_block
    rows = []
    cases = ([(BATCH, *s, "bfloat16") for s in SHAPES]
             + [(FUSED_F32_BATCH, *s, "float32") for s in SHAPES]
             + [(*s, d) for d in ("bfloat16", "float32") for s in FUSED_WIDE_SHAPES])
    for n, h, w, ci, co, dname in cases + FUSED_TEST_CASES:
        dtype = getattr(torch, dname)
        timed = (n, h, w, ci, co, dname) in cases
        if timed:
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
                   route=_route(n, h, w, ci, co, 8, dtype), max_abs_err=err.max().item(),
                   atol=atol, rtol=rtol, flagship=(h, w, ci, co) in SHAPES)
        if timed:
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
    # the DiT's paths (forwards, train steps, the CLIs, DDIM, DPM, Heun, the
    # ODE) launch no hand kernel: phase dit holds them to exactly 0
    "dit": (),
    # EDM's and flow matching's train steps and samplers on the UNet
    "edm_flow_unet": ("group_norm_mish", "linear_attention", "group_norm_mish_bwd",
                      "linear_attention_bwd"),
    # score-SDE, consistency and distillation: train steps, CLIs, samplers
    "families": ("group_norm_mish", "linear_attention", "group_norm_mish_bwd",
                 "linear_attention_bwd"),
    # MADE, PixelCNN and RealNVP launch no hand kernel: phase likelihood
    # holds them to exactly 0
    "likelihood": (),
    # VAE, beta-VAE, cVAE and FactorVAE launch no hand kernel: phase vae
    # holds them to exactly 0
    "vae": (),
    # the adversarial zoo launches no hand kernel: phase gan holds it to 0
    "gan": (),
    # the flagship's DPM-20 artifact served over HTTP
    "serve": ("group_norm_mish", "linear_attention"),
    # score_conditional's guided ancestral chain on ddpm/cond_mnist
    "scores": ("group_norm_mish", "linear_attention"),
    # the data axis: the NCCL rank's flagship steps and sample_sharded, and
    # the two gloo ranks' flagship, TAR (dropout) and EMA VQ-VAE steps
    "parallel": ("group_norm_mish", "linear_attention", "group_norm_mish_bwd",
                 "linear_attention_bwd", "nearest_codebook", "dropout_attention_fwd",
                 "dropout_attention_dq", "dropout_attention_dkv"),
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


# ---------------------------------------------------------------- dit
# the four DiT configs' full width (configs/experiment/ddpm/cifar10_dit.yaml):
# 384 wide, 8 deep, 6 heads of 64, patch 2 (256 tokens at 32x32x3)
DIT_WIDTH = dict(dim=384, depth=8, heads=6, patch=2, channels=3)
DIT_MOE = dict(moe_experts=8, moe_every=2, moe_dispatch="scatter")
DIT_MOE_OVERRIDES = [f"+model.{k}={v}" for k, v in DIT_MOE.items()]
DIT_EXPERIMENTS = ("ddpm/cifar10_dit", "ddpm/cifar10_dit_v", "edm/cifar10_dit",
                   "flow/cifar10_dit")
DIT_REF_BATCH = 8                    # card against CPU: forwards
DIT_STEP_BATCH = 2                   # card against CPU: train steps
# the DiT experiment whose CLI fit is resumed (the others' resumes drive the
# same trainer path, which phases train, latent, tar and families resume too)
DIT_CLI_RESUME = "flow/cifar10_dit"
# the CLIs' depth: they drive the trainer, checkpoints, resume and the
# sampling CLI; the full-depth DiT step runs in dit_train_timed, chain and
# parallel_cards (a depth cut that keeps the whole script under 600 s)
DIT_CLI = ["model.depth=2"]
# float32 with TF32 off on both sides: the same GEMMs and softmaxes summed in
# another order over 8 blocks (a few ulps a layer); held to 1e-4 of the
# output's largest value, the loss to 1e-4 of itself, and the gradients to
# 1e-3 of the largest gradient entry plus 1% of each, as train_unet holds them
DIT_FWD_RTOL = 1e-4
# the bf16 DiT on the card against the f32 forward on the CPU: the residual
# stream, every GEMM input and the probabilities round to bf16 (2^-8 of a
# value); held to 2% of the output's largest value, as
# tests/test_torch_cuda.py::test_dit_bf16_forward_near_f32 holds it
DIT_BF16_RTOL = 2e-2
DIT_TIMED_STEPS = 10
DIT_PROFILED_STEPS = 5
DIT_SAMPLE_BATCH = 64
# the train step's FLOPs at batch 256 (README's count for igm_tpu's Flax
# tree, forward and backward): the bound at the bf16 tensor-core rate
DIT_STEP_FLOPS = 6.274e12


def _release() -> None:
    """Free the device memory of models no longer referenced: their CUDA
    graphs' pools sit in reference cycles (a graph's callable holds its
    model), which only the cycle collector breaks."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _seeded_dit(gen, **kw):
    """A full-width DiT on the CPU, its Flax-default init drawn from ``gen``
    and every parameter moved by 0.05 N(0, 1) (adaLN-Zero would output 0)."""
    import torch
    from igm_tpu_torch.networks.dit import DiT
    net = DiT(**DIT_WIDTH, **kw).eval()
    for m in net.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(gen)
    with torch.no_grad():
        for p in net.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return net


def dit_reference() -> dict:
    """Full-width DiT forwards (batch 8, f32, TF32 off) on the card against
    the same weights on the CPU: the xla, flash and scan arms of a dense
    DiT against one CPU forward, and an MoE DiT; no hand-kernel launch."""
    import torch
    from igm_tpu_torch.networks.dit import DiT
    gen = torch.Generator().manual_seed(21)
    x = torch.randn(DIT_REF_BATCH, 32, 32, 3, generator=gen)
    t = torch.rand(DIT_REF_BATCH, generator=gen) * 999
    out = {}
    for name, kw, arms in (("dense", {}, ("xla", "flash", "scan")),
                           ("moe", DIT_MOE, ("xla",))):
        net = _seeded_dit(gen, **kw)
        with torch.no_grad():
            want = net(x, t)
        scale = want.abs().max().item()
        for arm in arms + (("xla_bf16", "flash_bf16") if name == "dense" else ()):
            arm, bf16 = arm.removesuffix("_bf16"), arm.endswith("_bf16")
            card = DiT(**DIT_WIDTH, **kw, **(dict(block_mode="scan") if arm == "scan"
                                            else dict(attn=arm)),
                       dtype=torch.bfloat16 if bf16 else None).eval()
            card.load_state_dict(net.state_dict())
            card.to("cuda")
            before = counts()
            with torch.no_grad():
                got = card(x.cuda(), t.cuda())
            torch.cuda.synchronize()
            launched = since(before)
            err = (got.cpu() - want).abs().max().item()
            rtol = DIT_BF16_RTOL if bf16 else DIT_FWD_RTOL
            dtype = "bfloat16" if bf16 else "float32"
            check(launched == expected(), f"dit {name} {arm}: launched {launched}")
            check(math.isfinite(err) and err <= rtol * scale,
                  f"dit {name} {arm} {dtype} forward: card vs CPU max err {err} beyond "
                  f"{rtol} x {scale}")
            out[f"{name}_{arm}_{dtype}"] = row = dict(batch=DIT_REF_BATCH, dtype=dtype,
                                                      max_abs_err=err, output_abs_max=scale,
                                                      rtol_of_max=rtol)
            emit("dit", run="reference", net=name, arm=arm, **row)
            del card
    _release()
    return out


def dit_train_reference() -> dict:
    """One f32 train step's loss and gradients (the DDPM-DiT, EDM and flow
    losses on the full-width DiT, batch 2, TF32 off) on the card against the
    same weights and draws on the CPU; no hand-kernel launch."""
    import torch
    from igm_tpu_torch.config import compose, instantiate
    gen = torch.Generator().manual_seed(23)
    out = {}
    for experiment in ("ddpm/cifar10_dit", "edm/cifar10_dit", "flow/cifar10_dit"):
        cfg = compose(REPO / "configs", [f"experiment={experiment}", "print_config=False"])
        models = [instantiate(cfg.model, datamodule=cfg.datamodule, device=d,
                              compute_dtype="float32") for d in ("cuda", "cpu")]
        name = models[0].weights_module
        weights = {k: v + 0.05 * torch.randn(v.shape, generator=gen)
                   for k, v in models[1].modules.state_dict().items()}
        imgs = torch.randint(0, 256, (DIT_STEP_BATCH, 32, 32, 3), generator=gen,
                             dtype=torch.uint8)
        noise = torch.randn(DIT_STEP_BATCH, 32, 32, 3, generator=gen)
        if experiment.startswith("ddpm"):
            level = torch.randint(0, models[0].timesteps, (DIT_STEP_BATCH,), generator=gen)
        elif experiment.startswith("edm"):
            level = torch.exp(-1.2 + 1.2 * torch.randn(DIT_STEP_BATCH, generator=gen))
        else:
            level = torch.rand(DIT_STEP_BATCH, generator=gen)
        res = []
        for model in models:
            dev = model.device
            model.modules.load_state_dict(weights)
            before = counts()
            loss, _ = model.loss(model.preprocess(imgs), level.to(dev), noise.to(dev))
            grads = torch.autograd.grad(loss, list(model.modules[name].parameters()))
            if dev.type == "cuda":
                torch.cuda.synchronize()
                launched = since(before)
            res.append((loss.item(), [g.cpu() for g in grads]))
        (l_card, g_card), (l_cpu, g_cpu) = res
        scale = max(g.abs().max().item() for g in g_cpu)
        err = max(((a - b).abs() - 1e-2 * b.abs()).max().item() for a, b in zip(g_card, g_cpu))
        rel = max(((a - b).abs().max() / scale).item() for a, b in zip(g_card, g_cpu))
        check(launched == expected(), f"dit train {experiment}: launched {launched}")
        check(math.isfinite(l_card) and abs(l_card - l_cpu) <= 1e-4 * abs(l_cpu),
              f"dit train {experiment}: loss card {l_card} vs CPU {l_cpu}")
        check(err <= 1e-3 * scale, f"dit train {experiment}: gradient error {err} "
                                   f"beyond 1e-3 x {scale}")
        out[experiment] = row = dict(batch=DIT_STEP_BATCH, dtype="float32", loss_card=l_card,
                                     loss_cpu=l_cpu, grad_max_abs_err_over_max_grad=rel,
                                     max_grad=scale, parameters=len(g_cpu))
        emit("dit", run="train_reference", experiment=experiment, **row)
        del models
    _release()
    return out


def dit_unet_launches() -> tuple:
    """EDM's and flow's train step on the flagship-width UNet (experiment=
    edm/cifar10, flow/cifar10, bf16, batch 8): exactly 25 + 25
    GroupNorm+Mish and 6 + 6 linear-attention launches each."""
    import torch
    total = expected()
    for experiment in ("edm/cifar10", "flow/cifar10"):
        model, _ = _chain_model(experiment, [f"experiment={experiment}"])
        state = model.init_state(0)
        imgs, labels = _chain_batches(model, 8, 1, 13)
        before = counts()
        state, metrics = model.train_step(state, (imgs[0], labels[0]))
        torch.cuda.synchronize()
        launched = since(before)
        check(launched == expected(group_norm_mish=25, linear_attention=6,
                                   group_norm_mish_bwd=25, linear_attention_bwd=6),
              f"{experiment} train step launched {launched}")
        check(math.isfinite(float(metrics["train_loss/loss"])), f"{experiment}: loss")
        total = tuple(a + b for a, b in zip(total, launched))
        emit("dit", run="unet_train_step", experiment=experiment,
             loss=float(metrics["train_loss/loss"]), launches=dict(zip(KERNELS, launched)))
        del model, state
    _release()
    return total


def dit_cli() -> tuple:
    """The train CLI on the four DiT experiments at depth 2 (DIT_CLI; an
    epoch of 3 steps with validation samples; DIT_CLI_RESUME 2, then
    resumed for one more), then the
    sampling CLI from their checkpoints: --sampler ddim, dpm, heun, and flow
    matching's default ODE.  Returns the launches (all 0)."""
    from PIL import Image
    from igm_tpu_torch.cli import sample_main
    before = counts()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for experiment in DIT_EXPERIMENTS:
            run = tmp / "logs" / "runs" / experiment
            extra = ["model.val_sampler=ddim"] if experiment == "ddpm/cifar10_dit" else []
            stages = [("fit", ["trainer.max_epochs=1"], ["step_3.pt"])]
            if experiment == DIT_CLI_RESUME:
                stages = [("fit", ["trainer.max_epochs=2"], ["step_3.pt", "step_6.pt"]),
                          ("resume", ["trainer.max_epochs=3",
                                      f"trainer.resume={run / 'checkpoints'}"],
                           ["step_6.pt", "step_9.pt"])]
            for name, overrides, ckpts in stages:
                t0 = time.perf_counter()
                loss = _train_cli(tmp, *DIT_CLI, *extra, *overrides, experiment=experiment)
                got = sorted(p.name for p in (run / "checkpoints").iterdir())
                check(loss is not None and math.isfinite(loss),
                      f"{experiment} {name}: loss {loss}")
                check(got == ckpts, f"{experiment} {name}: checkpoints {got}")
                grids = sorted(p.name for p in (run / "results").iterdir())
                check(grids[:len(ckpts)] == [f"{i}.jpg" for i in range(len(ckpts))],
                      f"{experiment}: grids {grids}")
                out[f"{experiment} {name}"] = row = dict(seconds=time.perf_counter() - t0,
                                                         loss=loss, checkpoints=got)
                emit("dit", run="cli_train", experiment=experiment, stage=name, **row)
        for experiment, sampler in (("ddpm/cifar10_dit", "ddim"), ("ddpm/cifar10_dit_v", "dpm"),
                                    ("edm/cifar10_dit", "heun"), ("flow/cifar10_dit", None)):
            png = tmp / f"{experiment.replace('/', '_')}.png"
            t0 = time.perf_counter()
            imgs = sample_main([f"experiment={experiment}", *DIT_CLI, "--ckpt",
                                str(tmp / "logs" / "runs" / experiment / "checkpoints"),
                                "--n", "16", "--out", str(png),
                                *(["--sampler", sampler] if sampler else [])])
            with Image.open(png) as img:
                size = img.size
            check(tuple(imgs.shape) == (16, 32, 32, 3) and bool(imgs.isfinite().all()),
                  f"{experiment} --sampler {sampler}: {tuple(imgs.shape)}")
            check(size == (2 + 8 * 34, 2 + 2 * 34), f"{experiment} grid {size}")
            emit("dit", run="cli_sample", experiment=experiment, sampler=sampler or "ode",
                 seconds=time.perf_counter() - t0, grid=list(size))
    _release()
    launched = since(before)
    check(launched == expected(), f"dit CLIs launched {launched}")
    return launched


def _abba(run, warm: int = 1) -> dict:
    """``run(graphed)`` timed eager, graphed, graphed, eager (host clock,
    fenced): seconds of each turn by mode."""
    import torch
    for mode in (True, False):
        for _ in range(warm):
            run(mode)
    sec = {"eager": [], "graphed": []}
    for mode in ("eager", "graphed", "graphed", "eager"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(mode == "graphed")
        torch.cuda.synchronize()
        sec[mode].append(time.perf_counter() - t0)
    return sec


def top_kernels(prof, steps: int, n: int = 12) -> list:
    """The ``n`` kernels with the most device time per step: [name (cut to
    90 characters), ms, launches]."""
    import torch
    from collections import defaultdict
    us, count = defaultdict(float), defaultdict(int)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(
                e, "is_user_annotation", False):
            us[e.name] += e.time_range.elapsed_us()
            count[e.name] += 1
    top = sorted(us, key=us.get, reverse=True)[:n]
    return [[k[:90], us[k] / 1e3 / steps, count[k] / steps] for k in top]


def dit_train_timed(name: str, overrides: list[str]) -> dict:
    """The DiT train step at batch 256, bf16: graphed against eager a-b-b-a
    (ms, images/s), the peak memory of each, and a profile of each mode:
    device busy ms, idle share, device ms by group."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from igm_tpu_torch.tools.profiling import DIT_GROUPS, device_summary
    model, _ = _chain_model(name, overrides)
    check(model.compute_dtype == torch.bfloat16, f"{name}: not bf16")
    state = model.init_state(0)
    chunk = _chain_batches(model, TRAIN_BATCH, 1, 17)
    metrics = {}

    def steps(graphed: bool, n: int = DIT_TIMED_STEPS):
        nonlocal state, metrics
        for _ in range(n):
            state, metrics = model.train_step_n(state, chunk, graph=graphed)

    before = counts()
    sec = _abba(steps)
    ms = {m: [1e3 * s / DIT_TIMED_STEPS for s in v] for m, v in sec.items()}
    peak = {}
    for mode in ("eager", "graphed"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        steps(mode == "graphed", 2)
        torch.cuda.synchronize()
        peak[mode] = torch.cuda.max_memory_allocated() / 2 ** 30
    prof_rows = {}
    for mode in ("eager", "graphed"):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            steps(mode == "graphed", DIT_PROFILED_STEPS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        prof_rows[mode] = device_summary(prof, DIT_PROFILED_STEPS,
                                         1e-3 * min(ms[mode]) * DIT_PROFILED_STEPS, wall,
                                         DIT_GROUPS)
        prof_rows[mode]["top_kernels_ms_per_step"] = top_kernels(prof, DIT_PROFILED_STEPS)
    launched = since(before)
    loss = float(metrics["train_loss/loss"])
    check(launched == expected() and math.isfinite(loss),
          f"{name} timed: launches {launched}, loss {loss}")
    row = dict(batch=TRAIN_BATCH, dtype="bfloat16", ms_per_step=ms,
               images_per_s={m: [TRAIN_BATCH * 1e3 / t for t in v] for m, v in ms.items()},
               bound_ms=1e3 * DIT_STEP_FLOPS / PEAK_OPS["bfloat16"], peak_memory_gib=peak,
               profile=prof_rows, loss=loss,
               metrics={k: float(v) for k, v in metrics.items()})
    emit("dit", run="train_timed", model=name, **row)
    del model, state
    _release()
    return row


def dit_attention_core() -> dict:
    """One block's attention core, forward and backward, at the train step's
    shapes (B 256, 256 tokens, 6 heads of 64, bf16, q/k/v slices of the
    head-grouped qkv): the xla arm (the product-softmax-product) and SDPA,
    CUDA-event timed; x8 is the step's."""
    import torch
    from igm_tpu_torch.networks.dit import attention_core
    from igm_tpu_torch.ops.causal_attention import flash_full_attention
    gen = torch.Generator("cuda").manual_seed(19)
    b, n, h, hd = TRAIN_BATCH, 256, 6, 64
    qkv = torch.randn(b, n, h, 3 * hd, generator=gen, device="cuda",
                      dtype=torch.bfloat16).requires_grad_(True)
    g = torch.randn(b, n, h, hd, generator=gen, device="cuda", dtype=torch.bfloat16)
    out = {}
    for arm, core in (("xla", attention_core),
                      ("flash", lambda q, k, v: flash_full_attention(q, k, v, hd ** -0.5))):
        def run():
            o = core(qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:])
            torch.autograd.grad(o, qkv, g.to(o.dtype))
        out[arm] = time_ms(run, [()], iters=10)
    flops = 3 * 4 * b * h * n * n * hd             # two products, forward and backward
    row = dict(shape=[b, n, h, hd], dtype="bfloat16", ms_per_block=out,
               ms_per_step={k: 8 * v for k, v in out.items()},
               bound_ms_per_block=1e3 * flops / PEAK_OPS["bfloat16"])
    emit("dit", run="attention_core", **row)
    return row


def dit_samplers() -> tuple[dict, tuple, tuple]:
    """DDIM-50 and DPM-20 on the DiT, EDM Heun-18 and flow Heun-50 on the DiT
    and on the flagship-width UNet, batch 64, bf16: images/s graphed against
    eager a-b-b-a, and the launches of the graphed runs (0 on the DiT; 25
    and 6 a UNet forward)."""
    import torch
    out, dit_l, unet_l = {}, expected(), expected()
    cases = (("dit", "ddim", "ddpm/cifar10_dit"), ("dit", "dpm", "ddpm/cifar10_dit"),
             ("dit", "edm_heun", "edm/cifar10_dit"), ("unet", "edm_heun", "edm/cifar10"),
             ("dit", "flow_heun", "flow/cifar10_dit"), ("unet", "flow_heun", "flow/cifar10"))
    models = {}
    n = DIT_SAMPLE_BATCH
    for backbone, sampler, experiment in cases:
        if experiment not in models:
            models[experiment], _ = _chain_model(experiment, [f"experiment={experiment}"])
            models[experiment].init_state(0)
        model = models[experiment]
        x_T = torch.randn(n, 32, 32, 3, generator=torch.Generator("cuda").manual_seed(4),
                          device="cuda")
        if sampler == "ddim":
            run, forwards = (lambda: model.ddim_sample(n, steps=50, x_T=x_T)), 50
        elif sampler == "dpm":
            run = lambda: model.dpm_sample(n, steps=20, x_T=x_T)     # noqa: E731
            forwards = len(model._dpm_timesteps(20, str(model.hparams.dpm_schedule)))
        elif sampler == "edm_heun":
            run, forwards = (lambda: model.heun_sample(n, noise=x_T)), 35
        else:
            run, forwards = (lambda: model.ode_sample(n, x0=x_T)), 100
        samples = {}

        def timed(graphed: bool):
            model.use_graphs = graphed
            samples[graphed] = run()

        model.use_graphs = True
        before = counts()
        run()                                              # capture
        torch.cuda.synchronize()
        sec = _abba(timed, warm=0)
        model.use_graphs = True
        before_g = counts()
        timed(True)
        torch.cuda.synchronize()
        per_run = since(before_g)
        launched = since(before)
        want = (expected() if backbone == "dit" else
                expected(group_norm_mish=25 * forwards, linear_attention=6 * forwards))
        check(per_run == want, f"{backbone} {sampler}: one graphed run launched {per_run}")
        x = samples[True]
        check(tuple(x.shape) == (n, 32, 32, 3) and bool(torch.isfinite(x).all()),
              f"{backbone} {sampler}: samples")
        if backbone == "dit":
            dit_l = tuple(a + b for a, b in zip(dit_l, launched))
        else:
            unet_l = tuple(a + b for a, b in zip(unet_l, launched))
        key = f"{backbone}_{sampler}"
        out[key] = row = dict(batch=n, forwards=forwards, seconds=sec,
                              images_per_s={m: [n / s for s in v] for m, v in sec.items()},
                              launches_per_run=dict(zip(KERNELS, per_run)))
        emit("dit", run="sampler", backbone=backbone, sampler=sampler, **row)
    del models, model
    _release()
    return out, dit_l, unet_l


# the MoE routing readings at batch 4: dit_reference's draws (seed 21, the
# dense DiT's weights drawn first), then MOE_ROUTING_SEEDS other draws
MOE_ROUTING_SEEDS = range(1)


def dit_moe_routing() -> dict:
    """The Switch-MoE DiT's routing at batch 4, card against CPU
    (``igm_tpu_torch.tools.moe_routing``): the tokens whose expert or kept
    slot differs, each with its top-1 router-logit margin."""
    from igm_tpu_torch.tools.moe_routing import routing_gap
    rows = [routing_gap(4, 21, dense_first=True)]
    rows += [routing_gap(4, seed) for seed in MOE_ROUTING_SEEDS]
    for row in rows:
        emit("dit", run="moe_routing", **row)
        check(row["finite"], "dit moe routing: the card's forward is not finite")
    _release()
    return {"readings": rows, "tokens_differing": sum(r["tokens_differing"] for r in rows),
            "expert_flips": sum(r["expert_flips"] for r in rows)}


def phase_dit() -> dict:
    """The DiT, its MoE, EDM and flow matching; the caller zeroes the
    counters before it.  Returns the launches of the DiT runs (all 0) and
    of EDM's and flow's UNet runs apart."""
    t0 = time.perf_counter()
    out = {"moe_routing": dit_moe_routing(), "reference": dit_reference(),
           "train_reference": dit_train_reference()}
    dit_l = counts()
    unet_l = dit_unet_launches()
    dit_l = tuple(a + b for a, b in zip(dit_l, dit_cli()))
    out["attention_core"] = dit_attention_core()
    out["train"] = {
        "xla": dit_train_timed("ddpm/cifar10_dit", ["experiment=ddpm/cifar10_dit"]),
        "flash": dit_train_timed("ddpm/cifar10_dit", ["experiment=ddpm/cifar10_dit",
                                                      "+model.attention=flash"]),
        "moe": dit_train_timed("ddpm/cifar10_dit", ["experiment=ddpm/cifar10_dit",
                                                    *DIT_MOE_OVERRIDES])}
    samplers, s_dit, s_unet = dit_samplers()
    out["samplers"] = samplers
    out["launches"] = {"dit": tuple(a + b for a, b in zip(dit_l, s_dit)),
                       "edm_flow_unet": tuple(a + b for a, b in zip(unet_l, s_unet))}
    total = tuple(a + b for a, b in zip(*out["launches"].values()))
    check(total == counts(), f"dit phase: launches {counts()} are not its runs' {total}")
    check(out["launches"]["dit"] == expected(),
          f"the DiT path launched {out['launches']['dit']}")
    emit("dit", run="path", seconds=time.perf_counter() - t0,
         launches={k: dict(zip(KERNELS, v)) for k, v in out["launches"].items()})
    return out


# ---------------------------------------------------------------- families
# the score-SDE, consistency and distillation paths: (name, experiment, the
# UNet forwards of one train step; each step makes one backward)
FAMILIES = (("score_sde", "score_sde/cifar10", 1), ("consistency", "consistency/cifar10", 2),
            ("distill", "distill/mnist", 3))
FAMILY_REF_BATCH = 4                 # card against CPU, f32
FAMILY_TIMED_STEPS = 5               # per turn of the a-b-b-a timing
FAMILY_PROFILED_STEPS = 3
FAMILY_TRAIN_BATCH = {"score_sde": TRAIN_BATCH, "consistency": TRAIN_BATCH, "distill": 128}
FAMILY_SAMPLE_BATCH = 64
# the distillation teacher: experiment=ddpm/mnist with distill/mnist's denoiser
TEACHER_OVERRIDES = ("model.dim_mults=[1,2]", "model.timesteps=256",
                     "+model.parameterization=v", "model.val_sampler=ddim")
# the timed samplers: (name, overrides, method, keyword arguments, forwards a run)
FAMILY_SAMPLERS = (
    ("ve_pc64", ["experiment=score_sde/cifar10"], "pc_sample", {}, 127),
    ("ve_ode64", ["experiment=score_sde/cifar10"], "ode_sample", {}, 127),
    ("vp_pc64", ["experiment=score_sde/cifar10", "model.sde=vp"], "pc_sample", {}, 127),
    ("consistency_1", ["experiment=consistency/cifar10"], "multistep_sample", {"steps": 1}, 1),
    ("consistency_2", ["experiment=consistency/cifar10"], "multistep_sample", {"steps": 2}, 2),
    ("student_8", ["experiment=distill/mnist"], "student_sample", {}, 8),
)


def unet_launches(dim_mults, forwards: int, backwards: int = 0) -> tuple:
    """counts() of ``forwards`` and ``backwards`` passes of a UNet: 25
    GroupNorm+Mish and 6 linear attention each at dim_mults [1, 2, 4], 17 and
    4 at [1, 2]."""
    gn, la = {3: (25, 6), 2: (17, 4)}[len(dim_mults)]
    return expected(group_norm_mish=gn * forwards, linear_attention=la * forwards,
                    group_norm_mish_bwd=gn * backwards, linear_attention_bwd=la * backwards)


def add(*launches) -> tuple:
    return tuple(sum(v) for v in zip(*launches))


def _near(got, want, what: str) -> dict:
    """Card against CPU in f32: within 1e-3 of the output's largest
    magnitude (at least 1e-3), as the unet phase holds a forward."""
    scale = max(1.0, want.abs().max().item())
    err = (got.cpu() - want).abs().max().item()
    check(math.isfinite(err) and err <= 1e-3 * scale,
          f"{what}: card vs CPU max err {err} beyond 1e-3 x {scale}")
    return dict(max_abs_err=err, output_abs_max=want.abs().max().item(), atol=1e-3 * scale)


def family_reference(name: str, experiment: str, forwards: int, gen) -> tuple[dict, tuple]:
    """One family at full width in f32 (TF32 off), on the card against the
    same weights and draws on the CPU: the train-step loss and gradients,
    with the step's exact launches; then its samplers' short chains.  The
    distillation target, a constant of the step, is compared on its own
    (below t = T-1, where its first DDIM step divides by sqrt(a) = 1.9e-4:
    reported there), and the CPU's feeds both losses."""
    import torch
    from igm_tpu_torch.config import compose, instantiate
    from igm_tpu_torch.ops import diffusion as gd
    cfg = compose(REPO / "configs", [f"experiment={experiment}", "print_config=False"])
    models = [instantiate(cfg.model, datamodule=cfg.datamodule, device=d,
                          compute_dtype="float32") for d in ("cuda", "cpu")]
    states = [m.init_state(0) for m in models]
    cpu = models[1]
    n = FAMILY_REF_BATCH
    shape = (n, cpu.height, cpu.width, cpu.channels)
    weights = {k: v + 0.05 * torch.randn(v.shape, generator=gen)
               for k, v in cpu.modules["denoise"].state_dict().items()}
    imgs = torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8)
    noise = torch.randn(shape, generator=gen)
    teacher = {}
    if name == "score_sde":
        draw = torch.rand(n, generator=gen)
    elif name == "consistency":
        draw = torch.randint(0, int(cpu.hparams.n_grid) - 1, (n,), generator=gen)
    else:                          # one student time at t = T-1, three below
        draw = torch.tensor([1, 3, 5, int(cpu.hparams.student_steps)])
        teacher = {k: v + 0.05 * torch.randn(v.shape, generator=gen)
                   for k, v in cpu.modules["denoise"].named_parameters()}
    for model, state in zip(models, states):
        model.modules["denoise"].load_state_dict(weights)
        for slot, values in (("ema", weights), ("teacher", teacher)):
            for k, t in state.opt_states.get(slot, {}).items():
                t.copy_(values[k])
    out, launched = {}, expected()
    if name == "distill":
        targets = []
        for model, state in zip(models, states):
            dev = model.device
            i, grid = draw.to(dev), model._grid_t
            t = grid[2 * i]
            x_t = gd.q_sample(model.tables, model.preprocess(imgs), t, noise.to(dev))
            before = counts()
            targets.append(model._distill_target(state, x_t, t, grid[2 * i - 1],
                                                  grid[2 * i - 2]).cpu())
            if model is not cpu:
                launched = since(before)
        below = (cpu._grid_t[2 * draw] < cpu.timesteps - 1)
        out["target"] = _near(targets[0][below], targets[1][below], f"{name} target")
        out["target"]["max_abs_err_at_t_T_minus_1"] = (
            targets[0][~below] - targets[1][~below]).abs().max().item()
        for model in models:
            model._distill_target = lambda *args, dev=model.device: targets[1].to(dev)
    res = []
    for model, state in zip(models, states):
        dev = model.device
        x, d, z = model.preprocess(imgs), draw.to(dev), noise.to(dev)
        model.modules.train()
        before = counts()
        if name == "distill":
            loss, _ = model.distill_loss(state, x, d, z)
        else:                                   # t for score-SDE, i for consistency
            loss, _ = model.loss(x, d, z)
        grads = torch.autograd.grad(loss, list(model.modules["denoise"].parameters()))
        model.modules.eval()
        if model is not cpu:
            torch.cuda.synchronize()
            launched = add(launched, since(before))
        res.append((loss.item(), [g.cpu() for g in grads]))
    check(launched == unet_launches(cpu.hparams.dim_mults, forwards, 1),
          f"{name} train step: launched {dict(zip(KERNELS, launched))}")
    (l_card, g_card), (l_cpu, g_cpu) = res
    scale = max(g.abs().max().item() for g in g_cpu)
    err = max(((a - b).abs() - 1e-2 * b.abs()).max().item() for a, b in zip(g_card, g_cpu))
    check(math.isfinite(l_card) and abs(l_card - l_cpu) <= 1e-4 * abs(l_cpu),
          f"{name} train step: loss card {l_card} vs CPU {l_cpu}")
    check(err <= 1e-3 * scale, f"{name} train step: gradient error {err} beyond "
                               f"1e-3 x {scale}")
    out["train"] = dict(batch=n, dtype="float32", loss_card=l_card, loss_cpu=l_cpu,
                        grad_max_abs_err_over_max_grad=max(
                            ((a - b).abs().max() / scale).item()
                            for a, b in zip(g_card, g_cpu)),
                        max_grad=scale, launches=dict(zip(KERNELS, launched)))
    emit("families", run="reference", family=name, **out["train"],
         **({"target": out["target"]} if "target" in out else {}))

    # short chains from the same draws: (name, call, draws, forwards)
    chains = {"score_sde": (("ve_pc4", lambda m, zs: m.pc_sample(n, steps=4, noises=zs), 7, 7),
                            ("ve_ode4", lambda m, zs: m.ode_sample(n, steps=4, noises=zs), 1, 7)),
              "consistency": (("multistep2", lambda m, zs: m.multistep_sample(
                  n, steps=2, noises=zs), 2, 2),),
              "distill": ()}[name]
    for chain, run, n_draws, chain_forwards in chains:
        zs = [torch.randn(shape, generator=gen) for _ in range(n_draws)]
        before = counts()
        got = run(models[0], [z.cuda() for z in zs])
        torch.cuda.synchronize()
        chain_l = since(before)
        check(chain_l == unet_launches(cpu.hparams.dim_mults, chain_forwards),
              f"{name} {chain}: launched {dict(zip(KERNELS, chain_l))}")
        launched = add(launched, chain_l)
        out[chain] = row = dict(batch=n, forwards=chain_forwards,
                                **_near(got, run(cpu, zs), f"{name} {chain}"))
        emit("families", run="reference", family=name, chain=chain, **row)
    del models, states
    _release()
    return out, launched


def families_cli() -> tuple[dict, tuple]:
    """The train CLI (2 epochs of 3 steps with validation samples) on
    score_sde/cifar10, consistency/cifar10 and distill/mnist (then resumed
    for one more epoch: the frozen teacher rides the checkpoint), the last
    from the checkpoints of a ddpm/mnist teacher
    trained here (1 epoch); then the sampling CLI from their checkpoints:
    the default samplers, consistency's --sampler multistep and the
    student's --sampler ddim.  Backward launches are exact (the steps and
    steps_per_execution=auto's probe); forwards at least the steps'."""
    from PIL import Image
    from igm_tpu_torch.cli import sample_main
    from igm_tpu_torch.config import compose
    from igm_tpu_torch.core.trainer import AUTO_TIMED
    probe = 1 + AUTO_TIMED
    out, total = {}, expected()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        teacher = tmp / "logs" / "runs" / "ddpm" / "mnist" / "checkpoints"
        runs = [("ddpm/mnist", "teacher", list(TEACHER_OVERRIDES), ["trainer.max_epochs=1"],
                 3, 1, ["step_3.pt"])]
        for name, experiment, forwards in FAMILIES:
            ckpts = tmp / "logs" / "runs" / experiment / "checkpoints"
            extra = [f"model.teacher_ckpt={teacher}"] if name == "distill" else []
            runs.append((experiment, "fit", extra, ["trainer.max_epochs=2"], 6, forwards,
                         ["step_3.pt", "step_6.pt"]))
            if name == "distill":
                runs.append((experiment, "resume", extra, ["trainer.max_epochs=3",
                                                           f"trainer.resume={ckpts}"],
                             3, forwards, ["step_6.pt", "step_9.pt"]))
        for experiment, stage, extra, overrides, steps, forwards, want_ckpts in runs:
            run = tmp / "logs" / "runs" / experiment
            cfg = compose(REPO / "configs", [f"experiment={experiment}", *extra,
                                             "print_config=False"])
            per_step = unet_launches(cfg.model.dim_mults, forwards, 1)
            before = counts()
            t0 = time.perf_counter()
            loss = _train_cli(tmp, *extra, *overrides, experiment=experiment)
            sec = time.perf_counter() - t0
            launched = since(before)
            got = sorted(p.name for p in (run / "checkpoints").iterdir())
            check(loss is not None and math.isfinite(loss), f"{experiment} {stage}: loss {loss}")
            check(got == want_ckpts, f"{experiment} {stage}: checkpoints {got}")
            bwd = slice(2, 4)
            check(launched[bwd] == tuple(v * (steps + probe) for v in per_step[bwd])
                  and all(a >= b * (steps + probe) for a, b in zip(launched[:2], per_step[:2]))
                  and not any(launched[4:]),
                  f"{experiment} {stage}: launched {dict(zip(KERNELS, launched))} for "
                  f"{steps} steps and auto's {probe}")
            grids = sorted(p.name for p in (run / "results").iterdir())
            check(grids[:1] == ["0.jpg"], f"{experiment}: grids {grids}")
            total = add(total, launched)
            out[f"{experiment} {stage}"] = row = dict(
                seconds=sec, steps=steps, loss=loss, checkpoints=got,
                launches=dict(zip(KERNELS, launched)))
            emit("families", run="cli_train", experiment=experiment, stage=stage, **row)
        for experiment, sampler, forwards in (("score_sde/cifar10", None, 127),
                                              ("consistency/cifar10", "multistep", 2),
                                              ("consistency/cifar10", None, 2),
                                              ("distill/mnist", None, 8),
                                              ("distill/mnist", "ddim", 8)):
            png = tmp / f"{experiment.replace('/', '_')}_{sampler}.png"
            cfg = compose(REPO / "configs", [f"experiment={experiment}", "print_config=False"])
            dm = cfg.datamodule
            before = counts()
            t0 = time.perf_counter()
            imgs = sample_main([f"experiment={experiment}", "--ckpt",
                                str(tmp / "logs" / "runs" / experiment / "checkpoints"),
                                "--n", "16", "--out", str(png),
                                *(["--sampler", sampler] if sampler else [])])
            sec = time.perf_counter() - t0
            launched = since(before)
            with Image.open(png) as img:
                size = img.size
            shape = (16, int(dm.height), int(dm.width), int(dm.channels))
            check(tuple(imgs.shape) == shape and bool(imgs.isfinite().all())
                  and imgs.abs().max().item() <= 1.0,
                  f"{experiment} --sampler {sampler}: {tuple(imgs.shape)}")
            check(size == (2 + 8 * (int(dm.width) + 2), 2 + 2 * (int(dm.height) + 2)),
                  f"{experiment} grid {size}")
            check(launched == unet_launches(cfg.model.dim_mults, forwards),
                  f"{experiment} --sampler {sampler}: launched {dict(zip(KERNELS, launched))}")
            total = add(total, launched)
            out[f"{experiment} sample {sampler or 'default'}"] = row = dict(
                seconds=sec, forwards=forwards, grid=list(size))
            emit("families", run="cli_sample", experiment=experiment,
                 sampler=sampler or "default", **row)
    _release()
    return out, total


def family_train_timed(name: str, experiment: str, forwards: int) -> tuple[dict, tuple]:
    """The train step at batch 256 (distill 128), bf16: one eager step and
    the graphed step (its first call eager and captured, then a replay)
    from the same state, bit for bit (parameters, Adam state, EMA shadow,
    teacher, generator, step; the metrics), each with exactly one step's
    launches; then eager against graphed a-b-b-a (ms, images/s), the peak
    memory of each, and a profile of the graphed step (device busy ms, idle
    share)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from igm_tpu_torch.tools.profiling import device_summary
    batch = FAMILY_TRAIN_BATCH[name]
    model, _ = _chain_model(name, [f"experiment={experiment}"])
    check(model.compute_dtype == torch.bfloat16, f"{name}: not bf16")
    state = model.init_state(0)
    per_step = unet_launches(model.hparams.dim_mults, forwards, 1)
    imgs, labels = _chain_batches(model, batch, 1, 31)
    before = counts()
    state, _ = model.train_step(state, (imgs[0], labels[0]))     # the Adam state exists
    start = state.snapshot()
    _, eager = model.train_step(state, (imgs[0], labels[0]))
    want = state.snapshot()
    torch.cuda.synchronize()
    check(since(before) == add(per_step, per_step), f"{name}: eager steps' launches")
    for stage in ("warm_up", "replay"):
        state.load_state_dict(start)
        before_run = counts()
        _, metrics = model.train_step_n(state, (imgs, labels))
        torch.cuda.synchronize()
        diff = same_bits(state.snapshot(), want) + same_bits(metrics, eager)
        check(not diff, f"{name} {stage}: graphed differs from eager at {diff[:8]}")
        check(since(before_run) == per_step,
              f"{name} {stage}: launched {dict(zip(KERNELS, since(before_run)))}")

    def steps(graphed: bool, k: int = FAMILY_TIMED_STEPS):
        nonlocal state, metrics
        for _ in range(k):
            state, metrics = model.train_step_n(state, (imgs, labels), graph=graphed)

    sec = _abba(steps)
    ms = {m: [1e3 * s / FAMILY_TIMED_STEPS for s in v] for m, v in sec.items()}
    peak = {}
    for mode in ("eager", "graphed"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        steps(mode == "graphed", 1)
        torch.cuda.synchronize()
        peak[mode] = torch.cuda.max_memory_allocated() / 2 ** 30
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps(True, FAMILY_PROFILED_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    summary = device_summary(prof, FAMILY_PROFILED_STEPS,
                             1e-3 * min(ms["graphed"]) * FAMILY_PROFILED_STEPS, wall)
    launched = since(before)
    # eager and graphed pairs, a-b-b-a after one warm-up turn a mode, peaks, profile
    n_steps = 2 + 2 + 6 * FAMILY_TIMED_STEPS + 2 + FAMILY_PROFILED_STEPS
    check(launched == tuple(v * n_steps for v in per_step), f"{name} timed: launches "
                                                            f"{dict(zip(KERNELS, launched))}")
    loss = float(metrics["train_loss/loss"])
    check(math.isfinite(loss), f"{name} timed: loss {loss}")
    row = dict(batch=batch, dtype="bfloat16", bit_equal=True, ms_per_step=ms,
               images_per_s={m: [batch * 1e3 / t for t in v] for m, v in ms.items()},
               peak_memory_gib=peak, loss=loss, launches_per_step=dict(zip(KERNELS, per_step)),
               profile_graphed={k: summary[k] for k in (
                   "wall_ms_per_step", "device_busy_ms_per_step", "idle_share",
                   "kernels_per_step")})
    emit("families", run="train_timed", family=name, **row)
    del model, state
    _release()
    return row, launched


def families_samplers() -> tuple[dict, tuple]:
    """VE PC-64, VE ODE-64 and VP PC-64 (1 corrector) on score_sde/cifar10,
    consistency 1- and 2-step on consistency/cifar10 and the 8-step student
    of distill/mnist, batch 64, bf16: graphed against eager a-b-b-a from the
    same generator seed, the samples bit for bit, images/s, and exactly the
    forwards' launches a run."""
    import torch
    out, total, models = {}, expected(), {}
    n = FAMILY_SAMPLE_BATCH
    for name, overrides, method, kw, forwards in FAMILY_SAMPLERS:
        key = tuple(overrides)
        if key not in models:
            models[key], _ = _chain_model(name, overrides)
            models[key].init_state(0)
        model = models[key]
        fn = getattr(model, method)
        samples = {}

        def run(graphed: bool):
            model.use_graphs = graphed
            samples[graphed] = fn(n, generator=torch.Generator("cuda").manual_seed(4), **kw)

        before = counts()
        run(True)                                           # capture
        torch.cuda.synchronize()
        sec = _abba(run, warm=0)
        before_g = counts()
        run(True)
        torch.cuda.synchronize()
        per_run = since(before_g)
        model.use_graphs = True
        total = add(total, since(before))
        check(per_run == unet_launches(model.hparams.dim_mults, forwards),
              f"{name}: one graphed run launched {dict(zip(KERNELS, per_run))}")
        x = samples[True]
        diff = same_bits(x, samples[False])
        check(not diff and bool(torch.isfinite(x).all())
              and tuple(x.shape) == (n, model.height, model.width, model.channels),
              f"{name}: graphed samples differ from eager, or are not finite")
        out[name] = row = dict(batch=n, forwards=forwards, bit_equal=True, seconds=sec,
                               images_per_s={m: [n / s for s in v] for m, v in sec.items()})
        emit("families", run="sampler", sampler=name, **row)
    del models, model
    _release()
    return out, total


def phase_families() -> dict:
    """The score-SDE, consistency and distillation paths; the caller zeroes
    the counters before it."""
    import torch
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(29)
    out, parts = {"reference": {}, "train": {}}, []
    for name, experiment, forwards in FAMILIES:
        out["reference"][name], launched = family_reference(name, experiment, forwards, gen)
        parts.append(launched)
    out["cli"], launched = families_cli()
    parts.append(launched)
    for name, experiment, forwards in FAMILIES:
        out["train"][name], launched = family_train_timed(name, experiment, forwards)
        parts.append(launched)
    out["samplers"], launched = families_samplers()
    parts.append(launched)
    out["launches"] = add(*parts)
    check(out["launches"] == counts(),
          f"families phase: launches {counts()} are not its runs' {out['launches']}")
    emit("families", run="path", seconds=time.perf_counter() - t0,
         launches=dict(zip(KERNELS, out["launches"])))
    return out



# ---------------------------------------------------------------- likelihood
# the exact-likelihood models: (name, experiment)
LIKELIHOOD = (("made", "made/mnist"), ("pixelcnn_mnist", "pixelcnn/mnist"),
              ("pixelcnn_cifar10", "pixelcnn/cifar10"), ("realnvp_mnist", "realnvp/mnist"),
              ("realnvp_cifar10", "realnvp/cifar10"))
LIK_REF_BATCH = 4                    # card against CPU, f32
# the train CLI: one experiment of each model class (pixelcnn/mnist and
# realnvp/mnist run the same model code on the MNIST datamodule, which
# made/mnist drives); realnvp/cifar10 also resumed, then sampled
LIK_CLI = ("made/mnist", "pixelcnn/cifar10", "realnvp/cifar10")
LIK_BATCH = 128                      # the datamodules' batch
LIK_SR_STEPS = 20
LIK_TIMED_STEPS = 5                  # per turn of the a-b-b-a timing
LIK_PROFILED_STEPS = 3
LIK_SAMPLE_BATCH = 64
SR_ELEMENTS = 2 ** 20
SR_SEED = 1_234_567_891
# MADE in bf16 against f32, the same weights and batch: a bf16 operand moves
# a logit by ~5e-4 (1024 products, each operand rounded to 2**-9); the bpd,
# a mean of log-softmax values, moves less
MADE_BF16_BPD_TOL = 5e-3
MADE_OUT_ELEMENTS = 1024 * 784 * 256          # the output kernel, hidden x (D x 256)
# the update's least traffic with bf16 weights and moments: g, mu, nu and w
# read, mu, nu and w written, 2 bytes each; the step's weight traffic adds w
# read twice (forward, dgrad) and dW written: 20 bytes an element, ~4.1 GB
MADE_UPDATE_BYTES = 14 * MADE_OUT_ELEMENTS
MADE_STEP_WEIGHT_BYTES = 20 * MADE_OUT_ELEMENTS
# MADE's products a step at batch 128: 3 x 2 x B x 1024 x 200704 (the output
# layer's forward, dgrad and wgrad; the hidden layers add 2%)
MADE_STEP_FLOPS = 3 * 2 * LIK_BATCH * 1024 * 784 * 256
# MADE's eager step by group: the optimizer update is the kernels inside the
# device span of Optimizer.step; the rest by name
MADE_GROUPS = (("gemm", ("gemm", "nvjet", "xmma", "cutlass", "sm90_", "splitk", "gemv")),
               ("softmax", ("softmax",)),
               ("copy_cast", ("copy", "cast", "convert")),
               ("elementwise", ("elementwise", "vectorized", "reduce", "index", "gather",
                                "scatter", "fill")))


def _lik_model(experiment: str, device: str = "cuda", **kw):
    from igm_tpu_torch.config import compose, instantiate
    cfg = compose(REPO / "configs", [f"experiment={experiment}", "print_config=False"])
    model = instantiate(cfg.model, datamodule=cfg.datamodule, device=device, **kw)
    model.steps_per_epoch = (60_000 if "mnist" in experiment else 50_000) // LIK_BATCH
    return model


def _lik_loss(model, imgs, labels, u):
    """The model's bpd on a batch (RealNVP with the dequantisation noise u)."""
    kind = type(model).__name__
    if kind == "RealNVP":
        return model.bpd(imgs, u)
    return model.bpd(imgs, labels) if kind == "PixelCNN" else model.bpd(imgs)


def lik_reference(name: str, experiment: str, gen) -> dict:
    """At full width in f32 (TF32 off), batch 4: the loss and every gradient
    of the train step on the card against the same weights, batch and
    dequantisation noise on the CPU (RealNVP's weights moved by 0.02 N(0, 1):
    its Conv_2 starts at 0)."""
    import torch
    kw = {"compute_dtype": "float32", "weight_dtype": "float32"} if name == "made" else {}
    models = [_lik_model(experiment, d, **kw) for d in ("cuda", "cpu")]
    cpu = models[1]
    if name.startswith("realnvp"):
        with torch.no_grad():
            for p in cpu.modules.parameters():
                p.add_(0.02 * torch.randn(p.shape, generator=gen))
    models[0].modules.load_state_dict(cpu.modules.state_dict())
    shape = (LIK_REF_BATCH, cpu.height, cpu.width, cpu.channels)
    imgs = torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8)
    labels = torch.randint(0, 10, (LIK_REF_BATCH,), generator=gen, dtype=torch.int32)
    u = torch.rand(shape, generator=gen)
    res = []
    for model in models:
        dev = model.device
        params = list(model.modules.parameters())
        loss = _lik_loss(model, imgs.to(dev), labels.to(dev), u.to(dev))
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        res.append((loss.item(), [torch.zeros(p.shape) if g is None else g.cpu()
                                  for p, g in zip(params, grads)]))
    (l_card, g_card), (l_cpu, g_cpu) = res
    scale = max(g.abs().max().item() for g in g_cpu)
    err = max(((a - b).abs() - 1e-2 * b.abs()).max().item() for a, b in zip(g_card, g_cpu))
    check(math.isfinite(l_card) and abs(l_card - l_cpu) <= 1e-4 * abs(l_cpu),
          f"{name} train step: bpd card {l_card} vs CPU {l_cpu}")
    check(err <= 1e-3 * scale, f"{name} train step: gradient error {err} beyond 1e-3 x {scale}")
    row = dict(batch=LIK_REF_BATCH, dtype="float32", bpd_card=l_card, bpd_cpu=l_cpu,
               grad_max_abs_err_over_max_grad=max(((a - b).abs().max() / scale).item()
                                                  for a, b in zip(g_card, g_cpu)),
               max_grad=scale, parameters=len(g_cpu))
    emit("likelihood", run="reference", model=name, **row)
    del models
    _release()
    return row


def made_bf16(gen) -> dict:
    """MADE's bf16 path on the card (bf16 products, the output kernel and the
    Adam moments stored in bf16, stochastic rounding): its bpd against f32
    on the same weights and batch 128; 20 SR steps whose bpd falls; every
    masked entry of every kernel and moment exactly 0 after them; the SR
    rounding of 2**20 float32 values bit for bit as the CPU's."""
    import torch
    from igm_tpu_torch.core.optim import hash_noise_u16, stochastic_round_bf16
    f32 = _lik_model("made/mnist", compute_dtype="float32", weight_dtype="float32")
    model = _lik_model("made/mnist")
    check(model.compute_dtype == torch.bfloat16 and model.bf16_weights and model.sr_active(),
          "made/mnist on the card: not bf16 weights with SR")
    state = model.init_state(0)
    model.modules.load_state_dict(f32.modules.state_dict())
    imgs, labels = _chain_batches(model, LIK_BATCH, 1, 41)
    batch = (imgs[0], labels[0])
    with torch.no_grad():
        bpd32, bpd16 = f32.bpd(batch[0]).item(), model.bpd(batch[0]).item()
    del f32
    _release()
    check(abs(bpd16 - bpd32) <= MADE_BF16_BPD_TOL,
          f"MADE bf16 bpd {bpd16} vs f32 {bpd32} beyond {MADE_BF16_BPD_TOL}")
    traj = []
    for _ in range(LIK_SR_STEPS):
        state, metrics = model.train_step(state, batch)
        traj.append(metrics["train_bpd"])
    traj = [float(t) for t in traj]
    check(all(map(math.isfinite, traj)) and traj[-1] < traj[0], f"MADE SR steps: bpd {traj}")
    net, opt = model.net, state.opt_states["opt"]
    nonzero = {}
    for lname, weight, mask in ([(f"layers_{i}", layer.weight, layer.mask_t)
                                 for i, layer in enumerate(net.layers())]
                                + [("out_layer", net.out_layer.weight,
                                    net.out_layer.expanded_mask())]):
        masked = mask == 0
        for key, t in (("kernel", weight), ("mu", opt.state[weight]["exp_avg"]),
                       ("nu", opt.state[weight]["exp_avg_sq"])):
            nonzero[f"{lname}/{key}"] = int((t[masked] != 0).sum())
        check(opt.state[weight]["exp_avg"].dtype == torch.bfloat16,
              f"{lname}: moments not bf16")
    check(not any(nonzero.values()), f"MADE masked entries not 0 after SR steps: {nonzero}")
    x = (torch.randn(SR_ELEMENTS, generator=gen)
         * torch.exp2(torch.randint(-30, 30, (SR_ELEMENTS,), generator=gen).float()))
    card = stochastic_round_bf16(x.cuda(), torch.tensor(SR_SEED, device="cuda")).cpu()
    plain = stochastic_round_bf16(x, SR_SEED)
    noise_card = hash_noise_u16((SR_ELEMENTS,), torch.tensor(SR_SEED, device="cuda")).cpu()
    differ = int((card.view(torch.int16) != plain.view(torch.int16)).sum())
    check(differ == 0 and torch.equal(noise_card, hash_noise_u16((SR_ELEMENTS,), SR_SEED)),
          f"SR on the card: {differ} of {SR_ELEMENTS} roundings differ from the CPU's")
    rounded_up = float((card.float().abs() > x.abs()).float().mean())
    row = dict(batch=LIK_BATCH, bpd_f32=bpd32, bpd_bf16=bpd16, bpd_tol=MADE_BF16_BPD_TOL,
               sr_steps=LIK_SR_STEPS, bpd_trajectory=traj, masked_nonzero=nonzero,
               sr_elements=SR_ELEMENTS, sr_bits_differ=differ,
               sr_share_rounded_away_from_zero=rounded_up,
               weight_dtype=str(net.out_layer.weight.dtype))
    emit("likelihood", run="made_bf16", **row)
    del model, state
    _release()
    return row


def made_update_ms(model, state, batch) -> dict:
    """MADE's optimizer update alone (CastAdam.step with SR, the gradients of
    one backward set), timed with CUDA events over 5 calls, beside its bound;
    then the eager step profiled, the update read as the kernels inside the
    device span of Optimizer.step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from igm_tpu_torch.tools.profiling import group_of
    params = list(model.net.parameters())
    opt = state.opt_states["opt"]
    grads = torch.autograd.grad(model.bpd(batch[0]), params)
    seeds = torch.randint(0, 2 ** 31 - 1, (len(params),), device="cuda",
                          generator=torch.Generator("cuda").manual_seed(3))
    for p, g in zip(params, grads):
        p.grad = g
    opt.step(sr_seeds=seeds)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        opt.step(sr_seeds=seeds)
    end.record()
    torch.cuda.synchronize()
    for p in params:
        p.grad = None
    update_ms = start.elapsed_time(end) / 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(LIK_PROFILED_STEPS):
            state, _ = model.train_step(state, batch)
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = [(e.time_range.start, e.time_range.end) for e in events
             if getattr(e, "is_user_annotation", False) and "Optimizer.step" in e.name]
    by_group = {}
    for e in events:
        if getattr(e, "is_user_annotation", False):
            continue
        inside = any(a <= e.time_range.start and e.time_range.end <= b for a, b in spans)
        g = "optimizer_update" if inside else group_of(e.name, MADE_GROUPS)
        by_group[g] = by_group.get(g, 0.0) + e.time_range.elapsed_us() / 1e3 / LIK_PROFILED_STEPS
    return dict(update_ms=update_ms, update_bound_ms=1e3 * MADE_UPDATE_BYTES / HBM_BYTES_PER_S,
                update_bytes=MADE_UPDATE_BYTES,
                step_weight_bound_ms=1e3 * MADE_STEP_WEIGHT_BYTES / HBM_BYTES_PER_S,
                step_flops_bound_ms=1e3 * MADE_STEP_FLOPS / PEAK_OPS["bfloat16"],
                eager_device_ms_per_step_by_group=by_group,
                optimizer_spans_found=len(spans))


def lik_train_timed(name: str, experiment: str) -> dict:
    """The train step at batch 128 as the CLI runs it (MADE bf16 with SR,
    PixelCNN and RealNVP f32): one eager step and the graphed step (its first
    call eager and captured, then a replay) from the same state, bit for bit
    (parameters, Adam state, generator, step, metrics); eager against
    graphed a-b-b-a (ms, images/s) and the peak memory of each; the graphed
    step's device busy time and idle share (MADE: its update alone against
    the bound, and the eager step by group); then the sampler at batch 64:
    MADE's 784-step chain and PixelCNN's row sampler eager (two runs each),
    RealNVP's inverse pass graphed against eager a-b-b-a, bit for bit."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from igm_tpu_torch.tools.profiling import device_summary
    model = _lik_model(experiment)
    state = model.init_state(0)
    imgs, labels = _chain_batches(model, LIK_BATCH, 1, 43)
    state, _ = model.train_step(state, (imgs[0], labels[0]))      # the Adam state exists
    start = state.snapshot()
    _, eager = model.train_step(state, (imgs[0], labels[0]))
    want = state.snapshot()
    for stage in ("warm_up", "replay"):
        state.load_state_dict(start)
        _, metrics = model.train_step_n(state, (imgs, labels))
        torch.cuda.synchronize()
        diff = same_bits(state.snapshot(), want) + same_bits(metrics, eager)
        check(not diff, f"{name} {stage}: graphed differs from eager at {diff[:8]}")

    def steps(graphed: bool, k: int = LIK_TIMED_STEPS):
        nonlocal state, metrics
        for _ in range(k):
            state, metrics = model.train_step_n(state, (imgs, labels), graph=graphed)

    sec = _abba(steps)
    ms = {m: [1e3 * s / LIK_TIMED_STEPS for s in v] for m, v in sec.items()}
    peak = {}
    for mode in ("eager", "graphed"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        steps(mode == "graphed", 1)
        torch.cuda.synchronize()
        peak[mode] = torch.cuda.max_memory_allocated() / 2 ** 30
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps(True, LIK_PROFILED_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    summary = device_summary(prof, LIK_PROFILED_STEPS,
                             1e-3 * min(ms["graphed"]) * LIK_PROFILED_STEPS, wall)
    summary["top_kernels_ms_per_step"] = top_kernels(prof, LIK_PROFILED_STEPS, 6)
    bpd = float(metrics["train_bpd"])
    check(math.isfinite(bpd), f"{name} timed: bpd {bpd}")
    row = dict(batch=LIK_BATCH, dtype=str(getattr(model, "compute_dtype", torch.float32)),
               bit_equal=True, ms_per_step=ms,
               images_per_s={m: [LIK_BATCH * 1e3 / t for t in v] for m, v in ms.items()},
               peak_memory_gib=peak, bpd=bpd,
               profile_graphed={k: summary[k] for k in (
                   "wall_ms_per_step", "device_busy_ms_per_step", "idle_share",
                   "kernels_per_step", "device_ms_per_step_by_group",
                   "top_kernels_ms_per_step")})
    if name == "made":
        row["update"] = made_update_ms(model, state, (imgs[0], labels[0]))
    row["sample"] = lik_sampler(name, model)
    emit("likelihood", run="train_timed", model=name, **row)
    del model, state
    _release()
    return row


def lik_sampler(name: str, model) -> dict:
    """The sampler at batch 64 from a generator seed: seconds and images/s."""
    import torch
    n = LIK_SAMPLE_BATCH
    shape = (n, model.height, model.width, model.channels)
    samples = {}
    if name.startswith("realnvp"):
        def run(graphed: bool):
            model.use_graphs = graphed
            samples[graphed] = model.sample(n, torch.Generator("cuda").manual_seed(5))

        run(True)                                           # capture
        sec = _abba(run, warm=0)
        model.use_graphs = True
        diff = same_bits(samples[True], samples[False])
        check(not diff, f"{name}: graphed samples differ from eager")
        x = samples[True]
    else:
        method = model.sample_images
        sec = {"eager": []}
        # PixelCNN's row sampler (3.8-4.9 s a batch) once, MADE's twice
        for i in range(1 if name.startswith("pixelcnn") else 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x = method(n, torch.Generator("cuda").manual_seed(5 + i))
            torch.cuda.synchronize()
            sec["eager"].append(time.perf_counter() - t0)
    check(tuple(x.shape) == shape and bool(torch.isfinite(x).all())
          and x.abs().max().item() <= 1.0, f"{name} samples: {tuple(x.shape)}")
    return dict(batch=n, seconds=sec, images_per_s={m: [n / s for s in v] for m, v in sec.items()},
                bit_equal=name.startswith("realnvp") or None,
                steps={"made": 784, "pixelcnn_mnist": 28 * 28,
                       "pixelcnn_cifar10": 32 * 32}.get(name, 1))


def lik_cli() -> dict:
    """Through the port's CLI, each experiment of LIK_CLI: 3 steps (an epoch
    of one step each, validation with the sample grid after the last);
    realnvp/cifar10 then a resume for 1 more step without validation, and
    samples through igm_tpu_torch.cli from its checkpoints."""
    from PIL import Image
    from igm_tpu_torch.cli import sample_main
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for experiment in LIK_CLI:
            ckpts = tmp / "logs" / "runs" / experiment / "checkpoints"
            stages = [("fit", ["trainer.max_epochs=3", "trainer.check_val_every_n_epoch=3"],
                       ["step_2.pt", "step_3.pt"])]
            if experiment == "realnvp/cifar10":
                stages.append(("resume", ["trainer.max_epochs=4", "trainer.limit_val_batches=0",
                                          f"trainer.resume={ckpts}"],
                               ["step_3.pt", "step_4.pt"]))
            for stage, overrides, want in stages:
                t0 = time.perf_counter()
                bpd = _train_cli(tmp, "trainer.limit_train_batches=1", *overrides,
                                 experiment=experiment, metric="train_bpd")
                sec = time.perf_counter() - t0
                got = sorted(p.name for p in ckpts.iterdir())
                grids = sorted(p.name for p in (ckpts.parent / "results").iterdir())
                check(bpd is not None and math.isfinite(bpd), f"{experiment} {stage}: bpd {bpd}")
                check(got == want, f"{experiment} {stage}: checkpoints {got}")
                check(grids == ["2.jpg"], f"{experiment} {stage}: grids {grids}")
                out[f"{experiment} {stage}"] = row = dict(seconds=sec, train_bpd=bpd,
                                                          checkpoints=got)
                emit("likelihood", run="cli_train", experiment=experiment, stage=stage, **row)
        png = tmp / "realnvp.png"
        t0 = time.perf_counter()
        imgs = sample_main(["experiment=realnvp/cifar10", "--ckpt",
                            str(tmp / "logs" / "runs" / "realnvp" / "cifar10" / "checkpoints"),
                            "--n", "16", "--out", str(png)])
        sec = time.perf_counter() - t0
        with Image.open(png) as img:
            size = img.size
        check(tuple(imgs.shape) == (16, 32, 32, 3) and bool(imgs.isfinite().all())
              and imgs.abs().max().item() <= 1.0 and size == (2 + 8 * 34, 2 + 2 * 34),
              f"realnvp/cifar10 sampling CLI: {tuple(imgs.shape)}, grid {size}")
        out["realnvp/cifar10 sample"] = row = dict(seconds=sec, grid=list(size))
        emit("likelihood", run="cli_sample", experiment="realnvp/cifar10", **row)
    _release()
    return out


def phase_likelihood() -> dict:
    """MADE, PixelCNN and RealNVP; the caller zeroes the counters before it.
    No hand kernel is on these paths: every count must stay 0."""
    import torch
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(31)
    out = {"reference": {}, "train": {}}
    for name, experiment in LIKELIHOOD:
        out["reference"][name] = lik_reference(name, experiment, gen)
    out["made_bf16"] = made_bf16(gen)
    for name, experiment in LIKELIHOOD:
        out["train"][name] = lik_train_timed(name, experiment)
    out["cli"] = lik_cli()
    out["launches"] = counts()
    check(out["launches"] == expected(),
          f"likelihood phase launched {dict(zip(KERNELS, out['launches']))}")
    emit("likelihood", run="path", seconds=time.perf_counter() - t0,
         launches=dict(zip(KERNELS, out["launches"])))
    return out


# ---------------------------------------------------------------- vae
# the VAE slice: (name, experiment, the metric its CLI fit returns)
VAE_EXPERIMENTS = (("vae_celeba", "vae/celeba", "metrics/fid_random_torch"),
                   ("beta_vae_dsprites", "beta_vae/dsprites", "train_log/elbo"),
                   ("factor_vae_dsprites", "factor_vae/dsprites", "train_loss/d_adv_loss"),
                   ("cvae_mnist", "cvae/mnist", "train_log/elbo"),
                   ("vae_mnist_mlp", "vae/mnist_mlp", "train_log/elbo"))
VAE_REF_BATCH = 8                    # card against CPU, f32
VAE_BATCH = 128                      # the datamodules' batch
VAE_TIMED_STEPS = 10                 # per turn of the a-b-b-a timing
VAE_PROFILED_STEPS = 5
VAE_SAMPLE_BATCH = 64
VAE_LOSS_RTOL = 1e-5
# the card's float32 convolutions and GEMMs sum in another order than the
# CPU's: gradients within 1e-4 of the largest; the parameters after Adam's
# first step (lr * sign(g) where the sign is certain, see vae_reference)
# and the BatchNorm buffers within 1e-5
VAE_GRAD_TOL = 1e-4
VAE_STATE_TOL = 1e-5
VAE_FID_IMAGES = 16
VAE_FID_RTOL = 1e-4
INCEPTION_BATCH = 16
INCEPTION_RTOL = 1e-3


def _vae_model(experiment: str, device: str = "cuda"):
    from igm_tpu_torch.config import compose, instantiate
    cfg = compose(REPO / "configs", [f"experiment={experiment}", "print_config=False"])
    model = instantiate(cfg.model, datamodule=cfg.datamodule, device=device)
    model.steps_per_epoch = 1000
    return model


def _vae_batch(model, n: int, gen):
    """uint8 images (dSprites' {0, 1} for a Bernoulli decoder) and labels."""
    import torch
    shape = (n, model.height, model.width, model.channels)
    imgs = torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8)
    if model.hparams.get("decoder_dist") == "bernoulli":
        imgs = (imgs > 127).to(torch.uint8)
    return imgs, torch.randint(0, 10, (n,), generator=gen, dtype=torch.int32)


def _vae_draws(model, n: int, gen) -> dict:
    """The train step's draws, given: the noise (and FactorVAE's halves'
    noise and permutations)."""
    import torch
    latent = int(model.hparams.latent_dim)
    if type(model).__name__ == "FactorVAE":
        h = n // 2
        return {"eps1": torch.randn(h, latent, generator=gen),
                "eps2": torch.randn(h, latent, generator=gen),
                "perm": torch.argsort(torch.rand(h, latent, generator=gen), dim=0)}
    return {"eps": torch.randn(n, latent, generator=gen)}


def _vae_loss(model, imgs, labels, draws, dtype=None):
    """The loss the (first) optimizer differentiates and the modules it owns
    (``dtype``: the images and draws cast to it, for a float64 model)."""
    import torch
    x = model.preprocess(imgs).to(dtype or torch.float32)
    draws = {k: v.to(x.dtype) if v.is_floating_point() else v for k, v in draws.items()}
    kind = type(model).__name__
    if kind == "FactorVAE":
        return model.ae_loss(x[:x.shape[0] // 2], draws["eps1"])[0], ["encoder", "decoder"]
    if kind == "cVAE":
        return (model.loss(x, labels, draws["eps"])[0],
                ["encoder", "decoder", "class_embedding"])
    return model.loss(x, draws["eps"])[0], ["encoder", "decoder"]


def _d_grads(model, state) -> dict:
    """FactorVAE's critic gradients of the step, read back from the ``d``
    Adam's first moment (mu = (1 - b1) g after one step)."""
    opt = state.opt_states["d"]
    b1 = float(model.hparams.adv_b1)
    return {f"netD.{k}": (opt.state[p]["exp_avg"] / (1.0 - b1)).detach().cpu()
            for k, p in model.modules["netD"].named_parameters()}


def _after_ae(model, post_ae: dict, own: dict) -> None:
    """FactorVAE: right after the step's ``ae`` update, keep the encoder's
    and decoder's parameters in ``post_ae`` (the CPU's run, ``post_ae``
    empty), or write those into ``model`` and keep its own in ``own`` (the
    card's run), so that both D phases read the same encoder."""
    import torch
    grad_step = model.optimizers.grad_step

    def step(state, opt_name, loss_fn, **kw):
        out = grad_step(state, opt_name, loss_fn, **kw)
        if opt_name == "ae":
            with torch.no_grad():
                for k, p in model.modules.named_parameters():
                    if k.split(".")[0] not in ("encoder", "decoder"):
                        continue
                    if k in post_ae:
                        own[k] = p.detach().clone()
                        p.copy_(post_ae[k])
                    else:
                        post_ae[k] = p.detach().cpu().clone()
        return out

    model.optimizers.grad_step = step


def vae_reference(name: str, experiment: str, gen) -> dict:
    """At full width in f32 (TF32 off), batch 8, from the same weights,
    batch and injected draws on the card and on the CPU: the loss and every
    gradient of the (AE) loss, then one train step (both optimizers for
    FactorVAE): its metrics, the parameters and the BatchNorm buffers.

    Each gradient tensor on the card is held to the same one in float64
    (the CPU model in double) within 1e-4 of the largest gradient.  The
    parameters after Adam's first step move by lr * sign(g): held to the
    CPU's where the two signs are certain to agree, that is where the CPU's
    |g| is beyond the largest card-CPU gradient difference on that tensor;
    elsewhere within 2 lr, and counted (vae/celeba's encoder Conv_2, ahead
    of a BatchNorm over 8 images, loses 5e-4 of the largest gradient to
    float32 on the CPU).  FactorVAE's D phase on the card reads the CPU's
    encoder after the AE update (otherwise Adam's sign on a gradient that
    is 0 up to rounding moves the second half's latents), as the CPU test
    does; its metrics at 1e-5 relative, netD's gradients within 1e-4 of the
    largest."""
    import torch
    models = [_vae_model(experiment, d) for d in ("cuda", "cpu")]
    cpu = models[1]
    models[0].modules.load_state_dict(cpu.modules.state_dict())
    imgs, labels = _vae_batch(cpu, VAE_REF_BATCH, gen)
    draws = _vae_draws(cpu, VAE_REF_BATCH, gen)
    exact = copy.deepcopy(cpu)
    exact.modules.double()
    loss64, mods = _vae_loss(exact, imgs, labels, draws, torch.float64)
    exact_grads = dict(zip(
        [f"{m}.{k}" for m in mods for k, _ in exact.modules[m].named_parameters()],
        torch.autograd.grad(loss64, [p for m in mods for p in exact.modules[m].parameters()])))
    del exact
    res, post_ae, own = [], {}, {}
    for model in (cpu, models[0]):                 # the CPU's post-AE encoder first
        dev = model.device
        d = {k: v.to(dev) for k, v in draws.items()}
        state = model.init_state(0)
        loss, mods = _vae_loss(model, imgs.to(dev), labels.to(dev), d)
        names = [f"{m}.{k}" for m in mods for k, _ in model.modules[m].named_parameters()]
        grads = torch.autograd.grad(loss, [p for m in mods for p in model.modules[m].parameters()])
        factor = "d" in state.opt_states
        if factor:                                 # the CPU's run fills post_ae
            given = {k: v.to(dev) for k, v in post_ae.items()}
            _after_ae(model, given or post_ae, own)
        state, metrics = model.train_step(state, (imgs.to(dev), labels.to(dev)), **d)
        if factor:
            del model.optimizers.grad_step
            with torch.no_grad():                  # the card's own AE update
                for k, p in model.modules.named_parameters():
                    if k in own:
                        p.copy_(own[k])
        res.append(dict(loss=loss.item(), grads={k: g.cpu() for k, g in zip(names, grads)},
                        d_grads=_d_grads(model, state) if factor else {},
                        metrics={k: float(v) for k, v in metrics.items()},
                        after={k: v.detach().cpu() for k, v in model.modules.state_dict().items()}))
    ref, card = res
    check(not post_ae or len(own) == len(post_ae), f"{name}: the card's D phase read its own encoder")
    check(math.isfinite(card["loss"]) and abs(card["loss"] - ref["loss"])
          <= VAE_LOSS_RTOL * abs(ref["loss"]), f"{name}: loss card {card['loss']} vs CPU {ref['loss']}")
    errs = {}
    scale = max(g.abs().max().item() for g in exact_grads.values())
    worst, cpu_worst = (0.0, ""), (0.0, "")
    for k, g in exact_grads.items():
        err = (card["grads"][k].double() - g).abs().max().item()
        check(err <= VAE_GRAD_TOL * scale, f"{name}: {k} gradient {err} from float64 beyond "
                                           f"{VAE_GRAD_TOL} x the largest gradient {scale}")
        own_err = (ref["grads"][k].double() - g).abs().max().item()
        worst, cpu_worst = max(worst, (err / scale, k)), max(cpu_worst, (own_err / scale, k))
    errs["grads_vs_float64"] = {"max_abs_err_over_max_grad": worst[0], "at": worst[1],
                                "cpu_max_abs_err_over_max_grad": cpu_worst[0],
                                "cpu_at": cpu_worst[1]}
    if ref["d_grads"]:
        d_scale = max(g.abs().max().item() for g in ref["d_grads"].values())
        err = max((card["d_grads"][k] - g).abs().max().item() for k, g in ref["d_grads"].items())
        check(err <= VAE_GRAD_TOL * d_scale,
              f"{name}: D gradients {err} beyond {VAE_GRAD_TOL} x {d_scale}")
        errs["d_grads_vs_cpu"] = err / d_scale
    metric_err = {}
    for k, v in ref["metrics"].items():
        metric_err[k] = abs(card["metrics"][k] - v) / max(abs(v), 1e-6)
        check(metric_err[k] <= VAE_LOSS_RTOL, f"{name}: step metric {k} card {card['metrics'][k]} "
                                              f"vs CPU {v} beyond {VAE_LOSS_RTOL} relative")
    named = dict(cpu.modules.named_parameters())
    lr = {m: float(cpu.hparams.lrD if m == "netD" else cpu.hparams.lr) for m in cpu.modules}
    param_err, buffer_err, unsure, entries = 0.0, 0.0, {}, {}
    for k, want in ref["after"].items():
        diff = (card["after"][k] - want).abs()
        if k not in named:                                       # a BatchNorm buffer
            buffer_err = max(buffer_err, (diff.max() / max(want.abs().max(), 1e-30)).item())
            continue
        g = ref["grads"].get(k, ref["d_grads"].get(k))
        sure = g.abs() > ({**card["grads"], **card["d_grads"]}[k] - g).abs().max()
        if sure.any():
            param_err = max(param_err, diff[sure].max().item())
        module = k.split(".")[0]
        unsure[module] = unsure.get(module, 0) + int((~sure).sum())
        entries[module] = entries.get(module, 0) + want.numel()
        check(bool((diff[~sure] <= 2 * lr[module] * (1 + 1e-3)).all()),
              f"{name}: {k} moved by more than 2 lr where the gradient's sign is unsure")
    check(param_err <= VAE_STATE_TOL, f"{name}: parameters after the step differ by {param_err}")
    check(buffer_err <= VAE_STATE_TOL, f"{name}: BatchNorm buffers after the step differ "
                                       f"by {buffer_err} (relative)")
    row = dict(batch=VAE_REF_BATCH, dtype="float32", loss_card=card["loss"], loss_cpu=ref["loss"],
               loss_float64=loss64.item(), max_grad=scale,
               grad_errors=errs, metric_rel_err=metric_err,
               parameters_after_step_max_abs_err=param_err,
               buffers_after_step_max_rel_err=buffer_err,
               sign_unsure_entries={m: [n, entries[m]] for m, n in unsure.items()},
               buffers=sum(1 for k in ref["after"] if k not in named),
               parameter_count=sum(p.numel() for p in named.values()))
    emit("vae", run="reference", model=name, **row)
    del models
    _release()
    return row


def vae_train_timed(name: str, experiment: str) -> dict:
    """The train step at batch 128: one eager step and the graphed step
    (its first call eager and captured, then a replay) from the same state,
    bit for bit (parameters, buffers, both optimizers' states, generator,
    step, metrics); eager against graphed a-b-b-a (ms, images/s); the eager
    step with and without cuDNN's deterministic algorithms, in turns; the
    graphed step's device busy time, idle share and kernels per step; then
    sampling at batch 64, graphed against eager."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from igm_tpu_torch.tools.profiling import device_summary
    model = _vae_model(experiment)
    state = model.init_state(0)
    imgs, labels = _chain_batches(model, VAE_BATCH, 1, 47)
    if model.hparams.get("decoder_dist") == "bernoulli":
        imgs = (imgs > 127).to(torch.uint8)
    state, _ = model.train_step(state, (imgs[0], labels[0]))      # the Adam state exists
    start = state.snapshot()
    _, eager = model.train_step(state, (imgs[0], labels[0]))
    want = state.snapshot()
    for stage in ("warm_up", "replay"):
        state.load_state_dict(start)
        _, metrics = model.train_step_n(state, (imgs, labels))
        torch.cuda.synchronize()
        diff = same_bits(state.snapshot(), want) + same_bits(metrics, eager)
        check(not diff, f"{name} {stage}: graphed differs from eager at {diff[:8]}")

    def steps(graphed: bool, k: int = VAE_TIMED_STEPS):
        nonlocal state, metrics
        for _ in range(k):
            state, metrics = model.train_step_n(state, (imgs, labels), graph=graphed)

    sec = _abba(steps)
    ms = {m: [1e3 * s / VAE_TIMED_STEPS for s in v] for m, v in sec.items()}
    # what cuDNN's deterministic algorithms cost the step (eager: a graph
    # keeps the algorithms it was captured with), in turns with them on
    nondet = {"deterministic": [], "nondeterministic": []}
    for mode in ("deterministic", "nondeterministic", "nondeterministic", "deterministic"):
        torch.backends.cudnn.deterministic = mode == "deterministic"
        steps(False, 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps(False)
        torch.cuda.synchronize()
        nondet[mode].append(1e3 * (time.perf_counter() - t0) / VAE_TIMED_STEPS)
    torch.backends.cudnn.deterministic = True
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps(True, VAE_PROFILED_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    summary = device_summary(prof, VAE_PROFILED_STEPS,
                             1e-3 * min(ms["graphed"]) * VAE_PROFILED_STEPS, wall)
    summary["top_kernels_ms_per_step"] = top_kernels(prof, VAE_PROFILED_STEPS, 6)
    values = {k: float(v) for k, v in metrics.items()}
    check(all(map(math.isfinite, values.values())), f"{name} timed: metrics {values}")
    row = dict(batch=VAE_BATCH, dtype="float32", bit_equal=True, ms_per_step=ms,
               images_per_s={m: [VAE_BATCH * 1e3 / t for t in v] for m, v in ms.items()},
               eager_ms_per_step_by_cudnn_mode=nondet, metrics=values,
               profile_graphed={k: summary[k] for k in (
                   "wall_ms_per_step", "device_busy_ms_per_step", "idle_share",
                   "kernels_per_step", "device_ms_per_step_by_group",
                   "top_kernels_ms_per_step")})
    row["sample"] = vae_sampler(name, model)
    emit("vae", run="train_timed", model=name, **row)
    del model, state
    _release()
    return row


def vae_sampler(name: str, model) -> dict:
    """The decoder in eval mode from N(0, I) latents at batch 64 (cVAE: 7
    a class, 70), graphed against eager a-b-b-a, the same images bit for
    bit."""
    import torch
    cvae = type(model).__name__ == "cVAE"
    n = 7 if cvae else VAE_SAMPLE_BATCH
    samples = {}

    def run(graphed: bool):
        model.use_graphs = graphed
        samples[graphed] = model.sample(n, torch.Generator("cuda").manual_seed(5))

    run(True)                                           # capture
    sec = _abba(run, warm=0)
    model.use_graphs = True
    check(not same_bits(samples[True], samples[False]), f"{name}: graphed samples differ")
    x = samples[True]
    images = n * (model.n_classes if cvae else 1)
    check(tuple(x.shape) == (images, model.height, model.width, model.channels)
          and bool(torch.isfinite(x).all()), f"{name} samples: {tuple(x.shape)}")
    return dict(batch=images, seconds=sec, bit_equal=True,
                images_per_s={m: [images / s for s in v] for m, v in sec.items()})


def vae_fid_features() -> dict:
    """The FID path's pieces on the card against the CPU: 16 validation
    images of the CelebA datamodule (synthetic here) converted to uint8 as
    the callback converts them (equal), the random backend's features
    (within 1e-4 of the largest), and InceptionV3 with seeded random weights
    at batch 16 (within 1e-3), with its time."""
    import torch
    from igm_tpu_torch.callbacks.evaluation import to_uint8
    from igm_tpu_torch.callbacks.fid import RandomConvFeatures
    from igm_tpu_torch.config import compose, instantiate
    from igm_tpu_torch.networks.inception import InceptionV3
    with tempfile.TemporaryDirectory() as tmp:
        cfg = compose(REPO / "configs", ["experiment=vae/celeba", "print_config=False",
                                         f"datamodule.data_dir={tmp}"])
        dm = instantiate(cfg.datamodule)
        dm.setup()
        imgs = dm.val_arrays()[0][:VAE_FID_IMAGES]
    x = torch.from_numpy(imgs).float() / 127.5 - 1.0                 # model space
    u8 = {d: to_uint8(x.numpy(), True, d).cpu() for d in ("cuda", "cpu")}
    check(torch.equal(u8["cuda"], u8["cpu"]), "FID uint8 conversion: card differs from CPU")
    feats = {d: torch.from_numpy(RandomConvFeatures(device=d)(u8["cpu"].numpy()))
             for d in ("cuda", "cpu")}
    scale = feats["cpu"].abs().max().item()
    fid_err = (feats["cuda"] - feats["cpu"]).abs().max().item()
    check(fid_err <= VAE_FID_RTOL * scale, f"FID random features: card vs CPU {fid_err} of {scale}")
    net = InceptionV3()
    net.reset_parameters(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(9)
    xin = torch.rand((INCEPTION_BATCH, 299, 299, 3), generator=gen) * 2 - 1
    with torch.no_grad():
        want = net(xin)
        net.cuda()
        xc = xin.cuda()
        got = net(xc).cpu()
        ms = time_ms(lambda a: net(a), [(xc,)], iters=10)
    inc_scale = want.abs().max().item()
    inc_err = (got - want).abs().max().item()
    check(inc_err <= INCEPTION_RTOL * inc_scale,
          f"InceptionV3: card vs CPU {inc_err} of {inc_scale}")
    row = dict(fid_images=VAE_FID_IMAGES, uint8_equal=True,
               random_features_max_abs_err_over_max=fid_err / scale,
               inception_batch=INCEPTION_BATCH,
               inception_max_abs_err_over_max=inc_err / inc_scale, inception_ms=ms)
    emit("vae", run="fid", **row)
    del net
    _release()
    return row


def vae_cli() -> dict:
    """Through the port's CLI, each experiment: a fit of one epoch (4 steps,
    2 validation batches) with the experiment's own callbacks (vae/celeba's
    FID on the random backend: metrics/fid_random_torch finite; the
    traversal grids handed to the logger, finite), then igm-sample from its
    checkpoint to a PNG; and one more fit (2 steps) with
    trainer.profile=true, whose trace must exist and hold CUDA kernels."""
    import numpy as np
    from PIL import Image
    from igm_tpu_torch.cli import sample_main
    from igm_tpu_torch.core.logging import NoOpLogger
    out, logged, log_image = {}, {}, NoOpLogger.log_image
    # logger=null: the images the trainer's logger is handed, by tag
    NoOpLogger.log_image = lambda self, tag, img, step: logged.setdefault(
        tag, (list(img.shape), int(step), bool(np.isfinite(img).all())))
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for name, experiment, metric in VAE_EXPERIMENTS:
            run = tmp / "logs" / "runs" / experiment
            logged.clear()
            t0 = time.perf_counter()
            value = _train_cli(tmp, "trainer.max_epochs=1", "trainer.limit_train_batches=4",
                               "trainer.limit_val_batches=2", experiment=experiment,
                               metric=metric)
            sec = time.perf_counter() - t0
            check(value is not None and math.isfinite(value),
                  f"{experiment} fit: {metric} = {value}")
            ckpts = sorted(p.name for p in (run / "checkpoints").iterdir())
            grids = sorted(p.name for p in (run / "results").iterdir())
            check(ckpts == ["step_4.pt"], f"{experiment} fit: checkpoints {ckpts}")
            check({"0.jpg", "recon_0.jpg"} <= set(grids), f"{experiment} fit: grids {grids}")
            traverse = {k: v for k, v in logged.items() if "traverse_latents" in k}
            want = set() if experiment.startswith("cvae/") else {
                f"sample/{k}" for k in ("random_traverse_latents", "fixed_traverse_latents_1",
                                        "fixed_traverse_latents_2")}
            check(set(traverse) == want and all(v[1:] == (0, True) for v in traverse.values()),
                  f"{experiment} fit: traversal grids logged {traverse}")
            png = tmp / f"{name}.png"
            t1 = time.perf_counter()
            imgs = sample_main([f"experiment={experiment}", "--ckpt", str(run / "checkpoints"),
                                "--n", "16", "--out", str(png)])
            sample_sec = time.perf_counter() - t1
            with Image.open(png) as img:
                size = img.size
            per = 10 if experiment.startswith("cvae/") else 1
            check(tuple(imgs.shape)[0] == 16 * per and bool(imgs.isfinite().all()),
                  f"{experiment} sampling CLI: {tuple(imgs.shape)}")
            out[experiment] = row = dict(fit_seconds=sec, metric=metric, value=value,
                                         checkpoints=ckpts, grids=grids,
                                         traversal_grids_logged=traverse,
                                         sample_seconds=sample_sec, grid_size=list(size))
            emit("vae", run="cli", experiment=experiment, **row)
        experiment = "vae/mnist_mlp"
        run = tmp / "logs" / "runs" / experiment
        _train_cli(tmp, "trainer.max_epochs=1", "trainer.limit_train_batches=2",
                   "trainer.limit_val_batches=0", "trainer.profile=true",
                   "trainer.enable_checkpointing=false", experiment=experiment,
                   metric="train_log/elbo")
        traces = sorted((run / "tensorboard").glob("trace_step*.json"))
        check(len(traces) == 1, f"trainer.profile=true: traces {traces}")
        text = traces[0].read_text()
        kernels = text.count('"cat": "kernel"')
        check(kernels > 0, "trainer.profile=true: the trace holds no CUDA kernel")
        out["profile"] = row = dict(trace=traces[0].name, bytes=len(text), kernel_events=kernels)
        emit("vae", run="profile", experiment=experiment, **row)
    NoOpLogger.log_image = log_image
    _release()
    return out


def phase_vae() -> dict:
    """VAE, beta-VAE, cVAE and FactorVAE; the caller zeroes the counters
    before it.  No hand kernel is on these paths: every count must stay 0."""
    import torch
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(37)
    out = {"reference": {}, "train": {}}
    for name, experiment, _ in VAE_EXPERIMENTS:
        out["reference"][name] = vae_reference(name, experiment, gen)
    for name, experiment, _ in VAE_EXPERIMENTS:
        out["train"][name] = vae_train_timed(name, experiment)
    out["fid"] = vae_fid_features()
    out["cli"] = vae_cli()
    out["launches"] = counts()
    check(out["launches"] == expected(),
          f"vae phase launched {dict(zip(KERNELS, out['launches']))}")
    emit("vae", run="path", seconds=time.perf_counter() - t0,
         launches=dict(zip(KERNELS, out["launches"])))
    return out


# ---------------------------------------------------------------- gan
# the adversarial zoo: (name, experiment, extra overrides) -- one experiment
# of each of the ten models, and speed_gan on vanilla_gan/cifar10
GAN_EXPERIMENTS = (("vanilla_gan", "vanilla_gan/cifar10", ()),
                   ("lsgan", "lsgan/mlp_mnist", ()),
                   ("ggan", "ggan/celeba", ()),
                   ("wgan", "wgan/cifar10", ()),
                   ("wgan_gp", "wgan_gp/celeba", ()),
                   ("infogan", "infogan/mnist", ()),
                   ("bigan", "bigan/cifar10", ()),
                   ("vaegan", "vaegan/celeba", ()),
                   ("aae", "aae/mnist", ()),
                   ("age", "age/celeba", ()),
                   ("speed_gan", "vanilla_gan/cifar10", ("model=speed_gan",)))
GAN_ZOO = ("vanilla_gan", "lsgan", "ggan", "wgan", "wgan_gp", "infogan", "bigan", "vaegan",
           "aae", "age")
GAN_REF_BATCH = 4                    # card against CPU (float64)
GAN_SAMPLE_BATCH = 64
GAN_TIMED_STEPS = 6                  # per turn of the a-b-b-a timing (whole periods)
# the steps profiled for their busy time and idle share (PERF.md's rows)
GAN_PROFILED = ("vanilla_gan", "wgan_gp", "vaegan", "infogan")
# float32 on the card against float64 on the CPU: the metrics within 1e-5
# relative or 1e-5 absolute (means of logits of order 1 that nearly
# cancel); every gradient within 1e-4 of the largest of its update (on the
# same side of every ReLU kink: gan_reference); the parameters each update
# leaves where the gradient's sign is certain, and the buffers, within 1e-5
GAN_METRIC_RTOL, GAN_METRIC_ATOL = 1e-5, 1e-5
GAN_GRAD_TOL = 1e-4
GAN_STATE_TOL = 1e-5
# Adam's first step moves a parameter by lr g / (|g| + 1e-8): lr sign(g) up
# to 1% where |g| > 1e-6 (tests/_torch_parity.py's G_FLOOR)
GAN_G_FLOOR = 1e-6
# float64 put on the card's side of a ReLU kink: at most 16 inputs a step,
# each within 1e-5 of the largest |x| of its activation's input (rounding)
GAN_KINK_MAX, GAN_KINK_RTOL = 16, 1e-5


def _gan_model(experiment: str, overrides=(), device: str = "cuda"):
    from igm_tpu_torch.config import compose, instantiate
    cfg = compose(REPO / "configs", [f"experiment={experiment}", *overrides,
                                     "print_config=False"])
    model = instantiate(cfg.model, datamodule=cfg.datamodule, device=device)
    model.steps_per_epoch = 1000
    return model, cfg


def _net_params(cfg, cin: int, cout: int, **kw) -> int:
    """The parameters of a zoo network, counted from its config alone."""
    kind = str(cfg["_target_"]).rsplit(".", 2)
    kind = f"{kind[-2]}.{kind[-1]}"
    kw = {**cfg, **kw}
    norm = kw.get("norm_type", "batch")
    norm = 0 if norm in (None, "None", "none", False, "null", "instance") else 2

    def conv(a, b, k):
        return a * b * k * k + b

    if kind in ("conv32.Encoder", "conv64.Encoder"):
        ndf, last = int(kw["ndf"]), 2 if kind.startswith("conv32") else 4
        return (conv(cin, ndf, 4) + sum(conv(ndf * m // 2, ndf * m, 4) + norm * ndf * m
                                        for m in (2, 4, 8)) + conv(ndf * 8, cout, last))
    if kind in ("conv32.Decoder", "conv64.Decoder", "basic.ConvDecoder"):
        ngf = int(kw["ngf"])
        layers = {"conv32.Decoder": ((8, 2), (4, 4), (2, 4), (1, 4)),
                  "conv64.Decoder": ((8, 4), (4, 4), (2, 4), (1, 4)),
                  "basic.ConvDecoder": ((4, 4), (2, 3), (1, 4))}[kind]
        total, c = 0, cin
        for mult, k in layers:
            total += conv(c, ngf * mult, k) + norm * ngf * mult
            c = ngf * mult
        return total + conv(c, cout, 4)
    if kind == "basic.ConvEncoder":
        ndf = int(kw["ndf"])
        return (conv(cin, ndf, 4) + conv(ndf, 2 * ndf, 4) + norm * 2 * ndf
                + conv(2 * ndf, 4 * ndf, 3) + norm * 4 * ndf + conv(4 * ndf, cout, 4))
    size = int(kw.get("width", 1)) * int(kw.get("height", 1))
    hidden = [int(h) for h in kw["hidden_dims"]]
    if kind == "basic.MLPEncoder":
        dims = [cin * size, *hidden]
        return (sum(a * b + b + (2 if i == 0 else norm) * b
                    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])))
                + dims[-1] * cout + cout)
    if kind == "basic.MLPDecoder":
        dims = [cin, *hidden]
        return (sum(a * b + b + norm * b for a, b in zip(dims[:-1], dims[1:]))
                + dims[-1] * cout * size + cout * size)
    raise ValueError(f"no count for {kind}")


def gan_config_params(cfg) -> int:
    """A zoo model's parameters, counted from the config's networks and
    hyperparameters as igm_tpu builds the model."""
    m, enc, dec = cfg.model, cfg.networks.encoder, cfg.networks.decoder
    c = int(cfg.datamodule.channels)
    kind = str(m["_target_"]).rsplit(".", 1)[-1]
    module = str(m["_target_"]).rsplit(".", 2)[-2]
    mlp = {"_target_": "igm_tpu.networks.basic.MLPEncoder"}
    if module == "wgan_gp":
        return (_net_params(dec, int(m.latent_dim), c, norm_type="layer")
                + _net_params(enc, c, 1, norm_type="layer"))
    if kind in ("GAN", "WGAN"):
        return _net_params(dec, int(m.latent_dim), c) + _net_params(enc, c, 1)
    if kind == "InfoGAN":
        codes = int(m.discrete_dim) * int(m.discrete_value) + int(m.continuous_dim)
        e = int(m.encode_dim)
        return (_net_params(dec, codes + int(m.noise_dim), c) + _net_params(enc, c, e)
                + e + 1 + e * 128 + 128 + 128 * codes + codes)
    lat = int(m.latent_dim)
    if kind == "BiGAN":
        h = int(m.hidden_dim)
        return (_net_params(dec, lat, c) + _net_params(enc, c, lat)
                + _net_params({**mlp, "hidden_dims": [h, h]}, lat, h)
                + _net_params(enc, c, h) + _net_params({**mlp, "hidden_dims": [h]}, 2 * h, 1))
    if kind == "VAEGAN":
        return _net_params(dec, lat, c) + _net_params(enc, c, 2 * lat) + _net_params(enc, c, 1)
    if kind == "AAE":
        return (_net_params(dec, lat, c) + _net_params(enc, c, lat)
                + _net_params({**mlp, "hidden_dims": [256, 256], "norm_type": "layer"}, lat, 1))
    if kind == "AGE":
        return _net_params(dec, lat, c) + _net_params(enc, c, lat)
    raise ValueError(f"no count for {kind}")


def gan_instantiate_all() -> dict:
    """Every zoo experiment (and speed_gan) composed and instantiated at
    full width on the card: its class, and its parameter count against the
    count from its config."""
    out = {}
    experiments = sorted(str(p.relative_to(REPO / "configs" / "experiment"))[:-5]
                         for p in (REPO / "configs" / "experiment").rglob("*.yaml")
                         if p.parent.name in GAN_ZOO)
    check(len(experiments) == 33, f"gan: {len(experiments)} zoo experiments")
    for experiment, extra in [(e, ()) for e in experiments] + [("vanilla_gan/cifar10",
                                                                ("model=speed_gan",))]:
        model, cfg = _gan_model(experiment, extra)
        got = sum(p.numel() for p in model.modules.parameters())
        want = gan_config_params(cfg)
        check(got == want, f"{experiment} {extra}: {got} parameters, the config counts {want}")
        check(all(p.is_cuda for p in model.modules.parameters()), f"{experiment}: not on the card")
        out[" ".join((experiment, *extra))] = dict(model=type(model).__name__, parameters=got)
        del model
    emit("gan", run="instantiate", experiments=len(out), parameters=out)
    _release()
    return out


def gan_draws(model, n: int, gen) -> dict:
    """A train step's draws, given (on the CPU, from ``gen``)."""
    import torch
    kind = type(model).__name__
    latent = int(model.hparams.get("latent_dim", 0))
    if kind == "InfoGAN":
        hp = model.hparams
        return {"dis": torch.randint(0, hp.discrete_value, (n, hp.discrete_dim), generator=gen),
                "cont": torch.rand((n, hp.continuous_dim), generator=gen) * 2 - 1,
                "z": torch.randn((n, hp.noise_dim), generator=gen)}
    if kind == "VAEGAN":
        return {"eps": torch.randn((n, latent), generator=gen),
                "prior_z": torch.randn((n, latent), generator=gen)}
    if kind == "AAE":
        return {"real_prior": torch.randn((n, latent), generator=gen)}
    draws = {"z": torch.randn((n, latent), generator=gen)}
    if type(model).__module__.endswith("wgan_gp"):
        draws["lerp"] = torch.rand((n, 1, 1, 1), generator=gen)
    return draws


def gan_phase_steps(model) -> tuple:
    """A step of each branch: the G and D (E) steps of the alternating
    models, step 0 of the others."""
    kind = type(model).__module__.rsplit(".", 1)[-1]
    if kind == "wgan_gp":
        return (0, int(model.hparams.n_critic))
    return (0, 1) if model.phase_period > 1 else (0,)


def _record_updates(model, targets=None):
    """Wrap the model's updates: per optimizer, the gradients and the
    parameters each update leaves (on the CPU, by name); after update i of
    optimizer n, the parameters are set to ``targets[n][i]`` when given."""
    import torch
    names = {id(p): k for k, p in model.modules.named_parameters()}
    rec = {"grads": {}, "after": {}, "order": []}
    inner = model.optimizers._apply

    def apply(opt_name, opt, params, grads, count=None, sr_seeds=None):
        rec["grads"].setdefault(opt_name, []).append(
            {names[id(p)]: (torch.zeros_like(p) if g is None else g).detach().double().cpu().clone()
             for p, g in zip(params, grads)})
        inner(opt_name, opt, params, grads, count, sr_seeds)
        after = rec["after"].setdefault(opt_name, [])
        after.append({names[id(p)]: p.detach().double().cpu().clone() for p in params})
        rec["order"].append(opt_name)
        if targets is not None:
            with torch.no_grad():
                for p in params:
                    p.copy_(targets[opt_name][len(after) - 1][names[id(p)]])

    model.optimizers._apply = apply
    return rec


class _KinkSigns:
    """Within: the side (x > 0) of every ReLU and leaky-ReLU input, in call
    order, kept on the CPU; with ``forced`` (another run's sides, in its
    order), each activation takes that side instead of its own: the same
    linear piece of the function, so the same gradient up to rounding.
    Where two runs of one step disagree on a side (an input within rounding
    of 0), they differentiate other pieces: float32 against float64 may.
    A forced run counts the inputs it put on the other side of their kink
    (``moved``) and keeps the largest of them, |x| over the largest |x| of
    that activation's input (``moved_rel``): how far from 0 they were."""

    def __init__(self, forced=None):
        self.forced = forced
        self.moved, self.moved_rel = 0, 0.0

    def __enter__(self):
        import torch
        import torch.nn.functional as F
        self.signs, self.saved = [], (F.relu, F.leaky_relu)
        relu, leaky = self.saved

        def side(x):
            own = x.detach() > 0
            if self.forced is None:
                self.signs.append(own.cpu())
                return None
            mask = self.forced[len(self.signs)].to(x.device)
            check(mask.shape == x.shape, "the forced run took other activations")
            self.signs.append(mask.cpu())
            moved = mask != own
            if bool(moved.any()):
                size = x.detach().abs()
                self.moved += int(moved.sum())
                self.moved_rel = max(self.moved_rel,
                                     (size[moved].max() / size.max().clamp_min(1e-30)).item())
            return mask

        def relu_at(x, *a, **k):
            mask = side(x)
            return relu(x, *a, **k) if mask is None else torch.where(mask, x, 0.0)

        def leaky_at(x, negative_slope=0.01, *a, **k):
            mask = side(x)
            if mask is None:
                return leaky(x, negative_slope, *a, **k)
            return torch.where(mask, x, x * negative_slope)

        F.relu, F.leaky_relu = relu_at, leaky_at
        return self

    def __exit__(self, *exc):
        import torch.nn.functional as F
        F.relu, F.leaky_relu = self.saved

    def flips(self, other: "_KinkSigns") -> int:
        check(len(self.signs) == len(other.signs), "the two runs took other activations")
        return sum(int((a != b).sum()) for a, b in zip(self.signs, other.signs))


def _update_bound(model, opt_name: str) -> float:
    """The largest move of a parameter by one update of ``opt_name``."""
    tx = model.optimizers.tx(opt_name)
    lr = max([float(tx.lr_at(0))] + [float(lr) for _, lr in getattr(tx, "lrs", ())])
    alpha = getattr(tx, "alpha", None)
    return lr / math.sqrt(1.0 - alpha) if alpha is not None else 1.1 * lr


def gan_reference(name: str, experiment: str, extra, gen, device: str = "cuda") -> dict:
    """At full width, batch 4, from the same weights, batch and injected
    draws: one train step of each branch on the card (f32, TF32 off) and
    on the CPU in float64.  The float64 run's updates come first; the
    card's run is put onto the float64 parameters after each of its
    updates, so that a later phase reads the same parameters (Adam's first
    step moves a parameter whose gradient is 0 up to rounding by lr times a
    sign that rounding decides).  Held: the metrics (NaN where the branch
    did not run), the optimizers updated and their order, every gradient
    of each update, the parameters each update left where the gradient's
    sign is certain (beyond the largest card-float64 gradient difference
    on that tensor and 1e-6, on every update of that optimizer so far;
    elsewhere within twice the update's bound), every buffer after the
    step; for WGAN-GP the penalty with the metrics.

    Every gradient is held within 1e-4 of the largest of its update.
    Where the card and float64 disagree on the side of a ReLU or leaky-ReLU
    kink (an input within rounding of 0), they differentiate other linear
    pieces of the function, and a single such element moved the gradients
    by up to 1.3e-2 of the largest on the CPU's float32 (AGE's E branch):
    those steps are counted (``kink_flips``) and float64 runs again with
    every activation on the card's side of its kink (``_KinkSigns``), from
    the same parameters after each update.  That rerun holds what it moved:
    at most GAN_KINK_MAX inputs a step, each within GAN_KINK_RTOL of the
    largest |x| of its activation's input in float64."""
    import torch
    card, _ = _gan_model(experiment, extra, device)
    exact, _ = _gan_model(experiment, extra, "cpu")
    exact.init_state(0)
    exact.modules.double()
    start = {k: v.detach().cpu().clone() for k, v in card.modules.state_dict().items()}
    out, fails = {}, []
    for step in gan_phase_steps(card):
        imgs = torch.randint(0, 256, (GAN_REF_BATCH, card.height, card.width, card.channels),
                             generator=gen, dtype=torch.uint8)
        labels = torch.zeros(GAN_REF_BATCH, dtype=torch.int32)
        draws = gan_draws(exact, GAN_REF_BATCH, gen)
        res = {}

        def run(model, dev, targets=None, forced=None):
            state = model.init_state(0)
            model.modules.load_state_dict(start)
            state.step = step
            rec = _record_updates(model, targets)
            with _KinkSigns(forced) as kinks:
                state, metrics = model.train_step(
                    state, (imgs.to(dev), labels.to(dev)),
                    **{k: v.to(dev) for k, v in draws.items()})
            del model.optimizers._apply
            return dict(rec=rec, kinks=kinks, metrics={k: float(v) for k, v in metrics.items()},
                        buffers={k: v.detach().double().cpu()
                                 for k, v in model.modules.named_buffers()},
                        counts=dict(state.counts))

        want = run(exact, "cpu")
        targets = want["rec"]["after"]
        got = run(card, device, {n: [{k: v.float().to(device) for k, v in a.items()} for a in lst]
                                 for n, lst in targets.items()})
        flips = got["kinks"].flips(want["kinks"])
        if flips:          # float64 again, on the card's side of every kink
            want = run(exact, "cpu", {n: [{k: v.clone() for k, v in a.items()} for a in lst]
                                      for n, lst in targets.items()}, got["kinks"].signs)
        kinks = want["kinks"]
        if kinks.moved > GAN_KINK_MAX or kinks.moved_rel > GAN_KINK_RTOL:
            fails.append(f"step {step}: float64 put {kinks.moved} inputs on the card's side "
                         f"of their kink, the largest {kinks.moved_rel} of its activation's "
                         f"largest input (at most {GAN_KINK_MAX}, {GAN_KINK_RTOL})")
        if got["rec"]["order"] != want["rec"]["order"] or got["counts"] != want["counts"]:
            fails.append(f"step {step}: updates {got['rec']['order']} vs {want['rec']['order']}")
        metric_err = {}
        for k, v in want["metrics"].items():
            g = got["metrics"][k]
            if math.isnan(v) != math.isnan(g):
                fails.append(f"step {step}: {k} {g} vs {v}")
            elif not math.isnan(v):
                metric_err[k] = abs(g - v)
                tol = GAN_METRIC_RTOL * abs(v) + GAN_METRIC_ATOL
                if abs(g - v) > tol:
                    fails.append(f"step {step}: metric {k} card {g} vs float64 {v} beyond {tol}")
        grad_err, param_err, unsure = {}, 0.0, 0
        for opt_name, updates in want["rec"]["grads"].items():
            sure = {}
            for i, g64 in enumerate(updates):
                gc = got["rec"]["grads"][opt_name][i]
                scale = max(g.abs().max().item() for g in g64.values())
                diff = {k: (gc[k] - g).abs() for k, g in g64.items()}
                err, at = max((d.max().item(), k) for k, d in diff.items())
                if err > GAN_GRAD_TOL * scale:
                    fails.append(f"step {step}: {opt_name} update {i} gradients {err} from "
                                 f"float64 at {at} beyond {GAN_GRAD_TOL} x the largest {scale} "
                                 f"({flips} kink flips)")
                grad_err[f"{opt_name}{i}"] = dict(
                    max_abs_err_over_max_grad=err / max(scale, 1e-30), at=at, max_grad=scale)
                bound = 2 * _update_bound(card, opt_name) * (1 + 1e-3)
                for k, g in g64.items():
                    sure[k] = ((g.abs() > max(diff[k].max().item(), GAN_G_FLOOR))
                               & sure.get(k, True))
                    moved = (got["rec"]["after"][opt_name][i][k]
                             - want["rec"]["after"][opt_name][i][k]).abs()
                    if sure[k].any():
                        param_err = max(param_err, moved[sure[k]].max().item())
                    unsure += int((~sure[k]).sum())
                    if not bool((moved[~sure[k]] <= bound).all()):
                        fails.append(f"step {step}: {k} moved beyond 2 x the update's bound")
        if param_err > GAN_STATE_TOL:
            fails.append(f"step {step}: parameters after the updates differ by {param_err}")
        buffer_err = 0.0
        for k, v in want["buffers"].items():
            buffer_err = max(buffer_err, ((got["buffers"][k] - v).abs().max()
                                          / max(v.abs().max().item(), 1e-30)).item())
        if buffer_err > GAN_STATE_TOL:
            fails.append(f"step {step}: buffers differ by {buffer_err} (relative)")
        out[step] = dict(updates=got["rec"]["order"], metrics=got["metrics"],
                         kink_flips=flips, kink_moved=kinks.moved,
                         kink_moved_max_rel=kinks.moved_rel,
                         metric_abs_err=metric_err, grad_errors=grad_err,
                         parameters_after_max_abs_err=param_err, sign_unsure_entries=unsure,
                         buffers_max_rel_err=buffer_err, buffers=len(want["buffers"]))
    emit("gan", run="reference", model=name, batch=GAN_REF_BATCH, dtype="float32",
         reference="float64 on the CPU", steps=out, fails=fails)
    check(not fails, f"gan {name}: {fails}")
    del card, exact
    _release()
    return out


def _alt_k(period: int) -> int:
    """A chunk length that is not a multiple of the period (3, or 4 for
    periods 3 and 6)."""
    return 4 if period % 3 == 0 else 3


def gan_chain(name: str, model, batch: int):
    """Graphed against eager at full width and the datamodule's batch, from
    step 0 and the same state: more than two periods of train_step_n at
    the K of _alt_k where the branch alternates (a K that is not a
    multiple of the period), then two periods at K = 1 (each starting
    phase's first chunk eager, then captured; the rest replayed).  Bit for
    bit: the parameters, buffers, optimizer states, generator, step,
    update counts, and each chunk's metrics (a NaN where the other run has
    a NaN: a branch that did not run); one graph per starting phase that
    occurs.  Returns the record and the state after the graphed K = 1
    run, which holds a graph of each phase."""
    import torch
    state = model.init_state(0)
    period = model.phase_period
    start = state.snapshot()
    out = {"period": period, "batch": batch}
    for k in (_alt_k(period), 1) if period > 1 else (1,):
        # every starting phase captured, then replayed at least once
        n_exec = 2 * period if k == 1 else -(-2 * period // k) + 1
        imgs, labels = _chain_batches(model, batch, n_exec * k, 13)
        imgs = imgs.reshape(n_exec, k, *imgs.shape[1:])
        labels = labels.reshape(n_exec, k, -1)
        runs = {}
        for graphed in (False, True):
            state.load_state_dict(start)
            state.graphs.clear()
            metrics = [model.train_step_n(state, (imgs[i], labels[i]), graph=graphed)[1]
                       for i in range(n_exec)]
            torch.cuda.synchronize()
            runs[graphed] = (state.snapshot(), metrics, dict(state.counts), len(state.graphs))
        diff = (same_bits(runs[True][0], runs[False][0])
                + same_bits(runs[True][1], runs[False][1], nan_equal=True))
        check(not diff, f"gan {name} K={k}: graphed differs from eager at {diff[:8]}")
        phases = {(i * k) % period for i in range(n_exec)}
        check(runs[True][2] == runs[False][2] and runs[True][3] == len(phases),
              f"gan {name} K={k}: counts {runs[True][2]} vs {runs[False][2]}, "
              f"{runs[True][3]} graphs for {len(phases)} phases")
        nan_keys = [sorted(kk for kk, v in m.items() if torch.isnan(v)) for m in runs[True][1]]
        out[f"k{k}"] = dict(steps=n_exec * k, bit_equal=True, graphs=runs[True][3],
                            counts=runs[True][2], nan_metrics_by_chunk=nan_keys)
    emit("gan", run="chain", model=name, **out)
    return out, state


def gan_train_timed(name: str, model, state, batch: int) -> dict:
    """The train step at the datamodule's batch (128; age/celeba 64), from
    ``state`` (gan_chain's: a graph of each phase at K = 1 captured on
    this batch's shapes), over whole periods: graphed against eager
    a-b-b-a (ms a step, images/s; the graphed steps replay, nothing is
    captured), the FLOPs of a period's steps (FlopCounterMode, as the
    trainer counts them), for the models of GAN_PROFILED the graphed
    steps' device busy time and idle share (one period profiled); then
    sampling at batch 64, graphed against eager (the same images bit for
    bit)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from igm_tpu_torch.core.trainer import step_flop_counter
    from igm_tpu_torch.tools.profiling import device_summary
    period = model.phase_period
    check(state.step % period == 0 and len(state.graphs) == period,
          f"gan {name} timed: step {state.step}, {len(state.graphs)} graphs")
    steps = period * -(-GAN_TIMED_STEPS // period)
    imgs, labels = _chain_batches(model, batch, 1, 47)
    with step_flop_counter() as counter:
        for _ in range(period):
            state, _ = model.train_step_n(state, (imgs, labels), graph=False)
    flops = float(counter.get_total_flops()) / period

    def run(graphed: bool, n: int = steps):
        nonlocal state
        for _ in range(n):
            state, metrics = model.train_step_n(state, (imgs, labels), graph=graphed)
        return metrics

    sec = _abba(run, warm=0)                 # the chain and the FLOP count warmed both
    check(len(state.graphs) == period, f"gan {name} timed: captured again")
    ms = {m: [1e3 * s / steps for s in v] for m, v in sec.items()}
    row = dict(batch=batch, dtype="float32", period=period, steps_per_turn=steps,
               ms_per_step=ms, images_per_s={m: [batch * 1e3 / t for t in v]
                                             for m, v in ms.items()},
               gflop_per_step=flops / 1e9,
               achieved_tflops_graphed=flops / (1e-3 * min(ms["graphed"])) / 1e12)
    if name in GAN_PROFILED:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(True, period)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        summary = device_summary(prof, period, 1e-3 * min(ms["graphed"]) * period, wall)
        row["profile_graphed"] = {k: summary[k] for k in (
            "wall_ms_per_step", "device_busy_ms_per_step", "idle_share", "kernels_per_step",
            "device_ms_per_step_by_group")}
    values = row["metrics"] = {k: float(v) for k, v in run(True, period).items()}
    check(any(math.isfinite(v) for v in values.values()), f"gan {name} timed: metrics {values}")
    samples = {}

    def sample(graphed: bool):
        model.use_graphs = graphed
        samples[graphed] = model.sample(GAN_SAMPLE_BATCH,
                                        torch.Generator(model.device).manual_seed(5))

    sample(True)                                          # capture
    sample_sec = _abba(sample, warm=0)
    model.use_graphs = True
    x = samples[True]
    check(not same_bits(samples[True], samples[False]), f"gan {name}: graphed samples differ")
    check(tuple(x.shape) == (GAN_SAMPLE_BATCH, model.height, model.width, model.channels)
          and bool(torch.isfinite(x).all()), f"gan {name} samples: {tuple(x.shape)}")
    row["sample"] = dict(batch=GAN_SAMPLE_BATCH, seconds=sample_sec, bit_equal=True,
                         images_per_s={m: [GAN_SAMPLE_BATCH / s for s in v]
                                       for m, v in sample_sec.items()})
    emit("gan", run="train_timed", model=name, **row)
    return row


# the CLI fits: one experiment of each network family and each period of
# the branch (MLP 2, conv_mnist 1, conv64 4; conv32 with period 6 is
# wgan/cifar10, fitted for the resume), each with the metric it returns
GAN_CLI = (("lsgan/mlp_mnist", "train_loss/d_loss"), ("infogan/mnist", "train_loss/d_loss"),
           ("age/celeba", "train_loss/g_loss"))
GAN_CLI_FOUR = ("trainer.limit_train_batches=4", "trainer.limit_val_batches=1")


def _gan_fit(root: Path, experiment: str, metric: str, *overrides: str) -> dict:
    """python -m igm_tpu_torch.train of ``experiment`` for one epoch of 4
    steps (K = 1) in ``root``, with its own callbacks (FID on the random
    backend, the sample and traversal grids), then igm-sample from its
    checkpoint to a PNG of 16 images: seconds, the checkpoints, the grids."""
    import numpy as np
    from PIL import Image
    from igm_tpu_torch.cli import sample_main
    from igm_tpu_torch.core.logging import NoOpLogger
    logged, log_image = {}, NoOpLogger.log_image
    NoOpLogger.log_image = lambda self, tag, img, step: logged.setdefault(
        tag, (list(img.shape), int(step), bool(np.isfinite(img).all())))
    try:
        t0 = time.perf_counter()
        value = _train_cli(root, "trainer.max_epochs=1", *GAN_CLI_FOUR,
                           "trainer.steps_per_execution=1", *overrides,
                           experiment=experiment, metric=metric)
        sec = time.perf_counter() - t0
    finally:
        NoOpLogger.log_image = log_image
    # the newest run directory (hydra.run.dir, named by exp_name)
    run = max((q.parent for q in (root / "logs" / "runs").rglob("checkpoints")),
              key=lambda q: q.stat().st_mtime)
    check(value is not None and math.isfinite(value), f"{experiment} fit: {metric} = {value}")
    ckpts = sorted(q.name for q in (run / "checkpoints").iterdir())
    grids = sorted(q.name for q in (run / "results").iterdir())
    check(ckpts == ["step_4.pt"] and "0.jpg" in grids,
          f"{experiment} fit: checkpoints {ckpts}, grids {grids}")
    if experiment.startswith("infogan/"):
        tags = {"visual/traverse over discrete values",
                "visual/traverse over first continuous values",
                "visual/traverse over second continuous values"}
        check(tags <= set(logged) and all(logged[t][1:] == (0, True) for t in tags),
              f"{experiment}: traversal grids logged {sorted(logged)}")
    png = root / "samples.png"
    t1 = time.perf_counter()
    imgs = sample_main([f"experiment={experiment}", "--ckpt", str(run / "checkpoints"),
                        "--n", "16", "--out", str(png)])
    sample_sec = time.perf_counter() - t1
    with Image.open(png) as img:
        size = img.size
    check(tuple(imgs.shape)[0] == 16 and bool(imgs.isfinite().all()),
          f"{experiment} sampling CLI: {tuple(imgs.shape)}")
    row = dict(fit_seconds=sec, metric=metric, value=value, checkpoints=ckpts, grids=grids,
               images_logged=sorted(logged), sample_seconds=sample_sec, grid_size=list(size))
    emit("gan", run="cli", experiment=experiment, **row)
    return row


def gan_cli() -> dict:
    """Through the port's CLI: the fits of GAN_CLI and igm-sample from
    their checkpoints (_gan_fit); wgan/cifar10 fitted and sampled so too,
    then resumed for a second epoch (step 4 is mid-period: its period is
    6) at the K that steps_per_execution=auto resolves (its probe warms,
    captures and times each of the six phases, then restores the state),
    ends where two epochs in one run at K = 1 do, bit for bit."""
    import torch
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for i, (experiment, metric) in enumerate(GAN_CLI):
            root = tmp / str(i)
            root.mkdir()
            out[experiment] = _gan_fit(root, experiment, metric)
        saved = {}
        for kind in ("resumed", "whole"):
            root = tmp / kind
            root.mkdir()
            ckpt = root / "logs" / "runs" / "wgan" / "cifar10_lr_0.0002" / "checkpoints"
            if kind == "resumed":
                out["wgan/cifar10"] = _gan_fit(root, "wgan/cifar10", "train_loss/d_loss")
                _train_cli(root, "trainer.max_epochs=2", *GAN_CLI_FOUR,
                           f"trainer.resume={ckpt}", experiment="wgan/cifar10",
                           metric="train_loss/d_loss")
            else:
                _train_cli(root, "trainer.max_epochs=2", *GAN_CLI_FOUR,
                           "trainer.steps_per_execution=1", experiment="wgan/cifar10",
                           metric="train_loss/d_loss")
            saved[kind] = torch.load(ckpt / "step_8.pt", weights_only=True)
        diff = same_bits(saved["resumed"], saved["whole"])
        check(not diff, f"wgan/cifar10 resumed mid-period differs at {diff[:8]}")
        out["resume"] = row = dict(experiment="wgan/cifar10", resumed_at=4, period=6,
                                   steps=8, resumed_k="auto", whole_k=1,
                                   checkpoint_bit_equal=True)
        emit("gan", run="cli_resume", **row)
    _release()
    return out


def phase_gan() -> dict:
    """The adversarial zoo; the caller zeroes the counters before it.  No
    hand kernel is on these paths: every count must stay 0."""
    import torch
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(41)
    out, sec = {"reference": {}, "chain": {}, "train": {}}, {}
    out["instantiate"] = gan_instantiate_all()
    sec["instantiate"] = time.perf_counter() - t0
    by_model = {name: {} for name, _, _ in GAN_EXPERIMENTS}
    for name, experiment, extra in GAN_EXPERIMENTS:
        t1 = time.perf_counter()
        out["reference"][name] = gan_reference(name, experiment, extra, gen)
        by_model[name]["reference"] = time.perf_counter() - t1
    for name, experiment, extra in GAN_EXPERIMENTS:     # one model and state for both
        t1 = time.perf_counter()
        model, cfg = _gan_model(experiment, extra)
        batch = int(cfg.datamodule.batch_size)
        out["chain"][name], state = gan_chain(name, model, batch)
        t2 = time.perf_counter()
        out["train"][name] = gan_train_timed(name, model, state, batch)
        by_model[name].update(chain=t2 - t1, train=time.perf_counter() - t2)
        del model, state
        _release()
    for part in ("reference", "chain", "train"):
        sec[part] = sum(m[part] for m in by_model.values())
    t1 = time.perf_counter()
    out["cli"] = gan_cli()
    sec["cli"] = time.perf_counter() - t1
    out["launches"] = counts()
    check(out["launches"] == expected(),
          f"gan phase launched {dict(zip(KERNELS, out['launches']))}")
    emit("gan", run="path", seconds=time.perf_counter() - t0, seconds_by_part=sec,
         seconds_by_model=by_model, launches=dict(zip(KERNELS, out["launches"])))
    return out


# ---------------------------------------------------------------- serve
SERVE_OVERRIDES = ["experiment=ddpm/cifar10"]
SERVE_SAMPLER = ("dpm", 20)          # DPM-Solver++ at 20 steps: one forward a step
SERVE_N = 64
SERVE_REQUESTS = 20
SERVE_CLI_SEEDS = 5                  # served seeds the sampling CLI redraws, bit for bit
SERVE_CONCURRENT = (0, 1, 0, 2, 1, 2, 0, 1)
SERVE_EAGER = 3                      # eager requests timed beside the graphed ones
SERVE_FID_FAKES = 256
SERVE_SWEEP = ["experiment=vae/mnist_mlp", "networks.encoder.hidden_dims=[16]",
               "networks.decoder.hidden_dims=[16]", "trainer.max_epochs=1",
               "trainer.limit_train_batches=2", "trainer.limit_val_batches=1",
               "datamodule.batch_size=16", "trainer.enable_checkpointing=False",
               "trainer.steps_per_execution=1", "print_config=False", "logger=null"]


def _http_sample(base: str, seed: int, fmt: str = "npy"):
    import io
    import urllib.request
    import numpy as np
    req = urllib.request.Request(f"{base}/sample",
                                 data=json.dumps({"seed": seed, "format": fmt}).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        check(r.status == 200, f"/sample seed {seed}: HTTP {r.status}")
        body = r.read()
    return body if fmt == "png" else np.load(io.BytesIO(body))


def _http_json(base: str, route: str) -> dict:
    import urllib.request
    with urllib.request.urlopen(f"{base}{route}", timeout=60) as r:
        return json.loads(r.read())


def serve_http(art: Path) -> dict:
    """The artifact served in this process: SERVE_REQUESTS sequential
    requests (each launch-counted), /stats, the concurrent requests against
    the sequential responses, a PNG, then SERVE_EAGER requests with the
    graphs off (timed, equal to the graphed ones bit for bit)."""
    import threading
    from concurrent.futures import ThreadPoolExecutor
    import numpy as np
    from igm_tpu_torch.tools.serve import serve
    t0 = time.perf_counter()
    httpd = serve(str(art), "127.0.0.1", 0)              # loads, warms up, captures
    warm_s = time.perf_counter() - t0
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    svc = httpd.service
    try:
        model = svc.model
        dpm_forwards = len(model._dpm_timesteps(SERVE_SAMPLER[1],
                                                 str(model.hparams.dpm_schedule)))
        per_request = expected(group_norm_mish=25 * dpm_forwards,
                               linear_attention=6 * dpm_forwards)
        health = _http_json(base, "/healthz")
        check(health["n"] == SERVE_N and health["out_shape"] == [[SERVE_N, 32, 32, 3]],
              f"/healthz {health}")
        responses, client_ms = {}, []
        for seed in range(SERVE_REQUESTS):
            before = counts()
            t1 = time.perf_counter()
            imgs = _http_sample(base, seed)
            client_ms.append((time.perf_counter() - t1) * 1e3)
            got = since(before)
            check(got == per_request,
                  f"request {seed} launched {dict(zip(KERNELS, got))}, expected "
                  f"{dict(zip(KERNELS, per_request))}")
            check(imgs.shape == (SERVE_N, 32, 32, 3) and bool(np.isfinite(imgs).all()),
                  f"request {seed}: {imgs.shape} or non-finite")
            responses[seed] = imgs
        stats = _http_json(base, "/stats")
        emit("serve", run="stats", **stats)
        with ThreadPoolExecutor(max_workers=len(SERVE_CONCURRENT)) as pool:
            together = list(pool.map(lambda s: _http_sample(base, s), SERVE_CONCURRENT))
        for seed, got in zip(SERVE_CONCURRENT, together):
            check(np.array_equal(got, responses[seed]),
                  f"concurrent request at seed {seed} differs from the sequential one")
        png = _http_sample(base, 0, fmt="png")
        check(png[:8] == b"\x89PNG\r\n\x1a\n", "/sample png: not a PNG")
        model.use_graphs = False                          # the same requests, eager
        eager_ms = []
        for seed in range(SERVE_EAGER):
            t1 = time.perf_counter()
            imgs = svc.sample(seed)
            eager_ms.append((time.perf_counter() - t1) * 1e3)
            check(np.array_equal(imgs, responses[seed]),
                  f"eager request at seed {seed} differs from the graphed one")
        model.use_graphs = True
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    graphed_ms = sorted(svc.latencies_ms[:SERVE_REQUESTS])
    return dict(responses=responses, stats=stats, warm_s=warm_s,
                dpm_forwards=dpm_forwards, per_request=dict(zip(KERNELS, per_request)),
                client_ms=client_ms, graphed_ms=graphed_ms, eager_ms=eager_ms,
                concurrent=len(SERVE_CONCURRENT), png_bytes=len(png))


def phase_serve() -> dict:
    """The serving path; the caller zeroes the counters before it: export,
    serve over HTTP, the sampling CLI at SERVE_CLI_SEEDS served seeds, the bench line,
    eval_fid and a joblib multirun."""
    import numpy as np
    import torch
    from igm_tpu_torch.cli import sample_main, train_main
    from igm_tpu_torch.config import compose, instantiate
    from igm_tpu_torch.tools import eval_fid, export
    from igm_tpu_torch.tools.serve import bench
    t0 = time.perf_counter()
    sec, out = {}, {}
    sampler, steps = SERVE_SAMPLER
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        cfg = compose(REPO / "configs", [*SERVE_OVERRIDES, "print_config=False"])
        model = instantiate(cfg.model, datamodule=cfg.datamodule, device="cuda")
        check(model.compute_dtype == torch.bfloat16, "compute dtype is not bf16")
        model.init_params(2026)                          # seeded weights
        weights = tmp / "w.pt"
        torch.save(model.modules[model.weights_module].state_dict(), weights)
        del model
        art = tmp / "ddpm_dpm20.pt"
        t1 = time.perf_counter()
        meta = export.export(SERVE_OVERRIDES, str(art), n=SERVE_N, sampler=sampler,
                             steps=steps, weights=str(weights))
        sec["export"] = time.perf_counter() - t1
        out["artifact_mb"] = art.stat().st_size / 1e6
        check(meta["out_shape"] == [[SERVE_N, 32, 32, 3]], f"export meta {meta}")

        t1 = time.perf_counter()
        http = serve_http(art)
        sec["http"] = time.perf_counter() - t1
        responses = http.pop("responses")
        out["http"] = http
        _release()

        t1 = time.perf_counter()                         # a response is the CLI's batch
        for seed, served in list(responses.items())[:SERVE_CLI_SEEDS]:
            imgs = sample_main([*SERVE_OVERRIDES, "--weights", str(weights), "--n", str(SERVE_N),
                                "--sampler", sampler, "--steps", str(steps), "--seed", str(seed),
                                "--out", str(tmp / "cli.png")])
            check(np.array_equal(imgs.float().cpu().numpy(), served),
                  f"served seed {seed} differs from the sampling CLI's batch")
            del imgs
            _release()
        sec["cli_equal"] = time.perf_counter() - t1
        out["cli_equal"] = min(len(responses), SERVE_CLI_SEEDS)

        t1 = time.perf_counter()
        out["bench"] = bench(str(art), SERVE_REQUESTS)
        sec["bench"] = time.perf_counter() - t1
        emit("serve", run="bench", **out["bench"])
        _release()

        t1 = time.perf_counter()
        fid = eval_fid.main([*SERVE_OVERRIDES, "--weights", str(weights),
                             "--n", str(SERVE_FID_FAKES), "--batch", str(SERVE_N),
                             "--sampler", "ddim", "--stats-dir", str(tmp / "fid_stats"),
                             f"datamodule.data_dir={tmp / 'data'}"])
        sec["eval_fid"] = time.perf_counter() - t1
        check(math.isfinite(fid["fid"]) and fid["backend"] == "random_torch"
              and fid["n_fake"] == SERVE_FID_FAKES, f"eval_fid {fid}")
        out["fid"] = fid
        emit("serve", run="eval_fid", seconds=sec["eval_fid"], **fid)
        _release()

        t1 = time.perf_counter()                         # joblib workers on the card
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            train_main(["-m", "hydra/launcher=joblib", "hydra.launcher.n_jobs=2",
                        "model.lr=1e-3,5e-4", "+optimized_metric=val_log/log_p_x_of_z",
                        *SERVE_SWEEP, f"hydra.sweep.dir={tmp / 'sweep'}"])
        finally:
            os.chdir(cwd)
        sec["multirun"] = time.perf_counter() - t1
        values = [json.loads((tmp / "sweep" / str(i) / "optimized_metric.json").read_text())
                  ["optimized_metric"] for i in range(2)]
        check(all(math.isfinite(v) for v in values), f"multirun values {values}")
        out["multirun"] = dict(jobs=2, values=values, seconds=sec["multirun"])
        emit("serve", run="multirun", **out["multirun"])
    out["launches"] = counts()
    lat = http["graphed_ms"]
    out["request"] = dict(graphed_p50_ms=float(np.percentile(lat, 50)),
                          graphed_p95_ms=float(np.percentile(lat, 95)),
                          eager_ms=http["eager_ms"],
                          images_per_s=SERVE_N * len(lat) / (sum(lat) / 1e3),
                          client_p50_ms=float(np.percentile(http["client_ms"], 50)))
    emit("serve", run="path", seconds=time.perf_counter() - t0, seconds_by_part=sec,
         export=meta, artifact_mb=out["artifact_mb"], warm_s=http["warm_s"],
         dpm_forwards=http["dpm_forwards"], per_request=http["per_request"],
         requests=SERVE_REQUESTS, concurrent=http["concurrent"], cli_equal=out["cli_equal"],
         request=out["request"], launches=dict(zip(KERNELS, out["launches"])))
    out["seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------- scores
SCORES_EXPERIMENT = "ddpm/cond_mnist"
SCORES_PER_CLASS = 8
# score_conditional at 8 a class: 80 images, the guided batch doubled to
# 160 inside each of the T = 1000 forwards of the ancestral chain; the
# cond_mnist UNet (dim_mults [2, 4]) launches 17 GroupNorm+Mish and 4 linear
# attention a forward
SCORES_LAUNCHES = dict(group_norm_mish=17 * 1000, linear_attention=4 * 1000)
GATHER_SHAPES = (("cifar_batch_256", (50_000, 32, 32, 3), 256),
                 ("mnist_batch_128", (60_000, 28, 28, 1), 128))
GATHER_CALLS = 200                   # index sets a turn of the a-b-b-a timing


def _gather_us(src, batch: int) -> dict:
    """One batch's gather (native and numpy) in microseconds a call, on the
    host's clock, a-b-b-a over GATHER_CALLS random index sets."""
    import numpy as np
    from igm_tpu_torch.data import native
    rng = np.random.default_rng(3)
    sets = [rng.permutation(len(src))[:batch] for _ in range(GATHER_CALLS)]
    turns = {"native": [], "numpy": []}
    for mode in ("native", "numpy", "numpy", "native"):
        t0 = time.perf_counter()
        for idx in sets:
            if mode == "native":
                native.gather_rows(src, idx)
            else:
                np.ascontiguousarray(src[idx])
        turns[mode].append(1e6 * (time.perf_counter() - t0) / GATHER_CALLS)
    return turns


def scores_batcher() -> dict:
    """The host batcher built from csrc/batcher.cpp: a CIFAR-shaped epoch of
    batches of 256 through epoch_batches equal to numpy's rows, and one
    batch's gather against numpy's (a 256-row CIFAR batch, a 128-row MNIST
    batch)."""
    import numpy as np
    from igm_tpu_torch.data import native
    from igm_tpu_torch.data.loader import epoch_batches
    t0 = time.perf_counter()
    lib = native.build()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    out = dict(library=lib.name, build_seconds=build_s, threads=min(os.cpu_count() or 1,
                                                                     native.MAX_THREADS))
    for name, shape, batch in GATHER_SHAPES:
        x = rng.integers(0, 256, shape, np.uint8)
        if name.startswith("cifar"):
            y = rng.integers(0, 10, shape[0]).astype(np.int32)
            order = np.random.default_rng(1).permutation(shape[0])
            n = 0
            for i, (a, b) in enumerate(epoch_batches([x, y], batch, np.random.default_rng(1),
                                                     shuffle=True)):
                idx = order[i * batch:(i + 1) * batch]
                check(np.array_equal(a, x[idx]) and np.array_equal(b, y[idx]),
                      f"epoch_batches batch {i} differs from numpy's rows")
                n += 1
            check(n == shape[0] // batch, f"epoch of {n} batches")
            out["epoch_batches"] = n
        us = _gather_us(x, batch)
        out[name] = dict(batch_bytes=batch * x[0].nbytes, native_us=us["native"],
                         numpy_us=us["numpy"],
                         native_over_numpy=min(us["native"]) / min(us["numpy"]))
    emit("scores", run="batcher", **out)
    return out


def phase_scores() -> dict:
    """The scorer's path: the packaged digits made without scikit-learn, the
    digit classifier trained on the card (against the same weights on the
    CPU), score_gallery over the archived runs (read only), a
    ddpm/cond_mnist fit on the real digits with GifCallback, score_conditional
    from its checkpoints (counters zeroed just before and read just after:
    exactly SCORES_LAUNCHES), and the host batcher."""
    import numpy as np
    import torch
    from PIL import Image
    from igm_tpu_torch.data import packaged
    from igm_tpu_torch.tools import score_conditional, score_gallery
    from igm_tpu_torch.utils import digit_score
    t0 = time.perf_counter()
    sec, out = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t1 = time.perf_counter()
        packaged.ensure(tmp / "data")
        sec["packaged"] = time.perf_counter() - t1
        check("sklearn" not in sys.modules, "packaging the digits imported scikit-learn")

        t1 = time.perf_counter()                         # 30 epochs, seed 0, on the card
        params = digit_score.load_or_train(tmp / "data", 28, 28, "cuda")
        torch.cuda.synchronize()
        sec["classifier"] = time.perf_counter() - t1
        acc = digit_score.validation_accuracy(params, 28, 28)
        card = digit_score.validation_logits(params, 28, 28).cpu()
        cpu = digit_score.validation_logits({k: v.cpu() for k, v in params.items()}, 28, 28)
        err = (card - cpu).abs().max().item()
        atol, rtol = tolerance(torch.float32)
        check(acc > 0.90, f"digit classifier on the card: validation accuracy {acc}")
        check(err <= atol + rtol * cpu.abs().max().item(),
              f"classifier logits card vs CPU: {err}")
        out["classifier"] = dict(epochs=30, seed=0, val_accuracy=acc, seconds=sec["classifier"],
                                 logits_max_abs_err=err, max_logit=cpu.abs().max().item())
        emit("scores", run="classifier", **out["classifier"])

        runs = REPO / "benchmarks" / "real_runs"
        before = {p: (p.stat().st_mtime_ns, p.stat().st_size) for p in runs.rglob("*")}
        t1 = time.perf_counter()
        table = score_gallery.main(["--runs-dir", str(runs), "--out-dir",
                                    str(tmp / "digit_scores"), "--cache-dir", str(tmp / "data")])
        sec["gallery"] = time.perf_counter() - t1
        check({p: (p.stat().st_mtime_ns, p.stat().st_size) for p in runs.rglob("*")} == before,
              "score_gallery wrote into the runs directory")
        keys = ("mean_confidence", "coverage", "inception_score")
        gallery = {}
        for family, got in table.items():
            check(all(math.isfinite(got[k]) for k in keys), f"gallery {family}: {got}")
            archived = runs / family / "digit_scores.json"
            old = json.loads(archived.read_text()) if archived.exists() else {}
            gallery[family] = {"grid": got["grid"], "port": {k: got[k] for k in keys},
                               "archived": {k: old.get(k) for k in keys}}
        check(len(gallery) >= 10, f"gallery scored {len(gallery)} families")
        out["gallery"] = gallery
        emit("scores", run="gallery", seconds=sec["gallery"], families=len(gallery),
             table=gallery)

        t1 = time.perf_counter()                         # the fit: 2 epochs of 3 steps
        loss = _train_cli(tmp, "trainer.max_epochs=2",
                          "+callbacks.gif._target_=igm_tpu.callbacks.util.GifCallback",
                          experiment=SCORES_EXPERIMENT)
        sec["fit"] = time.perf_counter() - t1
        run = tmp / "logs" / "runs" / SCORES_EXPERIMENT
        with Image.open(run / "video.gif") as gif:
            frames = gif.n_frames
        check(loss is not None and math.isfinite(loss) and frames == 2,
              f"{SCORES_EXPERIMENT} fit: loss {loss}, {frames} gif frames")
        out["fit"] = dict(seconds=sec["fit"], loss=loss, gif_frames=frames)
        emit("scores", run="fit", **out["fit"])
        _release()

        reset_counts()                                   # the scores path
        t1 = time.perf_counter()
        scores = score_conditional.main([f"experiment={SCORES_EXPERIMENT}", "--ckpt",
                                         str(run / "checkpoints"), "--per-class",
                                         str(SCORES_PER_CLASS), "--cache-dir", str(tmp / "data"),
                                         "--out", str(tmp / "scores.json")])
        torch.cuda.synchronize()
        sec["score_conditional"] = time.perf_counter() - t1
        out["launches"] = counts()
        check(out["launches"] == expected(**SCORES_LAUNCHES),
              f"score_conditional launched {dict(zip(KERNELS, out['launches']))}, "
              f"expected {SCORES_LAUNCHES}")
        check(json.loads((tmp / "scores.json").read_text()) == json.loads(json.dumps(scores))
              and scores["step"] == 6 and scores["per_class_n"] == SCORES_PER_CLASS
              and all(math.isfinite(v) for v in (scores["conditional_accuracy"],
                                                  scores["mean_confidence"])),
              f"score_conditional {scores}")
        out["score_conditional"] = dict(seconds=sec["score_conditional"], **scores)
        emit("scores", run="score_conditional", seconds=sec["score_conditional"],
             launches=dict(zip(KERNELS, out["launches"])), result=scores)
        _release()
    t1 = time.perf_counter()
    out["batcher"] = scores_batcher()
    sec["batcher"] = time.perf_counter() - t1
    out["seconds"] = time.perf_counter() - t0
    emit("scores", run="path", seconds=out["seconds"], seconds_by_part=sec,
         launches=dict(zip(KERNELS, out["launches"])))
    return out


# ---------------------------------------------------------------- chain
# the train steps the chain phase holds graphed against eager:
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
    ("dit", ["experiment=ddpm/cifar10_dit"], TRAIN_BATCH, {}),
    ("dit_moe", ["experiment=ddpm/cifar10_dit", *DIT_MOE_OVERRIDES], TRAIN_BATCH, {}),
)
CHAIN_K = (1, 4)
CHAIN_TIMED_STEPS = 8                # per turn of the a-b-b-a timing
CHAIN_SAMPLE_BATCH = 64


def same_bits(a, b, path: str = "", nan_equal: bool = False) -> list[str]:
    """The places where two nested state dicts differ (tensors bit for
    bit, on the CPU); empty when they are equal.  ``nan_equal``: a NaN
    equals a NaN in the same place (the metrics of a branch that did not
    run); else any NaN differs."""
    import torch
    if isinstance(a, torch.Tensor):
        a, b = a.detach().cpu(), b.detach().cpu()
        if nan_equal and a.shape == b.shape and a.dtype == b.dtype and a.dtype.is_floating_point:
            nan = a.isnan()
            ok = torch.equal(nan, b.isnan()) and torch.equal(a[~nan], b[~nan])
            return [] if ok else [path]
        ok = a.shape == b.shape and a.dtype == b.dtype and torch.equal(
            a.view(torch.uint8) if a.dtype.is_floating_point and a.element_size() == 1 else a,
            b.view(torch.uint8) if b.dtype.is_floating_point and b.element_size() == 1 else b)
        if ok and a.dtype.is_floating_point:         # NaN bits too
            ok = bool((a.isnan() == b.isnan()).all())
        return [] if ok else [path]
    if isinstance(a, dict):
        if set(a) != set(b):
            return [f"{path}: keys"]
        return [d for k in a for d in same_bits(a[k], b[k], f"{path}/{k}", nan_equal)]
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return [f"{path}: length"]
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in same_bits(x, y, f"{path}/{i}", nan_equal)]
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
    _release()
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


# ------------------------------------------------------------ phase parallel
# igm_tpu_torch/parallel: (a) one NCCL rank in this process, graphed; (b)
# two gloo ranks spawned on this card, eager; (c) sample_sharded; (d) the
# model axis and the MoE's global routing on (b)'s ranks
PARALLEL_STEPS = 3                   # (a): graphed K = 1 steps from one state
PARALLEL_TIMED = 16                  # steps a turn of (a)'s a-b-b-a timing
PARALLEL_DP_STEPS = 2                # (b): steps a model
PARALLEL_WORLD = 2
PARALLEL_TIMEOUT_S = 300             # (b)'s spawn: killed and failed past this
# (b)'s models: name, overrides, global batch, hand-kernel launches a step
PARALLEL_MODELS = (
    ("flagship", ["experiment=ddpm/cifar10"], TRAIN_BATCH,
     dict(group_norm_mish=25, linear_attention=6, group_norm_mish_bwd=25,
          linear_attention_bwd=6)),
    ("tar", ["experiment=tar/mnist", "model.flash_attention=dropout"], TAR_SHAPE[0],
     dict(dropout_attention_fwd=4, dropout_attention_dq=4, dropout_attention_dkv=4)),
    ("vqvae_ema", ["experiment=vqvae/cifar10", "model.codebook_update=ema"], VQ_TRAIN_BATCH,
     dict(nearest_codebook=1)),
)
PARALLEL_SAMPLE_N, PARALLEL_SAMPLE_STEPS = 64, 50
# (b)'s tolerances, two ranks of half the batch against one process on all
# of it: each metric over its own size, each update's reduced gradients
# over their largest entry.  The card showed (H100 80GB HBM3, 700.00 W,
# this phase alone): the flagship (bf16) 5.0e-5 and 2.1e-3, TAR (bf16
# attention) 4.7e-6 and 3.7e-4, the VQ-VAE (f32) 7.0e-8 and 9.2e-8; cuDNN
# picks its algorithms at the half batch and bf16 rounds the activations
# (tests/test_torch_parallel_dp.py holds the CPU's float32 to 1e-5)
PARALLEL_TOL = {"flagship": (5e-4, 1e-2), "tar": (1e-4, 2e-3), "vqvae_ema": (1e-5, 1e-5)}
# (d) the model axis and the Switch-MoE's global routing, the same two gloo
# ranks: name, overrides, global batch, make_mesh keywords, hand-kernel
# launches a step.  FSDP on one data rank is the one-process step bit for
# bit; tensor parallelism sums each row layer's two halves (f32, TF32 off);
# the MoE routes the global batch's tokens from two ranks' halves
PARALLEL_MODEL_AXIS = (
    ("fsdp_flagship", ["experiment=ddpm/cifar10"], TRAIN_BATCH, dict(model=2),
     PARALLEL_MODELS[0][3]),
    ("tensor_dit", ["experiment=ddpm/cifar10_dit", "model.compute_dtype=float32"], 32,
     dict(model=2, mode="tensor"), {}),
    ("moe_dit", ["experiment=ddpm/cifar10_dit", "model.compute_dtype=float32",
                 *DIT_MOE_OVERRIDES], 16, dict(), {}),
    # the pipeline: each rank one stage of 4 blocks, 2 microbatches of 16
    ("pipeline_dit", ["experiment=ddpm/cifar10_dit", "model.compute_dtype=float32"], 32,
     dict(stage=2, microbatches=2), {}),
    # Megatron-SP on the tensor mesh: 128 of the 256 tokens a rank between GEMMs
    ("sequence_dit", ["experiment=ddpm/cifar10_dit", "model.compute_dtype=float32"], 32,
     dict(model=2, mode="tensor", sequence=True), {}),
)
# (the card showed, H100 80GB HBM3, 700.00 W: tensor 0 and 5.3e-7, the
# MoE 1.1e-7 and 4.9e-7; DiT weights moved off adaLN-Zero, _mesh_state)
PARALLEL_TOL.update({"fsdp_flagship": (0.0, 0.0), "tensor_dit": (1e-6, 5e-6),
                     "moe_dit": (1e-6, 5e-6), "pipeline_dit": (1e-6, 1e-5),
                     "sequence_dit": (1e-6, 1e-5)})
# (c): DDIM-50 over 64 images, two ranks of 32 against one process on 64:
# bit for bit against one process on each half of the same x_T, which is
# what one process gives at a batch of 32.  Against the batch of 64 the
# seeded (untrained) bf16 UNet's outputs at another batch part in the last
# bits, and the first step divides them by sqrt(alphas_cumprod[T-1]):
# pixels land up to 1.67 apart (H100 80GB HBM3, 700.00 W), so the mean absolute
# difference over the images is held, the largest reported.  That card read
# a mean of 0.00203 in two whole runs; the limit is five times it
PARALLEL_SAMPLE_MEAN_ATOL = 1e-2


def _parallel_model(overrides, device="cuda"):
    from igm_tpu_torch.config import compose, instantiate
    cfg = compose(REPO / "configs", [*overrides, "print_config=False"])
    model = instantiate(cfg.model, datamodule=cfg.datamodule, device=device)
    model.steps_per_epoch = 1000
    return model


def _axis_model(overrides, device, mesh_kw):
    """(the model of ``overrides``, its mesh from ``mesh_kw``): make_mesh's
    keywords, and ``microbatches`` and ``sequence``, with which the model
    is rebuilt for the pipeline or the sequence split, as the trainer
    does (``Trainer.prepare_model``)."""
    from igm_tpu_torch.parallel.mesh import make_mesh
    kw = {k: v for k, v in mesh_kw.items() if k not in ("microbatches", "sequence")}
    mesh = make_mesh(devices=device, **kw)
    model = _parallel_model(overrides, device)
    if mesh.mode == "pipeline":
        model.enable_pipeline(mesh, mesh_kw.get("microbatches", 1))
    if mesh_kw.get("sequence"):
        model.enable_sequence_parallel(mesh)
    return model, mesh


def _mesh_state(model, mesh, overrides):
    """``model``'s train state on ``mesh`` (None: one process) from
    init_state(0); a DiT's (its adaLN gates start at 0 and would hide the
    blocks and the MoE's routing from a step) from the whole init moved by
    0.05 N(0, 1), seed 1, the same on every rank."""
    import torch
    weights = None
    if "experiment=ddpm/cifar10_dit" in overrides:
        model.init_state(0)
        gen = torch.Generator().manual_seed(1)
        names = {k for k, _ in model.modules.named_parameters()}
        weights = {k: (v.cpu() + 0.05 * torch.randn(v.shape, generator=gen).to(v.dtype)
                       if k in names else v.cpu())
                   for k, v in model.modules.state_dict().items()}
    model.set_mesh(mesh)
    state = model.init_state(0)
    if weights is not None:
        state.load_state_dict({**state.full_state_dict(), "params": weights})
    return state


def _dp_steps(model, state, batch, steps: int) -> dict:
    """``steps`` eager train steps on ``batch`` as the trainer runs them
    (``train_step_n``; under gloo eagerly): each step's metrics (averaged
    over the ranks on a mesh) and hand-kernel launches, each update's
    gradients after the reduction over the ranks, the state_dict after."""
    import torch
    from igm_tpu_torch.parallel.sharding import gather_whole
    opts = model.optimizers
    updates = []
    reduce = opts.reduce_grads

    def recorded(gs, params=()):
        out = reduce(gs, params)
        whole = [g if getattr(p, "_igm_leaf", None) is None
                 else gather_whole(model.mesh, p._igm_leaf, g) for g, p in zip(out, params)]
        updates.append([g.detach().float().cpu() for g in whole])
        return out

    opts.reduce_grads = recorded
    chunk = tuple(b[None] for b in batch)
    metrics, launches = [], []
    for _ in range(steps):
        before = counts()
        state, m = model.train_step_n(state, chunk, graph=False)
        torch.cuda.synchronize()
        launches.append(since(before))
        metrics.append({k: float(v) for k, v in m.items()})
    del opts.reduce_grads
    params = state.full_state_dict()["params"]
    return {"metrics": metrics, "launches": launches, "updates": updates,
            "state": {k: v.detach().cpu() for k, v in params.items()}}


def _state_bytes(state) -> int:
    """The bytes of every tensor a train state keeps between steps on this
    rank: parameters, buffers, optimizer state, the EMA shadow."""
    import torch

    def walk(obj):
        if isinstance(obj, torch.Tensor):
            return obj.numel() * obj.element_size()
        if isinstance(obj, dict):
            return sum(walk(v) for v in obj.values())
        if isinstance(obj, (list, tuple)):
            return sum(walk(v) for v in obj)
        return 0
    saved = state.state_dict()
    return walk(saved["params"]) + walk(saved["opt_states"])


def _moe_dropped(model) -> list:
    """Forward hooks on the model's Switch-MoE blocks: each forward appends
    the global batch's dropped tokens, from the routed fractions it
    returns (the global ``f`` on a mesh) and the capacity."""
    seen = []

    def hook(moe, args, out):
        n = args[0].shape[0] * args[0].shape[1] * (1 if moe.mesh is None else moe.mesh.world)
        routed = (out[2].detach().double() * n).round()
        seen.append(int(n - routed.clamp(max=moe.capacity(n)).sum().item()))

    from igm_tpu_torch.networks.moe import SwitchMoE
    for module in model.modules.modules():
        if isinstance(module, SwitchMoE):
            module.register_forward_hook(hook)
    return seen


def _parallel_rank(device, out_dir: str) -> None:
    """One of (b)'s gloo ranks (spawned, sharing the card): each model of
    PARALLEL_MODELS from init_state(0), its rows of the seeded global
    batch, PARALLEL_DP_STEPS steps recorded; then DDIM-50 over 64 images
    through sample_sharded.  Records saved in ``out_dir``."""
    import torch
    from igm_tpu_torch.parallel.mesh import make_mesh, sample_sharded
    from igm_tpu_torch.utils.platform import set_numerics
    set_numerics()
    mesh = make_mesh(devices=device)
    out = Path(out_dir)
    for name, overrides, batch, _ in PARALLEL_MODELS:
        model = _parallel_model(overrides, device)
        model.set_mesh(mesh)
        state = model.init_state(0)
        rows = torch.from_numpy(mesh.local_rows(batch, model.batch_blocks)).to(device)
        local = tuple(b[0][rows] for b in _chain_batches(model, batch, 1, 21))
        record = _dp_steps(model, state, local, PARALLEL_DP_STEPS)
        record["jax"] = "jax" in sys.modules
        torch.save(record, out / f"{name}.rank{mesh.rank}.pt")
        del model, state
        _release()
    for name, overrides, batch, mesh_kw, _ in PARALLEL_MODEL_AXIS:
        t0 = time.perf_counter()
        model, axis_mesh = _axis_model(overrides, device, mesh_kw)
        state = _mesh_state(model, axis_mesh, overrides)
        rows = torch.from_numpy(axis_mesh.local_rows(batch)).to(device)
        local = tuple(b[0][rows] for b in _chain_batches(model, batch, 1, 21))
        dropped = _moe_dropped(model)
        record = _dp_steps(model, state, local, PARALLEL_DP_STEPS)
        record.update(jax="jax" in sys.modules, dropped=dropped, bytes=_state_bytes(state),
                      seconds=time.perf_counter() - t0,
                      sharded=sum(leaf.sharded for leaf in (model.sharding.leaves
                                                            if model.sharding else [])))
        torch.save(record, out / f"{name}.rank{torch.distributed.get_rank()}.pt")
        del model, state
        _release()
    model = _parallel_model(["experiment=ddpm/cifar10"], device)
    gen = torch.Generator(device).manual_seed(0)
    before = counts()
    imgs = sample_sharded(model, mesh, None, gen, PARALLEL_SAMPLE_N, sampler="ddim_sample",
                          steps=PARALLEL_SAMPLE_STEPS)
    torch.save({"imgs": imgs.cpu(), "launches": since(before)},
               out / f"sample.rank{mesh.rank}.pt")


def _rel_err(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-12)


def parallel_compare(name: str, ranks: list, ref: dict, per_step: dict,
                     run: str = "two_ranks", tol=None) -> dict:
    """(b): every rank ends in the same state bit for bit and reports the
    same metrics; against one process, each metric and each update's
    reduced gradients within PARALLEL_TOL; each rank's launches a step
    exactly the one-process step's, which are the model's own."""
    import torch
    metric_tol, grad_tol = PARALLEL_TOL[name] if tol is None else tol
    check(not any(r["jax"] for r in ranks), f"parallel {name}: a rank imported jax")
    for r in ranks[1:]:
        diff = same_bits(r["state"], ranks[0]["state"], name)
        check(not diff, f"parallel {name}: the ranks' states differ at {diff[:4]}")
        check(r["metrics"] == ranks[0]["metrics"], f"parallel {name}: the ranks' metrics differ")
    want_launches = [expected(**per_step)] * len(ref["launches"])
    check(ref["launches"] == want_launches,
          f"parallel {name}: one process launched {ref['launches']}, not {want_launches}")
    for r, rec in enumerate(ranks):
        check(rec["launches"] == ref["launches"],
              f"parallel {name}: rank {r} launched {rec['launches']}, one process "
              f"{ref['launches']}")
    got = ranks[0]
    metric_err = max(_rel_err(got["metrics"][i][k], v) for i, m in enumerate(ref["metrics"])
                     for k, v in m.items() if math.isfinite(v))
    check(len(got["updates"]) == len(ref["updates"]), f"parallel {name}: update counts")
    grad_err = [max(float((g - w).abs().max()) for g, w in zip(gs, ws))
                / max(float(w.abs().max()) for w in ws)
                for gs, ws in zip(got["updates"], ref["updates"])]
    out = dict(metric_rel_err=metric_err, grad_err_over_largest=grad_err,
               launches_a_step=dict(zip(KERNELS, ref["launches"][0])),
               metrics=got["metrics"], metrics_one_process=ref["metrics"])
    emit("parallel", run=f"{run}_{name}", **out)
    check(metric_err <= metric_tol, f"parallel {name}: metrics {metric_err:.3g} off "
                                    f"(tolerance {metric_tol})")
    check(max(grad_err) <= grad_tol, f"parallel {name}: gradients {max(grad_err):.3g} of "
                                     f"the largest off (tolerance {grad_tol})")
    return out


def _graphed_ms(model, state, chunk, n: int) -> float:
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        state, _ = model.train_step_n(state, chunk)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / n


def phase_parallel() -> dict:
    """The data axis; the caller zeroes the counters before it.  (b)'s two
    gloo ranks run in a thread's spawn while this process runs (a), (c)'s
    NCCL rank and (b)'s one-process references on the same card; (a)'s
    timing waits for the ranks to end.  Returns the phase's launches: this
    process's and every rank's."""
    import datetime
    import shutil
    import threading
    import torch
    import torch.distributed as dist
    from igm_tpu_torch.parallel import launch
    from igm_tpu_torch.parallel.mesh import make_mesh, sample_sharded
    out, failed = {}, []
    tmp = Path(tempfile.mkdtemp(prefix="parallel-"))

    def ranks():
        try:
            launch.spawn(_parallel_rank, PARALLEL_WORLD, torch.device("cuda"), (str(tmp),),
                         timeout=PARALLEL_TIMEOUT_S)
        except BaseException as exc:      # re-raised by the phase below
            failed.append(exc)

    spawner = threading.Thread(target=ranks)
    spawner.start()
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{launch.free_port()}",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=launch.TIMEOUT_S))
    try:
        mesh = make_mesh(devices="cuda")
        check(mesh.backend == "nccl" and mesh.capturable and mesh.world == 1,
              f"parallel: the NCCL mesh is {mesh}")
        # (a) the flagship's graphed K = 1 steps, without a group and on the NCCL rank
        models = {}
        for key, m in (("plain", None), ("nccl", mesh)):
            model = _parallel_model(["experiment=ddpm/cifar10"])
            model.set_mesh(m)
            models[key] = (model, model.init_state(0))
        chunk = _chain_batches(models["plain"][0], TRAIN_BATCH, 1, 17)
        metrics = {key: [{k: float(v) for k, v in model.train_step_n(state, chunk)[1].items()}
                         for _ in range(PARALLEL_STEPS)]
                   for key, (model, state) in models.items()}
        torch.cuda.synchronize()
        diff = same_bits(models["plain"][1].state_dict(), models["nccl"][1].state_dict())
        check(not diff, f"parallel: the NCCL rank's graphed steps differ at {diff[:4]}")
        check(metrics["plain"] == metrics["nccl"], "parallel: the NCCL rank's metrics differ")
        n_graphs = len(models["nccl"][1].graphs)
        check(n_graphs == 1, f"parallel: {n_graphs} graphs captured on the NCCL rank")
        # (c) DDIM-50 over 64 images from the seeded init: one process, the NCCL
        # rank through sample_sharded, and one process on each half of x_T
        fresh = _parallel_model(["experiment=ddpm/cifar10"])
        want = fresh.ddim_sample(PARALLEL_SAMPLE_N, steps=PARALLEL_SAMPLE_STEPS,
                                 generator=torch.Generator("cuda").manual_seed(0))
        got = sample_sharded(fresh, mesh, None, torch.Generator("cuda").manual_seed(0),
                             PARALLEL_SAMPLE_N, sampler="ddim_sample",
                             steps=PARALLEL_SAMPLE_STEPS)
        check(torch.equal(got, want), "parallel: sample_sharded on the NCCL rank differs "
                                      "from the one-process DDIM-50")
        x_t = torch.randn((PARALLEL_SAMPLE_N, fresh.height, fresh.width, fresh.channels),
                          generator=torch.Generator("cuda").manual_seed(0), device="cuda")
        half = PARALLEL_SAMPLE_N // PARALLEL_WORLD
        halves = torch.cat([fresh.ddim_sample(half, steps=PARALLEL_SAMPLE_STEPS,
                                              x_T=x_t[r * half:(r + 1) * half])
                            for r in range(PARALLEL_WORLD)]).cpu()
        want = want.cpu()
        del fresh
        # (b)'s references: one process on the whole global batch
        refs = {}
        for name, overrides, batch, *_ in PARALLEL_MODELS + PARALLEL_MODEL_AXIS:
            ref_model = _parallel_model(overrides)
            state = _mesh_state(ref_model, None, overrides)
            glob = tuple(b[0] for b in _chain_batches(ref_model, batch, 1, 21))
            dropped = _moe_dropped(ref_model)
            refs[name] = _dp_steps(ref_model, state, glob, PARALLEL_DP_STEPS)
            refs[name].update(dropped=dropped, bytes=_state_bytes(state))
            del ref_model, state, glob
            _release()
        spawner.join()
        if failed:
            raise failed[0]
        out["seconds_to_ranks_end"] = time.perf_counter() - t0
        emit("parallel", run="ranks", seconds_to_ranks_end=out["seconds_to_ranks_end"])
        # (a)'s timing, the card quiet again: plain, NCCL, NCCL, plain
        ms = {"plain": [], "nccl": []}
        for key in ("plain", "nccl", "nccl", "plain"):
            ms[key].append(_graphed_ms(*models[key], chunk, PARALLEL_TIMED))
        out["nccl_graphed"] = dict(batch=TRAIN_BATCH, steps=PARALLEL_STEPS, bit_for_bit=True,
                                   timed_steps=PARALLEL_TIMED, ms_per_step_abba=ms)
        emit("parallel", run="nccl_world_one", **out["nccl_graphed"])
        del models, chunk
        launch.leave_group()         # the graphs that captured NCCL collectives first
    finally:
        spawner.join()
    launches = counts()
    for name, _, _, per_step in PARALLEL_MODELS:
        recs = [torch.load(tmp / f"{name}.rank{r}.pt", weights_only=False)
                for r in range(PARALLEL_WORLD)]
        out[name] = parallel_compare(name, recs, refs[name], per_step)
        for rec in recs:
            for step in rec["launches"]:
                launches = add(launches, step)
    for name, _, batch, mesh_kw, per_step in PARALLEL_MODEL_AXIS:
        recs = [torch.load(tmp / f"{name}.rank{r}.pt", weights_only=False)
                for r in range(PARALLEL_WORLD)]
        out[name] = parallel_compare(name, recs, refs[name], per_step, run="model_axis")
        out[name].update(mesh=mesh_kw, batch=batch, sharded_leaves=recs[0]["sharded"],
                         rank_seconds=max(r["seconds"] for r in recs),
                         state_bytes_by_rank=[r["bytes"] for r in recs],
                         one_process_state_bytes=refs[name]["bytes"])
        if name == "fsdp_flagship":     # one data rank: nothing summed in another order
            diff = same_bits(recs[0]["state"], refs[name]["state"])
            check(not diff, f"parallel {name}: the state differs from one process at {diff[:4]}")
            check(recs[0]["metrics"] == refs[name]["metrics"],
                  f"parallel {name}: the metrics differ from one process")
            check(all(r["bytes"] < refs[name]["bytes"] for r in recs),
                  f"parallel {name}: a rank keeps the whole state")
            out[name]["bit_for_bit"] = True
        if name in ("pipeline_dit", "sequence_dit"):
            check(all(r["bytes"] < refs[name]["bytes"] for r in recs),
                  f"parallel {name}: a rank keeps the whole state")
        if name == "moe_dit":
            check(recs[0]["dropped"] == refs[name]["dropped"] and sum(recs[0]["dropped"]) > 0,
                  f"parallel {name}: dropped {recs[0]['dropped']}, one process "
                  f"{refs[name]['dropped']}")
            out[name]["dropped_tokens_by_forward"] = recs[0]["dropped"]
        emit("parallel", run=f"model_axis_{name}_summary",
             **{k: v for k, v in out[name].items() if k not in ("metrics",
                                                               "metrics_one_process")})
        for rec in recs:
            for step in rec["launches"]:
                launches = add(launches, step)
    samples = [torch.load(tmp / f"sample.rank{r}.pt", weights_only=False)
               for r in range(PARALLEL_WORLD)]
    shutil.rmtree(tmp, ignore_errors=True)
    for s in samples:
        launches = add(launches, s["launches"])
    check(all(torch.equal(s["imgs"], samples[0]["imgs"]) for s in samples),
          "parallel: the ranks' gathered samples differ")
    check(torch.equal(samples[0]["imgs"], halves),
          "parallel: sample_sharded over two ranks differs from one process on each half")
    diff = (samples[0]["imgs"] - want).abs()
    err = float(diff.mean())
    out["sample_sharded"] = dict(n=PARALLEL_SAMPLE_N, steps=PARALLEL_SAMPLE_STEPS,
                                 nccl_bit_for_bit=True, two_ranks_halves_bit_for_bit=True,
                                 two_ranks_mean_abs_err_vs_batch_64=err,
                                 two_ranks_max_abs_err_vs_batch_64=float(diff.max()),
                                 mean_atol=PARALLEL_SAMPLE_MEAN_ATOL)
    emit("parallel", run="sample_sharded", **out["sample_sharded"])
    check(err <= PARALLEL_SAMPLE_MEAN_ATOL,
          f"parallel: sample_sharded {err:.3g} (mean absolute) off the one-process DDIM-50 "
          f"at 64 (tolerance {PARALLEL_SAMPLE_MEAN_ATOL})")
    out["launches"] = launches
    return out



# ------------------------------------------------------ phase parallel_cards
# every card of the host (--only parallel_cards; the default run needs one
# card and leaves it out): one NCCL rank a card, graphed
CARDS_BATCH = 256                    # rows a batch rank: the global batch is this x its ranks
CARDS_STEPS = 3                      # graphed steps checked after the eager one
CARDS_TIMED = 20
CARDS_FIT_EPOCHS = 2
CARDS_FIT_BATCH = 64                 # rows a rank in the CLI fit
# name, overrides, make_mesh keywords, rows a batch rank, tolerance key
CARDS_CASES = (
    ("data_flagship", ["experiment=ddpm/cifar10"], dict(), CARDS_BATCH, "flagship"),
    ("fsdp_flagship", ["experiment=ddpm/cifar10"], dict(model=2), CARDS_BATCH, "flagship"),
    ("tensor_dit", ["experiment=ddpm/cifar10_dit"], dict(model=2, mode="tensor"),
     CARDS_BATCH, "dit_bf16"),
    ("composed_dit", ["experiment=ddpm/cifar10_dit"], dict(fsdp=2, model=2, mode="tensor"),
     CARDS_BATCH, "dit_bf16"),
    ("moe_dit", ["experiment=ddpm/cifar10_dit", *DIT_MOE_OVERRIDES], dict(), 64, "dit_bf16"),
    ("pipeline_dit_1x4", ["experiment=ddpm/cifar10_dit"], dict(stage=4, microbatches=4),
     CARDS_BATCH, "dit_bf16"),
    ("pipeline_dit_2x2", ["experiment=ddpm/cifar10_dit"],
     dict(data=2, stage=2, microbatches=4), CARDS_BATCH, "dit_bf16"),
    ("sequence_dit_1x4", ["experiment=ddpm/cifar10_dit"],
     dict(model=4, mode="tensor", sequence=True), CARDS_BATCH, "dit_bf16"),
    ("sequence_dit_2x2", ["experiment=ddpm/cifar10_dit"],
     dict(model=2, mode="tensor", sequence=True), CARDS_BATCH, "dit_bf16"),
)
# bf16 DiT steps on a mesh against one card on the global batch: cuBLAS
# picks its GEMMs at the rank's rows and bf16 rounds the partial sums of a
# row layer before they are added.  Four cards showed (H100 80GB HBM3,
# 700.00 W, the weights of _mesh_state): metrics 1.6e-5 (tensor, composed)
# and 0 (the MoE) apart, gradients 1.8e-3 and 8.4e-4 of the largest
PARALLEL_TOL["dit_bf16"] = (1e-4, 1e-2)


def _cards_rank(device, out_dir: str) -> None:
    """One NCCL rank of phase parallel_cards, each case of CARDS_CASES in
    turn on its mesh: the model from init_state(0), its rows of the seeded
    global batch; one eager step recorded (the reduced gradients, whole),
    CARDS_STEPS graphed steps (the collectives inside the graph), then
    CARDS_TIMED graphed steps timed; the state's bytes and the peak memory."""
    import torch
    from igm_tpu_torch.utils.platform import set_numerics
    set_numerics()
    for name, overrides, mesh_kw, rows_per, _ in CARDS_CASES:
        torch.cuda.reset_peak_memory_stats(device)
        model, mesh = _axis_model(overrides, device, mesh_kw)
        state = _mesh_state(model, mesh, overrides)
        glob = _chain_batches(model, rows_per * mesh.world, 1, 23)
        rows = torch.from_numpy(mesh.local_rows(rows_per * mesh.world)).to(device)
        local = tuple(b[0][rows] for b in glob)
        record = _dp_steps(model, state, local, 1)
        chunk = tuple(b[None] for b in local)
        record["graphed_metrics"] = [
            {k: float(v) for k, v in model.train_step_n(state, chunk)[1].items()}
            for _ in range(CARDS_STEPS)]
        record["ms_per_step"] = _graphed_ms(model, state, chunk, CARDS_TIMED)
        record.update(graphs=len(state.graphs), capturable=mesh.capturable,
                      jax="jax" in sys.modules,
                      bytes=_state_bytes(state), global_batch=rows_per * mesh.world,
                      peak_bytes=torch.cuda.max_memory_allocated(device),
                      graphed_state=state.full_state_dict()["params"])
        torch.save(record, Path(out_dir) / f"{name}.rank{torch.distributed.get_rank()}.pt")
        del model, state, glob, local, chunk
        _release()


def phase_parallel_cards() -> dict:
    """Every card of the host, one NCCL rank each (spawned), each case of
    CARDS_CASES (the data axis, FSDP (2, 2) and the flagship, tensor
    (2, 2) and composed (1, 2, 2) on the DiT in bf16, the MoE DiT on four
    data ranks): the eager step against one process on card 0 on the
    whole global batch (metrics and reduced gradients within
    PARALLEL_TOL, launches a step exactly the one-process step's); then
    CARDS_STEPS graphed steps with the collectives in the graph, every
    rank's whole state equal bit for bit; the graphed step's ms, the
    images/s, each rank's state bytes and peak memory against one card's
    on the global batch; then the train CLI with trainer.devices=-1 (every
    card) for CARDS_FIT_EPOCHS epochs of CARDS_FIT_BATCH rows a rank on
    the synthetic set: rank 0's checkpoints, an epoch's each, at the steps
    one process would reach."""
    import shutil
    import torch
    from igm_tpu_torch.parallel import launch
    cards = torch.cuda.device_count()
    check(cards > 1, f"parallel_cards needs more than one card, found {cards}")
    out = {"cards": cards}
    tmp = Path(tempfile.mkdtemp(prefix="parallel-cards-"))
    t0 = time.perf_counter()
    launch.spawn(_cards_rank, cards, torch.device("cuda"), (str(tmp),),
                 timeout=PARALLEL_TIMEOUT_S * len(CARDS_CASES))
    out["seconds_ranks"] = time.perf_counter() - t0
    for name, overrides, mesh_kw, rows_per, tol in CARDS_CASES:
        recs = [torch.load(tmp / f"{name}.rank{r}.pt", weights_only=False)
                for r in range(cards)]
        for r in recs[1:]:
            diff = same_bits(r["graphed_state"], recs[0]["graphed_state"])
            check(not diff, f"parallel_cards {name}: the ranks' states differ at {diff[:4]}")
        # a pipelined step is eager by rule (Mesh.capturable): no graph
        want_graphs = [int(r["capturable"]) for r in recs]
        check([r["graphs"] for r in recs] == want_graphs,
              f"parallel_cards {name}: graphs {[r['graphs'] for r in recs]}, not {want_graphs}")
        n = recs[0]["global_batch"]
        torch.cuda.reset_peak_memory_stats()
        model = _parallel_model(overrides)
        state = _mesh_state(model, None, overrides)
        glob = tuple(b[0] for b in _chain_batches(model, n, 1, 23))
        ref = _dp_steps(model, state, glob, 1)
        per_step = PARALLEL_MODELS[0][3] if "flagship" in name else {}
        row = parallel_compare(name, recs, ref, per_step, run=f"{cards}_cards",
                               tol=PARALLEL_TOL[tol])
        chunk = tuple(b[None] for b in glob)
        for _ in range(2):
            model.train_step_n(state, chunk)
        one_ms = _graphed_ms(model, state, chunk, CARDS_TIMED)
        ms = [r["ms_per_step"] for r in recs]
        row.update(mesh=mesh_kw, global_batch=n, graphed=bool(recs[0]["capturable"]),
                   ms_per_step_by_rank=ms,
                   one_card_ms_per_step_global_batch=one_ms,
                   images_per_s=n / (max(ms) / 1e3), one_card_images_per_s=n / (one_ms / 1e3),
                   state_bytes_by_rank=[r["bytes"] for r in recs],
                   one_card_state_bytes=_state_bytes(state),
                   peak_bytes_by_rank=[r["peak_bytes"] for r in recs],
                   one_card_peak_bytes=torch.cuda.max_memory_allocated())
        out[name] = row
        emit("parallel_cards", run=f"graphed_{name}",
             **{k: v for k, v in row.items() if k not in ("metrics", "metrics_one_process")})
        del model, state, glob, chunk
        _release()
    shutil.rmtree(tmp, ignore_errors=True)
    fit = Path(tempfile.mkdtemp(prefix="parallel-cards-fit-"))
    from igm_tpu_torch.config import compose, instantiate
    dm = instantiate(compose(REPO / "configs", ["experiment=ddpm/cifar10",
                                                f"datamodule.data_dir={fit / 'data'}"]).datamodule)
    dm.prepare_data()
    dm.setup()
    # _train_cli's limit of 3 batches an epoch; a checkpoint an epoch
    per_epoch = min(3, len(dm.train_arrays()[0]) // (CARDS_FIT_BATCH * cards))
    want = {f"step_{per_epoch * (e + 1)}.pt" for e in range(CARDS_FIT_EPOCHS)}
    t0 = time.perf_counter()
    _train_cli(fit, "trainer.devices=-1", f"trainer.max_epochs={CARDS_FIT_EPOCHS}",
               "trainer.limit_val_batches=0", f"datamodule.batch_size={CARDS_FIT_BATCH * cards}",
               "callbacks=null")
    saved = sorted(p.name for p in (fit / "logs/runs/ddpm/cifar10/checkpoints").iterdir())
    check(set(saved) == want, f"parallel_cards: the fit saved {saved}, not {sorted(want)}")
    out["fit"] = dict(seconds=time.perf_counter() - t0, checkpoints=saved)
    emit("parallel_cards", run="fit", **out["fit"])
    shutil.rmtree(fit, ignore_errors=True)
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
                         "split over a cluster of up to 8 CTAs; past D = 216 the same tiles "
                         "with z and the codes in 32-feature chunks through two cp.async "
                         "stages, the scores kept across chunks, clusters aimed at 3 CTAs "
                         "an SM", "nearest_codebook"),
    "fused_block_fwd": ("bf16: an implicit GEMM on mma.sync (8 warps of 64 positions x 32 "
                        "channels, a CTA all Cout), the halo and weights of 16 input "
                        "channels by cp.async in two stages, a sample's tiles one cluster "
                        "summing the group statistics in rank order through DSMEM, "
                        "normalised in registers; two-pass (y in f32 and tile partials, then "
                        "a normalising kernel) past 8 tiles a sample; f32 on FMAs",
                        "fused_block_"),
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
PHASE_SECONDS: dict = {}


def timed(name: str, phase):
    """Run a phase; print and keep its seconds."""
    t0 = time.perf_counter()
    out = phase()
    PHASE_SECONDS[name] = time.perf_counter() - t0
    emit("seconds", name=name, seconds=PHASE_SECONDS[name])
    return out


# phases that run alone with --only (a rehearsal of a changed phase)
ALONE = {"unet": lambda: phase_unet(), "slice": lambda: phase_slice(),
         "train_unet": lambda: phase_train_unet(), "train": lambda: phase_train(),
         "first_stage": lambda: phase_first_stage(), "latent": lambda: phase_latent(),
         "tar_reference": lambda: phase_tar_reference(), "tar": lambda: phase_tar(),
         "fused_block": lambda: phase_fused_block(), "chain": lambda: phase_chain(),
         "parity_vq": lambda: parity_vq(), "dit": lambda: phase_dit(),
         "families": lambda: phase_families(), "likelihood": lambda: phase_likelihood(),
         "vae": lambda: phase_vae(), "gan": lambda: phase_gan(),
         "serve": lambda: phase_serve(), "scores": lambda: phase_scores(),
         "parallel": lambda: phase_parallel(),
         "parallel_cards": lambda: phase_parallel_cards()}


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
    usage = timed("build", phase_build)
    if args.only:
        for name in args.only:
            reset_counts()
            timed(name, ALONE[name])
        emit("only", phases=args.only, seconds=time.perf_counter() - T_START)
        return 0
    t_parity = time.perf_counter()
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
    PHASE_SECONDS["parity"] = time.perf_counter() - t_parity
    emit("seconds", name="parity", seconds=PHASE_SECONDS["parity"])
    timed("unet", phase_unet)
    sl = timed("slice", phase_slice)    # the sampling path: zeroes, then reads
    check_path("sampling", sl["launches"])
    timed("train_unet", phase_train_unet)
    reset_counts()                      # the training path
    tr = timed("train", phase_train)
    tr_launches = counts()
    check_path("training", tr_launches)
    emit("train", run="path", launches=dict(zip(KERNELS, tr_launches)))
    timed("first_stage", phase_first_stage)
    reset_counts()                      # the VQ-VAE -> latent-DDPM path
    lat = timed("latent", phase_latent)
    lat_launches = counts()
    check_path("latent", lat_launches)
    emit("latent", run="path", launches=dict(zip(KERNELS, lat_launches)))
    timed("tar_reference", phase_tar_reference)
    reset_counts()                      # the TAR path
    tar = timed("tar", phase_tar)
    tar_launches = counts()
    check_path("tar", tar_launches)
    emit("tar", run="path", launches=dict(zip(KERNELS, tar_launches)))
    reset_counts()                      # the fused-block bench tool
    fb = timed("fused_block", phase_fused_block)
    fb_launches = counts()
    check_path("fused_block", fb_launches)
    path_launches = {"sampling": sl["launches"], "training": tr_launches,
                     "latent": lat_launches, "tar": tar_launches,
                     "fused_block": fb_launches}
    # row 4 is wired into no model: no other path may launch it
    fb_index = KERNELS.index("fused_block_fwd")
    elsewhere = {p: n[fb_index] for p, n in path_launches.items() if p != "fused_block"}
    check(not any(elsewhere.values()), f"fused_block_fwd launched on {elsewhere}")
    reset_counts()                      # the DiT, EDM and flow matching paths
    dit = timed("dit", phase_dit)
    check_path("edm_flow_unet", dit["launches"]["edm_flow_unet"])
    path_launches.update(dit["launches"])
    reset_counts()                      # the score-SDE, consistency and distillation paths
    fam = timed("families", phase_families)
    check_path("families", fam["launches"])
    path_launches["families"] = fam["launches"]
    reset_counts()                      # MADE, PixelCNN and RealNVP
    lik = timed("likelihood", phase_likelihood)
    check_path("likelihood", lik["launches"])
    path_launches["likelihood"] = lik["launches"]
    reset_counts()                      # VAE, beta-VAE, cVAE and FactorVAE
    vae = timed("vae", phase_vae)
    check_path("vae", vae["launches"])
    path_launches["vae"] = vae["launches"]
    reset_counts()                      # the adversarial zoo
    gan = timed("gan", phase_gan)
    check_path("gan", gan["launches"])
    path_launches["gan"] = gan["launches"]
    reset_counts()                      # export, HTTP serving, eval_fid, a multirun
    srv = timed("serve", phase_serve)
    check_path("serve", srv["launches"])
    path_launches["serve"] = srv["launches"]
    sc = timed("scores", phase_scores)  # zeroes before score_conditional, reads after
    check_path("scores", sc["launches"])
    path_launches["scores"] = sc["launches"]
    chain = timed("chain", phase_chain)  # graphed against eager
    reset_counts()                      # the data axis: NCCL rank, two gloo ranks
    par = timed("parallel", phase_parallel)
    check_path("parallel", par["launches"])
    path_launches["parallel"] = par["launches"]

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
    fb_main = [r for r in fb_rows if r["dtype"] == "bfloat16" and r["flagship"]
               and "kernel_ms" in r]
    kernels.append(dict(
        name="fused_block_fwd", route="cuda", source="igm_tpu_torch/csrc/fused_block.cu",
        replaces="igm_tpu/ops/pallas_fused_block.py:105", launches=sum(by_path(fb_index).values()),
        launches_by_path=by_path(fb_index), max_abs_err=max(r["max_abs_err"] for r in fb_rows),
        ms=sum(r["kernel_ms"] for r in fb_main), plain_ms=sum(r["plain_ms"] for r in fb_main),
        block_ms=sum(r["block_ms"] for r in fb_main),
        bound_ms=sum(r["bound_ms"] for r in fb_main),
        bound_by="bytes" if sum(r["bound_terms_ms"]["bytes"] for r in fb_main)
        >= sum(r["bound_terms_ms"]["products"] for r in fb_main) else "operations",
        library_ms=None, design=REDESIGNED["fused_block_fwd"][0],
        ptxas={k: v for k, v in usage["fused_block"].items()
               if k.startswith(REDESIGNED["fused_block_fwd"][1])},
        shapes=[{key: r.get(key) for key in ("shape", "dtype", "route", "kernel_ms", "plain_ms",
                                             "block_ms", "bound_ms", "max_abs_err")}
                for r in fb_rows if "kernel_ms" in r],
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
         dit_train_ms_per_step={k: v["ms_per_step"] for k, v in dit["train"].items()},
         dit_attention_core_ms_per_step=dit["attention_core"]["ms_per_step"],
         dit_sampling_images_per_s={k: v["images_per_s"] for k, v in dit["samplers"].items()},
         families_train_ms_per_step={k: v["ms_per_step"] for k, v in fam["train"].items()},
         families_sampling_images_per_s={k: v["images_per_s"]
                                         for k, v in fam["samplers"].items()},
         likelihood_train_images_per_s={k: v["images_per_s"]
                                        for k, v in lik["train"].items()},
         likelihood_sampling_images_per_s={k: v["sample"]["images_per_s"]
                                           for k, v in lik["train"].items()},
         vae_train_ms_per_step={k: v["ms_per_step"] for k, v in vae["train"].items()},
         vae_train_images_per_s={k: v["images_per_s"] for k, v in vae["train"].items()},
         vae_sampling_images_per_s={k: v["sample"]["images_per_s"]
                                    for k, v in vae["train"].items()},
         gan_train_ms_per_step={k: v["ms_per_step"] for k, v in gan["train"].items()},
         gan_train_images_per_s={k: v["images_per_s"] for k, v in gan["train"].items()},
         gan_sampling_images_per_s={k: v["sample"]["images_per_s"]
                                    for k, v in gan["train"].items()},
         serve_p50_ms=srv["http"]["stats"]["p50_ms"],
         serve_p95_ms=srv["http"]["stats"]["p95_ms"],
         serve_images_per_s=srv["http"]["stats"]["samples_per_sec"],
         serve_http_requests_per_s=srv["bench"]["http_requests_per_sec"],
         serve_eager_request_ms=srv["request"]["eager_ms"],
         serve_phase_s=srv["seconds"],
         made_update_ms=lik["train"]["made"]["update"]["update_ms"],
         made_update_bound_ms=lik["train"]["made"]["update"]["update_bound_ms"],
         digit_classifier_val_accuracy=sc["classifier"]["val_accuracy"],
         digit_classifier_seconds=sc["classifier"]["seconds"],
         conditional_accuracy=sc["score_conditional"]["conditional_accuracy"],
         score_conditional_seconds=sc["score_conditional"]["seconds"],
         gather_native_over_numpy={k: sc["batcher"][k]["native_over_numpy"]
                                   for k, *_ in GATHER_SHAPES},
         parallel_graphed_ms_per_step=par["nccl_graphed"]["ms_per_step_abba"],
         parallel_sample_mean_abs_err=par["sample_sharded"][
             "two_ranks_mean_abs_err_vs_batch_64"],
         phase_seconds=PHASE_SECONDS, seconds=time.perf_counter() - T_START)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
