// Fused GroupNorm + Mish, forward and backward, for Hopper (sm_90a).
//
// The forward replaces the Pallas TPU kernel igm_tpu/ops/pallas_groupnorm.py
// group_norm_mish (_fwd_kernel): for each sample of an NHWC activation,
// GroupNorm(groups, eps) with one-pass f32 statistics
// (var = max(E[x^2] - E[x]^2, 0), inv = rsqrt(var + eps)), the per-channel
// affine, then Mish(y) = y * tanh(softplus(y)).  bf16 or f32 in, the same
// type out; statistics and arithmetic in f32.
//
// The backward replaces _gnm_bwd (_bwd_kernel, pallas_groupnorm.py:81-95):
// from x and the output's gradient g it recomputes the statistics, then per
// element xhat, y = xhat*gamma + beta and dy = g * mish'(y), and writes
//   dx = inv * (dxhat - mean_group(dxhat) - xhat * mean_group(dxhat * xhat))
// with dxhat = dy * gamma, in x's type; per sample and channel it writes the
// partials sum(dy * xhat) and sum(dy), which a second small kernel sums over
// the batch in a fixed order (dgamma, dbeta: f32).
//
// What bounds both on this card: bytes.  They do a few dozen operations per
// element against one read and one write (backward: two reads, one write),
// far below the ~295 operations per byte at which the H100's tensor cores
// would take over; but Mish as exp, log1p and tanh is ~45 instructions an
// element on the CUDA cores, near half the bytes' time, and mish' as many
// again.  Two designs of each, chosen per shape by gn_plan:
//   - the one-pass kernels (group_norm_mish_onepass_kernel,
//     group_norm_mish_bwd_onepass_kernel): a sample's slice (backward: of x
//     and of g) staged in shared memory by cp.async and kept there from the
//     statistics to the output, so each input is read from device memory
//     once; a sample larger than a CTA split over a thread-block cluster of
//     up to 8 CTAs, whose group totals meet through distributed shared
//     memory in rank order (cta_group_sums; the backward does it twice, for
//     the statistics and for the two group means of dx, then sums the
//     per-channel partials over the ranks the same way); few registers, so
//     2-4 CTAs share an SM and one's reduction overlaps another's loads;
//     Mish and mish' in closed form with one ex2 and one rcp each, mish'
//     once an element (dy kept in shared memory for dx).  They take the
//     16-byte path with C / VEC dividing 256 and samples up to 8 CTAs of 16
//     chunks a thread (past 64x64x64 in bf16).  On the H100 (700 W), at
//     batch 256 bf16, the flagship forward's 25 calls take 0.38 ms against
//     this file's first kernel's 0.74 (bound 0.21), and its backward's 25
//     calls 0.79 ms against 2.29 (bound 0.32).  What is left, by phase
//     stamps (tools/kernel_stamps.py): a sample's x arrives before its
//     statistics can start, the group exchanges wait for a cluster's
//     slowest CTA, and the CTAs of an SM compute and load in step, so that
//     device memory idles while they compute;
//   - the first kernels (group_norm_mish_kernel, group_norm_mish_bwd_kernel),
//     for every other shape (groups of 4 or 5 channels, x off a 16-byte
//     boundary, C / VEC not dividing 256, larger samples): one CTA of up to
//     1024 threads per sample, like the Pallas grid (N,), sweeping the
//     sample's (H*W, C) tile as rows of C contiguous values, 16 bytes per
//     thread per load where the channel layout allows it (one value where a
//     group has 4 or 5 channels or x is off a 16-byte boundary).  Pass 1
//     keeps per-thread sums in registers and reduces them through shared
//     memory; pass 2 reads the tile again (mostly from L2) and writes the
//     output.  The first backward kernel has a pass more: pass 2 sums the
//     per-channel and per-group terms of the gradient, pass 3 re-reads x
//     and g and writes dx.
// Sums run in a fixed order, no atomics anywhere, so results repeat exactly
// from run to run.
// Softplus is max(y, 0) + log1p(exp(-|y|)): the form jax.nn.softplus
// (logaddexp(y, 0)) evaluates, stable for large |y| of either sign.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "mma_sm90.cuh"

namespace {

constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ float softplus(float y) {
  return fmaxf(y, 0.f) + log1pf(expf(-fabsf(y)));
}

__device__ __forceinline__ float mish(float y) { return y * tanhf(softplus(y)); }

// d mish / dy = tanh(sp) + y * sigmoid(y) * (1 - tanh(sp)^2), as _mish_grad
// (pallas_groupnorm.py:33-36)
__device__ __forceinline__ float mish_grad(float y) {
  const float t = tanhf(softplus(y));
  return t + y * (1.f / (1.f + expf(-y))) * (1.f - t * t);
}

// Sums each thread's (a, b) over the rows of its channel chunk, then over the
// chunks of each group, in a fixed order: group totals land in out_a[g],
// out_b[g].  Every thread of the block calls it.
template <int VEC>
__device__ void group_totals(float a, float b, int c, int groups, float* red1, float* red2,
                             float* out_a, float* out_b) {
  const int tid = threadIdx.x;
  const int chunks = c / VEC;
  const int rows_per_step = blockDim.x / chunks;
  red1[tid] = a;
  red2[tid] = b;
  __syncthreads();
  // per chunk: add the other rows' partials (thread tid keeps row 0's)
  if (tid < chunks) {
    for (int t = tid + chunks; t < rows_per_step * chunks; t += chunks) {
      a += red1[t];
      b += red2[t];
    }
  }
  __syncthreads();
  if (tid < chunks) {
    red1[tid] = a;
    red2[tid] = b;
  }
  __syncthreads();
  // per group: add its chunks
  if (tid < groups) {
    const int per_group = c / groups / VEC;
    float ga = 0.f, gb = 0.f;
    for (int j = 0; j < per_group; ++j) {
      ga += red1[tid * per_group + j];
      gb += red2[tid * per_group + j];
    }
    out_a[tid] = ga;
    out_b[tid] = gb;
  }
  __syncthreads();
}

// One-pass statistics of one sample: group_mean[g], group_inv[g].
template <typename T, int VEC>
__device__ void group_stats(const T* __restrict__ xs, int hw, int c, int groups, float eps,
                            float* red1, float* red2, float* group_mean, float* group_inv) {
  const int tid = threadIdx.x;
  const int chunks = c / VEC;
  const int c0 = (tid % chunks) * VEC;
  const int rows_per_step = blockDim.x / chunks;
  float s1 = 0.f, s2 = 0.f;
#pragma unroll 4
  for (int r = tid / chunks; r < hw; r += rows_per_step) {
    const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(xs + (size_t)r * c + c0);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float v = to_f32(p.v[j]);
      s1 += v;
      s2 += v * v;
    }
  }
  group_totals<VEC>(s1, s2, c, groups, red1, red2, group_mean, group_inv);
  if (tid < groups) {
    const float n = (float)hw * (float)(c / groups);
    const float mean = group_mean[tid] / n;
    const float var = fmaxf(group_inv[tid] / n - mean * mean, 0.f);
    group_mean[tid] = mean;
    group_inv[tid] = rsqrtf(var + eps);
  }
  __syncthreads();
}

// Block layout: thread t owns the VEC-wide channel chunk (t % chunks) of the
// rows t / chunks, t / chunks + rows_per_step, ...  blockDim.x is a multiple
// of chunks = C / VEC, and a chunk never straddles two groups
// ((C / groups) % VEC == 0), so every thread's sums belong to one group.
template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
group_norm_mish_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                       const float* __restrict__ beta, T* __restrict__ out,
                       int hw, int c, int groups, float eps) {
  __shared__ float red1[kMaxThreads];
  __shared__ float red2[kMaxThreads];
  __shared__ float group_mean[kMaxThreads];
  __shared__ float group_inv[kMaxThreads];

  const int tid = threadIdx.x;
  const int chunks = c / VEC;
  const int row0 = tid / chunks;
  const int rows_per_step = blockDim.x / chunks;
  const int cg = c / groups;
  const int c0 = (tid % chunks) * VEC;
  const size_t base = (size_t)blockIdx.x * hw * c;
  const T* xs = x + base;
  T* os = out + base;

  // pass 1: the sample's group statistics
  group_stats<T, VEC>(xs, hw, c, groups, eps, red1, red2, group_mean, group_inv);

  // pass 2: normalise, affine, Mish, one write
  const int g = c0 / cg;
  const float mean = group_mean[g];
  const float inv = group_inv[g];
  float ga[VEC], be[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    ga[j] = gamma[c0 + j];
    be[j] = beta[c0 + j];
  }
#pragma unroll 4
  for (int r = row0; r < hw; r += rows_per_step) {
    const size_t off = (size_t)r * c + c0;
    const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(xs + off);
    Pack<T, VEC> o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float y = (to_f32(p.v[j]) - mean) * inv * ga[j] + be[j];
      o.v[j] = from_f32<T>(mish(y));
    }
    *reinterpret_cast<Pack<T, VEC>*>(os + off) = o;
  }
}

// ---------------------------------------------------------------------------
// The forward in one pass over device memory (see the note at the head).
// A CTA of 256 threads covers one sample or, in a cluster of `cluster`
// CTAs, rows [rank * R * step, ...) of it.  Thread t owns the 16-byte chunk
// t % chunks of the rows r0, r0 + step, ..., r0 + (R - 1) * step (step =
// 256 / chunks) and copies them by cp.async into its own slots of the
// CTA's shared memory, where they stay from the statistics to the output:
// x is read from device memory once, and the registers stay few enough
// (<= 64; 80 at R = 16) for 4 CTAs of 256 threads on an SM (3 at R = 16),
// whose load, reduction and output phases overlap.  The per-thread sums go
// to shared memory; warp w then sums groups w, w + 8, ... over their
// threads in a fixed order (lane i takes terms i, i + 32, ...; then a
// butterfly, which gives every lane the same bits), and a cluster sums its
// CTAs' group totals through distributed shared memory in rank order.  No
// atomics: the output repeats bit for bit.
constexpr int kOnePassThreads = 256;
constexpr int kOnePassWarps = kOnePassThreads / 32;
constexpr int kMaxCluster = 8;         // the portable cluster size

// Mish with tanh(softplus(y)) in closed form: with t = exp(y), softplus =
// log(1 + t), so tanh(softplus(y)) = ((1 + t)^2 - 1) / ((1 + t)^2 + 1) = n /
// (n + 2) with n = t (t + 2).  The same function as mish() with one
// exponential and one reciprocal (the hardware's ex2 and rcp, about 2 ulp
// each) in place of exp, log1p and tanh; y is capped at 20 inside the
// exponential, where n / (n + 2) is 1 in f32 already, so that n stays finite.
__device__ __forceinline__ float mish_fast(float y) {
  float t, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(t) : "f"(fminf(y, 20.f) * 1.4426950408889634f));
  const float n = t * (t + 2.f);
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(n + 2.f));
  return y * (n * r);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// The (a, b) of every thread of the CTA summed per group, then over the
// cluster's CTAs in rank order; thread q < groups gets group q's totals in
// (ga, gb).  red holds the threads' terms; tot the CTA's group totals, which
// the cluster's other CTAs read, so each exchange of a kernel has its own
// tot.  Thread (row k, chunk g * cpg + j) is term k * cpg + j of group g;
// warp w sums groups w, w + 8, ... (lane i takes terms i, i + 32, ..., then
// a butterfly: every lane gets the same bits).  Every thread calls it.  With
// a cluster it returns after this CTA's reads of the other CTAs' tot: the
// caller keeps it alive (a later cluster barrier) until they have read its.
__device__ __forceinline__ void cta_group_sums(float a, float b, int chunks, int cpg,
                                               int groups, int csize,
                                               float (*red)[kOnePassThreads],
                                               float (*tot)[kOnePassThreads], float& ga,
                                               float& gb) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  red[0][tid] = a;
  red[1][tid] = b;
  __syncthreads();
  const int terms = kOnePassThreads / groups;
  for (int q = warp; q < groups; q += kOnePassWarps) {
    float sa = 0.f, sb = 0.f;
    for (int i = lane; i < terms; i += 32) {
      const int t = (i / cpg) * chunks + q * cpg + i % cpg;
      sa += red[0][t];
      sb += red[1][t];
    }
    sa = warp_sum(sa);
    sb = warp_sum(sb);
    if (lane == 0) {
      tot[0][q] = sa;
      tot[1][q] = sb;
    }
  }
  ga = gb = 0.f;
  if (csize > 1) {
    cluster_sync();                             // every CTA's totals are written
    if (tid < groups) {                         // the ranks in order
      float ra[kMaxCluster], rb[kMaxCluster];
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {   // all loads in flight at once
        ra[r] = r < csize ? *remote(&tot[0][tid], r) : 0.f;
        rb[r] = r < csize ? *remote(&tot[1][tid], r) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        ga += ra[r];
        gb += rb[r];
      }
    }
  } else {
    __syncthreads();
    if (tid < groups) {
      ga = tot[0][tid];
      gb = tot[1][tid];
    }
  }
}

template <typename T, int R>
__global__ void __launch_bounds__(kOnePassThreads, R >= 16 ? 3 : 4)
group_norm_mish_onepass_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                               const float* __restrict__ beta, T* __restrict__ out, int n,
                               int hw, int c, int groups, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  using P = Pack<T, VEC>;
  extern __shared__ __align__(16) unsigned char slice_bytes[];
  P* slice = reinterpret_cast<P*>(slice_bytes);  // [R][256]: chunk i of thread t at i * 256 + t
  __shared__ float red[2][kOnePassThreads];     // each thread's (sum x, sum x^2)
  __shared__ float tot[2][kOnePassThreads];     // per group, this CTA's sums
  __shared__ float stat[2][kOnePassThreads];    // mean, inv per group

  const int tid = threadIdx.x;
  const int chunks = c / VEC, cpg = chunks / groups;
  const int csize = cluster_size(), rank = cluster_rank();
  const int sample = blockIdx.x / csize;
  const int step = kOnePassThreads / chunks;    // rows per sweep
  const int ch = tid % chunks, c0 = ch * VEC;
  const int r0 = rank * R * step + tid / chunks;
  const bool live = sample < n;
  const size_t base = live ? (size_t)sample * hw * c : 0;

  // this thread's chunks, by cp.async into its own slots (zero past the
  // last row or sample): each thread reads back only what it copied
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = r0 + i * step;
    const bool valid = live && r < hw;
    cp_async16(slice + i * kOnePassThreads + tid, x + (valid ? base + (size_t)r * c + c0 : 0),
               valid);
  }
  cp_async_commit();
  float ga[VEC], be[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    ga[j] = gamma[c0 + j];
    be[j] = beta[c0 + j];
  }
  cp_async_wait<0>();
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const P p = slice[i * kOnePassThreads + tid];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float v = to_f32(p.v[j]);
      s1 += v;
      s2 += v * v;
    }
  }
  float a, b;
  cta_group_sums(s1, s2, chunks, cpg, groups, csize, red, tot, a, b);
  if (csize > 1) cluster_arrive();              // this CTA reads no other's memory again
  if (tid < groups) {
    const float cnt = (float)hw * (float)(c / groups);
    const float mean = a / cnt;
    const float var = fmaxf(b / cnt - mean * mean, 0.f);
    stat[0][tid] = mean;
    stat[1][tid] = rsqrtf(var + eps);
  }
  __syncthreads();

  const float mean = stat[0][ch / cpg], inv = stat[1][ch / cpg];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = r0 + i * step;
    if (!live || r >= hw) continue;
    const P p = slice[i * kOnePassThreads + tid];
    P o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float y = (to_f32(p.v[j]) - mean) * inv * ga[j] + be[j];
      o.v[j] = from_f32<T>(mish_fast(y));
    }
    *reinterpret_cast<P*>(out + base + (size_t)r * c + c0) = o;
  }
  if (csize > 1) cluster_wait();                // no CTA leaves while another reads it
}

// mish'(y) in the closed form of mish_fast: with t = exp(y), n = t (t + 2)
// and r = 1 / (n + 2), tanh(softplus(y)) = n r and sigmoid(y) (1 - tanh^2) =
// t / (1 + t) * 4 (n + 1) r^2 = 4 t (t + 1) r^2, since n + 1 = (t + 1)^2; so
// mish'(y) = n r + 4 y t (t + 1) r^2 = r (n + 4 y (n - t) r): one ex2 and one
// rcp.  It takes y2 = y log2(e) (the caller folds log2(e) into gamma and
// beta), so the ex2 needs no multiply, and y = y2 ln(2).  y is capped at 20
// in both terms.  That is exact in f32: there n r rounds to 1 (1 - n r is
// about 2 e^-40), the second term is about 80 e^-40, and the reference's
// 1 - tanh^2 is 0 exactly from y of about 9 on, so both give 1 (the rcp's
// ulp aside); and n stays finite.  For large negative y, t underflows (to 0
// below y = -87, the ex2 flushing to zero): n r -> t and the second term ->
// y t, both to 0 as the reference's tanh(softplus) ~ e^y and y sigmoid(y) do.
constexpr float kLog2e = 1.4426950408889634f;
__device__ __forceinline__ float mish_grad_fast(float y2) {
  const float yc2 = fminf(y2, 20.f * kLog2e);
  float t, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(t) : "f"(yc2));
  const float n = t * (t + 2.f);
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(n + 2.f));
  return r * fmaf(4.f * 0.6931471805599453f * yc2 * (n - t), r, n);
}

// ---------------------------------------------------------------------------
// The backward in one pass over device memory (see the note at the head):
// the forward's one-pass layout (gn_plan, 256 threads, thread t's 16-byte
// chunks of x at i * 256 + t) with g's chunks beside them, staged by
// cp.async in two commit groups, so that g is still arriving while the
// statistics of x are taken.  Then, from shared memory only:
//   sweep 1: dy = g mish'(y) per element, and this thread's per-channel sums
//            of dy xhat and dy (the dgamma and dbeta partials); the group
//            sums of dxhat = dy gamma and of dxhat xhat follow from them
//            (gamma is constant along a channel) and go through
//            cta_group_sums.  dy is kept for sweep 2: in f32 in g's slot; in
//            bf16 as its rounding to bf16 in g's slot and the rest, rounded
//            to bf16, in a third slice (dy to about 16 bits, where dx keeps
//            8), so that sweep 2 needs no second mish';
//   sweep 2: dx written once.
// The slices are free after sweep 2: the threads' channel sums go there, one
// row of c per (sweep row, array), are summed per channel over the rows in
// order (thread q takes channel q), and over the cluster's CTAs in rank
// order by rank 0 (each thread's loads from the ranks all in flight at
// once), which writes the sample's (dgamma, dbeta) partials.  Cluster
// barriers: the two group exchanges, the channel exchange, and a last one
// so that no CTA leaves while rank 0 reads it.

// The backward's slices: x, g (then dy) and, in bf16, dy's low part; the
// CTAs an SM that they leave room for (at most 3): bf16 3 x 32 KB at R = 8,
// 2 CTAs; f32 2 x 32 KB, 3 CTAs
template <typename T>
constexpr int bwd_slices() {
  return sizeof(T) == sizeof(float) ? 2 : 3;
}
template <typename T, int R>
constexpr int bwd_ctas_per_sm() {
  const int per_cta = bwd_slices<T>() * R * kOnePassThreads * 16 + 11 * 1024;
  const int fit = 227 * 1024 / per_cta;
  return fit < 1 ? 1 : fit > 3 ? 3 : fit;
}

template <typename T, int R>
__global__ void __launch_bounds__(kOnePassThreads, bwd_ctas_per_sm<T, R>())
group_norm_mish_bwd_onepass_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                                   const float* __restrict__ beta, const T* __restrict__ g,
                                   T* __restrict__ dx, float* __restrict__ dgamma_part,
                                   float* __restrict__ dbeta_part, int hw, int c, int groups,
                                   float eps) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr bool kBf16 = sizeof(T) == 2;
  using P = Pack<T, VEC>;
  extern __shared__ __align__(16) unsigned char slice_bytes[];
  P* xs = reinterpret_cast<P*>(slice_bytes);   // [R][256]: chunk i of thread t at i * 256 + t
  P* gs = xs + R * kOnePassThreads;            // the same for g, then dy (bf16: its high part)
  P* ls = gs + R * kOnePassThreads;            // bf16: dy's low part
  float* part = reinterpret_cast<float*>(slice_bytes);  // after sweep 2: [2][step][c]
  __shared__ float red[2][kOnePassThreads];    // each thread's pair of terms
  __shared__ float tot[2][2][kOnePassThreads]; // per exchange and group, this CTA's sums
  __shared__ float stat[4][kOnePassThreads];   // per group: mean, inv, m1, m2

  const int tid = threadIdx.x;
  const int chunks = c / VEC, cpg = chunks / groups;
  const int csize = cluster_size(), rank = cluster_rank();
  const int sample = blockIdx.x / csize;
  const int step = kOnePassThreads / chunks;   // rows per sweep
  const int ch = tid % chunks, c0 = ch * VEC, grp = ch / cpg;
  const int r0 = rank * R * step + tid / chunks;
  const size_t base = (size_t)sample * hw * c;
  IGM_STAMP(0);

  // this thread's chunks of x, then of g (zero past the last row): rows past
  // hw add 0 to every sum, since x = g = 0 there
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = r0 + i * step;
    cp_async16(xs + i * kOnePassThreads + tid, x + (r < hw ? base + (size_t)r * c + c0 : 0),
               r < hw);
  }
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = r0 + i * step;
    cp_async16(gs + i * kOnePassThreads + tid, g + (r < hw ? base + (size_t)r * c + c0 : 0),
               r < hw);
  }
  cp_async_commit();
  float ga[VEC], ga2[VEC], be2[VEC];           // gamma; gamma, beta times log2(e)
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    ga[j] = gamma[c0 + j];
    ga2[j] = ga[j] * kLog2e;
    be2[j] = beta[c0 + j] * kLog2e;
  }
  const float cnt = (float)hw * (float)(c / groups);

  cp_async_wait<1>();                          // x has arrived
  IGM_STAMP(1);
  float a = 0.f, b = 0.f;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const P p = xs[i * kOnePassThreads + tid];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float v = to_f32(p.v[j]);
      a += v;
      b += v * v;
    }
  }
  cta_group_sums(a, b, chunks, cpg, groups, csize, red, tot[0], a, b);
  if (tid < groups) {
    const float mean = a / cnt;
    const float var = fmaxf(b / cnt - mean * mean, 0.f);
    stat[0][tid] = mean;
    stat[1][tid] = rsqrtf(var + eps);
  }
  __syncthreads();
  const float mean = stat[0][grp], inv = stat[1][grp];
  IGM_STAMP(2);

  // sweep 1: xhat = (x - mean) inv, y2 = y log2(e), dy = g mish'(y)
  cp_async_wait<0>();                          // g has arrived
  IGM_STAMP(3);
  float dga[VEC], dbe[VEC];                    // sum dy xhat, sum dy per channel
#pragma unroll
  for (int j = 0; j < VEC; ++j) dga[j] = dbe[j] = 0.f;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const P px = xs[i * kOnePassThreads + tid];
    const P pg = gs[i * kOnePassThreads + tid];
    P hi, lo;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float xhat = (to_f32(px.v[j]) - mean) * inv;
      const float dy = to_f32(pg.v[j]) * mish_grad_fast(fmaf(xhat, ga2[j], be2[j]));
      dga[j] = fmaf(dy, xhat, dga[j]);
      dbe[j] += dy;
      hi.v[j] = from_f32<T>(dy);
      if constexpr (kBf16) lo.v[j] = from_f32<T>(dy - to_f32(hi.v[j]));
    }
    gs[i * kOnePassThreads + tid] = hi;
    if constexpr (kBf16) ls[i * kOnePassThreads + tid] = lo;
  }
  a = b = 0.f;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    a = fmaf(ga[j], dbe[j], a);
    b = fmaf(ga[j], dga[j], b);
  }
  cta_group_sums(a, b, chunks, cpg, groups, csize, red, tot[1], a, b);
  if (tid < groups) {
    stat[2][tid] = a / cnt;
    stat[3][tid] = b / cnt;
  }
  __syncthreads();
  const float m1 = stat[2][grp], m2 = stat[3][grp];
  IGM_STAMP(4);

  // sweep 2: dx = inv (dy gamma - m1 - xhat m2)
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = r0 + i * step;
    const P px = xs[i * kOnePassThreads + tid];
    const P hi = gs[i * kOnePassThreads + tid];
    P lo;
    if constexpr (kBf16) lo = ls[i * kOnePassThreads + tid];
    P o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float xhat = (to_f32(px.v[j]) - mean) * inv;
      const float dy = kBf16 ? to_f32(hi.v[j]) + to_f32(lo.v[j]) : to_f32(hi.v[j]);
      o.v[j] = from_f32<T>(inv * fmaf(dy, ga[j], fmaf(-xhat, m2, -m1)));
    }
    if (r < hw) *reinterpret_cast<P*>(dx + base + (size_t)r * c + c0) = o;
  }

  IGM_STAMP(5);
  __syncthreads();                             // every thread is done with the slices
  float* pa = part + (tid / chunks) * c + c0;  // row tid / chunks of the sums of dy xhat
  float* pb = pa + step * c;                   // ... and of dy
#pragma unroll
  for (int j = 0; j < VEC; j += 4) {
    *reinterpret_cast<float4*>(pa + j) = make_float4(dga[j], dga[j + 1], dga[j + 2], dga[j + 3]);
    *reinterpret_cast<float4*>(pb + j) = make_float4(dbe[j], dbe[j + 1], dbe[j + 2], dbe[j + 3]);
  }
  __syncthreads();
  // channel q's sums over the rows, in order; only thread q reads or writes
  // column q, so its total can go to row 0
  for (int q = tid; q < c; q += kOnePassThreads) {
    float sa = 0.f, sb = 0.f;
#pragma unroll 8
    for (int k = 0; k < step; ++k) {
      sa += part[k * c + q];
      sb += part[(step + k) * c + q];
    }
    part[q] = sa;
    part[step * c + q] = sb;
  }
  IGM_STAMP(6);
  float* dgs = dgamma_part + (size_t)sample * c;
  float* dbs = dbeta_part + (size_t)sample * c;
  if (csize > 1) {
    cluster_sync();                            // every CTA's channel totals are written
    if (rank == 0) {                           // the ranks in order
      for (int q = tid; q < c; q += kOnePassThreads) {
        float ra[kMaxCluster], rb[kMaxCluster];
#pragma unroll
        for (int r = 0; r < kMaxCluster; ++r) {  // all loads in flight at once
          ra[r] = r < csize ? *remote(&part[q], r) : 0.f;
          rb[r] = r < csize ? *remote(&part[step * c + q], r) : 0.f;
        }
        float sa = 0.f, sb = 0.f;
#pragma unroll
        for (int r = 0; r < kMaxCluster; ++r) {
          sa += ra[r];
          sb += rb[r];
        }
        dgs[q] = sa;
        dbs[q] = sb;
      }
    }
    cluster_sync();                            // no CTA leaves while rank 0 reads it
  } else {
    for (int q = tid; q < c; q += kOnePassThreads) {
      dgs[q] = part[q];
      dbs[q] = part[step * c + q];
    }
  }
  IGM_STAMP(7);
}

// Backward: one CTA per sample, the forward's thread layout.
template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
group_norm_mish_bwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                           const float* __restrict__ beta, const T* __restrict__ g,
                           T* __restrict__ dx, float* __restrict__ dgamma_part,
                           float* __restrict__ dbeta_part, int hw, int c, int groups,
                           float eps) {
  __shared__ float red1[kMaxThreads];
  __shared__ float red2[kMaxThreads];
  __shared__ float group_mean[kMaxThreads];
  __shared__ float group_inv[kMaxThreads];
  __shared__ float group_m1[kMaxThreads];
  __shared__ float group_m2[kMaxThreads];

  const int tid = threadIdx.x;
  const int chunks = c / VEC;
  const int row0 = tid / chunks;
  const int rows_per_step = blockDim.x / chunks;
  const int cg = c / groups;
  const int c0 = (tid % chunks) * VEC;
  const size_t base = (size_t)blockIdx.x * hw * c;
  const T* xs = x + base;
  const T* gs = g + base;
  T* dxs = dx + base;

  // pass 1: the sample's group statistics, as the forward's
  group_stats<T, VEC>(xs, hw, c, groups, eps, red1, red2, group_mean, group_inv);
  const int grp = c0 / cg;
  const float mean = group_mean[grp];
  const float inv = group_inv[grp];
  float ga[VEC], be[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    ga[j] = gamma[c0 + j];
    be[j] = beta[c0 + j];
  }

  // pass 2: per channel sum(dy * xhat) and sum(dy); per group the sums of
  // dxhat and dxhat * xhat
  float dga[VEC], dbe[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) dga[j] = dbe[j] = 0.f;
  float s1 = 0.f, s2 = 0.f;
#pragma unroll 2
  for (int r = row0; r < hw; r += rows_per_step) {
    const size_t off = (size_t)r * c + c0;
    const Pack<T, VEC> px = *reinterpret_cast<const Pack<T, VEC>*>(xs + off);
    const Pack<T, VEC> pg = *reinterpret_cast<const Pack<T, VEC>*>(gs + off);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float xhat = (to_f32(px.v[j]) - mean) * inv;
      const float dy = to_f32(pg.v[j]) * mish_grad(xhat * ga[j] + be[j]);
      dga[j] += dy * xhat;
      dbe[j] += dy;
      const float dxhat = dy * ga[j];
      s1 += dxhat;
      s2 += dxhat * xhat;
    }
  }
  float* dgs = dgamma_part + (size_t)blockIdx.x * c;
  float* dbs = dbeta_part + (size_t)blockIdx.x * c;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    red1[tid] = dga[j];
    red2[tid] = dbe[j];
    __syncthreads();
    if (tid < chunks) {   // thread tid owns chunk tid of row 0
      float a = 0.f, b = 0.f;
      for (int t = tid; t < rows_per_step * chunks; t += chunks) {
        a += red1[t];
        b += red2[t];
      }
      dgs[tid * VEC + j] = a;
      dbs[tid * VEC + j] = b;
    }
    __syncthreads();
  }
  group_totals<VEC>(s1, s2, c, groups, red1, red2, group_m1, group_m2);
  const float per_group = (float)hw * (float)cg;
  const float m1 = group_m1[grp] / per_group;
  const float m2 = group_m2[grp] / per_group;

  // pass 3: dx, one write
#pragma unroll 2
  for (int r = row0; r < hw; r += rows_per_step) {
    const size_t off = (size_t)r * c + c0;
    const Pack<T, VEC> px = *reinterpret_cast<const Pack<T, VEC>*>(xs + off);
    const Pack<T, VEC> pg = *reinterpret_cast<const Pack<T, VEC>*>(gs + off);
    Pack<T, VEC> o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float xhat = (to_f32(px.v[j]) - mean) * inv;
      const float dy = to_f32(pg.v[j]) * mish_grad(xhat * ga[j] + be[j]);
      o.v[j] = from_f32<T>(inv * (dy * ga[j] - m1 - xhat * m2));
    }
    *reinterpret_cast<Pack<T, VEC>*>(dxs + off) = o;
  }
}

// dgamma[ch] = sum_i dgamma_part[i][ch] (blockIdx.y 0), the same for dbeta
// (blockIdx.y 1).  A CTA takes 32 channels: warp w sums the samples w,
// w + 16, w + 32, ... in order (a warp reads 128 contiguous bytes a sample;
// 16 loads in flight), then warp 0 sums the 16 warps' totals in order.  Fixed order, no
// atomics: the result repeats bit for bit.
constexpr int kSumWarps = 16;

__global__ void __launch_bounds__(kSumWarps * 32)
sum_partials_kernel(const float* __restrict__ dgamma_part, const float* __restrict__ dbeta_part,
                    float* __restrict__ dgamma, float* __restrict__ dbeta, int n, int c) {
  __shared__ float acc[kSumWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ch = blockIdx.x * 32 + lane;
  const float* part = blockIdx.y == 0 ? dgamma_part : dbeta_part;
  float s = 0.f;
  if (ch < c) {
#pragma unroll 16
    for (int i = warp; i < n; i += kSumWarps) s += part[(size_t)i * c + ch];
  }
  acc[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && ch < c) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kSumWarps; ++w) t += acc[w][lane];
    (blockIdx.y == 0 ? dgamma : dbeta)[ch] = t;
  }
}

template <typename T, int VEC>
cudaError_t launch_vec(const void* x, const void* gamma, const void* beta, void* out,
                       int n, int hw, int c, int groups, float eps, cudaStream_t stream) {
  const int chunks = c / VEC;
  // as many threads as fit in 1024 while staying a multiple of chunks
  const int threads = (kMaxThreads / chunks) * chunks;
  group_norm_mish_kernel<T, VEC><<<n, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<T*>(out), hw, c, groups, eps);
  return cudaGetLastError();
}

// How the one-pass forward covers a sample of hw rows of c channels: R,
// its 16-byte chunks a thread, and the cluster of CTAs that splits it.  R
// is the least power of two, up to 8, with which one CTA covers the sample
// (no idle threads), else 8 over a cluster of up to 8 CTAs, else 16; r = 0:
// the shape is not taken (C / VEC does not divide 256, or a sample needs
// more than 8 CTAs of 16 chunks a thread, past 64x64x64 in bf16), and the
// two-pass kernel runs it.  Measured on the H100 at the flagship's and the
// latent UNet's shapes, at batch 256 and 64: fewer, larger CTAs won at
// every shape, even where the grid is smaller than the card (at batch 64
// 8x8x256 takes 6.8 us a call in 64 CTAs against 11.4 us in 8-CTA
// clusters of R = 1), and several samples packed into one CTA lost at
// every latent shape (4x4x64: 4.2 against 3.8 us).
struct GnPlan {
  int r, cluster;
};

int pow2_at_least(int v) {
  int p = 1;
  while (p < v) p *= 2;
  return p;
}

GnPlan gn_plan(int hw, int c, int vec) {
  const int chunks = c / vec;
  if (chunks > kOnePassThreads || kOnePassThreads % chunks != 0) return {0, 0};
  const int step = kOnePassThreads / chunks;    // rows per sweep of a CTA
  GnPlan p{pow2_at_least((hw + step - 1) / step), 1};
  if (p.r > 8) {
    p.r = 8;
    p.cluster = (hw + 8 * step - 1) / (8 * step);
    if (p.cluster > kMaxCluster) {
      p.r = 16;
      p.cluster = (hw + 16 * step - 1) / (16 * step);
      if (p.cluster > kMaxCluster) return {0, 0};
    }
  }
  return p;
}

// Launches kernel over ctas CTAs of 256 threads in clusters of `cluster`,
// with `smem` bytes of dynamic shared memory.
template <typename... Params, typename... Args>
cudaError_t launch_clustered(void (*kernel)(Params...), int ctas, int cluster, size_t smem,
                             cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(ctas);
  config.blockDim = dim3(kOnePassThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = cluster > 1 ? 1 : 0;
  if (cudaError_t err = allow_dynamic_smem(kernel, smem)) return err;
  return cudaLaunchKernelEx(&config, kernel, static_cast<Params>(args)...);
}

// f(std::integral_constant<int, R>()) for a plan's R (up to kMaxR)
template <int kMaxR, typename F>
cudaError_t with_r(int r, F&& f) {
  switch (r) {
    case 1: return f(std::integral_constant<int, 1>());
    case 2: return f(std::integral_constant<int, 2>());
    case 4: return f(std::integral_constant<int, 4>());
    case 8: return f(std::integral_constant<int, 8>());
    default:
      if constexpr (kMaxR >= 16) return f(std::integral_constant<int, 16>());
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_onepass(const GnPlan& p, const void* x, const void* gamma,
                           const void* beta, void* out, int n, int hw, int c, int groups,
                           float eps, cudaStream_t stream) {
  return with_r<16>(p.r, [&](auto r) {
    constexpr int R = decltype(r)::value;
    return launch_clustered(group_norm_mish_onepass_kernel<T, R>, n * p.cluster, p.cluster,
                            (size_t)R * kOnePassThreads * 16, stream, x, gamma, beta, out, n,
                            hw, c, groups, eps);
  });
}

// The backward takes the forward's plan: its slices take two (f32) or three
// (bf16) times the forward's shared memory, 64 or 96 KB at R = 8 (3 or 2
// CTAs an SM), 128 or 192 KB at R = 16 (one), and after sweep 2 the channel
// sums take 256 * VEC * 8 bytes of it (16 KB in bf16: more than the slices
// at R = 1).
template <typename T>
cudaError_t launch_bwd_onepass(const GnPlan& p, const void* x, const void* gamma,
                               const void* beta, const void* g, void* dx, void* dgamma_part,
                               void* dbeta_part, int n, int hw, int c, int groups, float eps,
                               cudaStream_t stream) {
  return with_r<16>(p.r, [&](auto r) {
    constexpr int R = decltype(r)::value;
    const size_t slices = (size_t)bwd_slices<T>() * R * kOnePassThreads * 16;
    const size_t sums = (size_t)kOnePassThreads * (16 / sizeof(T)) * 8;
    return launch_clustered(group_norm_mish_bwd_onepass_kernel<T, R>, n * p.cluster,
                            p.cluster, slices > sums ? slices : sums, stream, x, gamma, beta,
                            g, dx, dgamma_part, dbeta_part, hw, c, groups, eps);
  });
}

cudaError_t launch_sum_partials(const void* dgamma_part, const void* dbeta_part, void* dgamma,
                                void* dbeta, int n, int c, cudaStream_t stream) {
  sum_partials_kernel<<<dim3((c + 31) / 32, 2), kSumWarps * 32, 0, stream>>>(
      static_cast<const float*>(dgamma_part), static_cast<const float*>(dbeta_part),
      static_cast<float*>(dgamma), static_cast<float*>(dbeta), n, c);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_bwd_vec(const void* x, const void* gamma, const void* beta, const void* g,
                           void* dx, void* dgamma_part, void* dbeta_part, int n, int hw, int c,
                           int groups, float eps, cudaStream_t stream) {
  const int chunks = c / VEC;
  const int threads = (kMaxThreads / chunks) * chunks;
  group_norm_mish_bwd_kernel<T, VEC><<<n, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const T*>(g), static_cast<T*>(dx),
      static_cast<float*>(dgamma_part), static_cast<float*>(dbeta_part), hw, c, groups, eps);
  return cudaGetLastError();
}

// Whether the 16-byte path takes these pointers and channels: every pointer
// 16-byte aligned, no chunk straddling two groups, one chunk per thread fits.
template <typename T>
bool vectorised(std::initializer_list<const void*> ptrs, int c, int groups) {
  constexpr int kVec = 16 / sizeof(T);
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return (c / groups) % kVec == 0 && c / kVec <= kMaxThreads;
}

bool bad_shape(int n, int hw, int c, int groups) {
  return n <= 0 || hw <= 0 || c <= 0 || groups <= 0 || c % groups != 0;
}

template <typename T>
int launch(const void* x, const void* gamma, const void* beta, void* out, int n, int hw,
           int c, int groups, float eps, void* stream) {
  if (bad_shape(n, hw, c, groups)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vectorised<T>({x, out}, c, groups)) {
    constexpr int kVec = 16 / sizeof(T);
    const GnPlan p = gn_plan(hw, c, kVec);
    if (p.r > 0) {
      const cudaError_t err = launch_onepass<T>(p, x, gamma, beta, out, n, hw, c, groups, eps, s);
      return err != cudaSuccess ? err : cudaGetLastError();
    }
    return launch_vec<T, kVec>(x, gamma, beta, out, n, hw, c, groups, eps, s);
  }
  if (c > kMaxThreads) return cudaErrorInvalidValue;
  return launch_vec<T, 1>(x, gamma, beta, out, n, hw, c, groups, eps, s);
}

template <typename T>
int launch_bwd(const void* x, const void* gamma, const void* beta, const void* g, void* dx,
               void* dgamma_part, void* dbeta_part, void* dgamma, void* dbeta, int n, int hw,
               int c, int groups, float eps, void* stream) {
  if (bad_shape(n, hw, c, groups)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (vectorised<T>({x, g, dx}, c, groups)) {
    constexpr int kVec = 16 / sizeof(T);
    const GnPlan p = gn_plan(hw, c, kVec);
    err = p.r > 0 ? launch_bwd_onepass<T>(p, x, gamma, beta, g, dx, dgamma_part, dbeta_part,
                                          n, hw, c, groups, eps, s)
                  : launch_bwd_vec<T, kVec>(x, gamma, beta, g, dx, dgamma_part, dbeta_part,
                                            n, hw, c, groups, eps, s);
  } else {
    if (c > kMaxThreads) return cudaErrorInvalidValue;
    err = launch_bwd_vec<T, 1>(x, gamma, beta, g, dx, dgamma_part, dbeta_part, n, hw, c,
                               groups, eps, s);
  }
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_sum_partials(dgamma_part, dbeta_part, dgamma, dbeta, n, c, s);
}

}  // namespace

// x, out: (n, hw, c) contiguous; gamma, beta: (c,) f32.  Returns the CUDA
// error code of the launch (0 on success).
extern "C" int igm_group_norm_mish_f32(const void* x, const void* gamma, const void* beta,
                                       void* out, int n, int hw, int c, int groups,
                                       float eps, void* stream) {
  return launch<float>(x, gamma, beta, out, n, hw, c, groups, eps, stream);
}

extern "C" int igm_group_norm_mish_bf16(const void* x, const void* gamma, const void* beta,
                                        void* out, int n, int hw, int c, int groups,
                                        float eps, void* stream) {
  return launch<__nv_bfloat16>(x, gamma, beta, out, n, hw, c, groups, eps, stream);
}

// x, g (the output's gradient), dx: (n, hw, c) contiguous; gamma, beta: (c,)
// f32; dgamma_part, dbeta_part: (n, c) f32 scratch; dgamma, dbeta: (c,) f32.
// Launches the backward and the batch sum of the partials; returns the CUDA
// error code of the launches (0 on success).
extern "C" int igm_group_norm_mish_bwd_f32(const void* x, const void* gamma, const void* beta,
                                           const void* g, void* dx, void* dgamma_part,
                                           void* dbeta_part, void* dgamma, void* dbeta, int n,
                                           int hw, int c, int groups, float eps, void* stream) {
  return launch_bwd<float>(x, gamma, beta, g, dx, dgamma_part, dbeta_part, dgamma, dbeta, n,
                           hw, c, groups, eps, stream);
}

extern "C" int igm_group_norm_mish_bwd_bf16(const void* x, const void* gamma, const void* beta,
                                            const void* g, void* dx, void* dgamma_part,
                                            void* dbeta_part, void* dgamma, void* dbeta, int n,
                                            int hw, int c, int groups, float eps,
                                            void* stream) {
  return launch_bwd<__nv_bfloat16>(x, gamma, beta, g, dx, dgamma_part, dbeta_part, dgamma,
                                   dbeta, n, hw, c, groups, eps, stream);
}
