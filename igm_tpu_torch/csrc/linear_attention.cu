// Linear attention forward and backward for Hopper (sm_90a), read in the
// head-folded ("flat") layout.
//
// The forward replaces the Pallas TPU kernel
// igm_tpu/ops/pallas_attention.py linear_attention_pallas
// (_linattn_kernel), and computes exactly what the default XLA path
// igm_tpu/ops/attention.py linear_attention_flat computes: q, k, v are
// (B, N, H*D) with D = 32; head h is the channel slice [h*D, (h+1)*D).
// Per (b, h):
//   k_sm = softmax of k over the N positions (per column),
//   ctx  = k_sm^T v                       (D x D, f32 accumulation),
//   out  = q ctx                          (q unscaled),
// with ctx rounded to the input type before the read-out, as
// _flat_fwd (attention.py:92-96) casts it.  For bf16 the key softmax also
// rounds where jax.nn.softmax rounds on a bf16 array: the shifted logits,
// their exponentials, the column sum and the quotient, each to bf16, against
// the exact column max.  float32 rounds nowhere.
//
// The backward replaces the XLA custom VJP _flat_bwd (attention.py:99-112):
//   dq = g ctx^T  (ctx as the forward computed and rounded it),
//   dctx = q^T g  (per head block), dv = k_sm dctx, dk_sm = v dctx^T,
//   dk = k_sm (dk_sm - sum_n k_sm dk_sm),
// where k_sm here is the float32 softmax of k with no rounding, as _flat_bwd
// recomputes it (attention.py:104).  f32 inside; outputs in the input type.
//
// What bounds both on this card: bytes.  The forward moves q, k, v and out
// once each, 256 bytes per position of a head in bf16, against 4*D = 128
// operations of the two D x D products, the softmax's ~10 and the weight's
// division per element: far below the ~295 operations per byte at which
// the tensor cores would bind, but not below the CUDA cores' ~20 (67
// TFLOP/s over 3.35 TB/s).  The products alone, done as f32 FMAs, would
// take about 80% of the bytes' time, so in bf16 they go to the tensor
// cores.  At the flagship's N = 1024, 256 and 64 (batch 256) the bytes take
// 0.080, 0.020 and 0.005 ms; the small calls are bound by latency: a head's
// key softmax needs the exact column max before any weight, so each head
// runs max, sum, weights, context and read-out in series.
//
// Two designs:
//   - bf16 forward (the UNet's path), on the tensor cores:
//     mma.sync.m16n8k16 bf16 -> f32 for ctx^T = v^T w and out = q ctx, so
//     that both products round exactly where _flat_fwd rounds (w and ctx to
//     bf16 before their products).  A CTA of 4 warps stages a head's rows
//     of k, v and q in shared memory once, by 16-byte cp.async (each read
//     from device memory once; rows padded to 80 bytes so ldmatrix is free
//     of bank conflicts): k and v at the start, so that v
//     lands while k's statistics are taken, and q over v once the context
//     is made, which keeps 2 rows of 80 bytes per position and so 4 CTAs
//     per SM at 256 rows each.  The warps split the work so that no sum
//     crosses warps: the key softmax by 8-column chunks (ldmatrix.x2.trans
//     gives a warp 16 rows of its 8 columns: the max; then e =
//     round(exp(round(k - max))), by ex2, stored over k by stmatrix, with
//     its f32 column sum; then w = round(e / round(sum)), the quotient
//     correctly rounded from the rounded reciprocal and one fma correction,
//     stored over e), the context by 16 x 16 tiles of ctx^T (A fragments of
//     v^T and B fragments of w, both by ldmatrix.trans), the read-out by
//     16-row groups with ctx's B fragments held in registers.  N beyond
//     256 splits a head's rows over a thread-block cluster of up to 8 CTAs
//     (N = 1024: 4 x 256 rows), which exchange the column max, the column
//     sums and the ctx^T tiles through distributed shared memory and sum
//     them in rank order; N <= 16 and <= 32 take 4 and 2 heads per CTA (and
//     stage q at once), so that every warp has rows.  N is at most 8 x 1408
//     (the shared memory of 8 CTAs).  ptxas (sm_90a): 66, 78 and 92
//     registers for 1, 2 and 4 heads per CTA, no spills.  What bounds it
//     now is latency: each CTA runs its five passes in series, with a
//     cluster barrier between them, and loads nothing while it computes;
//   - float32 forward, and the backward in both types: one CTA per (b, h),
//     like the Pallas grid (B*H,); the column statistics of k first (f32: a
//     running (max, sum of exp) per column, merged in shared memory; bf16:
//     the column max, then the sum of the rounded exponentials against it,
//     since a running sum rescaled as the max grows cannot reproduce values
//     rounded against the final max); tiles of 64 rows staged in shared
//     memory as f32, turned into softmax weights on load; each thread
//     accumulates 4 entries of each D x D product as f32 FMAs (the f32
//     checks' 1e-5 rules out TF32); row-wise outputs written by warps, one
//     whole 32-wide row each.
// Sums over rows run in a fixed order (no atomics): results repeat exactly.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <cooperative_groups.h>
#include <type_traits>

#include "mma_sm90.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kD = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// v rounded to T and back (the identity for float)
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f32(from_f32<T>(v)); }

// Column statistics of k over the n rows, into col_max and col_sum (the sum
// of exp(k - max), rounded as T's softmax rounds it) and, where col_sum32 is
// given, the float32 sum with no rounding.  Uses part_a/part_b as scratch.
template <typename T>
__device__ void key_stats(const T* __restrict__ k, size_t base, int n, int c,
                          float (*part_a)[kD], float (*part_b)[kD], float* col_max,
                          float* col_sum, float* col_sum32) {
  constexpr bool kRound = std::is_same<T, __nv_bfloat16>::value;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (!kRound && col_sum32 == nullptr) {
    // float32 forward: one sweep, a running (max, sum of exp) per column
    float m = -INFINITY, s = 0.f;
    for (int r = warp; r < n; r += kWarps) {
      const float x = to_f32(k[base + (size_t)r * c + lane]);
      if (x > m) {
        s = s * expf(m - x) + 1.f;
        m = x;
      } else {
        s += expf(x - m);
      }
    }
    part_a[warp][lane] = m;
    part_b[warp][lane] = s;
    __syncthreads();
    if (tid < kD) {
      float mm = -INFINITY;
      for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, part_a[w][tid]);
      float ss = 0.f;
      for (int w = 0; w < kWarps; ++w)
        if (part_b[w][tid] > 0.f) ss += part_b[w][tid] * expf(part_a[w][tid] - mm);
      col_max[tid] = mm;
      col_sum[tid] = ss;
    }
    __syncthreads();
    return;
  }
  // the column max first, then the sums against it
  float m = -INFINITY;
  for (int r = warp; r < n; r += kWarps) m = fmaxf(m, to_f32(k[base + (size_t)r * c + lane]));
  part_a[warp][lane] = m;
  __syncthreads();
  if (tid < kD) {
    float mm = -INFINITY;
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, part_a[w][tid]);
    col_max[tid] = mm;
  }
  __syncthreads();
  const float cm = col_max[lane];
  float s = 0.f, s32 = 0.f;
  for (int r = warp; r < n; r += kWarps) {
    const float x = to_f32(k[base + (size_t)r * c + lane]);
    s += round_to<T>(expf(round_to<T>(x - cm)));
    s32 += expf(x - cm);
  }
  part_a[warp][lane] = s;
  part_b[warp][lane] = s32;
  __syncthreads();
  if (tid < kD) {
    float ss = 0.f, ss32 = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      ss += part_a[w][tid];
      ss32 += part_b[w][tid];
    }
    col_sum[tid] = round_to<T>(ss);
    if (col_sum32 != nullptr) col_sum32[tid] = ss32;
  }
  __syncthreads();
}

// softmax weight of logit x in column col, rounded as T's softmax rounds it
template <typename T>
__device__ __forceinline__ float key_weight(float x, float m, float s) {
  return round_to<T>(round_to<T>(expf(round_to<T>(x - m))) / s);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
linear_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ out, int n, int c) {
  __shared__ float part_a[kWarps][kD];
  __shared__ float part_b[kWarps][kD];
  __shared__ float col_max[kD];
  __shared__ float col_sum[kD];
  __shared__ __align__(16) float tile_a[kTile][kD];  // softmax(k) rows, later q rows
  __shared__ __align__(16) float tile_v[kTile][kD];
  __shared__ __align__(16) float ctx[kD][kD];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t base = (size_t)blockIdx.y * n * c + (size_t)blockIdx.x * kD;

  // pass 1: column max and sum of exp over the n rows
  key_stats<T>(k, base, n, c, part_a, part_b, col_max, col_sum, nullptr);

  // pass 2: ctx[d][e] = sum_r softmax(k)[r][d] * v[r][e]
  const int d = tid >> 3;
  const int e0 = (tid & 7) * 4;
  float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
  for (int n0 = 0; n0 < n; n0 += kTile) {
    for (int i = tid; i < kTile * kD; i += kThreads) {
      const int r = i / kD, col = i % kD, row = n0 + r;
      float kv = 0.f, vv = 0.f;
      if (row < n) {
        const size_t off = base + (size_t)row * c + col;
        kv = key_weight<T>(to_f32(k[off]), col_max[col], col_sum[col]);
        vv = to_f32(v[off]);
      }
      tile_a[r][col] = kv;
      tile_v[r][col] = vv;
    }
    __syncthreads();
#pragma unroll 8
    for (int r = 0; r < kTile; ++r) {
      const float kd = tile_a[r][d];
      const float4 vv = *reinterpret_cast<const float4*>(&tile_v[r][e0]);
      acc0 += kd * vv.x;
      acc1 += kd * vv.y;
      acc2 += kd * vv.z;
      acc3 += kd * vv.w;
    }
    __syncthreads();
  }
  ctx[d][e0 + 0] = round_to<T>(acc0);
  ctx[d][e0 + 1] = round_to<T>(acc1);
  ctx[d][e0 + 2] = round_to<T>(acc2);
  ctx[d][e0 + 3] = round_to<T>(acc3);
  __syncthreads();

  // pass 3: out[r][e] = sum_d q[r][d] * ctx[d][e]
  for (int n0 = 0; n0 < n; n0 += kTile) {
    for (int i = tid; i < kTile * kD; i += kThreads) {
      const int r = i / kD, col = i % kD, row = n0 + r;
      tile_a[r][col] = row < n ? to_f32(q[base + (size_t)row * c + col]) : 0.f;
    }
    __syncthreads();
    for (int r = warp; r < kTile && n0 + r < n; r += kWarps) {
      float o = 0.f;
#pragma unroll
      for (int dd = 0; dd < kD; ++dd) o += tile_a[r][dd] * ctx[dd][lane];
      out[base + (size_t)(n0 + r) * c + lane] = from_f32<T>(o);
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
linear_attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ g,
                            T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
                            int n, int c) {
  __shared__ float part_a[kWarps][kD];
  __shared__ float part_b[kWarps][kD];
  __shared__ float col_max[kD];
  __shared__ float col_sum[kD];    // as the forward rounds it
  __shared__ float col_sum32[kD];  // float32, no rounding
  __shared__ float inner[kD];
  __shared__ __align__(16) float tile_k[kTile][kD];
  __shared__ __align__(16) float tile_v[kTile][kD];
  __shared__ __align__(16) float tile_q[kTile][kD];
  __shared__ __align__(16) float tile_g[kTile][kD];
  __shared__ float ctx[kD][kD + 1];   // padded: a warp reads a column of each
  __shared__ float dctx[kD][kD + 1];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t base = (size_t)blockIdx.y * n * c + (size_t)blockIdx.x * kD;

  // pass 1: column max, the forward's sum and the float32 sum
  key_stats<T>(k, base, n, c, part_a, part_b, col_max, col_sum, col_sum32);

  // pass 2: ctx = k_sm^T v as the forward computes it, and dctx = q^T g
  const int d = tid >> 3;
  const int e0 = (tid & 7) * 4;
  float c0 = 0.f, c1 = 0.f, c2 = 0.f, c3 = 0.f;
  float g0 = 0.f, g1 = 0.f, g2 = 0.f, g3 = 0.f;
  for (int n0 = 0; n0 < n; n0 += kTile) {
    for (int i = tid; i < kTile * kD; i += kThreads) {
      const int r = i / kD, col = i % kD, row = n0 + r;
      float kv = 0.f, vv = 0.f, qv = 0.f, gv = 0.f;
      if (row < n) {
        const size_t off = base + (size_t)row * c + col;
        const float x = to_f32(k[off]);
        kv = key_weight<T>(x, col_max[col], col_sum[col]);
        vv = to_f32(v[off]);
        qv = to_f32(q[off]);
        gv = to_f32(g[off]);
      }
      tile_k[r][col] = kv;
      tile_v[r][col] = vv;
      tile_q[r][col] = qv;
      tile_g[r][col] = gv;
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < kTile; ++r) {
      const float kd = tile_k[r][d];
      const float qd = tile_q[r][d];
      const float4 vv = *reinterpret_cast<const float4*>(&tile_v[r][e0]);
      const float4 gg = *reinterpret_cast<const float4*>(&tile_g[r][e0]);
      c0 += kd * vv.x;
      c1 += kd * vv.y;
      c2 += kd * vv.z;
      c3 += kd * vv.w;
      g0 += qd * gg.x;
      g1 += qd * gg.y;
      g2 += qd * gg.z;
      g3 += qd * gg.w;
    }
    __syncthreads();
  }
  ctx[d][e0 + 0] = round_to<T>(c0);
  ctx[d][e0 + 1] = round_to<T>(c1);
  ctx[d][e0 + 2] = round_to<T>(c2);
  ctx[d][e0 + 3] = round_to<T>(c3);
  dctx[d][e0 + 0] = g0;
  dctx[d][e0 + 1] = g1;
  dctx[d][e0 + 2] = g2;
  dctx[d][e0 + 3] = g3;
  __syncthreads();

  // pass 3: per row, dq and dv; the column sums of k_sm * dk_sm
  float acc_inner = 0.f;
  for (int n0 = 0; n0 < n; n0 += kTile) {
    for (int i = tid; i < kTile * kD; i += kThreads) {
      const int r = i / kD, col = i % kD, row = n0 + r;
      float kv = 0.f, vv = 0.f, gv = 0.f;
      if (row < n) {
        const size_t off = base + (size_t)row * c + col;
        kv = expf(to_f32(k[off]) - col_max[col]) / col_sum32[col];
        vv = to_f32(v[off]);
        gv = to_f32(g[off]);
      }
      tile_k[r][col] = kv;
      tile_v[r][col] = vv;
      tile_g[r][col] = gv;
    }
    __syncthreads();
    for (int r = warp; r < kTile && n0 + r < n; r += kWarps) {
      float dq_acc = 0.f, dv_acc = 0.f, dksm = 0.f;
#pragma unroll
      for (int e = 0; e < kD; ++e) {
        dq_acc += tile_g[r][e] * ctx[lane][e];
        dv_acc += tile_k[r][e] * dctx[e][lane];
        dksm += dctx[lane][e] * tile_v[r][e];
      }
      const size_t off = base + (size_t)(n0 + r) * c + lane;
      dq[off] = from_f32<T>(dq_acc);
      dv[off] = from_f32<T>(dv_acc);
      acc_inner += tile_k[r][lane] * dksm;
    }
    __syncthreads();
  }
  part_a[warp][lane] = acc_inner;
  __syncthreads();
  if (tid < kD) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += part_a[w][tid];
    inner[tid] = s;
  }
  __syncthreads();

  // pass 4: dk = k_sm * (dk_sm - inner)
  for (int n0 = 0; n0 < n; n0 += kTile) {
    for (int i = tid; i < kTile * kD; i += kThreads) {
      const int r = i / kD, col = i % kD, row = n0 + r;
      float kv = 0.f, vv = 0.f;
      if (row < n) {
        const size_t off = base + (size_t)row * c + col;
        kv = expf(to_f32(k[off]) - col_max[col]) / col_sum32[col];
        vv = to_f32(v[off]);
      }
      tile_k[r][col] = kv;
      tile_v[r][col] = vv;
    }
    __syncthreads();
    for (int r = warp; r < kTile && n0 + r < n; r += kWarps) {
      float dksm = 0.f;
#pragma unroll
      for (int e = 0; e < kD; ++e) dksm += dctx[lane][e] * tile_v[r][e];
      dk[base + (size_t)(n0 + r) * c + lane] =
          from_f32<T>(tile_k[r][lane] * (dksm - inner[lane]));
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------------------
// The bf16 forward on the tensor cores (see the note at the head).

using bf16 = __nv_bfloat16;

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kLdh = kD + 8;           // bf16 row padded to 80 bytes: the 8 rows of
                                       // an ldmatrix read hit distinct banks
constexpr int kRowsPerCta = 256;       // rows of a head per CTA before a cluster splits N
constexpr int kMaxCluster = 8;         // the portable cluster size
constexpr int kMaxSmem = 232448;       // a CTA's shared memory on sm_90
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float lo_f32(uint32_t r) { return __uint_as_float(r << 16); }
__device__ __forceinline__ float hi_f32(uint32_t r) { return __uint_as_float(r & 0xffff0000u); }
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// the thread-block cluster: this CTA's rank, the barrier (split into its
// arrive and its wait; it orders shared-memory writes before it against
// reads after it, across the cluster), and another CTA's shared memory
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}
__device__ __forceinline__ int cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}
template <typename T>
__device__ __forceinline__ const T* remote(const T* p, int rank) {
  return cg::this_cluster().map_shared_rank(const_cast<T*>(p), rank);
}

// Fragment addresses in a staged block (row-major, kLdh a row) for lane l.
// A operand, rows r0 .. r0+15 and columns c0 .. c0+15: a0..a3 of the mma.
__device__ __forceinline__ const bf16* frag_a(const bf16* tile, int r0, int c0, int lane) {
  return tile + (r0 + (lane & 15)) * kLdh + c0 + (lane >> 4) * 8;
}
// A operand of the transpose, through ldmatrix.trans: rows c0 .. c0+15 of
// tile^T (columns of the block) and its columns r0 .. r0+15 (rows of the block)
__device__ __forceinline__ const bf16* frag_at(const bf16* tile, int r0, int c0, int lane) {
  return tile + (r0 + (lane & 7) + (lane >> 4) * 8) * kLdh + c0 + ((lane >> 3) & 1) * 8;
}
// B operand from a block stored [n][k] (b = tile^T): n0 .. n0+15 (two n8
// tiles), k0 .. k0+15; gives b0, b1 of the first n8 tile, then of the second
__device__ __forceinline__ const bf16* frag_b(const bf16* tile, int n0, int k0, int lane) {
  return tile + (n0 + (lane & 7) + (lane >> 4) * 8) * kLdh + k0 + ((lane >> 3) & 1) * 8;
}
// B operand from a block stored [k][n] (b = tile), through ldmatrix.trans:
// k0 .. k0+15, n0 .. n0+15; the same register order as frag_b
__device__ __forceinline__ const bf16* frag_b_trans(const bf16* tile, int k0, int n0,
                                                    int lane) {
  return tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdh + n0 + (lane >> 4) * 8;
}
// 16 rows r0 .. r0+15 of the 8 columns c0 .. c0+7, through ldmatrix.x2.trans
// (or stmatrix): register i holds rows 2t + 8i and 2t + 8i + 1 of column c0 + g
__device__ __forceinline__ bf16* frag_col8(bf16* tile, int r0, int c0, int lane) {
  return tile + (r0 + (lane & 15)) * kLdh + c0;
}

// Rewrites 8 columns c0 .. c0+7 of the first `groups` 16-row groups of a
// staged block in place: each value x of row r (in the block) becomes
// round(f(x, r)), f called in a fixed order.  kBatch groups' fragments are
// loaded (ldmatrix.x2.trans), transformed and stored (stmatrix) together, so
// that their chains overlap.
constexpr int kBatch = 4;

template <typename F>
__device__ __forceinline__ void map_col8(bf16* block, int groups, int c0, int lane, F f) {
  const int t = lane & 3;
  for (int g0 = 0; g0 < groups; g0 += kBatch) {
    uint32_t x[kBatch][2] = {};
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      if (g0 + b < groups) ldsm_x2_trans(x[b], frag_col8(block, 16 * (g0 + b), c0, lane));
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = 16 * (g0 + b) + 2 * t + 8 * j;
        const float lo = f(lo_f32(x[b][j]), r);
        x[b][j] = pack_bf16(lo, f(hi_f32(x[b][j]), r + 1));
      }
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      if (g0 + b < groups) stsm_x2_trans(frag_col8(block, 16 * (g0 + b), c0, lane), x[b]);
  }
}

// Sum over the quad (the 4 lanes of a row group) in a fixed order: every
// lane gets the same bits
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// The bf16 forward.  A CTA of 4 warps covers `hpc` heads (1, 2 or 4 flat
// (b, h) units, 4 / hpc warps each) and rows [rank * rows, (rank + 1) * rows)
// of them, where rank is its place in a cluster that splits N (hpc = 1
// only).  Its k and v rows are staged once by cp.async, as two groups, so
// that v lands while k's statistics are taken, and q after the context (see
// kQEarly); every later read is from shared memory.  The warps of a head
// split its work so that no sum crosses warps: the key softmax by columns
// (8-column chunks), the context by 16 x 16 tiles, the read-out by 16-row
// groups.  Across a cluster, the
// column max, the column sums and the context tiles are summed over the
// CTAs in rank order; no atomics, so the output repeats bit for bit.
template <int hpc>
__global__ void __launch_bounds__(kMmaThreads, 4)
linear_attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, bf16* __restrict__ out, int n, int c,
                            int units, int rows) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  const int block = hpc * rows * kLdh;                  // bf16 of one staged array
  bf16* ks = reinterpret_cast<bf16*>(smem_bytes);       // [hpc][rows][kLdh]: k, then
                                                        // exp, then the weights
  // q is staged over v once the context is made, which saves a third of the
  // shared memory (more CTAs per SM) where a head has many rows; with
  // several heads per CTA (a few rows each) it is staged at once instead
  constexpr bool kQEarly = hpc > 1;
  bf16* vs = ks + block;                                // v (and then q)
  bf16* qs = kQEarly ? vs + block : vs;
  bf16* ctxb = qs + block;                              // [hpc][kD][kLdh]: ctx^T, bf16
  float* col_max = reinterpret_cast<float*>(ctxb + hpc * kD * kLdh);   // [hpc][kD]
  float* col_sum = col_max + hpc * kD;                  // [hpc][kD]
  float* ctx_cta = col_sum + hpc * kD;                  // [hpc][kD][kD]: ctx^T, f32

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int csize = cluster_size(), rank = cluster_rank();
  const int unit0 = (blockIdx.x / csize) * hpc;
  const int row0 = rank * rows;                         // this CTA's first row
  const int heads = c / kD;
  auto unit_base = [&](int u) {                         // element offset of unit u's row 0
    return (size_t)(u / heads) * n * c + (size_t)(u % heads) * kD;
  };

  // stage this CTA's rows of x (k, v or q) into dst as one cp.async group;
  // rows at or past n, and units past the last, are zero-filled
  const int rows_in = min(rows, n - row0);              // rows < n
  auto stage = [&](bf16* dst, const bf16* __restrict__ x) {
#pragma unroll
    for (int hh = 0; hh < hpc; ++hh) {
      const bool unit_ok = unit0 + hh < units;
      const bf16* src = x + (unit_ok ? unit_base(unit0 + hh) + (size_t)row0 * c : 0);
      for (int i = tid; i < rows * 4; i += kMmaThreads) {
        const int r = i >> 2, ch = 8 * (i & 3);
        const bool valid = unit_ok && r < rows_in;
        cp_async16(dst + (hh * rows + r) * kLdh + ch, src + (valid ? (size_t)r * c + ch : 0),
                   valid);
      }
    }
    cp_async_commit();
  };
  stage(ks, k);                                         // k, then v (and q)
  stage(vs, v);
  if constexpr (kQEarly) stage(qs, q);

  constexpr int wph = kMmaWarps / hpc;                  // warps per head
  const int hh = warp / wph, wr = warp % wph;
  bf16* kh = ks + hh * rows * kLdh;
  const bf16* vh = vs + hh * rows * kLdh;
  const bf16* qh = qs + hh * rows * kLdh;
  bf16* ch = ctxb + hh * kD * kLdh;
  const int groups = (rows_in + 15) / 16;               // 16-row groups holding rows < n
  constexpr int chunks = hpc;                           // this warp's 8-column chunks:
                                                        // wr + wph * i, column 8 (..) + g

  // the key softmax, by columns: pass 1, the column max
  if constexpr (kQEarly) cp_async_wait<2>(); else cp_async_wait<1>();
  __syncthreads();                                      // k has landed
  float cm[chunks], cs[chunks];
#pragma unroll
  for (int i = 0; i < chunks; ++i) {
    const int c0 = 8 * (wr + wph * i);
    float m = -INFINITY;
#pragma unroll 4
    for (int gi = 0; gi < groups; ++gi) {
      uint32_t x[2];
      ldsm_x2_trans(x, frag_col8(kh, 16 * gi, c0, lane));
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = 16 * gi + 2 * t + 8 * j;
        if (r < rows_in) m = fmaxf(m, lo_f32(x[j]));
        if (r + 1 < rows_in) m = fmaxf(m, hi_f32(x[j]));
      }
    }
    cm[i] = quad_max(m);
  }
  if (csize > 1) {                                      // the max over the cluster
#pragma unroll
    for (int i = 0; i < chunks; ++i)
      if (t == 0) col_max[hh * kD + 8 * (wr + wph * i) + g] = cm[i];
    cluster_sync();
#pragma unroll
    for (int i = 0; i < chunks; ++i) {
      const int d = hh * kD + 8 * (wr + wph * i) + g;
      float m = -INFINITY;
      for (int r = 0; r < csize; ++r) m = fmaxf(m, *remote(col_max + d, r));
      cm[i] = m;
    }
  }

  // pass 2: e = round(exp(round(k - max))), stored over k, and its column
  // sum in f32
#pragma unroll
  for (int i = 0; i < chunks; ++i) {
    float s = 0.f;
    map_col8(kh, groups, 8 * (wr + wph * i), lane, [&](float x, int r) {
      const float e = bf16_round(exp2f(bf16_round(x - cm[i]) * kLog2e));
      if (r < rows_in) s += e;
      return e;
    });
    cs[i] = quad_sum(s);
  }
  if (csize > 1) {                                      // the sum over the cluster, in order
#pragma unroll
    for (int i = 0; i < chunks; ++i)
      if (t == 0) col_sum[hh * kD + 8 * (wr + wph * i) + g] = cs[i];
    cluster_sync();
#pragma unroll
    for (int i = 0; i < chunks; ++i) {
      const int d = hh * kD + 8 * (wr + wph * i) + g;
      float s = 0.f;
      for (int r = 0; r < csize; ++r) s += *remote(col_sum + d, r);
      cs[i] = s;
    }
  }

  // pass 3: the weights w = round(e / round(sum)), stored over e; zero at
  // rows at or past n.  e / s correctly rounded in three operations: the
  // product with the rounded reciprocal, corrected once by its fma residual
  // (Markstein), as the division would give it
#pragma unroll
  for (int i = 0; i < chunks; ++i) {
    const float s = bf16_round(cs[i]), rs = __frcp_rn(s);
    map_col8(kh, groups, 8 * (wr + wph * i), lane, [&](float e, int r) {
      const float q1 = e * rs;
      return r < rows_in ? fmaf(fmaf(-q1, s, e), rs, q1) : 0.f;
    });
  }
  if constexpr (kQEarly) cp_async_wait<1>(); else cp_async_wait<0>();
  __syncthreads();                                      // the weights, and v has landed

  // pass 4: ctx^T = v^T w (f32), by 16 x 16 tiles (e: mt, d: dh) of the
  // head: this warp's tiles are wr + wph * i; element e of n8 tile j is
  // ctx^T[16 mt + g + 8 (e / 2)][16 dh + 8 j + 2 t + e % 2]
  constexpr int tiles = hpc;
  float acc[tiles][2][4];
#pragma unroll
  for (int i = 0; i < tiles; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
#pragma unroll 4
  for (int gi = 0; gi < groups; ++gi) {
#pragma unroll
    for (int i = 0; i < tiles; ++i) {
      const int tile = wr + wph * i, mt = tile >> 1, dh = tile & 1;
      uint32_t va[4], wb[4];
      ldsm_x4_trans(va, frag_at(vh, 16 * gi, 16 * mt, lane));
      ldsm_x4_trans(wb, frag_b_trans(kh, 16 * gi, 16 * dh, lane));
      mma_bf16(acc[i][0], va, wb[0], wb[1]);
      mma_bf16(acc[i][1], va, wb[2], wb[3]);
    }
  }
  if constexpr (!kQEarly) {
    __syncthreads();                                    // v is read: q goes over it
    stage(qs, q);
  }
  auto ctx_at = [&](int i, int j, int half) {          // offset of (c0, c1) or (c2, c3)
    const int tile = wr + wph * i;
    return (16 * (tile >> 1) + g + 8 * half) * kD + 16 * (tile & 1) + 8 * j + 2 * t;
  };
  if (csize > 1) {                                      // the sum over the cluster, in order
    float* mine = ctx_cta + hh * kD * kD;
#pragma unroll
    for (int i = 0; i < tiles; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          *reinterpret_cast<float2*>(mine + ctx_at(i, j, half)) =
              make_float2(acc[i][j][2 * half], acc[i][j][2 * half + 1]);
    }
    cluster_sync();
#pragma unroll
    for (int i = 0; i < tiles; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float2 s = make_float2(0.f, 0.f);
          for (int r = 0; r < csize; ++r) {
            const float2 x = *reinterpret_cast<const float2*>(remote(mine + ctx_at(i, j, half), r));
            s.x += x.x;
            s.y += x.y;
          }
          acc[i][j][2 * half] = s.x;
          acc[i][j][2 * half + 1] = s.y;
        }
    }
    cluster_arrive();                                   // this CTA reads no other's memory again
  }
  // ctx rounded to bf16, stored as ctx^T [e][d]: the B operand of the read-out
#pragma unroll
  for (int i = 0; i < tiles; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int off = ctx_at(i, j, half);
        *reinterpret_cast<uint32_t*>(ch + (off / kD) * kLdh + off % kD) =
            pack_bf16(acc[i][j][2 * half], acc[i][j][2 * half + 1]);
      }
  }
  cp_async_wait<0>();
  __syncthreads();                                      // the context, and q has landed

  // pass 5: out = q ctx, by 16-row groups; the context's B fragments held
  uint32_t cb[2][2][4];                                 // [k16 chunk of d][16 columns e]
#pragma unroll
  for (int kc = 0; kc < 2; ++kc)
#pragma unroll
    for (int ne = 0; ne < 2; ++ne) ldsm_x4(cb[kc][ne], frag_b(ch, 16 * ne, 16 * kc, lane));
  const int u = unit0 + hh;
  if (u < units) {
    bf16* dst = out + unit_base(u);
    for (int gi = wr; gi < groups; gi += wph) {
      float o[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < 2; ++kc) {
        uint32_t qa[4];
        ldsm_x4(qa, frag_a(qh, 16 * gi, 16 * kc, lane));
#pragma unroll
        for (int ne = 0; ne < 2; ++ne) {
          mma_bf16(o[2 * ne], qa, cb[kc][ne][0], cb[kc][ne][1]);
          mma_bf16(o[2 * ne + 1], qa, cb[kc][ne][2], cb[kc][ne][3]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row0 + 16 * gi + g + 8 * i;
        if (row >= n) continue;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)row * c + 8 * nt + 2 * t) =
              __floats2bfloat162_rn(o[nt][2 * i], o[nt][2 * i + 1]);
      }
    }
  }
  if (csize > 1) cluster_wait();                        // no CTA leaves while another reads it
}

// How the bf16 forward covers (b, n, heads): heads per CTA, rows per CTA,
// the cluster size, and the shared memory it takes.  Small n takes several
// heads per CTA so that its 4 warps each have rows; large n splits a head's
// rows over a cluster of up to 8 CTAs of about kRowsPerCta rows each.
struct MmaPlan {
  int hpc, rows, cluster;
  size_t smem;
};

MmaPlan mma_plan(int n) {
  MmaPlan p;
  const int groups = (n + 15) / 16;
  p.hpc = groups == 1 ? 4 : groups == 2 ? 2 : 1;
  const int ctas = (n + kRowsPerCta - 1) / kRowsPerCta;
  p.cluster = p.hpc > 1 ? 1 : ctas < kMaxCluster ? ctas : kMaxCluster;
  p.rows = ((n + p.cluster - 1) / p.cluster + 15) / 16 * 16;
  p.cluster = (n + p.rows - 1) / p.rows;
  p.smem = (size_t)((p.hpc > 1 ? 3 : 2) * p.rows + kD) * p.hpc * kLdh * sizeof(bf16) +
           (size_t)(2 * kD + kD * kD) * p.hpc * sizeof(float);
  return p;
}

int launch_mma(const bf16* q, const bf16* k, const bf16* v, bf16* out, int b, int n, int heads,
               cudaStream_t stream) {
  const MmaPlan p = mma_plan(n);
  if (p.smem > kMaxSmem) return cudaErrorInvalidValue;
  const int units = b * heads;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((units + p.hpc - 1) / p.hpc * p.cluster);
  config.blockDim = dim3(kMmaThreads);
  config.dynamicSmemBytes = p.smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = p.cluster > 1 ? 1 : 0;              // one CTA: no cluster
  auto kernel = p.hpc == 4 ? linear_attention_mma_kernel<4>
                : p.hpc == 2 ? linear_attention_mma_kernel<2> : linear_attention_mma_kernel<1>;
  if (cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(p.smem)))
    return err;
  return cudaLaunchKernelEx(&config, kernel, q, k, v, out, n, heads * kD, units, p.rows);
}

bool bad_shape(int b, int n, int heads) {
  return b <= 0 || n <= 0 || heads <= 0 || b > 65535 || heads > 65535;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int b, int n, int heads,
           void* stream) {
  if (bad_shape(b, n, heads)) return cudaErrorInvalidValue;
  const dim3 grid(heads, b);
  linear_attention_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), n, heads * kD);
  return cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* g, void* dq, void* dk,
               void* dv, int b, int n, int heads, void* stream) {
  if (bad_shape(b, n, heads)) return cudaErrorInvalidValue;
  const dim3 grid(heads, b);
  linear_attention_bwd_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv),
      n, heads * kD);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out: (b, n, heads * 32) contiguous.  Returns the CUDA error code
// of the launch (0 on success).
extern "C" int igm_linear_attention_f32(const void* q, const void* k, const void* v, void* out,
                                        int b, int n, int heads, void* stream) {
  return launch<float>(q, k, v, out, b, n, heads, stream);
}

// bf16: q, k, v and out start on a 16-byte boundary; n at most 8 x 1408.
extern "C" int igm_linear_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                         int b, int n, int heads, void* stream) {
  if (bad_shape(b, n, heads)) return cudaErrorInvalidValue;
  if ((int64_t)b * heads > INT_MAX) return cudaErrorInvalidValue;
  const cudaError_t err = static_cast<cudaError_t>(launch_mma(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), b, n, heads, static_cast<cudaStream_t>(stream)));
  return err != cudaSuccess ? err : cudaGetLastError();
}

// q, k, v, g (the output's gradient), dq, dk, dv: (b, n, heads * 32)
// contiguous.  Returns the CUDA error code of the launch (0 on success).
extern "C" int igm_linear_attention_bwd_f32(const void* q, const void* k, const void* v,
                                            const void* g, void* dq, void* dk, void* dv, int b,
                                            int n, int heads, void* stream) {
  return launch_bwd<float>(q, k, v, g, dq, dk, dv, b, n, heads, stream);
}

extern "C" int igm_linear_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                             const void* g, void* dq, void* dk, void* dv, int b,
                                             int n, int heads, void* stream) {
  return launch_bwd<__nv_bfloat16>(q, k, v, g, dq, dk, dv, b, n, heads, stream);
}
