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
// once each against 4*D = 128 operations per position of a head, about 16
// operations per byte in bf16; the backward moves 7 arrays against ~10*D
// operations per position.  Both are far below the ~295 operations per byte
// at which the tensor cores would be the limit, so the D x D products run on
// the CUDA cores in f32.  The designs keep the (N, D) softmax, the context
// and its gradient out of device memory:
//   - one CTA per (b, h), like the Pallas grid (B*H,);
//   - the column statistics of k come first (float32: a running (max, sum of
//     exp) per column, merged in shared memory; bf16: the column max, then
//     the sum of the rounded exponentials against it, since a running sum
//     rescaled as the max grows cannot reproduce values rounded against the
//     final max);
//   - tiles of 64 rows are staged in shared memory, turned into softmax
//     weights on load, and each thread accumulates 4 entries of each D x D
//     product in registers;
//   - row-wise outputs are written by warps, one whole 32-wide row each, so
//     loads and stores of a warp cover one row.
// Sums over rows run in a fixed order (no atomics): results repeat exactly.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

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

extern "C" int igm_linear_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                         int b, int n, int heads, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, b, n, heads, stream);
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
