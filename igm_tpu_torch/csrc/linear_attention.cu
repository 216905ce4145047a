// Linear attention forward for Hopper (sm_90a), read in the head-folded
// ("flat") layout.
//
// Replaces the Pallas TPU kernel igm_tpu/ops/pallas_attention.py
// linear_attention_pallas (_linattn_kernel), and computes exactly what the
// default XLA path igm_tpu/ops/attention.py linear_attention_flat computes:
// q, k, v are (B, N, H*D) with D = 32; head h is the channel slice
// [h*D, (h+1)*D).  Per (b, h):
//   k_sm = softmax of k over the N positions (per column),
//   ctx  = k_sm^T v                       (D x D, f32 accumulation),
//   out  = q ctx                          (q unscaled),
// with ctx rounded to the input type before the read-out, as
// _flat_fwd (attention.py:92-96) casts it.  The flat layout is read in
// place: no transpose to (B*H, N, D) and no copy.
//
// What bounds it on this card: bytes.  It moves q, k, v and out once each
// (k is swept twice: the second sweep mostly hits L2) against 4*D = 128
// operations per position of a head, about 16 operations per byte in bf16,
// far below the ~295 at which the tensor cores would be the limit.  So the
// D x D products run on the CUDA cores in f32.
// The design keeps the (N, D) softmax and the context out of device
// memory:
//   - one CTA per (b, h), like the Pallas grid (B*H,);
//   - pass 1: each thread keeps a running (max, sum of exp) for its column
//     over a strided set of rows (online softmax), merged in shared memory;
//   - pass 2: tiles of 64 rows of k (turned into softmax weights on load)
//     and v are staged in shared memory and each thread accumulates 4
//     entries of ctx in registers;
//   - pass 3: tiles of q are staged and each warp writes whole 32-wide
//     output rows, so loads and stores of a warp cover one row.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
linear_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ out, int n, int c) {
  __shared__ float part_max[kWarps][kD];
  __shared__ float part_sum[kWarps][kD];
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
  part_max[warp][lane] = m;
  part_sum[warp][lane] = s;
  __syncthreads();
  if (tid < kD) {
    float mm = -INFINITY;
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, part_max[w][tid]);
    float ss = 0.f;
    for (int w = 0; w < kWarps; ++w)
      if (part_sum[w][tid] > 0.f) ss += part_sum[w][tid] * expf(part_max[w][tid] - mm);
    col_max[tid] = mm;
    col_sum[tid] = ss;
  }
  __syncthreads();

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
        kv = expf(to_f32(k[off]) - col_max[col]) / col_sum[col];
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
  ctx[d][e0 + 0] = to_f32(from_f32<T>(acc0));
  ctx[d][e0 + 1] = to_f32(from_f32<T>(acc1));
  ctx[d][e0 + 2] = to_f32(from_f32<T>(acc2));
  ctx[d][e0 + 3] = to_f32(from_f32<T>(acc3));
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
int launch(const void* q, const void* k, const void* v, void* out, int b, int n, int heads,
           void* stream) {
  if (b <= 0 || n <= 0 || heads <= 0 || b > 65535) return cudaErrorInvalidValue;
  const dim3 grid(heads, b);
  linear_attention_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), n, heads * kD);
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
