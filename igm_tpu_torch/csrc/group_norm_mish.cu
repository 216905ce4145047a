// Fused GroupNorm + Mish forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel igm_tpu/ops/pallas_groupnorm.py
// group_norm_mish (_fwd_kernel): for each sample of an NHWC activation,
// GroupNorm(groups, eps) with one-pass f32 statistics
// (var = max(E[x^2] - E[x]^2, 0), inv = rsqrt(var + eps)), the per-channel
// affine, then Mish(y) = y * tanh(softplus(y)).  bf16 or f32 in, the same
// type out; statistics and arithmetic in f32.
//
// What bounds it on this card: bytes.  It does a few dozen operations per
// element against one read and one write, far below the ~295 operations per
// byte at which the H100's compute would take over.  So the design aims at
// full-width coalesced traffic and keeps every intermediate out of device
// memory:
//   - one CTA per sample, like the Pallas grid (N,).  Its threads sweep the
//     sample's (H*W, C) tile as rows of C contiguous values, 16 bytes per
//     thread per load where the channel layout allows it, so a warp reads
//     whole rows;
//   - pass 1 keeps per-thread sums in registers and reduces them through
//     shared memory in a fixed order (no atomics: results do not change from
//     run to run);
//   - pass 2 reads the tile again (one sample is at most a few hundred KB,
//     so the re-read mostly hits L2) and writes the output once.
// Softplus is max(y, 0) + log1p(exp(-|y|)): the form jax.nn.softplus
// (logaddexp(y, 0)) evaluates, stable for large |y| of either sign.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ float mish(float y) {
  const float sp = fmaxf(y, 0.f) + log1pf(expf(-fabsf(y)));
  return y * tanhf(sp);
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
  const int chunk = tid % chunks;
  const int row0 = tid / chunks;
  const int rows_per_step = blockDim.x / chunks;
  const int cg = c / groups;
  const int c0 = chunk * VEC;
  const size_t base = (size_t)blockIdx.x * hw * c;
  const T* xs = x + base;
  T* os = out + base;

  // pass 1: per-thread sums of x and x^2 over its rows
  float s1 = 0.f, s2 = 0.f;
#pragma unroll 4
  for (int r = row0; r < hw; r += rows_per_step) {
    const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(xs + (size_t)r * c + c0);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float v = to_f32(p.v[j]);
      s1 += v;
      s2 += v * v;
    }
  }
  red1[tid] = s1;
  red2[tid] = s2;
  __syncthreads();
  // per chunk: add the other rows' partials (thread tid keeps row 0's)
  if (tid < chunks) {
    for (int t = tid + chunks; t < rows_per_step * chunks; t += chunks) {
      s1 += red1[t];
      s2 += red2[t];
    }
  }
  __syncthreads();
  if (tid < chunks) {
    red1[tid] = s1;
    red2[tid] = s2;
  }
  __syncthreads();
  // per group: add its chunks, then the one-pass statistics
  if (tid < groups) {
    const int per_group = cg / VEC;
    float a = 0.f, b = 0.f;
    for (int j = 0; j < per_group; ++j) {
      a += red1[tid * per_group + j];
      b += red2[tid * per_group + j];
    }
    const float n = (float)hw * (float)cg;
    const float mean = a / n;
    const float var = fmaxf(b / n - mean * mean, 0.f);
    group_mean[tid] = mean;
    group_inv[tid] = rsqrtf(var + eps);
  }
  __syncthreads();

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

template <typename T>
int launch(const void* x, const void* gamma, const void* beta, void* out, int n, int hw,
           int c, int groups, float eps, void* stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (n <= 0 || hw <= 0 || c <= 0 || groups <= 0 || c % groups != 0)
    return cudaErrorInvalidValue;
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (aligned && (c / groups) % kVec == 0 && c / kVec <= kMaxThreads)
    return launch_vec<T, kVec>(x, gamma, beta, out, n, hw, c, groups, eps, s);
  if (c > kMaxThreads) return cudaErrorInvalidValue;
  return launch_vec<T, 1>(x, gamma, beta, out, n, hw, c, groups, eps, s);
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
