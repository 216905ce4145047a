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
// far below the ~295 operations per byte at which the H100's compute would
// take over.  So the design aims at full-width coalesced traffic and keeps
// every intermediate out of device memory:
//   - one CTA per sample, like the Pallas grid (N,).  Its threads sweep the
//     sample's (H*W, C) tile as rows of C contiguous values, 16 bytes per
//     thread per load where the channel layout allows it, so a warp reads
//     whole rows;
//   - pass 1 keeps per-thread sums in registers and reduces them through
//     shared memory in a fixed order (no atomics: results do not change from
//     run to run);
//   - pass 2 reads the tile again (one sample is at most a few hundred KB,
//     so the re-read mostly hits L2) and writes the output once;
//   - the backward adds a pass: pass 2 sums the per-channel and per-group
//     terms of the gradient, pass 3 re-reads x and g and writes dx.
// No atomics anywhere, so results repeat exactly from run to run.
// Softplus is max(y, 0) + log1p(exp(-|y|)): the form jax.nn.softplus
// (logaddexp(y, 0)) evaluates, stable for large |y| of either sign.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

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
// (blockIdx.y 1): one thread per channel, the samples in order.
__global__ void sum_partials_kernel(const float* __restrict__ dgamma_part,
                                    const float* __restrict__ dbeta_part,
                                    float* __restrict__ dgamma, float* __restrict__ dbeta,
                                    int n, int c) {
  const int ch = blockIdx.x * blockDim.x + threadIdx.x;
  if (ch >= c) return;
  const float* part = blockIdx.y == 0 ? dgamma_part : dbeta_part;
  float s = 0.f;
  for (int i = 0; i < n; ++i) s += part[(size_t)i * c + ch];
  (blockIdx.y == 0 ? dgamma : dbeta)[ch] = s;
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

template <typename T, int VEC>
cudaError_t launch_bwd_vec(const void* x, const void* gamma, const void* beta, const void* g,
                           void* dx, void* dgamma_part, void* dbeta_part, void* dgamma,
                           void* dbeta, int n, int hw, int c, int groups, float eps,
                           cudaStream_t stream) {
  const int chunks = c / VEC;
  const int threads = (kMaxThreads / chunks) * chunks;
  group_norm_mish_bwd_kernel<T, VEC><<<n, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const T*>(g), static_cast<T*>(dx),
      static_cast<float*>(dgamma_part), static_cast<float*>(dbeta_part), hw, c, groups, eps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((c + 127) / 128, 2);
  sum_partials_kernel<<<grid, 128, 0, stream>>>(
      static_cast<const float*>(dgamma_part), static_cast<const float*>(dbeta_part),
      static_cast<float*>(dgamma), static_cast<float*>(dbeta), n, c);
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
  if (vectorised<T>({x, out}, c, groups))
    return launch_vec<T, 16 / sizeof(T)>(x, gamma, beta, out, n, hw, c, groups, eps, s);
  if (c > kMaxThreads) return cudaErrorInvalidValue;
  return launch_vec<T, 1>(x, gamma, beta, out, n, hw, c, groups, eps, s);
}

template <typename T>
int launch_bwd(const void* x, const void* gamma, const void* beta, const void* g, void* dx,
               void* dgamma_part, void* dbeta_part, void* dgamma, void* dbeta, int n, int hw,
               int c, int groups, float eps, void* stream) {
  if (bad_shape(n, hw, c, groups)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vectorised<T>({x, g, dx}, c, groups))
    return launch_bwd_vec<T, 16 / sizeof(T)>(x, gamma, beta, g, dx, dgamma_part, dbeta_part,
                                             dgamma, dbeta, n, hw, c, groups, eps, s);
  if (c > kMaxThreads) return cudaErrorInvalidValue;
  return launch_bwd_vec<T, 1>(x, gamma, beta, g, dx, dgamma_part, dbeta_part, dgamma, dbeta,
                              n, hw, c, groups, eps, s);
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
