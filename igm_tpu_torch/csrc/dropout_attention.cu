// Causal flash attention with in-kernel attention-probs dropout for Hopper
// (sm_90a): forward, dq and dk/dv kernels, in float32 and bfloat16.
//
// Replaces the Pallas TPU kernels of igm_tpu/ops/pallas_dropout_attention.py:
// _call_fwd (_fwd_kernel), _dq_kernel and _dkv_kernel, and computes what they
// compute.  q, k, v, do and the outputs are (B, S, H, D) with D = 64, read in
// that layout (row stride H*D); lse and delta are (B*H, S) float32.  For each
// (b, h) with bh = b*H + h, query i and key j <= i:
//   s = (q_i . k_j) * sm_scale            (float32; j > i masked to -1e30)
//   forward: online softmax over the key tiles, m and l per row, l summing
//     the undropped p = exp(s - m); acc += round_T(p * f) @ v; o = acc / l,
//     lse = m + log(l);
//   dq:  p = exp(s - lse), g = (do_i . v_j) * f, ds = p * (g - delta_i),
//     dq = sum_j round_T(ds) k_j * sm_scale;
//   dkv: dv = sum_i round_T(p * f) do_i, dk = sum_i round_T(ds) q_i * sm_scale,
// where round_T rounds to the operand type (the identity in float32), as the
// Pallas kernels cast p and ds before their products, and f is the dropout
// factor: keep_scale where hash(seed + bh, i, j) >= thresh, else 0, or 1
// without dropout.  The hash is the Pallas kernel's murmur3-style finalizer
// on uint32 (_hash_bits) of the GLOBAL query and key indices, so the tiles
// cannot change the mask; the seed is read from device memory, as the Pallas
// kernel reads seed_ref, and gets bh added with uint32 wrap-around.
//
// What bounds them on this card, at TAR's B=128, H=4, S=785, D=64 in bf16:
// the forward reads q, k, v and writes o and lse, 207 MB (0.062 ms at
// 3.35 TB/s); its two products over the causal half are 40 GFLOP (0.041 ms
// at the 989 TFLOP/s of the bf16 tensor cores); the hash, with its row and
// column terms hoisted, is 11 integer operations for each of the 158 M live
// (i, j) pairs (0.104 ms at the CUDA cores' ~16.7 T int32 ops/s).  dq and
// dk/dv move 260 and 312 MB (0.078 and 0.093 ms) and do 3 and 4 products,
// and regenerate the hash.  So at rate 0.1 the hash bounds all three
// kernels, at 0.104 ms.  These first kernels are the simple,
// right version: every product is a float32 FMA on the CUDA cores (67
// TFLOP/s), from tiles staged in shared memory as float32:
//   - forward and dq: one block of 256 threads per (64-query tile, b*h); a
//     loop inside the block walks the causally live 64-key tiles;
//   - dk/dv: one block per (64-key tile, b*h), walking the live query tiles;
//   - each thread owns 4 rows x 4 columns of a 64 x 64 tile (rows ty + 16i,
//     columns tx + 16j), so tiles padded to 65 floats a row are read without
//     bank conflicts; row max and row sum reduce over the 16 lanes of a row;
//   - the ragged edge (S = 785 is no multiple of 64) is masked in the kernel:
//     rows past S load as zeros and are neither used nor stored;
//   - no atomics: every sum runs in a fixed order, so gradients repeat bit
//     for bit across runs.
// Moving the products to mma.sync or wgmma bf16 with float32 accumulation
// (the bf16 path) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;                      // head dim
constexpr int kTile = 64;                   // query or key rows per tile
constexpr int kLd = kD + 1;                 // staged row, padded against bank conflicts
constexpr int kTileFloats = kTile * kLd;
constexpr int kThreads = 256;
constexpr int kSide = 16;                   // 16 x 16 threads over a 64 x 64 tile
constexpr int kPer = kTile / kSide;         // rows and columns per thread
constexpr float kNegInf = -1e30f;           // the Pallas kernels' mask value

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

__device__ __forceinline__ uint32_t hash_bits(uint32_t seed, uint32_t qi, uint32_t kj) {
  uint32_t h = (qi * 0x9E3779B1u) ^ (kj * 0x85EBCA77u) ^ seed;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

struct Dropout {
  bool on;
  uint32_t seed, thresh;
  float keep_scale;
  __device__ __forceinline__ float factor(int qi, int kj) const {
    return hash_bits(seed, (uint32_t)qi, (uint32_t)kj) >= thresh ? keep_scale : 0.0f;
  }
};

__device__ __forceinline__ Dropout make_dropout(const int64_t* seed, int bh, uint32_t thresh,
                                                float keep_scale, int on) {
  Dropout d;
  d.on = on != 0;
  d.seed = d.on ? (uint32_t)(uint64_t)seed[0] + (uint32_t)bh : 0u;
  d.thresh = thresh;
  d.keep_scale = keep_scale;
  return d;
}

// Rows [row0, row0 + 64) of head h of batch b of a (B, S, H, D) tensor into
// dst[64][kLd] as float32; rows at or past s are zero.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src, int b, int h,
                                      int s, int nh, int row0) {
  for (int i = threadIdx.x; i < kTile * kD; i += kThreads) {
    const int r = i / kD, d = i % kD, row = row0 + r;
    dst[r * kLd + d] = row < s ? to_f32(src[(((size_t)b * s + row) * nh + h) * kD + d]) : 0.0f;
  }
}

// acc[i][j] = sum_d a[ty + 16i][d] * b[tx + 16j][d]
__device__ __forceinline__ void dot_rows(const float* a, const float* b, int ty, int tx,
                                         float acc[kPer][kPer]) {
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kPer; ++j) acc[i][j] = 0.0f;
#pragma unroll 8
  for (int d = 0; d < kD; ++d) {
    float av[kPer], bv[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) av[i] = a[(ty + kSide * i) * kLd + d];
#pragma unroll
    for (int j = 0; j < kPer; ++j) bv[j] = b[(tx + kSide * j) * kLd + d];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc[i][j] += sum_c a[ty + 16i][c] * b[c][tx + 16j]
__device__ __forceinline__ void mul_acc(const float* a, const float* b, int ty, int tx,
                                        float acc[kPer][kPer]) {
#pragma unroll 8
  for (int c = 0; c < kTile; ++c) {
    float av[kPer], bv[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) av[i] = a[(ty + kSide * i) * kLd + c];
#pragma unroll
    for (int j = 0; j < kPer; ++j) bv[j] = b[c * kLd + tx + kSide * j];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc[i][j] += sum_r a[r][ty + 16i] * b[r][tx + 16j]
__device__ __forceinline__ void mul_acc_t(const float* a, const float* b, int ty, int tx,
                                          float acc[kPer][kPer]) {
#pragma unroll 8
  for (int r = 0; r < kTile; ++r) {
    float av[kPer], bv[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) av[i] = a[r * kLd + ty + kSide * i];
#pragma unroll
    for (int j = 0; j < kPer; ++j) bv[j] = b[r * kLd + tx + kSide * j];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// the 16 threads of a row are 16 consecutive lanes: xor offsets below 16
// stay inside them
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = kSide / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = kSide / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dropout_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const int64_t* __restrict__ seed,
                             T* __restrict__ o, float* __restrict__ lse, int s, int nh,
                             float sm_scale, uint32_t thresh, float keep_scale, int dropout) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kTileFloats;
  float* vs = ks + kTileFloats;
  float* ps = vs + kTileFloats;
  const int qt = blockIdx.x, bh = blockIdx.y, b = bh / nh, h = bh % nh;
  const int ty = threadIdx.x / kSide, tx = threadIdx.x % kSide;
  const int q0 = qt * kTile;
  const Dropout drop = make_dropout(seed, bh, thresh, keep_scale, dropout);

  float m[kPer], l[kPer], acc[kPer][kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kPer; ++j) acc[i][j] = 0.0f;
  }
  stage(qs, q, b, h, s, nh, q0);
  for (int kt = 0; kt <= qt; ++kt) {           // the causally live key tiles
    const int k0 = kt * kTile;
    __syncthreads();                           // the last tiles have been read
    stage(ks, k, b, h, s, nh, k0);
    stage(vs, v, b, h, s, nh, k0);
    __syncthreads();
    float sc[kPer][kPer];
    dot_rows(qs, ks, ty, tx, sc);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int qi = q0 + ty + kSide * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int kj = k0 + tx + kSide * j;
        sc[i][j] = kj <= qi ? sc[i][j] * sm_scale : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        float p = expf(sc[i][j] - m_new);
        sum += p;
        if (drop.on) p *= drop.factor(qi, k0 + tx + kSide * j);
        ps[(ty + kSide * i) * kLd + tx + kSide * j] = round_to<T>(p);
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kPer; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    mul_acc(ps, vs, ty, tx, acc);
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int qi = q0 + ty + kSide * i;
    if (qi >= s) continue;
    T* row = o + (((size_t)b * s + qi) * nh + h) * kD;
#pragma unroll
    for (int j = 0; j < kPer; ++j) row[tx + kSide * j] = from_f32<T>(acc[i][j] / l[i]);
    if (tx == 0) lse[(size_t)bh * s + qi] = m[i] + logf(l[i]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dropout_attention_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            const int64_t* __restrict__ seed, T* __restrict__ dq, int s, int nh,
                            float sm_scale, uint32_t thresh, float keep_scale, int dropout) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kTileFloats;
  float* ks = dos + kTileFloats;
  float* vs = ks + kTileFloats;
  float* dss = vs + kTileFloats;
  const int qt = blockIdx.x, bh = blockIdx.y, b = bh / nh, h = bh % nh;
  const int ty = threadIdx.x / kSide, tx = threadIdx.x % kSide;
  const int q0 = qt * kTile;
  const Dropout drop = make_dropout(seed, bh, thresh, keep_scale, dropout);

  float row_lse[kPer], row_delta[kPer], acc[kPer][kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int qi = q0 + ty + kSide * i;
    row_lse[i] = qi < s ? lse[(size_t)bh * s + qi] : 0.0f;
    row_delta[i] = qi < s ? delta[(size_t)bh * s + qi] : 0.0f;
#pragma unroll
    for (int j = 0; j < kPer; ++j) acc[i][j] = 0.0f;
  }
  stage(qs, q, b, h, s, nh, q0);
  stage(dos, dout, b, h, s, nh, q0);
  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    stage(ks, k, b, h, s, nh, k0);
    stage(vs, v, b, h, s, nh, k0);
    __syncthreads();
    float sc[kPer][kPer], g[kPer][kPer];
    dot_rows(qs, ks, ty, tx, sc);
    dot_rows(dos, vs, ty, tx, g);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int qi = q0 + ty + kSide * i;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int kj = k0 + tx + kSide * j;
        const bool live = kj <= qi && qi < s;
        const float p = live ? expf(sc[i][j] * sm_scale - row_lse[i]) : 0.0f;
        float gg = g[i][j];
        if (drop.on) gg *= drop.factor(qi, kj);
        dss[(ty + kSide * i) * kLd + tx + kSide * j] = round_to<T>(p * (gg - row_delta[i]));
      }
    }
    __syncthreads();
    mul_acc(dss, ks, ty, tx, acc);
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int qi = q0 + ty + kSide * i;
    if (qi >= s) continue;
    T* row = dq + (((size_t)b * s + qi) * nh + h) * kD;
#pragma unroll
    for (int j = 0; j < kPer; ++j) row[tx + kSide * j] = from_f32<T>(acc[i][j] * sm_scale);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dropout_attention_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const T* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             const int64_t* __restrict__ seed, T* __restrict__ dk,
                             T* __restrict__ dv, int s, int nh, float sm_scale, uint32_t thresh,
                             float keep_scale, int dropout) {
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kTileFloats;
  float* qs = vs + kTileFloats;
  float* dos = qs + kTileFloats;
  float* pts = dos + kTileFloats;
  float* dss = pts + kTileFloats;
  float* lse_s = dss + kTileFloats;
  float* delta_s = lse_s + kTile;
  const int kt = blockIdx.x, bh = blockIdx.y, b = bh / nh, h = bh % nh;
  const int ty = threadIdx.x / kSide, tx = threadIdx.x % kSide;
  const int k0 = kt * kTile;
  const int tiles = (s + kTile - 1) / kTile;
  const Dropout drop = make_dropout(seed, bh, thresh, keep_scale, dropout);

  float dk_acc[kPer][kPer], dv_acc[kPer][kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kPer; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.0f;
  stage(ks, k, b, h, s, nh, k0);
  stage(vs, v, b, h, s, nh, k0);
  for (int qt = kt; qt < tiles; ++qt) {        // the query tiles that see this key tile
    const int q0 = qt * kTile;
    __syncthreads();
    stage(qs, q, b, h, s, nh, q0);
    stage(dos, dout, b, h, s, nh, q0);
    if (threadIdx.x < kTile) {
      const int qi = q0 + threadIdx.x;
      lse_s[threadIdx.x] = qi < s ? lse[(size_t)bh * s + qi] : 0.0f;
      delta_s[threadIdx.x] = qi < s ? delta[(size_t)bh * s + qi] : 0.0f;
    }
    __syncthreads();
    float sc[kPer][kPer], g[kPer][kPer];
    dot_rows(qs, ks, ty, tx, sc);              // rows: queries, columns: keys
    dot_rows(dos, vs, ty, tx, g);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int r = ty + kSide * i, qi = q0 + r;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int c = tx + kSide * j, kj = k0 + c;
        const bool live = kj <= qi && qi < s;
        const float p = live ? expf(sc[i][j] * sm_scale - lse_s[r]) : 0.0f;
        const float f = drop.on ? drop.factor(qi, kj) : 1.0f;
        pts[r * kLd + c] = round_to<T>(drop.on ? p * f : p);
        const float gg = drop.on ? g[i][j] * f : g[i][j];
        dss[r * kLd + c] = round_to<T>(p * (gg - delta_s[r]));
      }
    }
    __syncthreads();
    mul_acc_t(pts, dos, ty, tx, dv_acc);       // rows: keys, columns: features
    mul_acc_t(dss, qs, ty, tx, dk_acc);
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int kj = k0 + ty + kSide * i;
    if (kj >= s) continue;
    const size_t off = (((size_t)b * s + kj) * nh + h) * kD;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      dk[off + tx + kSide * j] = from_f32<T>(dk_acc[i][j] * sm_scale);
      dv[off + tx + kSide * j] = from_f32<T>(dv_acc[i][j]);
    }
  }
}

template <typename Kernel>
int launch_setup(Kernel kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

template <typename T>
int fwd(const T* q, const T* k, const T* v, const int64_t* seed, T* o, float* lse, int b,
        int s, int nh, float sm_scale, uint32_t thresh, float keep_scale, int dropout,
        cudaStream_t stream) {
  const size_t smem = 4 * kTileFloats * sizeof(float);
  if (int err = launch_setup(dropout_attention_fwd_kernel<T>, smem)) return err;
  const dim3 grid((s + kTile - 1) / kTile, b * nh);
  dropout_attention_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      q, k, v, seed, o, lse, s, nh, sm_scale, thresh, keep_scale, dropout);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dq(const T* q, const T* k, const T* v, const T* dout, const float* lse,
       const float* delta, const int64_t* seed, T* dq_out, int b, int s, int nh,
       float sm_scale, uint32_t thresh, float keep_scale, int dropout, cudaStream_t stream) {
  const size_t smem = 5 * kTileFloats * sizeof(float);
  if (int err = launch_setup(dropout_attention_dq_kernel<T>, smem)) return err;
  const dim3 grid((s + kTile - 1) / kTile, b * nh);
  dropout_attention_dq_kernel<T><<<grid, kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, seed, dq_out, s, nh, sm_scale, thresh, keep_scale, dropout);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dkv(const T* q, const T* k, const T* v, const T* dout, const float* lse,
        const float* delta, const int64_t* seed, T* dk, T* dv, int b, int s, int nh,
        float sm_scale, uint32_t thresh, float keep_scale, int dropout, cudaStream_t stream) {
  const size_t smem = (6 * kTileFloats + 2 * kTile) * sizeof(float);
  if (int err = launch_setup(dropout_attention_dkv_kernel<T>, smem)) return err;
  const dim3 grid((s + kTile - 1) / kTile, b * nh);
  dropout_attention_dkv_kernel<T><<<grid, kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, seed, dk, dv, s, nh, sm_scale, thresh, keep_scale, dropout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, do, o, dq, dk, dv: (b, s, h, 64) contiguous, one type; lse, delta:
// (b*h, s) float32; seed: one int64 in device memory (read only when dropout
// is 1; may be null otherwise); b*h <= 65535, s >= 1.  Each returns the error
// of setting the shared-memory limit or cudaGetLastError() after the launch.
#define IGM_DROPOUT_ATTENTION(SUFFIX, T)                                                    \
  extern "C" int igm_dropout_attention_fwd_##SUFFIX(                                        \
      const T* q, const T* k, const T* v, const int64_t* seed, T* o, float* lse, int b,     \
      int s, int h, float sm_scale, unsigned thresh, float keep_scale, int dropout,         \
      cudaStream_t stream) {                                                                \
    return fwd<T>(q, k, v, seed, o, lse, b, s, h, sm_scale, thresh, keep_scale, dropout,    \
                  stream);                                                                  \
  }                                                                                         \
  extern "C" int igm_dropout_attention_dq_##SUFFIX(                                         \
      const T* q, const T* k, const T* v, const T* dout, const float* lse,                  \
      const float* delta, const int64_t* seed, T* dq_out, int b, int s, int h,              \
      float sm_scale, unsigned thresh, float keep_scale, int dropout,                       \
      cudaStream_t stream) {                                                                \
    return dq<T>(q, k, v, dout, lse, delta, seed, dq_out, b, s, h, sm_scale, thresh,        \
                 keep_scale, dropout, stream);                                              \
  }                                                                                         \
  extern "C" int igm_dropout_attention_dkv_##SUFFIX(                                        \
      const T* q, const T* k, const T* v, const T* dout, const float* lse,                  \
      const float* delta, const int64_t* seed, T* dk, T* dv, int b, int s, int h,           \
      float sm_scale, unsigned thresh, float keep_scale, int dropout,                       \
      cudaStream_t stream) {                                                                \
    return dkv<T>(q, k, v, dout, lse, delta, seed, dk, dv, b, s, h, sm_scale, thresh,       \
                  keep_scale, dropout, stream);                                             \
  }

IGM_DROPOUT_ATTENTION(f32, float)
IGM_DROPOUT_ATTENTION(bf16, __nv_bfloat16)
