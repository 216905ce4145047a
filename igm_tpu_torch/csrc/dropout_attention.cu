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
// at the 989 TFLOP/s of the bf16 tensor cores).  dq and dk/dv move 260 and
// 312 MB (0.078 and 0.093 ms) and do 3 and 4 products (0.061 and 0.082 ms).
// The hash, with its row and column terms hoisted and its first shift+xor
// round folded into them (it distributes over their xor), is 9 integer
// operations for each of the 158 M live (i, j) pairs (0.085 ms at the CUDA
// cores' ~16.7 T int32 ops/s), and every kernel regenerates it: at rate 0.1
// the hash, not the matrix unit, bounds the forward and dq at 0.085 ms, and
// dk/dv's bytes bound it at 0.093 ms.
//
// Three designs:
//   - the bf16 forward, dq and dk/dv kernels (TAR's training and evaluation
//     path) do every product on the tensor cores, mma.sync.m16n8k16 bf16 ->
//     f32: FlashAttention-2's forward, and its backward split into two
//     deterministic kernels as the Pallas kernels split it.  One CTA of 4
//     warps per (64-row tile, b*h); each warp owns 16 rows, whose operands
//     are A fragments: k and v for dk/dv, and do for dq, held in registers
//     for the whole walk, and q for the forward and dq, read from its staged
//     tile by ldmatrix per chunk.  The other side's 64-row tiles stream
//     through a two-stage shared-memory ring filled by 16-byte cp.async
//     (rows at or past S zero-filled, rows padded to 144 bytes so ldmatrix
//     is free of bank conflicts): the next tile loads while this one
//     computes.  The scores (and dp) land in accumulator fragments and the
//     epilogue runs on them in registers: the forward's online softmax (the
//     row max over the quad, alpha, the rescale of l and of the o
//     accumulator, p = 2^(s log2 e - m) by ex2.approx), the causal mask on
//     the diagonal tile, the hash from a row term qi * C1 ^ seed and a
//     column term kj * C2, ds.  The rounded p * f and ds are repacked from
//     the accumulator layout into A fragments for the next product (one cvt
//     per register pair): they never touch shared memory.  Each tile's work
//     is compiled four times, with and without the hash and the mask, so
//     the tiles off the diagonal and the ragged edge skip the mask, and rate
//     0 (TAR's evaluation) skips the hash.  dk/dv works in the transposed
//     form (rows keys, columns queries: s^T = k q^T), so the hash takes its
//     query index from the column and lse and delta are indexed by column.
//     The forward and dq launch their heaviest query tiles first within
//     each b*h, whose tiles stay adjacent so its K and V stay in L2.
//     Registers (ptxas, sm_90a): the forward and dq 128 without spills, 4
//     CTAs of 128 threads per SM (45 and 55 KB of shared memory); dk/dv 168,
//     3 CTAs.  mma.sync rather than wgmma: the products at the full wgmma
//     rate already take about as long as the hash floor, so the gain is in
//     moving them off the CUDA cores and keeping p and ds in registers,
//     which leaves the integer lanes to the hash.  The bf16 kernels need
//     q, k, v and do on a 16-byte boundary (the wrappers check);
//   - the float32 forward, dq and dk/dv kernels are the first, simple
//     version: every product a float32 FMA on the CUDA cores (67 TFLOP/s)
//     from tiles staged in shared memory as float32, one block of 256
//     threads per (64-row tile, b*h), each thread owning 4 rows x 4 columns
//     (rows ty + 16i, columns tx + 16j) of 65-float padded rows.  float32
//     serves the f32 checks, whose 1e-5 tolerances rule out TF32 on the
//     tensor cores;
//   - all of them mask the ragged edge (S = 785 is no multiple of 64) in the
//     kernel and use no atomics: every sum runs in a fixed order, so
//     outputs and gradients repeat bit for bit across runs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_sm90.cuh"

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

constexpr uint32_t kQueryMul = 0x9E3779B1u;  // the hash's query and key multipliers
constexpr uint32_t kKeyMul = 0x85EBCA77u;

// h ^ (h >> 16): the hash's first round.  It distributes over xor, so for
// h = qterm ^ kterm it is hoisted into the two terms
__device__ __forceinline__ uint32_t fold16(uint32_t h) { return h ^ (h >> 16); }

struct Dropout {
  bool on;
  uint32_t seed, thresh;
  float keep_scale;
  __device__ __forceinline__ float factor(int qi, int kj) const {
    return factor_of(query_term(qi), key_term(kj));
  }
  // the hash's row and column terms with its first round folded in, hoisted
  // out of the pair loops: per pair there remain the xor of the two, two
  // multiply rounds, the compare and the select (9 integer operations)
  __device__ __forceinline__ uint32_t query_term(int qi) const {
    return fold16(((uint32_t)qi * kQueryMul) ^ seed);
  }
  static __device__ __forceinline__ uint32_t key_term(int kj) {
    return fold16((uint32_t)kj * kKeyMul);
  }
  __device__ __forceinline__ float factor_of(uint32_t qterm, uint32_t kterm) const {
    uint32_t h = qterm ^ kterm;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    h *= 0xC2B2AE35u;
    h ^= h >> 16;
    return h >= thresh ? keep_scale : 0.0f;
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

// ------------------------------------------------------------------------
// The bf16 backward on the tensor cores (see the note at the head).

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kMmaThreads = 32 * kWarps;    // a warp per 16 of a tile's 64 rows
constexpr int kLdh = kD + 8;                // bf16 row padded to 144 bytes: the 8 rows
                                            // of an ldmatrix read hit distinct banks
constexpr int kTileH = kTile * kLdh;        // bf16 elements of one staged tile
constexpr int kChunks = kD / 16;            // 16-wide chunks of a row (k of an mma)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 2^x in one MUFU.EX2 (2 ulp; results below 2^-126 flush to 0, far under
// the bf16 rounding of p)
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Fragment addresses in a staged tile (row-major, kLdh a row) for lane l.
// A operand, rows r0 .. r0+15 and columns c0 .. c0+15: a0..a3 of the mma.
__device__ __forceinline__ const bf16* frag_a(const bf16* tile, int r0, int c0, int lane) {
  return tile + (r0 + (lane & 15)) * kLdh + c0 + (lane >> 4) * 8;
}
// B operand from a tile stored [n][k] (b = tile^T): n0 .. n0+15 (two n8
// tiles), k0 .. k0+15; gives b0, b1 of the first n8 tile, then of the second
__device__ __forceinline__ const bf16* frag_b(const bf16* tile, int n0, int k0, int lane) {
  return tile + (n0 + (lane & 7) + (lane >> 4) * 8) * kLdh + k0 + ((lane >> 3) & 1) * 8;
}
// B operand from a tile stored [k][n] (b = tile), through ldmatrix.trans:
// k0 .. k0+15, n0 .. n0+15; the same register order as frag_b
__device__ __forceinline__ const bf16* frag_b_trans(const bf16* tile, int k0, int n0,
                                                    int lane) {
  return tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdh + n0 + (lane >> 4) * 8;
}

// Rows [row0, row0 + 64) of head h of batch b of a (B, S, H, 64) bf16 tensor
// into dst[64][kLdh] by cp.async, 16 bytes a copy; rows at or past s are
// zero-filled.  Each row of a head is 128 contiguous bytes.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src, int b,
                                          int h, int s, int nh, int row0) {
#pragma unroll
  for (int it = 0; it < kTile * (kD / 8) / kMmaThreads; ++it) {
    const int i = threadIdx.x + it * kMmaThreads;
    const int r = i >> 3, c = (i & 7) * 8, row = row0 + r;
    const bool valid = row < s;
    cp_async16(dst + r * kLdh + c,
               src + (((size_t)b * s + (valid ? row : 0)) * nh + h) * kD + c, valid);
  }
}

// A operands of the 16 rows at r0 of a staged tile: [chunk of 16 columns][4]
__device__ __forceinline__ void load_a(uint32_t a[kChunks][4], const bf16* tile, int r0,
                                       int lane) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c) ldsm_x4(a[c], frag_a(tile, r0, 16 * c, lane));
}

// rows (c layout: thread holds rows g and g + 8, columns 2t and 2t + 1 of
// each n8 tile) and their dq, dk or dv stored as bf16 pairs
__device__ __forceinline__ void store_rows(bf16* __restrict__ out, const float acc[8][4],
                                           float scale, int b, int h, int s, int nh,
                                           int row0, int g, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + g + 8 * i;
    if (row >= s) continue;
    bf16* dst = out + (((size_t)b * s + row) * nh + h) * kD + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
          __floats2bfloat162_rn(acc[n][2 * i] * scale, acc[n][2 * i + 1] * scale);
  }
}

// One live 64-key tile of the forward, for the warp's 16 query rows: the
// scores s = q k^T of all 64 keys by mma, in the log2 domain; the online
// softmax on the fragments (the row max over the quad, alpha, the rescale of
// l and of the o accumulator); then per 16 keys p = 2^(s - m), l += p, and
// acc += round(p f) v with p f repacked from the accumulator layout into A
// fragments.  l is each thread's partial row sum over its own columns until
// the quad sums it at the end.  kDrop: rate > 0 (else no hash); kMask: the
// diagonal tile (causal mask; it also holds the keys at or past s).
template <bool kDrop, bool kMask>
__device__ __forceinline__ void fwd_tile(float (&acc)[8][4], float (&m2)[2], float (&l)[2],
                                         const bf16* qs, const bf16* ks, const bf16* vs,
                                         int k0, int r0, int lane, float scale_log2,
                                         const uint32_t (&qterm)[2], const Dropout& drop) {
  const int g = lane >> 2, t = lane & 3;
  float sc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[n][e] = 0.0f;
#pragma unroll
  for (int d = 0; d < kChunks; ++d) {
    uint32_t qa[4];
    ldsm_x4(qa, frag_a(qs, r0, 16 * d, lane));
#pragma unroll
    for (int c = 0; c < kTile / 16; ++c) {
      uint32_t kb[4];
      ldsm_x4(kb, frag_b(ks, 16 * c, 16 * d, lane));
      mma_bf16(sc[2 * c], qa, kb[0], kb[1]);
      mma_bf16(sc[2 * c + 1], qa, kb[2], kb[3]);
    }
  }
  // element e of n8 tile n is row r0 + g + 8 (e / 2), key 8n + 2t + e % 2
  float mx[2] = {m2[0], m2[1]};
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sc[n][e] * scale_log2;
      if (kMask && 8 * n + 2 * t + (e & 1) > r0 + g + 8 * (e >> 1)) x = kNegInf;
      sc[n][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float alpha = exp2_fast(m2[i] - mx[i]);
    m2[i] = mx[i];
    l[i] *= alpha;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      acc[n][2 * i] *= alpha;
      acc[n][2 * i + 1] *= alpha;
    }
  }
#pragma unroll
  for (int c = 0; c < kTile / 16; ++c) {      // 16 keys at a time
    float pf[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int col = 0; col < 2; ++col) {
        const uint32_t kterm = kDrop ? Dropout::key_term(k0 + 16 * c + 8 * j + 2 * t + col) : 0u;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = 2 * i + col;
          const float p = exp2_fast(sc[2 * c + j][e] - m2[i]);
          l[i] += p;
          pf[j][e] = kDrop ? p * drop.factor_of(qterm[i], kterm) : p;
        }
      }
    // p f rounded to bf16: the c layout of two n8 tiles is the a layout of k16
    const uint32_t pa[4] = {pack_bf16(pf[0][0], pf[0][1]), pack_bf16(pf[0][2], pf[0][3]),
                            pack_bf16(pf[1][0], pf[1][1]), pack_bf16(pf[1][2], pf[1][3])};
#pragma unroll
    for (int n = 0; n < kD / 16; ++n) {       // acc += p f . v, 16 features at a time
      uint32_t vb[4];
      ldsm_x4_trans(vb, frag_b_trans(vs, 16 * c, 16 * n, lane));
      mma_bf16(acc[2 * n], pa, vb[0], vb[1]);
      mma_bf16(acc[2 * n + 1], pa, vb[2], vb[3]);
    }
  }
}

// 4 CTAs per SM: at most 128 registers (q's fragments come from shared memory
// per chunk), 4 x 45 KB of shared memory
__global__ void __launch_bounds__(kMmaThreads, 4)
dropout_attention_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                 const bf16* __restrict__ v, const int64_t* __restrict__ seed,
                                 bf16* __restrict__ o, float* __restrict__ lse, int s, int nh,
                                 float sm_scale, uint32_t thresh, float keep_scale,
                                 int dropout) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  bf16* qs = reinterpret_cast<bf16*>(smem_bytes);
  bf16* ring = qs + kTileH;                   // [stage][k tile, v tile]
  const int tiles = (s + kTile - 1) / kTile;
  // the heaviest query tiles first; a b*h's tiles stay adjacent (its K, V in L2)
  const int qt = tiles - 1 - blockIdx.x, bh = blockIdx.y, b = bh / nh, h = bh % nh;
  const int q0 = qt * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp;                   // this warp's rows in the tile
  const Dropout drop = make_dropout(seed, bh, thresh, keep_scale, dropout);
  const float scale_log2 = sm_scale * kLog2e;

  load_tile(qs, q, b, h, s, nh, q0);
  load_tile(ring, k, b, h, s, nh, 0);
  load_tile(ring + kTileH, v, b, h, s, nh, 0);
  cp_async_commit();

  uint32_t qterm[2];
  float m2[2], l[2], acc[8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qterm[i] = drop.query_term(q0 + r0 + g + 8 * i);
    m2[i] = kNegInf;
    l[i] = 0.0f;
  }
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  for (int kt = 0; kt <= qt; ++kt) {          // the causally live key tiles
    cp_async_wait<0>();                      // this tile has landed ...
    __syncthreads();                          // ... for all, and the other stage is free
    if (kt < qt) {
      bf16* next = ring + ((kt + 1) & 1) * 2 * kTileH;
      load_tile(next, k, b, h, s, nh, (kt + 1) * kTile);
      load_tile(next + kTileH, v, b, h, s, nh, (kt + 1) * kTile);
    }
    cp_async_commit();
    const bf16* ks = ring + (kt & 1) * 2 * kTileH;
#define IGM_FWD_TILE(DROP, MASK)                                                        \
  fwd_tile<DROP, MASK>(acc, m2, l, qs, ks, ks + kTileH, kt * kTile, r0, lane, scale_log2, \
                       qterm, drop)
    if (kt == qt) {                           // the diagonal tile: causal mask
      if (drop.on) IGM_FWD_TILE(true, true); else IGM_FWD_TILE(false, true);
    } else {
      if (drop.on) IGM_FWD_TILE(true, false); else IGM_FWD_TILE(false, false);
    }
#undef IGM_FWD_TILE
  }
  // the quad's partial sums make l; o = acc / l, lse = m + log l
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const float inv = 1.0f / l[i];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      acc[n][2 * i] *= inv;
      acc[n][2 * i + 1] *= inv;
    }
    const int qi = q0 + r0 + g + 8 * i;
    if (t == 0 && qi < s) lse[(size_t)bh * s + qi] = m2[i] * kLn2 + logf(l[i]);
  }
  store_rows(o, acc, 1.0f, b, h, s, nh, q0 + r0, g, t);
}

// One live 64-key tile of the dq kernel, for the warp's 16 query rows:
// s = q k^T and dp = do v^T by mma, the epilogue on the fragments, dq += ds k.
// kDrop: rate > 0 (else no hash); kMask: the diagonal tile (causal mask).
template <bool kDrop, bool kMask>
__device__ __forceinline__ void dq_tile(float (&acc)[8][4], const bf16* qs,
                                        const uint32_t (&doa)[kChunks][4], const bf16* ks,
                                        const bf16* vs, int k0, int r0, int lane,
                                        float scale_log2, const float (&lse_log2)[2],
                                        const float (&row_delta)[2],
                                        const uint32_t (&qterm)[2], const Dropout& drop) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int c = 0; c < kTile / 16; ++c) {      // 16 keys at a time
    float sc[2][4] = {}, dp[2][4] = {};
#pragma unroll
    for (int d = 0; d < kChunks; ++d) {
      uint32_t kb[4], vb[4];
      ldsm_x4(kb, frag_b(ks, 16 * c, 16 * d, lane));
      ldsm_x4(vb, frag_b(vs, 16 * c, 16 * d, lane));
      uint32_t qa[4];
      ldsm_x4(qa, frag_a(qs, r0, 16 * d, lane));
      mma_bf16(sc[0], qa, kb[0], kb[1]);
      mma_bf16(sc[1], qa, kb[2], kb[3]);
      mma_bf16(dp[0], doa[d], vb[0], vb[1]);
      mma_bf16(dp[1], doa[d], vb[2], vb[3]);
    }
    // the epilogue on the fragments: element e of n8 tile j is row
    // r0 + g + 8 (e / 2), key 16c + 8j + 2t + e % 2 of the tiles
    float ds[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int col = 0; col < 2; ++col) {
        const int kc = 16 * c + 8 * j + 2 * t + col;
        const uint32_t kterm = kDrop ? Dropout::key_term(k0 + kc) : 0u;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = 2 * i + col;
          float p = exp2_fast(fmaf(sc[j][e], scale_log2, -lse_log2[i]));
          if (kMask && kc > r0 + g + 8 * i) p = 0.0f;
          const float gg = kDrop ? dp[j][e] * drop.factor_of(qterm[i], kterm) : dp[j][e];
          ds[j][e] = p * (gg - row_delta[i]);
        }
      }
    // ds rounded to bf16: the c layout of two n8 tiles is the a layout of k16
    const uint32_t dsa[4] = {pack_bf16(ds[0][0], ds[0][1]), pack_bf16(ds[0][2], ds[0][3]),
                             pack_bf16(ds[1][0], ds[1][1]), pack_bf16(ds[1][2], ds[1][3])};
#pragma unroll
    for (int n = 0; n < kD / 16; ++n) {       // dq += ds . k, 16 features at a time
      uint32_t kb[4];
      ldsm_x4_trans(kb, frag_b_trans(ks, 16 * c, 16 * n, lane));
      mma_bf16(acc[2 * n], dsa, kb[0], kb[1]);
      mma_bf16(acc[2 * n + 1], dsa, kb[2], kb[3]);
    }
  }
}

// 4 CTAs per SM: at most 128 registers (q's fragments come from shared memory
// per chunk, not registers), 4 x 55 KB of shared memory
__global__ void __launch_bounds__(kMmaThreads, 4)
dropout_attention_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                                const float* __restrict__ lse, const float* __restrict__ delta,
                                const int64_t* __restrict__ seed, bf16* __restrict__ dq,
                                int s, int nh, float sm_scale, uint32_t thresh,
                                float keep_scale, int dropout) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  bf16* qs = reinterpret_cast<bf16*>(smem_bytes);
  bf16* dos = qs + kTileH;
  bf16* ring = dos + kTileH;                  // [stage][k tile, v tile]
  const int tiles = (s + kTile - 1) / kTile;
  // the heaviest query tiles first; a b*h's tiles stay adjacent (its K, V in L2)
  const int qt = tiles - 1 - blockIdx.x, bh = blockIdx.y, b = bh / nh, h = bh % nh;
  const int q0 = qt * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp;                   // this warp's rows in the tile
  const Dropout drop = make_dropout(seed, bh, thresh, keep_scale, dropout);
  const float scale_log2 = sm_scale * kLog2e;

  load_tile(qs, q, b, h, s, nh, q0);
  load_tile(dos, dout, b, h, s, nh, q0);
  load_tile(ring, k, b, h, s, nh, 0);
  load_tile(ring + kTileH, v, b, h, s, nh, 0);
  cp_async_commit();

  float lse_log2[2], row_delta[2];
  uint32_t qterm[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + r0 + g + 8 * i;
    lse_log2[i] = qi < s ? lse[(size_t)bh * s + qi] * kLog2e : 0.0f;
    row_delta[i] = qi < s ? delta[(size_t)bh * s + qi] : 0.0f;
    qterm[i] = drop.query_term(qi);
  }
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  uint32_t doa[kChunks][4];
  cp_async_wait<0>();
  __syncthreads();
  load_a(doa, dos, r0, lane);

  for (int kt = 0; kt <= qt; ++kt) {          // the causally live key tiles
    cp_async_wait<0>();                      // this tile has landed ...
    __syncthreads();                          // ... for all, and the other stage is free
    if (kt < qt) {
      bf16* next = ring + ((kt + 1) & 1) * 2 * kTileH;
      load_tile(next, k, b, h, s, nh, (kt + 1) * kTile);
      load_tile(next + kTileH, v, b, h, s, nh, (kt + 1) * kTile);
    }
    cp_async_commit();
    const bf16* ks = ring + (kt & 1) * 2 * kTileH;
    const bf16* vs = ks + kTileH;
    const int k0 = kt * kTile;
#define IGM_DQ_TILE(DROP, MASK)                                                           \
  dq_tile<DROP, MASK>(acc, qs, doa, ks, vs, k0, r0, lane, scale_log2, lse_log2, row_delta, \
                      qterm, drop)
    if (kt == qt) {                           // the diagonal tile: causal mask
      if (drop.on) IGM_DQ_TILE(true, true); else IGM_DQ_TILE(false, true);
    } else {
      if (drop.on) IGM_DQ_TILE(true, false); else IGM_DQ_TILE(false, false);
    }
#undef IGM_DQ_TILE
  }
  store_rows(dq, acc, sm_scale, b, h, s, nh, q0 + r0, g, t);
}

// One query tile of the dk/dv kernel, for the warp's 16 key rows, in the
// transposed form: s^T = k q^T and dp^T = v do^T by mma, the epilogue on the
// fragments, dv += (p^T f) do and dk += ds^T q.  kDrop: rate > 0 (else no
// hash); kMask: the diagonal tile (diag: causal mask) or the ragged last one
// (queries at or past s).
template <bool kDrop, bool kMask>
__device__ __forceinline__ void dkv_tile(float (&dk_acc)[8][4], float (&dv_acc)[8][4],
                                         const uint32_t (&ka)[kChunks][4],
                                         const uint32_t (&va)[kChunks][4], const bf16* qs,
                                         const bf16* dos, const float* lse_s,
                                         const float* delta_s, int q0, bool diag, int s,
                                         int r0, int lane, float scale_log2,
                                         const uint32_t (&kterm)[2], const Dropout& drop) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int c = 0; c < kTile / 16; ++c) {      // 16 queries at a time
    float sc[2][4] = {}, dp[2][4] = {};
#pragma unroll
    for (int d = 0; d < kChunks; ++d) {
      uint32_t qb[4], dob[4];
      ldsm_x4(qb, frag_b(qs, 16 * c, 16 * d, lane));
      ldsm_x4(dob, frag_b(dos, 16 * c, 16 * d, lane));
      mma_bf16(sc[0], ka[d], qb[0], qb[1]);
      mma_bf16(sc[1], ka[d], qb[2], qb[3]);
      mma_bf16(dp[0], va[d], dob[0], dob[1]);
      mma_bf16(dp[1], va[d], dob[2], dob[3]);
    }
    // element e of n8 tile j is key r0 + g + 8 (e / 2), query
    // 16c + 8j + 2t + e % 2 of the tiles: the hash takes the query from the
    // column, and lse and delta are the column's
    float pf[2][4], ds[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int col = 0; col < 2; ++col) {
        const int qc = 16 * c + 8 * j + 2 * t + col, qi = q0 + qc;
        const float lse_log2 = lse_s[qc] * kLog2e, col_delta = delta_s[qc];
        const uint32_t qterm = kDrop ? drop.query_term(qi) : 0u;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = 2 * i + col;
          float p = exp2_fast(fmaf(sc[j][e], scale_log2, -lse_log2));
          if (kMask && (qi >= s || (diag && r0 + g + 8 * i > qc))) p = 0.0f;
          if (kDrop) {
            const float f = drop.factor_of(qterm, kterm[i]);
            pf[j][e] = p * f;
            ds[j][e] = p * (dp[j][e] * f - col_delta);
          } else {
            pf[j][e] = p;
            ds[j][e] = p * (dp[j][e] - col_delta);
          }
        }
      }
    const uint32_t pa[4] = {pack_bf16(pf[0][0], pf[0][1]), pack_bf16(pf[0][2], pf[0][3]),
                            pack_bf16(pf[1][0], pf[1][1]), pack_bf16(pf[1][2], pf[1][3])};
    const uint32_t dsa[4] = {pack_bf16(ds[0][0], ds[0][1]), pack_bf16(ds[0][2], ds[0][3]),
                             pack_bf16(ds[1][0], ds[1][1]), pack_bf16(ds[1][2], ds[1][3])};
#pragma unroll
    for (int n = 0; n < kD / 16; ++n) {       // dv += p^T f . do, dk += ds^T . q
      uint32_t dob[4], qb[4];
      ldsm_x4_trans(dob, frag_b_trans(dos, 16 * c, 16 * n, lane));
      ldsm_x4_trans(qb, frag_b_trans(qs, 16 * c, 16 * n, lane));
      mma_bf16(dv_acc[2 * n], pa, dob[0], dob[1]);
      mma_bf16(dv_acc[2 * n + 1], pa, dob[2], dob[3]);
      mma_bf16(dk_acc[2 * n], dsa, qb[0], qb[1]);
      mma_bf16(dk_acc[2 * n + 1], dsa, qb[2], qb[3]);
    }
  }
}

// 3 CTAs per SM: its two accumulators and four operands need ~166 registers
__global__ void __launch_bounds__(kMmaThreads, 3)
dropout_attention_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                                 const float* __restrict__ lse,
                                 const float* __restrict__ delta,
                                 const int64_t* __restrict__ seed, bf16* __restrict__ dk,
                                 bf16* __restrict__ dv, int s, int nh, float sm_scale,
                                 uint32_t thresh, float keep_scale, int dropout) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  bf16* ks = reinterpret_cast<bf16*>(smem_bytes);
  bf16* vs = ks + kTileH;
  bf16* ring = vs + kTileH;                   // [stage][q tile, do tile]
  float* rows = reinterpret_cast<float*>(ring + 4 * kTileH);   // [stage][lse, delta][64]
  const int tiles = (s + kTile - 1) / kTile;
  const int kt = blockIdx.x, bh = blockIdx.y, b = bh / nh, h = bh % nh;
  const int k0 = kt * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp;                   // this warp's keys in the tile
  const Dropout drop = make_dropout(seed, bh, thresh, keep_scale, dropout);
  const float scale_log2 = sm_scale * kLog2e;

  // a query tile's q, do, lse and delta into a stage of the ring
  auto load_queries = [&](int qt) {
    bf16* st = ring + (qt & 1) * 2 * kTileH;
    const int q0 = qt * kTile;
    load_tile(st, q, b, h, s, nh, q0);
    load_tile(st + kTileH, dout, b, h, s, nh, q0);
    const int r = threadIdx.x & (kTile - 1), qi = q0 + r;
    const float* src = threadIdx.x < kTile ? lse : delta;
    const bool valid = qi < s;
    cp_async4(rows + (qt & 1) * 2 * kTile + (threadIdx.x / kTile) * kTile + r,
              src + (size_t)bh * s + (valid ? qi : 0), valid);
  };
  load_tile(ks, k, b, h, s, nh, k0);
  load_tile(vs, v, b, h, s, nh, k0);
  load_queries(kt);
  cp_async_commit();

  uint32_t kterm[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) kterm[i] = Dropout::key_term(k0 + r0 + g + 8 * i);
  float dk_acc[8][4], dv_acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.0f;

  uint32_t ka[kChunks][4], va[kChunks][4];
  cp_async_wait<0>();
  __syncthreads();
  load_a(ka, ks, r0, lane);
  load_a(va, vs, r0, lane);

  for (int qt = kt; qt < tiles; ++qt) {       // the query tiles that see this key tile
    cp_async_wait<0>();
    __syncthreads();
    if (qt + 1 < tiles) load_queries(qt + 1);
    cp_async_commit();
    const bf16* qs = ring + (qt & 1) * 2 * kTileH;
    const float* lse_s = rows + (qt & 1) * 2 * kTile;
    const int q0 = qt * kTile;
#define IGM_DKV_TILE(DROP, MASK)                                                           \
  dkv_tile<DROP, MASK>(dk_acc, dv_acc, ka, va, qs, qs + kTileH, lse_s, lse_s + kTile, q0, \
                       qt == kt, s, r0, lane, scale_log2, kterm, drop)
    if (qt == kt || q0 + kTile > s) {         // the diagonal or the ragged tile
      if (drop.on) IGM_DKV_TILE(true, true); else IGM_DKV_TILE(false, true);
    } else {
      if (drop.on) IGM_DKV_TILE(true, false); else IGM_DKV_TILE(false, false);
    }
#undef IGM_DKV_TILE
  }
  store_rows(dk, dk_acc, sm_scale, b, h, s, nh, k0 + r0, g, t);
  store_rows(dv, dv_acc, 1.0f, b, h, s, nh, k0 + r0, g, t);
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
  const dim3 grid((s + kTile - 1) / kTile, b * nh);
  if constexpr (std::is_same_v<T, bf16>) {
    const size_t smem = 5 * kTileH * sizeof(bf16);          // q, two stages of k, v
    if (int err = launch_setup(dropout_attention_fwd_mma_kernel, smem)) return err;
    dropout_attention_fwd_mma_kernel<<<grid, kMmaThreads, smem, stream>>>(
        q, k, v, seed, o, lse, s, nh, sm_scale, thresh, keep_scale, dropout);
  } else {
    const size_t smem = 4 * kTileFloats * sizeof(float);
    if (int err = launch_setup(dropout_attention_fwd_kernel<T>, smem)) return err;
    dropout_attention_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
        q, k, v, seed, o, lse, s, nh, sm_scale, thresh, keep_scale, dropout);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dq(const T* q, const T* k, const T* v, const T* dout, const float* lse,
       const float* delta, const int64_t* seed, T* dq_out, int b, int s, int nh,
       float sm_scale, uint32_t thresh, float keep_scale, int dropout, cudaStream_t stream) {
  const dim3 grid((s + kTile - 1) / kTile, b * nh);
  if constexpr (std::is_same_v<T, bf16>) {
    const size_t smem = 6 * kTileH * sizeof(bf16);          // q, do, two stages of k, v
    if (int err = launch_setup(dropout_attention_dq_mma_kernel, smem)) return err;
    dropout_attention_dq_mma_kernel<<<grid, kMmaThreads, smem, stream>>>(
        q, k, v, dout, lse, delta, seed, dq_out, s, nh, sm_scale, thresh, keep_scale, dropout);
  } else {
    const size_t smem = 5 * kTileFloats * sizeof(float);
    if (int err = launch_setup(dropout_attention_dq_kernel<T>, smem)) return err;
    dropout_attention_dq_kernel<T><<<grid, kThreads, smem, stream>>>(
        q, k, v, dout, lse, delta, seed, dq_out, s, nh, sm_scale, thresh, keep_scale, dropout);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dkv(const T* q, const T* k, const T* v, const T* dout, const float* lse,
        const float* delta, const int64_t* seed, T* dk, T* dv, int b, int s, int nh,
        float sm_scale, uint32_t thresh, float keep_scale, int dropout, cudaStream_t stream) {
  const dim3 grid((s + kTile - 1) / kTile, b * nh);
  if constexpr (std::is_same_v<T, bf16>) {
    // k, v, two stages of q, do, and of lse, delta
    const size_t smem = 6 * kTileH * sizeof(bf16) + 4 * kTile * sizeof(float);
    if (int err = launch_setup(dropout_attention_dkv_mma_kernel, smem)) return err;
    dropout_attention_dkv_mma_kernel<<<grid, kMmaThreads, smem, stream>>>(
        q, k, v, dout, lse, delta, seed, dk, dv, s, nh, sm_scale, thresh, keep_scale, dropout);
  } else {
    const size_t smem = (6 * kTileFloats + 2 * kTile) * sizeof(float);
    if (int err = launch_setup(dropout_attention_dkv_kernel<T>, smem)) return err;
    dropout_attention_dkv_kernel<T><<<grid, kThreads, smem, stream>>>(
        q, k, v, dout, lse, delta, seed, dk, dv, s, nh, sm_scale, thresh, keep_scale, dropout);
  }
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
