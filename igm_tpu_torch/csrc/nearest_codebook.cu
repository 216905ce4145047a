// Nearest-codebook search for Hopper (sm_90a): the VQ-VAE's quantiser.
//
// Replaces the Pallas TPU kernel igm_tpu/ops/pallas_vq.py
// nearest_codebook_pallas (_vq_kernel), and computes what it computes: for
// every row m of z (M, D) and code k of the codebook e (K, D), both f32,
//   score[m, k] = e_sq[k] - 2 * dot(z[m], e[k])
// and the output idx[m] (int32) is the k of the smallest score, ties going
// to the lower index (jnp.argmin, torch.argmin).  ||z||^2 is constant along a
// row and dropped, as there.  e_sq[k] = sum_d e[k, d]^2 comes from the
// wrapper (igm_tpu computes it outside its kernel too, pallas_vq.py:45).
// The formula is kept as it is, not rewritten as ||z - e||^2, so that ties
// and near-ties break as they do in igm_tpu.
//
// What bounds it on this card: operations.  2*M*K*D = 0.54 GFLOP at the
// VQ-VAE train step's M = 8192, K = 512, D = 64, against about 2.2 MB of z,
// e and idx: 8.0 us at the 67 TFLOP/s float32 rate of the CUDA cores, 0.66 us
// at 3.35 TB/s.  The products stay in full float32 FMAs, never TF32 or bf16
// tensor cores: an argmin flips on rounding, and the reference computes in
// float32.  Each score's dot product is one chain of fmaf over d = 0..D-1 in
// order (features past D are 0 on both sides, and fmaf(0, 0, acc) == acc),
// as in this file's first kernel, so every score has the same bits as there
// and the indices are the same on every input.  The design feeds the FMAs:
//   - a CTA of 128 threads keeps a tile of 128 rows of z in shared memory for
//     its whole walk over the codebook, which it takes in tiles of 64 codes;
//     the next code tile arrives by cp.async into a second buffer while the
//     current one is used;
//   - each thread owns 8 rows x 8 codes of a score tile (rows ty + 16 i,
//     codes tx + 8 j) and reads z and e as float4 along d, both row-major
//     as in device memory: 16 16-byte loads give 256 FMAs (4 FMAs a float
//     loaded; the first kernel did 2).  Rows of shared memory are padded to
//     dp = 8 n + 4 floats, so the 8 code rows a quarter-warp reads fall on
//     distinct banks, and the z row it reads is one broadcast;
//   - the codebook's tiles are split over a thread-block cluster of up to 8
//     CTAs (so that the grid fills the card; the rule is at the launch), and
//     rank 0 merges the ranks' (score, index) pairs through distributed
//     shared memory;
//   - each thread keeps a running (score, index) pair per row; the 8
//     threads that share a row merge theirs with warp shuffles.  Every
//     comparison is lexicographic (smaller score, then lower index; a NaN
//     score first, as argmin returns the first NaN), a total order, so the
//     result does not depend on the order in which tiles, threads and
//     ranks meet.
// Ragged M and K are masked; a D that is not a multiple of 4 (or inputs off
// a 16-byte boundary) is copied 4 bytes at a time.  The z tile and two code
// tiles take 1024 * dp bytes of shared memory: 68 KB at D = 64 (3 CTAs an
// SM); D up to 216 fits a CTA (kMaxD).  A larger D runs this file's first
// kernel (nearest_codebook_wide_kernel): z and code tiles staged in chunks
// of 32 features, 4 x 4 scores a thread, any D, each score the same fmaf
// chain over d in order, so the indices are the same as the resident
// kernel would give.
// On the H100 (700 W) the kernel takes 25.5 us at M = 8192 (the first
// kernel's call took 70 with e_sq), 18.7 at M = 4096.  Phase stamps
// (tools/kernel_stamps.py) put 20 of a CTA's 25 us in the code tiles, at
// about half the FMA rate: every 256 FMAs of a thread wait for 16 16-byte
// shared-memory loads, and the shared memory of an SM delivers 128 bytes a
// cycle, as fast as its FMAs take them; loading the next operands during
// the FMAs did not help (they are not late, they are slow to deliver).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <climits>

#include "mma_sm90.cuh"

namespace {

constexpr int kTileM = 128;                    // rows of z per CTA, resident
constexpr int kTileK = 64;                     // codes per shared-memory tile
constexpr int kThreadsK = 8;                   // threads along the codes
constexpr int kThreadsM = 16;                  // threads along the rows
constexpr int kThreads = kThreadsK * kThreadsM;
constexpr int kRows = kTileM / kThreadsM;      // rows per thread
constexpr int kCodes = kTileK / kThreadsK;     // codes per thread
constexpr int kMaxCluster = 8;
constexpr int kOneWave = 128;                  // about a CTA on each of 132 SMs
constexpr int kMaxD = 216;                     // 1024 * (216 + 4) bytes fit a CTA

// (s, i) comes before (t, j): a NaN score first, then the smaller score, then
// the lower index
__device__ __forceinline__ bool precedes(float s, int i, float t, int j) {
  const bool s_nan = isnan(s), t_nan = isnan(t);
  if (s_nan != t_nan) return s_nan;
  if (s_nan || s == t) return i < j;
  return s < t;
}

// rows [row0, row0 + rows) of src (n, d) into dst (rows, dp) by cp.async,
// zero past row n and past column d (to d rounded up to 4)
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int row0,
                                      int rows, int n, int d, int dp, bool vec16) {
  const int d4 = (d + 3) & ~3;
  if (vec16) {
    const int per_row = d4 / 4;
    for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
      const int r = i / per_row, c = (i % per_row) * 4;
      const bool valid = row0 + r < n;
      cp_async16(dst + r * dp + c, src + (valid ? (size_t)(row0 + r) * d + c : 0), valid);
    }
  } else {
    for (int i = threadIdx.x; i < rows * d4; i += kThreads) {
      const int r = i / d4, c = i % d4;
      const bool valid = row0 + r < n && c < d;
      cp_async4(dst + r * dp + c, src + (valid ? (size_t)(row0 + r) * d + c : 0), valid);
    }
  }
}

// e_sq[k0 .. k0 + kTileK) into dst by cp.async, zero past k
__device__ __forceinline__ void stage_sq(float* dst, const float* __restrict__ e_sq, int k0,
                                         int k) {
  if (threadIdx.x < kTileK) {
    const bool valid = k0 + threadIdx.x < k;
    cp_async4(dst + threadIdx.x, e_sq + (valid ? k0 + threadIdx.x : 0), valid);
  }
}

__global__ void __launch_bounds__(kThreads, 3)
nearest_codebook_kernel(const float* __restrict__ z, const float* __restrict__ e,
                        const float* __restrict__ e_sq, int32_t* __restrict__ idx, int m,
                        int k, int d, int dp, int vec16) {
  extern __shared__ __align__(16) float smem[];
  float* zs = smem;                            // [kTileM][dp]
  float* es = smem + kTileM * dp;              // [2][kTileK][dp]
  __shared__ float esq_s[2][kTileK];          // e_sq of the two code tiles
  __shared__ float best_s[kTileM];
  __shared__ int best_i[kTileM];

  const int tid = threadIdx.x;
  const int tx = tid % kThreadsK, ty = tid / kThreadsK;
  const int csize = cluster_size(), rank = cluster_rank();
  const int row0 = (blockIdx.x / csize) * kTileM;
  // this rank's code tiles: [t_lo, t_hi)
  const int tiles = (k + kTileK - 1) / kTileK;
  const int per_rank = (tiles + csize - 1) / csize;
  const int t_lo = min(tiles, rank * per_rank), t_hi = min(tiles, t_lo + per_rank);
  const int d4 = (d + 3) & ~3;
  IGM_STAMP(0);

  // a thread meets its codes in increasing order, so a later code takes a
  // row's place only if precedes() puts it first without the index: a
  // smaller score, or a NaN over a number; best_idx -1 is no code yet
  float best[kRows];
  int best_idx[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    best[i] = INFINITY;
    best_idx[i] = -1;
  }

  stage(zs, z, row0, kTileM, m, d, dp, vec16);
  if (t_lo < t_hi) stage_sq(esq_s[0], e_sq, t_lo * kTileK, k);
  if (t_lo < t_hi) stage(es, e, t_lo * kTileK, kTileK, k, d, dp, vec16);
  cp_async_commit();
  for (int t = t_lo; t < t_hi; ++t) {
    const int buf = (t - t_lo) & 1;
    const float* et = es + buf * kTileK * dp;
    if (t + 1 < t_hi) {                        // the next tile, into the other buffer
      stage_sq(esq_s[buf ^ 1], e_sq, (t + 1) * kTileK, k);
      stage(es + (buf ^ 1) * kTileK * dp, e, (t + 1) * kTileK, kTileK, k, d, dp, vec16);
    }
    cp_async_commit();
    cp_async_wait<1>();                        // all but the next tile have arrived
    __syncthreads();
    if (t == t_lo) IGM_STAMP(1);

    float acc[kRows][kCodes];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCodes; ++j) acc[i][j] = 0.f;
    for (int c = 0; c < d4; c += 4) {
      // every operand of the step first, so that one wait covers the loads
      float4 zr[kRows], ev[kCodes];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        zr[i] = *reinterpret_cast<const float4*>(zs + (ty + kThreadsM * i) * dp + c);
#pragma unroll
      for (int j = 0; j < kCodes; ++j)
        ev[j] = *reinterpret_cast<const float4*>(et + (tx + kThreadsK * j) * dp + c);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCodes; ++j) acc[i][j] = fmaf(zr[i].x, ev[j].x, acc[i][j]);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCodes; ++j) acc[i][j] = fmaf(zr[i].y, ev[j].y, acc[i][j]);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCodes; ++j) acc[i][j] = fmaf(zr[i].z, ev[j].z, acc[i][j]);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCodes; ++j) acc[i][j] = fmaf(zr[i].w, ev[j].w, acc[i][j]);
    }

#pragma unroll
    for (int j = 0; j < kCodes; ++j) {
      const int code = t * kTileK + tx + kThreadsK * j;
      if (code >= k) continue;
      const float esq = esq_s[buf][tx + kThreadsK * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float s = esq - 2.0f * acc[i][j];
        if ((!(s >= best[i]) && best[i] == best[i]) || best_idx[i] < 0) {
          best[i] = s;
          best_idx[i] = code;
        }
      }
    }
    __syncthreads();                           // this buffer is free for tile t + 2
  }
  cp_async_wait<0>();                          // a rank without tiles still has z in flight
  IGM_STAMP(2);

  // the 8 threads of a row are lanes 8q .. 8q + 7: xor offsets below 8 stay
  // inside them; a thread that met no code comes last (INT_MAX)
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    if (best_idx[i] < 0) best_idx[i] = INT_MAX;
#pragma unroll
    for (int off = kThreadsK / 2; off > 0; off >>= 1) {
      const float s = __shfl_xor_sync(0xffffffffu, best[i], off);
      const int j = __shfl_xor_sync(0xffffffffu, best_idx[i], off);
      if (precedes(s, j, best[i], best_idx[i])) {
        best[i] = s;
        best_idx[i] = j;
      }
    }
    if (tx == 0) {
      best_s[ty + kThreadsM * i] = best[i];
      best_i[ty + kThreadsM * i] = best_idx[i];
    }
  }
  IGM_STAMP(3);
  const int row = row0 + tid;                  // kThreads == kTileM: thread q takes row q
  if (csize > 1) {
    cluster_sync();                            // every rank's pairs are written
    if (rank == 0) {
      float s = best_s[tid];
      int j = best_i[tid];
      for (int r = 1; r < csize; ++r) {
        const float rs = *remote(&best_s[tid], r);
        const int rj = *remote(&best_i[tid], r);
        if (precedes(rs, rj, s, j)) {
          s = rs;
          j = rj;
        }
      }
      if (row < m) idx[row] = j;
    }
    cluster_sync();                            // no CTA leaves while rank 0 reads it
  } else {
    __syncthreads();
    if (row < m) idx[row] = best_i[tid];
  }
  IGM_STAMP(4);
}

static_assert(kThreads == kTileM, "the merge gives each thread one row");

// The first kernel of this file, for D > kMaxD: a CTA of 128 threads takes
// 32 rows of z and walks the codebook in tiles of 64 codes, staging both in
// shared memory in chunks of 32 features (rows padded by one float against
// bank conflicts); each thread owns 4 rows x 4 codes of a score tile and
// the 16 threads of a row merge their (score, index) pairs by shuffles.
constexpr int kWideTileM = 32;                 // rows of z per CTA
constexpr int kWideTileK = 64;                 // codes per shared-memory tile
constexpr int kWideTileD = 32;                 // features per staged chunk
constexpr int kWideThreadsK = 16;              // threads along the codes
constexpr int kWideThreadsM = 8;               // threads along the rows
constexpr int kWideThreads = kWideThreadsK * kWideThreadsM;
constexpr int kWideRows = kWideTileM / kWideThreadsM;
constexpr int kWideCodes = kWideTileK / kWideThreadsK;

__global__ void __launch_bounds__(kWideThreads)
nearest_codebook_wide_kernel(const float* __restrict__ z, const float* __restrict__ e,
                             const float* __restrict__ e_sq, int32_t* __restrict__ idx, int m,
                             int k, int d) {
  __shared__ float zs[kWideTileM][kWideTileD + 1];
  __shared__ float es[kWideTileK][kWideTileD + 1];
  const int tid = threadIdx.x;
  const int tx = tid % kWideThreadsK, ty = tid / kWideThreadsK;
  const int row0 = blockIdx.x * kWideTileM;

  float best[kWideRows];
  int best_idx[kWideRows];
#pragma unroll
  for (int r = 0; r < kWideRows; ++r) {
    best[r] = INFINITY;
    best_idx[r] = INT_MAX;
  }

  for (int k0 = 0; k0 < k; k0 += kWideTileK) {
    float acc[kWideRows][kWideCodes];
#pragma unroll
    for (int r = 0; r < kWideRows; ++r)
#pragma unroll
      for (int j = 0; j < kWideCodes; ++j) acc[r][j] = 0.0f;

    for (int d0 = 0; d0 < d; d0 += kWideTileD) {
      __syncthreads();                         // the last chunk has been read
      for (int i = tid; i < kWideTileM * kWideTileD; i += kWideThreads) {
        const int r = i / kWideTileD, c = i % kWideTileD;
        const int gr = row0 + r, gc = d0 + c;
        zs[r][c] = (gr < m && gc < d) ? z[(size_t)gr * d + gc] : 0.0f;
      }
      for (int i = tid; i < kWideTileK * kWideTileD; i += kWideThreads) {
        const int r = i / kWideTileD, c = i % kWideTileD;
        const int gk = k0 + r, gc = d0 + c;
        es[r][c] = (gk < k && gc < d) ? e[(size_t)gk * d + gc] : 0.0f;
      }
      __syncthreads();
      // features past D are 0 on both sides: fmaf(0, 0, acc) == acc
#pragma unroll 8
      for (int c = 0; c < kWideTileD; ++c) {
        float zr[kWideRows], ek[kWideCodes];
#pragma unroll
        for (int r = 0; r < kWideRows; ++r) zr[r] = zs[ty + r * kWideThreadsM][c];
#pragma unroll
        for (int j = 0; j < kWideCodes; ++j) ek[j] = es[tx + j * kWideThreadsK][c];
#pragma unroll
        for (int r = 0; r < kWideRows; ++r)
#pragma unroll
          for (int j = 0; j < kWideCodes; ++j) acc[r][j] = fmaf(zr[r], ek[j], acc[r][j]);
      }
    }

#pragma unroll
    for (int j = 0; j < kWideCodes; ++j) {
      const int code = k0 + tx + j * kWideThreadsK;
      if (code >= k) continue;
      const float esq = e_sq[code];
#pragma unroll
      for (int r = 0; r < kWideRows; ++r) {
        const float s = esq - 2.0f * acc[r][j];
        if (precedes(s, code, best[r], best_idx[r])) {
          best[r] = s;
          best_idx[r] = code;
        }
      }
    }
  }

  // the 16 threads of a row group are one half-warp: xor offsets below 16
  // stay inside it
#pragma unroll
  for (int r = 0; r < kWideRows; ++r) {
#pragma unroll
    for (int off = kWideThreadsK / 2; off > 0; off >>= 1) {
      const float s = __shfl_xor_sync(0xffffffffu, best[r], off);
      const int i = __shfl_xor_sync(0xffffffffu, best_idx[r], off);
      if (precedes(s, i, best[r], best_idx[r])) {
        best[r] = s;
        best_idx[r] = i;
      }
    }
    const int row = row0 + ty + r * kWideThreadsM;
    if (tx == 0 && row < m) idx[row] = best_idx[r];
  }
}

}  // namespace

// z (m, d), e (k, d), e_sq (k,) float32 and idx (m,) int32, contiguous on the
// current device; m, k, d >= 1 (d > 216 runs nearest_codebook_wide_kernel).
// Returns the CUDA error code of the launch (0 on success).
extern "C" int igm_nearest_codebook_f32(const float* z, const float* e,
                                        const float* e_sq, int32_t* idx, int m,
                                        int k, int d, cudaStream_t stream) {
  if (m < 1 || k < 1 || d < 1) return cudaErrorInvalidValue;
  if (d > kMaxD) {
    const dim3 grid((m + kWideTileM - 1) / kWideTileM);
    nearest_codebook_wide_kernel<<<grid, kWideThreads, 0, stream>>>(z, e, e_sq, idx, m, k, d);
    return static_cast<int>(cudaGetLastError());
  }
  const int row_tiles = (m + kTileM - 1) / kTileM;
  const int tiles = (k + kTileK - 1) / kTileK;
  // the least cluster with which the grid fills the card once (a CTA an
  // SM), then one CTA more a tile pair: measured on the H100, 4 tiles a CTA
  // in 128 CTAs beat 2 in 256 at M = 8192, and 1 tile a CTA in 256 CTAs beat
  // 2 in 128 at M = 4096
  int cluster = 1;
  while (2 * cluster <= kMaxCluster && 2 * cluster <= tiles && row_tiles * cluster < kOneWave)
    cluster *= 2;
  if (2 * cluster <= kMaxCluster && (tiles + cluster - 1) / cluster == 2) cluster *= 2;
  const int dp = ((d + 7) & ~7) + 4;
  const bool vec16 = d % 4 == 0 && reinterpret_cast<uintptr_t>(z) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(e) % 16 == 0;
  const size_t smem = (size_t)(kTileM + 2 * kTileK) * dp * sizeof(float);
  if (cudaError_t err = allow_dynamic_smem(nearest_codebook_kernel, smem)) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(row_tiles * cluster);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = cluster > 1 ? 1 : 0;
  if (cudaError_t err = cudaLaunchKernelEx(&config, nearest_codebook_kernel, z, e, e_sq, idx,
                                           m, k, d, dp, (int)vec16))
    return err;
  return static_cast<int>(cudaGetLastError());
}
