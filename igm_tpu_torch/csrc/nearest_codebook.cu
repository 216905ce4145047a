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
// float32.  The design is the simple one; making it fast (mma with a
// split-float32 scheme, or the codebook held in shared memory) is later work:
//   - one block of 128 threads takes a tile of 32 rows of z and walks the
//     codebook in tiles of 64 codes, staging both in shared memory in chunks
//     of 32 features (rows padded by one float against bank conflicts);
//   - each thread owns 4 rows x 4 codes of every score tile, accumulating
//     each dot product over d = 0..D-1 in order with fmaf, so equal codebook
//     rows give bit-equal scores;
//   - each thread keeps a running (score, index) pair per row; the 16
//     threads that share a row merge their pairs with warp shuffles.  Every
//     comparison is lexicographic (smaller score, then lower index; a NaN
//     score first, as argmin returns the first NaN), so the result does not
//     depend on the order in which tiles and threads meet.
// Ragged M and a K or D that is not a multiple of its tile are masked.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kTileM = 32;                     // rows of z per block
constexpr int kTileK = 64;                     // codes per shared-memory tile
constexpr int kTileD = 32;                     // features per staged chunk
constexpr int kThreadsK = 16;                  // threads along the codes
constexpr int kThreadsM = 8;                   // threads along the rows
constexpr int kThreads = kThreadsK * kThreadsM;
constexpr int kRows = kTileM / kThreadsM;      // rows per thread
constexpr int kCodes = kTileK / kThreadsK;     // codes per thread

// (s, i) comes before (t, j): a NaN score first, then the smaller score, then
// the lower index
__device__ __forceinline__ bool precedes(float s, int i, float t, int j) {
  const bool s_nan = isnan(s), t_nan = isnan(t);
  if (s_nan != t_nan) return s_nan;
  if (s_nan || s == t) return i < j;
  return s < t;
}

__global__ void __launch_bounds__(kThreads)
nearest_codebook_kernel(const float* __restrict__ z, const float* __restrict__ e,
                        const float* __restrict__ e_sq, int32_t* __restrict__ idx,
                        int m, int k, int d) {
  __shared__ float zs[kTileM][kTileD + 1];
  __shared__ float es[kTileK][kTileD + 1];
  const int tid = threadIdx.x;
  const int tx = tid % kThreadsK, ty = tid / kThreadsK;
  const int row0 = blockIdx.x * kTileM;

  float best[kRows];
  int best_idx[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    best[r] = INFINITY;
    best_idx[r] = INT_MAX;
  }

  for (int k0 = 0; k0 < k; k0 += kTileK) {
    float acc[kRows][kCodes];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int j = 0; j < kCodes; ++j) acc[r][j] = 0.0f;

    for (int d0 = 0; d0 < d; d0 += kTileD) {
      __syncthreads();                         // the last chunk has been read
      for (int i = tid; i < kTileM * kTileD; i += kThreads) {
        const int r = i / kTileD, c = i % kTileD;
        const int gr = row0 + r, gc = d0 + c;
        zs[r][c] = (gr < m && gc < d) ? z[(size_t)gr * d + gc] : 0.0f;
      }
      for (int i = tid; i < kTileK * kTileD; i += kThreads) {
        const int r = i / kTileD, c = i % kTileD;
        const int gk = k0 + r, gc = d0 + c;
        es[r][c] = (gk < k && gc < d) ? e[(size_t)gk * d + gc] : 0.0f;
      }
      __syncthreads();
      // features past D are 0 on both sides: fmaf(0, 0, acc) == acc
#pragma unroll 8
      for (int c = 0; c < kTileD; ++c) {
        float zr[kRows], ek[kCodes];
#pragma unroll
        for (int r = 0; r < kRows; ++r) zr[r] = zs[ty + r * kThreadsM][c];
#pragma unroll
        for (int j = 0; j < kCodes; ++j) ek[j] = es[tx + j * kThreadsK][c];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int j = 0; j < kCodes; ++j) acc[r][j] = fmaf(zr[r], ek[j], acc[r][j]);
      }
    }

#pragma unroll
    for (int j = 0; j < kCodes; ++j) {
      const int code = k0 + tx + j * kThreadsK;
      if (code >= k) continue;
      const float esq = e_sq[code];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
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
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int off = kThreadsK / 2; off > 0; off >>= 1) {
      const float s = __shfl_xor_sync(0xffffffffu, best[r], off);
      const int i = __shfl_xor_sync(0xffffffffu, best_idx[r], off);
      if (precedes(s, i, best[r], best_idx[r])) {
        best[r] = s;
        best_idx[r] = i;
      }
    }
    const int row = row0 + ty + r * kThreadsM;
    if (tx == 0 && row < m) idx[row] = best_idx[r];
  }
}

}  // namespace

// z (m, d), e (k, d), e_sq (k,) float32 and idx (m,) int32, contiguous on the
// current device; m, k, d >= 1.  Returns cudaGetLastError() after the launch.
extern "C" int igm_nearest_codebook_f32(const float* z, const float* e,
                                        const float* e_sq, int32_t* idx, int m,
                                        int k, int d, cudaStream_t stream) {
  const dim3 grid((m + kTileM - 1) / kTileM);
  nearest_codebook_kernel<<<grid, kThreads, 0, stream>>>(z, e, e_sq, idx, m, k, d);
  return static_cast<int>(cudaGetLastError());
}
