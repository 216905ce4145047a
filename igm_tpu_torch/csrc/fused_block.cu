// Fused UNet Block forward: conv3x3 + bias + GroupNorm + affine + Mish, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel igm_tpu/ops/pallas_fused_block.py
// fused_block_fwd (_kernel): for an NHWC activation x (N, H, W, Cin) and HWIO
// weights w (3, 3, Cin, Cout) in x's type,
//   y   = conv3x3_same(x, w) + b            (f32 accumulation, zero padding)
//   per sample and group of cg = Cout / groups channels over all H*W positions
//   var = max(E[y^2] - E[y]^2, 0)           (one pass, f32)
//   out = mish((y - E[y]) * rsqrt(var + eps) * scale + bias), in x's type.
// b, scale and bias are (Cout,) f32.  igm_tpu takes any such shape; so does
// this file, by four routes that ops/fused_block.py's _route chooses among:
//
//   cluster       bf16, Cin % 8 == 0, Cout in {64, 128, 256}, and a
//                 sample's positions in at most 8 CTA tiles:
//                 fused_block_mma_kernel<true>, one cluster a sample;
//   two_pass_mma  the same operands with more tiles a sample:
//                 fused_block_mma_kernel<false> writes y (f32) and partial
//                 sums, then fused_block_norm_kernel;
//   group         the first kernel (fused_block_kernel, f32 FMAs, one CTA per
//                 (sample, group)) where a group fits its block: the f32
//                 route at the flagship's levels;
//   two_pass_fma  any other shape, f32 or bf16: fused_block_conv_fma_kernel
//                 (f32 FMAs) writes y and partial sums, then
//                 fused_block_norm_kernel.
//
// What bounds it on this card: the products.  At the flagship levels (batch
// 256, 32x32x64, 16x16x128, 8x8x256) each call does 19.33 GFLOP of products
// against 18-67 MB of traffic: 0.0195 ms at the bf16 tensor-core rate, and
// 0.289 ms at the f32 rate of the CUDA cores.  The bf16 design
// (fused_block_mma_kernel) is an implicit GEMM on the tensor cores, per
// sample M = H*W positions, N = Cout, K = 9*Cin:
//   - mma.sync m16n8k16 bf16 -> f32; a CTA of 8 warps owns a tile of
//     positions x ALL Cout channels (each warp 64 positions x 64 channels,
//     128 f32 accumulators a thread, 8 ldmatrix for 32 mma a tap; 64 * 8 /
//     (Cout / 64) positions a CTA, one CTA an SM), so each input element is
//     read by one CTA;
//   - the tile is a th x tw rectangle of the image (tw = min(W, positions a
//     CTA), th as many rows as fill the rest); where a sample is one tile
//     whose positions divide 64 or are a multiple of it, a tile holds several
//     whole samples (the 8x8 level: 2), so that each staged weight serves
//     more positions;
//   - per chunk of 16 input channels, the tile's (th + 2) x (tw + 2) halo
//     arrives by cp.async (zeros outside the image by predication, no padded
//     copy; 32 bytes a position at a pitch of 48, so that ldmatrix's 8 rows
//     fall on distinct banks; the addresses from tables built once), with
//     the chunk's 9 x 16 x Cout weights (rows padded by 16 bytes), in two
//     stages; each tap's A fragments are ldmatrix rows of the halo at the
//     tap's shift, their shared-space addresses a base plus offsets;
//   - persistent: the card holds as many CTAs (clusters) as fit, each takes
//     units in turn, and the (unit, chunk) steps run as one pipeline, so a
//     unit's first chunk arrives while the previous unit finishes;
//   - statistics in a fixed order: each channel's sum over a warp's rows of
//     one sample by shuffles, the warps in order, a group's channels by a
//     warp's lanes and a shuffle tree; the CTAs of a sample form a cluster
//     and every CTA sums the ranks' group partials in rank order through
//     distributed shared memory,
//     so all hold the same totals; each CTA then normalises its accumulators
//     where they sit, applies the affine and Mish (row 1's closed form), and
//     writes once in bf16.  No atomics: outputs repeat bit for bit.
// A sample whose tiles outgrow a cluster (8 CTAs: 64x64 at Cout 128, every
// 128x128 level) runs the same conv with y written in f32 to the wrapper's
// scratch and each tile's group partials beside it; fused_block_norm_kernel
// sums the partials of a sample in tile order and normalises.  f32 stays on
// exact FMAs (no TF32): the group kernel where a group fits its block, else the
// FMA conv of the two-pass route.
// On the H100 (700 W) the cluster route takes 0.115, 0.091 and 0.088 ms at
// the three flagship levels (the UNet's Block, a cuDNN conv then the
// GroupNorm+Mish kernel: 0.145, 0.084, 0.069; the group kernel 1.48, 1.29,
// 1.93).  Phase stamps of a steady unit at 32x32x64: the conv 15 of 26 us,
// the statistics 4.6, normalise and write 5.3.  With the mma taken out the
// conv keeps 70% of its time: it is bound by mma.sync's per-warp ldmatrix
// traffic and the chunk barriers, not by the tensor cores (wgmma, which
// reads B from shared memory inside the tensor core, is the next design).
// Tried and dropped on the card: 16 warps of 64 x 32 (the 128-register cap
// spilled), three stages, two CTAs an SM of 64 x 32 warps, and the output
// staged through shared memory for 16-byte stores (all slower).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kPos = 8;              // positions per thread
constexpr int kCh = 4;               // channels per thread: one float4 of weights
constexpr int kMaxThreads = 1024;
constexpr int kMaxChunk = 16;        // input channels staged per pass
constexpr int kSmemBytes = 46 * 1024;   // dynamic; the static reduction buffer adds 272 bytes

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Mish with softplus = max(y, 0) + log1p(exp(-|y|)), as group_norm_mish.cu
__device__ __forceinline__ float mish(float y) {
  return y * tanhf(fmaxf(y, 0.f) + log1pf(expf(-fabsf(y))));
}

// Mish in closed form, as group_norm_mish.cu's mish_fast (its one-pass
// kernel, which the UNet's Block runs): tanh(softplus(y)) = n / (n + 2) with
// n = t (t + 2), t = exp(y), from the hardware's ex2 and rcp (about 2 ulp
// each); y capped at 20 inside the exponential.  The bf16 outputs use it;
// f32 outputs keep mish().
__device__ __forceinline__ float mish_fast(float y) {
  float t, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(t) : "f"(fminf(y, 20.f) * 1.4426950408889634f));
  const float n = t * (t + 2.f);
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(n + 2.f));
  return y * (n * r);
}

template <typename T> __device__ __forceinline__ float mish_out(float y) { return mish(y); }
template <> __device__ __forceinline__ float mish_out<__nv_bfloat16>(float y) {
  return mish_fast(y);
}

// ------------------------------------------------------------ the group route
// The first kernel: one CTA per (sample, group), each thread 8 positions x 4
// channels of the group (32 f32 accumulators), Cin staged in chunks of the
// (H+2)x(W+2) tile as f32; the group's statistics from the CTA's registers.
// Its cost: each of a sample's `groups` CTAs reads the sample's whole input,
// and the products run on the CUDA cores.

struct Layout {
  int h, w, cin, cout, groups;
  int cg;       // channels per group
  int cgp;      // cg rounded up to whole channel quads
  int hw;       // positions per sample
  int halo;     // (h + 2) * (w + 2): one channel's staged input tile
  int npt;      // position slots: ceil(hw / kPos)
  int chunk;    // input channels staged per pass
  int threads;  // quads * npt, rounded up to whole warps
};

// The launch layout of a shape; false where the kernel does not take it.
bool make_layout(int h, int w, int cin, int cout, int groups, Layout* l) {
  if (h <= 0 || w <= 0 || cin <= 0 || cout <= 0 || groups <= 0 || cout % groups != 0)
    return false;
  l->h = h;
  l->w = w;
  l->cin = cin;
  l->cout = cout;
  l->groups = groups;
  l->cg = cout / groups;
  const int quads = (l->cg + kCh - 1) / kCh;
  l->cgp = quads * kCh;
  l->hw = h * w;
  l->halo = (h + 2) * (w + 2);
  l->npt = (l->hw + kPos - 1) / kPos;
  const long long slots = (long long)quads * l->npt;
  if (slots > kMaxThreads) return false;
  l->threads = (int)((slots + 31) / 32 * 32);
  const int per_channel = (l->halo + 9 * l->cgp) * (int)sizeof(float);
  l->chunk = kSmemBytes / per_channel;
  if (l->chunk < 1) return false;
  if (l->chunk > kMaxChunk) l->chunk = kMaxChunk;
  if (l->chunk > cin) l->chunk = cin;
  return true;
}

// Sums (a, b) over the block in a fixed order; every thread gets the totals.
__device__ void block_sum(float& a, float& b, float* red) {
  for (int d = 16; d > 0; d >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, d);
    b += __shfl_down_sync(0xffffffffu, b, d);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    red[2 * warp] = a;
    red[2 * warp + 1] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float sa = 0.f, sb = 0.f;
    for (int i = 0; i < (int)blockDim.x / 32; ++i) {
      sa += red[2 * i];
      sb += red[2 * i + 1];
    }
    red[64] = sa;
    red[65] = sb;
  }
  __syncthreads();
  a = red[64];
  b = red[65];
}

// Block (sample n, group g) = blockIdx.x / groups, % groups.  Thread tid owns
// channel quad tid / npt of the group and positions pt, pt + npt, ... (pt =
// tid % npt), so neighbouring threads read neighbouring positions.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
fused_block_kernel(const T* __restrict__ x, const T* __restrict__ wt,
                   const float* __restrict__ b, const float* __restrict__ scale,
                   const float* __restrict__ bias, T* __restrict__ out, Layout l, float eps) {
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;                            // [chunk][9][cgp]
  float* x_s = smem + l.chunk * 9 * l.cgp;      // [chunk][halo]
  __shared__ float red[2 * kMaxThreads / 32 + 2];

  const int n = blockIdx.x / l.groups;
  const int co0 = (blockIdx.x % l.groups) * l.cg;
  const int tid = threadIdx.x;
  const int quad = tid / l.npt;
  const int pt = tid % l.npt;
  const bool active = quad < l.cgp / kCh;
  const int wp = l.w + 2;

  int off[kPos];
  bool valid[kPos];
#pragma unroll
  for (int j = 0; j < kPos; ++j) {
    const int p = pt + j * l.npt;
    valid[j] = active && p < l.hw;
    const int pc = valid[j] ? p : 0;
    off[j] = (pc / l.w) * wp + pc % l.w;
  }
  float acc[kPos][kCh];
#pragma unroll
  for (int j = 0; j < kPos; ++j)
#pragma unroll
    for (int c = 0; c < kCh; ++c) acc[j][c] = 0.f;

  const T* xs = x + (size_t)n * l.hw * l.cin;
  for (int ci0 = 0; ci0 < l.cin; ci0 += l.chunk) {
    const int nc = min(l.chunk, l.cin - ci0);
    __syncthreads();                    // the previous chunk has been read
    // w_s[(ci * 9 + tap) * cgp + c] = w[tap][ci0 + ci][co0 + c], 0 past cg
    for (int i = tid; i < nc * 9 * l.cgp; i += blockDim.x) {
      const int c = i % l.cgp;
      const int rest = i / l.cgp;
      const int tap = rest % 9, ci = rest / 9;
      w_s[i] = c < l.cg ? to_f32(wt[((size_t)tap * l.cin + ci0 + ci) * l.cout + co0 + c]) : 0.f;
    }
    // x_s[ci * halo + yy * wp + xx] = x[n][yy - 1][xx - 1][ci0 + ci], 0 outside
    for (int i = tid; i < nc * l.halo; i += blockDim.x) {
      const int ci = i % nc, q = i / nc;
      const int yy = q / wp - 1, xx = q % wp - 1;
      float v = 0.f;
      if (yy >= 0 && yy < l.h && xx >= 0 && xx < l.w)
        v = to_f32(xs[((size_t)yy * l.w + xx) * l.cin + ci0 + ci]);
      x_s[ci * l.halo + q] = v;
    }
    __syncthreads();
    if (active) {
      for (int ci = 0; ci < nc; ++ci) {
        const float* xc = x_s + ci * l.halo;
        const float* wc = w_s + ci * 9 * l.cgp + quad * kCh;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int shift = (tap / 3) * wp + tap % 3;
          const float4 wv = *reinterpret_cast<const float4*>(wc + tap * l.cgp);
#pragma unroll
          for (int j = 0; j < kPos; ++j) {
            const float xv = xc[off[j] + shift];
            acc[j][0] = fmaf(xv, wv.x, acc[j][0]);
            acc[j][1] = fmaf(xv, wv.y, acc[j][1]);
            acc[j][2] = fmaf(xv, wv.z, acc[j][2]);
            acc[j][3] = fmaf(xv, wv.w, acc[j][3]);
          }
        }
      }
    }
  }

  // conv bias, then the group's one-pass statistics over its valid outputs
  float bv[kCh], sc[kCh], bi[kCh];
  bool live[kCh];
#pragma unroll
  for (int c = 0; c < kCh; ++c) {
    const int ch = quad * kCh + c;
    live[c] = active && ch < l.cg;
    bv[c] = live[c] ? b[co0 + ch] : 0.f;
    sc[c] = live[c] ? scale[co0 + ch] : 0.f;
    bi[c] = live[c] ? bias[co0 + ch] : 0.f;
  }
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int j = 0; j < kPos; ++j)
#pragma unroll
    for (int c = 0; c < kCh; ++c) {
      acc[j][c] += bv[c];
      if (valid[j] && live[c]) {
        s1 += acc[j][c];
        s2 += acc[j][c] * acc[j][c];
      }
    }
  block_sum(s1, s2, red);
  const float count = (float)l.hw * (float)l.cg;
  const float mean = s1 / count;
  const float var = fmaxf(s2 / count - mean * mean, 0.f);
  const float inv = rsqrtf(var + eps);

  // normalise, affine, Mish, one write in x's type
  T* os = out + (size_t)n * l.hw * l.cout + co0 + quad * kCh;
#pragma unroll
  for (int j = 0; j < kPos; ++j) {
    if (!valid[j]) continue;
    T* row = os + (size_t)(pt + j * l.npt) * l.cout;
#pragma unroll
    for (int c = 0; c < kCh; ++c)
      if (live[c]) row[c] = from_f32<T>(mish((acc[j][c] - mean) * inv * sc[c] + bi[c]));
  }
}

// ----------------------------------------------- the tensor-core routes (bf16)
constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMT = 4;                         // m16 tiles a warp: 64 positions
constexpr int kWarpPos = 16 * kMT;
constexpr int kNT = 8;                         // n8 tiles a warp: 64 channels
constexpr int kWarpCh = 8 * kNT;
constexpr int kKc = 16;                        // input channels a stage
constexpr int kMaxCluster = 8;                 // CTAs of a sample (portable cluster)
constexpr int kRed = kMmaWarps * kWarpPos * kWarpCh / 16;   // m16 blocks x Cout: 2048
constexpr int kSmemLimit = 232448;             // dynamic shared memory a CTA may take
// a halo position's 16 input channels (32 bytes) at a pitch of 48: the 8 rows
// of an ldmatrix (8 consecutive positions) then fall on 8 distinct 16-byte
// bank groups (3 r mod 8), so a fragment's address is a base plus the tap's
// shift, with no swizzle
constexpr int kHaloPitch = 48;

struct MmaPlan {
  int n, h, w, cin, cout, groups;
  int wn, wm;          // warps along the channels (Cout / 64) and the positions (8 / wn)
  int p;               // positions a CTA tile: 64 wm
  int tw, th;          // a sample's tile: tw = min(W, p) columns, th = min(H, p / tw) rows
  int tiles_x, tiles;  // tiles along a row of tiles, and a sample's tiles
  int tile_pos;        // th tw
  int spc;             // samples a CTA tile holds (see make_mma_plan)
  int seg;             // m16 blocks of a warp that hold one sample: 4, or tile_pos / 16
  int cg_log2;         // log2(Cout / groups): Cout and groups are powers of 2 here
  int units;           // cluster route: groups of spc samples; two-pass: (sample, tile) pairs
  int hp, hq;          // a halo row (tw + 2) and a sample's halo ((th + 2) hp positions)
  int halo_bytes;      // spc hq positions of kHaloPitch bytes, rounded up to 128
  int bp;              // a staged weight row: Cout + 8 bf16 (16 bytes against bank conflicts)
  int segs_log2;       // log2(Cout / 8): 16-byte segments of a weight row
  int stage_bytes;     // halo_bytes + 9 kKc bp bf16
  int chunks;          // ceil(Cin / kKc)
  int table_bytes;     // the halo's table (2 spc hq ints) and the rows' (p ints)
  int smem;            // 2 stages, the tables, the epilogue's sums
};

// The plan of a shape; false where the tensor-core kernel does not take it
// (Cin % 8, Cout not 64/128/256, shared memory, int positions).  A tile
// holds spc = p / tile_pos whole samples where a sample is one tile whose
// positions divide 64 or are a multiple of it (and divide p): each warp's
// 64 rows then hold whole samples, or one sample.
bool make_mma_plan(int n, int h, int w, int cin, int cout, int groups, MmaPlan* l) {
  if (n <= 0 || h <= 0 || w <= 0 || cin <= 0 || cin % 8 != 0 || groups <= 0 ||
      cout % groups != 0 || (long long)n * h * w > 0x7fffffffLL)
    return false;
  if (cout != 64 && cout != 128 && cout != 256) return false;
  l->n = n;
  l->h = h;
  l->w = w;
  l->cin = cin;
  l->cout = cout;
  l->groups = groups;
  l->wn = cout / kWarpCh;
  l->wm = kMmaWarps / l->wn;
  l->p = kWarpPos * l->wm;
  l->tw = w < l->p ? w : l->p;
  l->th = h < l->p / l->tw ? h : l->p / l->tw;
  l->tiles_x = (w + l->tw - 1) / l->tw;
  const long long tiles = (long long)((h + l->th - 1) / l->th) * l->tiles_x;
  if (tiles > (1 << 30)) return false;
  l->tiles = (int)tiles;
  l->tile_pos = l->th * l->tw;
  const bool pack = l->tiles == 1 && l->tile_pos % 16 == 0 && l->p % l->tile_pos == 0 &&
                    (kWarpPos % l->tile_pos == 0 || l->tile_pos % kWarpPos == 0);
  l->spc = pack ? l->p / l->tile_pos : 1;
  l->seg = (pack && l->tile_pos < kWarpPos) ? l->tile_pos / 16 : kMT;
  l->cg_log2 = 0;
  while ((1 << l->cg_log2) < cout / groups) ++l->cg_log2;
  l->hp = l->tw + 2;
  l->hq = (l->th + 2) * l->hp;
  l->halo_bytes = (l->spc * l->hq * kHaloPitch + 127) & ~127;
  l->bp = cout + 8;
  l->segs_log2 = 0;
  while ((8 << l->segs_log2) < cout) ++l->segs_log2;
  l->stage_bytes = l->halo_bytes + 9 * kKc * l->bp * (int)sizeof(bf16);
  l->chunks = (cin + kKc - 1) / kKc;
  l->table_bytes = ((2 * l->spc * l->hq + l->p) * (int)sizeof(int) + 127) & ~127;
  const long long epilogue = 4LL * (2 * kRed + 2 * l->spc * cout + 2 * l->spc * groups);
  const long long smem = 2LL * l->stage_bytes + l->table_bytes + epilogue;
  if (smem > kSmemLimit) return false;
  l->smem = (int)smem;
  l->units = 0;
  return true;
}

// One stage by cp.async: the halo of a unit's tile for input channels ci0 ..
// ci0 + 15 (for each of its spc samples, image rows ty0 - 1 .. ty0 + th and
// columns tx0 - 1 .. tx0 + tw; zero outside the image, past the batch and
// past Cin), then the chunk's weights, [tap][16 input channels][Cout] at
// pitch bp (zero past Cin).  table[i] is halo entry i's (sample, row,
// column, half), packed once per CTA.
__device__ __forceinline__ void mma_stage(unsigned char* buf, const int* table,
                                          const bf16* __restrict__ x,
                                          const bf16* __restrict__ wt, const MmaPlan& l,
                                          int sample0, int ty0, int tx0, int ci0) {
  const int entries = 2 * l.spc * l.hq;
  for (int i = threadIdx.x; i < entries; i += kMmaThreads) {
    const int e = table[i];
    const int s = e >> 24, half = e & 1;
    const int yy = ty0 + ((e >> 13) & 0x7ff) - 1, xx = tx0 + ((e >> 1) & 0xfff) - 1;
    const int ci = ci0 + 8 * half;
    const bool valid = yy >= 0 && yy < l.h && xx >= 0 && xx < l.w && ci < l.cin &&
                       sample0 + s < l.n;
    cp_async16(buf + (i >> 1) * kHaloPitch + 16 * half,
               x + (valid ? (((size_t)(sample0 + s) * l.h + yy) * l.w + xx) * l.cin + ci : 0),
               valid);
  }
  bf16* ws = reinterpret_cast<bf16*>(buf + l.halo_bytes);
  const int segs = 1 << l.segs_log2;
  for (int i = threadIdx.x; i < 9 * kKc * segs; i += kMmaThreads) {
    const int row = i >> l.segs_log2, seg = i & (segs - 1);   // row = tap * kKc + k
    const int ci = ci0 + (row & (kKc - 1));
    const bool valid = ci < l.cin;
    cp_async16(ws + row * l.bp + 8 * seg,
               wt + (valid ? ((size_t)(row / kKc) * l.cin + ci) * l.cout + 8 * seg : 0), valid);
  }
}

// Persistent: the CTAs (cluster route: the clusters) of the grid take the
// plan's units in turn, CTA (cluster) j units j, j + stride, ...; a unit is
// a tile of positions x all Cout: cluster route, spc samples (rank r of a
// cluster of `tiles` CTAs: tile r of the sample); two-pass, tile u % tiles of
// sample u / tiles.  The (unit, chunk) steps run as one pipeline of two
// cp.async stages, so a unit's first chunk arrives while the last one ends.
// Warp (wr, wc) = (warp / wn, warp % wn) owns tile positions wr 64 .. wr 64 +
// 63 (sample i / tile_pos, its position i % tile_pos row-major in the th x
// tw rectangle) and channels wc 64 .. wc 64 + 63; its m16 blocks come in
// segments of `seg` that hold one sample.  kCluster: the unit's CTAs finish
// the GroupNorm and Mish and write out; else each writes y (f32) and its
// group partials (sum, sum of squares) to partials[sample][tile][group].
template <bool kCluster>
__global__ void __launch_bounds__(kMmaThreads, 1)
fused_block_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wt,
                       const float* __restrict__ b, const float* __restrict__ scale,
                       const float* __restrict__ bias, bf16* __restrict__ out,
                       float* __restrict__ y, float* __restrict__ partials, MmaPlan l,
                       float eps) {
  extern __shared__ __align__(128) unsigned char dyn[];
  unsigned char* stages = dyn;                                        // [2][stage_bytes]
  int* table = reinterpret_cast<int*>(dyn + 2 * l.stage_bytes);       // [2 spc hq]
  int* rows = table + 2 * l.spc * l.hq;                               // [p]
  float* red = reinterpret_cast<float*>(dyn + 2 * l.stage_bytes + l.table_bytes);  // [2][kRed]
  float* chan = red + 2 * kRed;                // [2][spc Cout]: per sample; later the statistics
  float* grp = chan + 2 * l.spc * l.cout;      // [2][spc groups]: this CTA's group partials

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp / l.wn, wc = warp % l.wn;
  const int hw = l.h * l.w;
  const int cg = l.cout / l.groups;
  const int csize = kCluster ? cluster_size() : 1;
  const int first = kCluster ? blockIdx.x / l.tiles : blockIdx.x;
  const int stride = kCluster ? gridDim.x / l.tiles : gridDim.x;
  const int my_units = first < l.units ? (l.units - 1 - first) / stride + 1 : 0;
  const int steps = my_units * l.chunks;
  // the unit the phase stamps time (IGM_STAMPS builds): the second, where
  // the pipeline runs from the unit before
  const int ks = my_units > 2 ? 1 : 0;
  if (ks == 0) IGM_STAMP(0);

  // the halo's entries: (sample, row, column, half) of entry i, packed; the
  // tile's rows: (sample, row, column) of position i, or -1 past its samples
  for (int i = tid; i < 2 * l.spc * l.hq; i += kMmaThreads) {
    const int q = i >> 1, s = q / l.hq, qs = q % l.hq;
    table[i] = (s << 24) | ((qs / l.hp) << 13) | ((qs % l.hp) << 1) | (i & 1);
  }
  for (int i = tid; i < l.p; i += kMmaThreads) {
    const int s = i / l.tile_pos, li = i % l.tile_pos;
    rows[i] = s < l.spc ? (s << 22) | ((li / l.tw) << 11) | (li % l.tw) : -1;
  }
  __syncthreads();
  // a unit's first sample and its tile's corner
  auto unit = [&](int k, int& sample0, int& ty0, int& tx0) {
    const int u = first + k * stride;
    int tile;
    if (kCluster) {
      sample0 = u * l.spc;
      tile = blockIdx.x % l.tiles;
    } else {
      sample0 = u / l.tiles;
      tile = u % l.tiles;
    }
    ty0 = (tile / l.tiles_x) * l.th;
    tx0 = (tile % l.tiles_x) * l.tw;
  };
  auto stage = [&](int st) {
    int sample0, ty0, tx0;
    unit(st / l.chunks, sample0, ty0, tx0);
    mma_stage(stages + (st & 1) * l.stage_bytes, table, x, wt, l, sample0, ty0, tx0,
              (st % l.chunks) * kKc);
  };

  // this lane's ldmatrix row of each m16 tile, as a halo byte offset at tap
  // (0, 0) with its 16-byte half (a row past the tile's samples reads
  // position 0: it is dropped), and of a tap's weights (row k, its channels)
  int qa[kMT];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    const int e = rows[wr * kWarpPos + 16 * mt + (lane & 15)];
    const int q = e < 0 ? 0 : (e >> 22) * l.hq + ((e >> 11) & 0x7ff) * l.hp + (e & 0x7ff);
    qa[mt] = q * kHaloPitch + (lane >> 4) * 16;
  }
  const int b_off = (((lane & 7) + ((lane >> 3) & 1) * 8) * l.bp + wc * kWarpCh + (lane >> 4) * 8) *
                    (int)sizeof(bf16);
  const uint32_t stages_at = smem_addr(stages);
  const int g = lane >> 2, t = lane & 3;
  const int nseg = kMT / l.seg;                // segments of a warp
  unsigned seg_end = 0;                        // bit mt: a segment ends at m16 block mt
  for (int mt = l.seg - 1; mt < kMT; mt += l.seg) seg_end |= 1u << mt;

  float acc[kMT][kNT][4];
  if (steps > 0) stage(0);
  cp_async_commit();
  for (int st = 0; st < steps; ++st) {
    const int c = st % l.chunks;
    if (ks > 0 && st == ks * l.chunks) IGM_STAMP(0);
    if (c == 0) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;
    }
    const uint32_t buf = stages_at + (st & 1) * l.stage_bytes;
    if (st + 1 < steps) stage(st + 1);
    cp_async_commit();
    cp_async_wait<1>();                        // all but step st + 1 have arrived
    __syncthreads();
    if (st == ks * l.chunks) IGM_STAMP(1);
    const uint32_t ws = buf + l.halo_bytes + b_off;
#pragma unroll 1
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const uint32_t a_at = buf + (dy * l.hp + dx) * kHaloPitch;
        const uint32_t b_at = ws + (dy * 3 + dx) * kKc * l.bp * (int)sizeof(bf16);
        uint32_t bw[kNT / 2][4];
#pragma unroll
        for (int j = 0; j < kNT / 2; ++j) ldsm_x4_trans_at(bw[j], b_at + 32 * j);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          uint32_t a[4];
          ldsm_x4_at(a, a_at + qa[mt]);
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt)
            mma_bf16(acc[mt][nt], a, bw[nt >> 1][2 * (nt & 1)], bw[nt >> 1][2 * (nt & 1) + 1]);
        }
      }
    }
    __syncthreads();                           // this stage is free for step st + 2
    if (c != l.chunks - 1) continue;

    // ---- the unit's epilogue
    const int k = st / l.chunks;
    int sample0, ty0, tx0;
    unit(k, sample0, ty0, tx0);
    if (k == ks) IGM_STAMP(2);
    // bit 2 mt + r: accumulator row wr 64 + 16 mt + g + 8 r is a position of
    // the image and the batch
    unsigned valid = 0;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int e = rows[wr * kWarpPos + 16 * mt + g + 8 * r];
        if (e >= 0 && sample0 + (e >> 22) < l.n && ty0 + ((e >> 11) & 0x7ff) < l.h &&
            tx0 + (e & 0x7ff) < l.w)
          valid |= 1u << (2 * mt + r);
      }
    // the conv bias, then each channel's sums over a segment's valid rows
    // (the 8 lanes of a channel pair by shuffles) into red
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int ch = wc * kWarpCh + 8 * nt + 2 * t + cc;
        const float bv = b[ch];
        float s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float v = acc[mt][nt][2 * r + cc] += bv;
            const float vm = (valid >> (2 * mt + r) & 1) ? v : 0.f;
            s1 += vm;
            s2 += vm * vm;
          }
          if (seg_end >> mt & 1) {             // the segment ends (warp-uniform)
#pragma unroll
            for (int off = 4; off < 32; off <<= 1) {
              s1 += __shfl_xor_sync(0xffffffffu, s1, off);
              s2 += __shfl_xor_sync(0xffffffffu, s2, off);
            }
            if (g == 0) {
              const int sg = wr * nseg + __popc(seg_end & ((1u << mt) - 1));
              red[sg * l.cout + ch] = s1;
              red[kRed + sg * l.cout + ch] = s2;
            }
            s1 = s2 = 0.f;
          }
        }
      }
    __syncthreads();
    // per (sample, channel): its segments in order
    const int per_sample = l.spc == 1 ? l.wm * nseg : l.tile_pos / (16 * l.seg);
    for (int i = tid; i < l.spc * l.cout; i += kMmaThreads) {
      const int s = i / l.cout, ch = i % l.cout;
      float s1 = 0.f, s2 = 0.f;
      for (int m = s * per_sample; m < (s + 1) * per_sample; ++m) {
        s1 += red[m * l.cout + ch];
        s2 += red[kRed + m * l.cout + ch];
      }
      chan[i] = s1;
      chan[l.spc * l.cout + i] = s2;
    }
    __syncthreads();
    if constexpr (!kCluster) {
      // per group: warp w takes groups w, w + 8, ...; lane c sums channels
      // c, c + 32, ... of the group, then a shuffle tree; to the partials
      for (int gi = warp; gi < l.groups; gi += kMmaWarps) {
        float s1 = 0.f, s2 = 0.f;
        for (int ch = gi * cg + lane; ch < (gi + 1) * cg; ch += 32) {
          s1 += chan[ch];
          s2 += chan[l.cout + ch];
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          s1 += __shfl_xor_sync(0xffffffffu, s1, off);
          s2 += __shfl_xor_sync(0xffffffffu, s2, off);
        }
        if (lane == 0) {
          float* pp = partials + ((size_t)(first + k * stride) * l.groups + gi) * 2;
          pp[0] = s1;
          pp[1] = s2;
        }
      }
      if (k == ks) IGM_STAMP(3);
      float* ys = y + (size_t)sample0 * hw * l.cout;
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (!(valid >> (2 * mt + r) & 1)) continue;
          const int e = rows[wr * kWarpPos + 16 * mt + g + 8 * r];
          const int pix = (ty0 + ((e >> 11) & 0x7ff)) * l.w + tx0 + (e & 0x7ff);
          float* row = ys + (size_t)pix * l.cout + wc * kWarpCh + 2 * t;
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt)
            *reinterpret_cast<float2*>(row + 8 * nt) =
                make_float2(acc[mt][nt][2 * r], acc[mt][nt][2 * r + 1]);
        }
      if (k == ks) IGM_STAMP(4);
    } else {
      // the ranks may still read grp for the previous unit
      if (csize > 1 && k > 0) cluster_wait();
      // per (sample, group): warp w takes w, w + 8, ...; lane c sums
      // channels c, c + 32, ... of the group, then a shuffle tree
      for (int i = warp; i < l.spc * l.groups; i += kMmaWarps) {
        const int s = i / l.groups, gi = i % l.groups;
        float s1 = 0.f, s2 = 0.f;
        for (int ch = gi * cg + lane; ch < (gi + 1) * cg; ch += 32) {
          s1 += chan[s * l.cout + ch];
          s2 += chan[l.spc * l.cout + s * l.cout + ch];
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          s1 += __shfl_xor_sync(0xffffffffu, s1, off);
          s2 += __shfl_xor_sync(0xffffffffu, s2, off);
        }
        if (lane == 0) {
          grp[i] = s1;
          grp[l.spc * l.groups + i] = s2;
        }
      }
      if (csize > 1)
        cluster_sync();                        // every rank's partials are written
      else
        __syncthreads();
      // the unit's totals: every CTA sums the ranks' partials in rank order;
      // the mean and 1 / std go where chan was
      for (int i = tid; i < l.spc * l.groups; i += kMmaThreads) {
        float s1 = 0.f, s2 = 0.f;
        for (int r = 0; r < csize; ++r) {
          s1 += csize > 1 ? *remote(&grp[i], r) : grp[i];
          s2 += csize > 1 ? *remote(&grp[l.spc * l.groups + i], r) : grp[l.spc * l.groups + i];
        }
        const float count = (float)hw * (float)cg;
        const float mean = s1 / count;
        const float var = fmaxf(s2 / count - mean * mean, 0.f);
        chan[i] = mean;
        chan[l.spc * l.groups + i] = rsqrtf(var + eps);
      }
      if (csize > 1) cluster_arrive();         // this CTA is done with the others' partials
      __syncthreads();
      if (k == ks) IGM_STAMP(3);
      // normalise, affine, Mish where the accumulators sit; one write in bf16.
      // A segment's sample's statistics are loaded when it begins.
      float sc[kNT][2], bi[kNT][2], mean[kNT][2], inv[kNT][2];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int ch = wc * kWarpCh + 8 * nt + 2 * t + cc;
          sc[nt][cc] = scale[ch];
          bi[nt][cc] = bias[ch];
        }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        if (mt == 0 || (seg_end >> (mt - 1) & 1)) {   // a segment begins (warp-uniform)
          int s = (wr * kWarpPos + 16 * mt) / l.tile_pos;
          s = s < l.spc ? s : l.spc - 1;
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
            for (int cc = 0; cc < 2; ++cc) {
              const int gi = s * l.groups + ((wc * kWarpCh + 8 * nt + 2 * t + cc) >> l.cg_log2);
              mean[nt][cc] = chan[gi];
              inv[nt][cc] = chan[l.spc * l.groups + gi];
            }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          uint32_t o[kNT];
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt)
            o[nt] = pack_bf16(mish_fast((acc[mt][nt][2 * r] - mean[nt][0]) * inv[nt][0] *
                                        sc[nt][0] + bi[nt][0]),
                              mish_fast((acc[mt][nt][2 * r + 1] - mean[nt][1]) * inv[nt][1] *
                                        sc[nt][1] + bi[nt][1]));
          if (valid >> (2 * mt + r) & 1) {
            const int e = rows[wr * kWarpPos + 16 * mt + g + 8 * r];
            const int pix = (ty0 + ((e >> 11) & 0x7ff)) * l.w + tx0 + (e & 0x7ff);
            bf16* row = out + ((size_t)(sample0 + (e >> 22)) * hw + pix) * l.cout +
                        wc * kWarpCh + 2 * t;
#pragma unroll
            for (int nt = 0; nt < kNT; ++nt) *reinterpret_cast<uint32_t*>(row + 8 * nt) = o[nt];
          }
        }
      }
      if (k == ks) IGM_STAMP(4);
      // the next unit's per-sample sums overwrite chan: every thread is
      // done reading the statistics
      __syncthreads();
    }
  }
  if (kCluster && csize > 1 && my_units > 0) cluster_wait();   // no CTA leaves while read
}

// ------------------------------------------------------ the two-pass FMA conv
// Any shape, f32 or bf16: a CTA of 256 threads takes a tile of at most 64
// positions (a th x tw rectangle, tw = min(W, 64)) x 32 output channels;
// each thread 4 positions x 2 channels, exact f32 FMAs (bf16 products are
// exact in f32), Cin staged 8 channels at a time as f32.  It writes y (f32)
// and, for every group, the tile's partial sums (0 where the tile holds none
// of the group's channels).
constexpr int kFmaThreads = 256;
constexpr int kFmaPos = 64;                    // positions a tile
constexpr int kFmaCh = 32;                     // output channels a tile
constexpr int kFmaCi = 8;                      // input channels a stage
constexpr int kFmaHalo = 3 * (kFmaPos + 2);    // the largest (th + 2)(tw + 2): 198

struct FmaPlan {
  int h, w, cin, cout, groups;
  int tw, th, tiles_x;  // the spatial tile, and tiles along a row of tiles
  int ctiles, tiles;    // channel tiles, and a sample's tiles (spatial x channel)
  int hp;               // a halo row: tw + 2
};

bool make_fma_plan(int h, int w, int cin, int cout, int groups, FmaPlan* l) {
  if (h <= 0 || w <= 0 || cin < 0 || cout <= 0 || groups <= 0 || cout % groups != 0)
    return false;
  l->h = h;
  l->w = w;
  l->cin = cin;
  l->cout = cout;
  l->groups = groups;
  l->tw = w < kFmaPos ? w : kFmaPos;
  l->th = h < kFmaPos / l->tw ? h : kFmaPos / l->tw;
  l->tiles_x = (w + l->tw - 1) / l->tw;
  l->ctiles = (cout + kFmaCh - 1) / kFmaCh;
  const long long tiles = (long long)((h + l->th - 1) / l->th) * l->tiles_x * l->ctiles;
  if (tiles > (1 << 30)) return false;
  l->tiles = (int)tiles;
  l->hp = l->tw + 2;
  return true;
}

template <typename T>
__global__ void __launch_bounds__(kFmaThreads)
fused_block_conv_fma_kernel(const T* __restrict__ x, const T* __restrict__ wt,
                            const float* __restrict__ b, float* __restrict__ y,
                            float* __restrict__ partials, FmaPlan l) {
  __shared__ float x_s[kFmaCi][kFmaHalo];
  __shared__ float w_s[9][kFmaCi][kFmaCh];
  __shared__ float y_s[kFmaPos][kFmaCh + 1];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tc = tid % 16, tp = tid / 16;      // channels 2 tc, 2 tc + 1; positions tp + 16 j
  const int n = blockIdx.x / l.tiles, tile = blockIdx.x % l.tiles;
  const int st = tile / l.ctiles, c0 = (tile % l.ctiles) * kFmaCh;
  const int ty0 = (st / l.tiles_x) * l.th, tx0 = (st % l.tiles_x) * l.tw;
  const int tile_pos = l.th * l.tw, halo = (l.th + 2) * l.hp;
  const int hw = l.h * l.w;
  const T* xs = x + (size_t)n * hw * l.cin;
  auto pos_of = [&](int i) {                   // position i of the tile in the sample, or -1
    const int yy = ty0 + i / l.tw, xx = tx0 + i % l.tw;
    return (i < tile_pos && yy < l.h && xx < l.w) ? yy * l.w + xx : -1;
  };

  int q[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i = tp + 16 * j < tile_pos ? tp + 16 * j : 0;
    q[j] = (i / l.tw) * l.hp + i % l.tw;
  }
  float acc[4][2] = {};
  for (int ci0 = 0; ci0 < l.cin; ci0 += kFmaCi) {
    __syncthreads();                           // the previous stage has been read
    for (int i = tid; i < kFmaCi * halo; i += kFmaThreads) {
      const int ci = i % kFmaCi, qq = i / kFmaCi;
      const int yy = ty0 + qq / l.hp - 1, xx = tx0 + qq % l.hp - 1;
      const bool valid = yy >= 0 && yy < l.h && xx >= 0 && xx < l.w && ci0 + ci < l.cin;
      x_s[ci][qq] = valid ? to_f32(xs[((size_t)yy * l.w + xx) * l.cin + ci0 + ci]) : 0.f;
    }
    for (int i = tid; i < 9 * kFmaCi * kFmaCh; i += kFmaThreads) {
      const int co = i % kFmaCh, ci = (i / kFmaCh) % kFmaCi, tap = i / (kFmaCh * kFmaCi);
      const bool valid = ci0 + ci < l.cin && c0 + co < l.cout;
      w_s[tap][ci][co] =
          valid ? to_f32(wt[((size_t)tap * l.cin + ci0 + ci) * l.cout + c0 + co]) : 0.f;
    }
    __syncthreads();
    for (int ci = 0; ci < kFmaCi; ++ci) {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int shift = (tap / 3) * l.hp + tap % 3;
        const float w0 = w_s[tap][ci][2 * tc], w1 = w_s[tap][ci][2 * tc + 1];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float xv = x_s[ci][q[j] + shift];
          acc[j][0] = fmaf(xv, w0, acc[j][0]);
          acc[j][1] = fmaf(xv, w1, acc[j][1]);
        }
      }
    }
  }

  // the conv bias; y out, and into y_s for the partials
  float* ys = y + (size_t)n * hw * l.cout;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int pj = pos_of(tp + 16 * j);
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int ch = c0 + 2 * tc + cc;
      const float v = acc[j][cc] + (ch < l.cout ? b[ch] : 0.f);
      y_s[tp + 16 * j][2 * tc + cc] = v;
      if (pj >= 0 && ch < l.cout) ys[(size_t)pj * l.cout + ch] = v;
    }
  }
  __syncthreads();
  // warp w: groups w, w + 8, ...; the lanes take the tile's elements of the
  // group in a fixed order, then a shuffle tree
  const int cg = l.cout / l.groups;
  for (int gi = warp; gi < l.groups; gi += kFmaThreads / 32) {
    const int lo = max(c0, gi * cg) - c0;
    const int hi = min(min(c0 + kFmaCh, (gi + 1) * cg), l.cout) - c0;
    float s1 = 0.f, s2 = 0.f;
    if (lo < hi) {
      const int nch = hi - lo;
      for (int e = lane; e < kFmaPos * nch; e += 32) {
        const int i = e / nch;
        if (pos_of(i) < 0) continue;
        const float v = y_s[i][lo + e % nch];
        s1 += v;
        s2 += v * v;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    if (lane == 0) {
      float* pp = partials + ((size_t)blockIdx.x * l.groups + gi) * 2;
      pp[0] = s1;
      pp[1] = s2;
    }
  }
}

// ------------------------------------------------------ the two-pass finish
// CTA blockIdx.x = sample n * ctas + part: the sample's group totals from its
// tiles' partials, summed in tile order (every CTA of the sample the same),
// then elements [part kNormPerCta, ...) of the sample: normalise, affine,
// Mish, one write in x's type.
constexpr int kNormThreads = 256;
constexpr int kNormPerCta = 8192;

template <typename T>
__global__ void __launch_bounds__(kNormThreads)
fused_block_norm_kernel(const float* __restrict__ y, const float* __restrict__ partials,
                        const float* __restrict__ scale, const float* __restrict__ bias,
                        T* __restrict__ out, int hw, int cout, int groups, int tiles, int ctas,
                        float eps) {
  extern __shared__ float group_stat[];        // [groups][2]: mean, 1 / std
  const int n = blockIdx.x / ctas, part = blockIdx.x % ctas;
  const int cg = cout / groups;
  const float count = (float)hw * (float)cg;
  for (int gi = threadIdx.x; gi < groups; gi += kNormThreads) {
    float s1 = 0.f, s2 = 0.f;
    for (int t = 0; t < tiles; ++t) {
      const float* pp = partials + (((size_t)n * tiles + t) * groups + gi) * 2;
      s1 += pp[0];
      s2 += pp[1];
    }
    const float mean = s1 / count;
    const float var = fmaxf(s2 / count - mean * mean, 0.f);
    group_stat[2 * gi] = mean;
    group_stat[2 * gi + 1] = rsqrtf(var + eps);
  }
  __syncthreads();
  const size_t per = (size_t)hw * cout, base = (size_t)n * per;
  const size_t end = (size_t)(part + 1) * kNormPerCta, hi = end < per ? end : per;
  for (size_t e = (size_t)part * kNormPerCta + threadIdx.x; e < hi; e += kNormThreads) {
    const int ch = (int)(e % cout), gi = ch / cg;
    out[base + e] = from_f32<T>(mish_out<T>((y[base + e] - group_stat[2 * gi]) *
                                            group_stat[2 * gi + 1] * scale[ch] + bias[ch]));
  }
}

template <typename Kernel, typename... Args>
cudaError_t launch_ex(Kernel kernel, int ctas, int threads, int cluster, size_t smem,
                      void* stream, Args... args) {
  if (cudaError_t err = allow_dynamic_smem(kernel, smem)) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(ctas);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem;
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = cluster > 1 ? 1 : 0;
  if (cudaError_t err = cudaLaunchKernelEx(&config, kernel, args...)) return err;
  return cudaGetLastError();
}

bool grid_fits(int n, int tiles) { return (long long)n * tiles <= 0x7fffffffLL; }

template <typename T>
int launch_group(const void* x, const void* w, const void* b, const void* scale, const void* bias,
           void* out, int n, int h, int w_, int cin, int cout, int groups, float eps,
           void* stream) {
  Layout l;
  if (n <= 0 || !make_layout(h, w_, cin, cout, groups, &l)) return cudaErrorInvalidValue;
  const size_t smem = (size_t)l.chunk * (9 * l.cgp + l.halo) * sizeof(float);
  fused_block_kernel<T><<<n * groups, l.threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(b),
      static_cast<const float*>(scale), static_cast<const float*>(bias), static_cast<T*>(out), l,
      eps);
  return cudaGetLastError();
}

}  // namespace

// x: (n, h, w, cin) contiguous; w: (3, 3, cin, cout) contiguous, in x's type;
// b, scale, bias: (cout,) f32; out: (n, h, w, cout).  Returns the CUDA error
// code of the launch (0 on success; cudaErrorInvalidValue for a shape the
// kernel does not take).
extern "C" int igm_fused_block_f32(const void* x, const void* w, const void* b,
                                   const void* scale, const void* bias, void* out, int n,
                                   int h, int w_, int cin, int cout, int groups, float eps,
                                   void* stream) {
  return launch_group<float>(x, w, b, scale, bias, out, n, h, w_, cin, cout, groups, eps, stream);
}

extern "C" int igm_fused_block_bf16(const void* x, const void* w, const void* b,
                                    const void* scale, const void* bias, void* out, int n,
                                    int h, int w_, int cin, int cout, int groups, float eps,
                                    void* stream) {
  return launch_group<__nv_bfloat16>(x, w, b, scale, bias, out, n, h, w_, cin, cout, groups, eps,
                               stream);
}

// The tensor-core plan's tiles a sample for a shape, or -1 where the
// tensor-core kernel does not take it (ops/fused_block.py computes the same
// to choose a route; the card tests hold the two together).
extern "C" int igm_fused_block_mma_tiles(int h, int w, int cin, int cout, int groups) {
  MmaPlan l;
  return make_mma_plan(1, h, w, cin, cout, groups, &l) ? l.tiles : -1;
}

// The FMA conv's tiles a sample (spatial x channel), or -1.
extern "C" int igm_fused_block_fma_tiles(int h, int w, int cin, int cout, int groups) {
  FmaPlan l;
  return make_fma_plan(h, w, cin, cout, groups, &l) ? l.tiles : -1;
}

namespace {

// Launches the persistent tensor-core kernel: as many CTAs (cluster route:
// clusters of the sample's `tiles` CTAs) as the card holds at once, at most
// one a unit.
template <bool kCluster>
int launch_mma(const void* x, const void* w, const void* b, const void* scale, const void* bias,
               void* out, void* y, void* partials, int n, int h, int w_, int cin, int cout,
               int groups, float eps, void* stream) {
  MmaPlan l;
  if (!make_mma_plan(n, h, w_, cin, cout, groups, &l)) return cudaErrorInvalidValue;
  if (kCluster ? l.tiles > kMaxCluster : (l.spc != 1 || !grid_fits(n, l.tiles)))
    return cudaErrorInvalidValue;
  l.units = kCluster ? (n + l.spc - 1) / l.spc : n * l.tiles;
  const int cluster = kCluster ? l.tiles : 1;
  auto kernel = fused_block_mma_kernel<kCluster>;
  if (cudaError_t err = allow_dynamic_smem(kernel, l.smem)) return err;
  cudaLaunchConfig_t config = {};
  config.blockDim = dim3(kMmaThreads);
  config.dynamicSmemBytes = l.smem;
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = cluster > 1 ? 1 : 0;
  int resident = 0;                            // units the card runs at once
  if (cluster > 1) {
    config.gridDim = dim3(cluster);
    if (cudaError_t err = cudaOccupancyMaxActiveClusters(&resident, kernel, &config)) return err;
  } else {
    int device = 0, sms = 0, per_sm = 0;
    if (cudaError_t err = cudaGetDevice(&device)) return err;
    if (cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device))
      return err;
    if (cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                                         kMmaThreads, l.smem))
      return err;
    resident = sms * per_sm;
  }
  if (resident < 1) return cudaErrorInvalidConfiguration;
  config.gridDim = dim3((l.units < resident ? l.units : resident) * cluster);
  if (cudaError_t err = cudaLaunchKernelEx(
          &config, kernel, static_cast<const bf16*>(x), static_cast<const bf16*>(w),
          static_cast<const float*>(b), static_cast<const float*>(scale),
          static_cast<const float*>(bias), static_cast<bf16*>(out), static_cast<float*>(y),
          static_cast<float*>(partials), l, eps))
    return err;
  return cudaGetLastError();
}

}  // namespace

// The cluster route, bf16: arguments as igm_fused_block_bf16; x and w on a
// 16-byte boundary; cudaErrorInvalidValue where a sample needs more than 8
// tiles or the plan does not take the shape.
extern "C" int igm_fused_block_cluster_bf16(const void* x, const void* w, const void* b,
                                            const void* scale, const void* bias, void* out,
                                            int n, int h, int w_, int cin, int cout, int groups,
                                            float eps, void* stream) {
  return launch_mma<true>(x, w, b, scale, bias, out, nullptr, nullptr, n, h, w_, cin, cout,
                          groups, eps, stream);
}

// The two-pass routes' conv: y (n, h, w, cout) f32 and partials (n, tiles,
// groups, 2) f32, tiles as igm_fused_block_{mma,fma}_tiles give them.  The
// mma conv takes bf16 on a 16-byte boundary; the FMA conv any shape.
extern "C" int igm_fused_block_conv_mma_bf16(const void* x, const void* w, const void* b,
                                             void* y, void* partials, int n, int h, int w_,
                                             int cin, int cout, int groups, void* stream) {
  return launch_mma<false>(x, w, b, nullptr, nullptr, nullptr, y, partials, n, h, w_, cin, cout,
                           groups, 0.f, stream);
}

template <typename T>
int launch_conv_fma(const void* x, const void* w, const void* b, void* y, void* partials, int n,
                    int h, int w_, int cin, int cout, int groups, void* stream) {
  FmaPlan l;
  if (n <= 0 || !make_fma_plan(h, w_, cin, cout, groups, &l) || !grid_fits(n, l.tiles))
    return cudaErrorInvalidValue;
  return launch_ex(fused_block_conv_fma_kernel<T>, n * l.tiles, kFmaThreads, 1, 0, stream,
                   static_cast<const T*>(x), static_cast<const T*>(w),
                   static_cast<const float*>(b), static_cast<float*>(y),
                   static_cast<float*>(partials), l);
}

extern "C" int igm_fused_block_conv_fma_f32(const void* x, const void* w, const void* b, void* y,
                                            void* partials, int n, int h, int w_, int cin,
                                            int cout, int groups, void* stream) {
  return launch_conv_fma<float>(x, w, b, y, partials, n, h, w_, cin, cout, groups, stream);
}

extern "C" int igm_fused_block_conv_fma_bf16(const void* x, const void* w, const void* b, void* y,
                                             void* partials, int n, int h, int w_, int cin,
                                             int cout, int groups, void* stream) {
  return launch_conv_fma<bf16>(x, w, b, y, partials, n, h, w_, cin, cout, groups, stream);
}

// The two-pass finish: out (n, hw, cout) in its type from y and the partials
// of `tiles` tiles a sample; groups up to 16,384 (their statistics in shared
// memory).
template <typename T>
int launch_norm(const void* y, const void* partials, const void* scale, const void* bias,
                void* out, int n, int hw, int cout, int groups, int tiles, float eps,
                void* stream) {
  if (n <= 0 || hw <= 0 || cout <= 0 || groups <= 0 || groups > 16384 || cout % groups != 0 ||
      tiles <= 0)
    return cudaErrorInvalidValue;
  const long long ctas = ((long long)hw * cout + kNormPerCta - 1) / kNormPerCta;
  if (ctas > (1 << 30) || !grid_fits(n, (int)ctas)) return cudaErrorInvalidValue;
  return launch_ex(fused_block_norm_kernel<T>, n * (int)ctas, kNormThreads, 1,
                   2 * sizeof(float) * groups, stream, static_cast<const float*>(y),
                   static_cast<const float*>(partials), static_cast<const float*>(scale),
                   static_cast<const float*>(bias), static_cast<T*>(out), hw, cout, groups,
                   tiles, (int)ctas, eps);
}

extern "C" int igm_fused_block_norm_f32(const void* y, const void* partials, const void* scale,
                                        const void* bias, void* out, int n, int hw, int cout,
                                        int groups, int tiles, float eps, void* stream) {
  return launch_norm<float>(y, partials, scale, bias, out, n, hw, cout, groups, tiles, eps, stream);
}

extern "C" int igm_fused_block_norm_bf16(const void* y, const void* partials, const void* scale,
                                         const void* bias, void* out, int n, int hw, int cout,
                                         int groups, int tiles, float eps, void* stream) {
  return launch_norm<bf16>(y, partials, scale, bias, out, n, hw, cout, groups, tiles, eps, stream);
}
