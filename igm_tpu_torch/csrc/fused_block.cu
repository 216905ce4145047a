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
// b, scale and bias are (Cout,) f32.
//
// What bounds it on this card: the products.  At the flagship levels (batch
// 256, 32x32x64, 16x16x128, 8x8x256) each call does 19.33 GFLOP of products
// against 18-67 MB of traffic: 0.0195 ms at the bf16 tensor-core rate, and
// 0.289 ms at the f32 rate of the CUDA cores that this first kernel uses.
// The design keeps the conv output out of device memory:
//   - one CTA per (sample, group).  The group's statistics need every one of
//     its H*W*cg conv outputs, and they fit in the CTA's registers: each
//     thread owns 8 positions x 4 channels (32 f32 accumulators), so y is
//     normalised where it was computed and written once;
//   - Cin is walked in chunks.  Each chunk's (H+2)x(W+2) input tile (zeros
//     outside the image, by bounds checks, no padded copy) and its 9 x chunk
//     x cg weights are staged in shared memory as f32;
//   - per input channel and tap a thread loads 8 inputs and one float4 of
//     weights (shared by the threads of its channel quad) for 32 FMAs;
//   - the statistics are summed in a fixed order (warp shuffles, then the
//     warps in order): no atomics, results repeat from run to run.
// Its cost: each of a sample's `groups` CTAs reads the sample's whole input
// (from L2 mostly), and the products run on the CUDA cores, not the tensor
// cores (mma.sync / wgmma are later work).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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

template <typename T>
int launch(const void* x, const void* w, const void* b, const void* scale, const void* bias,
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
  return launch<float>(x, w, b, scale, bias, out, n, h, w_, cin, cout, groups, eps, stream);
}

extern "C" int igm_fused_block_bf16(const void* x, const void* w, const void* b,
                                    const void* scale, const void* bias, void* out, int n,
                                    int h, int w_, int cin, int cout, int groups, float eps,
                                    void* stream) {
  return launch<__nv_bfloat16>(x, w, b, scale, bias, out, n, h, w_, cin, cout, groups, eps,
                               stream);
}
