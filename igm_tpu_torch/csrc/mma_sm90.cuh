// The PTX the port's kernels share (sm_90a): 16-byte cp.async copies into
// shared memory, ldmatrix / stmatrix, mma.sync m16n8k16 bf16 -> f32, the
// bf16 packing of accumulator pairs, and the thread-block cluster (rank,
// barrier, another CTA's shared memory); on the host, the raising of a
// kernel's dynamic shared-memory limit.  Included by the kernel sources;
// each keeps its own fragment address helpers, which depend on its padded
// row length.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>
#include <mutex>
#include <utility>
#include <vector>

static __device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (4) bytes from global to shared memory, or as many zero bytes when !valid
static __device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
static __device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
static __device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most n of this thread's groups are in flight
template <int n>
static __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// ldmatrix / stmatrix: lane l gives the address of row l % 8 of matrix l / 8
// (x2: lanes 0-15).  Thread (g = l / 4, t = l % 4) holds row g, columns 2t
// and 2t + 1 (low, high half) of each matrix; with .trans, rows 2t and
// 2t + 1 of column g
static __device__ __forceinline__ void ldsm_x4(uint32_t r[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
static __device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
static __device__ __forceinline__ void ldsm_x2_trans(uint32_t r[2], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}
static __device__ __forceinline__ void stsm_x2_trans(__nv_bfloat16* p, const uint32_t r[2]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x2.trans.shared.b16 [%0], {%1, %2};\n"
               ::"r"(smem_addr(p)), "r"(r[0]), "r"(r[1])
               : "memory");
}

// c (16x8 f32) += a (16x16 bf16, row-major) . b (16x8 bf16, column-major)
static __device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                                uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// lo and hi rounded to bf16 (nearest even), lo in the low half
static __device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the thread-block cluster: this CTA's rank, the barrier (split into its
// arrive and its wait; it orders shared-memory writes before it against
// reads after it, across the cluster), and another CTA's shared memory
static __device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}
static __device__ __forceinline__ int cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}
static __device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
static __device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
static __device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}
template <typename T>
static __device__ __forceinline__ const T* remote(const T* p, int rank) {
  return cooperative_groups::this_cluster().map_shared_rank(const_cast<T*>(p), rank);
}

// Lets `kernel` take `bytes` of dynamic shared memory on the current device.
// The attribute is raised once per kernel and device (to the largest size
// asked for so far), not set again on every launch; it is raised for any
// size, since the default limit of 48 KB counts the kernel's static shared
// memory too.
template <typename Kernel>
static cudaError_t allow_dynamic_smem(Kernel kernel, size_t bytes) {
  if (bytes == 0) return cudaSuccess;
  int device = 0;
  if (cudaError_t err = cudaGetDevice(&device)) return err;
  static std::mutex mutex;
  static std::vector<std::pair<std::pair<const void*, int>, size_t>> granted;
  const std::pair<const void*, int> key(reinterpret_cast<const void*>(kernel), device);
  std::lock_guard<std::mutex> lock(mutex);
  size_t* have = nullptr;
  for (auto& entry : granted)
    if (entry.first == key) have = &entry.second;
  if (have && *have >= bytes) return cudaSuccess;
  if (cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(bytes)))
    return err;
  if (have)
    *have = bytes;
  else
    granted.push_back({key, bytes});
  return cudaSuccess;
}

// Phase stamps, for measurement builds only (nvcc -DIGM_STAMPS, as
// tools/kernel_stamps.py builds them): IGM_STAMP(k) has thread 0 of the CTA
// write %globaltimer (ns) to igm_stamps[blockIdx.x][k], and the library
// exports igm_stamps_read to copy the first `ctas` rows to the host.  In
// every other build IGM_STAMP(k) is nothing.
#ifdef IGM_STAMPS
constexpr int kStampSlots = 8;
constexpr int kStampCtas = 4096;
__device__ unsigned long long igm_stamps[kStampCtas][kStampSlots];
#define IGM_STAMP(k)                                                            \
  do {                                                                          \
    if (threadIdx.x == 0 && blockIdx.x < kStampCtas) {                          \
      unsigned long long t_;                                                    \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                   \
      igm_stamps[blockIdx.x][k] = t_;                                           \
    }                                                                           \
  } while (0)
extern "C" int igm_stamps_read(void* host, int ctas) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      host, igm_stamps, sizeof(unsigned long long) * kStampSlots * ctas));
}
#else
#define IGM_STAMP(k) \
  do {               \
  } while (0)
#endif
