// Shared pieces of the kernels: the Laplace transform (dpps_perturb.cu,
// laplace_noise.cu), the block reduction in a fixed order and the
// read-once 16-byte load of the row kernels (l1_norm.cu, dpps_perturb.cu,
// which finish each row's sum in one launch through per-row ticket
// counters), and the asynchronous copies that fill the shared-memory rings
// of flash_attention.cu, spmm.cu and pushsum_mix.cu.
//
// No float atomics anywhere, so every sum is deterministic. Element
// offsets are int64 throughout: at the full-width shape N * d_pad exceeds
// 2^31.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr int kThreads = 256;
// Rows a grid holds in gridDim.y. The row kernels (l1_norm.cu,
// dpps_perturb.cu, clip_scale.cu) take more rows in one launch for each
// block of kMaxGridRows, each kernel told its first row.
constexpr int64_t kMaxGridRows = 65535;
constexpr int kQuadsPerThread = 8;
// Elements a block of clip_scale.cu: the 64 x 128 tile of the Pallas kernels.
constexpr int64_t kChunk = (int64_t)kThreads * kQuadsPerThread * 4;

// Laplace(0, scale) from uint32 bits by the inverse CDF, the transform of
// repro/kernels/laplace_noise.py::_laplace_transform:
//   u = (bits >> 8) 2^-24, c = u - 1/2, -scale sign(c) log(max(1 - 2|c|, 1e-30)).
// Bits 1 << 31 give c = 0 and so exactly 0. Each step is rounded as the
// plain version (repro_torch.kernels.ref.laplace_from_bits) rounds it; the
// card's logf may differ from the CPU's log by an ulp.
__device__ __forceinline__ float laplace_from_bits(uint32_t bits, float scale) {
  const float u = (float)(bits >> 8) * (1.0f / 16777216.0f);
  const float c = u - 0.5f;
  const float mag = fmaxf(1.0f - 2.0f * fabsf(c), 1e-30f);
  const float sgn = c > 0.f ? 1.f : (c < 0.f ? -1.f : 0.f);
  return -scale * sgn * logf(mag);
}

// Sum over the block in a fixed order: warp shuffles, then thread 0 adds
// the warp totals in warp order. The result is valid in thread 0 only.
__device__ __forceinline__ float block_sum(float v, float* smem) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x == 0) {
    const int n_warps = (blockDim.x + 31) >> 5;
    for (int i = 0; i < n_warps; ++i) total += smem[i];
  }
  __syncthreads();
  return total;
}

// A 16-byte load of data this kernel reads once: through the read-only
// path, without allocating in L1.
__device__ __forceinline__ float4 ld_once(const float4* p) {
  float4 v;
  asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p));
  return v;
}

// 16 bytes from device memory to shared memory without passing through
// registers (cp.async, L2 only). With `valid` false nothing is read and
// the 16 bytes are zero-filled; `src` must still be a device address.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes the same way (cp.async.ca: no 16-byte alignment needed).
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// Close the group of this thread's copies issued since the last commit.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `kPending` of this thread's committed groups are in
// flight; a __syncthreads() after it makes the landed data visible to all.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

}  // namespace repro_torch
