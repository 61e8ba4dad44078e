// Shared pieces of the kernels: the Laplace transform (dpps_perturb.cu,
// laplace_noise.cu), the two-pass row reduction (dpps_perturb.cu; l1_norm.cu
// takes block_sum and sums its partials in pass two's order in one pass)
// and the 16-byte asynchronous copies that fill the shared-memory rings of
// flash_attention.cu and spmm.cu.
//
// The row-reduction kernels reduce each row of a (N, d_pad) f32 buffer in
// two passes: pass one gives one partial per (row, chunk) block, pass two
// sums a row's partials in a fixed order. No atomics, so the result is deterministic.
// Element offsets are int64 throughout: at the full-width shape N * d_pad
// exceeds 2^31.
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
// Elements per pass-one block: the 64 x 128 tile of the Pallas kernels.
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

// 16 bytes from device memory to shared memory without passing through
// registers (cp.async, L2 only). With `valid` false nothing is read and
// the 16 bytes are zero-filled; `src` must still be a device address.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
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

// Pass two: out[row] = sum over partials[row, 0:n_chunks]; one block a row.
static __global__ void sum_partials_kernel(const float* __restrict__ partials,
                                           int64_t n_chunks,
                                           float* __restrict__ out) {
  __shared__ float smem[32];
  const float* p = partials + (int64_t)blockIdx.x * n_chunks;
  float acc = 0.f;
  for (int64_t j = threadIdx.x; j < n_chunks; j += blockDim.x) acc += p[j];
  const float total = block_sum(acc, smem);
  if (threadIdx.x == 0) out[blockIdx.x] = total;
}

}  // namespace repro_torch
