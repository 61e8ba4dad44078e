// Per-row L1 norm of a packed (N, d_pad) f32 buffer's first d_s columns.
//
// Replaces the Pallas kernel repro/kernels/l1_clip.py::_norm_kernel
// (wrapper l1_norm), which repro.kernels.ops.l1_norm_packed vmaps over the
// nodes: the per-node ||eps||_1 of the Remark-1 recursion, once a round.
//
// Bound on the card: memory. It reads N * d_s * 4 bytes once and writes N
// floats; an H100 moves that at 3.35 TB/s. The design streams each row in
// 8192-element chunks with 16-byte loads (one block per (chunk, row)),
// keeps the sum in registers, and writes one partial per block; a second
// small kernel sums each row's partials in a fixed order. Deterministic,
// no atomics. The ragged tail (d_s not a multiple of 4) is read scalar.
#include "common.cuh"

namespace repro_torch {

static __global__ void l1_partials_kernel(const float* __restrict__ buf,
                                          int64_t d_pad, int64_t d_s,
                                          float* __restrict__ partials,
                                          int64_t n_chunks) {
  __shared__ float smem[32];
  const int64_t row = blockIdx.y;
  const float* x = buf + row * d_pad;
  const int64_t c0 = (int64_t)blockIdx.x * kChunk;
  const int64_t c1 = c0 + kChunk < d_s ? c0 + kChunk : d_s;
  const int64_t q_end = (c0 + ((c1 - c0) & ~(int64_t)3)) / 4;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float acc = 0.f;
  for (int64_t q = c0 / 4 + threadIdx.x; q < q_end; q += blockDim.x) {
    const float4 v = x4[q];
    acc += fabsf(v.x) + fabsf(v.y) + fabsf(v.z) + fabsf(v.w);
  }
  for (int64_t e = q_end * 4 + threadIdx.x; e < c1; e += blockDim.x) acc += fabsf(x[e]);
  const float total = block_sum(acc, smem);
  if (threadIdx.x == 0) partials[row * n_chunks + blockIdx.x] = total;
}

}  // namespace repro_torch

// buf (n, d_pad) f32, 16-byte aligned, d_pad % 4 == 0; partials (n, n_chunks)
// scratch with n_chunks = ceil(d_s / 8192); out (n,). Returns cudaGetLastError().
extern "C" int l1_norm_rows(const float* buf, int64_t n, int64_t d_pad, int64_t d_s,
                            float* partials, int64_t n_chunks, float* out,
                            void* stream) {
  using namespace repro_torch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  l1_partials_kernel<<<dim3((unsigned)n_chunks, (unsigned)n), kThreads, 0, st>>>(
      buf, d_pad, d_s, partials, n_chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials_kernel<<<(unsigned)n, kThreads, 0, st>>>(partials, n_chunks, out);
  return (int)cudaGetLastError();
}
