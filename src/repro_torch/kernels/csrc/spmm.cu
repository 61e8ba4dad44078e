// Sparse push-sum mixing over a padded receiver-major CSR edge list:
//   out[i, c] = sum_k vals[i, k] * x[idx[i, k], c]       (Eq. 9, sparse W)
// for idx (N, K) int32, vals (N, K) f32, x and out (N, D) f32.
//
// Replaces the Pallas kernel repro/kernels/spmm.py::_kernel (wrapper spmm),
// reached through repro.core.pushsum.gossip_sparse and the sparse branch of
// gossip_packed (through repro.kernels.ops.pushsum_mix_sparse) once a round
// on the sparse schedule.
//
// The TPU design expands the K slots into a dense (N, N) W in VMEM and runs
// an MXU product per D tile: O(N^2) work per tile, pointless here. Reading
// each sender row from device memory once per edge is no better: at
// N = 24, K = 14 (252 edges) that moves 10.5x the buffer. Instead one block
// takes a column tile [c0, c0 + tile) of every row:
//  1. it stages x[:, c0:c0+tile] for all N rows in shared memory (16-byte
//     loads), so x is read from device memory exactly once;
//  2. each thread owns four neighbouring columns of one receiver row and
//     forms acc = fmaf(vals[i, k], xs[idx[i, k]][c], acc) over the slots in
//     storage order, starting from 0, then writes out with one 16-byte
//     store. idx and vals are read through the read-only cache; all threads
//     of a row read the same slot, so the loads broadcast.
// The tile is the largest power of two <= 512 (at least 4) with
// N * tile * 4 bytes <= 48 KB, so several blocks share an SM; above 48 KB
// (N > 3072) the block opts into more shared memory, up to the card's
// 227 KB, which caps N at 14,528. Past that the launch is refused.
//
// Bound on the card: memory. It reads x and writes out once (8 bytes an
// element) plus the edge list; 2 flops per edge and column, about 2 * K / 8
// flop/byte, far below the card's ridge.
//
// Bit-exact with pushsum_mix.cu: on a topology's own CSR the slots hold the
// senders in ascending order and the zero-weight pads add exactly 0 to the
// fma chain, so the sum is the dense kernel's fma-in-j-order sum, bit for
// bit. Element offsets are int64: N * D exceeds 2^31 at full width.
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr int kSpmmThreads = 256;
constexpr int kSpmmMaxTile = 512;
constexpr int kSpmmSmemTarget = 48 * 1024;
constexpr int kSpmmSmemMax = 232448;  // 227 KB, the opt-in limit on sm_90

__global__ void spmm_kernel(const int32_t* __restrict__ idx, const float* __restrict__ vals,
                            const float* __restrict__ x, float* __restrict__ out, int n, int k,
                            int64_t d, int quads_shift) {
  extern __shared__ float4 xs[];  // (n, tile / 4) quads
  const int quads = 1 << quads_shift;
  const int64_t c0 = (int64_t)blockIdx.x << (quads_shift + 2);
  const int64_t rem = d - c0;
  // quads of this tile that lie inside the row (d % 4 == 0)
  const int width = rem >= ((int64_t)quads << 2) ? quads : (int)(rem >> 2);
  const int total = n << quads_shift;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int j = e >> quads_shift, q = e & (quads - 1);
    if (q < width)
      xs[e] = *reinterpret_cast<const float4*>(x + (int64_t)j * d + c0 + 4 * q);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int i = e >> quads_shift, q = e & (quads - 1);
    if (q >= width) continue;
    const int32_t* ir = idx + (int64_t)i * k;
    const float* vr = vals + (int64_t)i * k;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int s = 0; s < k; ++s) {
      const float v = __ldg(vr + s);
      const float4 xv = xs[(__ldg(ir + s) << quads_shift) + q];
      acc.x = fmaf(v, xv.x, acc.x);
      acc.y = fmaf(v, xv.y, acc.y);
      acc.z = fmaf(v, xv.z, acc.z);
      acc.w = fmaf(v, xv.w, acc.w);
    }
    *reinterpret_cast<float4*>(out + (int64_t)i * d + c0 + 4 * q) = acc;
  }
}

// Columns per block for n rows, or 0 if no tile fits in shared memory.
static int64_t spmm_tile(int64_t n) {
  int64_t tile = kSpmmMaxTile;
  while (tile > 4 && n * tile * 4 > kSpmmSmemTarget) tile >>= 1;
  return n * tile * 4 <= kSpmmSmemMax ? tile : 0;
}

}  // namespace repro_torch

// idx (n, k) int32 with entries in [0, n), vals (n, k) f32, x and out (n, d)
// f32, 16-byte aligned, d % 4 == 0. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int spmm(const int32_t* idx, const float* vals, const float* x, float* out,
                    int64_t n, int64_t k, int64_t d, void* stream) {
  using namespace repro_torch;
  const int64_t tile = spmm_tile(n);
  if (tile == 0 || n < 1 || k < 1 || d < 4 || d % 4 != 0) return (int)cudaErrorInvalidValue;
  int quads_shift = 0;
  while ((4 << quads_shift) < tile) ++quads_shift;
  const int smem = (int)(n * tile * 4);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(spmm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t blocks = (d + tile - 1) / tile;
  spmm_kernel<<<(unsigned)blocks, kSpmmThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      idx, vals, x, out, (int)n, (int)k, d, quads_shift);
  return (int)cudaGetLastError();
}
