// Sparse push-sum mixing over a padded receiver-major CSR edge list:
//   out[i, c] = sum_k vals[i, k] * x[idx[i, k], c]       (Eq. 9, sparse W)
// for idx (M, K) int32, vals (M, K) f32, x (N, D) f32 and out (M, D) f32:
// M = N for the whole network, M < N for a row block of receivers (a rank
// of the sharded engine, repro_torch.engine.shard, mixing its own rows from
// the gathered senders). A receiver's sum reads only its own slots, so a
// row block's outputs are the same rows of the whole mix, bit for bit.
//
// Replaces the Pallas kernel repro/kernels/spmm.py::_kernel (wrapper spmm),
// reached through repro.core.pushsum.gossip_sparse and the sparse branch of
// gossip_packed (through repro.kernels.ops.pushsum_mix_sparse) once a round
// on the sparse schedule.
//
// The TPU design expands the K slots into a dense (N, N) W in VMEM and runs
// an MXU product per D tile: O(N^2) work per tile, pointless here. Two
// regimes instead, chosen by the wrapper (repro_torch.kernels.ops.spmm_plan)
// from (N, K, D) and the card's SM count and passed in as (tile, stages,
// threads, blocks, smem_bytes):
//
// * Column tiles (tile > 0), for rows wide against N: persistent blocks,
//   a few to an SM, each walking over the column tiles blockIdx.x,
//   blockIdx.x + gridDim.x, ... of width `tile`. A ring of kSpmmStages
//   shared-memory slots, each holding x[:, c0:c0+tile] for all N rows, is
//   filled by 16-byte cp.async two tiles ahead, so the loads of tiles t + 1
//   and t + 2 are in flight while tile t is reduced and stored: x is read
//   from device memory exactly once. A slot holds all N senders, whatever
//   M is. Each thread owns four neighbouring
//   columns of one receiver row at a time, forms the sum from the slot's
//   rows and writes it with one 16-byte store. The slot table (each slot's
//   sender as a quad offset into a ring slot, and its weight) is copied to
//   shared memory once per block and read four slots a load, broadcast to
//   the warp, whose lanes share the row.
//   What bounds it: besides HBM, the L1 / shared-memory pipe. A quad of
//   output reads K quads of the slot from shared memory (K x 16 bytes for
//   16 written), 14 at the sparse full width: about as many pipe cycles
//   as the HBM bytes need. Reading idx and vals from device memory at each
//   slot (through L1) added half as much again: 8.2-8.7 ms there against
//   6.5-6.8 with the table (H100 80GB HBM3 at 700 W,
//   repro_torch.kernels.sweep).
// * Rows (tile = 0), for D narrow against N (e.g. N = 4096, D = 8, where
//   the column tiling gave the card 2 blocks), or N or K too large for a
//   ring slot or the slot table: one thread a (receiver row, 4 columns), reading x[idx[i, k]]
//   straight from device memory through the read-only path (a narrow x
//   stays in L2). The grid grows with N D / 4, not with D.
//
// In both, acc = fmaf(vals[i, k], x[idx[i, k]][c], acc) over the slots in
// storage order, starting from 0.
//
// Bound on the card: memory. It reads x and writes out once (8 bytes an
// element) plus the edge list; 2 flops per edge and column, about 2 * K / 8
// flop/byte, far below the card's ridge.
//
// Bit-exact with pushsum_mix.cu: on a topology's own CSR the slots hold the
// senders in ascending order and the zero-weight pads add exactly 0 to the
// fma chain, so the sum is the dense kernel's fma-in-j-order sum, bit for
// bit, in either regime. Element offsets are int64: N * D exceeds 2^31 at
// full width.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {

constexpr int kSpmmStages = 3;         // ring slots (ops.SPMM_STAGES)
constexpr int kSpmmSmemMax = 232448;   // 227 KB, the opt-in limit on sm_90

__device__ __forceinline__ void fma4(float4& acc, float v, const float4 x) {
  acc.x = fmaf(v, x.x, acc.x);
  acc.y = fmaf(v, x.y, acc.y);
  acc.z = fmaf(v, x.z, acc.z);
  acc.w = fmaf(v, x.w, acc.w);
}

// Column tile `tile_no` (of 4 << quads_shift columns) of all n rows into
// ring slot `xs`; quads past d are not loaded. Always closes a group, so
// the count of groups in flight is the same in every thread and iteration.
__device__ __forceinline__ void stage_tile(float4* xs, const float* __restrict__ x, int n,
                                           int64_t d, int quads_shift, int64_t tile_no,
                                           bool any) {
  if (any) {
    const int quads = 1 << quads_shift;
    const int64_t c0 = tile_no << (quads_shift + 2);
    const int64_t rem = (d - c0) >> 2;
    const int width = rem >= quads ? quads : (int)rem;
    for (int e = threadIdx.x; e < (n << quads_shift); e += blockDim.x) {
      const int j = e >> quads_shift, q = e & (quads - 1);
      if (q < width) cp_async16(xs + e, x + (int64_t)j * d + c0 + 4 * q, true);
    }
  }
  cp_async_commit();
}

// Shared memory: the ring, then the slot table (m receiver rows of kp = k
// rounded up to 4 slots: the sender's quad offset in a ring slot, then the
// weights).
__global__ void spmm_tiles_kernel(const int32_t* __restrict__ idx,
                                  const float* __restrict__ vals, const float* __restrict__ x,
                                  float* __restrict__ out, int m, int n, int k, int64_t d,
                                  int quads_shift, int64_t n_tiles) {
  extern __shared__ float4 ring[];  // kSpmmStages slots of (n, tile / 4) quads
  const int quads = 1 << quads_shift;
  const int slot = n << quads_shift;
  const int outs = m << quads_shift;  // the receivers' quads of a tile
  const int kp = (k + 3) & ~3;
  int* offs = reinterpret_cast<int*>(ring + kSpmmStages * slot);
  float* wts = reinterpret_cast<float*>(offs + m * kp);
  const int64_t first = blockIdx.x, step = gridDim.x;
  const int64_t count = first < n_tiles ? (n_tiles - 1 - first) / step + 1 : 0;
#pragma unroll
  for (int s = 0; s < kSpmmStages - 1; ++s)
    stage_tile(ring + s * slot, x, n, d, quads_shift, first + s * step, s < count);
  for (int e = threadIdx.x; e < m * kp; e += blockDim.x) {  // read at the first barrier
    const int i = e / kp, s = e - i * kp;
    offs[e] = s < k ? __ldg(idx + (int64_t)i * k + s) << quads_shift : 0;
    wts[e] = s < k ? __ldg(vals + (int64_t)i * k + s) : 0.f;
  }
  for (int64_t it = 0; it < count; ++it) {
    cp_async_wait<kSpmmStages - 2>();
    __syncthreads();  // tile `it` has landed for all; tile it - 1's slot is free
    const int64_t ahead = it + kSpmmStages - 1;
    stage_tile(ring + (ahead % kSpmmStages) * slot, x, n, d, quads_shift, first + ahead * step,
               ahead < count);
    const float4* xs = ring + (it % kSpmmStages) * slot;
    const int64_t c0 = (first + it * step) << (quads_shift + 2);
    const int64_t rem = (d - c0) >> 2;
    const int width = rem >= quads ? quads : (int)rem;
    for (int e = threadIdx.x; e < outs; e += blockDim.x) {
      const int i = e >> quads_shift, q = e & (quads - 1);
      if (q >= width) continue;
      // four slots a shared-memory load (the warp's lanes share row i: broadcast)
      const int4* o4 = reinterpret_cast<const int4*>(offs + i * kp);
      const float4* w4 = reinterpret_cast<const float4*>(wts + i * kp);
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int s4 = 0; s4 < kp / 4; ++s4) {
        const int4 o = o4[s4];
        const float4 w = w4[s4];
        const int left = k - 4 * s4;
        fma4(acc, w.x, xs[o.x + q]);
        if (left > 1) fma4(acc, w.y, xs[o.y + q]);
        if (left > 2) fma4(acc, w.z, xs[o.z + q]);
        if (left > 3) fma4(acc, w.w, xs[o.w + q]);
      }
      *reinterpret_cast<float4*>(out + (int64_t)i * d + c0 + 4 * q) = acc;
    }
  }
}

__global__ void spmm_rows_kernel(const int32_t* __restrict__ idx,
                                 const float* __restrict__ vals, const float* __restrict__ x,
                                 float* __restrict__ out, int m, int k, int64_t d) {
  const int64_t row_quads = d >> 2;
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= m * row_quads) return;
  const int64_t i = e / row_quads, q = e - i * row_quads;
  const int32_t* ir = idx + i * k;
  const float* vr = vals + i * k;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int s = 0; s < k; ++s)
    fma4(acc, __ldg(vr + s),
         __ldg(reinterpret_cast<const float4*>(x + (int64_t)__ldg(ir + s) * d) + q));
  *reinterpret_cast<float4*>(out + i * d + 4 * q) = acc;
}

}  // namespace repro_torch

// idx (m, k) int32 with entries in [0, n), vals (m, k) f32, x (n, d) and out
// (m, d) f32, 16-byte aligned, d % 4 == 0, 1 <= m <= n. (tile, stages,
// threads, blocks, smem_bytes) is the wrapper's plan (repro_torch.kernels.ops.spmm_plan):
// tile 0 runs the row regime, tile a power of two in [4, 512] the
// column-tile ring of `stages` slots on `blocks` persistent blocks. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape or plan the kernel does not take.
extern "C" int spmm(const int32_t* idx, const float* vals, const float* x, float* out,
                    int64_t m, int64_t n, int64_t k, int64_t d, int64_t tile, int64_t stages,
                    int64_t threads, int64_t blocks, int64_t smem_bytes, void* stream) {
  using namespace repro_torch;
  if (n < 1 || n >= ((int64_t)1 << 31) || m < 1 || m > n || k < 1 || d < 4 || d % 4 != 0 ||
      threads < 32 || threads > 1024 || threads % 32 != 0 || blocks < 1 ||
      blocks >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile == 0) {
    if (blocks * threads < m * (d / 4)) return (int)cudaErrorInvalidValue;
    spmm_rows_kernel<<<(unsigned)blocks, (unsigned)threads, 0, st>>>(idx, vals, x, out, (int)m,
                                                                    (int)k, d);
    return (int)cudaGetLastError();
  }
  int quads_shift = 0;
  while ((4 << quads_shift) < tile) ++quads_shift;
  const int64_t smem = 4 * (kSpmmStages * n * tile + 2 * m * ((k + 3) & ~3));
  if (stages != kSpmmStages || (4 << quads_shift) != tile || tile > 512 ||
      smem != smem_bytes || smem > kSpmmSmemMax)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        spmm_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t n_tiles = (d + tile - 1) / tile;
  spmm_tiles_kernel<<<(unsigned)blocks, (unsigned)threads, (size_t)smem, st>>>(
      idx, vals, x, out, (int)m, (int)n, (int)k, d, quads_shift, n_tiles);
  return (int)cudaGetLastError();
}
