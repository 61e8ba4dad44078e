// Per-row L1 norm of a packed (N, d_pad) f32 buffer's first d_s columns.
//
// Replaces the Pallas kernel repro/kernels/l1_clip.py::_norm_kernel
// (wrapper l1_norm), which repro.kernels.ops.l1_norm_packed vmaps over the
// nodes: the per-node ||eps||_1 of the Remark-1 recursion, once a round.
//
// Bound on the card: memory. It reads N * d_s * 4 bytes once and writes N
// floats; an H100 moves that at 3.35 TB/s. The design keeps enough loads in
// flight to cover the memory's latency, in one launch:
// * Grid (blocks_per_row, rows), from the wrapper's plan
//   (repro_torch.kernels.ops.l1_plan): block b of a row reads the
//   `quads_per_block` 16-byte quads from b * quads_per_block on (the last
//   block fewer), and the last block also reads the ragged tail (d_s % 4
//   columns) one float at a time. Pad columns past d_s are never read. The
//   plan gives 2048 quads a block, 8 a thread: small blocks that the card
//   hands out as SMs free up. A few persistent blocks an SM, each reading
//   one long range, were 1-15 % slower (repro_torch.kernels.sweep, variant
//   not kept). A grid holds at most 65,535 rows (gridDim.y): more rows take
//   one launch for each block of 65,535 rows, each told its first row, so
//   every row is reduced as it is in a single launch.
// * Each thread keeps kUnroll = 8 independent float4 loads in flight (quad
//   k of the thread into accumulator k % 8; 4 was no faster), with loads
//   that skip L1 (nothing reads the buffer again; about 1 % faster than
//   default loads); the 8 sums are added in index order at the end, then
//   over the block (common.cuh block_sum).
// * One partial per (row, block). The block of the row that draws the last
//   ticket of a per-row counter sums the row's partials (thread t adds
//   partials t, t + blockDim.x, ..., then block_sum) and puts the counter
//   back to zero. A second launch instead cost about 4 us
//   of host time a call at the paper shape and saved nothing at full width
//   (sweep, variant not kept). The wrapper keeps one set of counters for
//   each stream, so two streams never share one, and gives a launch
//   captured into a CUDA graph counters of its own
//   (repro_torch.kernels.ops._row_scratch). No float atomics: the same bits
//   every launch.
#include "common.cuh"

namespace repro_torch {

__device__ __forceinline__ float abs_sum(const float4 v) {
  return fabsf(v.x) + fabsf(v.y) + fabsf(v.z) + fabsf(v.w);
}

constexpr int kUnroll = 8;

// Row row0 + blockIdx.y, quads [blockIdx.x * qpb, min(+ qpb, n_quads)); the last
// block of the row adds columns [4 n_quads, d_s). The last block of the row
// to finish writes out[row] and puts its ticket back to zero.
__global__ void l1_norm_kernel(const float* __restrict__ buf, int64_t row0, int64_t d_pad,
                               int64_t d_s, int64_t qpb, float* __restrict__ partials,
                               unsigned* __restrict__ tickets, float* __restrict__ out) {
  __shared__ float smem[32];
  __shared__ bool last;
  const int64_t row = row0 + blockIdx.y;
  const float* x = buf + row * d_pad;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const int64_t n_quads = d_s / 4;
  const int64_t q0 = (int64_t)blockIdx.x * qpb;
  const int64_t q1 = q0 + qpb < n_quads ? q0 + qpb : n_quads;
  const int64_t step = blockDim.x;
  float acc[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) acc[u] = 0.f;
  int64_t q = q0 + threadIdx.x;
  for (; q + (kUnroll - 1) * step < q1; q += kUnroll * step) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = ld_once(x4 + q + u * step);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc[u] += abs_sum(v[u]);
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
    if (q + u * step < q1) acc[u] += abs_sum(ld_once(x4 + q + u * step));
  if (blockIdx.x == gridDim.x - 1)
    for (int64_t e = 4 * n_quads + threadIdx.x; e < d_s; e += step) acc[0] += fabsf(x[e]);
  float total = acc[0];
#pragma unroll
  for (int u = 1; u < kUnroll; ++u) total += acc[u];
  total = block_sum(total, smem);
  float* p = partials + row * gridDim.x;
  if (threadIdx.x == 0) {
    p[blockIdx.x] = total;
    __threadfence();  // the partial is visible before the ticket is drawn
    last = atomicAdd(tickets + row, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // every partial of the row has landed: sum them in a fixed order
  float a = 0.f;
  for (int64_t j = threadIdx.x; j < gridDim.x; j += blockDim.x) a += __ldcg(p + j);
  a = block_sum(a, smem);
  if (threadIdx.x == 0) {
    out[row] = a;
    tickets[row] = 0u;
  }
}

}  // namespace repro_torch

// buf (n, d_pad) f32, 16-byte aligned, d_pad % 4 == 0, 0 < d_s <= d_pad.
// (threads, blocks_per_row, quads_per_block) is the wrapper's plan
// (repro_torch.kernels.ops.l1_plan): blocks_per_row * quads_per_block
// covers the d_s / 4 whole quads of a row and no block is empty. partials
// (n, blocks_per_row) scratch; tickets n uint32 at zero (left at zero);
// out (n,). Returns cudaGetLastError(), or cudaErrorInvalidValue for a plan
// the kernel does not take.
extern "C" int l1_norm_rows(const float* buf, int64_t n, int64_t d_pad, int64_t d_s,
                            int64_t threads, int64_t blocks_per_row, int64_t quads_per_block,
                            float* partials, unsigned* tickets, float* out, void* stream) {
  using namespace repro_torch;
  const int64_t n_quads = d_s / 4;
  if (n < 1 || d_s < 1 || d_s > d_pad || d_pad % 4 != 0 ||
      (uintptr_t)buf % 16 != 0 || threads < 32 || threads > 1024 || threads % 32 != 0 ||
      blocks_per_row < 1 || blocks_per_row >= ((int64_t)1 << 31) || quads_per_block < 0 ||
      blocks_per_row * quads_per_block < n_quads ||
      (blocks_per_row - 1) * quads_per_block >= (n_quads > 0 ? n_quads : 1))
    return (int)cudaErrorInvalidValue;
  for (int64_t row0 = 0; row0 < n; row0 += kMaxGridRows) {
    const int64_t rows = n - row0 < kMaxGridRows ? n - row0 : kMaxGridRows;
    l1_norm_kernel<<<dim3((unsigned)blocks_per_row, (unsigned)rows), (unsigned)threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(buf, row0, d_pad, d_s, quads_per_block,
                                                          partials, tickets, out);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
