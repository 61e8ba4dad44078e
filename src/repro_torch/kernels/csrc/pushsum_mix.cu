// Push-sum mixing: out = W @ x for W (N, N) f32 and x (N, D) f32 (Eq. 9).
//
// Replaces the Pallas kernel repro/kernels/pushsum_mix.py::_kernel
// (wrapper pushsum_mix), reached through repro.core.pushsum.gossip_packed
// (dense schedule) once a round. The Pallas kernel takes any N (one (N, N)
// block against (N, 512) column tiles); so do the two kernels here.
//
// Every output is one f32 fma chain over the senders in increasing j,
// starting from 0: acc = fmaf(W[i, j], x[j, c], acc). Both kernels keep that
// order, so they give the same bits where both apply, and spmm.cu, which
// runs the same chain over a topology's CSR slots in ascending sender order
// (an fma with a zero weight leaves the sum as it is), gives the dense
// kernel's bits on that topology.
//
// N <= 32 (mix_kernel): memory-bound. It reads x and writes out once, 8
// bytes per element, and does 2N flops per element: about 2 flop/byte at
// N = 8, far below the card's ridge. So no tensor cores: W (at most 32 x 32
// floats, 4 KB) sits in shared memory, each thread owns one column, loads
// its N values of x into registers (coalesced across the warp) and writes N
// outputs. N is a template parameter (1..32) so the column stays in
// registers.
//
// N > 32 (mix_wide_kernel): at 2N flops for 8 bytes an element the mix
// turns bound by the f32 CUDA cores near N = 64 (67 TFLOP/s against 3.35
// TB/s), and a column no longer fits in registers. A block of 256 threads
// owns a tile of 8 TM output rows x 128 columns (TM = 8, or 2 where the
// card would otherwise hold too few blocks: the wrapper's plan,
// repro_torch.kernels.ops.mix_plan). It walks the senders in steps of 16,
// staging W[rows, step] (transposed, rows padded by 4 floats against bank
// conflicts) and x[step, cols] in shared memory, two buffers deep with the
// next step's loads in flight during this step's fmas. Each thread keeps
// TM x 4 sums in registers (rows ty TM .. + TM, columns tx + 32 c), reading
// TM broadcast W values and 4 x values a sender for 4 TM fmas. Loads and
// stores of x and out are scalar and coalesced, so x needs no alignment and
// D may be anything. Blocks are numbered row tile fastest, so the blocks
// that share a column tile of x run together and read it from L2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr int kMixThreads = 256;
constexpr int kMaxNodes = 32;
constexpr int kWideCols = 128;  // columns of a wide block tile: 32 lanes x 4
constexpr int kWideDepth = 16;  // senders staged in shared memory a step

template <int N>
__global__ void mix_kernel(const float* __restrict__ w, const float* __restrict__ x,
                           float* __restrict__ out, int64_t d) {
  __shared__ float ws[N * N];
  for (int i = threadIdx.x; i < N * N; i += blockDim.x) ws[i] = w[i];
  __syncthreads();
  const int64_t col = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= d) return;
  float xv[N];
#pragma unroll
  for (int j = 0; j < N; ++j) xv[j] = x[(int64_t)j * d + col];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j) acc = fmaf(ws[i * N + j], xv[j], acc);
    out[(int64_t)i * d + col] = acc;
  }
}

template <int N>
static void launch(const float* w, const float* x, float* out, int64_t d, cudaStream_t st) {
  const unsigned blocks = (unsigned)((d + kMixThreads - 1) / kMixThreads);
  mix_kernel<N><<<blocks, kMixThreads, 0, st>>>(w, x, out, d);
}

// One sender jj of the staged step: TM x 4 fmas from TM broadcast W values
// (16- or 8-byte shared loads: with 4 scalar x loads a sender, the shared
// memory pipe keeps pace with the fmas) and 4 x values.
template <int TM, int BM>
__device__ __forceinline__ void mix_wide_step(float (*ws)[BM + 4], float (*xs)[kWideCols],
                                              int jj, int ty, int tx, float (&acc)[TM][4]) {
  static_assert(TM % 2 == 0, "W rows are read in pairs or quads");
  float wv[TM], xv[4];
  const float* wrow = &ws[jj][ty * TM];  // 8 TM-byte aligned
  if constexpr (TM % 4 == 0) {
#pragma unroll
    for (int r = 0; r < TM; r += 4) {
      const float4 q = *reinterpret_cast<const float4*>(wrow + r);
      wv[r] = q.x;
      wv[r + 1] = q.y;
      wv[r + 2] = q.z;
      wv[r + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < TM; r += 2) {
      const float2 q = *reinterpret_cast<const float2*>(wrow + r);
      wv[r] = q.x;
      wv[r + 1] = q.y;
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) xv[c] = xs[jj][tx + 32 * c];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(wv[r], xv[c], acc[r][c]);
}

// Block b: row tile b % row_tiles (8 TM rows), column tile b / row_tiles
// (128 columns). The staged senders are double-buffered: a step's compute
// runs on one buffer while the next step's W and x values are already
// loaded into registers, then stored into the other buffer; one barrier a
// step.
template <int TM>
__global__ void __launch_bounds__(kMixThreads)
    mix_wide_kernel(const float* __restrict__ w, const float* __restrict__ x,
                    float* __restrict__ out, int64_t n, int64_t d, int64_t row_tiles) {
  constexpr int BM = 8 * TM;
  constexpr int kWLoads = BM * kWideDepth / kMixThreads;         // W values a thread stages
  constexpr int kXLoads = kWideDepth * kWideCols / kMixThreads;  // x values a thread stages
  // ws[b][jj][r] = W[row0 + r, j0 + jj], xs[b][jj][c] = x[j0 + jj, col0 + c]
  __shared__ __align__(16) float ws[2][kWideDepth][BM + 4];
  __shared__ __align__(16) float xs[2][kWideDepth][kWideCols];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int64_t row0 = ((int64_t)blockIdx.x % row_tiles) * BM;
  const int64_t col0 = ((int64_t)blockIdx.x / row_tiles) * kWideCols;
  const int64_t cols = d - col0 < kWideCols ? d - col0 : kWideCols;  // real columns
  float wr[kWLoads], xr[kXLoads];
  // the W and x values of the step at sender j0 into registers (0 past N)
  auto fetch = [&](int64_t j0) {
#pragma unroll
    for (int k = 0; k < kWLoads; ++k) {
      const int e = threadIdx.x + k * kMixThreads;
      const int64_t i = row0 + e / kWideDepth, j = j0 + e % kWideDepth;  // 16 senders of a row
      wr[k] = (i < n && j < n) ? w[i * n + j] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kXLoads; ++k) {
      const int e = threadIdx.x + k * kMixThreads;
      const int64_t j = j0 + e / kWideCols;
      const int c = e % kWideCols;
      xr[k] = (j < n && c < cols) ? x[j * d + col0 + c] : 0.f;
    }
  };
  auto stash = [&](int b) {
#pragma unroll
    for (int k = 0; k < kWLoads; ++k) {
      const int e = threadIdx.x + k * kMixThreads;
      ws[b][e % kWideDepth][e / kWideDepth] = wr[k];
    }
#pragma unroll
    for (int k = 0; k < kXLoads; ++k) {
      const int e = threadIdx.x + k * kMixThreads;
      xs[b][e / kWideCols][e % kWideCols] = xr[k];
    }
  };
  float acc[TM][4];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  fetch(0);
  stash(0);
  __syncthreads();
  int b = 0;
  for (int64_t j0 = 0; j0 < n; j0 += kWideDepth) {
    const int jn = n - j0 < kWideDepth ? (int)(n - j0) : kWideDepth;
    const bool more = j0 + kWideDepth < n;
    if (more) fetch(j0 + kWideDepth);  // in flight during this step's fmas
#pragma unroll
    for (int jj = 0; jj < kWideDepth; ++jj)  // only the real senders join the chain
      if (jj < jn) mix_wide_step<TM, BM>(ws[b], xs[b], jj, ty, tx, acc);
    if (more) stash(b ^ 1);  // every thread left buffer b ^ 1 at the last barrier
    __syncthreads();
    b ^= 1;
  }
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int64_t i = row0 + ty * TM + r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int64_t col = col0 + tx + 32 * c;
      if (i < n && col < d) out[i * d + col] = acc[r][c];
    }
  }
}

template <int TM>
static int launch_wide(const float* w, const float* x, float* out, int64_t n, int64_t d,
                       cudaStream_t st) {
  const int64_t row_tiles = (n + 8 * TM - 1) / (8 * TM);
  const int64_t blocks = row_tiles * ((d + kWideCols - 1) / kWideCols);
  if (blocks >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  mix_wide_kernel<TM><<<(unsigned)blocks, kMixThreads, 0, st>>>(w, x, out, n, d, row_tiles);
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

#define REPRO_MIX_CASE(K) \
  case K:                 \
    launch<K>(w, x, out, d, st); \
    break;

// w (n, n) f32, x and out (n, d) f32, n >= 1, d >= 1. n <= 32 takes
// mix_kernel<n>; n > 32 takes mix_wide_kernel<rows_per_thread>, with
// rows_per_thread 8 or 2 (the wrapper's plan). Returns cudaGetLastError(),
// or cudaErrorInvalidValue for arguments the kernels do not take.
extern "C" int pushsum_mix(const float* w, const float* x, float* out, int64_t n, int64_t d,
                           int64_t rows_per_thread, void* stream) {
  using namespace repro_torch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d < 1) return (int)cudaErrorInvalidValue;
  if (n > kMaxNodes) {
    if (rows_per_thread == 8) return launch_wide<8>(w, x, out, n, d, st);
    if (rows_per_thread == 2) return launch_wide<2>(w, x, out, n, d, st);
    return (int)cudaErrorInvalidValue;
  }
  switch (n) {
    REPRO_MIX_CASE(1) REPRO_MIX_CASE(2) REPRO_MIX_CASE(3) REPRO_MIX_CASE(4)
    REPRO_MIX_CASE(5) REPRO_MIX_CASE(6) REPRO_MIX_CASE(7) REPRO_MIX_CASE(8)
    REPRO_MIX_CASE(9) REPRO_MIX_CASE(10) REPRO_MIX_CASE(11) REPRO_MIX_CASE(12)
    REPRO_MIX_CASE(13) REPRO_MIX_CASE(14) REPRO_MIX_CASE(15) REPRO_MIX_CASE(16)
    REPRO_MIX_CASE(17) REPRO_MIX_CASE(18) REPRO_MIX_CASE(19) REPRO_MIX_CASE(20)
    REPRO_MIX_CASE(21) REPRO_MIX_CASE(22) REPRO_MIX_CASE(23) REPRO_MIX_CASE(24)
    REPRO_MIX_CASE(25) REPRO_MIX_CASE(26) REPRO_MIX_CASE(27) REPRO_MIX_CASE(28)
    REPRO_MIX_CASE(29) REPRO_MIX_CASE(30) REPRO_MIX_CASE(31) REPRO_MIX_CASE(32)
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
