// Push-sum mixing: out = W @ x for W (M, N) f32 and x (N, D) f32 (Eq. 9):
// M = N for the whole network, M < N for a row block of W (the receivers a
// rank of the sharded engine holds, repro_torch.engine.shard, against the
// gathered senders).
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
// A row block's outputs are the same rows of the whole mix, bit for bit:
// an output's chain reads only its row of W and all N senders, whatever M
// is and whichever rows the block holds.
//
// N <= 32 (mix_kernel): memory-bound. It reads x and writes out once, 8
// bytes per element, and does 2N flops per element: about 2 flop/byte at
// N = 8, far below the card's ridge. So no tensor cores: W (at most 32 x 32
// floats, 4 KB) sits in shared memory, each thread owns one column, loads
// its N values of x into registers (coalesced across the warp) and writes N
// outputs. N is a template parameter (1..32) so the column stays in
// registers.
//
// N > 32 (mix_tile_kernel): at 2N flops for 8 bytes an element the mix
// turns bound by the f32 CUDA cores near N = 64 (67 TFLOP/s against 3.35
// TB/s), and a column no longer fits in registers. An SGEMM-shaped kernel
// without split-K (a split over the senders would break the one chain an
// output): a block owns a BM x BN tile of out and walks the senders in
// stages of BK, each stage's W[rows, stage] and x[stage, cols] copied to
// shared memory by cp.async into a ring of STAGES slots, so the copies of
// the next STAGES - 1 stages are in flight while one is multiplied, one
// barrier a stage. W is staged as it lies (rows of BK senders padded by 4
// floats, an odd number of 16-byte quads, so lanes on neighbouring rows
// hit other banks) and read as 16-byte quads: four senders of a row a
// load. Each thread owns TM rows (ty, ty + BM/TM, ...) x TN columns (in
// loads of up to 4 neighbouring columns, BN/(TN/4) apart) and so TM TN
// sums in registers, each sender costing it TM/4 + max(TN/4, 1) shared
// loads for TM TN fmas; in a stage of real senders the next sender's
// loads are issued before this one's fmas. Copies are 16 bytes where W's
// or x's rows are 16-byte aligned (N or D % 4 == 0 and an aligned base),
// else 4 bytes, so x needs no alignment and D may be anything; past N or
// D they fill zeros that no output keeps.
//
// The tiles (ops.MIX_TILES, chosen by ops.mix_plan from N, D and the
// card's SMs; this file instantiates exactly those and refuses others),
// each the fastest at its shapes of the 21 tiles and stagings timed
// (repro_torch.kernels.sweep, H100 80GB HBM3 at 700 W):
// * 128 x 128, 8 x 8 a thread: large D and N, where the f32 cores bound it;
// * 64 x 128: N <= 64 in one row tile, so x is read from device memory
//   once (bytes-bound at N = 33..64);
// * 32 x 64, 4 x 4 a thread, stages of 64 senders: enough blocks where D
//   is narrow against N (N = 4096, D = 128 gives 256 blocks, the 128 x 128
//   tile 32);
// * 16 x 8, one column a thread, for D <= 8, where W's bytes bound it (N =
//   4096, D = 8: 64 MB of W against 0.27 GFLOP): a column tile sized to D,
//   so no lane stages zeros, a thread for each output (with 4 columns a
//   thread the card held 2 warps an SM and ran 1.4x slower), and a deep
//   ring of long stages (BK = 128) streaming W's rows.
// A block for each tile, numbered row tile fastest where D >= N (the
// blocks that share a column tile of x run together and read it from L2),
// else column tile fastest (those that share a row tile of W). A block
// whose last rows pass N runs the fmas of its real rows only. Variants not
// kept: persistent blocks with the ring running on from tile to tile were
// 2-25 % slower at every shape (more registers, fewer blocks an SM); W
// staged transposed, 8 neighbouring rows a thread read one sender ahead,
// 13 % slower at N = 256 (145 registers, capped at 128 with a spill).
#include "common.cuh"

namespace repro_torch {

constexpr int kMixThreads = 256;
constexpr int kMaxNodes = 32;

template <int N>
__global__ void mix_kernel(const float* __restrict__ w, const float* __restrict__ x,
                           float* __restrict__ out, int m, int64_t d) {
  __shared__ float ws[N * N];
  for (int i = threadIdx.x; i < m * N; i += blockDim.x) ws[i] = w[i];
  __syncthreads();
  const int64_t col = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= d) return;
  float xv[N];
#pragma unroll
  for (int j = 0; j < N; ++j) xv[j] = x[(int64_t)j * d + col];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i >= m) break;  // the row block's M <= N receivers
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j) acc = fmaf(ws[i * N + j], xv[j], acc);
    out[(int64_t)i * d + col] = acc;
  }
}

template <int N>
static void launch(const float* w, const float* x, float* out, int64_t m, int64_t d,
                   cudaStream_t st) {
  const unsigned blocks = (unsigned)((d + kMixThreads - 1) / kMixThreads);
  mix_kernel<N><<<blocks, kMixThreads, 0, st>>>(w, x, out, (int)m, d);
}

// One tile shape of the N > 32 kernel: BM x BN outputs a block, TM x TN a
// thread, BK senders a stage, STAGES stages in the ring.
template <int BM, int BN, int TM, int TN, int BK, int STAGES>
struct MixTile {
  static_assert((TN == 1 || TN == 2 || TN % 4 == 0) && BN % TN == 0 && BM % TM == 0, "tile");
  static_assert(BK % 8 == 0, "a staged W row must hold an odd number of quads");
  static constexpr int kRowGroups = BM / TM;
  static constexpr int kColGroups = BN / TN;
  static constexpr int kThreads = kRowGroups * kColGroups;
  static constexpr int kVec = TN < 4 ? TN : 4;         // columns a shared load
  static constexpr int kVecs = TN / kVec;              // shared loads a sender
  static constexpr int kVecStride = BN / kVecs;        // columns between them
  static constexpr int kWStride = BK + 4;              // floats a staged W row
  static constexpr int kStageFloats = BM * kWStride + BK * BN;
  static constexpr int kSmemBytes = STAGES * kStageFloats * 4;
};

// V (1, 2 or 4) neighbouring floats from shared memory in one load.
template <int V>
__device__ __forceinline__ void lds_vec(const float* p, float* v) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = *p;
  }
}

// flags of a launch: 16-byte copies of W's rows, of x's rows, stores of
// out; tiles numbered column tile fastest
constexpr int kVecW = 1, kVecX = 2, kVecOut = 4, kColsFastest = 8;

// Copy stage [j0, j0 + BK) of W's rows [row0, row0 + BM) and x's columns
// [col0, col0 + BN) into one ring slot (zeros past M rows, N senders and D).
template <int BM, int BN, int TM, int TN, int BK, int STAGES>
__device__ __forceinline__ void mix_load(float* slot, const float* __restrict__ w,
                                         const float* __restrict__ x, int64_t m, int64_t n,
                                         int64_t d, int64_t row0, int64_t col0, int64_t j0,
                                         int flags) {
  using T = MixTile<BM, BN, TM, TN, BK, STAGES>;
  float* ws = slot;                       // ws[r][jj] = W[row0 + r, j0 + jj]
  float* xs = slot + BM * T::kWStride;    // xs[jj][c] = x[j0 + jj, col0 + c]
  // Each loop hands element e = threadIdx.x + it T of the stage to this thread.
  constexpr int kWQuads = BM * BK / 4, kXQuads = BK * BN / 4;
  if (flags & kVecW) {
#pragma unroll
    for (int it = 0; it < (kWQuads + T::kThreads - 1) / T::kThreads; ++it) {
      const int e = threadIdx.x + it * T::kThreads;
      if (kWQuads % T::kThreads != 0 && e >= kWQuads) break;
      const int r = e / (BK / 4), jj = 4 * (e % (BK / 4));
      const int64_t i = row0 + r, j = j0 + jj;  // N % 4 == 0: a quad is all in or all out
      const bool ok = i < m && j < n;
      cp_async16(ws + r * T::kWStride + jj, ok ? w + i * n + j : w, ok);
    }
  } else {
#pragma unroll 4
    for (int it = 0; it < (4 * kWQuads + T::kThreads - 1) / T::kThreads; ++it) {
      const int e = threadIdx.x + it * T::kThreads;
      if ((4 * kWQuads) % T::kThreads != 0 && e >= 4 * kWQuads) break;
      const int r = e / BK, jj = e % BK;
      const int64_t i = row0 + r, j = j0 + jj;
      const bool ok = i < m && j < n;
      cp_async4(ws + r * T::kWStride + jj, ok ? w + i * n + j : w, ok);
    }
  }
  if (flags & kVecX) {
#pragma unroll
    for (int it = 0; it < (kXQuads + T::kThreads - 1) / T::kThreads; ++it) {
      const int e = threadIdx.x + it * T::kThreads;
      if (kXQuads % T::kThreads != 0 && e >= kXQuads) break;
      const int jj = e / (BN / 4), c = 4 * (e % (BN / 4));
      const int64_t j = j0 + jj, col = col0 + c;  // D % 4 == 0
      const bool ok = j < n && col < d;
      cp_async16(xs + jj * BN + c, ok ? x + j * d + col : x, ok);
    }
  } else {
#pragma unroll 4
    for (int it = 0; it < (4 * kXQuads + T::kThreads - 1) / T::kThreads; ++it) {
      const int e = threadIdx.x + it * T::kThreads;
      if ((4 * kXQuads) % T::kThreads != 0 && e >= 4 * kXQuads) break;
      const int jj = e / BN, c = e % BN;
      const int64_t j = j0 + jj, col = col0 + c;
      const bool ok = j < n && col < d;
      cp_async4(xs + jj * BN + c, ok ? x + j * d + col : x, ok);
    }
  }
}

// The fmas of one staged slot over its first `jn` senders (all BK where
// kFull), in sender order; only the thread's first `live` rows (all TM
// where !kRowGuard) take them.
template <int BM, int BN, int TM, int TN, int BK, int STAGES, bool kFull, bool kRowGuard>
__device__ __forceinline__ void mix_multiply(const float* slot, int ty, int tx, int jn,
                                             int live, float (&acc)[TM][TN]) {
  using T = MixTile<BM, BN, TM, TN, BK, STAGES>;
  const float* ws = slot + ty * T::kWStride;
  const float* xs = slot + BM * T::kWStride + T::kVec * tx;
#pragma unroll
  for (int jj = 0; jj < BK; jj += 4) {
    if (!kFull && jj >= jn) break;
    float4 wq[TM];
#pragma unroll
    for (int k = 0; k < TM; ++k)
      wq[k] = *reinterpret_cast<const float4*>(ws + k * T::kRowGroups * T::kWStride + jj);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (!kFull && jj + q >= jn) break;
      float xv[TN];
#pragma unroll
      for (int m = 0; m < T::kVecs; ++m)
        lds_vec<T::kVec>(xs + (jj + q) * BN + m * T::kVecStride, xv + m * T::kVec);
#pragma unroll
      for (int k = 0; k < TM; ++k) {
        if (kRowGuard && k >= live) break;
        const float wk = q == 0 ? wq[k].x : q == 1 ? wq[k].y : q == 2 ? wq[k].z : wq[k].w;
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[k][c] = fmaf(wk, xv[c], acc[k][c]);
      }
    }
  }
}

// mix_multiply for a whole stage of real senders and rows, software
// pipelined: the next sender's x values (and, where registers allow, the
// next four senders' W values) are loaded before this sender's fmas, so
// the shared loads' latency hides behind them. The same chains in the same
// order as mix_multiply.
template <int BM, int BN, int TM, int TN, int BK, int STAGES>
__device__ __forceinline__ void mix_multiply_full(const float* slot, int ty, int tx,
                                                  float (&acc)[TM][TN]) {
  using T = MixTile<BM, BN, TM, TN, BK, STAGES>;
  constexpr bool kPrefetchW = TM * TN <= 32;  // 8 TM more registers
  const float* ws = slot + ty * T::kWStride;
  const float* xs = slot + BM * T::kWStride + T::kVec * tx;
  auto load_w = [&](float4 (&q)[TM], int jj) {
#pragma unroll
    for (int k = 0; k < TM; ++k)
      q[k] = *reinterpret_cast<const float4*>(ws + k * T::kRowGroups * T::kWStride + jj);
  };
  auto load_x = [&](float (&v)[TN], int jj) {
#pragma unroll
    for (int m = 0; m < T::kVecs; ++m)
      lds_vec<T::kVec>(xs + jj * BN + m * T::kVecStride, v + m * T::kVec);
  };
  float4 wq[TM], wn[TM];
  float xv[2][TN];
  load_w(wq, 0);
  load_x(xv[0], 0);
#pragma unroll
  for (int jj = 0; jj < BK; ++jj) {
    const int q = jj % 4;
    if (jj + 1 < BK) load_x(xv[(jj + 1) % 2], jj + 1);
    if (kPrefetchW && q == 2 && jj + 2 < BK) load_w(wn, jj + 2);
#pragma unroll
    for (int k = 0; k < TM; ++k) {
      const float wk = q == 0 ? wq[k].x : q == 1 ? wq[k].y : q == 2 ? wq[k].z : wq[k].w;
#pragma unroll
      for (int c = 0; c < TN; ++c) acc[k][c] = fmaf(wk, xv[jj % 2][c], acc[k][c]);
    }
    if (q == 3 && jj + 1 < BK) {
      if (kPrefetchW) {
#pragma unroll
        for (int k = 0; k < TM; ++k) wq[k] = wn[k];
      } else {
        load_w(wq, jj + 1);
      }
    }
  }
}

// The rows and columns of output tile t: tiles are numbered along the
// operand the most blocks share (kColsFastest: column tile fastest, so the
// blocks that read one row tile of W run together; else row tile fastest,
// for x), so that operand is read from L2.
struct MixGrid {
  int64_t row_tiles, col_tiles;
  int flags;
  template <int BM, int BN>
  __device__ __forceinline__ void origin(int64_t t, int64_t& row0, int64_t& col0) const;
};

template <int BM, int BN>
__device__ __forceinline__ void MixGrid::origin(int64_t t, int64_t& row0, int64_t& col0) const {
  if (flags & kColsFastest) {
    row0 = t / col_tiles * BM;
    col0 = t % col_tiles * BN;
  } else {
    row0 = t % row_tiles * BM;
    col0 = t / row_tiles * BN;
  }
}

// The block's whole sender walk over its tile: the ring filled STAGES - 1
// stages ahead, one barrier a stage, each stage multiplied in sender order.
template <int BM, int BN, int TM, int TN, int BK, int STAGES, bool kRowGuard>
__device__ __forceinline__ void mix_walk(float* smem, const float* __restrict__ w,
                                         const float* __restrict__ x, int64_t m, int64_t n,
                                         int64_t d,
                                         int64_t row0, int64_t col0, int flags, int ty,
                                         int tx, int live, float (&acc)[TM][TN]) {
  using T = MixTile<BM, BN, TM, TN, BK, STAGES>;
  const int64_t steps = (n + BK - 1) / BK;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < steps)
      mix_load<BM, BN, TM, TN, BK, STAGES>(smem + st * T::kStageFloats, w, x, m, n, d, row0,
                                           col0, (int64_t)st * BK, flags);
    cp_async_commit();
  }
  int slot = 0;
  for (int64_t k = 0; k < steps; ++k) {
    cp_async_wait<STAGES - 2>();  // stage k has landed for this thread ...
    __syncthreads();              // ... and for all; all are done with stage k - 1
    if (k + STAGES - 1 < steps)   // into stage k - 1's slot
      mix_load<BM, BN, TM, TN, BK, STAGES>(smem + (slot == 0 ? STAGES - 1 : slot - 1) *
                                                      T::kStageFloats,
                                           w, x, m, n, d, row0, col0, (k + STAGES - 1) * BK,
                                           flags);
    cp_async_commit();
    const float* stage = smem + slot * T::kStageFloats;
    const int64_t j0 = k * BK;
    if (j0 + BK > n)  // the last, short stage: only its real senders join the chains
      mix_multiply<BM, BN, TM, TN, BK, STAGES, false, kRowGuard>(stage, ty, tx, (int)(n - j0),
                                                                 live, acc);
    else if (kRowGuard)
      mix_multiply<BM, BN, TM, TN, BK, STAGES, true, true>(stage, ty, tx, BK, live, acc);
    else
      mix_multiply_full<BM, BN, TM, TN, BK, STAGES>(stage, ty, tx, acc);
    slot = slot == STAGES - 1 ? 0 : slot + 1;
  }
}

// Block b owns output tile b (MixGrid::origin).
template <int BM, int BN, int TM, int TN, int BK, int STAGES>
__global__ void __launch_bounds__((MixTile<BM, BN, TM, TN, BK, STAGES>::kThreads))
    mix_tile_kernel(const float* __restrict__ w, const float* __restrict__ x,
                    float* __restrict__ out, int64_t m, int64_t n, int64_t d, MixGrid grid) {
  using T = MixTile<BM, BN, TM, TN, BK, STAGES>;
  extern __shared__ __align__(16) float smem[];
  const int tx = threadIdx.x % T::kColGroups, ty = threadIdx.x / T::kColGroups;
  int64_t row0, col0;
  grid.origin<BM, BN>(blockIdx.x, row0, col0);
  float acc[TM][TN];
#pragma unroll
  for (int k = 0; k < TM; ++k)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[k][c] = 0.f;
  if (row0 + BM <= m) {
    mix_walk<BM, BN, TM, TN, BK, STAGES, false>(smem, w, x, m, n, d, row0, col0, grid.flags, ty,
                                                tx, TM, acc);
  } else {  // rows ty + k BM/TM < M: the first `live` of the thread's rows
    const int64_t real = m - row0 - ty;
    const int live = real <= 0 ? 0 : (int)((real + T::kRowGroups - 1) / T::kRowGroups);
    mix_walk<BM, BN, TM, TN, BK, STAGES, true>(smem, w, x, m, n, d, row0, col0, grid.flags, ty,
                                               tx, live, acc);
  }
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int64_t i = row0 + ty + r * T::kRowGroups;
    if (i >= m) continue;
#pragma unroll
    for (int m = 0; m < T::kVecs; ++m) {
      const int64_t col = col0 + m * T::kVecStride + T::kVec * tx;
      const float* a = acc[r] + m * T::kVec;
      float* o = out + i * d + col;
      if (T::kVec == 4 && (grid.flags & kVecOut) && col < d) {  // the quad is all in
        *reinterpret_cast<float4*>(o) = make_float4(a[0], a[1], a[2], a[3]);
      } else {
#pragma unroll
        for (int c = 0; c < T::kVec; ++c)
          if (col + c < d) o[c] = a[c];
      }
    }
  }
}

template <int BM, int BN, int TM, int TN, int BK, int STAGES>
static int launch_tile(const float* w, const float* x, float* out, int64_t m, int64_t n,
                       int64_t d, int64_t smem_bytes, cudaStream_t st) {
  using T = MixTile<BM, BN, TM, TN, BK, STAGES>;
  if (smem_bytes != T::kSmemBytes) return (int)cudaErrorInvalidValue;
  MixGrid grid{(m + BM - 1) / BM, (d + BN - 1) / BN, 0};
  const int64_t tiles = grid.row_tiles * grid.col_tiles;
  if (tiles >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  grid.flags = ((uintptr_t)w % 16 == 0 && n % 4 == 0 ? kVecW : 0) |
               ((uintptr_t)x % 16 == 0 && d % 4 == 0 ? kVecX : 0) |
               ((uintptr_t)out % 16 == 0 && d % 4 == 0 ? kVecOut : 0) |
               (d < n ? kColsFastest : 0);  // W (N x N) outweighs x (N x D)
  auto kernel = mix_tile_kernel<BM, BN, TM, TN, BK, STAGES>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)tiles, T::kThreads, T::kSmemBytes, st>>>(w, x, out, m, n, d, grid);
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

// The tiles of ops.MIX_TILES: (BM, BN, TM, TN, BK, STAGES).
#define REPRO_MIX_TILES(X) \
  X(128, 128, 8, 8, 16, 3)   \
  X(64, 128, 4, 8, 16, 4)    \
  X(32, 64, 4, 4, 64, 3)     \
  X(16, 8, 1, 1, 128, 4)

#define REPRO_MIX_CASE(K) \
  case K:                 \
    launch<K>(w, x, out, m, d, st); \
    break;

// w (m, n) f32 (a row block of W: 1 <= m <= n; m = n the whole W), x (n, d)
// and out (m, d) f32, n >= 1, d >= 1. n <= 32 takes
// mix_kernel<n> (the tile arguments all 0); n > 32 takes the
// mix_tile_kernel instantiation of tile (bm, bn, tm, tn, bk, stages) with
// its dynamic shared memory smem_bytes (the wrapper's plan). Returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments the kernels
// do not take.
extern "C" int pushsum_mix(const float* w, const float* x, float* out, int64_t m, int64_t n,
                           int64_t d, int64_t bm, int64_t bn, int64_t tm, int64_t tn,
                           int64_t bk, int64_t stages, int64_t smem_bytes, void* stream) {
  using namespace repro_torch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d < 1 || m < 1 || m > n) return (int)cudaErrorInvalidValue;
  if (n > kMaxNodes) {
#define REPRO_MIX_TILE_CASE(BM, BN, TM, TN, BK, STAGES)                                  \
  if (bm == BM && bn == BN && tm == TM && tn == TN && bk == BK && stages == STAGES)      \
    return launch_tile<BM, BN, TM, TN, BK, STAGES>(w, x, out, m, n, d, smem_bytes, st);
    REPRO_MIX_TILES(REPRO_MIX_TILE_CASE)
#undef REPRO_MIX_TILE_CASE
    return (int)cudaErrorInvalidValue;
  }
  if (bm != 0 || bn != 0 || tm != 0 || tn != 0 || bk != 0 || stages != 0 || smem_bytes != 0)
    return (int)cudaErrorInvalidValue;
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
