// Causal grouped-query attention forward with an optional sliding window,
// by the online ("flash") softmax, to f32 accuracy on the tensor cores:
//   o[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, c] / sqrt(D)) v[b, j, c],
//   c = (head0 + h) / group,
// over the keys j <= i (and i - j < window when window >= 0). head0 is 0
// for a whole model (h = kh * group); a rank of a model axis launches its
// own run of query heads, which may start head0 heads into its first KV
// head's group and end inside its last (repro_torch.models.parallel.
// HeadShare): one launch covers exactly the rank's heads, none padded.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py:91
// (body _kernel at :31, wrapper flash_attention), which
// repro.kernels.ops.flash_attention_bshd vmaps over the batch for every
// attention layer of a prefill when ModelConfig.flash_prefill is set
// (repro/models/transformer.py:81).
//
// Products: both Q K^T and P V run on the tensor cores through
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, in 3xTF32. Each f32
// operand x is split into hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi)
// and a product is formed as lo*hi + hi*lo + hi*hi into an f32 accumulator,
// the small terms first (CUTLASS's OpMultiplyAddFastF32, which PyTorch's
// f32 memory-efficient SDPA uses). That keeps about 22 bits of each operand:
// the result stays within f32 rounding of the plain version
// (repro_torch.kernels.ref.flash_attention). No product is ever a single
// TF32 pass, which keeps only 10 bits.
//
// Schedule. A warp owns 16 query rows (the mma's M) and D / DSPLIT of the
// D columns; a block of WM * DSPLIT warps owns BQ = 16 WM query rows of one
// (batch, head) and loops over the key tiles of BK rows that the query tile
// can see: tiles wholly in the future or wholly outside the window are not
// visited (the Pallas grid visits every (iq, ik) pair), so a 512-window
// layer at 32k costs O(S w), not O(S^2); a warp also skips a visited tile
// that none of its own rows sees. K and V tiles arrive through a ring of two
// shared-memory stages filled by 16-byte cp.async, so tile j + 1 is in
// flight while the mma work runs on tile j; rows past S are zero-filled.
// Q is read once, straight from device memory into the A fragments of the
// warp's rows, and stays in registers as f32. The score fragment, the
// running max m and denominator l and the O accumulator stay in registers;
// a row's max and sum are two xor shuffles inside the quad of lanes that
// holds it in the C layout. P feeds the P V product from the score
// registers directly: the eight keys of an mma k-step are taken in the order
// 0 2 4 6 1 3 5 7, so the C layout of Q K^T is already the A layout of P V,
// and the V fragments are read in that order. A key tile's P V is summed on
// the tensor cores from zero and added to O with f32 fmas (rounded to
// nearest), so no tensor-core sum runs longer than one tile.
//
// Registers set the tiles. With DSPLIT = 2 the two warps of a row group
// each form the scores over their half of D and add the two halves through
// shared memory, in slice order, so both hold bitwise equal scores and
// probabilities: D = 112 (zamba2-7b's head dim: 56 columns, 7 k-steps a
// warp), 128 and 256 are split, as one warp's O accumulator and Q
// fragments (D / 2 registers each) would spill. At D = 112 the key tile is
// 32 rows: at 128 registers a thread and 74 KB of shared memory two blocks
// share an SM, where 64-row tiles fit one (PERF.md section 6 times both:
// repro_torch.kernels.sweep --only flash, with ops.FLASH_TILES and the
// list below changed alike). At D = 256 the key tile is 16 rows: at 32
// the kernel needs one register more than the 255 a thread has and
// spills it (it then ran 10 % faster, 62.4 against 68.8 ms
// at gemma3-1b's global 32k layer on an H100 80GB HBM3 at 700 W,
// repro_torch.kernels.sweep; the table keeps to no spills). Rows padded to
// D + 4 floats put the fragments' reads on distinct banks. The tile table
// (BQ, BK, DSPLIT for each D) lives in the wrapper
// (repro_torch.kernels.ops.FLASH_TILES) and is passed in; only its entries
// are instantiated here.
//
// Masked scores are -inf while m starts at the finite -1e30 (the Pallas
// kernel's mask value), so m stays finite, a masked entry adds exactly 0
// (expf(-inf) = 0) and no row can form inf - inf. The ragged edge (S not a
// multiple of the tile) is masked here, not padded by the wrapper: rows past
// S are zero in the fragments and never written back. The largest query
// tiles (the most keys) are launched first. Element offsets are int64
// (B H S D passes 2^31 at the serving shapes); positions are int, as S is
// below 2^31. The scale 1/sqrt(D) multiplies
// each score in f32 as the Pallas spec operand carries it; expf (not
// __expf); one IEEE division by l at the end.
//
// Bound on the card: tensor-core operations. A causal pass does 4 D flops
// for each visible (query, key) pair and head (Q K^T and P V), and 3xTF32
// issues three TF32 products for each: at S = 32,768, 32 heads, D = 64,
// 3 * 4.40e12 TF32 flops, 26.7 ms at the 495 TFLOP/s of the dense TF32
// tensor cores; q, k, v read once and o written once are 0.5 GB there,
// 0.16 ms at 3.35 TB/s. (The same f32 flops on the CUDA cores, at
// 67 TFLOP/s, take 65.6 ms.) mma.sync does not reach the tensor cores'
// full rate on Hopper, the splits and the softmax run on the CUDA cores,
// and every warp reads its K and V fragments from shared memory: wgmma
// with operands in shared memory is the step after this one.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {

constexpr float kMaskedMax = -1e30f;  // the Pallas kernel's mask value

struct FlashArgs {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  int s;                     // sequence length (< 2^31: positions are int)
  int64_t q_sb, q_ss, q_sh;  // element strides of q and o: batch, position, head
  int64_t k_sb, k_ss, k_sh;  // element strides of k and v
  int group;                 // query heads per KV head
  int head0;                 // query head 0's place in KV head 0's group
  int window;                // < 0: global; at most s
  float scale;               // 1 / sqrt(D)
  int nq;                    // query tiles
};

// WM row groups of 16 query rows, DSPLIT warps a row group (each owning
// D / DSPLIT columns), key tiles of BK rows.
template <int D, int WM, int BK, int DSPLIT>
struct FlashTile {
  static constexpr int kWarps = WM * DSPLIT;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBQ = 16 * WM;
  static constexpr int kDW = D / DSPLIT;           // D columns a warp owns
  static constexpr int kRS = D + 4;                // K, V rows in shared memory
  static constexpr int kStages = 2;                // the K/V ring
  static constexpr int kStageFloats = 2 * BK * kRS;  // a K tile, then a V tile
  // partial scores of every warp, BK / 2 registers a lane, when D is split
  static constexpr int kXchFloats = DSPLIT > 1 ? kWarps * (BK / 2) * 32 : 0;
  static constexpr int kSmemBytes = 4 * (kStages * kStageFloats + kXchFloats);
  static_assert(BK % 8 == 0 && kDW % 8 == 0 && D % 4 == 0, "tile shape");
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to about 22 bits: hi is x rounded to TF32, lo the rest so rounded.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// c += a b for a 16x8 A fragment and an 8x8 B fragment, in TF32.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in 3xTF32 (a given split, b as two f32 values): lo hi, hi lo, hi hi.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4], float b0, float b1) {
  uint32_t h0, l0, h1, l1;
  split_tf32(b0, h0, l0);
  split_tf32(b1, h1, l1);
  mma_tf32(c, alo, h0, h1);
  mma_tf32(c, ahi, l0, l1);
  mma_tf32(c, ahi, h0, h1);
}

// Rows [r0, r0 + ROWS) of a (position, D) slab at row stride `stride` into
// shared memory at row stride D + 4; rows at or past s are zero-filled.
template <int D, int ROWS, int kThreads>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int64_t stride, int r0,
                                           int s) {
  constexpr int kQuads = D / 4;
#pragma unroll
  for (int e = threadIdx.x; e < ROWS * kQuads; e += kThreads) {
    const int r = e / kQuads, c = e % kQuads;
    const bool ok = r0 + r < s;
    cp_async16(dst + r * (D + 4) + 4 * c, src + (ok ? (r0 + r) * stride + 4 * c : 0), ok);
  }
}

template <int D, int WM, int BK, int DSPLIT>
__global__ void __launch_bounds__(FlashTile<D, WM, BK, DSPLIT>::kThreads)
    flash_attention_kernel(const FlashArgs a) {
  using T = FlashTile<D, WM, BK, DSPLIT>;
  constexpr int RS = T::kRS, NT = BK / 8, KQ = T::kDW / 8;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  float* xch = ring + T::kStages * T::kStageFloats;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;  // the mma fragments' row and column lanes
  const int wm = warp % WM, dc0 = (warp / WM) * T::kDW;
  const int iq = a.nq - 1 - (int)blockIdx.x;  // the longest rows first
  const int64_t h = blockIdx.y, b = blockIdx.z;
  const int q0 = iq * T::kBQ;
  const int wq0 = q0 + 16 * wm;                 // this warp's first row
  const int row[2] = {wq0 + g, wq0 + g + 8};  // the rows this lane holds
  const float* qg = a.q + b * a.q_sb + h * a.q_sh;
  // one offset for K and V (registers are at their limit at D = 256)
  const int64_t kv = b * a.k_sb + ((a.head0 + h) / a.group) * a.k_sh;

  // Key tiles this query tile can see: [k_first, q_last].
  const int q_last = (q0 + T::kBQ < a.s ? q0 + T::kBQ : a.s) - 1;
  const int k_first = a.window >= 0 && q0 - a.window + 1 > 0 ? q0 - a.window + 1 : 0;
  const int kt0 = k_first / BK, kt1 = q_last / BK;
  stage_rows<D, BK, T::kThreads>(ring, a.k + kv, a.k_ss, kt0 * BK, a.s);
  stage_rows<D, BK, T::kThreads>(ring + BK * RS, a.v + kv, a.k_ss, kt0 * BK, a.s);
  cp_async_commit();

  // Q's A fragments for k-step kk: (row g, col t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
  float qf[KQ][4];
#pragma unroll
  for (int kk = 0; kk < KQ; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row[i & 1];
      const int col = dc0 + 8 * kk + t + 4 * (i >> 1);
      qf[kk][i] = r < a.s ? qg[r * a.q_ss + col] : 0.f;
    }

  float o[KQ][4];
#pragma unroll
  for (int kk = 0; kk < KQ; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[kk][i] = 0.f;
  float m[2] = {kMaskedMax, kMaskedMax}, l[2] = {0.f, 0.f};

  for (int kt = kt0, stage = 0; kt <= kt1; ++kt, stage ^= 1) {
    cp_async_wait<0>();
    __syncthreads();  // tile kt has landed for all; tile kt - 1 is consumed
    if (kt < kt1) {
      float* next = ring + (stage ^ 1) * T::kStageFloats;
      stage_rows<D, BK, T::kThreads>(next, a.k + kv, a.k_ss, (kt + 1) * BK, a.s);
      stage_rows<D, BK, T::kThreads>(next + BK * RS, a.v + kv, a.k_ss, (kt + 1) * BK, a.s);
      cp_async_commit();
    }
    const float* ks = ring + stage * T::kStageFloats;
    const float* vs = ks + BK * RS;
    const int k0 = kt * BK;
    // Q's splits are loop-invariant: hoisted out of the key loop, they
    // would double Q's registers (a first build spilled so). Hide qf from
    // the hoist; the splits are redone each tile (12 operations a k-step,
    // against NT mma triples).
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(qf[kk][i]));
    // warp-uniform: does any row of this warp see a key of this tile?
    const bool sees = k0 <= wq0 + 15 && (a.window < 0 || wq0 - (k0 + BK - 1) < a.window);

    // S = Q K^T over this warp's D columns; C layout: (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)
    float sc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[nt][i] = 0.f;
    if (sees) {
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) {
        uint32_t ah[4], al[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(qf[kk][i], ah[i], al[i]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float* kr = ks + (8 * nt + g) * RS + dc0 + 8 * kk + t;
          mma_3xtf32(sc[nt], ah, al, kr[0], kr[4]);
        }
      }
    }
    if (DSPLIT > 1) {  // add the D slices' partial scores, in slice order
      if (sees) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) xch[(warp * NT * 4 + nt * 4 + i) * 32 + lane] = sc[nt][i];
      }
      __syncthreads();
      if (sees) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float sum = xch[((wm * NT + nt) * 4 + i) * 32 + lane];
#pragma unroll
            for (int j = 1; j < DSPLIT; ++j)
              sum += xch[(((j * WM + wm) * NT + nt) * 4 + i) * 32 + lane];
            sc[nt][i] = sum;
          }
      }
    }
    if (!sees) continue;

    // scale, mask, online softmax
    const bool edge = k0 + BK - 1 > wq0 || k0 + BK > a.s ||
                      (a.window >= 0 && wq0 + 15 - k0 >= a.window);
    float mx[2] = {kMaskedMax, kMaskedMax};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = sc[nt][i] * a.scale;
        if (edge) {
          const int qp = row[i >> 1], kp = k0 + 8 * nt + 2 * t + (i & 1);
          const bool seen = kp <= qp && kp < a.s && (a.window < 0 || qp - kp < a.window);
          if (!seen) x = -INFINITY;
        }
        sc[nt][i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);  // finite: m starts at -1e30
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = expf(sc[nt][i] - m[i >> 1]);  // masked: expf(-inf) = 0
        sc[nt][i] = p;
        rs[i >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];  // this lane's columns

    // O = alpha O + P V. k-step nt takes keys 8 nt + (0 2 4 6 1 3 5 7): A's
    // column t is key 2t and column t + 4 is key 2t + 1, i.e. this lane's
    // own scores. Each n-tile of O sums the tile's P V in fresh registers
    // and adds it with an f32 fma: the tensor cores' f32 accumulation does
    // not round to nearest, and chained over the whole key loop it drifted
    // past 1e-5 at 27k keys.
    uint32_t ph[NT][4], pl[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      split_tf32(sc[nt][0], ph[nt][0], pl[nt][0]);  // (g, 2t)
      split_tf32(sc[nt][2], ph[nt][1], pl[nt][1]);  // (g + 8, 2t)
      split_tf32(sc[nt][1], ph[nt][2], pl[nt][2]);  // (g, 2t + 1)
      split_tf32(sc[nt][3], ph[nt][3], pl[nt][3]);  // (g + 8, 2t + 1)
    }
    const float* vr = vs + 2 * t * RS + dc0 + g;
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      float pv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma_3xtf32(pv, ph[nt], pl[nt], vr[8 * nt * RS + 8 * kk], vr[(8 * nt + 1) * RS + 8 * kk]);
#pragma unroll
      for (int i = 0; i < 4; ++i) o[kk][i] = fmaf(o[kk][i], alpha[i >> 1], pv[i]);
    }
  }

  // o = acc / l, once; every written row has seen at least its own key
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  float* og = a.o + (int64_t)blockIdx.z * a.q_sb + (int64_t)blockIdx.y * a.q_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= a.s) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    float* orow = og + row[r] * a.q_ss + dc0 + 2 * t;
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk)
      *reinterpret_cast<float2*>(orow + 8 * kk) =
          make_float2(o[kk][2 * r] / denom, o[kk][2 * r + 1] / denom);
  }
}

// The instantiations: ops.FLASH_TILES, one (D, BQ, BK, DSPLIT) each.
#define REPRO_FLASH_TILES                                                \
  REPRO_FLASH_TILE(64, 64, 32, 1)                                        \
  REPRO_FLASH_TILE(112, 64, 32, 2)                                       \
  REPRO_FLASH_TILE(128, 64, 64, 2)                                       \
  REPRO_FLASH_TILE(256, 64, 16, 2)

template <int D, int WM, int BK, int DSPLIT>
static int launch(FlashArgs a, int64_t b, int64_t h, int64_t smem_bytes, cudaStream_t stream) {
  using T = FlashTile<D, WM, BK, DSPLIT>;
  if (smem_bytes != T::kSmemBytes) return (int)cudaErrorInvalidValue;
  auto kernel = flash_attention_kernel<D, WM, BK, DSPLIT>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  a.nq = (a.s + T::kBQ - 1) / T::kBQ;
  const dim3 grid((unsigned)a.nq, (unsigned)h, (unsigned)b);
  kernel<<<grid, T::kThreads, T::kSmemBytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

// q, o: (b, s, h, d) at element strides (q_sb, q_ss, q_sh) and unit stride
// over d; k, v: (b, s, kh, d) at (k_sb, k_ss, k_sh). f32, 16-byte aligned,
// every stride a multiple of 4. d in {64, 112, 128, 256}; query head i
// reads KV head (head0 + i) / group, and the h heads read exactly KV heads
// [0, kh) (0 <= head0 < group); window < 0 (global) or >= 1. (bq, bk,
// dsplit, smem_bytes) is the wrapper's tile for d
// (repro_torch.kernels.ops.FLASH_TILES); the grid is
// (ceil(s / bq), h, b). Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape or tile the kernel does not take.
extern "C" int flash_attention(const float* q, const float* k, const float* v, float* o,
                               int64_t b, int64_t s, int64_t h, int64_t kh,
                               int64_t group, int64_t head0, int64_t d,
                               int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
                               int64_t k_ss, int64_t k_sh, int64_t window, int64_t bq,
                               int64_t bk, int64_t dsplit, int64_t smem_bytes, void* stream) {
  using namespace repro_torch;
  if (b < 1 || s < 1 || kh < 1 || h < 1 || group < 1 || head0 < 0 || head0 >= group ||
      (head0 + h - 1) / group != kh - 1 || window == 0 || b > 65535 || h > 65535 ||
      group > 65535 || s > ((int64_t)1 << 31) - 512)  // positions and tile ends fit an int
    return (int)cudaErrorInvalidValue;
  FlashArgs a{q, k, v, o, (int)s, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, (int)group, (int)head0,
              (int)(window < s ? window : s), (float)(1.0 / sqrt((double)d)), 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_FLASH_TILE(D, BQ, BK, DSPLIT)                          \
  if (d == D && bq == BQ && bk == BK && dsplit == DSPLIT) \
    return launch<D, BQ / 16, BK, DSPLIT>(a, b, h, smem_bytes, st);
  REPRO_FLASH_TILES
#undef REPRO_FLASH_TILE
  return (int)cudaErrorInvalidValue;
}
