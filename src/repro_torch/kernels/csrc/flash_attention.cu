// Causal grouped-query attention forward with an optional sliding window,
// by the online ("flash") softmax, in f32:
//   o[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, h / group] / sqrt(D)) v[b, j, h / group]
// over the keys j <= i (and i - j < window when window >= 0).
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py:91
// (body _kernel at :31, wrapper flash_attention), which
// repro.kernels.ops.flash_attention_bshd vmaps over the batch for every
// attention layer of a prefill when ModelConfig.flash_prefill is set
// (repro/models/transformer.py:81).
//
// Design. One block of 128 threads takes one (batch, head, query tile of BQ
// rows) and loops over the key tiles of BK rows that the tile can see: tiles
// wholly in the future or wholly outside the window are never visited (the
// Pallas grid visits every (iq, ik) pair), so a 512-window layer at 32k costs
// O(S w), not O(S^2). The Q tile and each K, V tile are staged in shared
// memory (rows padded by 4 floats: 16-byte loads stay aligned and the rows
// fall on different banks). Thread (ty, tx) = (tid / 8, tid % 8) owns the
// query rows ty + 16 i and the key columns tx + 8 j of the score tile, and
// the 4-column groups tx + 8 c of the output rows; the eight threads of a
// row group sit in one warp, so the row max and row sum are three xor
// shuffles. The running max m, the running denominator l and the (BQ, D)
// accumulator stay in registers in f32; P goes through shared memory for the
// P V product. The division by l happens once, at the end.
//
// Masked scores are -inf while m starts at the finite -1e30 (the Pallas
// kernel's mask value), so m stays finite, a masked entry adds exactly 0
// (expf(-inf) = 0) and no row can form inf - inf. The ragged edge (S not a
// multiple of the tile) is masked here, not padded by the wrapper: rows past
// S are zero-filled in shared memory and never written back. The largest
// query tiles (the most keys) are launched first. Element offsets are int64:
// B H S D passes 2^31 at the serving shapes.
//
// Arithmetic: fmaf over D in order for each score, scale 1/sqrt(D) in f32 as
// the Pallas spec operand carries it, expf (not __expf), IEEE division at the
// end. No TF32 and no tensor cores: CUDA-core f32 FMAs keep the result within
// f32 rounding of the plain version (repro_torch.kernels.ref.flash_attention).
//
// Bound on the card: f32 operations. A causal pass does 4 D flops for each
// visible (query, key) pair and head (QK^T and P V), 4.40e12 at S = 32,768,
// 32 heads, D = 64: 65.6 ms at the 67 TFLOP/s of the CUDA cores; q, k, v read
// once and o written once are 0.5 GB there, 0.16 ms at 3.35 TB/s.
//
// What this simple design leaves on the table: the tensor cores (TF32 or
// bf16 wgmma would lift the bound 7-15x), cp.async/TMA double buffering of
// the K/V tiles (the loads are exposed; other blocks on the SM hide part of
// them), and a persistent schedule that balances the causal triangle.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace repro_torch {

constexpr int kFlashThreads = 128;
constexpr float kMaskedMax = -1e30f;  // the Pallas kernel's mask value

struct FlashArgs {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  int64_t s;                 // sequence length
  int64_t q_sb, q_ss, q_sh;  // element strides of q and o: batch, position, head
  int64_t k_sb, k_ss, k_sh;  // element strides of k and v
  int group;                 // query heads per KV head
  int64_t window;            // < 0: global
  float scale;               // 1 / sqrt(D)
  int nq;                    // query tiles
};

template <int D, int BQ, int BK>
struct FlashTile {
  static constexpr int kRowStride = D + 4;  // Q, K, V rows in shared memory
  static constexpr int kPStride = BK + 8;   // P rows
  static constexpr int kRows = BQ / 16;     // query rows a thread owns
  static constexpr int kCols = BK / 8;      // key columns a thread owns
  static constexpr int kGroups = D / 32;    // 4-column output groups a thread owns
  static constexpr int kSmemBytes =
      (int)sizeof(float) * (BQ * kRowStride + 2 * BK * kRowStride + BQ * kPStride);
  static_assert(BQ % 16 == 0 && BK % 8 == 0 && BK % 4 == 0 && D % 32 == 0, "tile shape");
};

// Rows [r0, r0 + rows) of a (position, D) slab with row stride `stride` into
// shared memory at row stride D + 4; rows at or past s are zero.
template <int D>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int64_t stride,
                                           int64_t r0, int rows, int64_t s) {
  constexpr int kQuads = D / 4;
  for (int e = threadIdx.x; e < rows * kQuads; e += kFlashThreads) {
    const int r = e / kQuads, c = e % kQuads;
    const int64_t pos = r0 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (pos < s) val = *reinterpret_cast<const float4*>(src + pos * stride + 4 * c);
    *reinterpret_cast<float4*>(dst + r * (D + 4) + 4 * c) = val;
  }
}

template <int D, int BQ, int BK>
__global__ void __launch_bounds__(kFlashThreads) flash_attention_kernel(const FlashArgs a) {
  using T = FlashTile<D, BQ, BK>;
  constexpr int RS = T::kRowStride, PS = T::kPStride;
  constexpr int RM = T::kRows, CN = T::kCols, CG = T::kGroups;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + BQ * RS;
  float* vs = ks + BK * RS;
  float* ps = vs + BK * RS;

  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int iq = a.nq - 1 - (int)blockIdx.x;  // the longest rows first
  const int64_t h = blockIdx.y, b = blockIdx.z;
  const int64_t kh = h / a.group;
  const int64_t q0 = (int64_t)iq * BQ;
  const float* qg = a.q + b * a.q_sb + h * a.q_sh;
  const float* kg = a.k + b * a.k_sb + kh * a.k_sh;
  const float* vg = a.v + b * a.k_sb + kh * a.k_sh;
  float* og = a.o + b * a.q_sb + h * a.q_sh;

  stage_rows<D>(qs, qg, a.q_ss, q0, BQ, a.s);

  float m[RM], l[RM];
  float4 acc[RM][CG];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kMaskedMax;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CG; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // Key tiles this query tile can see: [k_first, q_last].
  const int64_t q_last = (q0 + BQ < a.s ? q0 + BQ : a.s) - 1;
  int64_t k_first = 0;
  if (a.window >= 0 && q0 - a.window + 1 > 0) k_first = q0 - a.window + 1;
  const int64_t kt_end = q_last / BK;
  for (int64_t kt = k_first / BK; kt <= kt_end; ++kt) {
    const int64_t k0 = kt * BK;
    __syncthreads();  // the previous tile's K, V and P are consumed
    stage_rows<D>(ks, kg, a.k_ss, k0, BK, a.s);
    stage_rows<D>(vs, vg, a.k_ss, k0, BK, a.s);
    __syncthreads();

    // S = Q K^T for rows ty + 16 i, columns tx + 8 j
    float sc[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d4 = 0; d4 < D / 4; ++d4) {
      float4 qv[RM], kv[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * RS + 4 * d4);
#pragma unroll
      for (int j = 0; j < CN; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 8 * j) * RS + 4 * d4);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          float t = sc[i][j];
          t = fmaf(qv[i].x, kv[j].x, t);
          t = fmaf(qv[i].y, kv[j].y, t);
          t = fmaf(qv[i].z, kv[j].z, t);
          t = fmaf(qv[i].w, kv[j].w, t);
          sc[i][j] = t;
        }
    }

    // mask, online softmax, P to shared memory
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int64_t qp = q0 + ty + 16 * i;
      float mx = kMaskedMax;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int64_t kp = k0 + tx + 8 * j;
        const bool seen = kp <= qp && kp < a.s && (a.window < 0 || qp - kp < a.window);
        sc[i][j] = seen ? sc[i][j] * a.scale : -INFINITY;
        mx = fmaxf(mx, sc[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);  // finite: m starts at -1e30
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float p = expf(sc[i][j] - m_new);  // masked: expf(-inf) = 0
        ps[(ty + 16 * i) * PS + tx + 8 * j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CG; ++c) {
        acc[i][c].x *= alpha;
        acc[i][c].y *= alpha;
        acc[i][c].z *= alpha;
        acc[i][c].w *= alpha;
      }
    }
    __syncthreads();

    // O += P V for rows ty + 16 i, column groups tx + 8 c
#pragma unroll 2
    for (int k4 = 0; k4 < BK / 4; ++k4) {
      float4 pv[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        pv[i] = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * PS + 4 * k4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* vrow = vs + (4 * k4 + kk) * RS;
#pragma unroll
        for (int c = 0; c < CG; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(vrow + 4 * (tx + 8 * c));
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            const float p = kk == 0 ? pv[i].x : kk == 1 ? pv[i].y : kk == 2 ? pv[i].z : pv[i].w;
            acc[i][c].x = fmaf(p, vv.x, acc[i][c].x);
            acc[i][c].y = fmaf(p, vv.y, acc[i][c].y);
            acc[i][c].z = fmaf(p, vv.z, acc[i][c].z);
            acc[i][c].w = fmaf(p, vv.w, acc[i][c].w);
          }
        }
      }
    }
  }

  // o = acc / l, once; every written row has seen at least its own key
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int64_t qp = q0 + ty + 16 * i;
    if (qp >= a.s) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CG; ++c) {
      const float4 r = make_float4(acc[i][c].x / denom, acc[i][c].y / denom,
                                   acc[i][c].z / denom, acc[i][c].w / denom);
      *reinterpret_cast<float4*>(og + qp * a.q_ss + 4 * (tx + 8 * c)) = r;
    }
  }
}

template <int D, int BQ, int BK>
static int launch(FlashArgs a, int64_t b, int64_t h, cudaStream_t stream) {
  using T = FlashTile<D, BQ, BK>;
  auto kernel = flash_attention_kernel<D, BQ, BK>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  a.nq = (int)((a.s + BQ - 1) / BQ);
  const dim3 grid((unsigned)a.nq, (unsigned)h, (unsigned)b);
  kernel<<<grid, kFlashThreads, T::kSmemBytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

// q, o: (b, s, h, d) at element strides (q_sb, q_ss, q_sh) and unit stride
// over d; k, v: (b, s, kh, d) at (k_sb, k_ss, k_sh). f32, 16-byte aligned,
// every stride a multiple of 4. d in {64, 128, 256}, h = kh * group,
// window < 0 (global) or >= 1. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int flash_attention(const float* q, const float* k, const float* v, float* o,
                               int64_t b, int64_t s, int64_t h, int64_t kh, int64_t d,
                               int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
                               int64_t k_ss, int64_t k_sh, int64_t window, void* stream) {
  using namespace repro_torch;
  if (b < 1 || s < 1 || kh < 1 || h < 1 || h % kh != 0 || window == 0 || b > 65535 ||
      h > 65535 || s >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  FlashArgs a{q, k, v, o, s, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, (int)(h / kh), window,
              (float)(1.0 / sqrt((double)d)), 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return launch<64, 64, 64>(a, b, h, st);
    case 128: return launch<128, 64, 32>(a, b, h, st);
    case 256: return launch<256, 32, 32>(a, b, h, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
