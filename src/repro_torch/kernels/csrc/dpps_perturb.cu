// Fused DPPS round point-op over the packed (N, d_pad) rows:
//   noise    = Laplace(bits; scale)                 (Eq. 8, inverse CDF)
//   s_noise  = s + eps + gamma_n * noise            (Eq. 7 + Eq. 8)
//   eps_l1   = sum |eps|,  noise_l1 = sum |noise|   per row
// on the first d_s columns; the pad columns of s_noise are written as 0.
//
// Replaces the Pallas kernel repro/kernels/dpps_perturb.py::_kernel
// (wrapper dpps_perturb) with repro/kernels/laplace_noise.py::
// _laplace_transform inlined, as repro.kernels.ops.dpps_perturb_packed
// vmaps it over the nodes once a round. noise_l1 feeds the next round's
// sensitivity recursion.
//
// Two variants:
//  * bits-in: uint32 bits (N, d_s) from the caller (conformance tests);
//  * Philox: Philox4x32-10 computed in the kernel, key = the 64-bit seed,
//    counter = (element quad lo, quad hi, node, round t); element e is word
//    e % 4 of quad e / 4. The main path uses it: round t's noise is a pure
//    function of (seed, t, node, e). The node word is the global node
//    node0 + row: a rank of the sharded engine (repro_torch.engine.shard)
//    holding nodes [node0, node0 + n) draws exactly the rows the whole
//    network's launch draws for them. repro_torch.kernels.ref.philox_bits
//    computes the same bits on any device. The rows may be one leaf of the
//    wire row, whose first column is col0 there: element j of the leaf is
//    then wire column e = col0 + j, so a launch per leaf draws exactly the
//    bits a launch over the packed row draws for those columns. Where
//    col0 % 4 != 0 a leaf quad straddles two Philox counters; that
//    instantiation evaluates both and picks the words (twice the Philox
//    work, the simple way; col0 % 4 == 0, and so the packed row, takes
//    the one-counter instantiation). A rank of the model axis holds a
//    block of a leaf (repro_torch.models.parallel): element j of its rows
//    is wire column col0 + (j / run) * stride + j % run (run the rank's
//    elements of the split dim and its trailing dims, stride the whole
//    leaf's; col0 with the block's offset folded in), so a rank draws the
//    whole leaf's bits at its columns. That instantiation takes one
//    32-bit divide a quad and one Philox counter where the quad's four
//    columns are one counter's (every quad where the run, the stride and
//    col0 are multiples of 4: every run of the attention and MLP blocks
//    at published widths); else, the simple way, a counter for each of
//    its elements (a quad across counters or across a run's end).
// The noise scale S / b is read through a device pointer, so the round
// needs no host sync.
//
// Bound on the card: memory. It reads s and eps (8 bytes an element) and
// writes s_noise (4 bytes); the bits-in variant reads 4 more. Philox-10 is
// about 25 integer operations an element and the transform about 17 float
// ones with a logf: under half the time of the bytes at the card's rates,
// so they hide behind the loads as long as enough loads are in flight.
// The design, one launch a call, from the wrapper's plan
// (repro_torch.kernels.ops.perturb_plan):
// * Long rows: grid (blocks_per_row, rows); block b of a row writes quads
//   [b q, min((b + 1) q, d_pad / 4)) for q = quads_per_block, each thread
//   its quads t, t + T, ... of that range. Short rows: rows_per_block rows
//   a block, T / rows_per_block threads (at most a warp) a row, which
//   write the whole row.
// * A thread issues the loads of kUnroll = 2 quads of s and of eps before
//   the Philox and logf of the first, through the read-only path without
//   L1 allocation (nothing reads them again), and writes s_noise with
//   streaming stores. Quads wholly in the pad are written as zeros and
//   never read. The Philox and the transform need many warps to hide
//   their latency behind the loads: 8 quads in flight a thread took 132
//   registers, one block of 256 an SM, and ran 1.7x slower at full width;
//   4 were 13 % slower than 2, and 1 3 % (repro_torch.kernels.sweep, H100
//   80GB HBM3 at 700 W; variants not kept).
// * The norms: each thread adds |eps| and |noise| of its elements in its
//   quads' order into one sum each. Short rows reduce them over the row's
//   lanes by shuffles (fixed tree). Long rows take block_sum (common.cuh);
//   with one block a row that is the row's norm; with more, each block
//   stores its two partials and the block that draws the last ticket of a
//   per-row counter sums the row's partials (thread t adds partials t, t +
//   T, ..., then block_sum) and puts the counter back to zero, as
//   l1_norm.cu does. The wrapper keeps the counters per (device, stream)
//   and gives a launch under CUDA-graph capture its own
//   (repro_torch.kernels.ops._row_scratch). No float atomics: the same
//   bits every launch.
// * More than 65,535 long rows take a launch for each block of 65,535 rows
//   (gridDim.y), told its first row; short rows run in a one-dimensional
//   grid. The Philox counter holds the row and the quad itself, so no plan
//   and no split changes a bit of s_noise. The card's logf may differ from
//   the CPU's log by an ulp, so the noise agrees with a CPU run to about
//   1e-7 relative, not bit for bit.
#include "common.cuh"

namespace repro_torch {

__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c[0]), lo0 = 0xD2511F53u * c[0];
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c[2]), lo1 = 0xCD9E8D57u * c[2];
    const uint32_t n0 = hi1 ^ c[1] ^ k0, n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
}

struct PerturbArgs {
  const float* s;
  const float* eps;
  const uint32_t* bits;  // (n, d_s), or null for Philox
  const float* scale;    // one f32 on the card
  float* out;
  float* eps_l1;
  float* noise_l1;
  float* partials;   // (n, 2 blocks_per_row) where blocks_per_row > 1
  unsigned* tickets; // n counters at zero where blocks_per_row > 1
  int64_t n, d_pad, d_s, row0, quads_per_block, rows_per_block;
  int64_t col0;  // the rows' first column in the wire row (Philox only)
  int64_t run, stride;  // the column map of a leaf's block (kPhiloxMapped)
  int64_t node0; // the global node of row 0 (Philox only)
  float gamma_n;
  uint32_t seed_lo, seed_hi, t;
};

// The four instantiations: bits from the caller; Philox where col0 % 4 ==
// 0 (one counter a quad); Philox where a quad straddles two counters;
// Philox at a block's mapped columns.
constexpr int kBitsIn = 0, kPhilox = 1, kPhiloxStraddle = 2, kPhiloxMapped = 3;

// The four Philox words of counter c of `row` into w.
__device__ __forceinline__ void philox_counter(const PerturbArgs& a, int64_t row, int64_t c,
                                               uint32_t w[4]) {
  w[0] = (uint32_t)(c & 0xffffffffu);
  w[1] = (uint32_t)(c >> 32);
  w[2] = (uint32_t)(a.node0 + row);
  w[3] = a.t;
  philox4x32_10(w, a.seed_lo, a.seed_hi);
}

// The four Philox words of quad q of `row`: wire columns col0 + 4q + k.
template <int kMode>
__device__ __forceinline__ void philox_words(const PerturbArgs& a, int64_t row, int64_t q,
                                             uint32_t w[4]) {
  if (kMode == kPhiloxMapped) {
    // elements 4q .. 4q + 3 lie in run r from element m of it (a 32-bit
    // divide: d_pad < 2^31 in this mode); run >= 4, so the quad reaches
    // at most into run r + 1
    const uint32_t j0 = 4u * (uint32_t)q, run = (uint32_t)a.run;
    const uint32_t r = j0 / run, m = j0 - r * run;
    const int64_t e0 = a.col0 + (int64_t)r * a.stride + m;  // element 0's column
    if ((e0 & 3) == 0 && run - m >= 4) {  // one counter: every quad of an aligned map
      philox_counter(a, row, e0 >> 2, w);
      return;
    }
    // element k's own counter and word (a quad across counters or runs)
    const int64_t e1 = e0 + a.stride - a.run;  // element k >= run - m: e1 + k
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int64_t e = k < (int)(run - m) ? e0 + k : e1 + k;
      uint32_t v[4];
      philox_counter(a, row, e >> 2, v);
      const int x = (int)(e & 3);
      w[k] = x == 0 ? v[0] : x == 1 ? v[1] : x == 2 ? v[2] : v[3];
    }
    return;
  }
  const int64_t c = a.col0 / 4 + q;  // the counter of wire column col0 + 4q
  philox_counter(a, row, c, w);
  if (kMode == kPhiloxStraddle) {
    const int r = (int)(a.col0 & 3);  // 1, 2 or 3
    uint32_t v[4];
    philox_counter(a, row, c + 1, v);
    // element k is word r + k of counter c, or word r + k - 4 of c + 1;
    // selects keep both sets in registers
    uint32_t o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = r + k;
      o[k] = j == 1 ? w[1] : j == 2 ? w[2] : j == 3 ? w[3] : j == 4 ? v[0] : j == 5 ? v[1] : v[2];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = o[k];
  }
}

// Quad q of `row`: s_noise's four values into `o`, |eps| and |noise| of the
// real elements added to the sums in element order.
template <int kMode>
__device__ __forceinline__ float4 perturb_quad(const PerturbArgs& a, int64_t row, int64_t q,
                                               float4 sv, float4 ev, float scale,
                                               float& eps_acc, float& noise_acc) {
  const int64_t e0 = 4 * q;
  const float sa[4] = {sv.x, sv.y, sv.z, sv.w};
  const float ea[4] = {ev.x, ev.y, ev.z, ev.w};
  uint32_t w[4];
  if (kMode == kBitsIn) {
    const uint32_t* b = a.bits + row * a.d_s;
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = e0 + k < a.d_s ? b[e0 + k] : 0u;
  } else {
    philox_words<kMode>(a, row, q, w);
  }
  float o[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (e0 + k < a.d_s) {
      const float noise = laplace_from_bits(w[k], scale);
      // (s + eps) + gamma_n * noise, each step rounded as the plain
      // version rounds it (no fused multiply-add).
      o[k] = __fadd_rn(__fadd_rn(sa[k], ea[k]), __fmul_rn(a.gamma_n, noise));
      eps_acc += fabsf(ea[k]);
      noise_acc += fabsf(noise);
    } else {
      o[k] = 0.f;
    }
  }
  return make_float4(o[0], o[1], o[2], o[3]);
}

constexpr int kUnroll = 2;  // quads of s and eps in flight a thread

// Quads [qa, qb) of `row`, this thread's being qa + lane, + step, ...,
// kUnroll of them loaded before the first is computed.
template <int kMode>
__device__ __forceinline__ void perturb_range(const PerturbArgs& a, int64_t row, int64_t qa,
                                              int64_t qb, int lane, int step, float scale,
                                              float& eps_acc, float& noise_acc) {
  const int64_t real = (a.d_s + 3) / 4;  // quads holding a column < d_s
  const float4* s4 = reinterpret_cast<const float4*>(a.s + row * a.d_pad);
  const float4* e4 = reinterpret_cast<const float4*>(a.eps + row * a.d_pad);
  float4* o4 = reinterpret_cast<float4*>(a.out + row * a.d_pad);
  for (int64_t q = qa + lane; q < qb; q += (int64_t)kUnroll * step) {
    float4 sv[kUnroll], ev[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t qq = q + (int64_t)u * step;
      if (qq < qb && qq < real) {
        sv[u] = ld_once(s4 + qq);
        ev[u] = ld_once(e4 + qq);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t qq = q + (int64_t)u * step;
      if (qq >= qb) break;
      __stcs(o4 + qq, qq < real ? perturb_quad<kMode>(a, row, qq, sv[u], ev[u], scale,
                                                        eps_acc, noise_acc)
                                : make_float4(0.f, 0.f, 0.f, 0.f));
    }
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, 3) perturb_kernel(const PerturbArgs a) {
  __shared__ float smem[32];
  __shared__ bool last;
  const float scale = __ldg(a.scale);
  float eps_acc = 0.f, noise_acc = 0.f;
  if (a.rows_per_block > 1) {  // short rows: T / rows_per_block lanes a row
    const int lanes = blockDim.x / (int)a.rows_per_block;
    const int64_t row = (int64_t)blockIdx.x * a.rows_per_block + threadIdx.x / lanes;
    const int lane = threadIdx.x % lanes;
    if (row < a.n)
      perturb_range<kMode>(a, row, 0, a.d_pad / 4, lane, lanes, scale, eps_acc, noise_acc);
    for (int off = lanes / 2; off > 0; off >>= 1) {  // every lane of the warp takes part
      eps_acc += __shfl_down_sync(0xffffffffu, eps_acc, off, lanes);
      noise_acc += __shfl_down_sync(0xffffffffu, noise_acc, off, lanes);
    }
    if (lane == 0 && row < a.n) {
      a.eps_l1[row] = eps_acc;
      a.noise_l1[row] = noise_acc;
    }
    return;
  }
  const int64_t row = a.row0 + blockIdx.y;
  const int64_t qa = (int64_t)blockIdx.x * a.quads_per_block;
  const int64_t qb = qa + a.quads_per_block < a.d_pad / 4 ? qa + a.quads_per_block : a.d_pad / 4;
  perturb_range<kMode>(a, row, qa, qb, threadIdx.x, blockDim.x, scale, eps_acc, noise_acc);
  eps_acc = block_sum(eps_acc, smem);
  noise_acc = block_sum(noise_acc, smem);
  if (gridDim.x == 1) {
    if (threadIdx.x == 0) {
      a.eps_l1[row] = eps_acc;
      a.noise_l1[row] = noise_acc;
    }
    return;
  }
  float* p = a.partials + row * 2 * gridDim.x;  // the row's eps partials, then its noise ones
  if (threadIdx.x == 0) {
    p[blockIdx.x] = eps_acc;
    p[gridDim.x + blockIdx.x] = noise_acc;
    __threadfence();  // the partials are visible before the ticket is drawn
    last = atomicAdd(a.tickets + row, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // every partial of the row has landed: sum them in a fixed order
  float pe = 0.f, pn = 0.f;
  for (unsigned j = threadIdx.x; j < gridDim.x; j += blockDim.x) {
    pe += __ldcg(p + j);
    pn += __ldcg(p + gridDim.x + j);
  }
  pe = block_sum(pe, smem);
  pn = block_sum(pn, smem);
  if (threadIdx.x == 0) {
    a.eps_l1[row] = pe;
    a.noise_l1[row] = pn;
    a.tickets[row] = 0u;
  }
}

static int launch_perturb(bool bits_in, dim3 grid, unsigned threads, cudaStream_t st,
                          const PerturbArgs& a) {
  if (bits_in)
    perturb_kernel<kBitsIn><<<grid, threads, 0, st>>>(a);
  else if (a.run > 0)
    perturb_kernel<kPhiloxMapped><<<grid, threads, 0, st>>>(a);
  else if (a.col0 % 4 != 0)
    perturb_kernel<kPhiloxStraddle><<<grid, threads, 0, st>>>(a);
  else
    perturb_kernel<kPhilox><<<grid, threads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

// s, eps, out (n, d_pad) f32, 16-byte aligned, d_pad % 4 == 0, 0 < d_s <=
// d_pad; bits (n, d_s) uint32 or NULL for the Philox variant, whose rows
// start at wire column col0 >= 0 (run 0) or, with 4 <= run <= stride,
// have element j at column col0 + (j / run) * stride + j % run, and are
// the global nodes node0 >= 0, node0 + 1, ...; scale a device pointer to
// one f32.
// (threads, rows_per_block, quads_per_block, blocks_per_row) is the
// wrapper's plan (repro_torch.kernels.ops.
// perturb_plan): rows_per_block > 1 takes short rows, threads /
// rows_per_block lanes a row (a power of two <= 32), one block for
// rows_per_block rows; rows_per_block 1 takes blocks_per_row blocks of
// quads_per_block quads a row, covering its d_pad / 4 quads with no block
// empty. partials (n, 2 blocks_per_row) scratch and tickets n uint32 at
// zero (left at zero), both only where blocks_per_row > 1; eps_l1,
// noise_l1 (n,). Returns cudaGetLastError(), or cudaErrorInvalidValue for
// a plan the kernel does not take.
extern "C" int dpps_perturb_rows(const float* s, const float* eps, const uint32_t* bits,
                                 const float* scale, float gamma_n, int64_t n,
                                 int64_t d_pad, int64_t d_s, uint64_t seed, int64_t t,
                                 int64_t col0, int64_t run, int64_t stride, int64_t node0,
                                 int64_t threads,
                                 int64_t rows_per_block,
                                 int64_t quads_per_block, int64_t blocks_per_row,
                                 float* partials, unsigned* tickets, float* out,
                                 float* eps_l1, float* noise_l1, void* stream) {
  using namespace repro_torch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n_quads = d_pad / 4;
  const int64_t lanes = rows_per_block > 0 ? threads / rows_per_block : 0;
  if (n < 1 || d_s < 1 || d_s > d_pad || d_pad % 4 != 0 || (uintptr_t)s % 16 != 0 ||
      (uintptr_t)eps % 16 != 0 || (uintptr_t)out % 16 != 0 || col0 < 0 || node0 < 0 ||
      run < 0 || (run > 0 && (run < 4 || stride < run || d_pad >= ((int64_t)1 << 31))) ||
      threads < 32 ||
      threads > kThreads || threads % 32 != 0 || rows_per_block < 1 ||
      threads % rows_per_block != 0)
    return (int)cudaErrorInvalidValue;
  PerturbArgs a{s, eps, bits, scale, out, eps_l1, noise_l1, partials, tickets, n, d_pad, d_s,
                0, quads_per_block, rows_per_block, col0, run, stride, node0, gamma_n,
                (uint32_t)(seed & 0xffffffffu), (uint32_t)(seed >> 32), (uint32_t)t};
  if (rows_per_block > 1) {
    const int64_t blocks = (n + rows_per_block - 1) / rows_per_block;
    if (lanes > 32 || (lanes & (lanes - 1)) != 0 || blocks_per_row != 1 ||
        quads_per_block < n_quads || blocks >= ((int64_t)1 << 31))
      return (int)cudaErrorInvalidValue;
    return launch_perturb(bits != nullptr, dim3((unsigned)blocks), (unsigned)threads, st, a);
  }
  if (quads_per_block < 1 || blocks_per_row < 1 || blocks_per_row >= ((int64_t)1 << 31) ||
      blocks_per_row * quads_per_block < n_quads ||
      (blocks_per_row - 1) * quads_per_block >= n_quads ||
      (blocks_per_row > 1 && (partials == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  for (int64_t row0 = 0; row0 < n; row0 += kMaxGridRows) {
    a.row0 = row0;
    const dim3 grid((unsigned)blocks_per_row,
                    (unsigned)(n - row0 < kMaxGridRows ? n - row0 : kMaxGridRows));
    const int err = launch_perturb(bits != nullptr, grid, (unsigned)threads, st, a);
    if (err != (int)cudaSuccess) return err;
  }
  return (int)cudaSuccess;
}
