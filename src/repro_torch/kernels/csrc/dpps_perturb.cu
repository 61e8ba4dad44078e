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
//    function of (seed, t, node, e). repro_torch.kernels.ref.philox_bits
//    computes the same bits on any device.
// The noise scale S / b is read through a device pointer, so the round
// needs no host sync.
//
// Bound on the card: memory. It reads s and eps (8 bytes an element) and
// writes s_noise (4 bytes); the bits-in variant reads 4 more. Philox costs
// about 10 x 4 integer ops an element quad, far under the card's integer
// rate. Each thread handles quads of 4 columns with 16-byte loads and
// stores; one block per (8192-column chunk, row); the norms use the same
// two-pass partials as l1_norm.cu (pass two one block a row, in gridDim.x).
// More than 65,535 rows take a launch of pass one for each block of 65,535
// rows, told its first row: the Philox counter holds the row itself, so the
// bits do not depend on the split. The card's logf may differ from the
// CPU's log by an ulp, so the noise agrees with the plain version to about
// 1e-7 relative, not bit for bit.
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

template <bool kBitsIn>
__global__ void perturb_kernel(const float* __restrict__ s, const float* __restrict__ eps,
                               const uint32_t* __restrict__ bits,
                               const float* __restrict__ scale_ptr, float gamma_n,
                               int64_t row0, int64_t d_pad, int64_t d_s, uint32_t seed_lo,
                               uint32_t seed_hi, uint32_t t, float* __restrict__ out,
                               float* __restrict__ eps_part, float* __restrict__ noise_part,
                               int64_t n_chunks) {
  __shared__ float smem[32];
  const int64_t row = row0 + blockIdx.y;
  const int64_t base = row * d_pad;
  const float scale = __ldg(scale_ptr);
  const int64_t c0 = (int64_t)blockIdx.x * kChunk;
  const int64_t c1 = c0 + kChunk < d_pad ? c0 + kChunk : d_pad;
  const float4* s4 = reinterpret_cast<const float4*>(s + base);
  const float4* e4 = reinterpret_cast<const float4*>(eps + base);
  float4* o4 = reinterpret_cast<float4*>(out + base);
  float eps_acc = 0.f, noise_acc = 0.f;
  for (int64_t q = c0 / 4 + threadIdx.x; q < c1 / 4; q += blockDim.x) {
    const int64_t e0 = 4 * q;
    const float4 sv = s4[q], ev = e4[q];
    const float sa[4] = {sv.x, sv.y, sv.z, sv.w};
    const float ea[4] = {ev.x, ev.y, ev.z, ev.w};
    uint32_t w[4];
    if (kBitsIn) {
      const uint32_t* b = bits + row * d_s;
#pragma unroll
      for (int k = 0; k < 4; ++k) w[k] = e0 + k < d_s ? b[e0 + k] : 0u;
    } else {
      w[0] = (uint32_t)(q & 0xffffffffu);
      w[1] = (uint32_t)(q >> 32);
      w[2] = (uint32_t)row;
      w[3] = t;
      philox4x32_10(w, seed_lo, seed_hi);
    }
    float o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (e0 + k < d_s) {
        const float noise = laplace_from_bits(w[k], scale);
        // (s + eps) + gamma_n * noise, each step rounded as the plain
        // version rounds it (no fused multiply-add).
        o[k] = __fadd_rn(__fadd_rn(sa[k], ea[k]), __fmul_rn(gamma_n, noise));
        eps_acc += fabsf(ea[k]);
        noise_acc += fabsf(noise);
      } else {
        o[k] = 0.f;
      }
    }
    o4[q] = make_float4(o[0], o[1], o[2], o[3]);
  }
  const float eps_total = block_sum(eps_acc, smem);
  const float noise_total = block_sum(noise_acc, smem);
  if (threadIdx.x == 0) {
    eps_part[row * n_chunks + blockIdx.x] = eps_total;
    noise_part[row * n_chunks + blockIdx.x] = noise_total;
  }
}

}  // namespace repro_torch

// s, eps, out (n, d_pad) f32, 16-byte aligned, d_pad % 4 == 0; bits (n, d_s)
// uint32 or NULL for the Philox variant; scale a device pointer to one f32;
// eps_part, noise_part (n, n_chunks) scratch with n_chunks = ceil(d_pad / 8192);
// eps_l1, noise_l1 (n,). Returns cudaGetLastError().
extern "C" int dpps_perturb_rows(const float* s, const float* eps, const uint32_t* bits,
                                 const float* scale, float gamma_n, int64_t n,
                                 int64_t d_pad, int64_t d_s, uint64_t seed, int64_t t,
                                 float* out, float* eps_part, float* noise_part,
                                 int64_t n_chunks, float* eps_l1, float* noise_l1,
                                 void* stream) {
  using namespace repro_torch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t seed_lo = (uint32_t)(seed & 0xffffffffu), seed_hi = (uint32_t)(seed >> 32);
  cudaError_t err;
  for (int64_t row0 = 0; row0 < n; row0 += kMaxGridRows) {
    const dim3 grid((unsigned)n_chunks,
                    (unsigned)(n - row0 < kMaxGridRows ? n - row0 : kMaxGridRows));
    if (bits != nullptr) {
      perturb_kernel<true><<<grid, kThreads, 0, st>>>(s, eps, bits, scale, gamma_n, row0, d_pad,
                                                       d_s, seed_lo, seed_hi, (uint32_t)t, out,
                                                       eps_part, noise_part, n_chunks);
    } else {
      perturb_kernel<false><<<grid, kThreads, 0, st>>>(s, eps, bits, scale, gamma_n, row0,
                                                        d_pad, d_s, seed_lo, seed_hi,
                                                        (uint32_t)t, out, eps_part, noise_part,
                                                        n_chunks);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  sum_partials_kernel<<<(unsigned)n, kThreads, 0, st>>>(eps_part, n_chunks, eps_l1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials_kernel<<<(unsigned)n, kThreads, 0, st>>>(noise_part, n_chunks, noise_l1);
  return (int)cudaGetLastError();
}
