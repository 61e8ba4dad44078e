// Per-row clip scale of a packed (N, d_pad) f32 buffer (paper Eq. 24):
//   out[i, c] = buf[i, c] / denom[i]   for c < d_s,   0 in the pad columns,
// with denom[i] = max(1, ||buf[i]||_1 / C) computed by the caller on the
// device (l1_norm_rows, then one elementwise op).
//
// Replaces the Pallas kernel repro/kernels/l1_clip.py::_scale_kernel
// (wrapper clip_scale), which repro.kernels.ops.l1_clip_tree vmaps over the
// nodes after the norm pass.
//
// A division, rounded to nearest (__fdiv_rn), as the Pallas kernel and the
// plain version divide: a product with the reciprocal would differ in the
// last bit.
//
// Bound on the card: memory. It reads buf and writes out once, 8 bytes an
// element. One block per (8192-column chunk, row), 16-byte loads and
// stores; element offsets are int64. More than 65,535 rows take one launch
// for each block of 65,535 rows, each told its first row.
#include "common.cuh"

namespace repro_torch {

__global__ void clip_scale_kernel(const float* __restrict__ buf, const float* __restrict__ denom,
                                  int64_t row0, int64_t d_pad, int64_t d_s,
                                  float* __restrict__ out) {
  const int64_t row = row0 + blockIdx.y;
  const float dn = __ldg(denom + row);
  const int64_t c0 = (int64_t)blockIdx.x * kChunk;
  const int64_t c1 = c0 + kChunk < d_pad ? c0 + kChunk : d_pad;
  const float4* x4 = reinterpret_cast<const float4*>(buf + row * d_pad);
  float4* o4 = reinterpret_cast<float4*>(out + row * d_pad);
  for (int64_t q = c0 / 4 + threadIdx.x; q < c1 / 4; q += blockDim.x) {
    const int64_t e0 = 4 * q;
    const float4 v = x4[q];
    float4 o;
    o.x = e0 + 0 < d_s ? __fdiv_rn(v.x, dn) : 0.f;
    o.y = e0 + 1 < d_s ? __fdiv_rn(v.y, dn) : 0.f;
    o.z = e0 + 2 < d_s ? __fdiv_rn(v.z, dn) : 0.f;
    o.w = e0 + 3 < d_s ? __fdiv_rn(v.w, dn) : 0.f;
    o4[q] = o;
  }
}

}  // namespace repro_torch

// buf, out (n, d_pad) f32, 16-byte aligned, d_pad % 4 == 0; denom (n,) f32.
// Returns cudaGetLastError().
extern "C" int clip_scale_rows(const float* buf, const float* denom, int64_t n, int64_t d_pad,
                               int64_t d_s, float* out, void* stream) {
  using namespace repro_torch;
  for (int64_t row0 = 0; row0 < n; row0 += kMaxGridRows) {
    const dim3 grid((unsigned)((d_pad + kChunk - 1) / kChunk),
                    (unsigned)(n - row0 < kMaxGridRows ? n - row0 : kMaxGridRows));
    clip_scale_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        buf, denom, row0, d_pad, d_s, out);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
