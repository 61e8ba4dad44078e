// Laplace(0, scale) noise from uint32 bits (paper Eq. 8, Lemma 1):
//   out[e] = laplace_from_bits(bits[e], *scale)     for e < m
// with the inverse-CDF transform of common.cuh, which dpps_perturb.cu runs
// inside its fused round.
//
// Replaces the Pallas kernel repro/kernels/laplace_noise.py::_kernel
// (wrapper laplace_from_bits), reached through
// repro.kernels.ops.laplace_noise_tree. The bits come from the caller, one
// uint32 per element; the scale is read on the device through its pointer,
// so the caller needs no host sync. Bits 1 << 31 give exactly 0, which is
// what the reference pads its tiles with.
//
// Bound on the card: memory. It reads 4 bytes and writes 4 bytes an
// element; the log is a few dozen f32 operations, under the card's rate.
// Each thread takes quads of 4 elements with 16-byte loads and stores
// (grid-stride); the ragged tail (m % 4) is done by thread 0 of block 0.
// Element offsets are int64.
#include "common.cuh"

namespace repro_torch {

__global__ void laplace_kernel(const uint32_t* __restrict__ bits,
                               const float* __restrict__ scale_ptr, int64_t m,
                               float* __restrict__ out) {
  const float scale = __ldg(scale_ptr);
  const int64_t n_quads = m / 4;
  const uint4* b4 = reinterpret_cast<const uint4*>(bits);
  float4* o4 = reinterpret_cast<float4*>(out);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; q < n_quads; q += stride) {
    const uint4 b = b4[q];
    o4[q] = make_float4(laplace_from_bits(b.x, scale), laplace_from_bits(b.y, scale),
                        laplace_from_bits(b.z, scale), laplace_from_bits(b.w, scale));
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    for (int64_t e = 4 * n_quads; e < m; ++e) out[e] = laplace_from_bits(bits[e], scale);
  }
}

}  // namespace repro_torch

// bits (m,) uint32 and out (m,) f32, both 16-byte aligned; scale a device
// pointer to one f32. Returns cudaGetLastError().
extern "C" int laplace_from_bits(const uint32_t* bits, const float* scale, int64_t m, float* out,
                                 void* stream) {
  using namespace repro_torch;
  // Enough blocks to fill the card many times over; each thread then loops.
  const int64_t quads = (m / 4 + kThreads - 1) / kThreads;
  const unsigned blocks = (unsigned)(quads < 1 ? 1 : (quads < 132 * 64 ? quads : 132 * 64));
  laplace_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(bits, scale, m, out);
  return (int)cudaGetLastError();
}
