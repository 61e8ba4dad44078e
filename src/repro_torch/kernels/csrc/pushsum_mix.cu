// Push-sum mixing: out = W @ x for W (N, N) f32 and x (N, D) f32 (Eq. 9).
//
// Replaces the Pallas kernel repro/kernels/pushsum_mix.py::_kernel
// (wrapper pushsum_mix), reached through repro.core.pushsum.gossip_packed
// (dense schedule) once a round.
//
// Bound on the card: memory. It reads x and writes out once, 8 bytes per
// element, and does 2N flops per element: about 2 flop/byte at N = 8, far
// below the card's ridge. So no tensor cores: W (at most 32 x 32 floats,
// 4 KB) sits in shared memory, each thread owns one column, loads its N
// values of x into registers (coalesced across the warp) and writes N
// outputs, each accumulated in f32 in j order with fma. N is a template
// parameter (1..32) so the column stays in registers.
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr int kMixThreads = 256;
constexpr int kMaxNodes = 32;

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

}  // namespace repro_torch

#define REPRO_MIX_CASE(K) \
  case K:                 \
    launch<K>(w, x, out, d, st); \
    break;

// w (n, n) f32, x and out (n, d) f32, 1 <= n <= 32. Returns cudaGetLastError(),
// or cudaErrorInvalidValue for an n outside 1..32.
extern "C" int pushsum_mix(const float* w, const float* x, float* out, int64_t n, int64_t d,
                           void* stream) {
  using namespace repro_torch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
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
