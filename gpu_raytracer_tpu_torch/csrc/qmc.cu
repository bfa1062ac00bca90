// K6's in-kernel QMC stream launched on its own: the seven lattice uniforms
// of lanes 0..n-1 (bounce.cuh::qmc_uniforms) written to u [n,7], so that they
// can be held bit for bit against ops/sampler.py::qmc_uniforms on the card.
// The path tracer never calls this launch: K6 computes the numbers in place.
#include <cuda_runtime.h>

#include "bounce.cuh"

namespace {

__global__ void __launch_bounds__(128)
qmc_uniforms_kernel(const rt::QmcStream q, int n, float* __restrict__ u) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  float uu[rt::kBounceDims];
  rt::qmc_uniforms(q, lane, uu);
#pragma unroll
  for (int k = 0; k < rt::kBounceDims; ++k) u[rt::kBounceDims * lane + k] = uu[k];
}

}  // namespace

// `qmc`: the 4 + 2 * 7 host words of rt_bounce. Returns cudaGetLastError().
extern "C" int rt_qmc_uniforms(const unsigned* qmc, int n, void* u, void* stream) {
  if (n <= 0) return 0;
  qmc_uniforms_kernel<<<(n + 127) / 128, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      rt::qmc_stream(qmc), n, static_cast<float*>(u));
  return static_cast<int>(cudaGetLastError());
}
