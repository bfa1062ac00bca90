// K5 standalone launch: the material sample of N (material id, uv) pairs at one
// mip level, one per thread, the device function of texsample.cuh that K6
// calls on textured scenes. The path tracer never launches this: it holds K5
// against its plain version (ops/shading.py::sample_materials) at the main
// path's shapes and times it. 12 bytes in and 44 bytes out per ray.
#include <cuda_runtime.h>

#include "texsample.cuh"

namespace {

__global__ void __launch_bounds__(128)
sample_materials_kernel(const float* __restrict__ mats, int n_mats,
                        const rt::TexMeta* __restrict__ maps, const int* __restrict__ atlas,
                        int present, int n_levels, const int* __restrict__ mid,
                        const float* __restrict__ uv, float lod, int n, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int m = min(max(mid[i], 0), n_mats - 1);
  const rt::MaterialSample s =
      rt::sample_material<false>(mats, maps, atlas, present, n_levels, m, uv[2 * i],
                                 uv[2 * i + 1], lod);
  float* o = out + 11 * i;
  o[0] = s.albedo[0];
  o[1] = s.albedo[1];
  o[2] = s.albedo[2];
  o[3] = s.emission[0];
  o[4] = s.emission[1];
  o[5] = s.emission[2];
  o[6] = s.metallic;
  o[7] = s.roughness;
  o[8] = s.ior;
  o[9] = s.transmission;
  o[10] = s.occlusion;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int rt_sample_materials(const void* mats, int n_mats, const void* maps,
                                   const void* atlas, int present, int n_levels, const void* mid,
                                   const void* uv, float lod, int n, void* out, void* stream) {
  if (n <= 0) return 0;
  const dim3 block(128);
  const dim3 grid((n + 127) / 128);
  sample_materials_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mats), n_mats, static_cast<const rt::TexMeta*>(maps),
      static_cast<const int*>(atlas), present, n_levels, static_cast<const int*>(mid),
      static_cast<const float*>(uv), lod, n, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
