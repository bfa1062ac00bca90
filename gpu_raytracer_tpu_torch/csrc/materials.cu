// K5 standalone launch: the material sample of N (material id, uv) pairs at one
// mip level, one per thread, the device function of texsample.cuh that K6
// calls on textured scenes. The path tracer never launches this: it holds K5
// against its plain version (ops/shading.py::sample_materials) at the main
// path's shapes and times it. 12 bytes in and 44 bytes out per ray: the uv as
// one 8-byte load, the block's 11-channel rows through shared memory as
// 16-byte stores of one contiguous run.
#include <cuda_runtime.h>

#include "texsample.cuh"

namespace {

constexpr int kBlock = 128;
constexpr int kChannels = 11;

__global__ void __launch_bounds__(kBlock)
sample_materials_kernel(const float* __restrict__ mats, int n_mats,
                        const rt::TexMeta* __restrict__ maps, const int2* __restrict__ atlas,
                        int present, int n_levels, const int* __restrict__ mid,
                        const float2* __restrict__ uv, float lod, int n, float* __restrict__ out) {
  __shared__ float rows[kBlock * kChannels];
  const int base = blockIdx.x * kBlock;
  const int i = base + threadIdx.x;
  if (i < n) {
    const int m = min(max(__ldg(mid + i), 0), n_mats - 1);
    const float2 t = __ldg(uv + i);
    const rt::MaterialSample s =
        rt::sample_material<false>(mats, maps, atlas, present, n_levels, m, t.x, t.y, lod);
    float* o = rows + kChannels * threadIdx.x;
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
  __syncthreads();
  const int count = kChannels * min(kBlock, n - base);
  float* dst = out + kChannels * static_cast<long long>(base);
  if (count == kChannels * kBlock) {   // 16-byte aligned: 44 * kBlock bytes per block
    for (int j = threadIdx.x; j < count / 4; j += kBlock)
      reinterpret_cast<float4*>(dst)[j] = reinterpret_cast<const float4*>(rows)[j];
  } else {
    for (int j = threadIdx.x; j < count; j += kBlock) dst[j] = rows[j];
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int rt_sample_materials(const void* mats, int n_mats, const void* maps,
                                   const void* atlas, int present, int n_levels, const void* mid,
                                   const void* uv, float lod, int n, void* out, void* stream) {
  if (n <= 0) return 0;
  const dim3 block(kBlock);
  const dim3 grid((n + kBlock - 1) / kBlock);
  sample_materials_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mats), n_mats, static_cast<const rt::TexMeta*>(maps),
      static_cast<const int2*>(atlas), present, n_levels, static_cast<const int*>(mid),
      static_cast<const float2*>(uv), lod, n, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
