// K4: texture shading of the deferred G-buffer, phase 2 of the textured render,
// one ray per thread.
//
// Replaces the TPU kernel gpu_raytracer_tpu/ops/pallas/texshade.py
// pallas_texture_shade -> _kernel (pallas_call at :463), which turns every
// material-row and texel gather into one-hot matrix products against tables
// resident in TPU on-chip memory. Here each thread reads its ray's record of
// the G-buffer's first plane (S rgb, material id; render_deferred.cu), keeps
// the sky colour for a miss, and for a hit reads the second plane (u, v,
// footprint), its material row and, for each map slot some material uses
// (base colour, metallic-roughness, occlusion, emissive) that its material
// holds a texture in, samples the atlas (texsample.cuh::sample_maps, nearest
// mip or trilinear, an instance each). Then, in the plain version's order
// (ops/shading.py::shade_deferred):
//   albedo * 0.1 * occlusion + (albedo * brdf) * S + emission,
// the per-channel dispersion blend, magenta for an out-of-range material.
//
// What bounds it on an H100: the bytes, 16 per ray of the first plane, 16 per
// hit of the second and 12 of RGB per ray; a sky lane costs its 16 bytes
// (planes, not 32-byte records that every lane's sector pulls whole). The
// block's RGB goes out through shared memory as 16-byte stores of one
// contiguous run, not three 4-byte stores at a 12-byte stride. The sampled
// hits add the latency of their dependent loads (material row, metadata,
// level record, two texel pairs per level; all L1/L2-resident).
#include <cuda_runtime.h>

#include "render_common.cuh"
#include "texsample.cuh"

namespace {

constexpr int kShadeBlock = 128;
// Blocks an SM must fit: caps the registers at 65536 / (block * min blocks),
// 48. K4 is bound by memory traffic, which wants many warps in flight more
// than registers: the trilinear instance, which spills 184 bytes under this
// cap, ran 19% faster than with 80 registers and no spill (6 blocks), and
// the nearest one 8% faster than with 40 (`chip_ab.py --variants
// kShadeMinBlocks=...`, PERF.md).
constexpr int kShadeMinBlocks = 10;

template <bool TRILINEAR>
__global__ void __launch_bounds__(kShadeBlock, kShadeMinBlocks)
texshade_kernel(const float4* __restrict__ gbuf, int n, const float* __restrict__ mats,
                int n_mats, const rt::TexMeta* __restrict__ maps, const int2* __restrict__ atlas,
                int present, int n_levels, float sky_r, float sky_g, float sky_b,
                float* __restrict__ rgb) {
  __shared__ float out[kShadeBlock * 3];
  const int base = blockIdx.x * kShadeBlock;
  const int i = base + threadIdx.x;
  float col[3] = {sky_r, sky_g, sky_b};
  const float4 g0 = i < n ? __ldg(gbuf + i) : make_float4(0.0f, 0.0f, 0.0f, __int_as_float(-1));
  const int mat = __float_as_int(g0.w);
  if (mat >= 0) {
    const float4 g1 = __ldg(gbuf + n + i);   // u, v, footprint
    const int mid = min(max(mat, 0), n_mats - 1);
    const float* m = mats + mid * rt::kMatWords;
    float alb[3] = {m[0], m[1], m[2]};
    float emi[3] = {m[3], m[4], m[5]};
    float metallic = m[6];
    float occlusion = 1.0f;
    float4 s[rt::kMapSlots];
    const int held = rt::sample_maps<TRILINEAR ? rt::kLodTrilinear : rt::kLodNearest>(
        maps, atlas, present, n_levels, mid, g1.x, g1.y, g1.z, s);
    if (held & (1 << rt::kMapBaseColor)) {
      alb[0] = alb[0] * s[rt::kMapBaseColor].x;
      alb[1] = alb[1] * s[rt::kMapBaseColor].y;
      alb[2] = alb[2] * s[rt::kMapBaseColor].z;
    }
    if (held & (1 << rt::kMapEmissive)) {
      emi[0] = emi[0] * s[rt::kMapEmissive].x;
      emi[1] = emi[1] * s[rt::kMapEmissive].y;
      emi[2] = emi[2] * s[rt::kMapEmissive].z;
    }
    if (held & (1 << rt::kMapMetallicRoughness))
      metallic = metallic * s[rt::kMapMetallicRoughness].z;   // B channel
    if (held & (1 << rt::kMapOcclusion)) occlusion = s[rt::kMapOcclusion].x;   // R channel
    const bool with_occlusion = !RT_SAMPLER_OFF && ((present >> rt::kMapOcclusion) & 1);
    const float is_metal = metallic > 0.5f ? 1.0f : 0.0f;
    const float brdf = is_metal * 0.5f + (1.0f - is_metal) / rt::kPi;
    const float S[3] = {g0.x, g0.y, g0.z};
    const bool invalid = mat >= n_mats;
    const float magenta[3] = {1.0f, 0.0f, 1.0f};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float ambient = alb[c] * 0.1f;
      if (with_occlusion) ambient = ambient * occlusion;
      const float lit = ambient + alb[c] * brdf * S[c] + emi[c];
      col[c] = invalid ? magenta[c] : rt::dispersion_blend(lit, m[7], m[8], c);
    }
  }
  // the block's rows [base, base + count) are one contiguous run of floats
#pragma unroll
  for (int c = 0; c < 3; ++c) out[3 * threadIdx.x + c] = col[c];
  __syncthreads();
  const int count = 3 * min(kShadeBlock, n - base);
  float* dst = rgb + 3 * static_cast<long long>(base);
  if (count == 3 * kShadeBlock) {   // 16-byte aligned: 12 * kShadeBlock bytes per block
    for (int j = threadIdx.x; j < count / 4; j += kShadeBlock)
      reinterpret_cast<float4*>(dst)[j] = reinterpret_cast<const float4*>(out)[j];
  } else {
    for (int j = threadIdx.x; j < count; j += kShadeBlock) dst[j] = out[j];
  }
}

}  // namespace

// `gbuf` is the planar G-buffer [2, n, 4] f32 (render_deferred.cu), `atlas`
// the texel pairs. Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int rt_texture_shade(const void* gbuf, int n, const void* mats, int n_mats,
                                const void* maps, const void* atlas, int present, int n_levels,
                                int trilinear, float sky_r, float sky_g, float sky_b, void* rgb,
                                void* stream) {
  if (n <= 0) return 0;
  const dim3 block(kShadeBlock);
  const dim3 grid((n + kShadeBlock - 1) / kShadeBlock);
  auto s = static_cast<cudaStream_t>(stream);
#define RT_LAUNCH(T)                                                                          \
  texshade_kernel<T><<<grid, block, 0, s>>>(                                                  \
      static_cast<const float4*>(gbuf), n, static_cast<const float*>(mats), n_mats,           \
      static_cast<const rt::TexMeta*>(maps), static_cast<const int2*>(atlas), present,       \
      n_levels, sky_r, sky_g, sky_b, static_cast<float*>(rgb))
  if (trilinear) {
    RT_LAUNCH(true);
  } else {
    RT_LAUNCH(false);
  }
#undef RT_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
