// K4: texture shading of the deferred G-buffer, phase 2 of the textured render,
// one ray per thread.
//
// Replaces the TPU kernel gpu_raytracer_tpu/ops/pallas/texshade.py
// pallas_texture_shade -> _kernel (pallas_call at :463), which turns every
// material-row and texel gather into one-hot matrix products against tables
// resident in TPU on-chip memory. Here each thread reads its ray's 32-byte
// G-buffer record (render_deferred.cu), returns the sky colour at once for a
// miss, reads its material row and, for each map slot some material uses
// (base colour, metallic-roughness, occlusion, emissive) that its material
// holds a texture in, samples the atlas with direct loads (texsample.cuh).
// Then, in the plain version's order (ops/shading.py::shade_deferred):
//   albedo * 0.1 * occlusion + (albedo * brdf) * S + emission,
// the per-channel dispersion blend, magenta for an out-of-range material.
//
// What bounds it on an H100: per hit ray 32 bytes of G-buffer in, 12 bytes of
// RGB out, a 64-byte material row and the 32-byte metadata of each sampled map
// (all L1/L2-resident), and 4 texel loads per map and mip level. Neighbouring
// rays of the tile-major order hit neighbouring texels, so the atlas rows a
// warp touches are few and stay in L2 (the 100k courtyard's atlas is 1.7 MB).
// It is bound by the latency of those dependent loads, not by bandwidth or
// arithmetic.
#include <cuda_runtime.h>

#include "render_common.cuh"
#include "texsample.cuh"

namespace {

__global__ void __launch_bounds__(128)
texshade_kernel(const float4* __restrict__ gbuf, int n, const float* __restrict__ mats,
                int n_mats, const rt::TexMeta* __restrict__ maps, const int* __restrict__ atlas,
                int present, int n_levels, int trilinear, float sky_r, float sky_g, float sky_b,
                float* __restrict__ rgb) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float4 g0 = __ldg(gbuf + 2 * i);
  const int mat = __float_as_int(g0.w);
  if (mat < 0) {
    rgb[3 * i] = sky_r;
    rgb[3 * i + 1] = sky_g;
    rgb[3 * i + 2] = sky_b;
    return;
  }
  const float4 g1 = __ldg(gbuf + 2 * i + 1);   // u, v, footprint
  const int mid = min(max(mat, 0), n_mats - 1);
  const float* m = mats + mid * rt::kMatWords;
  float alb[3] = {m[0], m[1], m[2]};
  float emi[3] = {m[3], m[4], m[5]};
  float metallic = m[6];
  float occlusion = 1.0f;
  for (int k = 0; k < rt::kMapSlots; ++k) {
    if (!((present >> k) & 1)) continue;
    const rt::TexMeta t = maps[mid * rt::kMapSlots + k];
    if (!t.has) continue;   // the plain sampler's factor is exactly 1
    const float4 s = rt::sample_map(atlas, t, g1.x, g1.y, g1.z, n_levels, trilinear != 0);
    if (k == rt::kMapBaseColor) {
      alb[0] = alb[0] * s.x;
      alb[1] = alb[1] * s.y;
      alb[2] = alb[2] * s.z;
    } else if (k == rt::kMapEmissive) {
      emi[0] = emi[0] * s.x;
      emi[1] = emi[1] * s.y;
      emi[2] = emi[2] * s.z;
    } else if (k == rt::kMapMetallicRoughness) {
      metallic = metallic * s.z;   // B channel
    } else {
      occlusion = s.x;             // R channel
    }
  }
  const bool with_occlusion = (present >> rt::kMapOcclusion) & 1;
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
    rgb[3 * i + c] = invalid ? magenta[c] : rt::dispersion_blend(lit, m[7], m[8], c);
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int rt_texture_shade(const void* gbuf, int n, const void* mats, int n_mats,
                                const void* maps, const void* atlas, int present, int n_levels,
                                int trilinear, float sky_r, float sky_g, float sky_b, void* rgb,
                                void* stream) {
  if (n <= 0) return 0;
  const dim3 block(128);
  const dim3 grid((n + 127) / 128);
  texshade_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(gbuf), n, static_cast<const float*>(mats), n_mats,
      static_cast<const rt::TexMeta*>(maps), static_cast<const int*>(atlas), present, n_levels,
      trilinear, sky_r, sky_g, sky_b, static_cast<float*>(rgb));
  return static_cast<int>(cudaGetLastError());
}
