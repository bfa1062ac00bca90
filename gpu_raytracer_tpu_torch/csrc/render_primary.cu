// K2: the fused primary render, one pixel per thread.
//
// Replaces the TPU kernel gpu_raytracer_tpu/ops/pallas/render.py
// pallas_render_primary -> _kernel (pallas_call at :701), untextured branch:
// camera ray from the pixel coordinates -> exhaustive sphere pass (strict <)
// -> K1 closest hit of the triangles pruned at the sphere's t -> material row
// -> per light: intensity with the f16 attenuation round trip, and with
// shadows one any-hit shadow ray through K1 plus the sphere occluders ->
// ambient 0.1 + brdf x light sum + emission -> per-channel dispersion blend ->
// magenta for an invalid material, the sky colour for a miss.
//
// Every formula follows the plain PyTorch version (engine/renderer.py::
// render_chunk and ops/shading.py) operation for operation, in the same order
// (render_common.cuh holds the parts shared with the deferred trace, K3), and
// the light sum accumulates in light order. Built with -fmad=false the kernel
// then rounds like the plain version; the two differ only where two triangles
// share the exact same t (see traverse.cuh).
//
// What bounds it on an H100: the traversals (one primary ray and, with
// shadows, one shadow ray per light), which are latency- and divergence-bound
// (traverse.cuh). The rest is a few hundred flops per pixel. Per pixel it
// reads 8 bytes (coordinates) and writes 12 (RGB); the camera, material,
// light and sphere rows are a few hundred bytes read through the constant-
// like read-only path, the BVH tables stay in L2. Fusing raygen, traversal
// and shading keeps every intermediate in registers instead of the ~15 per-ray
// arrays the plain pipeline writes to device memory between stages.
#include <cuda_runtime.h>

#include "render_common.cuh"

namespace {

template <int STACK>
__global__ void __launch_bounds__(128)
render_primary_kernel(const rt::Node4* __restrict__ nodes, const float4* __restrict__ tris,
                      const float* __restrict__ cam, const float* __restrict__ mats,
                      int n_mats, const float* __restrict__ lights, int n_lights,
                      const float* __restrict__ spheres, int n_spheres,
                      const int* __restrict__ px, const int* __restrict__ py, int n, int width,
                      int height, int shadows, float sky_r, float sky_g, float sky_b,
                      float* __restrict__ rgb) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  const rt::Ray ray = rt::camera_ray(cam, px[i], py[i], width, height);
  rt::Surface s;
  if (!rt::closest_surface<STACK>(nodes, tris, spheres, n_spheres, ray, s)) {
    rgb[3 * i] = sky_r;
    rgb[3 * i + 1] = sky_g;
    rgb[3 * i + 2] = sky_b;
    return;
  }

  // ---- material ----
  const int mid = min(max(s.mat, 0), n_mats - 1);
  const float* m = mats + mid * rt::kMatWords;
  const float alb[3] = {m[0], m[1], m[2]};
  const float is_metal = m[6] > 0.5f ? 1.0f : 0.0f;
  const float brdf = is_metal * 0.5f + (1.0f - is_metal) / rt::kPi;

  // ---- direct lighting, accumulated in light order ----
  float sum[3] = {0.0f, 0.0f, 0.0f};
  for (int li = 0; li < n_lights; ++li) {
    const float* L = lights + li * rt::kLightWords;
    const float I = rt::light_intensity<STACK>(L, s, shadows != 0, nodes, tris, spheres,
                                               n_spheres);
    const float gate = I > 0.0f ? 1.0f : 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) sum[c] = sum[c] + alb[c] * brdf * (I * gate) * L[4 + c];
  }

  // ---- ambient + lights + emission, transmission blend with dispersion ----
  const bool invalid = s.mat < 0 || s.mat >= n_mats;
  const float magenta[3] = {1.0f, 0.0f, 1.0f};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float lit = alb[c] * 0.1f + sum[c] + m[3 + c];
    rgb[3 * i + c] = invalid ? magenta[c] : rt::dispersion_blend(lit, m[7], m[8], c);
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a stack capacity that was not compiled.
extern "C" int rt_render_primary(const void* nodes, const void* tris, int stack,
                                 const void* cam, const void* mats, int n_mats,
                                 const void* lights, int n_lights, const void* spheres,
                                 int n_spheres, const void* px, const void* py, int n, int width,
                                 int height, int shadows, float sky_r, float sky_g, float sky_b,
                                 void* rgb, void* stream) {
  if (n <= 0) return 0;
  const dim3 block(128);
  const dim3 grid((n + 127) / 128);
  auto s = static_cast<cudaStream_t>(stream);
#define RT_LAUNCH(S)                                                                          \
  render_primary_kernel<S><<<grid, block, 0, s>>>(                                            \
      static_cast<const rt::Node4*>(nodes), static_cast<const float4*>(tris),                \
      static_cast<const float*>(cam), static_cast<const float*>(mats), n_mats,               \
      static_cast<const float*>(lights), n_lights, static_cast<const float*>(spheres),       \
      n_spheres, static_cast<const int*>(px), static_cast<const int*>(py), n, width, height, \
      shadows, sky_r, sky_g, sky_b, static_cast<float*>(rgb))
  RT_SWITCH_STACK(stack, RT_LAUNCH)
#undef RT_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
