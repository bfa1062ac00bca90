// K3: the deferred trace, phase 1 of the textured render, one pixel per thread.
//
// Replaces the TPU kernel gpu_raytracer_tpu/ops/pallas/render.py
// pallas_render_deferred -> _kernel_deferred (pallas_call at :787): camera ray
// -> exhaustive sphere pass -> K1 closest hit pruned at the sphere's t -> per
// light the shadowed intensity I (render_common.cuh, shared with K2) ->
// the material-independent light sum S = sum of (I * gate) * colour in light
// order. It writes one 32-byte G-buffer record per ray, two float4:
//   (S.r, S.g, S.b, material id as int bits), (u, v, mip footprint, 0),
// with material -1 and zeros for a miss. K4 (texshade.cu) applies the
// materials and textures to it.
//
// The hit's texture coordinates: for a triangle, its Moller-Trumbore
// barycentrics recomputed once for the winner in the plain version's
// operation order (ops/trace.py::mt_bary) and its corner uvs interpolated as
// uv0 * (1 - u - v) + uv1 * u + uv2 * v from the per-slot attribute table
// (ops/cuda/traverse.py); for a sphere, equirectangular from the unit normal
// with atan2f / asinf (the TPU kernel's polynomial atan2 is not needed). The
// footprint is t * (2 tan(fov/2) / H) * density, the density decoded on the
// host from the scene's 14-bit code; 0 for a sphere.
//
// What bounds it on an H100: as K2, the traversals (latency- and
// divergence-bound, traverse.cuh); the winner's attribute record is one more
// 32-byte read, the record out 32 bytes per ray. Splitting shading off lets
// the texture reads run in K4 on rays already sorted out from the sky.
#include <cuda_runtime.h>

#include "render_common.cuh"

namespace {

constexpr float kTwoPi = static_cast<float>(2.0 * 3.14159265358979323846);

template <int STACK>
__global__ void __launch_bounds__(128)
render_deferred_kernel(const rt::Node4* __restrict__ nodes, const float4* __restrict__ tris,
                       const float4* __restrict__ attrs, const float* __restrict__ cam,
                       const float* __restrict__ lights, int n_lights,
                       const float* __restrict__ spheres, int n_spheres,
                       const int* __restrict__ px, const int* __restrict__ py, int n, int width,
                       int height, int shadows, float pix_scale, float4* __restrict__ gbuf) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  const rt::Ray ray = rt::camera_ray(cam, px[i], py[i], width, height);
  rt::Surface s;
  if (!rt::closest_surface<STACK>(nodes, tris, spheres, n_spheres, ray, s)) {
    gbuf[2 * i] = make_float4(0.0f, 0.0f, 0.0f, __int_as_float(-1));
    gbuf[2 * i + 1] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    return;
  }

  float S[3] = {0.0f, 0.0f, 0.0f};
  for (int li = 0; li < n_lights; ++li) {
    const float* L = lights + li * rt::kLightWords;
    const float I = rt::light_intensity<STACK>(L, s, shadows != 0, nodes, tris, spheres,
                                               n_spheres);
    const float gate = I > 0.0f ? 1.0f : 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) S[c] = S[c] + (I * gate) * L[4 + c];
  }

  float u, v, lam;
  if (s.slot >= 0) {
    const float4 a0 = __ldg(tris + 3 * s.slot + 0);
    const float4 a1 = __ldg(tris + 3 * s.slot + 1);
    const float4 a2 = __ldg(tris + 3 * s.slot + 2);
    // h = d x e2, a = e1 . h, s = o - v0, q = s x e1
    const float hx = ray.dy * a2.z - ray.dz * a2.y;
    const float hy = ray.dz * a2.x - ray.dx * a2.z;
    const float hz = ray.dx * a2.y - ray.dy * a2.x;
    const float a = rt::dot3(a1.x, a1.y, a1.z, hx, hy, hz);
    const float f = 1.0f / (a == 0.0f ? 1.0f : a);
    const float sx = ray.ox - a0.x, sy = ray.oy - a0.y, sz = ray.oz - a0.z;
    const float qx = sy * a1.z - sz * a1.y;
    const float qy = sz * a1.x - sx * a1.z;
    const float qz = sx * a1.y - sy * a1.x;
    const float bu = f * rt::dot3(sx, sy, sz, hx, hy, hz);
    const float bv = f * rt::dot3(ray.dx, ray.dy, ray.dz, qx, qy, qz);
    const float4 t0 = __ldg(attrs + 2 * s.slot);       // uv0, uv1
    const float4 t1 = __ldg(attrs + 2 * s.slot + 1);   // uv2, density, 0
    const float w0 = 1.0f - bu - bv;
    u = t0.x * w0 + t0.z * bu + t1.x * bv;
    v = t0.y * w0 + t0.w * bu + t1.y * bv;
    lam = s.t * pix_scale * t1.z;
  } else {
    u = 0.5f + atan2f(s.nz, s.nx) / kTwoPi;
    v = 0.5f - asinf(fminf(fmaxf(s.ny, -1.0f), 1.0f)) / rt::kPi;
    lam = 0.0f;
  }
  gbuf[2 * i] = make_float4(S[0], S[1], S[2], __int_as_float(s.mat));
  gbuf[2 * i + 1] = make_float4(u, v, lam, 0.0f);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a stack capacity that was not compiled.
extern "C" int rt_render_deferred(const void* nodes, const void* tris, const void* attrs,
                                  int stack, const void* cam, const void* lights, int n_lights,
                                  const void* spheres, int n_spheres, const void* px,
                                  const void* py, int n, int width, int height, int shadows,
                                  float pix_scale, void* gbuf, void* stream) {
  if (n <= 0) return 0;
  const dim3 block(128);
  const dim3 grid((n + 127) / 128);
  auto s = static_cast<cudaStream_t>(stream);
#define RT_LAUNCH(S)                                                                           \
  render_deferred_kernel<S><<<grid, block, 0, s>>>(                                            \
      static_cast<const rt::Node4*>(nodes), static_cast<const float4*>(tris),                 \
      static_cast<const float4*>(attrs), static_cast<const float*>(cam),                      \
      static_cast<const float*>(lights), n_lights, static_cast<const float*>(spheres),        \
      n_spheres, static_cast<const int*>(px), static_cast<const int*>(py), n, width, height,  \
      shadows, pix_scale, static_cast<float4*>(gbuf))
  RT_SWITCH_STACK(stack, RT_LAUNCH)
#undef RT_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
