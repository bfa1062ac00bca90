// K3: the deferred trace, phase 1 of the textured render, one pixel per thread,
// for node tables of width W (the width-4 instances and the entry point in
// render_deferred.cu, the width-8 instances in render_deferred_w8.cu).
//
// Replaces the TPU kernel gpu_raytracer_tpu/ops/pallas/render.py
// pallas_render_deferred -> _kernel_deferred (pallas_call at :787): camera ray
// -> exhaustive sphere pass -> K1 closest hit pruned at the sphere's t -> per
// light the shadowed intensity I (render_common.cuh, shared with K2) ->
// the material-independent light sum S = sum of (I * gate) * colour in light
// order, or with `light_u` (the TPU kernel's branch above 16 lights) the one
// sampled light's (I * gate) * L * colour. It writes the G-buffer as two
// planes of one float4 per ray, [2, n, 4]:
//   plane 0: (S.r, S.g, S.b, material id as int bits),
//   plane 1: (u, v, mip footprint, 0),
// with material -1 and zeros for a miss (ops/render.py::split_gbuffer
// reads both layouts). Each store of a warp is one contiguous 512-byte run,
// and K4 (texshade.cu), which applies the materials and textures, reads
// plane 1 for hits only.
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
// What bounds it on an H100: as K2, the traversals (issue-bound,
// traverse.cuh); the winner's attribute record is one more 32-byte read, 32
// bytes out per ray. Splitting shading off lets the texture reads run in K4
// on rays already sorted out from the sky.
//
// Every camera ray of a frame starts at the camera, so the camera walk takes
// the walk's camera-relative form (traverse.cuh, REL): it reads the node
// records with the camera's position taken off every box plane and the
// triangle rows with s = o - v0, q = s x e1 and e2 . q made once per frame
// by K3's pre-pass (camera_relative.cu, launched before every K3 launch by
// ops/cuda/render.py::render_deferred), the same bits as the per-ray values,
// so the same visits, tests and winners for fewer instructions a visit and
// a test. The shadow walks (their own origins), the hit point, the winner's
// attributes and uv read the ordinary tables. kCameraRel 1: the camera walk
// reads both relative tables (on an NVIDIA H100 each half shortened K3 at
// both widths, and both together the most, PERF.md); 0: the ordinary walk,
// for an A/B (chip_ab.py --variants kCameraRel=0 rewrites it).
#pragma once

#include <cuda_runtime.h>

#include "render_common.cuh"

namespace rt {

constexpr int kCameraRel = 1;

template <int W, int STACK>
__global__ void __launch_bounds__(kRenderBlock, W == 8 ? kRenderMinBlocksW8 : kRenderMinBlocks)
render_deferred_kernel(const Node<W>* __restrict__ nodes, const float4* __restrict__ tris,
                       const float4* __restrict__ attrs, const Node<W>* __restrict__ rel_nodes,
                       const float4* __restrict__ rel_tris, const float* __restrict__ cam,
                       const float* __restrict__ lights, int n_lights,
                       const float* __restrict__ spheres, int n_spheres,
                       const int* __restrict__ px, const int* __restrict__ py, int n, int width,
                       int height, int shadows, float pix_scale,
                       const float* __restrict__ light_u, float4* __restrict__ gbuf) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  const Ray ray = camera_ray(cam, px[i], py[i], width, height);
  Surface s;
  if (!closest_surface<W, STACK, kCameraRel != 0>(nodes, tris, spheres, n_spheres, ray, s,
                                                  rel_nodes, rel_tris)) {
    gbuf[i] = make_float4(0.0f, 0.0f, 0.0f, __int_as_float(-1));
    gbuf[n + i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    return;
  }

  float S[3] = {0.0f, 0.0f, 0.0f};
  if (light_u != nullptr) {
    float Ig;
    const float* L = sampled_light<W, STACK>(lights, n_lights, light_u[i], s, shadows != 0,
                                             nodes, tris, spheres, n_spheres, Ig);
#pragma unroll
    for (int c = 0; c < 3; ++c) S[c] = Ig * L[4 + c];
  } else {
    for (int li = 0; li < n_lights; ++li) {
      const float* L = lights + li * kLightWords;
      const float I = light_intensity<W, STACK>(L, s, shadows != 0, nodes, tris, spheres,
                                                n_spheres);
      const float gate = I > 0.0f ? 1.0f : 0.0f;
#pragma unroll
      for (int c = 0; c < 3; ++c) S[c] = S[c] + (I * gate) * L[4 + c];
    }
  }

  float density;
  const float2 uv = surface_uv(tris, attrs, ray, s, density);
  const float lam = s.slot >= 0 ? s.t * pix_scale * density : 0.0f;
  gbuf[i] = make_float4(S[0], S[1], S[2], __int_as_float(s.mat));
  gbuf[n + i] = make_float4(uv.x, uv.y, lam, 0.0f);
}

// The arguments of one K3 launch (host side).
struct DeferredLaunch {
  const void* nodes;
  const float4* tris;
  const float4* attrs;
  const void* rel_nodes;    // the camera-relative tables (camera_relative.cu)
  const float4* rel_tris;
  const float* cam;
  const float* lights;
  int n_lights;
  const float* spheres;
  int n_spheres;
  const int* px;
  const int* py;
  int n, width, height, shadows;
  float pix_scale;
  const float* light_u;
  float4* gbuf;
};

// Launch the width-W instance for `stack`; returns cudaGetLastError(), or
// cudaErrorInvalidValue for a stack capacity that was not compiled.
template <int W>
int launch_render_deferred(const DeferredLaunch& a, int stack, cudaStream_t s) {
  const dim3 block(kRenderBlock);
  const dim3 grid((a.n + kRenderBlock - 1) / kRenderBlock);
#define RT_LAUNCH(S)                                                                          \
  render_deferred_kernel<W, S><<<grid, block, 0, s>>>(                                        \
      static_cast<const Node<W>*>(a.nodes), a.tris, a.attrs,                                  \
      static_cast<const Node<W>*>(a.rel_nodes), a.rel_tris, a.cam, a.lights, a.n_lights,     \
      a.spheres, a.n_spheres, a.px, a.py, a.n, a.width, a.height, a.shadows, a.pix_scale,     \
      a.light_u, a.gbuf)
  RT_SWITCH_STACK(W, stack, RT_LAUNCH)
#undef RT_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// The width-8 instances (render_deferred_w8.cu).
int render_deferred_w8(const DeferredLaunch& a, int stack, cudaStream_t s);

}  // namespace rt
