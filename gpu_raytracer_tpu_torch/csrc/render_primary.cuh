// K2 and K2t: the fused primary render, one pixel per thread, untextured
// (TEXTURED = false, instantiated in render_primary.cu) and textured
// (TEXTURED = true, render_primary_textured.cu), for node tables of width 4;
// the width-8 instances compile in render_primary_w8.cu and
// render_primary_textured_w8.cu.
//
// Replaces the TPU kernel gpu_raytracer_tpu/ops/pallas/render.py
// pallas_render_primary -> _kernel (pallas_call at :701), both branches:
// camera ray from the pixel coordinates -> exhaustive sphere pass (strict <)
// -> K1 closest hit of the triangles pruned at the sphere's t -> material
// -> per light: intensity with the f16 attenuation round trip, and with
// shadows one any-hit shadow ray through K1 plus the sphere occluders ->
// ambient 0.1 + brdf x light sum + emission -> per-channel dispersion blend ->
// magenta for an invalid material, the sky colour for a miss. The pixel is
// primary_pixel.cuh (where the camera walk over the camera-relative tables
// and the material step split around the light loop of width 8 and of K2t
// at width 4 are laid out); this file holds the kernel and its launch.
//
// The material is the winner's material row (K2) or, textured (K2t, the TPU
// kernel's branch at :363-378), that row times its maps: the hit's uv
// (render_common.cuh::surface_uv, the triangle's barycentrics or the
// sphere's equirectangular coordinates), the mip footprint
// t * (2 tan(fov/2) / H) * uv density in the deferred trace's operation
// order, and texsample.cuh::sample_material at the nearest mip level of that
// footprint (nearest only, as the TPU kernel); the occlusion map's R scales
// the ambient term. One launch, no G-buffer.
//
// With `light_u` (one uniform per pixel) each pixel evaluates the one light
// min(floor(u * L), L - 1), one shadow ray, weighted by L
// (render_common.cuh::sampled_light): the TPU kernel's branch above 16
// lights (:410-423). Null loops over every light.
//
// Every formula follows the plain PyTorch version (ops/render.py::
// render_chunk and ops/shading.py) operation for operation, in the same order
// (render_common.cuh holds the parts shared with the deferred trace, K3), and
// the light sum accumulates in light order. Built with -fmad=false the kernel
// then rounds like the plain version; the two differ only where two triangles
// share the exact same t (see traverse.cuh).
//
// What bounds it on an H100: the traversals (one primary ray and, with
// shadows, one shadow ray per light), which are bound by instruction
// throughput and the latency of dependent node loads, not by divergence on camera rays
// (traverse.cuh, with the measured SIMT efficiency). The rest is a few
// hundred flops per pixel. Per pixel it reads 8 bytes (coordinates) and
// writes 12 (RGB); the camera, material, light and sphere rows are a few
// hundred bytes read through the constant-like read-only path, the BVH
// tables (128-byte node lines) stay in L2; textured, one 32-byte attribute
// record, the metadata, one level record and two 8-byte texel-pair loads per
// sampled map (texsample.cuh), dependent loads from L2-resident tables.
// Fusing raygen, traversal and shading keeps every intermediate in registers
// instead of the ~15 per-ray arrays the plain pipeline writes to device
// memory between stages. The launch is 128
// threads a block with the registers capped for 6 blocks an SM (77-80
// registers, no spills at width 4; a measured sweep, PERF.md); the width-8
// instances take the width-8 cap kRenderMinBlocksW8 (traverse.cuh), also 6,
// at which K2 w8 spills 28 bytes and K2t w8 84 (80 registers): 5 blocks
// (96 registers, 4 / 72 bytes) read 5% slower (PERF.md). Callers
// order the pixels so that a warp is an 8 x 4 block (engine/renderer.py).
#pragma once

#include <cuda_runtime.h>

#include "primary_pixel.cuh"

namespace rt {

// rel_nodes / rel_tris: the camera-relative tables of `cam` (K3's pre-pass,
// launched before on the same stream), read by the camera walk of width 8
// and of K2t at width 4; K2 at width 4 never reads them.
template <int W, int STACK, bool TEXTURED>
__global__ void __launch_bounds__(kRenderBlock, W == 8 ? kRenderMinBlocksW8 : kRenderMinBlocks)
render_primary_kernel(const Node<W>* __restrict__ nodes, const float4* __restrict__ tris,
                      const float* __restrict__ cam, const float* __restrict__ mats,
                      int n_mats, const float* __restrict__ lights, int n_lights,
                      const float* __restrict__ spheres, int n_spheres,
                      const PrimaryTextures tex, const int* __restrict__ px,
                      const int* __restrict__ py, int n, int width, int height, int shadows,
                      float sky_r, float sky_g, float sky_b,
                      const float* __restrict__ light_u, float* __restrict__ rgb,
                      const Node<W>* __restrict__ rel_nodes,
                      const float4* __restrict__ rel_tris) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  primary_pixel<W, STACK, TEXTURED>(nodes, tris, cam, mats, n_mats, lights, n_lights, spheres,
                                    n_spheres, tex, px, py, i, width, height, shadows, sky_r,
                                    sky_g, sky_b, light_u, rgb, rel_nodes, rel_tris);
}

// The arguments of one K2 / K2t launch (host side).
struct PrimaryLaunch {
  const void* nodes;
  const float4* tris;
  const float* cam;
  const float* mats;
  int n_mats;
  const float* lights;
  int n_lights;
  const float* spheres;
  int n_spheres;
  PrimaryTextures tex;
  const int* px;
  const int* py;
  int n, width, height, shadows;
  float sky_r, sky_g, sky_b;
  const float* light_u;
  float* rgb;
  const void* rel_nodes;    // the camera-relative tables (width 8, K2t; else null)
  const float4* rel_tris;
};

// Launch the width-W instance for `stack`; returns cudaGetLastError(), or
// cudaErrorInvalidValue for a stack capacity that was not compiled.
template <int W, bool TEXTURED>
int launch_render_primary(const PrimaryLaunch& a, int stack, cudaStream_t s) {
  const dim3 block(kRenderBlock);
  const dim3 grid((a.n + kRenderBlock - 1) / kRenderBlock);
#define RT_LAUNCH(S)                                                                          \
  render_primary_kernel<W, S, TEXTURED><<<grid, block, 0, s>>>(                               \
      static_cast<const Node<W>*>(a.nodes), a.tris, a.cam, a.mats, a.n_mats, a.lights,       \
      a.n_lights, a.spheres, a.n_spheres, a.tex, a.px, a.py, a.n, a.width, a.height,         \
      a.shadows, a.sky_r, a.sky_g, a.sky_b, a.light_u, a.rgb,                                \
      static_cast<const Node<W>*>(a.rel_nodes), a.rel_tris)
  RT_SWITCH_STACK(W, stack, RT_LAUNCH)
#undef RT_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// The width-8 instances (render_primary_w8.cu, render_primary_textured_w8.cu).
int render_primary_w8(const PrimaryLaunch& a, int stack, cudaStream_t s);
int render_primary_textured_w8(const PrimaryLaunch& a, int stack, cudaStream_t s);

}  // namespace rt
