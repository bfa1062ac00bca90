// K2: the entry point and the untextured width-4 instances of the fused
// primary render (render_primary.cuh).
#include "render_primary.cuh"

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a node width or stack capacity that was not
// compiled, or width 8 without the camera-relative tables. `light_u` null:
// every light is looped over. `rel_nodes` and `rel_tris`: the
// camera-relative tables of `cam` (rt_camera_relative, launched before on
// the same stream), read at node width 8 only.
extern "C" int rt_render_primary(const void* nodes, const void* tris, const void* rel_nodes,
                                 const void* rel_tris, int node_width, int stack,
                                 const void* cam, const void* mats, int n_mats,
                                 const void* lights, int n_lights, const void* spheres,
                                 int n_spheres, const void* px, const void* py, int n, int width,
                                 int height, int shadows, float sky_r, float sky_g, float sky_b,
                                 const void* light_u, void* rgb, void* stream) {
  if (n <= 0) return 0;
  const rt::PrimaryLaunch a{nodes, static_cast<const float4*>(tris),
                            static_cast<const float*>(cam), static_cast<const float*>(mats),
                            n_mats, static_cast<const float*>(lights), n_lights,
                            static_cast<const float*>(spheres), n_spheres,
                            rt::PrimaryTextures{nullptr, nullptr, nullptr, 0, 1, 0.0f},
                            static_cast<const int*>(px), static_cast<const int*>(py), n, width,
                            height, shadows, sky_r, sky_g, sky_b,
                            static_cast<const float*>(light_u), static_cast<float*>(rgb),
                            rel_nodes, static_cast<const float4*>(rel_tris)};
  auto s = static_cast<cudaStream_t>(stream);
  if (node_width == 8 && (rel_nodes == nullptr || rel_tris == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (node_width == 4) return rt::launch_render_primary<4, false>(a, stack, s);
  if (node_width == 8) return rt::render_primary_w8(a, stack, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
