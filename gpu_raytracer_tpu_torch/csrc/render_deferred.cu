// K3: the entry point and the width-4 instances of the deferred trace
// (render_deferred.cuh).
#include <cuda_runtime.h>

#include "render_deferred.cuh"

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a node width or stack capacity that was not
// compiled. `light_u` null: every light is looped over. `rel_nodes` and
// `rel_tris`: the camera-relative tables of `cam` (rt_camera_relative,
// launched before on the same stream).
extern "C" int rt_render_deferred(const void* nodes, const void* tris, const void* attrs,
                                  const void* rel_nodes, const void* rel_tris, int node_width,
                                  int stack, const void* cam, const void* lights, int n_lights,
                                  const void* spheres, int n_spheres, const void* px,
                                  const void* py, int n, int width, int height, int shadows,
                                  float pix_scale, const void* light_u, void* gbuf,
                                  void* stream) {
  if (n <= 0) return 0;
  const rt::DeferredLaunch a{nodes, static_cast<const float4*>(tris),
                             static_cast<const float4*>(attrs), rel_nodes,
                             static_cast<const float4*>(rel_tris), static_cast<const float*>(cam),
                             static_cast<const float*>(lights), n_lights,
                             static_cast<const float*>(spheres), n_spheres,
                             static_cast<const int*>(px), static_cast<const int*>(py), n, width,
                             height, shadows, pix_scale, static_cast<const float*>(light_u),
                             static_cast<float4*>(gbuf)};
  auto s = static_cast<cudaStream_t>(stream);
  if (node_width == 4) return rt::launch_render_deferred<4>(a, stack, s);
  if (node_width == 8) return rt::render_deferred_w8(a, stack, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
