// K2t: the entry point and the textured width-4 instances of the fused
// primary render (render_primary.cuh), in a source of their own so that they
// compile beside the untextured ones.
#include "render_primary.cuh"

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a node width or stack capacity that was not
// compiled, or without the camera-relative tables. `light_u` null: every
// light is looped over. `rel_nodes` and `rel_tris`: the camera-relative
// tables of `cam` (rt_camera_relative, launched before on the same stream),
// which the camera walk reads at both node widths.
extern "C" int rt_render_primary_textured(
    const void* nodes, const void* tris, const void* attrs, const void* rel_nodes,
    const void* rel_tris, int node_width, int stack,
    const void* cam, const void* mats, int n_mats, const void* lights, int n_lights,
    const void* spheres, int n_spheres, const void* maps, const void* atlas, int present,
    int n_levels, float pix_scale, const void* px, const void* py, int n, int width, int height,
    int shadows, float sky_r, float sky_g, float sky_b, const void* light_u, void* rgb,
    void* stream) {
  if (n <= 0) return 0;
  const rt::PrimaryTextures tex{static_cast<const float4*>(attrs),
                                static_cast<const rt::TexMeta*>(maps),
                                static_cast<const int2*>(atlas), present, n_levels, pix_scale};
  const rt::PrimaryLaunch a{nodes, static_cast<const float4*>(tris),
                            static_cast<const float*>(cam), static_cast<const float*>(mats),
                            n_mats, static_cast<const float*>(lights), n_lights,
                            static_cast<const float*>(spheres), n_spheres, tex,
                            static_cast<const int*>(px), static_cast<const int*>(py), n, width,
                            height, shadows, sky_r, sky_g, sky_b,
                            static_cast<const float*>(light_u), static_cast<float*>(rgb),
                            rel_nodes, static_cast<const float4*>(rel_tris)};
  auto s = static_cast<cudaStream_t>(stream);
  if (rel_nodes == nullptr || rel_tris == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (node_width == 4) return rt::launch_render_primary<4, true>(a, stack, s);
  if (node_width == 8) return rt::render_primary_textured_w8(a, stack, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
