// K6 entry point and its untextured width-4 instances (the kernel is in
// bounce.cuh). The textured and the width-8 instances compile in
// bounce_textured.cu, bounce_w8.cu and bounce_textured_w8.cu, in parallel
// with this file.
#include <cuda_runtime.h>

#include "bounce.cuh"

// One bounce of the pool in place (bounce.cuh): `order`, `n_live` and `u` may
// be null; `qmc` points at 4 + 2 * 7 host words (pid_base, sample_base, hd,
// chunk, the generators, the salts), read when `u` is null. Returns
// cudaGetLastError() after the launch (0 = launched), or cudaErrorInvalidValue
// for a node width, stack capacity or flag that was not compiled.
extern "C" int rt_bounce(const void* nodes, const void* tris, const void* attrs, int width,
                         int stack,
                         const void* mats, int n_mats, const void* lights, int n_lights,
                         const void* spheres, int n_spheres, const void* maps, const void* atlas,
                         int present, int n_levels, int textured, float tex_lod, void* o,
                         void* d, void* thr, void* med, void* chan, void* rtype, void* depth,
                         void* active, void* rad, int n, const void* order, const void* n_live,
                         const void* u, const unsigned* qmc, int nee, int cont, void* stream) {
  if (n <= 0) return 0;
  rt::BounceArgs a;
  a.nodes = nodes;
  a.tris = static_cast<const float4*>(tris);
  a.attrs = static_cast<const float4*>(attrs);
  a.mats = static_cast<const float*>(mats);
  a.n_mats = n_mats;
  a.lights = static_cast<const float*>(lights);
  a.n_lights = n_lights;
  a.spheres = static_cast<const float*>(spheres);
  a.n_spheres = n_spheres;
  a.maps = static_cast<const rt::TexMeta*>(maps);
  a.atlas = static_cast<const int2*>(atlas);
  a.present = present;
  a.n_levels = n_levels;
  a.tex_lod = tex_lod;
  a.o = static_cast<float*>(o);
  a.d = static_cast<float*>(d);
  a.thr = static_cast<float*>(thr);
  a.med = static_cast<float*>(med);
  a.chan = static_cast<int*>(chan);
  a.rtype = static_cast<int*>(rtype);
  a.depth = static_cast<int*>(depth);
  a.active = static_cast<unsigned char*>(active);
  a.rad = static_cast<float*>(rad);
  a.n = n;
  a.order = static_cast<const int*>(order);
  a.n_live = static_cast<const long long*>(n_live);
  a.u = static_cast<const float*>(u);
  a.qmc = rt::qmc_stream(qmc);
  auto s = static_cast<cudaStream_t>(stream);
  if (width == 4)
    return textured ? rt::launch_bounce_textured(a, stack, nee, cont, s)
                    : rt::launch_bounce<4, false>(a, stack, nee, cont, s);
  if (width == 8)
    return textured ? rt::launch_bounce_textured_w8(a, stack, nee, cont, s)
                    : rt::launch_bounce_w8(a, stack, nee, cont, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
