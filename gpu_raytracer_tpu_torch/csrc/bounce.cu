// K6 entry point and its untextured instances (the kernel is in bounce.cuh).
// The textured instances compile in bounce_textured.cu, in parallel with this
// file.
#include <cuda_runtime.h>

#include "bounce.cuh"

int rt_bounce_textured_launch(const rt::BounceArgs& a, int stack, int nee, int cont,
                              cudaStream_t s);

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a stack capacity or flag that was not compiled.
extern "C" int rt_bounce(const void* nodes, const void* tris, const void* attrs, int stack,
                         const void* mats, int n_mats, const void* lights, int n_lights,
                         const void* spheres, int n_spheres, const void* maps, const void* atlas,
                         int present, int n_levels, int textured, float tex_lod, const void* o,
                         const void* d, const void* thr, const void* med, const void* chan,
                         const void* rtype, const void* depth, const void* active, const void* u,
                         int n, int nee, int cont, void* no, void* nd, void* nthr, void* nmed,
                         void* nchan, void* nrt, void* ndepth, void* nactive, void* rad,
                         void* stream) {
  if (n <= 0) return 0;
  rt::BounceArgs a;
  a.nodes = static_cast<const rt::Node4*>(nodes);
  a.tris = static_cast<const float4*>(tris);
  a.attrs = static_cast<const float4*>(attrs);
  a.mats = static_cast<const float*>(mats);
  a.n_mats = n_mats;
  a.lights = static_cast<const float*>(lights);
  a.n_lights = n_lights;
  a.spheres = static_cast<const float*>(spheres);
  a.n_spheres = n_spheres;
  a.maps = static_cast<const rt::TexMeta*>(maps);
  a.atlas = static_cast<const int*>(atlas);
  a.present = present;
  a.n_levels = n_levels;
  a.tex_lod = tex_lod;
  a.o = static_cast<const float*>(o);
  a.d = static_cast<const float*>(d);
  a.thr = static_cast<const float*>(thr);
  a.med = static_cast<const float*>(med);
  a.chan = static_cast<const int*>(chan);
  a.rtype = static_cast<const int*>(rtype);
  a.depth = static_cast<const int*>(depth);
  a.active = static_cast<const unsigned char*>(active);
  a.u = static_cast<const float*>(u);
  a.n = n;
  a.no = static_cast<float*>(no);
  a.nd = static_cast<float*>(nd);
  a.nthr = static_cast<float*>(nthr);
  a.nmed = static_cast<float*>(nmed);
  a.nchan = static_cast<int*>(nchan);
  a.nrt = static_cast<int*>(nrt);
  a.ndepth = static_cast<int*>(ndepth);
  a.nactive = static_cast<unsigned char*>(nactive);
  a.rad = static_cast<float*>(rad);
  auto s = static_cast<cudaStream_t>(stream);
  return textured ? rt_bounce_textured_launch(a, stack, nee, cont, s)
                  : rt::launch_bounce<false>(a, stack, nee, cont, s);
}
