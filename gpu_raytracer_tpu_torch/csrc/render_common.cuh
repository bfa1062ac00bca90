// Device functions shared by the primary-render kernels: K2 and K2t
// (render_primary.cuh) and K3 (render_deferred.cuh). One pixel per thread.
// The traversing ones take the node records' width W (4 or 8) as their first
// template argument.
//
// Camera ray from the pixel coordinates, the exhaustive sphere pass, K1's
// closest hit pruned at the sphere's t (strict <: the sphere wins a tie), the
// hit point, normal and material, one light's intensity with the f16
// attenuation round trip and, with shadows, its any-hit shadow ray through K1
// plus the sphere occluders, and the per-channel dispersion blend.
//
// Every formula follows the plain PyTorch version (ops/camera_rays.py,
// ops/trace.py, ops/shading.py, ops/render.py::_shadow_mask) operation
// for operation, in the same order: IEEE division and sqrt (no rsqrt, no
// reciprocal multiply), three-term dot products added left to right, and
// __float2half_rn for the attenuation. Built with -fmad=false the kernels then
// round like the plain version.
#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "traverse.cuh"

namespace rt {

constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = static_cast<float>(2.0 * 3.14159265358979323846);
constexpr int kMatWords = 16;    // albedo3 emission3 metallic ior transmission roughness pad6
constexpr int kLightWords = 16;  // position3 type color3 intensity direction3 pad5
constexpr int kSphereWords = 8;  // center3 radius material(int bits) pad3

__device__ __forceinline__ float max0(float x) { return x > 0.0f ? x : 0.0f; }

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx, float by,
                                      float bz) {
  return ax * bx + ay * by + az * bz;
}

// Camera ray through the pixel centre (unnormalised right / true_up basis in
// cam[6..11], tan(fov/2) in cam[12]).
__device__ __forceinline__ Ray camera_ray(const float* __restrict__ cam, int px, int py,
                                          int width, int height) {
  const float w = static_cast<float>(width), h = static_cast<float>(height);
  const float u = (static_cast<float>(px) + 0.5f) / w;
  const float v = (static_cast<float>(py) + 0.5f) / h;
  const float fov_scale = cam[12];
  const float cx = (u * 2.0f - 1.0f) * (w / h) * fov_scale;
  const float cy = (1.0f - v * 2.0f) * fov_scale;
  float dx = cam[3] + cam[6] * cx + cam[9] * cy;
  float dy = cam[4] + cam[7] * cx + cam[10] * cy;
  float dz = cam[5] + cam[8] * cx + cam[11] * cy;
  const float dlen = sqrtf(dot3(dx, dy, dz, dx, dy, dz));
  dx = dx / dlen;
  dy = dy / dlen;
  dz = dz / dlen;
  return make_ray(cam[0], cam[1], cam[2], dx, dy, dz);
}

// Sphere t along the ray (the near root when it is past MIN_T), and whether it
// lies in (MIN_T, max_t).
__device__ __forceinline__ bool sphere_hit(const float* __restrict__ s, const Ray& r,
                                           float max_t, float& t) {
  const float ocx = r.ox - s[0], ocy = r.oy - s[1], ocz = r.oz - s[2];
  const float rad = s[3];
  const float a = dot3(r.dx, r.dy, r.dz, r.dx, r.dy, r.dz);
  const float b = 2.0f * dot3(ocx, ocy, ocz, r.dx, r.dy, r.dz);
  const float c = dot3(ocx, ocy, ocz, ocx, ocy, ocz) - rad * rad;
  const float disc = b * b - 4.0f * a * c;
  const float sq = sqrtf(fmaxf(disc, 0.0f));
  const float t1 = (-b - sq) / (2.0f * a);
  const float t2 = (-b + sq) / (2.0f * a);
  t = t1 > kMinT ? t1 : t2;
  return disc >= 0.0f && t > kMinT && t < max_t;
}

// The closest hit of a camera ray: point, unit normal, material.
struct Surface {
  float t;
  float px, py, pz;
  float nx, ny, nz;
  int mat;
  int slot;   // winning triangle slot, -1 for a sphere
};

// Spheres exhaustively (first closest wins), then the triangles pruned at the
// sphere t. Returns false on a miss. REL (the camera rays of K3, of K2t and
// of K2 at width 8): the walk reads the camera-relative node records
// `rel_nodes` and triangle rows `rel_tris` of the ray's origin
// (camera_relative.cu); the winner's attributes come from `tris`.
template <int W, int STACK, bool REL = false>
__device__ __forceinline__ bool closest_surface(const Node<W>* __restrict__ nodes,
                                                const float4* __restrict__ tris,
                                                const float* __restrict__ spheres,
                                                int n_spheres, const Ray& ray, Surface& s,
                                                const Node<W>* __restrict__ rel_nodes = nullptr,
                                                const float4* __restrict__ rel_tris = nullptr) {
  float sph_t = kMissT;
  int sph_i = -1;
  for (int k = 0; k < n_spheres; ++k) {
    float t;
    if (sphere_hit(spheres + k * kSphereWords, ray, kMissT, t) && t < sph_t) {
      sph_t = t;
      sph_i = k;
    }
  }
  const TriHit tri = traverse_bvh<W, STACK, false, false, REL>(
      REL ? rel_nodes : nodes, REL ? rel_tris : tris, ray, sph_t);
  const bool use_tri = tri.slot >= 0;
  if (!use_tri && sph_i < 0) return false;
  s.t = use_tri ? tri.t : sph_t;
  s.slot = tri.slot;
  s.px = ray.ox + ray.dx * s.t;
  s.py = ray.oy + ray.dy * s.t;
  s.pz = ray.oz + ray.dz * s.t;
  if (use_tri) {
    tri_attributes(tris, tri.slot, s.nx, s.ny, s.nz, s.mat);
  } else {
    const float* sp = spheres + sph_i * kSphereWords;
    const float snx = s.px - sp[0], sny = s.py - sp[1], snz = s.pz - sp[2];
    const float slen = sqrtf(dot3(snx, sny, snz, snx, sny, snz));
    s.nx = snx / slen;
    s.ny = sny / slen;
    s.nz = snz / slen;
    s.mat = __float_as_int(sp[4]);
  }
  return true;
}

// Intensity of light row L at the surface, times 0 when a shadow ray finds a
// blocker (only traced where the light contributes), before the > 0 gate.
// NEAR_ANY: the width-8 shadow walk in the closest hit's order (walk_bvh).
template <int W, int STACK, bool NEAR_ANY = false>
__device__ __forceinline__ float light_intensity(const float* __restrict__ L, const Surface& s,
                                                 bool shadows, const Node<W>* __restrict__ nodes,
                                                 const float4* __restrict__ tris,
                                                 const float* __restrict__ spheres,
                                                 int n_spheres) {
  const float type = L[3];
  const float intensity = L[7];
  const float ldx = L[8], ldy = L[9], ldz = L[10];
  const float dir_I = max0(dot3(s.nx, s.ny, s.nz, -ldx, -ldy, -ldz)) * intensity;
  const float tlx = L[0] - s.px, tly = L[1] - s.py, tlz = L[2] - s.pz;
  const float dist = sqrtf(dot3(tlx, tly, tlz, tlx, tly, tlz));
  const float plx = tlx / dist, ply = tly / dist, plz = tlz / dist;
  const float atten = __half2float(__float2half_rn(1.0f / (1.0f + dist * dist * 0.01f)));
  const float point_I = max0(dot3(s.nx, s.ny, s.nz, plx, ply, plz)) * intensity * atten;
  const float spot_I = point_I * max0(dot3(-ldx, -ldy, -ldz, plx, ply, plz));
  float I = dir_I * (type == 0.0f ? 1.0f : 0.0f) + point_I * (type == 1.0f ? 1.0f : 0.0f) +
            spot_I * (type == 2.0f ? 1.0f : 0.0f);
  if (shadows && I > 0.0f) {
    const bool directional = type == 0.0f;
    const float sdx = directional ? -ldx : plx;
    const float sdy = directional ? -ldy : ply;
    const float sdz = directional ? -ldz : plz;
    const float smax = directional ? 3.0e38f : dist - 1e-3f;
    const Ray sray = make_ray(s.px + s.nx * 1e-3f, s.py + s.ny * 1e-3f, s.pz + s.nz * 1e-3f,
                              sdx, sdy, sdz);
    bool blocked = false;
    for (int k = 0; k < n_spheres && !blocked; ++k) {
      float st;
      blocked = sphere_hit(spheres + k * kSphereWords, sray, smax, st);
    }
    if (!blocked)
      blocked = traverse_bvh<W, STACK, true, false, false, NEAR_ANY>(nodes, tris, sray, smax)
                    .slot >= 0;
    I = I * (blocked ? 0.0f : 1.0f);
  }
  return I;
}

// Single-sample light selection (ops/shading.py with `light_index`): the one
// light min(int(u * n_lights), n_lights - 1), its shadowed intensity behind
// the > 0 gate and weighted by the light count in `Ig`; returns its row.
template <int W, int STACK, bool NEAR_ANY = false>
__device__ __forceinline__ const float* sampled_light(
    const float* __restrict__ lights, int n_lights, float u, const Surface& s, bool shadows,
    const Node<W>* __restrict__ nodes, const float4* __restrict__ tris,
    const float* __restrict__ spheres, int n_spheres, float& Ig) {
  const int li = min(static_cast<int>(u * static_cast<float>(n_lights)), n_lights - 1);
  const float* L = lights + li * kLightWords;
  const float I =
      light_intensity<W, STACK, NEAR_ANY>(L, s, shadows, nodes, tris, spheres, n_spheres);
  const float gate = I > 0.0f ? 1.0f : 0.0f;
  Ig = (I * gate) * static_cast<float>(n_lights);
  return L;
}

// Texture coordinates of a surface (ops/trace.py::trace): for a triangle its
// Moller-Trumbore barycentrics recomputed once for the winner in the plain
// version's operation order (ops/trace.py::mt_bary) and its corner uvs from the
// per-slot attribute table (uv0, uv1), (uv2, decoded uv density, 0) blended as
// uv0 * (1 - u - v) + uv1 * u + uv2 * v, `density` set to the decoded density;
// for a sphere equirectangular from the unit normal with atan2f / asinf,
// `density` 0.
__device__ __forceinline__ float2 surface_uv(const float4* __restrict__ tris,
                                             const float4* __restrict__ attrs, const Ray& ray,
                                             const Surface& s, float& density) {
  if (s.slot < 0) {
    density = 0.0f;
    return make_float2(0.5f + atan2f(s.nz, s.nx) / kTwoPi,
                       0.5f - asinf(fminf(fmaxf(s.ny, -1.0f), 1.0f)) / kPi);
  }
  const float4 a0 = __ldg(tris + 3 * s.slot + 0);
  const float4 a1 = __ldg(tris + 3 * s.slot + 1);
  const float4 a2 = __ldg(tris + 3 * s.slot + 2);
  // h = d x e2, a = e1 . h, s = o - v0, q = s x e1
  const float hx = ray.dy * a2.z - ray.dz * a2.y;
  const float hy = ray.dz * a2.x - ray.dx * a2.z;
  const float hz = ray.dx * a2.y - ray.dy * a2.x;
  const float a = dot3(a1.x, a1.y, a1.z, hx, hy, hz);
  const float f = 1.0f / (a == 0.0f ? 1.0f : a);
  const float sx = ray.ox - a0.x, sy = ray.oy - a0.y, sz = ray.oz - a0.z;
  const float qx = sy * a1.z - sz * a1.y;
  const float qy = sz * a1.x - sx * a1.z;
  const float qz = sx * a1.y - sy * a1.x;
  const float bu = f * dot3(sx, sy, sz, hx, hy, hz);
  const float bv = f * dot3(ray.dx, ray.dy, ray.dz, qx, qy, qz);
  const float4 t0 = __ldg(attrs + 2 * s.slot);       // uv0, uv1
  const float4 t1 = __ldg(attrs + 2 * s.slot + 1);   // uv2, density, 0
  const float w0 = 1.0f - bu - bv;
  density = t1.z;
  return make_float2(t0.x * w0 + t0.z * bu + t1.x * bv, t0.y * w0 + t0.w * bu + t1.y * bv);
}

// Transmission blend of channel c with the wavelength-dependent IOR
// (offsets -0.018, 0, +0.035; transmitted base 0.2, 0.2, 0.3).
__device__ __forceinline__ float dispersion_blend(float lit, float ior, float trans_raw, int c) {
  const float trans = fminf(fmaxf(trans_raw, 0.0f), 1.0f);
  const float offset = c == 0 ? -0.018f : c == 1 ? 0.0f : 0.035f;
  const float base = c == 2 ? 0.3f : 0.2f;
  const float dispersion = (ior + offset - 1.0f) / (ior - 1.0f);
  const float transmitted = base * dispersion;
  const float blended = lit * (1.0f - trans) + transmitted * trans;
  return trans > 0.0f ? blended : lit;
}

}  // namespace rt
