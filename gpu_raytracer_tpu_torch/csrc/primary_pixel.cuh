// The pixel of K2 and K2t (render_primary.cuh): one camera ray through the
// sphere pass and K1's closest hit, the material, the light loop with its
// shadow rays and the final blend, for one thread. Kept apart from the
// kernel and its launch so that the same function also compiles for the host
// (tests/test_torch_primary_host.py builds it with g++ over stand-ins for the
// CUDA names and holds it to the plain version bit for bit).
//
// Width 8 (K2 w8, K2t w8) and the textured instance at width 4 (K2t) are
// laid out for what the H100 rewards in this issue-bound walk, each choice
// read on an NVIDIA H100 80GB HBM3 (PERF.md, chip_ab.py --w8-frames, --k2t):
//   * REL: the camera walk reads the camera-relative tables of K3's pre-pass
//     (camera_relative.cu; traverse.cuh REL), which the wrapper launches
//     before every width-8 K2 / K2t launch and every width-4 K2t launch:
//     the same visits, tests and winners for fewer instructions a visit and
//     a test (width 8's node / triangle loop 481 / 155 -> 431 / 121 SASS
//     instructions, the kernels 8-9% faster without shadows, 13-14% with
//     them; width 4's 206 / 155 -> 182 / 121, K2t 8-10% faster);
//   * SPLIT: only what the light loop reads stays live across its shadow
//     walks: the albedo and the metallic that sets the brdf are taken before
//     the loop (textured: the base-colour and metallic-roughness maps), the
//     emission, IOR, transmission and occlusion after it (the material row
//     read again from L1; textured: the occlusion and emissive maps sampled
//     then, one map at a time). Each value keeps its own operations in the
//     same order, so the same bits as the one material step before the loop;
//   * NEAR_ANY: the shadow walk's order, per kernel (below); width 4 keeps
//     the near-first any hit (the unranked one is width 8's).
// Width 4's K2 takes none of them: it keeps the machine code measured
// before them (PERF.md), as do K1, K3, K4 and K6.
#pragma once

#include "render_common.cuh"
#include "texsample.cuh"

namespace rt {

// The width-8 shadow walks of K2 (kPrimaryNearAnyW8) and K2t
// (kPrimaryNearAnyTexturedW8): 1 keeps the closest hit's near-first order
// (render_common.cuh NEAR_ANY), 0 takes the other kernels' any-hit walk
// (the nearest entered, the others in stored order; node loop 476 -> 323).
// K2 w8 takes 0 (2% faster with shadows, as fast without); K2t w8 keeps 1:
// with 0 its frames read 4% faster with shadows but 1.6% slower without,
// the same camera walk and spill (code layout). `chip_ab.py --w8-frames
// --variants kName=VALUE` reads the other one.
constexpr int kPrimaryNearAnyW8 = 0;
constexpr int kPrimaryNearAnyTexturedW8 = 1;
// Whether instance (W, TEXTURED) takes REL, SPLIT (the pixel's defaults):
// K2 w8 and K2t at both widths walk the camera-relative tables, which the
// wrapper's pre-pass writes before each of their launches, and split their
// material step around the light loop; K2 at width 4 does neither.
template <int W, bool TEXTURED>
constexpr bool kPrimaryRel = W == 8 || TEXTURED;
template <int W, bool TEXTURED>
constexpr bool kPrimarySplit = W == 8 || TEXTURED;

// What the textured instance reads beside the untextured one's arguments.
struct PrimaryTextures {
  const float4* attrs;    // per-slot uv records (ops/cuda/traverse.py)
  const TexMeta* maps;    // [n_mats, 4] (ops/cuda/texshade.py)
  const int2* atlas;      // texel pairs
  int present;            // bit k: map slot k is sampled
  int n_levels;           // longest mip chain of the atlas
  float pix_scale;        // 2 tan(fov/2) / height
};

// The map slots of `mask` that the textures sample and material `mid`
// holds, at the nearest mip of footprint `lam`, applied to `m` one map
// after the other (texsample.cuh sample_material without OVERLAP: each
// field changed by one map, so the same bits as all maps at once). With
// each half's maps in flight together K2t w8 spilled 184 bytes and read 4%
// slower (PERF.md).
__device__ __forceinline__ void apply_maps(MaterialSample& m, const PrimaryTextures& tex,
                                           int mask, int mid, float u, float v, float lam) {
  if (RT_SAMPLER_OFF) return;
#pragma unroll
  for (int k = 0; k < kMapSlots; ++k) {
    if (!(((tex.present & mask) >> k) & 1)) continue;
    const TexMeta t = tex.maps[mid * kMapSlots + k];
    if (t.has)
      apply_map(m, k, finish_sample<kLodNearest>(
                          begin_sample<kLodNearest>(tex.maps, tex.atlas, t, u, v, lam,
                                                    tex.n_levels), tex.n_levels));
  }
}

// Pixel i of a launch: (px[i], py[i]) rendered into rgb[3i .. 3i + 2].
// REL: the camera walk over `rel_nodes` / `rel_tris` (the camera-relative
// tables of `cam`); SPLIT: the material step split around the light loop.
template <int W, int STACK, bool TEXTURED, bool REL = kPrimaryRel<W, TEXTURED>,
          bool SPLIT = kPrimarySplit<W, TEXTURED>>
__device__ __forceinline__ void primary_pixel(
    const Node<W>* __restrict__ nodes, const float4* __restrict__ tris,
    const float* __restrict__ cam, const float* __restrict__ mats, int n_mats,
    const float* __restrict__ lights, int n_lights, const float* __restrict__ spheres,
    int n_spheres, const PrimaryTextures tex, const int* __restrict__ px,
    const int* __restrict__ py, int i, int width, int height, int shadows, float sky_r,
    float sky_g, float sky_b, const float* __restrict__ light_u, float* __restrict__ rgb,
    const Node<W>* __restrict__ rel_nodes, const float4* __restrict__ rel_tris) {
  const Ray ray = camera_ray(cam, px[i], py[i], width, height);
  Surface s;
  if (!closest_surface<W, STACK, REL>(nodes, tris, spheres, n_spheres, ray, s, rel_nodes,
                                      rel_tris)) {
    rgb[3 * i] = sky_r;
    rgb[3 * i + 1] = sky_g;
    rgb[3 * i + 2] = sky_b;
    return;
  }

  // ---- material: whole, or (SPLIT) what the light loop reads ----
  const int mid = min(max(s.mat, 0), n_mats - 1);
  float u = 0.0f, v = 0.0f, lam = 0.0f;
  if (TEXTURED) {
    float density;
    const float2 uv = surface_uv(tris, tex.attrs, ray, s, density);
    u = uv.x;
    v = uv.y;
    lam = s.slot >= 0 ? s.t * tex.pix_scale * density : 0.0f;
  }
  MaterialSample m;
  if constexpr (SPLIT) {
    const float* row = mats + mid * kMatWords;
#pragma unroll
    for (int c = 0; c < 3; ++c) m.albedo[c] = row[c];
    m.metallic = row[6];
    m.roughness = row[9];   // K2 reads no roughness: for the metallic-roughness map
    if constexpr (TEXTURED)
      apply_maps(m, tex, (1 << kMapBaseColor) | (1 << kMapMetallicRoughness), mid, u, v, lam);
  } else {
    m = sample_material<true>(mats, TEXTURED ? tex.maps : nullptr, tex.atlas, tex.present,
                              tex.n_levels, mid, u, v, lam);
  }
  const float is_metal = m.metallic > 0.5f ? 1.0f : 0.0f;
  const float brdf = is_metal * 0.5f + (1.0f - is_metal) / kPi;

  // ---- direct lighting: every light in light order, or the one sampled ----
  // (NEAR_ANY orders width 8's shadow walk only; width 4 keeps its argument)
  constexpr bool NEAR_ANY =
      W != 8 || (TEXTURED ? kPrimaryNearAnyTexturedW8 : kPrimaryNearAnyW8) == 1;
  float sum[3] = {0.0f, 0.0f, 0.0f};
  if (light_u != nullptr) {
    float Ig;
    const float* L = sampled_light<W, STACK, NEAR_ANY>(
        lights, n_lights, light_u[i], s, shadows != 0, nodes, tris, spheres, n_spheres, Ig);
#pragma unroll
    for (int c = 0; c < 3; ++c) sum[c] = m.albedo[c] * brdf * Ig * L[4 + c];
  } else {
    for (int li = 0; li < n_lights; ++li) {
      const float* L = lights + li * kLightWords;
      const float I = light_intensity<W, STACK, NEAR_ANY>(L, s, shadows != 0, nodes, tris,
                                                        spheres, n_spheres);
      const float gate = I > 0.0f ? 1.0f : 0.0f;
#pragma unroll
      for (int c = 0; c < 3; ++c) sum[c] = sum[c] + m.albedo[c] * brdf * (I * gate) * L[4 + c];
    }
  }

  // ---- (SPLIT) the rest of the material, after the shadow walks ----
  if constexpr (SPLIT) {
    const float* row = mats + mid * kMatWords;
#pragma unroll
    for (int c = 0; c < 3; ++c) m.emission[c] = row[3 + c];
    m.ior = row[7];
    m.transmission = row[8];
    m.occlusion = 1.0f;
    if constexpr (TEXTURED)
      apply_maps(m, tex, (1 << kMapOcclusion) | (1 << kMapEmissive), mid, u, v, lam);
  }

  // ---- ambient + lights + emission, transmission blend with dispersion ----
  const bool invalid = s.mat < 0 || s.mat >= n_mats;
  const bool with_occlusion = TEXTURED && ((tex.present >> kMapOcclusion) & 1);
  const float magenta[3] = {1.0f, 0.0f, 1.0f};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float ambient = m.albedo[c] * 0.1f;
    if (with_occlusion) ambient = ambient * m.occlusion;
    const float lit = ambient + sum[c] + m.emission[c];
    rgb[3 * i + c] = invalid ? magenta[c] : dispersion_blend(lit, m.ior, m.transmission, c);
  }
}

}  // namespace rt
