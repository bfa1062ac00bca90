// Texture sampling device functions over the guard-band atlas, one ray per
// thread: the device form of the plain sampler ops/texture.py, formula for
// formula and in the same order, so every sample is bit-equal to it. Used by
// the texture shade kernel (K4, texshade.cu) and, through `sample_material`
// (K5), by the path tracer's bounce (K6, bounce.cuh), the textured primary
// render (K2t, render_primary.cuh) and K5's standalone launch (materials.cu).
//
// Atlas layout (models/geometry.py::Textures): 128-texel rows of 127 texels
// plus one guard texel repeating the wrap neighbour, one guard row per
// texture level, so the bilinear quad of base address a is always a, a + 1,
// a + srows*128, a + srows*128 + 1. The wrap applies to the base texel only,
// with integer math. No texture object: its filtering uses 8-bit fixed-point
// weights, not the f32 formula the plain version evaluates.
//
// Shaped for the H100 (ops/cuda/texshade.py lays out the tables):
//   * a mip level is one 16-byte record made at pack time (offset row, size,
//     srows), not a walk of the chain per sample, so lanes at different
//     levels run the same instructions;
//   * a wrap is a mask where the level's size is a power of two (every map
//     of the courtyard and the zoos), the general floor_mod otherwise, with
//     the same integers either way;
//   * the atlas holds texel pairs (a, a+1), so each row of a quad is one
//     aligned 8-byte load: two loads per bilinear sample, not four;
//   * every sampled map's loads are issued before any map is blended, so
//     their latencies overlap; bytes convert to float by byte-select (exact).
// A sample is bound by the latency of its dependent loads (metadata, level
// record, texels; all L1/L2-resident), not by bandwidth or arithmetic.
#pragma once

#include <cuda_runtime.h>

// 1: every kernel reads every map slot as absent, the material rows alone (a
// timing reading of the launches without the sampler, chip_ab.py --variants).
#ifndef RT_SAMPLER_OFF
#define RT_SAMPLER_OFF 0
#endif

namespace rt {

constexpr int kTexChunk = 127;     // texels per atlas row, the 128th is a guard
constexpr int kMapSlots = 4;       // base colour, metallic-roughness, occlusion, emissive
constexpr int kMapBaseColor = 0;
constexpr int kMapMetallicRoughness = 1;
constexpr int kMapOcclusion = 2;
constexpr int kMapEmissive = 3;

// How a sample picks its mip level.
constexpr int kLodExplicit = 0;    // x is the level (the path tracer's bounce LOD)
constexpr int kLodNearest = 1;     // x is the footprint: its nearest level
constexpr int kLodTrilinear = 2;   // x is the footprint: the two levels around it, blended

// One texture as one material slot sees it (ops/cuda/texshade.py maps table).
struct __align__(16) TexMeta {
  int has;       // the slot holds a texture index
  int off_row;   // atlas row of level 0's texel (0, 0)
  int srows;     // atlas rows per level-0 texture row
  int w, h;      // level-0 size
  int wrap;      // 0 REPEAT, 1 CLAMP_TO_EDGE, 2 MIRRORED_REPEAT
  int levels;    // mip chain length
  int level0;    // the texture's level-0 TexLevel, in 16-byte records from the table's start
};
static_assert(sizeof(TexMeta) == 32, "TexMeta must match the 8-word host record");

// One mip level (ops/cuda/texshade.py::level_records).
struct TexLevel {
  int off_row, w, h, srows;
};

// Level `lod` of texture `m`: record m.level0 + lod of the table.
__device__ __forceinline__ TexLevel load_level(const TexMeta* __restrict__ table,
                                               const TexMeta& m, int lod) {
  const int4 r = __ldg(reinterpret_cast<const int4*>(table) + m.level0 + lod);
  return TexLevel{r.x, r.y, r.z, r.w};
}

__device__ __forceinline__ int floor_mod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

// floor_mod(c, m) for m >= 1: a mask where m is a power of two (two's
// complement makes it exact for negative c too), a division otherwise.
__device__ __forceinline__ int wrap_mod(int c, int m) {
  return (m & (m - 1)) == 0 ? (c & (m - 1)) : floor_mod(c, m);
}

// One axis of the tap setup: the wrapped base texel and its weight, with the
// CLAMP low-edge collapse and the MIRRORED reflected-period flip.
__device__ __forceinline__ void tap_axis(int c0, int size, int mode, float& f, int& cw) {
  const int n = max(size, 1);
  if (mode == 1) {
    cw = min(max(c0, 0), n - 1);
    if (c0 < 0) f = 0.0f;
  } else if (mode == 2) {
    const int per = wrap_mod(c0, 2 * n);
    cw = per < n ? per : 2 * n - 1 - per;
    if (per >= n) {   // a reflected period: the +1 neighbour is at cw - 1
      f = cw == 0 ? 0.0f : 1.0f - f;
      cw = max(cw - 1, 0);
    }
  } else {
    cw = wrap_mod(c0, n);
  }
}

// A bilinear quad in flight: each row's two taps (one 8-byte load of the pair
// atlas) and the two weights.
struct Quad {
  int2 top, bot;
  float fx, fy;
};

__device__ __forceinline__ Quad fetch_quad(const int2* __restrict__ atlas, const TexLevel& L,
                                           int mode, float u, float v) {
  const float uf = u * static_cast<float>(L.w) - 0.5f;
  const float vf = v * static_cast<float>(L.h) - 0.5f;
  const float x0f = floorf(uf), y0f = floorf(vf);
  Quad q;
  q.fx = uf - x0f;
  q.fy = vf - y0f;
  int xw, yw;
  tap_axis(static_cast<int>(x0f), L.w, mode, q.fx, xw);
  tap_axis(static_cast<int>(y0f), L.h, mode, q.fy, yw);
  const int k = xw / kTexChunk;
  const int a = (L.off_row + yw * L.srows + k) * 128 + (xw - k * kTexChunk);
  q.top = __ldg(atlas + a);
  q.bot = __ldg(atlas + a + L.srows * 128);
  return q;
}

__device__ __forceinline__ float texel_byte(int t, int c) {
  return static_cast<float>(__byte_perm(static_cast<unsigned>(t), 0u, 0x4440u | c));
}

// RGBA in [0, 1] of a quad: each row's pair blended horizontally, then the
// two rows vertically, then scaled by 1/255.
__device__ __forceinline__ float4 blend(const Quad& q) {
  const float gx = 1.0f - q.fx, gy = 1.0f - q.fy;
  const float inv255 = 1.0f / 255.0f;
  float out[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float top = texel_byte(q.top.x, c) * gx + texel_byte(q.top.y, c) * q.fx;
    const float bot = texel_byte(q.bot.x, c) * gx + texel_byte(q.bot.y, c) * q.fx;
    out[c] = (top * gy + bot * q.fy) * inv255;
  }
  return make_float4(out[0], out[1], out[2], out[3]);
}

__device__ __forceinline__ float footprint(const TexMeta& m, float lam) {
  return fmaxf(lam * static_cast<float>(m.w), 1e-20f);
}

// Nearest mip level: floor(log2(lam * w * sqrt2)) from the f32 exponent,
// clamped to the chain.
__device__ __forceinline__ int nearest_lod(const TexMeta& m, float lam) {
  const int e = (__float_as_int(footprint(m, lam) * 1.4142135f) >> 23) - 127;
  return min(max(e, 0), m.levels - 1);
}

// One map sample in flight: its quad(s) with the loads issued, and the
// trilinear blend weight of the second.
struct MapFetch {
  Quad q0;
  Quad q1;       // kLodTrilinear only
  float frac;
};

// Issue the loads of texture `m` sampled at uv: at level 0 of a single-level
// atlas; else at the level LOD picks from x (kLodExplicit: x clamped to the
// chain and truncated; kLodNearest: the nearest level of the footprint x;
// kLodTrilinear: the two levels around it, split by the footprint's exponent
// and mantissa).
template <int LOD>
__device__ __forceinline__ MapFetch begin_sample(const TexMeta* __restrict__ table,
                                                 const int2* __restrict__ atlas,
                                                 const TexMeta& m, float u, float v, float x,
                                                 int n_levels) {
  MapFetch f;
  f.frac = 0.0f;
  if (n_levels <= 1) {
    f.q0 = fetch_quad(atlas, load_level(table, m, 0), m.wrap, u, v);
  } else if (LOD == kLodExplicit) {
    const float l = fminf(fmaxf(x, 0.0f), static_cast<float>(m.levels) - 1.0f);
    f.q0 = fetch_quad(atlas, load_level(table, m, static_cast<int>(l)), m.wrap, u, v);
  } else if (LOD == kLodNearest) {
    f.q0 = fetch_quad(atlas, load_level(table, m, nearest_lod(m, x)), m.wrap, u, v);
  } else {
    const int bits = __float_as_int(footprint(m, x));
    const float e = static_cast<float>((bits >> 23) - 127);
    const float mant = static_cast<float>(bits & 0x7FFFFF) * 1.1920928955078125e-07f;  // 2^-23
    const float lv = static_cast<float>(m.levels);
    const float l0 = fminf(fmaxf(e, 0.0f), lv - 1.0f);
    f.frac = (e >= 0.0f && e < lv - 1.0f) ? mant : 0.0f;
    const float l1 = fminf(l0 + 1.0f, lv - 1.0f);
    const TexLevel L0 = load_level(table, m, static_cast<int>(l0));
    const TexLevel L1 = load_level(table, m, static_cast<int>(l1));
    f.q0 = fetch_quad(atlas, L0, m.wrap, u, v);
    f.q1 = fetch_quad(atlas, L1, m.wrap, u, v);
  }
  return f;
}

template <int LOD>
__device__ __forceinline__ float4 finish_sample(const MapFetch& f, int n_levels) {
  const float4 r0 = blend(f.q0);
  if (LOD != kLodTrilinear || n_levels <= 1) return r0;
  const float4 r1 = blend(f.q1);
  const float g = 1.0f - f.frac;
  return make_float4(r0.x * g + r1.x * f.frac, r0.y * g + r1.y * f.frac,
                     r0.z * g + r1.z * f.frac, r0.w * g + r1.w * f.frac);
}

// Every map slot that `present` marks and material `mid` holds a texture in,
// sampled at uv: all slots' metadata, then all level records and texel loads,
// then the blends. Returns the slots sampled as a bitmask; s[k] is slot k's
// RGBA where its bit is set. (Keeping only each slot's level record and wrap
// between the passes measured 2-6 more registers in the bounce kernel's
// textured instances, a block an SM fewer, 4% slower: PERF.md.)
template <int LOD>
__device__ __forceinline__ int sample_maps(const TexMeta* __restrict__ maps,
                                           const int2* __restrict__ atlas, int present,
                                           int n_levels, int mid, float u, float v, float x,
                                           float4 (&s)[kMapSlots]) {
  if (RT_SAMPLER_OFF) return 0;
  TexMeta t[kMapSlots];
  int held = 0;
#pragma unroll
  for (int k = 0; k < kMapSlots; ++k) {
    if ((present >> k) & 1) {
      t[k] = maps[mid * kMapSlots + k];
      if (t[k].has) held |= 1 << k;   // else the plain sampler's factor is exactly 1
    }
  }
  MapFetch f[kMapSlots];
#pragma unroll
  for (int k = 0; k < kMapSlots; ++k)
    if ((held >> k) & 1) f[k] = begin_sample<LOD>(maps, atlas, t[k], u, v, x, n_levels);
#pragma unroll
  for (int k = 0; k < kMapSlots; ++k)
    if ((held >> k) & 1) s[k] = finish_sample<LOD>(f[k], n_levels);
  return held;
}

// K5: the material of a hit as the path tracer's bounce and the textured
// primary render need it.
//
// Replaces the TPU kernel's subroutine gpu_raytracer_tpu/ops/pallas/texshade.py
// sample_materials_tiles (:506), which looks up material rows by one-hot matrix
// products and samples the atlas tile by tile. Here one thread reads its
// material row (ops/cuda/render.py material_rows: albedo, emission, metallic,
// IOR, transmission, roughness) and samples each map slot that some material
// uses and its own material holds (`sample_maps`), at the fixed level `x`
// (FOOTPRINT false, the bounce's LOD) or at the nearest mip level of the
// ray's own footprint `x` (FOOTPRINT true, the primary render): base colour
// scales the albedo, emissive the emission, the metallic-roughness map's B the
// metallic and its G the roughness, occlusion's R is the ambient factor
// (1 without). Each map is sampled once. Its plain version is
// ops/shading.py::sample_materials.
struct MaterialSample {
  float albedo[3];
  float emission[3];
  float metallic, roughness, ior, transmission, occlusion;
};

// What map slot k's RGBA `s` does to a material sample: base colour scales
// the albedo, emissive the emission, the metallic-roughness map's B the
// metallic and its G the roughness, occlusion's R is the ambient factor.
__device__ __forceinline__ void apply_map(MaterialSample& m, int k, const float4& s) {
  if (k == kMapBaseColor) {
    m.albedo[0] = m.albedo[0] * s.x;
    m.albedo[1] = m.albedo[1] * s.y;
    m.albedo[2] = m.albedo[2] * s.z;
  } else if (k == kMapMetallicRoughness) {
    m.metallic = m.metallic * s.z;     // B channel
    m.roughness = m.roughness * s.y;   // G channel
  } else if (k == kMapOcclusion) {
    m.occlusion = s.x;                 // R channel
  } else {
    m.emission[0] = m.emission[0] * s.x;
    m.emission[1] = m.emission[1] * s.y;
    m.emission[2] = m.emission[2] * s.z;
  }
}

// OVERLAP: every map's loads in flight together (`sample_maps`), then each
// applied. Else one map after the other, each applied as soon as it is
// blended, so one map's quads and no sampled colour are live at a time: the
// bounce kernel's all-lights instances take it, where the light loop that
// follows needs the registers more (PERF.md). Both give the same bits: each
// field is changed by one map only.
template <bool FOOTPRINT, bool OVERLAP = true>
__device__ __forceinline__ MaterialSample sample_material(
    const float* __restrict__ mats, const TexMeta* __restrict__ maps,
    const int2* __restrict__ atlas, int present, int n_levels, int mid, float u, float v,
    float x) {
  constexpr int LOD = FOOTPRINT ? kLodNearest : kLodExplicit;
  const float* row = mats + mid * 16;
  MaterialSample m;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    m.albedo[c] = row[c];
    m.emission[c] = row[3 + c];
  }
  m.metallic = row[6];
  m.ior = row[7];
  m.transmission = row[8];
  m.roughness = row[9];
  m.occlusion = 1.0f;
  if (maps == nullptr || RT_SAMPLER_OFF) return m;
  if (!OVERLAP) {
#pragma unroll
    for (int k = 0; k < kMapSlots; ++k) {
      if (!((present >> k) & 1)) continue;
      const TexMeta t = maps[mid * kMapSlots + k];
      if (t.has)
        apply_map(m, k, finish_sample<LOD>(begin_sample<LOD>(maps, atlas, t, u, v, x, n_levels),
                                           n_levels));
    }
    return m;
  }
  float4 s[kMapSlots];
  const int held = sample_maps<LOD>(maps, atlas, present, n_levels, mid, u, v, x, s);
#pragma unroll
  for (int k = 0; k < kMapSlots; ++k)
    if ((held >> k) & 1) apply_map(m, k, s[k]);
  return m;
}

}  // namespace rt
