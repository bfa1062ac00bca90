// Texture sampling device functions over the guard-band atlas, one ray per
// thread: the device form of the plain sampler ops/texture.py, formula for
// formula and in the same order. Used by the texture shade kernel (K4,
// texshade.cu) and, through `sample_material` (K5), by the path tracer's
// bounce (K6, bounce.cuh) and the textured primary render (K2t,
// render_primary.cuh).
//
// Atlas layout (models/geometry.py::Textures): 128-texel rows of 127 texels
// plus one guard texel repeating the wrap neighbour, one guard row per
// texture level, so the bilinear quad of base address a is always a, a + 1,
// a + srows*128, a + srows*128 + 1. The wrap applies to the base texel only,
// with integer math, and the four taps are two direct 32-bit loads from each
// of two atlas rows. No texture object: its filtering uses 8-bit fixed-point
// weights, not the f32 formula the plain version evaluates.
#pragma once

#include <cuda_runtime.h>

namespace rt {

constexpr int kTexChunk = 127;     // texels per atlas row, the 128th is a guard
constexpr int kMapSlots = 4;       // base colour, metallic-roughness, occlusion, emissive
constexpr int kMapBaseColor = 0;
constexpr int kMapMetallicRoughness = 1;
constexpr int kMapOcclusion = 2;
constexpr int kMapEmissive = 3;

// One texture as one material slot sees it (ops/cuda/texshade.py maps table).
struct __align__(16) TexMeta {
  int has;       // the slot holds a texture index
  int off_row;   // atlas row of level 0's texel (0, 0)
  int srows;     // atlas rows per level-0 texture row
  int w, h;      // level-0 size
  int wrap;      // 0 REPEAT, 1 CLAMP_TO_EDGE, 2 MIRRORED_REPEAT
  int levels;    // mip chain length
  int pad;
};
static_assert(sizeof(TexMeta) == 32, "TexMeta must match the 8-word host record");

struct TexLevel {
  int w, h, srows, off_row;
};

__device__ __forceinline__ int floor_mod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

// Integer texel coordinate wrapped to [0, size).
__device__ __forceinline__ int wrap_coord(int c, int size, int mode) {
  size = max(size, 1);
  if (mode == 1) return min(max(c, 0), size - 1);
  if (mode == 2) {
    const int per = floor_mod(c, 2 * size);
    return per < size ? per : 2 * size - 1 - per;
  }
  return floor_mod(c, size);
}

// Level `lod` (already clamped to the chain) of a texture: level l+1 starts
// (h_l + 1) * srows_l rows after level l, with halved sizes.
__device__ __forceinline__ TexLevel tex_level(const TexMeta& m, int lod) {
  TexLevel L{m.w, m.h, m.srows, m.off_row};
  for (int l = 1; l <= lod; ++l) {
    L.off_row += (L.h + 1) * L.srows;
    L.w = max(L.w / 2, 1);
    L.h = max(L.h / 2, 1);
    L.srows = (L.w + kTexChunk - 1) / kTexChunk;
  }
  return L;
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

// One axis of the tap setup: the wrapped base texel and its weight, with the
// CLAMP low-edge collapse and the MIRRORED reflected-period flip.
__device__ __forceinline__ void tap_axis(int c0, int size, int mode, float& f, int& cw) {
  cw = wrap_coord(c0, size, mode);
  if (mode == 1 && c0 < 0) f = 0.0f;
  const bool flip = mode == 2 && floor_mod(c0, 2 * max(size, 1)) >= max(size, 1);
  if (flip) {
    f = cw == 0 ? 0.0f : 1.0f - f;
    cw = max(cw - 1, 0);
  }
}

__device__ __forceinline__ float texel_byte(int t, int c) {
  return static_cast<float>((static_cast<unsigned>(t) >> (8 * c)) & 0xFFu);
}

// Bilinear RGBA in [0, 1] at uv on one level: each row's pair blended
// horizontally, then the two rows vertically, then scaled by 1/255.
__device__ __forceinline__ float4 bilinear(const int* __restrict__ atlas, const TexLevel& L,
                                           int mode, float u, float v) {
  const float uf = u * static_cast<float>(L.w) - 0.5f;
  const float vf = v * static_cast<float>(L.h) - 0.5f;
  const float x0f = floorf(uf), y0f = floorf(vf);
  float fx = uf - x0f, fy = vf - y0f;
  int xw, yw;
  tap_axis(static_cast<int>(x0f), L.w, mode, fx, xw);
  tap_axis(static_cast<int>(y0f), L.h, mode, fy, yw);
  const int k = xw / kTexChunk;
  const int a = (L.off_row + yw * L.srows + k) * 128 + (xw - k * kTexChunk);
  const int b = a + L.srows * 128;
  const int t00 = __ldg(atlas + a), t01 = __ldg(atlas + a + 1);
  const int t10 = __ldg(atlas + b), t11 = __ldg(atlas + b + 1);
  const float gx = 1.0f - fx, gy = 1.0f - fy;
  const float inv255 = 1.0f / 255.0f;
  float out[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float top = texel_byte(t00, c) * gx + texel_byte(t01, c) * fx;
    const float bot = texel_byte(t10, c) * gx + texel_byte(t11, c) * fx;
    out[c] = (top * gy + bot * fy) * inv255;
  }
  return make_float4(out[0], out[1], out[2], out[3]);
}

// A texture sampled at uv as primary shading samples it: bilinear at level 0
// of a single-level atlas, else at the nearest mip of the footprint `lam`,
// or (trilinear) blended between the two levels around it, the level split
// taken as the footprint's exponent and mantissa.
__device__ __forceinline__ float4 sample_map(const int* __restrict__ atlas, const TexMeta& m,
                                             float u, float v, float lam, int n_levels,
                                             bool trilinear) {
  if (n_levels <= 1) return bilinear(atlas, tex_level(m, 0), m.wrap, u, v);
  if (!trilinear) return bilinear(atlas, tex_level(m, nearest_lod(m, lam)), m.wrap, u, v);
  const int bits = __float_as_int(footprint(m, lam));
  const float e = static_cast<float>((bits >> 23) - 127);
  const float mant = static_cast<float>(bits & 0x7FFFFF) * 1.1920928955078125e-07f;  // 2^-23
  const float lv = static_cast<float>(m.levels);
  const float l0 = fminf(fmaxf(e, 0.0f), lv - 1.0f);
  const float frac = (e >= 0.0f && e < lv - 1.0f) ? mant : 0.0f;
  const float l1 = fminf(l0 + 1.0f, lv - 1.0f);
  const float4 r0 = bilinear(atlas, tex_level(m, static_cast<int>(l0)), m.wrap, u, v);
  const float4 r1 = bilinear(atlas, tex_level(m, static_cast<int>(l1)), m.wrap, u, v);
  const float g = 1.0f - frac;
  return make_float4(r0.x * g + r1.x * frac, r0.y * g + r1.y * frac, r0.z * g + r1.z * frac,
                     r0.w * g + r1.w * frac);
}

// A texture sampled bilinearly at an explicit level `lod` (clamped to the
// texture's chain and truncated), the path tracer's bounce LOD; level 0 of a
// single-level atlas.
__device__ __forceinline__ float4 sample_map_lod(const int* __restrict__ atlas, const TexMeta& m,
                                                 float u, float v, float lod, int n_levels) {
  if (n_levels <= 1) return bilinear(atlas, tex_level(m, 0), m.wrap, u, v);
  const float l = fminf(fmaxf(lod, 0.0f), static_cast<float>(m.levels) - 1.0f);
  return bilinear(atlas, tex_level(m, static_cast<int>(l)), m.wrap, u, v);
}

// K5: the material of a hit as the path tracer's bounce and the textured
// primary render need it.
//
// Replaces the TPU kernel's subroutine gpu_raytracer_tpu/ops/pallas/texshade.py
// sample_materials_tiles (:506), which looks up material rows by one-hot matrix
// products and samples the atlas tile by tile. Here one thread reads its
// material row (ops/cuda/render.py material_rows: albedo, emission, metallic,
// IOR, transmission, roughness) and samples each map slot that some material
// uses and its own material holds, at the fixed level `x` (FOOTPRINT false,
// the bounce's LOD) or at the nearest mip level of the ray's own footprint
// `x` (FOOTPRINT true, the primary render, as `sample_map` picks it for the
// texture shade kernel): base colour
// scales the albedo, emissive the emission, the metallic-roughness map's B the
// metallic and its G the roughness, occlusion's R is the ambient factor
// (1 without). Each map is sampled once. Its plain version is
// ops/shading.py::sample_materials. Bound by the latency of the 4 texel loads
// per sampled map (L2-resident atlas rows), like the texture shade kernel.
struct MaterialSample {
  float albedo[3];
  float emission[3];
  float metallic, roughness, ior, transmission, occlusion;
};

template <bool FOOTPRINT>
__device__ __forceinline__ MaterialSample sample_material(
    const float* __restrict__ mats, const TexMeta* __restrict__ maps,
    const int* __restrict__ atlas, int present, int n_levels, int mid, float u, float v,
    float x) {
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
  if (maps == nullptr) return m;
  for (int k = 0; k < kMapSlots; ++k) {
    if (!((present >> k) & 1)) continue;
    const TexMeta t = maps[mid * kMapSlots + k];
    if (!t.has) continue;   // the plain sampler's factor is exactly 1
    const float4 s = FOOTPRINT ? sample_map(atlas, t, u, v, x, n_levels, false)
                               : sample_map_lod(atlas, t, u, v, x, n_levels);
    if (k == kMapBaseColor) {
      m.albedo[0] = m.albedo[0] * s.x;
      m.albedo[1] = m.albedo[1] * s.y;
      m.albedo[2] = m.albedo[2] * s.z;
    } else if (k == kMapEmissive) {
      m.emission[0] = m.emission[0] * s.x;
      m.emission[1] = m.emission[1] * s.y;
      m.emission[2] = m.emission[2] * s.z;
    } else if (k == kMapMetallicRoughness) {
      m.metallic = m.metallic * s.z;     // B channel
      m.roughness = m.roughness * s.y;   // G channel
    } else {
      m.occlusion = s.x;                 // R channel
    }
  }
  return m;
}

}  // namespace rt
