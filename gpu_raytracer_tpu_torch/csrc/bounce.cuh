// K6: one wavefront bounce of the path tracer's ray pool, one ray per thread.
//
// Replaces the TPU kernel gpu_raytracer_tpu/ops/pallas/bounce.py pallas_bounce
// -> _kernel (pallas_call at :505), which runs a 1024-8192-ray packet per
// program over VMEM-resident pool tiles. Here every thread owns one lane of
// the pool (ops/wavefront.py WavefrontRays, structure of arrays):
//   a dead lane is not visited; a live lane traces its closest hit (render_common.cuh
//   closest_surface: the sphere pass, then K1 pruned at the sphere's t), adds
//   sky x throughput on a miss; on a hit it reads the material (the row, or
//   on a textured scene K5 `sample_material` at the launch's fixed mip level,
//   with the triangle or sphere uv of render_common.cuh surface_uv), lights
//   it (ambient + every light through K1 shadow rays, or with single-light
//   next-event estimation one light picked by u6, weighted by the light
//   count, one shadow ray from p + n * 1e-3 along the geometric normal),
//   adds emission, the dispersion blend and magenta for an invalid
//   material, and adds shading x throughput. Unless this is the last depth
//   it then samples the continuation: a cosine lobe about the faced normal
//   (Duff's orthonormal basis), a mirror lobe widened by roughness (absorbed
//   when it leaves below the surface), or Fresnel glass with the
//   wavelength's IOR and total internal reflection; a full-RGB ray (channel
//   3) meeting glass collapses to channel min(floor(u5 * 3), 2) with a 3x
//   one-hot throughput; Russian roulette keeps a lane with probability
//   clamp(max throughput, 0.05, 0.95) and divides by it.
//
// Every formula follows the plain version (ops/wavefront.py::bounce, with
// ops/sampling.py and ops/shading.py) operation for operation, in the same
// order: IEEE division and sqrt, libdevice sinf / cosf / atan2f / asinf,
// NaN-propagating max and clamp where PyTorch's amax and clamp propagate NaN.
// Built with -fmad=false it then rounds like the plain version run on the card.
//
// Launch flags are template parameters, so each launch compiles to the
// branches it takes: the node records' width (4 or 8, the width-8 instances in
// bounce_w8.cu and bounce_textured_w8.cu), the traversal stack, textured or
// not, the lighting mode
// (none, every light, one sampled light) and the continuation (none at the
// last depth, with or without roulette). Where the uniforms come from is a
// runtime branch on a pointer that is the same for the whole launch.
//
// The pool is updated in place, and only its live lanes are touched. A launch
// takes `order` (sorted position -> lane, the coherence sort of
// ops/wavefront.py::_sort_perm with dead lanes last; null: position = lane)
// and `n_live` (a count on the device; null: every position). Thread i past
// n_live returns before it reads anything; thread i works on lane order[i]:
// it reads that lane, adds its radiance to radiance[lane], writes the
// continuation over the lane when it survives and otherwise only clears
// active[lane]. Nothing is copied for a dead lane and nothing is permuted.
//
// The seven uniforms of a lane: with `u` given, row i of it (by position: an
// independent stream, sampler "rng"); with `u` null the kernel computes the
// lane's own QMC numbers (ops/sampler.py::qmc_uniforms, to the letter, in
// unsigned arithmetic): pixel id pid_base + lane % C and sample index
// sample_base + lane / C, the rotation hash pcg(pcg(pid ^ hd) + salt_k) with
// hd the host's hash of depth and seed, and (s * alpha_k + rot) >> 8 times
// 2^-24. The generators and salts are launch arguments from the host's table.
//
// What bounds it on an H100: the closest-hit and shadow walks (traverse.cuh),
// which from depth 1 on are bound by divergence as well as by instruction
// throughput: after the first bounce neighbouring lanes no longer share a path
// through the tree, which is what the coherence order is for; with it the
// depth-1 pool of the 1024^2 courtyard still has only 62% of a warp's lanes
// at work in the node body and 48% in the triangle body, its shadow rays
// 28% / 23% (the kernel's own counter, PERF.md), and without it K6 takes 1.5x
// as long. Bytes are no longer the limit: per live lane 4 bytes of order and
// 45 of pool read, 12 of radiance read and written, 52 written by a
// survivor, and no uniforms when the kernel makes them: 276 MB per sample
// (0.08 ms at 3.35 TB/s) against 700 MB when every lane was copied; a warp's
// lanes are scattered in the pool from depth 1 on (32-byte sectors, not
// 128-byte lines). The launch is 128 threads a block with the registers
// capped for 4 blocks an SM (a measured sweep, PERF.md); the width-8
// instances take their own cap, kBounceMinBlocksW8 (traverse.cuh), also 4:
// at 5 (96 registers) they spill 4-80 bytes.
// The scene tables (~5 MB for the 100k courtyard, the 3.5 MB pair atlas) stay in L2.
#pragma once

#include <cuda_runtime.h>

#include "render_common.cuh"
#include "texsample.cuh"

namespace rt {

constexpr int kNeeNone = 0;      // no shadows: ambient + every light, unshadowed
constexpr int kNeeAll = 1;       // every light with its shadow ray
constexpr int kNeeSampled = 2;   // one light picked by u6, weighted by the light count
constexpr int kContinue = 0;     // sample the continuation
constexpr int kContinueRR = 1;   // ... then Russian roulette
constexpr int kLast = 2;         // the last depth: no continuation, every lane retires
constexpr int kBounceDims = 7;   // uniforms per lane and bounce

// The in-kernel QMC stream of one launch (ops/sampler.py).
struct QmcStream {
  unsigned pid_base;      // pixel id of lane 0
  unsigned sample_base;   // sample index of the pool's first chunk
  unsigned hd;            // pcg_hash(depth * 0x9E3779B9 + seed), from the host
  int chunk;              // C: lanes per sample of the chunk-major pool
  unsigned alpha[kBounceDims];   // the lattice generators, odd uint32 fixed point
  unsigned salt[kBounceDims];    // k * 0x85EBCA6B + 0x165667B1
};

// The stream from its 4 + 2 * kBounceDims host words: pid_base, sample_base,
// hd, chunk, the generators, the salts (ops/cuda/bounce.py::qmc_words); a null
// pointer gives a stream that is never read (the launch has its `u`).
inline QmcStream qmc_stream(const unsigned* w) {
  QmcStream q{};
  q.chunk = 1;
  if (w == nullptr) return q;
  q.pid_base = w[0];
  q.sample_base = w[1];
  q.hd = w[2];
  q.chunk = static_cast<int>(w[3]);
  for (int k = 0; k < kBounceDims; ++k) {
    q.alpha[k] = w[4 + k];
    q.salt[k] = w[4 + kBounceDims + k];
  }
  return q;
}

struct BounceArgs {
  const void* nodes;      // Node<W> records of the launch's width
  const float4* tris;
  const float4* attrs;
  const float* mats;
  int n_mats;
  const float* lights;
  int n_lights;
  const float* spheres;
  int n_spheres;
  const TexMeta* maps;
  const int2* atlas;      // texel pairs (ops/cuda/texshade.py)
  int present;
  int n_levels;
  float tex_lod;
  // the pool, updated in place
  float* o;
  float* d;
  float* thr;
  float* med;
  int* chan;
  int* rtype;
  int* depth;
  unsigned char* active;
  float* rad;   // [n,3], added to
  int n;
  const int* order;          // [n] sorted position -> lane, or null
  const long long* n_live;   // positions to work on, or null for n
  const float* u;            // [n,7] by position, or null: the QMC stream
  QmcStream qmc;
};

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}

// torch.clamp: a NaN stays NaN.
__device__ __forceinline__ float nan_clamp(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

// PCG output permutation on uint32 (ops/sampler.py::pcg_hash).
__device__ __forceinline__ unsigned pcg_hash(unsigned x) {
  x = x * 747796405u + 2891336453u;
  x = ((x >> ((x >> 28) + 4u)) ^ x) * 277803737u;
  return (x >> 22) ^ x;
}

// The kBounceDims lattice uniforms of `lane` (ops/sampler.py::qmc_uniforms).
__device__ __forceinline__ void qmc_uniforms(const QmcStream& q, int lane, float* uu) {
  const unsigned pid = q.pid_base + static_cast<unsigned>(lane % q.chunk);
  const unsigned s = q.sample_base + static_cast<unsigned>(lane / q.chunk);
  const unsigned h = pcg_hash(pid ^ q.hd);
#pragma unroll
  for (int k = 0; k < kBounceDims; ++k) {
    const unsigned v = s * q.alpha[k] + pcg_hash(h + q.salt[k]);
    uu[k] = static_cast<float>(v >> 8) * (1.0f / 16777216.0f);
  }
}

template <int W, int STACK, bool TEXTURED, int NEE, int CONT>
__global__ void __launch_bounds__(kBounceBlock, W == 8 ? kBounceMinBlocksW8 : kBounceMinBlocks)
bounce_kernel(const BounceArgs a) {
  const Node<W>* nodes = static_cast<const Node<W>*>(a.nodes);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  if (a.n_live != nullptr && i >= *a.n_live) return;
  const int lane = a.order != nullptr ? a.order[i] : i;
  if (!a.active[lane]) return;
  const float ox = a.o[3 * lane], oy = a.o[3 * lane + 1], oz = a.o[3 * lane + 2];
  const float dx = a.d[3 * lane], dy = a.d[3 * lane + 1], dz = a.d[3 * lane + 2];
  const float thr[3] = {a.thr[3 * lane], a.thr[3 * lane + 1], a.thr[3 * lane + 2]};
  const float med = a.med[lane];
  const int chan = a.chan[lane];

  bool alive = false;
  float rad[3] = {0.0f, 0.0f, 0.0f};
  const Ray ray = make_ray(ox, oy, oz, dx, dy, dz);
  Surface s;
  if (!closest_surface<W, STACK>(nodes, a.tris, a.spheres, a.n_spheres, ray, s)) {
    const float sky[3] = {0.1f, 0.2f, 0.3f};
#pragma unroll
    for (int c = 0; c < 3; ++c) rad[c] = sky[c] * thr[c] + 0.0f;
  } else {
    const int mid = min(max(s.mat, 0), a.n_mats - 1);
    float u = 0.0f, v = 0.0f;
    if (TEXTURED) {
      float density;
      const float2 uv = surface_uv(a.tris, a.attrs, ray, s, density);
      u = uv.x;
      v = uv.y;
    }
    // the all-lights instances sample one map at a time (texsample.cuh
    // sample_material): their light loop holds the registers the overlap takes
    const MaterialSample m = sample_material<false, NEE != kNeeAll>(
        a.mats, TEXTURED ? a.maps : nullptr, a.atlas, a.present, a.n_levels, mid, u, v,
        a.tex_lod);
    float uu[kBounceDims];
    if (a.u != nullptr) {
#pragma unroll
      for (int k = 0; k < kBounceDims; ++k) uu[k] = a.u[kBounceDims * i + k];
    } else {
      qmc_uniforms(a.qmc, lane, uu);
    }

    // ---- direct lighting ----
    const float is_metal_f = m.metallic > 0.5f ? 1.0f : 0.0f;
    const float brdf = is_metal_f * 0.5f + (1.0f - is_metal_f) / kPi;
    float lit[3];
    if (NEE == kNeeSampled) {
      const int li = min(static_cast<int>(uu[6] * static_cast<float>(a.n_lights)),
                         a.n_lights - 1);
      const float* L = a.lights + li * kLightWords;
      const float I =
          light_intensity<W, STACK>(L, s, true, nodes, a.tris, a.spheres, a.n_spheres);
      const float gate = I > 0.0f ? 1.0f : 0.0f;
      const float w = brdf * I * gate * static_cast<float>(a.n_lights);
#pragma unroll
      for (int c = 0; c < 3; ++c)
        lit[c] = m.albedo[c] * 0.1f * m.occlusion + m.albedo[c] * w * L[4 + c] +
                 m.emission[c];
    } else {
      float sum[3] = {0.0f, 0.0f, 0.0f};
      for (int li = 0; li < a.n_lights; ++li) {
        const float* L = a.lights + li * kLightWords;
        const float I = light_intensity<W, STACK>(L, s, NEE == kNeeAll, nodes, a.tris,
                                                  a.spheres, a.n_spheres);
        const float gate = I > 0.0f ? 1.0f : 0.0f;
#pragma unroll
        for (int c = 0; c < 3; ++c) sum[c] = sum[c] + m.albedo[c] * brdf * (I * gate) * L[4 + c];
      }
#pragma unroll
      for (int c = 0; c < 3; ++c)
        lit[c] = m.albedo[c] * 0.1f * m.occlusion + sum[c] + m.emission[c];
    }
    const bool invalid = s.mat >= a.n_mats;
    const float magenta[3] = {1.0f, 0.0f, 1.0f};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float shaded =
          invalid ? magenta[c] : dispersion_blend(lit[c], m.ior, m.transmission, c);
      rad[c] = 0.0f + shaded * thr[c];
    }

    if (CONT != kLast) {
      const float u0 = uu[0], u1 = uu[1], u2 = uu[2], u3 = uu[3], u4 = uu[4], u5 = uu[5];
      const bool entering = dot3(dx, dy, dz, s.nx, s.ny, s.nz) < 0.0f;
      const float fnx = entering ? s.nx : -s.nx;
      const float fny = entering ? s.ny : -s.ny;
      const float fnz = entering ? s.nz : -s.nz;

      // diffuse: cosine lobe about the faced normal, Duff's basis
      const float sg = fnz >= 0.0f ? 1.0f : -1.0f;
      const float ob = -1.0f / (sg + fnz);
      const float bb = fnx * fny * ob;
      const float tx = 1.0f + sg * (fnx * fnx) * ob, ty = sg * bb, tz = -sg * fnx;
      const float bx = bb, by = sg + (fny * fny) * ob, bz = -fny;
      const float r = sqrtf(u0);
      const float phi = (2.0f * kPi) * u1;
      const float hx = r * cosf(phi), hy = r * sinf(phi);
      const float hz = sqrtf(fmaxf(1.0f - u0, 0.0f));
      float dfx = tx * hx + bx * hy + fnx * hz;
      float dfy = ty * hx + by * hy + fny * hz;
      float dfz = tz * hx + bz * hy + fnz * hz;
      const float dl = sqrtf(dot3(dfx, dfy, dfz, dfx, dfy, dfz));
      dfx = dfx / dl;
      dfy = dfy / dl;
      dfz = dfz / dl;

      // metal: the mirror direction plus roughness x fuzz
      const float dfn = dot3(dx, dy, dz, fnx, fny, fnz);
      const float k2 = 2.0f * dfn;
      const float rfx = dx - k2 * fnx, rfy = dy - k2 * fny, rfz = dz - k2 * fnz;
      float mx = rfx + m.roughness * (u0 * 2.0f - 1.0f);
      float my = rfy + m.roughness * (u1 * 2.0f - 1.0f);
      float mz = rfz + m.roughness * (u2 * 2.0f - 1.0f);
      const float ml = sqrtf(dot3(mx, my, mz, mx, my, mz));
      mx = mx / ml;
      my = my / ml;
      mz = mz / ml;
      const bool metal_absorbed = dot3(mx, my, mz, fnx, fny, fnz) <= 0.0f;

      // glass: Fresnel-weighted reflection or refraction at the wavelength's IOR
      const bool is_glass = m.transmission > 0.0f;
      const bool split = is_glass && chan >= 3;
      const int eff = split ? min(static_cast<int>(u5 * 3.0f), 2) : chan;
      const float offs = eff == 0 ? -0.018f : eff == 1 ? 0.0f : eff == 2 ? 0.035f : 0.0f;
      const float mat_ior = m.ior + offs;
      const float n1 = entering ? med : mat_ior;
      const float n2 = entering ? mat_ior : 1.0f;
      const float eta = n1 / n2;
      const float cos_i = fabsf(dfn);
      const float ci = -dfn;
      const float sin2_t = eta * eta * fmaxf(1.0f - ci * ci, 0.0f);
      const bool tir = sin2_t > 1.0f;
      const float cos_t = sqrtf(fmaxf(1.0f - sin2_t, 0.0f));
      const float kr = eta * ci - cos_t;
      float gx = eta * dx + kr * fnx, gy = eta * dy + kr * fny, gz = eta * dz + kr * fnz;
      const float gl = sqrtf(dot3(gx, gy, gz, gx, gy, gz));
      gx = gx / gl;
      gy = gy / gl;
      gz = gz / gl;
      const float xr = (n1 - n2) / (n1 + n2);
      const float r0 = xr * xr;
      const float om = 1.0f - cos_i;
      const float om2 = om * om;
      const float fres = nan_clamp(r0 + (1.0f - r0) * (om * (om2 * om2)), 0.0f, 1.0f);
      const bool do_reflect = tir || u3 < fres;

      const bool is_metal = !is_glass && m.metallic > 0.5f;
      float ndx, ndy, ndz;
      if (is_glass) {
        ndx = do_reflect ? rfx : gx;
        ndy = do_reflect ? rfy : gy;
        ndz = do_reflect ? rfz : gz;
      } else if (is_metal) {
        ndx = mx;
        ndy = my;
        ndz = mz;
      } else {
        ndx = dfx;
        ndy = dfy;
        ndz = dfz;
      }
      const float off = (dot3(ndx, ndy, ndz, fnx, fny, fnz) >= 0.0f ? 1.0f : -1.0f) * 1e-3f;

      float t3[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        t3[c] = thr[c] * m.albedo[c];
        if (split) t3[c] = t3[c] * 3.0f * (eff == c ? 1.0f : 0.0f);
      }
      alive = !(is_metal && metal_absorbed);
      if (CONT == kContinueRR) {
        const float p = nan_clamp(nan_max(nan_max(t3[0], t3[1]), t3[2]), 0.05f, 0.95f);
        const bool survive = u4 <= p;
        if (alive && survive) {
#pragma unroll
          for (int c = 0; c < 3; ++c) t3[c] = t3[c] / p;
        }
        alive = alive && survive;
      }
      if (alive) {
        a.o[3 * lane] = s.px + fnx * off;
        a.o[3 * lane + 1] = s.py + fny * off;
        a.o[3 * lane + 2] = s.pz + fnz * off;
        a.d[3 * lane] = ndx;
        a.d[3 * lane + 1] = ndy;
        a.d[3 * lane + 2] = ndz;
#pragma unroll
        for (int c = 0; c < 3; ++c) a.thr[3 * lane + c] = t3[c];
        if (is_glass) a.med[lane] = do_reflect ? med : (entering ? mat_ior : 1.0f);
        a.chan[lane] = eff;
        a.rtype[lane] = (is_glass && !do_reflect) ? 2 : 1;
        a.depth[lane] = a.depth[lane] + 1;
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) a.rad[3 * lane + c] = a.rad[3 * lane + c] + rad[c];
  if (!alive) a.active[lane] = 0;
}

// Launch the width-W instance of the given flags for `stack`; returns
// cudaGetLastError(), or cudaErrorInvalidValue for a stack capacity or flag
// that was not compiled.
template <int W, bool TEXTURED>
int launch_bounce(const BounceArgs& a, int stack, int nee, int cont, cudaStream_t s) {
  const dim3 block(kBounceBlock);
  const dim3 grid((a.n + kBounceBlock - 1) / kBounceBlock);
#define RT_LAUNCH_NC(S, N, C) bounce_kernel<W, S, TEXTURED, N, C><<<grid, block, 0, s>>>(a)
#define RT_LAUNCH_N(S, N)                                       \
  switch (cont) {                                               \
    case kContinue: RT_LAUNCH_NC(S, N, kContinue); break;       \
    case kContinueRR: RT_LAUNCH_NC(S, N, kContinueRR); break;   \
    case kLast: RT_LAUNCH_NC(S, N, kLast); break;               \
    default: return static_cast<int>(cudaErrorInvalidValue);    \
  }
#define RT_LAUNCH(S)                                            \
  switch (nee) {                                                \
    case kNeeNone: RT_LAUNCH_N(S, kNeeNone); break;             \
    case kNeeAll: RT_LAUNCH_N(S, kNeeAll); break;               \
    case kNeeSampled: RT_LAUNCH_N(S, kNeeSampled); break;       \
    default: return static_cast<int>(cudaErrorInvalidValue);    \
  }
  RT_SWITCH_STACK(W, stack, RT_LAUNCH)
#undef RT_LAUNCH
#undef RT_LAUNCH_N
#undef RT_LAUNCH_NC
  return static_cast<int>(cudaGetLastError());
}

// The instances outside bounce.cu, each in a source of its own so that they
// compile in parallel: textured width 4 (bounce_textured.cu), untextured and
// textured width 8 (bounce_w8.cu, bounce_textured_w8.cu).
int launch_bounce_textured(const BounceArgs& a, int stack, int nee, int cont, cudaStream_t s);
int launch_bounce_w8(const BounceArgs& a, int stack, int nee, int cont, cudaStream_t s);
int launch_bounce_textured_w8(const BounceArgs& a, int stack, int nee, int cont,
                              cudaStream_t s);

}  // namespace rt
