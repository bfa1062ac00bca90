"""The à-trous filter's kernels (csrc/atrous.cu) compiled for the host and
held to the plain filter and to the JAX package's, on the CPU.

The CUDA kernels only build on the card, but their arithmetic and their
tiling live in csrc/atrous.cuh as plain functions over float4. g++ builds
that header with stand-ins for the CUDA names (-ffp-contract=off, as the
kernels are built -fmad=false); the harness below runs the prepare step for
every pixel, then each pass block by block as the kernel does: it stages a
block's tile with the kernel's staging functions and runs each of the
block's threads on that stage. Between the two steps the subsample is
sorted by torch.sort, as on the card, and the passes take the depth scale
from it with the header's sorted_quantile (rank, order statistics, lerp). The frame
must be within 1e-5 x max(1, max |ref|) of the plain `atrous_denoise` and
of the JAX package's; the prepare step's planes and subsample equal the
plain version's values bit for bit, and the quantile `torch.quantile`'s;
every pixel of a pass is written exactly once.

Cases: odd frames smaller and larger than a block's tile (32 x 8 lattice
points), one pass and four (dilation 8, a halo wider than the frame's
class lattice), with and without albedo, rows and columns of misses, the
cosine exponent 64 (repeated squaring) and 2.5 (powf), a frame above 512
rows (the strided depth subsample), and no pass at all."""

import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpu_raytracer_tpu.ops.denoise import atrous_denoise as jax_atrous_denoise
from gpu_raytracer_tpu_torch.ops.cuda.denoise import SUBSAMPLE_EDGE
from gpu_raytracer_tpu_torch.ops.denoise import atrous_denoise

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "gpu_raytracer_tpu_torch", "csrc")
TOL = 1e-5
MISS_DEPTH = np.float32(3.4028235e38)

STUBS = r"""
#pragma once
#include <cmath>
#define __host__
#define __device__
struct float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
"""

# prepare H W sy sx albedo(0/1) nopass(0/1): reads color.bin, normal.bin,
#   depth.bin, albedo.bin; writes cplane.bin, gplane.bin, sub.bin (or out.bin
#   with nopass).
# quantile: reads sorted.bin (a subsample in torch.sort's order), writes
#   quantile.bin (the depth scale's 99th percentile, sorted_quantile).
# divide N seed: N random quotients (numerators of every exponent, the
#   filter's divisors and random ones) through div_by and through '/';
#   prints the pairs whose bits differ (a zero quotient's sign aside).
# passes H W iterations sigma_color sigma_depth sigma_normal power albedo(0/1)
#   quantile: reads cplane.bin, gplane.bin, albedo.bin; writes out.bin and
#   cover.bin (the writes each pixel got, per pass).
HARNESS = r"""
#include <algorithm>
#include <cstdio>
#include <cstring>
#include <random>
#include <cstdlib>
#include <vector>
#include "stubs.h"
#include "atrous.cuh"
using namespace rt::atrous;

template <class T> static std::vector<T> slurp(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) std::exit(3);
  std::fseek(f, 0, SEEK_END);
  const long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<T> v(n / sizeof(T));
  if (std::fread(v.data(), 1, n, f) != static_cast<size_t>(n)) std::exit(4);
  std::fclose(f);
  return v;
}

template <class T> static void spill(const char* path, const std::vector<T>& v) {
  FILE* f = std::fopen(path, "wb");
  std::fwrite(v.data(), sizeof(T), v.size(), f);
  std::fclose(f);
}

static int prepare(char** argv) {
  const int H = std::atoi(argv[2]), W = std::atoi(argv[3]);
  const int sy = std::atoi(argv[4]), sx = std::atoi(argv[5]);
  const bool with_albedo = std::atoi(argv[6]) != 0, nopass = std::atoi(argv[7]) != 0;
  const auto color = slurp<float>("color.bin"), normal = slurp<float>("normal.bin");
  const auto depth = slurp<float>("depth.bin");
  const auto albedo = with_albedo ? slurp<float>("albedo.bin") : std::vector<float>();
  const long n = static_cast<long>(H) * W;
  const int sub_w = (W + sx - 1) / sx;
  std::vector<float4> cp(n), gp(n);
  std::vector<float> sub(static_cast<size_t>((H + sy - 1) / sy) * sub_w, -1.0f), out(3 * n);
  for (long p = 0; p < n; ++p) {
    const float* alb = with_albedo ? &albedo[3 * p] : nullptr;
    float4 c, g;
    const bool hit = prepare_pixel(&color[3 * p], &normal[3 * p], depth[p], alb, &c, &g);
    if (nopass) {
      remodulate(c, alb, &out[3 * p]);
      continue;
    }
    cp[p] = c;
    gp[p] = g;
    const long y = p / W, x = p % W;
    if (y % sy == 0 && x % sx == 0) sub[(y / sy) * sub_w + x / sx] = hit ? depth[p] : 0.0f;
  }
  if (nopass) {
    spill("out.bin", out);
  } else {
    spill("cplane.bin", cp);
    spill("gplane.bin", gp);
    spill("sub.bin", sub);
  }
  return 0;
}

static int divide(char** argv) {
  const long n = std::atol(argv[2]);
  std::mt19937_64 rng(std::strtoull(argv[3], nullptr, 10));
  const float fixed[] = {0.02f, 0.45f, 0.225f, 0.1125f, 0.05625f, 0.028125f, 0x1p-20f, 0x1p20f};
  long bad = 0;
  for (long i = 0; i < n; ++i) {
    const unsigned ua = static_cast<unsigned>(rng()), ub = static_cast<unsigned>(rng());
    float a, b;
    std::memcpy(&a, &ua, 4);   // every bit pattern: all exponents, zeros, inf, NaN
    if (i % 4 == 0) {
      b = fixed[(ub >> 8) % 8];
    } else {   // a divisor in [2^-20, 2^20]
      const unsigned e = 127 - 20 + (ub >> 23) % 41;
      const unsigned bits = (e << 23) | (ub & 0x7fffffu);
      std::memcpy(&b, &bits, 4);
    }
    const float got = div_by(a, b, reciprocal(b)), want = a / b;
    if (std::isnan(want) ? !std::isnan(got) : (got != want || (want != 0.0f && std::signbit(got) != std::signbit(want)))) {
      if (++bad <= 5) std::printf("%a / %a: %a, want %a\n", a, b, got, want);
    }
  }
  std::printf("mismatches %ld of %ld\n", bad, n);
  return 0;
}

static int quantile() {
  const auto sorted = slurp<float>("sorted.bin");
  spill("quantile.bin",
        std::vector<float>{sorted_quantile(sorted.data(), static_cast<int>(sorted.size()))});
  return 0;
}

template <int E>
static void run_pass(const std::vector<float4>& cin, const std::vector<float4>& gp, float zscale,
                     const PassParams& p, std::vector<float4>* cout, const float* albedo,
                     std::vector<float>* out, std::vector<int>* cover) {
  const int H = p.height, W = p.width, s = p.step;
  float4 sc[kStage], sg[kStage];
  unsigned char sh[kStage];
  for (int blk = 0; blk < pass_blocks(H, W, s); ++blk) {
    const Tile t = block_tile(blk, H, W, s);
    for (int e = 0; e < kStage; ++e) {
      const int q = stage_pixel(t, e, H, W, s);
      bool hit;
      sc[e] = cin[q];
      sg[e] = stage_geometry(gp[q], zscale, &hit);
      sh[e] = hit ? 1 : 0;
    }
    for (int tid = 0; tid < kBlock; ++tid) {
      const int i = tid / kTileW, j = tid % kTileW;
      const int q = thread_pixel(t, i, j, H, W, s);
      if (q < 0) continue;
      (*cover)[q] += 1;
      const float4 c = filter_pixel<E>(sc, sg, sh, i, j, p);
      if (out == nullptr)
        (*cout)[q] = c;
      else
        remodulate(c, albedo != nullptr ? albedo + 3 * q : nullptr, &(*out)[3 * q]);
    }
  }
}

static int passes(char** argv) {
  const int H = std::atoi(argv[2]), W = std::atoi(argv[3]), iterations = std::atoi(argv[4]);
  const double sigma_color = std::strtod(argv[5], nullptr);
  const float sigma_depth = static_cast<float>(std::strtod(argv[6], nullptr));
  const float sigma_normal = static_cast<float>(std::strtod(argv[7], nullptr));
  const int power = std::atoi(argv[8]);
  const bool with_albedo = std::atoi(argv[9]) != 0;
  const float quantile = static_cast<float>(std::strtod(argv[10], nullptr));
  const long n = static_cast<long>(H) * W;
  std::vector<float4> planes[2] = {slurp<float4>("cplane.bin"), std::vector<float4>(n)};
  const auto gp = slurp<float4>("gplane.bin");
  const auto albedo = with_albedo ? slurp<float>("albedo.bin") : std::vector<float>();
  std::vector<float> out(3 * n);
  std::vector<int> cover(static_cast<size_t>(iterations) * n, 0);
  const float zscale = depth_scale(quantile);
  for (int it = 0; it < iterations; ++it) {
    const float sc = static_cast<float>(sigma_color / (1 << it));
    const PassParams p{H,     W,     1 << it,           sc,
                       sigma_depth, sigma_normal, power, reciprocal(sc), reciprocal(sigma_depth)};
    const bool last = it == iterations - 1;
    std::vector<int> c(n, 0);
    std::vector<float4>* next = &planes[(it + 1) % 2];
    const float* alb = last && with_albedo ? albedo.data() : nullptr;
    std::vector<float>* o = last ? &out : nullptr;
    if (power == 64)
      run_pass<64>(planes[it % 2], gp, zscale, p, next, alb, o, &c);
    else
      run_pass<0>(planes[it % 2], gp, zscale, p, next, alb, o, &c);
    for (long q = 0; q < n; ++q) cover[it * n + q] = c[q];
  }
  spill("out.bin", out);
  spill("cover.bin", cover);
  return 0;
}

int main(int argc, char** argv) {
  if (argc > 1 && std::string(argv[1]) == "prepare") return prepare(argv);
  if (argc > 1 && std::string(argv[1]) == "passes") return passes(argv);
  if (argc > 1 && std::string(argv[1]) == "quantile") return quantile();
  if (argc > 1 && std::string(argv[1]) == "divide") return divide(argv);
  return 2;
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    """The host build of csrc/atrous.cuh -> (directory, executable)."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.fail("g++ is needed to build the host filter")
    d = tmp_path_factory.mktemp("atrous_host")
    shutil.copy(os.path.join(CSRC, "atrous.cuh"), d / "atrous.cuh")
    (d / "stubs.h").write_text(STUBS)
    (d / "harness.cpp").write_text("#include <string>\n" + HARNESS)
    exe = d / "harness"
    proc = subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-o", str(exe),
                           str(d / "harness.cpp")], capture_output=True, text=True, cwd=d)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return d, exe


def _frame(seed, H, W):
    """A G-buffer and a noisy frame shaped like a path tracer's: two flat
    walls with smoothly varying depth (the taps carry weight), a patch of
    random normals, whole rows and columns of misses and a scatter of them
    (normal 0, depth f32::MAX, albedo 1)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    normal = np.zeros((H, W, 3), np.float32)
    normal[...] = [0.0, 0.0, 1.0]
    normal[:, W // 2:] = [0.6, 0.0, 0.8]
    rand = rng.normal(size=(H, W, 3)).astype(np.float32)
    rand /= np.linalg.norm(rand, axis=-1, keepdims=True)
    normal[2 * H // 3:, : W // 3] = rand[2 * H // 3:, : W // 3]
    depth = (4.0 + 0.01 * x + 0.02 * y + rng.uniform(0.0, 0.01, (H, W))).astype(np.float32)
    depth[:, W // 2:] += 2.0
    miss = rng.random((H, W)) < 0.1
    miss[0] = miss[H // 2] = True
    miss[:, W - 1] = miss[:, W // 4] = True
    normal[miss] = 0.0
    depth[miss] = MISS_DEPTH
    albedo = rng.uniform(0.0, 1.0, (H, W, 3)).astype(np.float32)
    albedo[: H // 5] = 0.004          # under the 1e-2 floor
    albedo[miss] = 1.0
    color = (albedo * rng.exponential(0.5, (H, W, 3))).astype(np.float32)
    return color, normal, depth, albedo


def _power(sigma_normal) -> int:
    return int(sigma_normal) if float(sigma_normal).is_integer() and \
        1 <= sigma_normal <= 4096 else 0


def _host_filter(harness, color, normal, depth, albedo, iterations, sigma_normal,
                 sigma_color=0.45, sigma_depth=0.02):
    """The host build's frame -> (out [H,W,3], the prepare step's planes and
    subsample, the per-pass write counts), as ops/cuda/denoise.py runs the
    kernels."""
    d, exe = harness
    H, W = color.shape[:2]
    for name, a in (("color", color), ("normal", normal), ("depth", depth),
                    ("albedo", albedo if albedo is not None else np.zeros(1, np.float32))):
        np.ascontiguousarray(a, np.float32).tofile(d / f"{name}.bin")
    sy, sx = max(1, H // SUBSAMPLE_EDGE), max(1, W // SUBSAMPLE_EDGE)
    run = lambda *args: subprocess.run([str(exe), *map(str, args)], cwd=d, check=True)
    run("prepare", H, W, sy, sx, int(albedo is not None), int(iterations == 0))
    read = lambda name, shape, dt=np.float32: np.fromfile(d / f"{name}.bin", dt).reshape(shape)
    if iterations == 0:
        return read("out", (H, W, 3)), None, None, None
    cplane, gplane = read("cplane", (H, W, 4)), read("gplane", (H, W, 4))
    sub = read("sub", (-1,))
    q = _host_quantile(harness, sub)
    run("passes", H, W, iterations, repr(float(sigma_color)), repr(float(sigma_depth)),
        repr(float(sigma_normal)), _power(sigma_normal), int(albedo is not None), repr(q))
    cover = read("cover", (iterations, H, W), np.int32)
    return read("out", (H, W, 3)), (cplane, gplane), sub, cover


def _sorted_quantile(harness, sorted_sub) -> float:
    """The host build's sorted_quantile of an ascending subsample."""
    d, exe = harness
    np.ascontiguousarray(sorted_sub, np.float32).tofile(d / "sorted.bin")
    subprocess.run([str(exe), "quantile"], cwd=d, check=True)
    return float(np.fromfile(d / "quantile.bin", np.float32)[0])


def _host_quantile(harness, sub) -> float:
    """The depth-scale quantile of sub as the passes take it, from
    torch.sort's order; it must be torch.quantile(sub, 0.99)'s, bit for
    bit."""
    t = torch.from_numpy(np.array(sub, np.float32))
    q = np.float32(_sorted_quantile(harness, torch.sort(t).values.numpy()))
    want = torch.quantile(t, 0.99).numpy()
    assert np.array_equal(q, want, equal_nan=True), (q, want)
    return float(q)


def _within(got, ref):
    bar = TOL * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert np.isfinite(got).all() and err <= bar, (err, bar)


@pytest.mark.parametrize("sigma_normal", [64.0, 2.5])
@pytest.mark.parametrize("with_albedo", [False, True])
@pytest.mark.parametrize("iterations", [1, 4])
@pytest.mark.parametrize("size", [(37, 29), (130, 67)])
def test_host_filter_matches_the_plain_and_the_jax_filter(harness, size, iterations,
                                                          with_albedo, sigma_normal):
    H, W = size
    color, normal, depth, albedo = _frame(H * W + iterations, H, W)
    alb = albedo if with_albedo else None
    kw = dict(iterations=iterations, sigma_normal=sigma_normal)
    got, planes, sub, cover = _host_filter(harness, color, normal, depth, alb, iterations,
                                           sigma_normal)
    assert (cover == 1).all(), "a pass wrote some pixel other than once"
    t = lambda a: None if a is None else torch.from_numpy(a)
    plain = atrous_denoise(t(color), t(normal), t(depth), t(alb), **kw).numpy()
    want = np.asarray(jax_atrous_denoise(jnp.asarray(color), jnp.asarray(normal),
                                         jnp.asarray(depth),
                                         None if alb is None else jnp.asarray(alb), **kw))
    _within(got, plain)
    _within(got, want)
    # the prepare step: the plain version's values, bit for bit
    hit = (torch.from_numpy(normal) ** 2).sum(-1) > 0.25
    c = torch.from_numpy(color)
    if alb is not None:
        c = c / torch.clamp(torch.from_numpy(alb), min=1e-2)
    lum = (c * torch.tensor([0.2126, 0.7152, 0.0722])).sum(-1)
    cplane, gplane = planes
    assert np.array_equal(cplane[..., :3], c.numpy()) and np.array_equal(cplane[..., 3], lum)
    assert np.array_equal(gplane[..., :3], normal) and np.array_equal(gplane[..., 3], depth)
    zs = torch.where(hit, torch.from_numpy(depth), 0.0)
    assert np.array_equal(sub, zs.reshape(-1).numpy())


def test_host_filter_takes_the_strided_depth_subsample(harness):
    """A frame of more than 512 rows: the depth scale's subsample is every
    second row, as the plain version's; the frame as the plain one's."""
    H, W = 520, 37
    color, normal, depth, albedo = _frame(11, H, W)
    got, _, sub, cover = _host_filter(harness, color, normal, depth, albedo, 1, 64.0)
    assert (cover == 1).all()
    hit = (torch.from_numpy(normal) ** 2).sum(-1) > 0.25
    zs = torch.where(hit, torch.from_numpy(depth), 0.0)[::2, ::1]
    assert sub.shape == (zs.numel(),) and np.array_equal(sub, zs.reshape(-1).numpy())
    t = torch.from_numpy
    _within(got, atrous_denoise(t(color), t(normal), t(depth), t(albedo), iterations=1).numpy())


@pytest.mark.parametrize("with_albedo", [False, True])
def test_host_filter_of_no_pass_is_the_remodulated_colour(harness, with_albedo):
    color, normal, depth, albedo = _frame(5, 19, 23)
    alb = albedo if with_albedo else None
    got = _host_filter(harness, color, normal, depth, alb, 0, 64.0)[0]
    t = lambda a: None if a is None else torch.from_numpy(a)
    want = atrous_denoise(t(color), t(normal), t(depth), t(alb), iterations=0).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n", [1, 2, 7, 100, 101, 1000, 4097, 65536])
def test_host_quantile_is_torch_quantile(harness, n):
    """The depth scale's quantile (rank, order statistics of torch.sort's
    order, lerp) equals torch.quantile(x, 0.99) bit for bit: hit depths with
    many ties and misses at 0, spread magnitudes, negative values and -0,
    and a NaN (the result NaN), also first, where the card's radix sort puts
    a negative one."""
    rng = np.random.default_rng(n)
    x = rng.uniform(1.0, 40.0, n).astype(np.float32)
    x[rng.random(n) < 0.3] = 0.0
    x[rng.random(n) < 0.2] = np.float32(7.25)
    _host_quantile(harness, x)
    y = (rng.standard_normal(n) * 10.0 ** rng.integers(-6, 6, n)).astype(np.float32)
    y[rng.random(n) < 0.1] = -0.0
    _host_quantile(harness, y)
    y[n // 2] = np.nan
    assert np.isnan(_host_quantile(harness, y))
    first = np.concatenate([[-np.float32(np.nan)], np.sort(x)[1:]]).astype(np.float32)
    assert np.isnan(_sorted_quantile(harness, first))


def test_host_division_is_ieee_division(harness):
    """div_by (the passes' division with its reciprocal taken once a launch)
    equals IEEE division bit for bit on 4M random quotients: numerators of
    every bit pattern, the filter's divisors (sigma_depth, sigma_color
    halved per pass) and random ones in [2^-20, 2^20]; a zero quotient's
    sign aside (the filter squares it). The host rounds as the card does
    (IEEE f32, fused multiply-add, no flush to zero)."""
    d, exe = harness
    out = subprocess.run([str(exe), "divide", "4000000", "22"], cwd=d, check=True,
                         capture_output=True, text=True).stdout
    assert out.strip().endswith("mismatches 0 of 4000000"), out
