"""K1's walk (csrc/traverse.cuh) compiled for the host and held to the plain
traversal, on the CPU.

The CUDA kernels only build on the card, but `walk_bvh<W>` is plain C++
over a few CUDA names (float4, __ldg, __activemask, ...). Stand-ins for
those let g++ compile the walk as it is, at both node widths, on the node
and triangle tables `pack_trace_tables` makes; the hits of the closest-hit
and any-hit walks must equal the plain `traverse_triangles` bit for bit
(hit mask, and t and slot of the closest hit: the courtyard has no
exact-t ties here), the counting instances (COUNT) must return the same
hits, and their counts must be consistent: a visited node has 2 .. W
non-empty child slots, and a width-8 walk visits fewer nodes than a
width-4 walk of the same binary tree. Built with -ffp-contract=off, as
the kernels are with -fmad=false. Run with -s to print the counts."""

import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from gpu_raytracer_tpu_torch.config import RaytracerConfig
from gpu_raytracer_tpu_torch.ops.camera_rays import generate_rays
from gpu_raytracer_tpu_torch.ops.cuda.traverse import pack_trace_tables
from gpu_raytracer_tpu_torch.ops.trace import traverse_triangles
from gpu_raytracer_tpu_torch.utils.procgen import make_courtyard_scene

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "gpu_raytracer_tpu_torch", "csrc")
TRIANGLES = 6000
W, H = 160, 120
RANDOM_RAYS = 4000
F32_MAX = 3.4028234663852886e38

# The CUDA names traverse.cuh uses, for one host thread (lane 0 of its warp).
STUBS = r"""
#pragma once
#include <cmath>
#include <cstring>
#define __device__
#define __forceinline__ inline
#define __restrict__
#define __align__(n) alignas(n)
struct float4 { float x, y, z, w; };
struct int4 { int x, y, z, w; };
struct uint3 { unsigned x, y, z; };
static uint3 threadIdx;
template <class T> T __ldg(const T* p) { return *p; }
inline unsigned __activemask() { return 1u; }
inline int __ffs(unsigned x) { return __builtin_ffs(static_cast<int>(x)); }
inline float fminf(float a, float b) { return std::fmin(a, b); }
inline float fmaxf(float a, float b) { return std::fmax(a, b); }
inline float fabsf(float a) { return std::fabs(a); }
inline float sqrtf(float a) { return std::sqrt(a); }
inline int __float_as_int(float x) { int i; std::memcpy(&i, &x, 4); return i; }
"""

# Reads nodes.bin, tris.bin and rays.bin (o, d, max_t per ray), walks every
# ray with and without COUNT, writes t, slot, nodes, triangles, live slots.
HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <vector>
#include "traverse.cuh"
using namespace rt;

template <class T> static std::vector<T> slurp(const char* path) {
  FILE* f = std::fopen(path, "rb");
  std::fseek(f, 0, SEEK_END);
  const long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<T> v(n / sizeof(T));
  if (std::fread(v.data(), 1, n, f) != static_cast<size_t>(n)) std::exit(4);
  std::fclose(f);
  return v;
}

template <int W, int S, bool ANY>
static int run(const std::vector<float>& raw, const std::vector<float>& tris,
               const std::vector<float>& rays) {
  void* mem = std::aligned_alloc(256, (raw.size() * 4 + 255) / 256 * 256);
  std::memcpy(mem, raw.data(), raw.size() * 4);
  const Node<W>* nodes = static_cast<const Node<W>*>(mem);
  const float4* tr = reinterpret_cast<const float4*>(tris.data());
  FILE* out = std::fopen("out.bin", "wb");
  for (size_t i = 0; i < rays.size() / 7; ++i) {
    const float* q = &rays[7 * i];
    const Ray r = make_ray(q[0], q[1], q[2], q[3], q[4], q[5]);
    Work w{0, 0, 0, 0, 0};
    const TriHit a = traverse_bvh<W, S, ANY, true>(nodes, tr, r, q[6], &w);
    const TriHit b = traverse_bvh<W, S, ANY, false>(nodes, tr, r, q[6]);
    if (a.slot != b.slot || a.t != b.t) return 3;
    const float t = a.slot >= 0 ? a.t : kMissT;
    const int row[4] = {a.slot, w.nodes, w.tris, w.slots};
    std::fwrite(&t, 4, 1, out);
    std::fwrite(row, 4, 4, out);
  }
  std::fclose(out);
  std::free(mem);
  return 0;
}

int main(int argc, char** argv) {
  const int width = std::atoi(argv[1]), stack = std::atoi(argv[2]), any = std::atoi(argv[3]);
  const auto raw = slurp<float>("nodes.bin");
  const auto tris = slurp<float>("tris.bin");
  const auto rays = slurp<float>("rays.bin");
#define RT_RUN(WD, S)                                                          \
  if (width == WD && stack == S)                                               \
    return any ? run<WD, S, true>(raw, tris, rays) : run<WD, S, false>(raw, tris, rays);
  RT_RUN(4, 16) RT_RUN(4, 32) RT_RUN(4, 64) RT_RUN(8, 32) RT_RUN(8, 64)
  return 2;
}
"""


@pytest.fixture(scope="module")
def walk_host(tmp_path_factory):
    """The host build of the walk -> (its directory, the executable)."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.fail("g++ is needed to build the host walk")
    d = tmp_path_factory.mktemp("walk_host")
    with open(os.path.join(CSRC, "traverse.cuh")) as f:
        header = f.read().replace("#include <cuda_runtime.h>", '#include "stubs.h"')
    (d / "traverse.cuh").write_text(header)
    (d / "stubs.h").write_text(STUBS)
    (d / "walk.cpp").write_text(HARNESS)
    exe = d / "walk"
    subprocess.run([cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-o", str(exe),
                    str(d / "walk.cpp")], check=True, capture_output=True, cwd=d)
    return d, exe


def rays(scene):
    """The camera rays of a W x H frame and seeded random rays, 50 of them
    with a zero y component (the general, NaN-checking slab test)."""
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.int32),
                            torch.arange(W, dtype=torch.int32), indexing="ij")
    o, d = generate_rays(scene.camera, W, H, xs.reshape(-1), ys.reshape(-1))
    rng = np.random.default_rng(1)
    ro = torch.from_numpy(rng.uniform(-20, 20, (RANDOM_RAYS, 3)).astype(np.float32))
    rd = torch.from_numpy(rng.normal(size=(RANDOM_RAYS, 3)).astype(np.float32))
    rd[:50, 1] = 0.0
    rd = rd / rd.norm(dim=1, keepdim=True)
    return torch.cat([o, ro]).contiguous(), torch.cat([d, rd]).contiguous()


def walk(build, tables, o, d, max_t, any_hit):
    """The host walk over `tables` -> (t, slot, nodes, triangles, live slots)."""
    directory, exe = build
    tables.nodes.numpy().tofile(directory / "nodes.bin")
    tables.tris.numpy().tofile(directory / "tris.bin")
    torch.cat([o, d, max_t[:, None]], dim=1).numpy().tofile(directory / "rays.bin")
    subprocess.run([str(exe), str(tables.width), str(tables.stack), str(int(any_hit))],
                   check=True, cwd=directory)
    out = np.fromfile(directory / "out.bin", dtype=np.int32).reshape(-1, 5)
    return out[:, 0].view(np.float32), out[:, 1], out[:, 2], out[:, 3], out[:, 4]


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("spatial", [False, True], ids=["sah", "sbvh"])
def test_host_walk_matches_the_plain_traversal_at_both_widths(walk_host, spatial, any_hit):
    visits = {}
    for width in (4, 8):
        cfg = RaytracerConfig(bvh_width=width, bvh_spatial_splits=spatial)
        scene = make_courtyard_scene(TRIANGLES, seed=0, config=cfg, device="cpu")
        tables = pack_trace_tables(scene)
        assert tables.width == width
        o, d = rays(scene)
        max_t = torch.full((o.shape[0],), 5.0 if any_hit else F32_MAX)
        t, slot, nodes, tris, live = walk(walk_host, tables, o, d, max_t, any_hit)
        pt, ps, ph, _, _ = traverse_triangles(scene, o, d, max_t, any_hit=any_hit)
        hit = slot >= 0
        assert np.array_equal(hit, ph.numpy())
        if not any_hit:
            assert np.array_equal(t[hit], pt.numpy()[hit])
            assert np.array_equal(slot[hit], ps.numpy()[hit])
        assert (nodes >= 1).all() and (live >= 2 * nodes).all() and (live <= width * nodes).all()
        visits[width] = int(nodes.sum())
        print(f"width {width} spatial={spatial} any_hit={any_hit}: {nodes.mean():.2f} nodes, "
              f"{tris.mean():.2f} triangles a ray, {live.sum() / nodes.sum():.2f} live child "
              f"slots a visit")
    assert visits[8] < visits[4]
