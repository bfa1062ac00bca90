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
the kernels are with -fmad=false. Run with -s to print the counts.

The camera-relative walk (REL: K3's camera walk over the tables of its
pre-pass, csrc/camera_relative.cu) runs the frame's camera rays over the
tables the plain `camera_relative_tables` makes, from the scene's camera and
from two moved ones: its hits must equal the plain traversal's and the
ordinary walk's bit for bit, and its node visits, triangle tests and live
child slots the ordinary walk's (the same walk). One ray pins down where
the walk and the plain traversal part: an order tie at a shared edge, on
which the walk keeps the JAX package's winner."""

import dataclasses
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from gpu_raytracer_tpu_torch.config import RaytracerConfig
from gpu_raytracer_tpu_torch.models.camera import Camera, CameraController
from gpu_raytracer_tpu_torch.ops.camera_rays import generate_rays
from gpu_raytracer_tpu_torch.ops.cuda.render import (camera_relative_tables, pack_render_tables,
                                                     set_camera)
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
inline unsigned atomicAdd(unsigned* p, unsigned v) { const unsigned o = *p; *p += v; return o; }
"""

# Reads nodes.bin, tris.bin and rays.bin (o, d, max_t per ray), walks every
# ray with and without COUNT, writes t, slot, nodes, triangles, live slots.
HARNESS = r"""
#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <cstring>
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

static void write_row(FILE* out, const TriHit& h, const Work& w) {
  const float t = h.slot >= 0 ? h.t : kMissT;
  const int row[4] = {h.slot, w.nodes, w.tris, w.slots};
  std::fwrite(&t, 4, 1, out);
  std::fwrite(row, 4, 4, out);
}

// Writes t, slot, nodes, triangles, live slots per ray to out.bin, the
// visits by children ahead (Work::ahead, width 8) to ahead.bin, and the most
// entries each ray's stack held (Work::deepest) to deep.bin.
template <int W, int S, bool ANY>
static int run(const std::vector<float>& raw, const std::vector<float>& tris,
               const std::vector<float>& rays) {
  void* mem = std::aligned_alloc(256, (raw.size() * 4 + 255) / 256 * 256);
  std::memcpy(mem, raw.data(), raw.size() * 4);
  const Node<W>* nodes = static_cast<const Node<W>*>(mem);
  const float4* tr = reinterpret_cast<const float4*>(tris.data());
  FILE* out = std::fopen("out.bin", "wb");
  FILE* deep = std::fopen("deep.bin", "wb");
  unsigned ahead[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
  for (size_t i = 0; i < rays.size() / 7; ++i) {
    const float* q = &rays[7 * i];
    const Ray r = make_ray(q[0], q[1], q[2], q[3], q[4], q[5]);
    Work w{0, 0, 0, 0, 0, ahead};
    const TriHit a = traverse_bvh<W, S, ANY, true>(nodes, tr, r, q[6], &w);
    const TriHit b = traverse_bvh<W, S, ANY, false>(nodes, tr, r, q[6]);
    if (a.slot != b.slot || a.t != b.t) return 3;
    if constexpr (ANY) {   // the frame kernels' near-first any hit: the same mask
      const TriHit c = traverse_bvh<W, S, true, false, false, true>(nodes, tr, r, q[6]);
      if ((c.slot >= 0) != (a.slot >= 0)) return 5;
    }
    write_row(out, a, w);
    std::fwrite(&w.deepest, 4, 1, deep);
  }
  std::fclose(out);
  std::fclose(deep);
  out = std::fopen("ahead.bin", "wb");
  std::fwrite(ahead, 4, 9, out);
  std::fclose(out);
  std::free(mem);
  return 0;
}

// The closest-hit walk written plainly: each visit's children ahead in a
// vector, in the stored order or backward (the ray's direction along the
// sort axis), std::stable_sort on the entry distance, the nearest entered
// and the others pushed far first; the slab and triangle tests are the
// walk's own (child_entry / child_entry_tame, leaf_test), so the entry
// distances and hits are the same bits.
template <int W>
static TriHit reference_walk(const Node<W>* nodes, const float4* tris, const Ray& r,
                             float max_t, Work& w) {
  TriHit best{max_t, -1};
  if (0.0f >= max_t) return best;
  const bool tame = is_tame(r);
  std::vector<Entry> stack;
  int cur = 0;
  while (true) {
    while (cur >= 0) {
      ++w.nodes;
      const float* plane = reinterpret_cast<const float*>(nodes[cur].box);
      const int* code = reinterpret_cast<const int*>(nodes[cur].code);
      std::vector<Entry> ahead;
      const float d_axis = nodes[cur].axis == 0 ? r.dx : nodes[cur].axis == 1 ? r.dy : r.dz;
      for (int i = 0; i < W; ++i) {
        const int c = d_axis >= 0.0f ? i : W - 1 - i;
        const float lx = plane[c], ly = plane[W + c], lz = plane[2 * W + c];
        const float hx = plane[3 * W + c], hy = plane[4 * W + c], hz = plane[5 * W + c];
        const float ce =
            tame ? child_entry_tame(r.dx > 0.0f ? lx : hx, r.dy > 0.0f ? ly : hy,
                                    r.dz > 0.0f ? lz : hz, r.dx > 0.0f ? hx : lx,
                                    r.dy > 0.0f ? hy : ly, r.dz > 0.0f ? hz : lz, code[c], r,
                                    best.t)
                 : child_entry(lx, ly, lz, hx, hy, hz, code[c], r, best.t);
        w.slots += code[c] != -1;
        if (ce < kInf) ahead.push_back(Entry{code[c], ce});
      }
      std::stable_sort(ahead.begin(), ahead.end(),
                       [](const Entry& a, const Entry& b) { return a.ce < b.ce; });
      if (!ahead.empty()) {
        cur = ahead[0].code;
        for (size_t k = ahead.size() - 1; k >= 1; --k) stack.push_back(ahead[k]);
        continue;
      }
      cur = -1;
      while (!stack.empty()) {
        const Entry e = stack.back();
        stack.pop_back();
        if (!(e.ce >= best.t)) {
          cur = e.code;
          break;
        }
      }
      if (cur == -1) return best;
    }
    const int packed = -1 - cur;
    leaf_test<false, true>(tris, packed >> 4, packed & 15, r, best, &w);
    cur = -1;
    while (!stack.empty()) {
      const Entry e = stack.back();
      stack.pop_back();
      if (!(e.ce >= best.t)) {
        cur = e.code;
        break;
      }
    }
    if (cur == -1) return best;
  }
}

// Writes, per ray, t, slot, nodes, triangles, live slots of the closest-hit
// walk, then of reference_walk.
template <int W, int S>
static int run_ref(const std::vector<float>& raw, const std::vector<float>& tris,
                   const std::vector<float>& rays) {
  void* mem = std::aligned_alloc(256, (raw.size() * 4 + 255) / 256 * 256);
  std::memcpy(mem, raw.data(), raw.size() * 4);
  const Node<W>* nodes = static_cast<const Node<W>*>(mem);
  const float4* tr = reinterpret_cast<const float4*>(tris.data());
  FILE* out = std::fopen("out.bin", "wb");
  for (size_t i = 0; i < rays.size() / 7; ++i) {
    const float* q = &rays[7 * i];
    const Ray r = make_ray(q[0], q[1], q[2], q[3], q[4], q[5]);
    Work w{0, 0, 0, 0, 0}, wr{0, 0, 0, 0, 0};
    write_row(out, traverse_bvh<W, S, false, true>(nodes, tr, r, q[6], &w), w);
    write_row(out, reference_walk<W>(nodes, tr, r, q[6], wr), wr);
  }
  std::fclose(out);
  std::free(mem);
  return 0;
}

static const void* aligned_copy(const std::vector<float>& raw) {
  void* mem = std::aligned_alloc(256, (raw.size() * 4 + 255) / 256 * 256);
  std::memcpy(mem, raw.data(), raw.size() * 4);
  return mem;
}

// The closest-hit walk of each ray over the camera-relative tables (REL)
// and over the ordinary ones, both counted; writes t, slot, nodes,
// triangles, live slots of the REL walk, then of the ordinary one.
template <int W, int S>
static int run_rel(const std::vector<float>& raw, const std::vector<float>& tris,
                   const std::vector<float>& rel_raw, const std::vector<float>& rel_tris,
                   const std::vector<float>& rays) {
  const void* mem = aligned_copy(raw);
  const void* rel_mem = aligned_copy(rel_raw);
  const Node<W>* nodes = static_cast<const Node<W>*>(mem);
  const Node<W>* walk_nodes = static_cast<const Node<W>*>(rel_mem);
  const float4* tr = reinterpret_cast<const float4*>(tris.data());
  const float4* walk_tris = reinterpret_cast<const float4*>(rel_tris.data());
  FILE* out = std::fopen("out.bin", "wb");
  for (size_t i = 0; i < rays.size() / 7; ++i) {
    const float* q = &rays[7 * i];
    const Ray r = make_ray(q[0], q[1], q[2], q[3], q[4], q[5]);
    Work wr{0, 0, 0, 0, 0}, wo{0, 0, 0, 0, 0};
    const TriHit a = traverse_bvh<W, S, false, true, true>(walk_nodes, walk_tris, r, q[6], &wr);
    const TriHit b = traverse_bvh<W, S, false, false, true>(walk_nodes, walk_tris, r, q[6]);
    const TriHit c = traverse_bvh<W, S, false, true>(nodes, tr, r, q[6], &wo);
    if (a.slot != b.slot || a.t != b.t) return 3;
    const TriHit* hits[2] = {&a, &c};
    const Work* works[2] = {&wr, &wo};
    for (int k = 0; k < 2; ++k) {
      const float t = hits[k]->slot >= 0 ? hits[k]->t : kMissT;
      const int row[4] = {hits[k]->slot, works[k]->nodes, works[k]->tris, works[k]->slots};
      std::fwrite(&t, 4, 1, out);
      std::fwrite(row, 4, 4, out);
    }
  }
  std::fclose(out);
  return 0;
}

// walk <width> <stack> <any hit 0|1> [walk|rel|ref]
int main(int argc, char** argv) {
  const int width = std::atoi(argv[1]), stack = std::atoi(argv[2]), any = std::atoi(argv[3]);
  const char* mode = argc > 4 ? argv[4] : "walk";
  const auto raw = slurp<float>("nodes.bin");
  const auto tris = slurp<float>("tris.bin");
  const auto rays = slurp<float>("rays.bin");
  if (std::strcmp(mode, "ref") == 0) {
#define RT_REF(WD, S) \
  if (width == WD && stack == S) return run_ref<WD, S>(raw, tris, rays);
    RT_REF(4, 16) RT_REF(4, 32) RT_REF(4, 64) RT_REF(8, 32) RT_REF(8, 64)
    return 2;
  }
  if (std::strcmp(mode, "rel") == 0) {
    const auto rel_raw = slurp<float>("rel_nodes.bin");
    const auto rel_tris = slurp<float>("rel_tris.bin");
#define RT_REL(WD, S) \
  if (width == WD && stack == S) return run_rel<WD, S>(raw, tris, rel_raw, rel_tris, rays);
    RT_REL(4, 16) RT_REL(4, 32) RT_REL(4, 64) RT_REL(8, 32) RT_REL(8, 64)
    return 2;
  }
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


def walk(build, tables, o, d, max_t, any_hit, mode="walk"):
    """The host walk over `tables` -> (t, slot, nodes, triangles, live slots)
    ("ref": [N,2,5] int32 rows of the walk and of the reference walk)."""
    directory, exe = build
    tables.nodes.numpy().tofile(directory / "nodes.bin")
    tables.tris.numpy().tofile(directory / "tris.bin")
    torch.cat([o, d, max_t[:, None]], dim=1).numpy().tofile(directory / "rays.bin")
    subprocess.run([str(exe), str(tables.width), str(tables.stack), str(int(any_hit)), mode],
                   check=True, cwd=directory)
    out = np.fromfile(directory / "out.bin", dtype=np.int32)
    if mode == "ref":
        return out.reshape(-1, 2, 5)
    out = out.reshape(-1, 5)
    return out[:, 0].view(np.float32), out[:, 1], out[:, 2], out[:, 3], out[:, 4]


def walk_ahead(build) -> np.ndarray:
    """The last walk's visits by children ahead, [9] (width 8; zeros at 4)."""
    return np.fromfile(build[0] / "ahead.bin", dtype=np.uint32).astype(np.int64)


def walk_deepest(build) -> np.ndarray:
    """The most entries each ray's stack held in the last walk, [N] int32."""
    return np.fromfile(build[0] / "deep.bin", dtype=np.int32)


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


@pytest.fixture(scope="module")
def courtyards():
    """The courtyard at each width, SAH or SBVH, packed once for the module."""
    cache = {}

    def get(width, spatial):
        if (width, spatial) not in cache:
            cfg = RaytracerConfig(bvh_width=width, bvh_spatial_splits=spatial)
            scene = make_courtyard_scene(TRIANGLES, seed=0, config=cfg, device="cpu")
            cache[width, spatial] = pack_render_tables(scene)
        return cache[width, spatial]

    return get


def walk_rel(build, rt, o, d, max_t):
    """The closest-hit walk of camera rays over the camera-relative tables
    of `rt` and over the ordinary ones -> two [N,5] int32 arrays of (t bits,
    slot, nodes, triangles, live slots)."""
    directory, exe = build
    tables = rt.trace
    rel_nodes, rel_tris = camera_relative_tables(rt)
    tables.nodes.numpy().tofile(directory / "nodes.bin")
    tables.tris.numpy().tofile(directory / "tris.bin")
    rel_nodes.numpy().tofile(directory / "rel_nodes.bin")
    rel_tris.numpy().tofile(directory / "rel_tris.bin")
    torch.cat([o, d, max_t[:, None]], dim=1).numpy().tofile(directory / "rays.bin")
    subprocess.run([str(exe), str(tables.width), str(tables.stack), "0", "rel"],
                   check=True, cwd=directory)
    out = np.fromfile(directory / "out.bin", dtype=np.int32).reshape(-1, 2, 5)
    return out[:, 0], out[:, 1]


# The cameras the relative walk starts from: the scene's, one across the
# courtyard looking down, one low and off every axis looking up.
CAMERAS = {"scene": None,
           "across": ((7.25, 3.5, -11.0), (-0.4, -0.3, 0.85)),
           "low": ((-3.125, 0.375, 2.2), (0.55, 0.2, -0.8))}


@pytest.mark.parametrize("camera", sorted(CAMERAS))
@pytest.mark.parametrize("spatial", [False, True], ids=["sah", "sbvh"])
@pytest.mark.parametrize("width", [4, 8])
def test_host_camera_relative_walk_matches_the_ordinary_walk(walk_host, courtyards, width,
                                                             spatial, camera):
    rt = courtyards(width, spatial)
    if CAMERAS[camera] is not None:   # a copy: the module's tables keep their camera
        rt = dataclasses.replace(rt, camera=rt.camera.clone(),
                                 trace=dataclasses.replace(rt.trace))
        set_camera(rt, Camera.create(*CAMERAS[camera]))
    tables = rt.trace
    assert tables.width == width
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.int32),
                            torch.arange(W, dtype=torch.int32), indexing="ij")
    o, d = generate_rays(tables.scene.camera, W, H, xs.reshape(-1), ys.reshape(-1))
    o, d = o.contiguous(), d.contiguous()
    assert torch.equal(o, rt.camera[:3].expand_as(o))   # one origin: the camera row's
    max_t = torch.full((o.shape[0],), F32_MAX)
    got, ordinary = walk_rel(walk_host, rt, o, d, max_t)
    assert np.array_equal(got, ordinary)   # t bits, slot, nodes, triangles, live slots
    pt, ps, ph, _, _ = traverse_triangles(tables.scene, o, d, max_t)
    hit = got[:, 1] >= 0
    assert hit.any() and np.array_equal(hit, ph.numpy())
    assert np.array_equal(got[hit, 0].view(np.float32), pt.numpy()[hit])
    assert np.array_equal(got[hit, 1], ps.numpy()[hit])
    print(f"width {width} spatial={spatial} camera={camera}: {got[:, 2].mean():.2f} nodes, "
          f"{got[:, 3].mean():.2f} triangles a camera ray, all equal to the ordinary walk")


# The 1920x1080 frame's pixel (264, 981) on the 100k courtyard after the
# Viewer's keys "w" then "d": two triangles meet at an edge there, and their
# computed t differ by ~5 ulps.
ORDER_TIE = dict(width=1920, height=1080, px=264, py=981, triangles=100_000)


def test_order_tie_at_a_shared_edge_keeps_the_jax_walks_winner(walk_host):
    """The walk (ordinary and camera-relative, at width 4) reaches slot
    50319 first and culls the leaf of slot 35181, whose slab entry rounds to
    no less than 50319's t while 35181's own t is ~5 ulps smaller (without
    50319 the walk returns 35181); the plain left-first
    traversal keeps 35181. The JAX package's threaded walk keeps 50319 at
    the walk's t, bit for bit. So K1 and its plain version may part on such
    order ties (counted in chip_smoke.py::order_ties), and K3's relative
    walk parts exactly where the ordinary walk does."""
    import jax.numpy as jnp

    from gpu_raytracer_tpu.models.camera import CameraController as JaxCameraController
    from gpu_raytracer_tpu.ops.bvh_traverse import bvh_traverse_threaded as jax_threaded
    from gpu_raytracer_tpu.ops.camera_rays import generate_rays as jax_generate_rays
    from gpu_raytracer_tpu.utils.procgen import make_courtyard_scene as jax_courtyard

    c = ORDER_TIE
    scene = make_courtyard_scene(c["triangles"], seed=0, device="cpu")
    rt = pack_render_tables(scene)
    ctl = CameraController(scene.camera)
    ctl.move(forward=1.0)
    ctl.move(strafe=1.0)
    set_camera(rt, ctl.camera())
    px, py = torch.tensor([c["px"]], dtype=torch.int32), torch.tensor([c["py"]], dtype=torch.int32)
    o, d = generate_rays(rt.scene.camera, c["width"], c["height"], px, py)
    o, d = o.contiguous(), d.contiguous()
    max_t = torch.full((1,), F32_MAX)
    got, ordinary = walk_rel(walk_host, rt, o, d, max_t)
    assert np.array_equal(got, ordinary)
    walk_t, walk_slot = got[0, 0:1].view(np.float32)[0], int(got[0, 1])
    pt, ps, _, _, _ = traverse_triangles(rt.scene, o, d, max_t)
    assert (walk_slot, int(ps[0])) == (50319, 35181)
    assert float(pt[0]) < walk_t and (walk_t - float(pt[0])) / walk_t < 1e-6
    # the JAX package, on the same ray bit for bit
    js = jax_courtyard(c["triangles"], seed=0)
    jctl = JaxCameraController(js.camera)
    jctl.move(forward=1.0)
    jctl.move(strafe=1.0)
    jo, jd = jax_generate_rays(jctl.camera(), c["width"], c["height"],
                               jnp.asarray(px.numpy()), jnp.asarray(py.numpy()))
    assert np.array_equal(np.asarray(jo).view(np.int32), o.numpy().view(np.int32))
    assert np.array_equal(np.asarray(jd).view(np.int32), d.numpy().view(np.int32))
    jt, jslot, _ = jax_threaded(js.bvh, js.tri_v0, js.tri_e1, js.tri_e2, jo, jd,
                                jnp.asarray(max_t.numpy()), leaf_size=js.bvh.max_leaf)
    assert int(jslot[0]) == walk_slot
    assert np.asarray(jt)[0].view(np.int32) == np.float32(walk_t).view(np.int32)


def test_host_closest_walk_visits_children_in_stable_sorted_order(walk_host, courtyards):
    """The closest-hit walk's order, against a reference walk written in the
    harness: each visit's children ahead by std::stable_sort on entry
    distance over the stored order, forward or backward along the ray. The
    t, slot, node visits, triangle tests and live slots of every ray equal,
    at both widths and on both trees: the width-8 ordering keeps the order
    of the stable insertion it replaced."""
    for width in (4, 8):
        for spatial in (False, True):
            tables = courtyards(width, spatial).trace
            o, d = rays(tables.scene)
            got = walk(walk_host, tables, o, d, torch.full((o.shape[0],), F32_MAX), False,
                       mode="ref")
            assert (got[:, 0, 1] >= 0).any()
            assert np.array_equal(got[:, 0], got[:, 1])
            print(f"width {width} spatial={spatial}: {got[:, 0, 2].mean():.2f} nodes, "
                  f"{got[:, 0, 3].mean():.2f} triangles a ray, the reference's")


def camera_shadow_rays(scene, light):
    """The W x H camera rays' hits (plain closest hit) -> shadow rays of every
    hit toward the light, as chip_smoke.py casts them."""
    from torch_scenes import light_shadow_rays

    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.int32),
                            torch.arange(W, dtype=torch.int32), indexing="ij")
    o, d = generate_rays(scene.camera, W, H, xs.reshape(-1), ys.reshape(-1))
    t, _, h, n, _ = traverse_triangles(scene, o, d, torch.full((o.shape[0],), F32_MAX))
    return light_shadow_rays(scene, o, d, t, h, n, W * H, directional=light == "directional")


@pytest.mark.parametrize("light", ["point", "directional"])
@pytest.mark.parametrize("spatial", [False, True], ids=["sah", "sbvh"])
def test_host_any_hit_walk_blocks_as_the_plain_traversal(walk_host, courtyards, spatial, light):
    """The any-hit walk at both widths on the shadow rays of every camera
    hit: its mask equals the plain any-hit and the plain closest hit below
    max_t, whatever order it enters the children ahead in. Run with -s for
    the visits and tests a ray."""
    scene = courtyards(4, spatial).trace.scene
    so, sd, smax = camera_shadow_rays(scene, light)
    plain_any = traverse_triangles(scene, so, sd, smax, any_hit=True)[2].numpy()
    closest = traverse_triangles(scene, so, sd, smax)[2].numpy()
    assert np.array_equal(plain_any, closest) and 0 < closest.sum() < closest.shape[0]
    for width in (4, 8):
        tables = courtyards(width, spatial).trace
        assert same_tree(tables.scene, scene)
        _, slot, nodes, tris, _ = walk(walk_host, tables, so, sd, smax, True)
        assert np.array_equal(slot >= 0, plain_any)
        print(f"{light} light, width {width} spatial={spatial}: {nodes.mean():.2f} nodes, "
              f"{tris.mean():.2f} triangles a shadow ray, {int(plain_any.sum())} of "
              f"{plain_any.shape[0]} blocked")


def same_tree(a, b) -> bool:
    """Whether two scenes hold the same leaf-ordered triangle slots."""
    return all(torch.equal(getattr(a, k), getattr(b, k)) for k in ("tri_v0", "tri_e1", "tri_e2"))


@pytest.mark.parametrize("spatial", [False, True], ids=["sah", "sbvh"])
def test_host_walk_counts_width8_visits_by_children_ahead(walk_host, courtyards, spatial):
    """The counting walk's visits by children ahead (Work::ahead): at width 8
    they add up to the node visits, for the closest hit of the camera rays
    and the any hit of both lights' shadow rays; at width 4 nothing is
    counted. Run with -s for the histograms: visits with 2+ children ahead
    are the ones that pay for the ordering."""
    o, d = rays(courtyards(4, spatial).trace.scene)
    far = torch.full((o.shape[0],), F32_MAX)
    walk(walk_host, courtyards(4, spatial).trace, o, d, far, False)
    assert not walk_ahead(walk_host).any()
    tables = courtyards(8, spatial).trace
    cases = {"camera": (o, d, far, False)}
    for light in ("point", "directional"):
        cases[f"shadow {light}"] = (*camera_shadow_rays(tables.scene, light), True)
    for name, (ro, rd, rm, any_hit) in cases.items():
        nodes = walk(walk_host, tables, ro, rd, rm, any_hit)[2]
        ahead = walk_ahead(walk_host)
        assert ahead.sum() == nodes.sum()
        share = ahead / ahead.sum()
        print(f"width 8 spatial={spatial} {name}: visits by children ahead 0..8 "
              f"{np.round(share, 3).tolist()}, 2+ {share[2:].sum():.3f}")
