"""K1 unordered's walk (csrc/threaded_walk.cuh) compiled for the host and
held to the plain threaded walk, on the CPU.

The kernel only builds on the card, but `threaded_walk` is plain C++ over a
few CUDA names. With the stand-ins of tests/test_torch_walk_host.py and the
warp votes of one lane, g++ compiles it as it is, and a harness walks every
ray over the tables `pack_threaded_tables` makes (32-byte records). The
hits of the closest-hit and any-hit walks must equal
`ops/bvh_traverse.py::bvh_traverse_threaded` bit for bit (t, slot, hit),
both with the votes of a lane alone in its warp (it stops at its first hit
leaf) and with a warp whose other lanes never hold a leaf, so that the lane
walks on past its pending leaf against a stale best_t (the most a warp can
postpone; the counting instance must count such visits in closest hit, and
none in any hit, which postpones no leaf), each with the lean and the
general box test. Rays: the camera rays of a frame, seeded
random rays, rays with zero direction components (NaN slabs, the general
test) and rays whose origin lies on a node's box planes, on the
2,000-triangle courtyard, a spatial-split tree and a rebuilt (LBVH) tree.
The lean box test is checked against the general one on every node for
every tame ray; tables with a NaN box plane clear `lean`, and a tree with a
child box grown past its parent's is refused. Built with
-ffp-contract=off, as the kernel is with -fmad=false."""

import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from gpu_raytracer_tpu_torch.config import RaytracerConfig
from gpu_raytracer_tpu_torch.models.scene import refit_scene
from gpu_raytracer_tpu_torch.ops.bvh_traverse import bvh_traverse_threaded
from gpu_raytracer_tpu_torch.ops.camera_rays import generate_rays
from gpu_raytracer_tpu_torch.ops.cuda.traverse import THREADED_WORDS, pack_threaded_tables
from gpu_raytracer_tpu_torch.utils.procgen import make_courtyard_scene

from test_torch_walk_host import STUBS

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "gpu_raytracer_tpu_torch", "csrc")
TRIANGLES = 2000
W, H = 96, 64
RANDOM_RAYS = 3000
F32_MAX = 3.4028234663852886e38

# The warp votes of one host thread: its own predicate, or (g_never_ready) a
# warp whose other lanes walk on and never hold a leaf.
VOTE_STUBS = r"""
static bool g_never_ready = false;
inline bool __any_sync(unsigned, bool p) { return p; }
inline bool __all_sync(unsigned, bool p) { return g_never_ready ? false : p; }
"""

# Reads nodes.bin, tris.bin, rays.bin (o, d, max_t per ray); walks every ray
# with both votes and both box tests and writes the kernel's (threaded_walk)
# t and slot, and the visits the never-ready walk made with a leaf pending,
# per ray to out.bin; exits 3 where two walks differ, 5 where a lane alone
# walked past a leaf. "boxes": for every tame ray, the lean box test against
# the general one on every node, at best_t max_t and 1; writes the number of
# differing tests and of tests made.
HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
#include "threaded_walk.cuh"
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

template <bool ANY, bool LEAN>
static TriHit walk_as(const float4* nodes, int n_nodes, const float4* tris, const Ray& r,
                      float max_t, int& past) {
  TriHit best{max_t, -1};
  threaded_walk_as<ANY, LEAN, true>(nodes, 2 * n_nodes + 4, tris, r, 1u, best, past);
  return best;
}

static bool same(const TriHit& a, const TriHit& b) { return a.slot == b.slot && a.t == b.t; }

template <bool ANY>
static int run(const float4* nodes, int n_nodes, bool lean, const float4* tris,
               const std::vector<float>& rays) {
  FILE* out = std::fopen("out.bin", "wb");
  for (size_t i = 0; i < rays.size() / 7; ++i) {
    const float* q = &rays[7 * i];
    const Ray r = make_ray(q[0], q[1], q[2], q[3], q[4], q[5]);
    const bool tame = lean && is_tame(r);
    int alone = 0, past = 0;
    g_never_ready = false;
    const TriHit k = threaded_walk<ANY, false>(nodes, n_nodes, lean, tris, r, q[6], 1u, alone);
    TriHit v[4] = {walk_as<ANY, false>(nodes, n_nodes, tris, r, q[6], alone), k, k, k};
    if (tame) v[1] = walk_as<ANY, true>(nodes, n_nodes, tris, r, q[6], alone);
    if (alone != 0) return 5;
    g_never_ready = true;
    v[2] = threaded_walk<ANY, true>(nodes, n_nodes, lean, tris, r, q[6], 1u, past);
    if (tame) {
      int general = 0;
      v[3] = walk_as<ANY, false>(nodes, n_nodes, tris, r, q[6], general);
    }
    for (const TriHit& h : v)
      if (!same(h, k)) return 3;
    const float t = k.slot >= 0 ? k.t : kMissT;
    std::fwrite(&t, 4, 1, out);
    std::fwrite(&k.slot, 4, 1, out);
    std::fwrite(&past, 4, 1, out);
  }
  std::fclose(out);
  return 0;
}

static int boxes(const float4* nodes, int n_nodes, const std::vector<float>& rays) {
  long tests = 0, differ = 0;
  for (size_t i = 0; i < rays.size() / 7; ++i) {
    const float* q = &rays[7 * i];
    const Ray r = make_ray(q[0], q[1], q[2], q[3], q[4], q[5]);
    if (!is_tame(r)) continue;
    for (int c = 0; c < n_nodes; ++c)
      for (const float best_t : {q[6], 1.0f}) {
        ++tests;
        differ += threaded_box<true>(nodes[2 * c], nodes[2 * c + 1], r, best_t) !=
                  threaded_box<false>(nodes[2 * c], nodes[2 * c + 1], r, best_t);
      }
  }
  FILE* out = std::fopen("out.bin", "wb");
  const long row[2] = {differ, tests};
  std::fwrite(row, 8, 2, out);
  std::fclose(out);
  return 0;
}

// threaded <any hit 0|1> <lean 0|1> [walk|boxes]
int main(int argc, char** argv) {
  const int any = std::atoi(argv[1]), lean = std::atoi(argv[2]);
  const char* mode = argc > 3 ? argv[3] : "walk";
  const auto raw = slurp<float>("nodes.bin");
  const auto tris = slurp<float>("tris.bin");
  const auto rays = slurp<float>("rays.bin");
  void* mem = std::aligned_alloc(32, (raw.size() * 4 + 31) / 32 * 32);
  std::memcpy(mem, raw.data(), raw.size() * 4);
  const auto* nodes = static_cast<const float4*>(mem);
  const int n_nodes = static_cast<int>(raw.size() / 8);
  const auto* tr = reinterpret_cast<const float4*>(tris.data());
  if (std::strcmp(mode, "boxes") == 0) return boxes(nodes, n_nodes, rays);
  return any ? run<true>(nodes, n_nodes, lean != 0, tr, rays)
             : run<false>(nodes, n_nodes, lean != 0, tr, rays);
}
"""


@pytest.fixture(scope="module")
def threaded_host(tmp_path_factory):
    """The host build of the threaded walk -> (its directory, the executable)."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.fail("g++ is needed to build the host walk")
    d = tmp_path_factory.mktemp("threaded_host")
    for name in ("traverse.cuh", "threaded_walk.cuh"):
        with open(os.path.join(CSRC, name)) as f:
            text = f.read().replace("#include <cuda_runtime.h>", '#include "stubs.h"')
        (d / name).write_text(text)
    (d / "stubs.h").write_text(STUBS + VOTE_STUBS)
    (d / "threaded.cpp").write_text(HARNESS)
    exe = d / "threaded"
    proc = subprocess.run([cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-o", str(exe),
                           str(d / "threaded.cpp")], capture_output=True, text=True, cwd=d)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return d, exe


def host_walk(build, tables, o, d, max_t, any_hit, mode="walk"):
    """The host walk over `tables` -> (t, slot, the never-ready walk's
    visits with a leaf pending) per ray ("boxes": the lean tests that differ
    from the general ones, and the tests made)."""
    directory, exe = build
    tables.nodes.numpy().tofile(directory / "nodes.bin")
    tables.tris.numpy().tofile(directory / "tris.bin")
    torch.cat([o, d, max_t[:, None]], dim=1).contiguous().numpy().tofile(directory / "rays.bin")
    proc = subprocess.run([str(exe), str(int(any_hit)), str(int(tables.lean)), mode],
                          cwd=directory)
    assert proc.returncode == 0, ("the walks differ" if proc.returncode == 3 else
                                  f"the host walk failed (exit {proc.returncode})")
    if mode == "boxes":
        return tuple(np.fromfile(directory / "out.bin", dtype=np.int64))
    out = np.fromfile(directory / "out.bin", dtype=np.int32).reshape(-1, 3)
    return out[:, 0].view(np.float32), out[:, 1], out[:, 2]


def tree(kind):
    """The 2,000-triangle courtyard: SAH (`sah`), spatial splits (`sbvh`),
    or rebuilt by the LBVH path (`lbvh`)."""
    cfg = RaytracerConfig(bvh_spatial_splits=kind == "sbvh")
    scene = make_courtyard_scene(TRIANGLES, seed=1, config=cfg, device="cpu")
    if kind == "lbvh":
        scene = refit_scene(scene, scene.mesh.vertices, rebuild=True)
    return scene


def rays(scene, seed=1):
    """Camera rays of a W x H frame; seeded random rays, 200 of them with a
    zero direction component (NaN slabs where the origin is on a plane);
    and rays from points on the planes of random nodes' boxes."""
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.int32),
                            torch.arange(W, dtype=torch.int32), indexing="ij")
    o, d = generate_rays(scene.camera, W, H, xs.reshape(-1), ys.reshape(-1))
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-20, 20, (RANDOM_RAYS, 3)).astype(np.float32)
    rd = rng.normal(size=(RANDOM_RAYS, 3)).astype(np.float32)
    rd[:100, 0] = 0.0
    rd[100:200, 1] = 0.0
    rd[150:200, 2] = 0.0
    # origins on box planes: x on a node's min.x, y on its max.y, z inside
    bvh = scene.bvh
    pick = rng.integers(0, bvh.num_nodes, RANDOM_RAYS // 2)
    lo, hi = bvh.node_min.numpy()[pick], bvh.node_max.numpy()[pick]
    half = slice(RANDOM_RAYS // 2, RANDOM_RAYS)
    ro[half, 0] = lo[:, 0]
    ro[half, 1] = hi[:, 1]
    ro[half, 2] = (lo[:, 2] + hi[:, 2]) * np.float32(0.5)
    rd[RANDOM_RAYS // 2:RANDOM_RAYS // 2 + 300, 0] = 0.0   # on the plane, along it
    rd = rd / np.linalg.norm(rd, axis=1, keepdims=True)
    return (torch.cat([o, torch.from_numpy(ro)]).contiguous(),
            torch.cat([d, torch.from_numpy(rd.astype(np.float32))]).contiguous())


def plain(scene, o, d, max_t, any_hit):
    t, slot, hit = bvh_traverse_threaded(scene.bvh, scene.tri_v0, scene.tri_e1, scene.tri_e2,
                                         o, d, max_t, leaf_size=scene.bvh.max_leaf,
                                         any_hit=any_hit)
    return t.numpy(), slot.numpy(), hit.numpy()


def shadow_rays(scene, o, d):
    """From every plain closest hit toward the point light, ending 1e-3
    short of it (chip_smoke.py phase 24's shadow rays)."""
    t, slot, hit = plain(scene, o, d, torch.full((o.shape[0],), F32_MAX), False)
    hit = torch.from_numpy(hit)
    p = o[hit] + d[hit] * torch.from_numpy(t)[hit, None]
    L = scene.lights
    to_light = L.position[int(torch.nonzero(L.light_type == 1)[0])][None, :] - p
    dist = torch.sqrt((to_light * to_light).sum(dim=1))
    return (p.contiguous(), (to_light / dist[:, None]).contiguous(),
            (dist * 0.999).contiguous())


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("kind", ["sah", "sbvh", "lbvh"])
def test_host_threaded_walk_matches_the_plain_walk(threaded_host, kind, any_hit):
    scene = tree(kind)
    tables = pack_threaded_tables(scene)
    assert tables.nodes.shape == (scene.bvh.num_nodes, THREADED_WORDS)
    assert tables.lean
    o, d = rays(scene)
    if any_hit:
        o, d, max_t = shadow_rays(scene, o, d)
    else:
        max_t = torch.full((o.shape[0],), F32_MAX)
    t, slot, past = host_walk(threaded_host, tables, o, d, max_t, any_hit)
    pt, ps, ph = plain(scene, o, d, max_t, any_hit)
    assert np.array_equal(slot >= 0, ph) and 0 < ph.sum() < ph.size
    # closest hit: the never-ready walk did walk past pending leaves, on
    # many rays; any hit postpones none
    assert (past == 0).all() if any_hit else (past > 0).sum() > 0.1 * past.size
    assert np.array_equal(slot, ps)
    assert np.array_equal(t.view(np.int32), pt.view(np.int32))


@pytest.mark.parametrize("kind", ["sah", "sbvh"])
def test_lean_box_test_equals_the_general_one_on_every_node(threaded_host, kind):
    scene = tree(kind)
    tables = pack_threaded_tables(scene)
    o, d = rays(scene)
    differ, tests = host_walk(threaded_host, tables, o, d, torch.full((o.shape[0],), F32_MAX),
                              False, mode="boxes")
    assert differ == 0 and tests > 2 * scene.bvh.num_nodes * W * H


def test_table_flags_follow_the_boxes_and_the_walk_stays_exact(threaded_host):
    """A NaN box plane clears `lean` (the general test for every ray), and
    the walk still equals the plain one bit for bit; a child box grown past
    its parent's is refused (a lane walking past a pending leaf could enter
    it against a stale best_t)."""
    import dataclasses

    base = tree("sah")
    bvh = base.bvh
    leaves = torch.nonzero(bvh.left < 0).squeeze(1)
    for broken in ("nan", "grown"):
        lo, hi = bvh.node_min.clone(), bvh.node_max.clone()
        if broken == "nan":
            lo[leaves[::7], 1] = float("nan")
        else:
            hi[leaves[::5]] += 0.75
        scene = dataclasses.replace(base, bvh=dataclasses.replace(bvh, node_min=lo,
                                                                  node_max=hi))
        if broken == "grown":
            with pytest.raises(ValueError, match="inside its parent"):
                pack_threaded_tables(scene)
            continue
        tables = pack_threaded_tables(scene)
        assert not tables.lean
        o, d = rays(scene)
        for any_hit in (False, True):
            if any_hit:
                ro, rd, rm = shadow_rays(scene, o, d)
            else:
                ro, rd, rm = o, d, torch.full((o.shape[0],), F32_MAX)
            t, slot, _ = host_walk(threaded_host, tables, ro, rd, rm, any_hit)
            pt, ps, ph = plain(scene, ro, rd, rm, any_hit)
            assert np.array_equal(slot, ps) and ph.any()
            assert np.array_equal(t.view(np.int32), pt.view(np.int32))


def test_packer_refuses_leaves_it_cannot_code():
    """A leaf whose hit link is not its miss link, or whose count does not
    fit its code's four bits, is refused."""
    import dataclasses

    scene = tree("sah")
    bvh = scene.bvh
    leaf = torch.nonzero(bvh.left < 0).squeeze(1)[3]
    for field, value in (("tri_count", 16), ("miss_link", 0)):
        x = getattr(bvh, field).clone()
        x[leaf] = value
        bad = dataclasses.replace(scene, bvh=dataclasses.replace(bvh, **{field: x}))
        with pytest.raises(ValueError):
            pack_threaded_tables(bad)
