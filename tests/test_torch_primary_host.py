"""K2's and K2t's pixel (csrc/primary_pixel.cuh) compiled for the host and
held to the plain render, on the CPU.

The fused frame kernels only build on the card, but their per-pixel body,
`primary_pixel`, is plain C++ over a few CUDA names. With the stand-ins of
tests/test_torch_walk_host.py and a few more (half rounding, byte select)
g++ compiles it as it is, with the walk (traverse.cuh), the shared render
functions (render_common.cuh) and the texture sampler (texsample.cuh), and
a harness renders every pixel of a frame with it. Built with
-ffp-contract=off, as the kernels are with -fmad=false.

At node width 8, and for K2t at width 4, the pixel's camera walk reads the
camera-relative tables (`camera_relative_tables`, the plain version of K3's
pre-pass) and its material step is split around the light loop. Each frame
must equal `ops/render.py::render_chunk` bit for bit: the untextured
courtyard (K2), the textured courtyard (K2t, base-colour maps) and the
multi-slot zoo (K2t: base-colour, metallic-roughness, occlusion and
emissive maps, so both halves of the split sample), at both widths,
shadows off and on, every light or one sampled light (`light_u`), at the
scene's camera and at a moved one. The same frame must come out of a K2t
or width-8 pixel over the ordinary tables and with the material step whole
(those choices change no bit), and K2's width-4 pixel (which takes
neither) is held to the same plain frame.

One deviation is declared: PyTorch's vectorised CPU sqrt is not correctly
rounded (an ulp off on ~0.6% of inputs, e.g. sqrt(60.375534) gives
7.7701693, IEEE 7.7701697), while the card's, like the kernels' sqrtf, is.
The plain frame the pixel is held to bit for bit is `render_chunk` with
`torch.sqrt` correctly rounded (through float64, exact for float32): the
arithmetic the plain version does on the card. Against the stock CPU
`render_chunk` the pixels that differ are counted (at most 1% of a frame;
up to 1.1e-5 apart where a moved uv moves a texture sample) and the rest
are the same bits."""

import dataclasses
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from gpu_raytracer_tpu_torch.config import RaytracerConfig
from gpu_raytracer_tpu_torch.ops.render import render_chunk
from gpu_raytracer_tpu_torch.models.camera import Camera
from gpu_raytracer_tpu_torch.ops.cuda.render import (camera_relative_tables, pack_render_tables,
                                                     set_camera)
from gpu_raytracer_tpu_torch.ops.cuda.texshade import pack_shade_tables
from gpu_raytracer_tpu_torch.ops.shading import pixel_footprint_scale
from gpu_raytracer_tpu_torch.utils.procgen import make_courtyard_scene, make_zoo_scene

from test_torch_walk_host import STUBS

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "gpu_raytracer_tpu_torch", "csrc")
HEADERS = ("traverse.cuh", "render_common.cuh", "texsample.cuh", "primary_pixel.cuh")
TRIANGLES = 4000
W, H = 160, 90
STACK = 32      # the stack both widths' tables of these scenes take
SKY = (0.1, 0.2, 0.3)
MOVED = ((7.25, 3.5, -11.0), (-0.4, -0.3, 0.85))   # across the courtyard, looking down
CPU_SQRT_SHARE = 0.01    # pixels off the stock CPU frame, share of the frame

# The CUDA names the render functions and the sampler use beyond the walk's.
MORE_STUBS = r"""
#include <algorithm>
#include <cmath>
struct int2 { int x, y; };
struct float2 { float x, y; };
inline float2 make_float2(float x, float y) { return float2{x, y}; }
inline float4 make_float4(float x, float y, float z, float w) { return float4{x, y, z, w}; }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
inline float __int_as_float(int i) { float x; std::memcpy(&x, &i, 4); return x; }
// f16 round to nearest even and back (the kernels' __float2half_rn)
struct __half { _Float16 h; };
inline __half __float2half_rn(float x) { return __half{static_cast<_Float16>(x)}; }
inline float __half2float(__half x) { return static_cast<float>(x.h); }
// byte k of the result is byte (selector nibble k & 7) of {y, x}
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
  const unsigned long long v = (static_cast<unsigned long long>(y) << 32) | x;
  unsigned r = 0;
  for (int k = 0; k < 4; ++k) r |= ((v >> (8 * ((s >> (4 * k)) & 7))) & 0xFFull) << (8 * k);
  return r;
}
"""

# Reads the frame's tables and pixels, renders every pixel with one
# instance of primary_pixel, writes rgb.bin.
HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
#include "primary_pixel.cuh"
using namespace rt;

template <class T> static std::vector<T> slurp(const char* path) {
  std::vector<T> v;
  FILE* f = std::fopen(path, "rb");
  if (f == nullptr) return v;
  std::fseek(f, 0, SEEK_END);
  const long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  v.resize(n / sizeof(T));
  if (std::fread(v.data(), 1, n, f) != static_cast<size_t>(n)) std::exit(4);
  std::fclose(f);
  return v;
}

static const void* aligned_copy(const std::vector<float>& raw) {
  void* mem = std::aligned_alloc(256, (raw.size() * 4 + 255) / 256 * 256);
  std::memcpy(mem, raw.data(), raw.size() * 4);
  return mem;
}

// params.bin: n, width, height, shadows, n_mats, n_lights, n_spheres,
// light_u given, present, n_levels (int32), then sky r, g, b, pix_scale (f32)
template <int W, bool TEXTURED, bool REL, bool SPLIT>
static int run() {
  const auto p = slurp<int>("params.bin");
  const int n = p[0], width = p[1], height = p[2], shadows = p[3], n_mats = p[4];
  const int n_lights = p[5], n_spheres = p[6], with_u = p[7];
  float f[4];
  std::memcpy(f, &p[10], 16);
  const auto nodes = slurp<float>("nodes.bin"), tris = slurp<float>("tris.bin");
  const auto rel_nodes = slurp<float>("rel_nodes.bin"), rel_tris = slurp<float>("rel_tris.bin");
  const auto cam = slurp<float>("cam.bin"), mats = slurp<float>("mats.bin");
  const auto lights = slurp<float>("lights.bin"), spheres = slurp<float>("spheres.bin");
  const auto px = slurp<int>("px.bin"), py = slurp<int>("py.bin");
  const auto light_u = slurp<float>("light_u.bin");
  const auto attrs = slurp<float>("attrs.bin");
  const auto maps = slurp<int>("maps.bin"), atlas = slurp<int>("atlas.bin");
  const PrimaryTextures tex{reinterpret_cast<const float4*>(attrs.data()),
                            reinterpret_cast<const TexMeta*>(maps.data()),
                            reinterpret_cast<const int2*>(atlas.data()), p[8], p[9], f[3]};
  const auto* node_ptr = static_cast<const Node<W>*>(aligned_copy(nodes));
  const auto* rel_ptr = static_cast<const Node<W>*>(aligned_copy(rel_nodes));
  std::vector<float> rgb(3 * n);
  for (int i = 0; i < n; ++i)
    primary_pixel<W, 32, TEXTURED, REL, SPLIT>(
        node_ptr, reinterpret_cast<const float4*>(tris.data()), cam.data(), mats.data(),
        n_mats, lights.data(), n_lights, spheres.data(), n_spheres, tex, px.data(), py.data(),
        i, width, height, shadows, f[0], f[1], f[2], with_u ? light_u.data() : nullptr,
        rgb.data(), rel_ptr, reinterpret_cast<const float4*>(rel_tris.data()));
  FILE* out = std::fopen("rgb.bin", "wb");
  std::fwrite(rgb.data(), 4, rgb.size(), out);
  std::fclose(out);
  return 0;
}

// pixel <width> <textured 0|1> <variant: kernel | ordinary | whole>
//   kernel: the instance the kernel takes; ordinary: its camera walk over
//   the ordinary tables; whole: its material step unsplit
template <int W, bool T>
static int variant(const char* v) {
  constexpr bool rel = kPrimaryRel<W, T>, split = kPrimarySplit<W, T>;
  if (!std::strcmp(v, "kernel")) return run<W, T, rel, split>();
  if (!std::strcmp(v, "ordinary")) return run<W, T, false, split>();
  if (!std::strcmp(v, "whole")) return run<W, T, rel, false>();
  return 2;
}

int main(int argc, char** argv) {
  const int width = std::atoi(argv[1]), textured = std::atoi(argv[2]);
  if (width == 4) return textured ? variant<4, true>(argv[3]) : variant<4, false>(argv[3]);
  if (width == 8) return textured ? variant<8, true>(argv[3]) : variant<8, false>(argv[3]);
  return 2;
}
"""


@pytest.fixture(scope="module")
def pixel_host(tmp_path_factory):
    """The host build of the pixel -> (its directory, the executable)."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.fail("g++ is needed to build the host pixel")
    d = tmp_path_factory.mktemp("pixel_host")
    for name in HEADERS:
        with open(os.path.join(CSRC, name)) as f:
            text = f.read()
        for inc in ("#include <cuda_runtime.h>", "#include <cuda_fp16.h>"):
            text = text.replace(inc, '#include "stubs.h"')
        (d / name).write_text(text)
    (d / "stubs.h").write_text(STUBS + MORE_STUBS)
    (d / "pixel.cpp").write_text(HARNESS)
    exe = d / "pixel"
    proc = subprocess.run([cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-o", str(exe),
                           str(d / "pixel.cpp")], capture_output=True, text=True, cwd=d)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return d, exe


@pytest.fixture(scope="module")
def scenes():
    """(tables, shade tables or None) of each scene at each width, packed once."""
    cache = {}

    def get(name, width):
        if (name, width) not in cache:
            cfg = RaytracerConfig(bvh_width=width)
            if name == "courtyard":
                scene = make_courtyard_scene(TRIANGLES, seed=0, config=cfg, device="cpu")
            elif name == "textured_courtyard":   # base-colour maps on the floor and boxes
                scene = make_courtyard_scene(TRIANGLES, seed=0, config=cfg, textured=True,
                                             device="cpu")
            else:   # every map kind of the sampler, glass and emission
                scene = make_zoo_scene(TRIANGLES, n_mats=12, n_texs=8, seed=0, multi_slot=True,
                                       config=cfg, device="cpu")
            tables = pack_render_tables(scene)
            shade = pack_shade_tables(scene) if scene.textures.textured else None
            assert tables.trace.width == width and tables.trace.stack == STACK
            cache[name, width] = (tables, shade)
        return cache[name, width]

    return get


def pixel_frame(build, tables, shade, px, py, shadows, light_u, variant="kernel"):
    """Every pixel of (px, py) through the host pixel -> RGB [N,3] f32."""
    directory, exe = build
    tr = tables.trace
    rel_nodes, rel_tris = camera_relative_tables(tables)
    files = dict(nodes=tr.nodes, tris=tr.tris, rel_nodes=rel_nodes, rel_tris=rel_tris,
                 cam=tables.camera, mats=tables.materials, lights=tables.lights,
                 spheres=tables.spheres, px=px, py=py)
    textured = shade is not None
    if textured:   # the maps and their level records are one buffer (texshade.py)
        files.update(attrs=tr.attrs, atlas=shade.atlas,
                     maps=torch.cat([shade.maps.reshape(-1), shade.levels.reshape(-1)]))
    if light_u is not None:
        files["light_u"] = light_u
    for name in ("attrs", "maps", "atlas", "light_u"):
        (directory / f"{name}.bin").unlink(missing_ok=True)
    for name, x in files.items():
        x.contiguous().numpy().tofile(directory / f"{name}.bin")
    pix = pixel_footprint_scale(tables.fov_scale, H) if textured else 0.0
    ints = np.int32([px.shape[0], W, H, int(shadows), tables.materials.shape[0],
                     tables.lights.shape[0], tables.spheres.shape[0], int(light_u is not None),
                     shade.present if textured else 0, shade.n_levels if textured else 1])
    np.concatenate([ints, np.float32([*SKY, pix]).view(np.int32)]).tofile(
        directory / "params.bin")
    subprocess.run([str(exe), str(tr.width), str(int(textured)), variant], check=True,
                   cwd=directory)
    return np.fromfile(directory / "rgb.bin", dtype=np.float32).reshape(-1, 3)


def moved_copy(tables):
    """The tables at the moved camera (a copy: the module's keep theirs)."""
    rt = dataclasses.replace(tables, camera=tables.camera.clone(),
                             trace=dataclasses.replace(tables.trace))
    set_camera(rt, Camera.create(*MOVED))
    return rt


_TORCH_SQRT = torch.sqrt


def correctly_rounded_sqrt(x, *args, **kwargs):
    """torch.sqrt rounded as IEEE float32 sqrt is (the card's): the float64
    root rounded to float32 (53 >= 2 * 24 + 2 bits, so exact)."""
    if x.dtype != torch.float32 or args or kwargs:
        return _TORCH_SQRT(x, *args, **kwargs)
    return _TORCH_SQRT(x.double()).float()


@pytest.mark.parametrize("light_u", [False, True], ids=["every_light", "light_u"])
@pytest.mark.parametrize("shadows", [False, True], ids=["no_shadows", "shadows"])
@pytest.mark.parametrize("camera", ["scene", "moved"])
@pytest.mark.parametrize("width", [4, 8])
@pytest.mark.parametrize("name", ["courtyard", "textured_courtyard", "zoo_multi_slot"])
def test_host_pixel_matches_render_chunk_bit_for_bit(pixel_host, scenes, name, width, camera,
                                                     shadows, light_u):
    tables, shade = scenes(name, width)
    if camera == "moved":
        tables = moved_copy(tables)
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.int32),
                            torch.arange(W, dtype=torch.int32), indexing="ij")
    px, py = xs.reshape(-1).contiguous(), ys.reshape(-1).contiguous()
    u = (torch.from_numpy(np.random.default_rng(3).random(W * H, dtype=np.float32))
         if light_u else None)
    plain = lambda: render_chunk(tables.scene, px, py, W, H, shadows=shadows, sky=SKY,
                                 light_u=u).numpy()
    stock = plain()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "sqrt", correctly_rounded_sqrt)
        want = plain()
    assert (want != np.float32(SKY[0])).any() and np.isfinite(want).all()
    variants = ("kernel", "ordinary", "whole") if width == 8 or shade is not None else ("kernel",)
    for variant in variants:
        got = pixel_frame(pixel_host, tables, shade, px, py, shadows, u, variant)
        off = (got.view(np.int32) != want.view(np.int32)).any(axis=1)
        assert not off.any(), (f"{variant}: {int(off.sum())} pixels differ, max |diff| "
                               f"{np.abs(got - want).max():.3g}")
    counted = (got.view(np.int32) != stock.view(np.int32)).any(axis=1)
    assert counted.sum() <= CPU_SQRT_SHARE * counted.size
    print(f"{name} width {width} {camera} shadows={shadows} light_u={light_u}: bit for bit "
          f"({len(variants)} variants); {int(counted.sum())} pixels off the stock CPU frame, "
          f"max |diff| {np.abs(got - stock).max():.3g}")

