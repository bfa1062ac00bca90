"""K6: one wavefront bounce of the path tracer's pool, one ray per thread
(CUDA), with K5 (the material sampler) inside it on textured scenes.

K6 replaces the TPU kernel `gpu_raytracer_tpu/ops/pallas/bounce.py`
(`pallas_bounce` -> `_kernel`). Kernel source: csrc/bounce.cuh (instances
in csrc/bounce.cu and csrc/bounce_textured.cu), which reuses K2's sphere
pass, K1's closest and any-hit traversal, the per-light intensity and the
dispersion blend (csrc/render_common.cuh), at the node table's width (the
width-8 instances compile in csrc/bounce_w8.cu and bounce_textured_w8.cu).
`fused_bounce_` is its wrapper:
it updates the pool and the radiance IN PLACE, visits only the live lanes
in the coherence order it is handed, and on the card computes each lane's
QMC uniforms inside the kernel. Its plain version is
`ops/wavefront.py::bounce_` (built on `bounce`, the functional form).
`fused_bounce` is the functional form of the same kernel (pool in, new
pool and radiance out, the uniforms given), for checks against `bounce`.

`qmc_uniforms_kernel` launches the kernel's QMC stream on its own
(csrc/qmc.cu) so that it can be held bit for bit against
`ops/sampler.py::qmc_uniforms`; the path tracer never calls it.

K5 replaces the TPU subroutine `gpu_raytracer_tpu/ops/pallas/texshade.py`
`sample_materials_tiles`: on the card it is the device function
`sample_material` of csrc/texsample.cuh, which K6 calls once per textured
hit. `sample_materials` below launches it on its own (csrc/materials.cu)
so that it can be held against its plain version
(`ops/shading.py::sample_materials`) and timed; the path tracer never
calls that launch.

The tables are the render kernels' (ops/cuda/render.py, whose material
rows carry roughness in word 9) and, for a textured scene, the texture
shade kernel's maps and atlas (ops/cuda/texshade.py).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ...models.scene import Scene
from ..sampler import MASK32, QmcStream, lattice_words, mul32, pcg_hash
from ..shading import sample_materials as plain_sample_materials
from ..wavefront import bounce, bounce_
from .build import check, load_kernels, tally
from .render import RenderTables, pack_render_tables
from .texshade import ShadeTables, pack_shade_tables
from .traverse import nodes_ptr

# lighting modes and continuations of the kernel (csrc/bounce.cuh)
NEE_NONE, NEE_ALL, NEE_SAMPLED = 0, 1, 2
CONTINUE, CONTINUE_RR, LAST = 0, 1, 2
MATERIAL_CHANNELS = 11   # albedo 3, emission 3, metallic, roughness, IOR, transmission, occlusion


@dataclass
class BounceTables:
    render: RenderTables
    shade: ShadeTables | None   # maps and atlas of a textured scene

    @property
    def scene(self) -> Scene:
        return self.render.scene

    @property
    def device(self) -> torch.device:
        return self.render.trace.device


def pack_bounce_tables(scene: Scene) -> BounceTables:
    """The bounce kernel's tables of a scene, on the scene's device."""
    shade = pack_shade_tables(scene) if scene.textures.textured else None
    return BounceTables(pack_render_tables(scene), shade)


def _check(name: str, x: torch.Tensor, dtype, shape, device) -> None:
    if x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous():
        raise ValueError(f"{name}: want contiguous {dtype} {shape}, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, the tables on {device}")


def qmc_words(stream: QmcStream, depth: int, chunk: int):
    """The kernel's view of `stream` at bounce `depth` for a pool of `chunk`
    lanes per sample: 4 + 2 * 7 uint32 host words (pixel id base, sample
    base, the depth's rotation hash, chunk, the lattice generators and the
    rotation salts), everything `ops/sampler.py::qmc_uniforms` derives
    before it touches a lane."""
    hd = pcg_hash((mul32(int(depth) & MASK32, 0x9E3779B9) + (int(stream.seed) & MASK32))
                  & MASK32)
    words = [int(stream.pid_base) & MASK32, int(stream.sample_base) & MASK32, hd, int(chunk),
             *lattice_words()]
    return (ctypes.c_uint32 * len(words))(*words)


def _check_pool(tables: BounceTables, r, order, n_live, u, radiance=None) -> int:
    N = r.count
    dev = tables.device
    f32, i32 = torch.float32, torch.int32
    wanted = [("origin", r.origin, f32, (N, 3)), ("direction", r.direction, f32, (N, 3)),
              ("throughput", r.throughput, f32, (N, 3)), ("medium_ior", r.medium_ior, f32, (N,)),
              ("wavelength_channel", r.wavelength_channel, i32, (N,)),
              ("ray_type", r.ray_type, i32, (N,)), ("bounce_depth", r.bounce_depth, i32, (N,)),
              ("active", r.active, torch.bool, (N,))]
    if radiance is not None:
        wanted.append(("radiance", radiance, f32, (N, 3)))
    if order is not None:
        wanted.append(("order", order, i32, (N,)))
    if n_live is not None:
        wanted.append(("n_live", n_live, torch.int64, ()))
    if u is not None:
        wanted.append(("u", u, f32, (N, 7)))
    for name, x, dtype, shape in wanted:
        _check(name, x, dtype, shape, dev)
    return N


def fused_bounce_(tables: BounceTables, r, radiance: torch.Tensor, *, depth: int = 0,
                  order: torch.Tensor | None = None, n_live: torch.Tensor | None = None,
                  u: torch.Tensor | None = None, qmc: QmcStream | None = None,
                  shadows: bool, do_rr: bool, light_sample: bool = False,
                  tex_lod: float = 0.0, last: bool = False) -> None:
    """One bounce of pool `r` (ops/wavefront.py WavefrontRays) IN PLACE:
    every live lane's continuation is written over the lane (or the lane is
    retired) and its radiance is added to `radiance` [N,3]; a dead lane is
    left as it is. The arguments of `ops/wavefront.py::bounce_`:

    order   [N] int32, sorted position -> lane (the coherence order, dead
            lanes last), or None for position = lane;
    n_live  0-d int64 on the pool's device: only the first n_live positions
            are worked on (never read by the host), or None for all;
    u       [N,7] f32 uniforms BY POSITION (an independent stream), or None
            for the QMC numbers of `qmc` at `depth`, which follow the
            lane's identity: on the card the kernel computes them itself.

    CUDA tensors launch the kernel, CPU tensors take the plain version."""
    if (u is None) == (qmc is None):
        raise ValueError("fused_bounce_: give the uniforms `u` or the QMC stream `qmc`")
    N = _check_pool(tables, r, order, n_live, u, radiance)
    dev = tables.device
    flags = dict(shadows=shadows, do_rr=do_rr, light_sample=light_sample, tex_lod=tex_lod,
                 last=last)
    if dev.type == "cpu":
        return bounce_(tables.scene, r, radiance, depth=depth, order=order, n_live=n_live,
                       u=u, qmc=qmc, **flags)
    if dev.type != "cuda":
        raise ValueError(f"fused_bounce_: unsupported device {dev}")
    k = load_kernels()
    rt, sh = tables.render, tables.shade
    n_lights = rt.lights.shape[0]
    nee = (NEE_NONE if not shadows
           else NEE_SAMPLED if light_sample and n_lights > 1 else NEE_ALL)
    cont = LAST if last else CONTINUE_RR if do_rr else CONTINUE
    textured = sh is not None
    maps = sh.maps.data_ptr() if textured else None
    atlas = sh.atlas.data_ptr() if textured else None
    ptr = lambda x: None if x is None else x.data_ptr()
    words = None if qmc is None else qmc_words(qmc, depth, N // qmc.spp)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tr = rt.trace
    nodes = nodes_ptr(tr)
    tally("k6", tr.width)
    if textured:   # each runs K5 per hit
        tally("k5", tr.width)
    check(k.lib.rt_bounce(
        nodes, tr.tris.data_ptr(), tr.attrs.data_ptr(), tr.width, tr.stack,
        rt.materials.data_ptr(), rt.materials.shape[0], rt.lights.data_ptr(), n_lights,
        rt.spheres.data_ptr(), rt.spheres.shape[0], maps, atlas,
        sh.present if textured else 0, sh.n_levels if textured else 1, int(textured),
        float(tex_lod), r.origin.data_ptr(), r.direction.data_ptr(), r.throughput.data_ptr(),
        r.medium_ior.data_ptr(), r.wavelength_channel.data_ptr(), r.ray_type.data_ptr(),
        r.bounce_depth.data_ptr(), r.active.data_ptr(), radiance.data_ptr(), N, ptr(order),
        ptr(n_live), ptr(u), words, nee, cont, stream), "rt_bounce")


def fused_bounce(tables: BounceTables, r, u: torch.Tensor, *, shadows: bool, do_rr: bool,
                 light_sample: bool = False, tex_lod: float = 0.0, last: bool = False):
    """The functional form: one bounce of pool `r` with uniforms u [N,7] f32
    by lane -> (next pool, radiance [N,3] f32), the arguments and the result
    of `ops/wavefront.py::bounce`; `r` is left as it was. On CUDA tensors it
    is `fused_bounce_` (the kernel) on a copy of the pool; CPU tensors take
    the plain `bounce`."""
    flags = dict(shadows=shadows, do_rr=do_rr, light_sample=light_sample, tex_lod=tex_lod,
                 last=last)
    if tables.device.type == "cpu":
        _check_pool(tables, r, None, None, u)
        return bounce(tables.scene, r, u, **flags)
    out = r.clone()
    rad = torch.zeros_like(r.origin)
    fused_bounce_(tables, out, rad, u=u, **flags)
    return out, rad


def qmc_uniforms_kernel(qmc: QmcStream, depth: int, n: int, device) -> torch.Tensor:
    """The bounce kernel's own QMC numbers of lanes 0..n-1 of an n-lane pool
    of `qmc.spp` samples at bounce `depth` -> [n,7] f32, by a standalone
    launch of the kernel's stream (csrc/qmc.cu). Bit-equal to
    `ops/wavefront.py::pool_uniforms`. Only on a CUDA device."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"qmc_uniforms_kernel: the kernel's stream runs on CUDA, got {dev}")
    k = load_kernels()
    out = torch.empty((n, 7), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tally("qmc")
    check(k.lib.rt_qmc_uniforms(qmc_words(qmc, depth, n // qmc.spp), n, out.data_ptr(), stream),
          "rt_qmc_uniforms")
    return out


def material_channels(scene: Scene, mat_id: torch.Tensor, uv: torch.Tensor,
                      lod: float = 0.0) -> torch.Tensor:
    """The plain version of the K5 launch below: ops/shading.py's
    `sample_materials` as [N,11] f32 channels, occlusion 1 without a map."""
    mid = torch.clamp(mat_id.long(), 0, scene.materials.count - 1)
    m = plain_sample_materials(scene, mid, uv, lod=lod if lod > 0.0 else None)
    occ = m.occlusion if m.occlusion is not None else torch.ones_like(m.metallic)
    return torch.cat([m.albedo, m.emission, torch.stack(
        [m.metallic, m.roughness, m.ior, m.transmission, occ], dim=1)], dim=1)


def sample_materials(tables: BounceTables, mat_id: torch.Tensor, uv: torch.Tensor,
                     lod: float = 0.0) -> torch.Tensor:
    """K5 on its own: the material of ids `mat_id` [N] int32 (clamped to the
    table) at uvs [N,2] f32, every map at level `lod` -> [N,11] f32
    (albedo, emission, metallic, roughness, IOR, transmission, occlusion).
    CUDA tensors launch the kernel, CPU tensors take the plain version."""
    N = mat_id.shape[0]
    dev = tables.device
    _check("mat_id", mat_id, torch.int32, (N,), dev)
    _check("uv", uv, torch.float32, (N, 2), dev)
    if dev.type == "cpu":
        return material_channels(tables.scene, mat_id, uv, lod)
    if dev.type != "cuda":
        raise ValueError(f"sample_materials: unsupported device {dev}")
    sh = tables.shade
    if sh is None:
        raise ValueError("sample_materials: the scene has no textures")
    k = load_kernels()
    out = torch.empty((N, MATERIAL_CHANNELS), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tally("k5_standalone")
    check(k.lib.rt_sample_materials(
        sh.materials.data_ptr(), sh.materials.shape[0], sh.maps.data_ptr(), sh.atlas.data_ptr(),
        sh.present, sh.n_levels, mat_id.data_ptr(), uv.data_ptr(), float(lod), N,
        out.data_ptr(), stream), "rt_sample_materials")
    return out
