"""K6: one wavefront bounce of the path tracer's pool, one ray per thread
(CUDA), with K5 (the material sampler) inside it on textured scenes.

K6 replaces the TPU kernel `gpu_raytracer_tpu/ops/pallas/bounce.py`
(`pallas_bounce` -> `_kernel`). Kernel source: csrc/bounce.cuh (instances
in csrc/bounce.cu and csrc/bounce_textured.cu), which reuses K2's sphere
pass, K1's closest and any-hit traversal, the per-light intensity and the
dispersion blend (csrc/render_common.cuh). Its plain version is
`ops/wavefront.py::bounce`.

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

from dataclasses import dataclass

import torch

from ...models.scene import Scene
from .build import check, load_kernels
from .render import RenderTables, pack_render_tables
from .texshade import ShadeTables, pack_shade_tables

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


def fused_bounce(tables: BounceTables, r, u: torch.Tensor, *, shadows: bool, do_rr: bool,
                 light_sample: bool = False, tex_lod: float = 0.0, last: bool = False):
    """One bounce of pool `r` (ops/wavefront.py WavefrontRays) with
    uniforms u [N,7] f32 -> (next pool, radiance [N,3] f32), the arguments
    of `ops/wavefront.py::bounce`. CUDA tensors launch the kernel, CPU
    tensors take the plain version."""
    from ..wavefront import bounce

    N = r.count
    dev = tables.device
    f32, i32 = torch.float32, torch.int32
    for name, x, dtype, shape in (
            ("origin", r.origin, f32, (N, 3)), ("direction", r.direction, f32, (N, 3)),
            ("throughput", r.throughput, f32, (N, 3)), ("medium_ior", r.medium_ior, f32, (N,)),
            ("wavelength_channel", r.wavelength_channel, i32, (N,)),
            ("ray_type", r.ray_type, i32, (N,)), ("bounce_depth", r.bounce_depth, i32, (N,)),
            ("active", r.active, torch.bool, (N,)), ("u", u, f32, (N, 7))):
        _check(name, x, dtype, shape, dev)
    if dev.type == "cpu":
        return bounce(tables.scene, r, u, shadows=shadows, do_rr=do_rr,
                      light_sample=light_sample, tex_lod=tex_lod, last=last)
    if dev.type != "cuda":
        raise ValueError(f"fused_bounce: unsupported device {dev}")
    k = load_kernels()
    rt, sh = tables.render, tables.shade
    n_lights = rt.lights.shape[0]
    nee = (NEE_NONE if not shadows
           else NEE_SAMPLED if light_sample and n_lights > 1 else NEE_ALL)
    cont = LAST if last else CONTINUE_RR if do_rr else CONTINUE
    empty = lambda shape, dtype: torch.empty(shape, dtype=dtype, device=dev)
    no, nd, nthr, rad = (empty((N, 3), f32) for _ in range(4))
    nmed = empty((N,), f32)
    nchan, nrt, ndepth = (empty((N,), i32) for _ in range(3))
    nact = empty((N,), torch.bool)
    textured = sh is not None
    maps = sh.maps.data_ptr() if textured else None
    atlas = sh.atlas.data_ptr() if textured else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    fused_bounce.launches += 1
    if textured:
        fused_bounce.material_launches += 1
    tr = rt.trace
    check(k.lib.rt_bounce(
        tr.nodes.data_ptr(), tr.tris.data_ptr(), tr.attrs.data_ptr(), tr.stack,
        rt.materials.data_ptr(), rt.materials.shape[0], rt.lights.data_ptr(), n_lights,
        rt.spheres.data_ptr(), rt.spheres.shape[0], maps, atlas,
        sh.present if textured else 0, sh.n_levels if textured else 1, int(textured),
        float(tex_lod), r.origin.data_ptr(), r.direction.data_ptr(), r.throughput.data_ptr(),
        r.medium_ior.data_ptr(), r.wavelength_channel.data_ptr(), r.ray_type.data_ptr(),
        r.bounce_depth.data_ptr(), r.active.data_ptr(), u.data_ptr(), N, nee, cont,
        no.data_ptr(), nd.data_ptr(), nthr.data_ptr(), nmed.data_ptr(), nchan.data_ptr(),
        nrt.data_ptr(), ndepth.data_ptr(), nact.data_ptr(), rad.data_ptr(), stream),
        "rt_bounce")
    return r.replace(origin=no, direction=nd, throughput=nthr, medium_ior=nmed,
                     wavelength_channel=nchan, ray_type=nrt, bounce_depth=ndepth,
                     active=nact), rad


fused_bounce.launches = 0            # K6 launches
fused_bounce.material_launches = 0   # of which textured: each runs K5 per hit


def material_channels(scene: Scene, mat_id: torch.Tensor, uv: torch.Tensor,
                      lod: float = 0.0) -> torch.Tensor:
    """The plain version of the K5 launch below: ops/shading.py's
    `sample_materials` as [N,11] f32 channels, occlusion 1 without a map."""
    from ..shading import sample_materials as plain

    mid = torch.clamp(mat_id.long(), 0, scene.materials.count - 1)
    m = plain(scene, mid, uv, lod=lod if lod > 0.0 else None)
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
    sample_materials.launches += 1
    check(k.lib.rt_sample_materials(
        sh.materials.data_ptr(), sh.materials.shape[0], sh.maps.data_ptr(), sh.atlas.data_ptr(),
        sh.present, sh.n_levels, mat_id.data_ptr(), uv.data_ptr(), float(lod), N,
        out.data_ptr(), stream), "rt_sample_materials")
    return out


sample_materials.launches = 0
