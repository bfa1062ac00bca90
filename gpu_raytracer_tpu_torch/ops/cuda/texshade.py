"""K4: texture shading of the deferred G-buffer, one ray per thread (CUDA).

Replaces the TPU kernel `gpu_raytracer_tpu/ops/pallas/texshade.py`
(`pallas_texture_shade` -> `_kernel`): the second phase of the textured
render. Kernel source: csrc/texshade.cu, with the sampler in
csrc/texsample.cuh. Its plain version is `ops/shading.py::shade_deferred`
over the split G-buffer (`engine/renderer.py::split_gbuffer`).

The tables are laid out once per scene, on the scene's device:

  * materials [M,16] f32: the fused render's material rows
    (ops/cuda/render.py::material_rows);
  * maps [M,4,8] int32: per material and samplable map slot (base colour,
    metallic-roughness, occlusion, emissive), the texture's metadata as the
    plain sampler resolves it: has (index != NO_TEXTURE), offset_row, srows,
    width, height, wrap, levels, 0;
  * atlas [R*128] int32: the RGBA8 texels, bit for bit.

`present` is a bitmask over the four map slots: the slots some material
uses, the only ones the plain path samples.

The same tables serve the textured fused render (K2t,
ops/cuda/render.py::render_primary with `shade=`) and, inside the bounce
tables, the path tracer's material sampler.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ...models.material import (TEX_BASE_COLOR, TEX_EMISSIVE, TEX_METALLIC_ROUGHNESS,
                                TEX_OCCLUSION)
from ...models.scene import Scene
from ..texture import NO_TEXTURE
from .build import check, load_kernels
from .render import material_rows

# map slots in the kernel's table order (csrc/texsample.cuh kMap*)
MAP_SLOTS = (TEX_BASE_COLOR, TEX_METALLIC_ROUGHNESS, TEX_OCCLUSION, TEX_EMISSIVE)
META_WORDS = 8
MAX_ATLAS_WORDS = 2**31 - 1   # the kernel addresses texels with int32


@dataclass
class ShadeTables:
    scene: Scene              # the scene the tables were packed from (plain path)
    materials: torch.Tensor   # [M,16] f32
    maps: torch.Tensor        # [M,4,8] int32
    atlas: torch.Tensor       # [R*128] int32
    present: int              # bit k: MAP_SLOTS[k] is sampled
    n_levels: int             # longest mip chain of the atlas

    @property
    def device(self) -> torch.device:
        return self.materials.device


def pack_shade_tables(scene: Scene) -> ShadeTables:
    tex = scene.textures
    data = tex.data_u32
    if data.numel() > MAX_ATLAS_WORDS:
        raise ValueError(f"atlas of {data.numel()} texels exceeds the kernel's int32 "
                         f"addresses ({MAX_ATLAS_WORDS})")
    ti = scene.materials.texture_indices[:, list(MAP_SLOTS)]          # [M,4]
    has = ti != NO_TEXTURE
    safe = torch.clamp(torch.where(has, ti, torch.zeros_like(ti)), max=max(tex.count - 1, 0))
    maps = torch.stack([has.long(), tex.offset_row[safe], tex.srows[safe], tex.width[safe],
                        tex.height[safe], tex.wrap[safe], tex.levels[safe],
                        torch.zeros_like(safe)], dim=2)
    atlas = torch.where(data >= 2**31, data - 2**32, data).to(torch.int32)
    present = sum(1 << k for k, slot in enumerate(MAP_SLOTS)
                  if slot in scene.materials.present_slots)
    return ShadeTables(scene, material_rows(scene), maps.to(torch.int32).contiguous(),
                       atlas.contiguous(), present, tex.n_levels)


def texture_shade(tables: ShadeTables, gbuf: torch.Tensor, sky=(0.0, 0.0, 0.0),
                  trilinear: bool = False) -> torch.Tensor:
    """Shade a G-buffer [N,8] f32 -> RGB [N,3] f32 in the same order. CUDA
    tensors launch the kernel, CPU tensors take the plain version."""
    from ...engine.renderer import GBUFFER_WORDS, split_gbuffer
    from ..shading import shade_deferred

    N = gbuf.shape[0]
    if (gbuf.dtype != torch.float32 or tuple(gbuf.shape) != (N, GBUFFER_WORDS)
            or not gbuf.is_contiguous()):
        raise ValueError(f"gbuf: want contiguous float32 ({N}, {GBUFFER_WORDS}), got "
                         f"{gbuf.dtype} {tuple(gbuf.shape)}")
    if gbuf.device != tables.device:
        raise ValueError(f"gbuf is on {gbuf.device}, the tables on {tables.device}")
    if gbuf.device.type == "cpu":
        S, mat, uv, lam = split_gbuffer(gbuf)
        return shade_deferred(tables.scene, S, mat, uv, sky_color=sky, lam=lam,
                              trilinear=trilinear)
    if gbuf.device.type != "cuda":
        raise ValueError(f"texture_shade: unsupported device {gbuf.device}")
    k = load_kernels()
    rgb = torch.empty((N, 3), dtype=torch.float32, device=gbuf.device)
    sky_r, sky_g, sky_b = (float(c) for c in sky)
    stream = torch.cuda.current_stream(gbuf.device).cuda_stream
    texture_shade.launches += 1
    check(k.lib.rt_texture_shade(
        gbuf.data_ptr(), N, tables.materials.data_ptr(), tables.materials.shape[0],
        tables.maps.data_ptr(), tables.atlas.data_ptr(), tables.present, tables.n_levels,
        int(trilinear), sky_r, sky_g, sky_b, rgb.data_ptr(), stream), "rt_texture_shade")
    return rgb


texture_shade.launches = 0
