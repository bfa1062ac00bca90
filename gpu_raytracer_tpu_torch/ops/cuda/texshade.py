"""K4: texture shading of the deferred G-buffer, one ray per thread (CUDA).

Replaces the TPU kernel `gpu_raytracer_tpu/ops/pallas/texshade.py`
(`pallas_texture_shade` -> `_kernel`): the second phase of the textured
render. Kernel source: csrc/texshade.cu, with the sampler in
csrc/texsample.cuh. Its plain version is `ops/shading.py::shade_deferred`
over the split G-buffer (`ops/render.py::split_gbuffer`).

The tables are laid out once per scene, on the scene's device:

  * materials [M,16] f32: the fused render's material rows
    (ops/cuda/render.py::material_rows);
  * maps [M,4,8] int32: per material and samplable map slot (base colour,
    metallic-roughness, occlusion, emissive), the texture's metadata as the
    plain sampler resolves it: has (index != NO_TEXTURE), offset_row, srows,
    width, height, wrap, levels, and the index of the texture's level-0
    record in `levels` counted in 16-byte records from the start of `maps`;
  * levels [T,n_levels,4] int32, stored right after `maps` in one buffer
    (the kernels find it through that index, so no launch takes another
    pointer): each mip level's offset_row, width, height and srows, the
    recurrence of `ops/texture.py::_level_walk` evaluated once here, so a
    sample loads one record instead of walking the chain;
  * atlas [R*128,2] int32: texel a and its right neighbour a+1 at row a
    (the RGBA8 texels bit for bit, each twice), so each row of a bilinear
    quad is one aligned 8-byte load. Twice the atlas's bytes (3.5 MB for the
    100k courtyard), still far inside the 50 MB L2.

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
from ...models.geometry import TEX_CHUNK
from ...models.scene import Scene
from ..render import split_gbuffer
from ..shading import shade_deferred
from ..texture import NO_TEXTURE
from .build import check, load_kernels, tally
from .render import material_rows

# map slots in the kernel's table order (csrc/texsample.cuh kMap*)
MAP_SLOTS = (TEX_BASE_COLOR, TEX_METALLIC_ROUGHNESS, TEX_OCCLUSION, TEX_EMISSIVE)
META_WORDS = 8
LEVEL_WORDS = 4   # offset_row, width, height, srows
MAX_ATLAS_WORDS = 2**31 - 1   # the kernel addresses texels with int32


@dataclass
class ShadeTables:
    scene: Scene              # the scene the tables were packed from (plain path)
    materials: torch.Tensor   # [M,16] f32
    maps: torch.Tensor        # [M,4,8] int32, the front of one buffer with `levels`
    levels: torch.Tensor      # [T,n_levels,4] int32, right after `maps`
    atlas: torch.Tensor       # [R*128,2] int32 texel pairs
    present: int              # bit k: MAP_SLOTS[k] is sampled
    n_levels: int             # longest mip chain of the atlas

    @property
    def device(self) -> torch.device:
        return self.materials.device


def level_records(tex) -> torch.Tensor:
    """[T,n_levels,4] int64: each texture's mip levels as (offset_row, width,
    height, srows), level l+1 starting (h_l + 1) * srows_l rows after level
    l with halved sizes (at least 1), srows = ceil(w / 127): the chain the
    plain sampler walks per ray (`ops/texture.py::_level_walk`), walked once.
    Levels past a texture's own chain continue the recurrence; the kernels
    never read them (a level is clamped to the chain first)."""
    w, h, sr, off = tex.width, tex.height, tex.srows, tex.offset_row
    rows = [torch.stack([off, w, h, sr], dim=1)]
    for _ in range(1, tex.n_levels):
        off = off + (h + 1) * sr
        w = torch.clamp(w // 2, min=1)
        h = torch.clamp(h // 2, min=1)
        sr = (w + (TEX_CHUNK - 1)) // TEX_CHUNK
        rows.append(torch.stack([off, w, h, sr], dim=1))
    return torch.stack(rows, dim=1)


def texel_pairs(data_u32: torch.Tensor) -> torch.Tensor:
    """[R*128] unsigned texels (int64) -> [R*128,2] int32 rows (texel a,
    texel a+1), bit for bit; the last row's neighbour is 0 (a tap never
    starts on the last texel: lane 127 of an atlas row is a guard)."""
    atlas = torch.where(data_u32 >= 2**31, data_u32 - 2**32, data_u32).to(torch.int32)
    right = torch.cat([atlas[1:], atlas.new_zeros(1)])
    return torch.stack([atlas, right], dim=1).contiguous()


def pack_shade_tables(scene: Scene) -> ShadeTables:
    tex = scene.textures
    data = tex.data_u32
    if data.numel() > MAX_ATLAS_WORDS:
        raise ValueError(f"atlas of {data.numel()} texels exceeds the kernel's int32 "
                         f"addresses ({MAX_ATLAS_WORDS})")
    ti = scene.materials.texture_indices[:, list(MAP_SLOTS)]          # [M,4]
    has = ti != NO_TEXTURE
    safe = torch.clamp(torch.where(has, ti, torch.zeros_like(ti)), max=max(tex.count - 1, 0))
    M = ti.shape[0]
    # the texture's level-0 record, in 16-byte records from the start of maps
    first = M * len(MAP_SLOTS) * META_WORDS // LEVEL_WORDS + safe * tex.n_levels
    maps = torch.stack([has.long(), tex.offset_row[safe], tex.srows[safe], tex.width[safe],
                        tex.height[safe], tex.wrap[safe], tex.levels[safe], first], dim=2)
    levels = level_records(tex)
    buf = torch.cat([maps.reshape(-1), levels.reshape(-1)]).to(torch.int32)
    present = sum(1 << k for k, slot in enumerate(MAP_SLOTS)
                  if slot in scene.materials.present_slots)
    return ShadeTables(scene, material_rows(scene), buf[:maps.numel()].view(maps.shape),
                       buf[maps.numel():].view(levels.shape), texel_pairs(data), present,
                       tex.n_levels)


def texture_shade(tables: ShadeTables, gbuf: torch.Tensor, sky=(0.0, 0.0, 0.0),
                  trilinear: bool = False) -> torch.Tensor:
    """Shade a G-buffer -> RGB [N,3] f32 in the same order. `gbuf` is the
    planes [2,N,4] f32 that `render_deferred` returns (the plain
    `render_gbuffer`'s rows go through `gbuffer_planes` first). CUDA tensors
    launch the kernel, CPU tensors take the plain version."""
    N = gbuf.shape[1] if gbuf.dim() == 3 else -1
    if gbuf.dtype != torch.float32 or tuple(gbuf.shape) != (2, N, 4) or not gbuf.is_contiguous():
        raise ValueError(f"gbuf: want contiguous float32 (2, N, 4) planes, got {gbuf.dtype} "
                         f"{tuple(gbuf.shape)}")
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
    tally("k4")
    check(k.lib.rt_texture_shade(
        gbuf.data_ptr(), N, tables.materials.data_ptr(), tables.materials.shape[0],
        tables.maps.data_ptr(), tables.atlas.data_ptr(), tables.present, tables.n_levels,
        int(trilinear), sky_r, sky_g, sky_b, rgb.data_ptr(), stream), "rt_texture_shade")
    return rgb
