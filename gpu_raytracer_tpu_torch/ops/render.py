"""The plain Whitted render: raygen -> trace -> shadow mask -> shade, in
PyTorch on any device.

`render_chunk` is the plain version of the fused render kernels K2 and K2t
(ops/cuda/render.py::render_primary). `render_gbuffer` is the plain version
of the deferred trace kernel K3 (ops/cuda/render.py::render_deferred), and
`render_deferred_chunk` of the two-phase textured render: the G-buffer
(light sum, material, uv, mip footprint per ray) then `shade_deferred`,
the plain version of the texture shade kernel K4 (ops/cuda/texshade.py).
"""

from __future__ import annotations

import torch

from ..models.scene import Scene
from .camera_rays import generate_rays
from .linalg import dot, normalize
from .shading import (hit_footprint, light_rows, light_sum, sample_light_index, shade,
                      shade_deferred)
from .trace import Hit, occluded, trace


def _shadow_mask(scene: Scene, hit: Hit,
                 light_index: torch.Tensor | None = None) -> torch.Tensor:
    """[N,L] visibility, 1 where the light is reachable from the hit point
    ([N,1], of each ray's own light, with `light_index`): shadow rays start
    1e-3 off the surface along the normal and end 1e-3 short of a point
    light."""
    L = scene.lights
    N = hit.point.shape[0]
    nl = L.count if light_index is None else 1
    origin = hit.point + hit.normal * 1e-3                          # [N,3]
    to_light = light_rows(L.position, light_index) - hit.point[:, None, :]   # [N,L,3]
    dist = torch.sqrt(dot(to_light, to_light))                      # [N,L]
    pl_dir = to_light / dist[..., None]
    ldir = light_rows(normalize(L.direction), light_index).expand_as(to_light)
    is_directional = light_rows(L.light_type == 0, light_index).expand(N, nl)
    sdir = torch.where(is_directional[..., None], -ldir, pl_dir)
    smax = torch.where(is_directional, torch.full_like(dist, 3.0e38), dist - 1e-3)
    # light-major: the rays of one light are consecutive
    o = origin[None, :, :].expand(nl, N, 3).reshape(-1, 3)
    d = sdir.transpose(0, 1).reshape(-1, 3)
    m = smax.transpose(0, 1).reshape(-1)
    blocked = occluded(scene, o, d, m).reshape(nl, N).transpose(0, 1)
    mask = 1.0 - blocked.to(torch.float32)
    return torch.where(hit.hit[:, None], mask, torch.ones_like(mask))


def _sampled_light(scene: Scene, light_u: torch.Tensor | None) -> torch.Tensor | None:
    """Each ray's light for single-sample selection, or None for the loop
    over every light (no `light_u`, or nothing to choose between)."""
    if light_u is None or scene.lights.count <= 1:
        return None
    return sample_light_index(scene, light_u)


def render_chunk(scene: Scene, px: torch.Tensor, py: torch.Tensor,
                 width: int, height: int, shadows: bool = False,
                 sky=(0.0, 0.0, 0.0), trilinear: bool = False,
                 light_u: torch.Tensor | None = None) -> torch.Tensor:
    """Trace + shade one pixel batch -> RGB [n,3] in the given order.
    Pyramid atlases sample the mip level of each hit's footprint. Every
    light is evaluated, however many there are; with `light_u` [n]
    (uniforms in [0, 1)) each ray evaluates the one light
    min(floor(u * L), L - 1), one shadow ray, weighted by L: the plain
    version of the render kernels' branch above MAX_LIGHTS lights."""
    orig, dirn = generate_rays(scene.camera, width, height, px, py)
    hit = trace(scene, orig, dirn)
    li = _sampled_light(scene, light_u)
    mask = _shadow_mask(scene, hit, li) if shadows else None
    lam = hit_footprint(scene, hit, height) if scene.textures.n_levels > 1 else None
    return shade(scene, hit, shadow_mask=mask, sky_color=sky, lam=lam, trilinear=trilinear,
                 light_index=li)


GBUFFER_WORDS = 8   # S rgb, material id (int32 bits), u, v, footprint, 0


def render_gbuffer(scene: Scene, px: torch.Tensor, py: torch.Tensor,
                   width: int, height: int, shadows: bool = False,
                   light_u: torch.Tensor | None = None) -> torch.Tensor:
    """The deferred trace of one pixel batch -> G-buffer [n,8] f32: the
    shadowed light sum S (of every light, or with `light_u` of each ray's
    one sampled light, as `render_chunk`), the material id (int32 bits, -1 a
    miss), the hit uv and the mip footprint; zeros on a miss. The plain
    version of the deferred trace kernel
    (ops/cuda/render.py::render_deferred)."""
    orig, dirn = generate_rays(scene.camera, width, height, px, py)
    hit = trace(scene, orig, dirn)
    li = _sampled_light(scene, light_u)
    mask = _shadow_mask(scene, hit, li) if shadows else None
    mat = hit.material_id.to(torch.int32).view(torch.float32)[:, None]
    lam = hit_footprint(scene, hit, height)[:, None]
    return torch.cat([light_sum(scene, hit, mask, li), mat, hit.uv, lam,
                      torch.zeros_like(lam)], dim=1)


def split_gbuffer(gbuf: torch.Tensor):
    """G-buffer -> (S [n,3], material id [n] int64, uv [n,2], footprint [n]),
    from rows [n,8] (`render_gbuffer`) or planes [2,n,4] (the deferred trace
    kernel's layout: (S, material id) for every ray, then (u, v, footprint,
    0)); the same eight words per ray either way."""
    lo, hi = (gbuf[0], gbuf[1]) if gbuf.dim() == 3 else (gbuf[:, 0:4], gbuf[:, 4:8])
    mat = lo[:, 3].contiguous().view(torch.int32).long()
    return lo[:, 0:3], mat, hi[:, 0:2], hi[:, 2]


def gbuffer_planes(rows: torch.Tensor) -> torch.Tensor:
    """G-buffer rows [n,8] (`render_gbuffer`) -> planes [2,n,4], the layout
    `render_deferred` returns and `texture_shade` reads."""
    return rows.reshape(-1, 2, 4).transpose(0, 1).contiguous()


def render_deferred_chunk(scene: Scene, px: torch.Tensor, py: torch.Tensor,
                          width: int, height: int, shadows: bool = False,
                          sky=(0.0, 0.0, 0.0), trilinear: bool = False,
                          light_u: torch.Tensor | None = None) -> torch.Tensor:
    """The two-phase textured render of one pixel batch -> RGB [n,3]: the
    plain version of the deferred trace kernel followed by the texture
    shade kernel."""
    S, mat, uv, lam = split_gbuffer(render_gbuffer(scene, px, py, width, height, shadows,
                                                   light_u))
    return shade_deferred(scene, S, mat, uv, sky_color=sky, lam=lam, trilinear=trilinear)
