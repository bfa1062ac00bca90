"""Frame renderer: one pass over the whole image in tile-major ray order.

`render_chunk` is the plain pipeline (raygen -> trace -> shadow mask ->
shade) and the plain version of the fused CUDA render kernel
(ops/cuda/render.py). `render_gbuffer` + `shade_deferred` is the plain
version of the two-phase textured render: the deferred trace kernel writes
a per-ray G-buffer (light sum, material, uv, mip footprint) and the texture
shade kernel (ops/cuda/texshade.py) turns it into RGB.

`Renderer` runs on one device, chosen by `device` (CUDA unless the caller
asks for the CPU). On a CUDA device an
untextured frame is one fused-render launch and a textured frame a deferred
trace launch then a texture shade launch; on the CPU every frame goes
through `render_chunk`, as the JAX package's CPU route does. Nothing falls
back from one to the other. Above MAX_LIGHTS lights the CUDA route samples
one light per pixel, batch and frame (`light_uniforms`), as the JAX package's
kernels do; the CPU route loops over every light, as its plain path does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, RaytracerConfig
from ..models.camera import Camera
from ..models.scene import Scene
from ..ops.camera_rays import generate_rays
from ..ops.cuda.render import (MAX_LIGHTS, pack_render_tables, render_deferred, render_primary,
                               set_camera)
from ..ops.cuda.texshade import pack_shade_tables, texture_shade
from ..ops.cuda.traverse import refit_trace_tables
from ..ops.linalg import dot, normalize
from ..ops.shading import (hit_footprint, light_rows, light_sum, sample_light_index, shade,
                           shade_deferred)
from ..ops.trace import Hit, occluded, trace
from .perf import span

TILE = 64  # tile edge of the tile-major pixel order
MASK32 = 0xFFFFFFFF
MASK64 = 0xFFFFFFFFFFFFFFFF
WARP_BLOCK = (8, 4)  # pixels (wide, high) of one warp of the CUDA kernels


def tiled_pixel_order(width: int, height: int, tile: int = TILE,
                      warp: tuple[int, int] | None = None):
    """Pixel coordinates in tile-major order, every pixel once: (px [W*H]
    i32, py [W*H] i32). Inside each tile the pixels run row-major (the JAX
    package's order), or with `warp` = (w, h) in w x h blocks, row-major
    inside a block and block after block along the tile's rows, so that 32
    consecutive rays of a CUDA warp cover a compact 8 x 4 block of pixels
    and walk nearly the same nodes, not a 32 x 1 strip. `tile` must be a
    multiple of both block edges."""
    gy, gx = np.mgrid[0:tile, 0:tile]
    if warp is not None:
        bw, bh = warp
        if tile % bw or tile % bh:
            raise ValueError(f"a {tile}-pixel tile does not divide into {bw} x {bh} blocks")
        # [block row, block column, row in block, column in block]
        blocks = lambda g: g.reshape(tile // bh, bh, tile // bw, bw).transpose(0, 2, 1, 3)
        gx, gy = blocks(gx), blocks(gy)
    gx, gy = gx.reshape(-1), gy.reshape(-1)
    px, py = [], []
    for ty in range(0, height, tile):
        for tx in range(0, width, tile):
            keep = (tx + gx < width) & (ty + gy < height)
            px.append(tx + gx[keep])
            py.append(ty + gy[keep])
    return (np.concatenate(px).astype(np.int32),
            np.concatenate(py).astype(np.int32))


def light_seed(frame: int, salt: int) -> int:
    """The light choice's generator seed of (frame, salt), each taken modulo
    2^32 (the JAX package folds a 32-bit salt into PRNGKey(frame)): the
    64-bit word frame << 32 | salt through the splitmix64 finalizer, a
    bijection of 64-bit words, so the mix is injective: two batches of one
    frame, or one batch of two frames, never share a seed. The card's Philox
    generator keys on all 64 bits; the CPU's mt19937 keeps the low 32, which
    the finalizer makes depend on both numbers."""
    z = ((int(frame) & MASK32) << 32) | (int(salt) & MASK32)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK64
    return z ^ (z >> 31)


def light_uniforms(n: int, frame: int, salt: int, device) -> torch.Tensor:
    """[n] f32 uniforms in [0, 1) for the single-sample light choice of one
    pixel batch, from a torch.Generator on `device` seeded by
    light_seed(frame, salt): the same (frame, salt) gives the same numbers.
    They are not the JAX package's threefry numbers; both estimate the sum
    over the lights without bias."""
    gen = torch.Generator(device=device)
    gen.manual_seed(light_seed(frame, salt))
    return torch.rand((n,), generator=gen, dtype=torch.float32, device=device)


def resolve_device(device, who: str) -> torch.device:
    """The device an entry point runs on: CUDA when `device` is None, and a
    CUDA device must exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}(device={str(dev)!r}): no CUDA device is available; "
                           f"pass device='cpu' for the plain PyTorch path")
    return dev


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


class Renderer:
    """Whole-frame renderer on one device (`device` defaults to CUDA; pass
    "cpu" for the plain path). Frames come out in the order of `px`, `py`
    (`render_device`: tile-major, on CUDA in 8 x 4 blocks inside the tiles) or
    as [H,W,3] images (`render`, `render_u8`), the same on either device. Textured scenes sample with
    `config.texture_trilinear`."""

    def __init__(self, scene: Scene, width: int, height: int,
                 config: RaytracerConfig = DEFAULT_CONFIG,
                 shadows: bool = False, sky=(0.0, 0.0, 0.0), device=None):
        self.device = resolve_device(device, "Renderer")
        self.scene = scene.to(self.device)
        self.textured = scene.textures.textured
        self.width = width
        self.height = height
        self.config = config
        self.shadows = shadows
        self.sky = tuple(float(x) for x in sky)
        # folded into the light choice above MAX_LIGHTS lights: a caller that
        # advances it per frame gets fresh choices, so frames average to the
        # sum over the lights; left at 0 every frame is the same
        self.light_frame = 0
        # on the card a warp's 32 rays are a compact block of pixels
        px, py = tiled_pixel_order(width, height,
                                   warp=WARP_BLOCK if self.device.type == "cuda" else None)
        self._px_host, self._py_host = px, py
        self.px = torch.from_numpy(px).to(self.device)
        self.py = torch.from_numpy(py).to(self.device)
        self.tables = pack_render_tables(self.scene)
        self.shade_tables = (pack_shade_tables(self.scene)
                             if self.textured and self.device.type != "cpu" else None)

    def set_camera(self, camera: Camera) -> None:
        """Move the camera: the camera row of the tables is rewritten in
        place (ops/cuda/render.py::set_camera); nothing else is repacked."""
        with span("renderer.set_camera"):
            set_camera(self.tables, camera)
            self.scene = self.tables.scene

    def set_geometry(self, scene: Scene) -> None:
        """Take `scene`, a refit of this renderer's scene
        (models/scene.py::refit_scene; the camera stays the renderer's): the
        tables follow it (ops/cuda/traverse.py::refit_trace_tables, in place
        after a topology refit); the material, light and texture tables do
        not change."""
        scene = dataclasses.replace(scene.to(self.device), camera=self.scene.camera)
        refit_trace_tables(self.tables.trace, scene)
        if self.shade_tables is not None:
            self.shade_tables.scene = scene
        self.scene = scene

    def _light_u(self, n: int, salt: int = 0) -> torch.Tensor | None:
        """Per-ray uniforms [n] for the kernels' single-sample light choice
        (CUDA, more than MAX_LIGHTS lights) of the batch `salt` of frame
        `light_frame`; None where every light is looped over."""
        if self.device.type == "cpu" or self.scene.lights.count <= MAX_LIGHTS:
            return None
        return light_uniforms(n, self.light_frame, salt, self.device)

    def render_rays(self, px: torch.Tensor, py: torch.Tensor,
                    light_salt: int = 0) -> torch.Tensor:
        """Trace + shade one pixel batch on the renderer's device -> RGB [n,3].
        `light_salt` tells the batches of one frame apart: above MAX_LIGHTS
        lights each (light_frame, light_salt) draws its own light choices."""
        W, H = self.width, self.height
        trilinear = self.config.texture_trilinear
        with span("renderer.render"):
            if self.device.type == "cpu":
                return render_chunk(self.scene, px, py, W, H, shadows=self.shadows,
                                    sky=self.sky, trilinear=trilinear)
            light_u = self._light_u(px.shape[0], light_salt)
            if not self.textured:
                return render_primary(self.tables, px, py, W, H, shadows=self.shadows,
                                      sky=self.sky, light_u=light_u)
            gbuf = render_deferred(self.tables, px, py, W, H, shadows=self.shadows,
                                   light_u=light_u)
            return texture_shade(self.shade_tables, gbuf, sky=self.sky, trilinear=trilinear)

    def render_device(self) -> torch.Tensor:
        """The full frame, left on the device: f32 [W*H,3] in the order of
        `self.px`, `self.py`."""
        return self.render_rays(self.px, self.py)

    def to_image(self, flat: np.ndarray) -> np.ndarray:
        fb = np.zeros((self.height, self.width) + flat.shape[1:], flat.dtype)
        fb[self._py_host, self._px_host] = flat
        return fb

    def render(self) -> np.ndarray:
        """Full frame -> host float32 [H,W,3]."""
        return self.to_image(self.render_device().cpu().numpy())

    def render_u8(self, srgb: bool = True) -> np.ndarray:
        """Full frame quantised to u8 on the device (sRGB-encoded by
        default) -> host [H,W,3] uint8."""
        from ..utils.image import linear_to_srgb

        fb = self.render_device()
        if srgb:
            fb = linear_to_srgb(fb)
        u8 = (torch.clamp(fb, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
        return self.to_image(u8.cpu().numpy())


def render_image(scene: Scene, width: int, height: int, *, shadows: bool = False,
                 sky=(0.0, 0.0, 0.0), config: RaytracerConfig = DEFAULT_CONFIG,
                 device=None) -> np.ndarray:
    """One frame -> host float32 [H,W,3] (a Renderer made and used once)."""
    return Renderer(scene, width, height, config=config, shadows=shadows, sky=sky,
                    device=device).render()
