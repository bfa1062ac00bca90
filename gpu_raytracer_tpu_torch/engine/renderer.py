"""Frame renderer: one pass over the whole image in tile-major ray order.

`Renderer` runs on one device, chosen by `device` (CUDA unless the caller
asks for the CPU). On a CUDA device an
untextured frame is one fused-render launch and a textured frame a deferred
trace launch then a texture shade launch (ops/cuda/render.py,
ops/cuda/texshade.py); on the CPU every frame goes through the plain
`ops/render.py::render_chunk`, as the JAX package's CPU route does. Nothing
falls back from one to the other. Above MAX_LIGHTS lights the CUDA route
samples one light per pixel, batch and frame (`light_uniforms`), as the JAX
package's kernels do; the CPU route loops over every light, as its plain
path does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, RaytracerConfig
from ..models.camera import Camera
from ..models.scene import Scene
from ..ops.cuda.render import (MAX_LIGHTS, pack_render_tables, render_deferred, render_primary,
                               set_camera)
from ..ops.cuda.texshade import pack_shade_tables, texture_shade
from ..ops.cuda.traverse import refit_trace_tables
from ..ops.render import render_chunk
from ..utils.image import quantize_u8
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
        return self.to_image(quantize_u8(self.render_device(), srgb).cpu().numpy())


def render_image(scene: Scene, width: int, height: int, *, shadows: bool = False,
                 sky=(0.0, 0.0, 0.0), config: RaytracerConfig = DEFAULT_CONFIG,
                 device=None) -> np.ndarray:
    """One frame -> host float32 [H,W,3] (a Renderer made and used once)."""
    return Renderer(scene, width, height, config=config, shadows=shadows, sky=sky,
                    device=device).render()
