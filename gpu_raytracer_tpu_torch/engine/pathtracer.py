"""Progressive multi-bounce path tracing with an accumulation buffer.

Each `step()` traces `samples_per_step` samples of every pixel through one
wavefront pool (ops/wavefront.py) and adds them to an accumulator kept on
the device; `image()` is the running mean. Spectral mode starts every ray
with full RGB throughput and splits it to one wavelength only at
dispersive glass; RGB mode traces channel 1 (no dispersion offset) and
never splits.

A step is: the camera pool with QMC-jittered pixel positions (one lane
per pixel, tile-major), then for each depth 0 to `max_bounce_depth` a count
of the live lanes, their coherence order (not at depth 0) and one bounce,
which updates the pool and the step's radiance in place, then one add into
the accumulator. On a CUDA device the bounce is one kernel launch that
visits only the live lanes and computes their QMC uniforms itself; no step
reads a value back to the host. On the CPU the same calls run the plain
bounce.

The accumulator rows are pixels in tile-major order (64x64 tiles, every
pixel once); `image()` and `image_device()` reorder them to [H,W,3].
Checkpoints are `.npz` files with the JAX package's keys, so either
package loads the other's.

The interactive stack on top of it, as the JAX package's:
  * `gbuffer()`: the primary hits at pixel centres (normal, depth, albedo);
    on a CUDA device the triangles go through the traversal kernel (K1,
    `ops/cuda/traverse.py::trace`) and a textured albedo through the
    material sampler (K5, `ops/cuda/bounce.py::sample_materials`);
  * `denoised_frame()` / `denoised_image()`: the accumulator mean through
    the à-trous filter (ops/denoise.py) along that G-buffer;
  * `set_camera(temporal=True)`: the temporal reprojection of the
    accumulation into the new view (`_warp_history`), per-pixel history
    weights in `_count_base`, clamped to `temporal_clamp` samples;
  * `step_interleaved(m)`: one sample for 1/m of the pixels, a rotating
    interleaved coset;
  * `fly_frame()`: warp, one coset step, G-buffer reorder, à-trous and the
    optional u8 encode: the moving frame of a fly-through.
None of them reads a value back to the host on a CUDA device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, RaytracerConfig
from ..models.scene import Scene, upload
from ..ops.camera_rays import generate_rays, pixel_grid
from ..ops.cuda.bounce import pack_bounce_tables, sample_materials
from ..ops.cuda.render import set_camera
from ..ops.cuda.traverse import refit_trace_tables, trace
from ..ops.denoise import atrous_denoise
from ..ops.linalg import cross, dot
from ..ops.pool import path_trace_pool
from ..ops.shading import material_textures
from ..ops.wavefront import RGB_CHANNEL, WavefrontCounters, camera_wavefront_rays
from ..utils.image import quantize_u8
from .perf import ProgressiveTiming, Timer, span
from .renderer import light_seed, resolve_device, tiled_pixel_order

JITTER_STREAM = -1       # the independent stream's "depth" of the pixel jitter
WARP_STREAM = 0x3A97     # the warp's history-jitter stream (the JAX package's fold-in)
COSET_SAMPLE_BASE = 0x7000   # sample index of interleaved step k: 0x7000 + k
# interleave m -> the coset grid (a, b): coset k holds the pixels with
# (x mod a, y mod b) == (k mod a, k // a); m = 1 is the whole frame
COSET_GRID = {1: (1, 1), 2: (2, 1), 4: (2, 2), 8: (4, 2)}


def _sample_chunk(tables, px: torch.Tensor, py: torch.Tensor, width: int, height: int,
                  channel: int, max_depth: int, rr_start: int, shadows: bool,
                  antialias: bool, spp: int = 1, qmc: bool = True, sample_base: int = 0,
                  qmc_seed: int = 0, qmc_pid_base: int = 0, tex_lod_bias: float = 0.0,
                  rng_seed: int = 0, fov_scale: float | None = None):
    """Trace `spp` samples of every pixel (px, py) in ONE pool -> (radiance
    [C,3] summed over the samples, per-depth active counts).

    The pool is chunk-major: sample s of pixel i sits at lane s*C + i. A
    lane's QMC identity is pixel id qmc_pid_base + lane % C and sample
    index sample_base + lane // C, for its jitter here and its bounce
    uniforms in the pool."""
    n = px.shape[0] * spp
    with span("pathtracer.camera_pool"):
        if spp > 1:
            px, py = px.repeat(spp), py.repeat(spp)
        jitter = None
        if antialias and qmc:
            from ..ops.sampler import qmc_jitter

            lane = torch.arange(n, dtype=torch.int64, device=px.device)
            C = n // spp
            jitter = qmc_jitter(int(qmc_pid_base) + lane % C, int(sample_base) + lane // C,
                                qmc_seed)
        elif antialias:
            from ..ops.rng import bounce_key, sample_uniform

            jitter = sample_uniform(bounce_key(rng_seed, sample_base, JITTER_STREAM,
                                               device=px.device), (n,), 2)
        rays = camera_wavefront_rays(tables.scene.camera, width, height, px, py, channel,
                                     jitter=jitter, fov_scale=fov_scale)
    contrib, counts = path_trace_pool(tables, rays, max_depth=max_depth, rr_start=rr_start,
                                      shadows=shadows, qmc=qmc, qmc_pid_base=qmc_pid_base,
                                      sample_base=sample_base, qmc_seed=qmc_seed,
                                      qmc_spp=spp, tex_lod_bias=tex_lod_bias,
                                      rng_seed=rng_seed)
    if spp > 1:
        contrib = contrib.reshape(spp, -1, 3).sum(dim=0)
    return contrib, counts


def primary_gbuffer(tables, px: torch.Tensor, py: torch.Tensor, width: int, height: int):
    """The primary hits of camera rays through the pixel centres (px, py) ->
    (hit, origins, directions, (normal [C,3] 0 on a miss, depth [C] ray t,
    albedo [C,3] 1 on a miss)). Albedo is the material row times its
    textures at level 0: K5 on a textured scene on the card, the plain
    sampler on the CPU."""
    scene = tables.scene
    o, d = generate_rays(scene.camera, width, height, px, py,
                         fov_scale=tables.render.fov_scale)
    hit = trace(tables.render.trace, o, d)
    mid = torch.clamp(hit.material_id, min=0)
    if tables.shade is not None:
        albedo = sample_materials(tables, mid.to(torch.int32), hit.uv.contiguous())[:, :3]
    else:
        albedo = material_textures(scene, mid, hit.uv)[0]
    albedo = torch.where(hit.hit[:, None], albedo, torch.ones_like(albedo))
    return hit, o, d, (hit.normal, hit.t, albedo)


def _warp_history(tables, old_cam, old_fov_scale: float, accum, n_tot, inv_perm, px, py,
                  clamp: float, jitter, old_depth_tile, width: int, height: int):
    """Temporal reprojection: seed the new camera's accumulator (the camera
    of `tables`) with the old accumulation -> (accum0 [C,3], n0 [C], the new
    camera's G-buffer in accumulator (tile) order).

    For every new pixel: trace its primary hit, reproject the point into the
    old camera (its basis forward / right / true_up is orthogonal even
    unnormalised, so the inverse projection is three dot products), move the
    projected position by jitter - 0.5 ([C,2] in [0,1): a stochastic
    bilinear fetch) and round it, fetch the old mean, count and primary
    depth there in one packed [C,5] gather through `inv_perm`, and accept
    the history only where the old depth agrees with the point's distance
    to the old camera (2% + 1e-3); a miss reprojects by direction and needs
    an old miss. Accepted history enters as mean * n0 with
    n0 = min(old count, clamp); the rest starts from zero.

    old_depth_tile: the old camera's primary depth in tile order (the
    previous warp's G-buffer), or None, and it is traced first (two traces
    in all)."""
    H, W = height, width
    dev = accum.device
    full = lambda v: torch.full((), v, dtype=torch.float32, device=dev)
    if old_depth_tile is None:
        o0, d0 = generate_rays(old_cam, W, H, px, py, fov_scale=old_fov_scale)
        old_depth_tile = trace(tables.render.trace, o0, d0).t
    hit, o, d, gbuf_tile = primary_gbuffer(tables, px, py, W, H)
    point = o + d * hit.t[:, None]
    V = torch.where(hit.hit[:, None], point - old_cam.position, d)

    fwd = old_cam.direction
    right = cross(fwd, old_cam.up)
    true_up = cross(right, fwd)
    af = dot(V, fwd) / dot(fwd, fwd)
    ar = dot(V, right) / dot(right, right)
    au = dot(V, true_up) / dot(true_up, true_up)
    front = af > 1e-6
    af_s = torch.where(front, af, full(1.0))
    aspect = full(W) / full(H)
    fs = full(old_fov_scale)
    u = ((ar / af_s) / (aspect * fs) + 1.0) * 0.5
    v = (1.0 - (au / af_s) / fs) * 0.5
    jxy = jitter - 0.5
    ix = torch.round(u * W - 0.5 + jxy[:, 0]).to(torch.int64)
    iy = torch.round(v * H - 0.5 + jxy[:, 1]).to(torch.int64)
    inb = front & (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
    flat = torch.clamp(iy, 0, H - 1) * W + torch.clamp(ix, 0, W - 1)

    # the accumulator is in tile order and `flat` a row-major index:
    # accum_rm[flat] == accum[inv_perm[flat]], the same for every column
    src = inv_perm[flat]
    hist = torch.cat([accum, n_tot[:, None], old_depth_tile[:, None]], dim=1)[src]
    n_f = hist[:, 3]
    mean_f = hist[:, 0:3] / torch.clamp(n_f, min=1.0)[:, None]
    depth_f = hist[:, 4]
    dist = torch.sqrt((V * V).sum(dim=-1))
    ok_hit = hit.hit & (torch.abs(depth_f - dist) <= 0.02 * dist + 1e-3)
    ok_miss = ~hit.hit & (depth_f > 1e30)
    valid = inb & (ok_hit | ok_miss)
    n0 = torch.where(valid, torch.minimum(n_f, full(clamp)), full(0.0))
    return mean_f * n0[:, None], n0, gbuf_tile


def warp_jitter(seed: int, warp_no: int, n: int, device) -> torch.Tensor:
    """[n,2] f32 U[0,1): the history jitter of warp number `warp_no`, from a
    torch.Generator on `device` seeded by light_seed(warp_no, seed ^
    WARP_STREAM). The JAX package draws this array from jax.random
    (fold_in(fold_in(key, 0x3A97), warp_no)), whose bits PyTorch cannot
    reproduce; the parity tests inject that array instead."""
    gen = torch.Generator(device=device)
    gen.manual_seed(light_seed(warp_no, int(seed) ^ WARP_STREAM))
    return torch.rand((n, 2), generator=gen, dtype=torch.float32, device=device)


def to_u8(img: torch.Tensor) -> torch.Tensor:
    """Linear [H,W,3] f32 -> sRGB-encoded u8 on the image's device."""
    return quantize_u8(img)


class PathTracer:
    """Progressive accumulator: call step() per frame, image() for the mean.

    `device` defaults to CUDA (and raises without one); pass "cpu" for the
    plain path. `sampler` is "qmc" (rank-1 lattice uniforms, bit-exact with
    the JAX package) or "rng" (independent torch.Generator streams)."""

    def __init__(self, scene: Scene, width: int, height: int,
                 config: RaytracerConfig = DEFAULT_CONFIG, spectral: bool = True,
                 shadows: bool = True, antialias: bool = True, seed: int = 0,
                 samples_per_step: int = 1, sampler: str = "qmc", device=None):
        if sampler not in ("qmc", "rng"):
            raise ValueError(f"sampler must be 'qmc' or 'rng', got {sampler!r}")
        self.device = resolve_device(device, "PathTracer")
        self.scene = scene.to(self.device)
        self.width = width
        self.height = height
        self.config = config
        self.spectral = spectral
        self.shadows = shadows
        self.antialias = antialias
        self.samples_per_step = max(int(samples_per_step), 1)
        self.sampler = sampler
        self.qmc = sampler == "qmc"
        self.seed = int(seed)
        self._qmc_seed = self.seed & 0xFFFFFFFF
        self.tables = pack_bounce_tables(self.scene)
        px, py = tiled_pixel_order(width, height)
        self._px_host, self._py_host = px, py
        self._px = torch.from_numpy(px).to(self.device)
        self._py = torch.from_numpy(py).to(self.device)
        order = torch.from_numpy(py.astype(np.int64) * width + px)
        inv = torch.empty_like(order)
        inv[order] = torch.arange(order.numel())
        self._inv_perm = inv.to(self.device)     # row-major pixel -> accumulator row
        self._rowmajor = (self._py.long() * width + self._px.long())   # accumulator row -> pixel
        self.accum = torch.zeros((height * width, 3), dtype=torch.float32, device=self.device)
        self.samples = 0
        self._last_counts = None
        self._last_seed = 0
        # temporal reprojection: per-pixel history weights [C] f32 from the
        # last warp, None while the weights are the uniform `samples`
        self._count_base = None
        self.temporal_clamp = 8.0
        self._warp_no = 0
        self._il_step = 0      # interleaved steps so far (their sample index)
        self._il_phase = -1    # the last coset traced
        self._coset_cache = {}
        # primary G-buffer of the current camera: _gbuf_tile in accumulator
        # order (the warp's by-product, whose depth the next warp reuses),
        # _gbuf row-major planes, made on demand
        self._gbuf = None
        self._gbuf_tile = None

    def set_camera(self, camera, temporal: bool = False) -> None:
        """Move the camera. The camera row of the tables is rewritten in
        place; nothing else is repacked. temporal=False restarts the
        accumulation; temporal=True reprojects it into the new view
        (`_warp_history`), depth-validated, each pixel's history clamped to
        `temporal_clamp` samples."""
        if temporal and self._total_samples() > 0:
            old_cam, old_fov_scale = self.scene.camera, self.tables.render.fov_scale
            set_camera(self.tables.render, camera)
            self.scene = self.tables.scene
            self._warp_no += 1
            # the previous frame's G-buffer depth is the old camera's
            # primary depth the warp validates against
            if self._gbuf_tile is not None:
                old_depth = self._gbuf_tile[1]
            elif self._gbuf is not None:
                old_depth = self._gbuf[1].reshape(-1)[self._rowmajor]
            else:
                old_depth = None
            self.accum, self._count_base, self._gbuf_tile = _warp_history(
                self.tables, old_cam, old_fov_scale, self.accum, self._n_total(),
                self._inv_perm, self._px, self._py, self.temporal_clamp, self._warp_jitter(),
                old_depth, self.width, self.height)
            self._gbuf = None
            self.samples = 0
            return
        set_camera(self.tables.render, camera)
        self.scene = self.tables.scene
        self.reset()

    def set_geometry(self, scene: Scene) -> None:
        """Take `scene`, a refit of this tracer's scene
        (models/scene.py::refit_scene; the camera stays this tracer's): the
        bounce tables follow it (ops/cuda/traverse.py::refit_trace_tables,
        in place after a topology refit) and the accumulation restarts."""
        scene = dataclasses.replace(scene.to(self.device), camera=self.scene.camera)
        refit_trace_tables(self.tables.render.trace, scene)
        if self.tables.shade is not None:
            self.tables.shade.scene = scene
        self.scene = scene
        self.reset()

    def _warp_jitter(self) -> torch.Tensor:
        """The history jitter of the current warp, [C,2] (`warp_jitter`)."""
        return warp_jitter(self.seed, self._warp_no, self.accum.shape[0], self.device)

    def _total_samples(self) -> int:
        return self.samples + (0 if self._count_base is None else 1)

    def _n_total(self) -> torch.Tensor:
        """Per-pixel total sample weight [C] f32 (history + new)."""
        n = torch.full((self.accum.shape[0],), float(self.samples), dtype=torch.float32,
                       device=self.device)
        if self._count_base is not None:
            n = n + self._count_base
        return n

    def reset(self) -> None:
        """Restart the accumulation: no history, no cached G-buffer."""
        self.accum.zero_()
        self.samples = 0
        self._count_base = None
        self._gbuf = None
        self._gbuf_tile = None

    def step(self) -> None:
        """Trace samples_per_step samples per pixel and accumulate."""
        with span("pathtracer.step"):
            self._last_seed = self.samples
            contrib, self._last_counts = _sample_chunk(
                self.tables, self._px, self._py, self.width, self.height,
                RGB_CHANNEL if self.spectral else 1, self.config.max_bounce_depth,
                self.config.russian_roulette_start, self.shadows, self.antialias,
                spp=self.samples_per_step, qmc=self.qmc, sample_base=self.samples,
                qmc_seed=self._qmc_seed, tex_lod_bias=self.config.bounce_lod_bias,
                rng_seed=self.seed, fov_scale=self.tables.render.fov_scale)
            with span("pathtracer.accumulate"):
                self.accum += contrib
            self.samples += self.samples_per_step

    def render(self, spp: int, progress: bool = False) -> np.ndarray:
        """`spp` steps, each timed to its device completion -> image()."""
        timing = ProgressiveTiming()
        timing.rays_per_tile = self.width * self.height
        for i in range(spp):
            with Timer(self.device) as t:
                self.step()
            timing.record_tile(t.ms)
            if progress and (i + 1) % 8 == 0:
                print(f"  {i + 1}/{spp} spp")
        if progress:
            timing.print_summary()
        return self.image()

    def counters(self) -> WavefrontCounters:
        """Per-bounce-depth live-lane counts of the last step (read from the
        device here, not during the step)."""
        wc = WavefrontCounters(self.config.max_bounce_depth, frame_seed=self._last_seed)
        if self._last_counts is not None:
            for depth, cnt in enumerate(self._last_counts.tolist()):
                if cnt > 0:
                    wc.add_rays(depth, int(cnt))
        return wc

    def image(self) -> np.ndarray:
        """The accumulated mean -> host float32 [H,W,3] (per-pixel weights
        after a temporal warp)."""
        if self._count_base is None:
            n = max(self.samples, 1)
        else:
            n = np.maximum(self._count_base.cpu().numpy() + self.samples, 1.0)[:, None]
        flat = self.accum.cpu().numpy() / n
        fb = np.zeros((self.height, self.width, 3), np.float32)
        fb[self._py_host, self._px_host] = flat
        return fb

    def _inv_n(self) -> torch.Tensor:
        """1 / the sample weight: a 0-d scalar, or [C,1] per pixel after a
        warp."""
        if self._count_base is None:
            return torch.full((), 1.0 / max(self.samples, 1), dtype=torch.float32,
                              device=self.device)
        return (1.0 / torch.clamp(self._count_base + self.samples, min=1.0))[:, None]

    def image_device(self, u8: bool = False) -> torch.Tensor:
        """The accumulated mean on the device, row-major [H,W,3]: f32, or
        sRGB-encoded uint8 with u8=True."""
        out = (self.accum * self._inv_n())[self._inv_perm].reshape(self.height, self.width, 3)
        return to_u8(out) if u8 else out

    def gbuffer(self):
        """The primary-hit G-buffer of the current camera: (normal [H,W,3],
        exactly 0 on a miss; depth [H,W], the ray t; albedo [H,W,3], 1 on a
        miss), traced through the pixel centres with the samples' trace, so
        edges line up with the image. Cached until the camera or the scene
        changes; after a warp it is the warp's trace, reordered."""
        if self._gbuf is None:
            if self._gbuf_tile is None:
                W, H = self.width, self.height
                px, py = pixel_grid(W, H, self.device)
                planes = primary_gbuffer(self.tables, px, py, W, H)[3]
            else:
                normal, depth, albedo = self._gbuf_tile
                pack = torch.cat([normal, depth[:, None], albedo], dim=1)[self._inv_perm]
                planes = pack[:, 0:3], pack[:, 3], pack[:, 4:7]
            normal, depth, albedo = planes
            self._gbuf = (normal.reshape(self.height, self.width, 3),
                          depth.reshape(self.height, self.width),
                          albedo.reshape(self.height, self.width, 3))
        return self._gbuf

    def denoised_frame(self, iterations: int = 4, u8: bool = False, **kw) -> torch.Tensor:
        """The mean filtered by the à-trous pass (ops/denoise.py) along the
        cached G-buffer -> device [H,W,3] f32, or sRGB u8 with u8=True. `kw`
        forwards the sigma_* knobs."""
        normal, depth, albedo = self.gbuffer()
        out = atrous_denoise(self.image_device(), normal, depth, albedo,
                             iterations=iterations, **kw)
        return to_u8(out) if u8 else out

    def denoised_image(self, iterations: int = 4, **kw) -> np.ndarray:
        """denoised_frame() on the host, f32 [H,W,3]."""
        return self.denoised_frame(iterations=iterations, **kw).cpu().numpy()

    def save_checkpoint(self, path: str) -> None:
        cam = self.scene.camera
        host = lambda t: t.detach().cpu().numpy()
        np.savez_compressed(path, accum=host(self.accum), samples=self.samples,
                            width=self.width, height=self.height,
                            camera_position=host(cam.position),
                            camera_direction=host(cam.direction), camera_up=host(cam.up),
                            camera_fov=host(cam.fov))

    def load_checkpoint(self, path: str) -> None:
        with np.load(path) as data:
            if int(data["width"]) != self.width or int(data["height"]) != self.height:
                raise ValueError(f"checkpoint is {int(data['width'])}x{int(data['height'])}, "
                                 f"the tracer {self.width}x{self.height}")
            accum = np.asarray(data["accum"], np.float32)
            if accum.shape != tuple(self.accum.shape):
                raise ValueError(f"checkpoint accumulator {accum.shape}, want "
                                 f"{tuple(self.accum.shape)}")
            self.accum = torch.from_numpy(accum).to(self.device)
            self.samples = int(data["samples"])

    def _cosets(self, m: int):
        """Per phase k of interleave m: (accumulator rows [C/m] i64, sorted;
        their px, py) of the pixels with (x mod a, y mod b) == (k mod a,
        k // a), (a, b) = COSET_GRID[m]."""
        if m not in self._coset_cache:
            a, b = COSET_GRID[m]
            px, py = self._px_host, self._py_host
            sets = []
            for k in range(m):
                idx = np.nonzero((px % a == k % a) & (py % b == k // a))[0]
                sets.append(tuple(upload(arr, self.device) for arr in (idx, px[idx], py[idx])))
            self._coset_cache[m] = sets
        return self._coset_cache[m]

    def interleave_ok(self, m: int) -> bool:
        """step_interleaved(m) traces a coset iff m is 2, 4 or 8 and the
        frame divides the coset grid."""
        a, b = COSET_GRID.get(m, (0, 0)) if m > 1 else (0, 0)
        return a > 0 and self.width % a == 0 and self.height % b == 0

    def _coset_step(self, m: int) -> None:
        """One sample for the next coset of interleave m (the whole frame for
        m = 1), added into the accumulator and the per-pixel weights. The
        scalar count folds into `_count_base` first. The QMC identity is the
        JAX package's: sample 0x7000 + step, pixel id phase * C/m + lane."""
        n_vec = self._n_total()
        if self._count_base is None or self.samples:
            self._count_base = n_vec
            self.samples = 0
        self._il_step += 1
        self._il_phase = phase = (self._il_phase + 1) % m
        idx, px_s, py_s = self._cosets(m)[phase]
        self._last_seed = COSET_SAMPLE_BASE + self._il_step
        spp = self.samples_per_step
        contrib, self._last_counts = _sample_chunk(
            self.tables, px_s, py_s, self.width, self.height,
            RGB_CHANNEL if self.spectral else 1, self.config.max_bounce_depth,
            self.config.russian_roulette_start, self.shadows, self.antialias, spp=spp,
            qmc=self.qmc, sample_base=self._last_seed, qmc_seed=self._qmc_seed,
            qmc_pid_base=phase * idx.shape[0], tex_lod_bias=self.config.bounce_lod_bias,
            rng_seed=self.seed, fov_scale=self.tables.render.fov_scale)
        # the rows are unique: one add each, the JAX package's sums
        self.accum.index_add_(0, idx, contrib)
        self._count_base.index_add_(0, idx, torch.full(idx.shape, float(spp),
                                                       dtype=torch.float32, device=self.device))

    def step_interleaved(self, m: int = 4) -> None:
        """Trace one sample for 1/m of the pixels (the next coset of a
        rotation) and accumulate: a moving frame pays ~1/m of a step, the
        temporal warp carries history into every pixel and the à-trous
        filter fills the cosets not sampled. A frame that does not divide
        the interleave takes the full step()."""
        if not self.interleave_ok(m):
            self.step()
            return
        self._coset_step(m)

    def fly_frame(self, camera, m: int = 4, iterations: int = 4, u8: bool = False,
                  **kw) -> torch.Tensor:
        """One moving frame of a fly-through: the temporal warp to `camera`
        (its old depth from the cached G-buffer), one 1/m coset step (the
        whole frame for m = 1), the G-buffer reorder, the à-trous filter
        and, with u8=True, the sRGB encode -> the row-major [H,W,3] device
        frame. Without history (the first frame after a restart) it is
        set_camera, then step_interleaved(m) or step(), then
        denoised_frame(), as in the JAX package."""
        history = (self._total_samples() > 0 and m in COSET_GRID
                   and self.interleave_ok(max(m, 2)))
        self.set_camera(camera, temporal=True)
        if history:
            self._coset_step(m)
        elif m > 1:
            self.step_interleaved(m)
        else:
            self.step()
        return self.denoised_frame(iterations=iterations, u8=u8, **kw)


def render_pathtraced(scene: Scene, width: int, height: int, spp: int = 16,
                      **kw) -> np.ndarray:
    return PathTracer(scene, width, height, **kw).render(spp)
