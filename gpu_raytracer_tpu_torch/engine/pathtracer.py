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

Not ported yet (ROADMAP queue 1 item 9): the temporal reprojection
(`set_camera(temporal=True)`), the interleaved step, the fly-through frame,
the G-buffer and the denoised outputs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, RaytracerConfig
from ..models.scene import Scene
from ..ops.cuda.bounce import pack_bounce_tables
from ..ops.cuda.render import set_camera
from ..ops.wavefront import (RGB_CHANNEL, WavefrontCounters, camera_wavefront_rays,
                             path_trace_pool)
from .perf import PerformanceState, ProgressiveTiming, Timer
from .renderer import resolve_device, tiled_pixel_order

JITTER_STREAM = -1   # the independent stream's "depth" of the pixel jitter
_NOT_PORTED = "is not ported yet (ROADMAP queue 1 item 9)"


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
        self.accum = torch.zeros((height * width, 3), dtype=torch.float32, device=self.device)
        self.samples = 0
        self._last_counts = None
        self._last_seed = 0
        self.perf = PerformanceState(config.performance_stats_interval, verbose=False)

    def set_camera(self, camera, temporal: bool = False) -> None:
        """Move the camera and restart the accumulation. The camera row of the
        tables is rewritten in place; nothing else is repacked."""
        if temporal:
            raise NotImplementedError(f"set_camera(temporal=True) {_NOT_PORTED}")
        set_camera(self.tables.render, camera)
        self.scene = self.tables.scene
        self.reset()

    def reset(self) -> None:
        """Restart the accumulation."""
        self.accum.zero_()
        self.samples = 0

    def step(self) -> None:
        """Trace samples_per_step samples per pixel and accumulate."""
        self._last_seed = self.samples
        contrib, self._last_counts = _sample_chunk(
            self.tables, self._px, self._py, self.width, self.height,
            RGB_CHANNEL if self.spectral else 1, self.config.max_bounce_depth,
            self.config.russian_roulette_start, self.shadows, self.antialias,
            spp=self.samples_per_step, qmc=self.qmc, sample_base=self.samples,
            qmc_seed=self._qmc_seed, tex_lod_bias=self.config.bounce_lod_bias,
            rng_seed=self.seed, fov_scale=self.tables.render.fov_scale)
        self.accum += contrib
        self.samples += self.samples_per_step
        self.perf.update_frame_count()

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
        """The accumulated mean -> host float32 [H,W,3]."""
        flat = self.accum.cpu().numpy() / max(self.samples, 1)
        fb = np.zeros((self.height, self.width, 3), np.float32)
        fb[self._py_host, self._px_host] = flat
        return fb

    def image_device(self, u8: bool = False) -> torch.Tensor:
        """The accumulated mean on the device, row-major [H,W,3]: f32, or
        sRGB-encoded uint8 with u8=True."""
        inv_n = torch.full((), 1.0 / max(self.samples, 1), dtype=torch.float32,
                           device=self.device)
        out = (self.accum * inv_n)[self._inv_perm].reshape(self.height, self.width, 3)
        if u8:
            from ..utils.image import linear_to_srgb

            out = (torch.clamp(linear_to_srgb(out), 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
        return out

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

    def step_interleaved(self, m: int = 4) -> None:
        raise NotImplementedError(f"step_interleaved {_NOT_PORTED}")

    def fly_frame(self, camera, m: int = 4, iterations: int = 4, u8: bool = False, **kw):
        raise NotImplementedError(f"fly_frame {_NOT_PORTED}")

    def gbuffer(self):
        raise NotImplementedError(f"gbuffer {_NOT_PORTED}")

    def denoised_frame(self, iterations: int = 4, u8: bool = False, **kw):
        raise NotImplementedError(f"denoised_frame {_NOT_PORTED}")

    def denoised_image(self, iterations: int = 4, **kw):
        raise NotImplementedError(f"denoised_image {_NOT_PORTED}")


def render_pathtraced(scene: Scene, width: int, height: int, spp: int = 16,
                      **kw) -> np.ndarray:
    return PathTracer(scene, width, height, **kw).render(spp)
