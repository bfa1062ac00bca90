"""Adaptive progressive path tracing: variance-weighted sample allocation, the
counterpart of `gpu_raytracer_tpu/engine/adaptive.py`.

Each step spends a fixed budget, K tiles x 4096 lanes (one pool of one
shape every step), on the 64x64 tiles with the highest estimated error of
the mean:

    score(tile) = mean over pixels of  sqrt(Var[mean]) / (mean + 0.05)

with Var[mean] = (E[l^2] - E[l]^2) / n from per-pixel luminance moment
accumulators. The first 2 * ceil(T/K) steps sweep the tiles round-robin
(every pixel needs n >= 2 for a variance); from then on a quarter of each
step (at least one tile, none for K = 1) continues the round-robin sweep
and the rest takes the top-scoring tiles, unseeded tiles (n < 2) first.
Whether a step is past the warm-up is known on the host, so a step reads
nothing back from the device.

Estimator: a pixel's value is the plain mean of its own samples (accum /
count): every sample is an unbiased estimate whatever tiles were refined.
The pool runs the independent stream (`sampler="rng"`, torch.Generator):
an irregular subset of sample indices forfeits the lattice's
stratification. So the image agrees with the JAX package's only
statistically; the tile selection is exact: the same accumulators in give
the same tiles out.

Works on whole 64x64 tiles (width and height multiples of 64): a tile is a
contiguous block of 4096 rows of the tile-major accumulator.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, RaytracerConfig
from ..models.scene import Scene
from ..ops.wavefront import RGB_CHANNEL
from .pathtracer import PathTracer, _sample_chunk

TILE = 64
TILE_PX = TILE * TILE  # 4096


def select_tiles(accum, accum_sq, counts, g: int, K: int, T: int,
                 adaptive_from: int) -> torch.Tensor:
    """The K tiles step `g` refines -> [K] int64 tile indices (repeats
    allowed): the round-robin sweep (g * K + k) mod T before
    `adaptive_from`; after it K_RR = max(1, K // 4) (0 for K = 1) tiles of
    the sweep (g * K_RR + k) mod T, then the K - K_RR highest scores, the
    lower tile index first on equal scores (lax.top_k's order: a stable
    descending sort)."""
    dev = accum.device
    if g < adaptive_from:
        return (g * K + torch.arange(K, device=dev)) % T
    n = torch.clamp(counts.to(torch.float32), min=1.0)
    lum = accum.mean(dim=-1)                        # [C] summed luminance
    mean = lum / n
    var = torch.clamp(accum_sq / n - mean * mean, min=0.0)
    score_px = torch.sqrt(var / n) / (mean + 0.05)  # relative error of the mean
    score_tile = score_px.reshape(T, TILE_PX).mean(dim=-1)
    # n < 2 makes the sample variance zero: unseeded tiles score first
    n_tile = counts.reshape(T, TILE_PX)[:, 0].to(torch.float32)
    score_tile = torch.where(n_tile < 2.0, torch.full_like(score_tile, 1e9), score_tile)
    # a quarter of the step keeps sweeping: a variance that never saw a rare
    # path understates the error, and the sweep bounds every revisit
    K_RR = 0 if K == 1 else max(1, K // 4)
    rr = (g * K_RR + torch.arange(K_RR, device=dev)) % T
    top = torch.sort(score_tile, descending=True, stable=True)[1][:K - K_RR]
    return torch.cat([rr, top])


class AdaptivePathTracer(PathTracer):
    """PathTracer whose step() refines the K highest-error tiles.

    `samples` reports the average samples per pixel (total samples /
    pixels); the per-pixel counts live in `counts` [C] int32 and the
    per-pixel luminance squares in `accum_sq` [C] f32."""

    def __init__(self, scene: Scene, width: int, height: int,
                 config: RaytracerConfig = DEFAULT_CONFIG, tiles_per_step: int = 16, **kw):
        if width % TILE or height % TILE:
            raise ValueError(f"adaptive sampling works on whole {TILE}x{TILE} tiles: "
                             f"{width}x{height} is not a multiple of {TILE}")
        kw.setdefault("sampler", "rng")   # the pool runs the independent stream either way
        super().__init__(scene, width, height, config=config, **kw)
        self.T = (width // TILE) * (height // TILE)
        self.K = max(1, min(int(tiles_per_step), self.T))
        # two full sweeps before the error signal takes over: the sample
        # variance needs n >= 2 per pixel to be nonzero at all
        self.adaptive_from = 2 * (-(-self.T // self.K))
        C = height * width
        self.accum_sq = torch.zeros((C,), dtype=torch.float32, device=self.device)
        self.counts = torch.zeros((C,), dtype=torch.int32, device=self.device)
        self._steps = 0
        self._tile_rows = torch.arange(TILE_PX, device=self.device)

    @property
    def samples(self) -> float:
        if self._steps == 0:
            return 0
        return float(self._steps * self.K * TILE_PX) / self.accum.shape[0]

    @samples.setter
    def samples(self, v):   # PathTracer.__init__ and reset assign 0
        if not getattr(self, "K", 0) or not v:
            self._steps = 0
        else:   # average spp -> step count
            self._steps = int(round(float(v) * self.accum.shape[0] / (self.K * TILE_PX)))

    def reset(self) -> None:
        super().reset()
        self.accum_sq.zero_()
        self.counts.zero_()

    def _n_total(self) -> torch.Tensor:
        n = self.counts.to(torch.float32)
        if self._count_base is not None:
            n = n + self._count_base
        return n

    def set_camera(self, camera, temporal: bool = False) -> None:
        """A temporal warp folds the reprojected history into the adaptive
        accumulators: counts <- round(n0), accum_sq <- n0 * mean_lum^2 (the
        history's own variance is unknown, so it seeds at zero, an
        underestimate the round-robin share of each step corrects)."""
        super().set_camera(camera, temporal=temporal)
        if temporal and self._count_base is not None:
            n0 = self._count_base
            self.counts = torch.round(n0).to(torch.int32)
            mean_lum = self.accum.mean(dim=-1) / torch.clamp(n0, min=1.0)
            self.accum_sq = n0 * mean_lum * mean_lum
            self._count_base = None   # the adaptive step reads self.counts
            self._steps = 0

    def step(self) -> None:
        """Refine K tiles by one sample each pixel."""
        g = self._steps
        self._last_seed = g
        sel = select_tiles(self.accum, self.accum_sq, self.counts, g, self.K, self.T,
                           self.adaptive_from)
        rows = (sel[:, None] * TILE_PX + self._tile_rows[None, :]).reshape(-1)
        contrib, self._last_counts = _sample_chunk(
            self.tables, self._px[rows], self._py[rows], self.width, self.height,
            RGB_CHANNEL if self.spectral else 1, self.config.max_bounce_depth,
            self.config.russian_roulette_start, self.shadows, self.antialias,
            qmc=False, sample_base=g, tex_lod_bias=self.config.bounce_lod_bias,
            rng_seed=self.seed, fov_scale=self.tables.render.fov_scale)
        # a tile chosen twice adds both samples
        self.accum.index_add_(0, rows, contrib)
        self.accum_sq.index_add_(0, rows, contrib.mean(dim=-1) ** 2)
        self.counts.index_add_(0, rows, torch.ones_like(rows, dtype=torch.int32))
        self._steps += 1

    def image(self) -> np.ndarray:
        n = np.maximum(self.counts.cpu().numpy(), 1)[:, None]
        flat = self.accum.cpu().numpy() / n
        fb = np.zeros((self.height, self.width, 3), np.float32)
        fb[self._py_host, self._px_host] = flat
        return fb

    def _inv_n(self) -> torch.Tensor:
        # a per-pixel [C,1] inverse count in place of the uniform scalar
        return (1.0 / torch.clamp(self.counts.to(torch.float32), min=1.0))[:, None]

    def save_checkpoint(self, path: str) -> None:
        cam = self.scene.camera
        host = lambda t: t.detach().cpu().numpy()
        np.savez_compressed(path, accum=host(self.accum), accum_sq=host(self.accum_sq),
                            counts=host(self.counts), samples=self._steps, width=self.width,
                            height=self.height, camera_position=host(cam.position),
                            camera_direction=host(cam.direction), camera_up=host(cam.up),
                            camera_fov=host(cam.fov))

    def load_checkpoint(self, path: str) -> None:
        with np.load(path) as data:
            if int(data["width"]) != self.width or int(data["height"]) != self.height:
                raise ValueError(f"checkpoint is {int(data['width'])}x{int(data['height'])}, "
                                 f"the tracer {self.width}x{self.height}")
            tensor = lambda k, dtype: torch.from_numpy(np.asarray(data[k], dtype)).to(self.device)
            self.accum = tensor("accum", np.float32)
            self.accum_sq = tensor("accum_sq", np.float32)
            self.counts = tensor("counts", np.int32)
            self._steps = int(data["samples"])
