"""Engine configuration.

The same fields and defaults as the JAX package's `RaytracerConfig`, so a
configuration means the same thing to both packages. Fields that only the
TPU kernels read (`use_pallas`, the path-tracing knobs) are kept for that
parity; the parts of the port that exist so far read `bvh_leaf_size`,
`bvh_width`, `texture_mips` and `texture_trilinear`.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class RaytracerConfig:
    tile_size: int = 128
    camera_move_speed: float = 0.1
    camera_rotate_sensitivity: float = 0.005
    min_ray_distance: float = 1e-5
    performance_stats_interval: int = 60
    camera_pitch_clamp: float = 0.99
    ray_batch_size: int = 128 * 1024
    bvh_stack_depth: int = 64
    # Max triangles per BVH leaf; leaves are packed into 8-slot rows.
    bvh_leaf_size: int = 8
    # Children per wide-BVH node: 4 or 8, each with its own kernel instances.
    bvh_width: int = 4
    max_bounce_depth: int = 4
    russian_roulette_start: int = 2
    pathtrace_samples_per_step: int = 1
    bounce_lod_bias: float = 0.0
    texture_mips: int = 8
    bvh_spatial_splits: bool = False
    texture_trilinear: bool = False
    dtype: str = "float32"
    use_pallas: bool = True

    def replace(self, **kw) -> "RaytracerConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = RaytracerConfig()


def add_config_args(parser: argparse.ArgumentParser) -> None:
    """Register every config field as a CLI flag (--tile-size etc.)."""
    for f in dataclasses.fields(RaytracerConfig):
        flag = "--" + f.name.replace("_", "-")
        if isinstance(f.default, bool):
            parser.add_argument(flag, type=lambda s: s.lower() in ("1", "true", "yes"),
                                default=f.default)
        else:
            parser.add_argument(flag, type=type(f.default), default=f.default)


def config_from_args(args: argparse.Namespace) -> RaytracerConfig:
    kw = {f.name: getattr(args, f.name) for f in dataclasses.fields(RaytracerConfig)
          if hasattr(args, f.name)}
    return RaytracerConfig(**kw)
