"""Engine configuration: the fields of the JAX package's `RaytracerConfig`
that the port reads, with the same names and defaults, so a field means
the same thing to both packages. The JAX package's fields that only its
TPU path reads (`use_pallas`, `dtype`, `ray_batch_size`, `bvh_stack_depth`,
`pathtrace_samples_per_step`) have no counterpart here.
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
    # Max triangles per BVH leaf; leaves are packed into 8-slot rows.
    bvh_leaf_size: int = 8
    # Children per wide-BVH node: 4 or 8, each with its own kernel instances.
    bvh_width: int = 4
    max_bounce_depth: int = 4
    russian_roulette_start: int = 2
    bounce_lod_bias: float = 0.0
    texture_mips: int = 8
    bvh_spatial_splits: bool = False
    texture_trilinear: bool = False

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
