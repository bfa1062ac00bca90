"""Progressive tile scheduling: the tile grid, the adaptive tiles-per-frame
schedule and the tile cursor (needs-recompute flag, trigger, resize).

A tile is a pixel batch handed to one render call. The Viewer renders whole
frames on a CUDA device (one tile per frame) and keeps the tile cadence on
the CPU, where a full frame spans many frames' time.
"""

from __future__ import annotations

from ..config import DEFAULT_CONFIG, RaytracerConfig


class TileHelper:
    @staticmethod
    def calculate_tile_count(width: int, height: int, tile_size: int):
        """Ceil-div tile grid -> (tiles_x, tiles_y)."""
        return ((width + tile_size - 1) // tile_size,
                (height + tile_size - 1) // tile_size)

    @staticmethod
    def calculate_tiles_per_frame(total_tiles: int) -> int:
        """Adaptive schedule: all at <= 16 tiles, /8 to 64, /32 to 256, /64
        to 1024, then 1; at least 1."""
        if total_tiles <= 16:
            v = total_tiles
        elif total_tiles <= 64:
            v = total_tiles // 8
        elif total_tiles <= 256:
            v = total_tiles // 32
        elif total_tiles <= 1024:
            v = total_tiles // 64
        else:
            v = 1
        return max(v, 1)


class ProgressiveState:
    """Tile cursor for progressive rendering."""

    def __init__(self, width: int, height: int, config: RaytracerConfig = DEFAULT_CONFIG):
        self.config = config
        self.resize(width, height)

    def resize(self, width: int, height: int) -> None:
        self.tiles_x, self.tiles_y = TileHelper.calculate_tile_count(
            width, height, self.config.tile_size)
        self.total_tiles = self.tiles_x * self.tiles_y
        self.tiles_per_frame = TileHelper.calculate_tiles_per_frame(self.total_tiles)
        self.current_tile = 0
        self.needs_recompute = True

    def trigger_recompute(self) -> None:
        """Reset the cursor: a full re-render."""
        self.current_tile = 0
        self.needs_recompute = True

    @property
    def complete(self) -> bool:
        return self.current_tile >= self.total_tiles

    def tile_rect(self, tile_index: int, width: int, height: int):
        """Tile -> (x0, y0, w, h), clamped at the image's edges."""
        ts = self.config.tile_size
        tx = tile_index % self.tiles_x
        ty = tile_index // self.tiles_x
        x0, y0 = tx * ts, ty * ts
        return x0, y0, min(ts, width - x0), min(ts, height - y0)

    def next_tiles(self) -> list[int]:
        """This frame's tiles: min(tiles_per_frame, remaining)."""
        n = min(self.tiles_per_frame, self.total_tiles - self.current_tile)
        tiles = list(range(self.current_tile, self.current_tile + n))
        self.current_tile += n
        if tiles:
            self.needs_recompute = False
        return tiles
