"""The port's host-side app pieces against the JAX package's, on the CPU:
the progressive tile scheduler (engine/progressive.py), the launch-parameter
packing (utils/packing.py) and the performance counters (engine/perf.py).
All host code: results must be equal."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpu_raytracer_tpu import RaytracerConfig as JaxConfig
from gpu_raytracer_tpu.engine import perf as jperf
from gpu_raytracer_tpu.engine.progressive import ProgressiveState as JaxProgressiveState
from gpu_raytracer_tpu.engine.progressive import TileHelper as JaxTileHelper
from gpu_raytracer_tpu.utils import packing as jpacking
from gpu_raytracer_tpu_torch.config import RaytracerConfig
from gpu_raytracer_tpu_torch.engine.perf import (DeviceProfiler, PerformanceState,
                                                 ProgressiveTiming, block_on, percentile)
from gpu_raytracer_tpu_torch.engine.progressive import ProgressiveState, TileHelper
from gpu_raytracer_tpu_torch.utils import packing


@pytest.mark.parametrize("total", [0, 1, 10, 16, 17, 64, 65, 256, 257, 1024, 1025, 4000])
def test_tiles_per_frame_matches_jax(total):
    assert (TileHelper.calculate_tiles_per_frame(total)
            == JaxTileHelper.calculate_tiles_per_frame(total))


@pytest.mark.parametrize("size", [(1920, 1080), (128, 128), (129, 1), (300, 200), (50, 40)])
@pytest.mark.parametrize("tile", [32, 128])
def test_progressive_cursor_matches_jax(size, tile):
    W, H = size
    got = ProgressiveState(W, H, RaytracerConfig(tile_size=tile))
    want = JaxProgressiveState(W, H, JaxConfig(tile_size=tile))
    assert TileHelper.calculate_tile_count(W, H, tile) == JaxTileHelper.calculate_tile_count(
        W, H, tile)
    assert (got.tiles_x, got.tiles_y, got.total_tiles, got.tiles_per_frame) == (
        want.tiles_x, want.tiles_y, want.total_tiles, want.tiles_per_frame)
    for _ in range(got.total_tiles + 1):
        tiles = got.next_tiles()
        assert tiles == want.next_tiles()
        assert [got.tile_rect(t, W, H) for t in tiles] == [want.tile_rect(t, W, H)
                                                           for t in tiles]
        assert (got.complete, got.needs_recompute) == (want.complete, want.needs_recompute)
    got.trigger_recompute()
    assert not got.complete and got.current_tile == 0 and got.needs_recompute


def test_packing_matches_jax():
    for w, h in ((128, 128), (1, 65535), (70000, 3), (0, 0)):
        p = packing.pack_tile_size(w, h)
        assert p == jpacking.pack_tile_size(w, h)
        assert packing.unpack_tile_size(p) == jpacking.unpack_tile_size(p)
    for args in ((2, 3, 8, 1), (0, 0, 0, 0), (255, 1, 300, 2)):
        f = packing.pack_flags(*args)
        assert f == jpacking.pack_flags(*args)
        for name in ("color_channel", "current_bounce_depth", "max_bounce_depth",
                     "wavefront_mode"):
            assert getattr(packing, name)(f) == getattr(jpacking, name)(f)
    for c in (True, False):
        for t, f in ((7, 13), (0xFFFFFFFF, 0), (0, 0xFFFFFFFF)):
            assert packing.branchless_u32_if(c, t, f) == jpacking.branchless_u32_if(c, t, f)


def test_branchless_float_if_matches_jax():
    nan = float("nan")
    cond = [True, False, True, False, True, False, True]
    t = [0.5, 0.5, nan, nan, nan, -0.5, 3e38]
    f = [-1.0, -1.0, 1.0, 1.0, nan, nan, 1.0]
    got_v, got_ok = packing.branchless_float_if(torch.tensor(cond), torch.tensor(t),
                                                torch.tensor(f))
    want_v, want_ok = jpacking.branchless_float_if(jnp.asarray(cond), jnp.asarray(t),
                                                   jnp.asarray(f))
    assert np.array_equal(got_v.numpy().view(np.uint32),
                          np.asarray(want_v, np.float32).view(np.uint32))
    assert np.array_equal(got_ok.numpy(), np.asarray(want_ok))
    v, ok = packing.branchless_float_if(False, nan, nan)     # scalars
    assert float(v) == np.float32(packing.F32_MAX) and not bool(ok)


def test_timing_matches_jax():
    got, want = ProgressiveTiming(), jperf.ProgressiveTiming()
    for v in [1.0, 2.0, 3.0, 4.0, 100.0]:
        got.record_tile(v)
        want.record_tile(v)
    g, w = got.summary(), want.summary()
    for k in ("tiles", "p50_ms", "p95_ms", "p99_ms"):
        assert g[k] == w[k]
    assert percentile([], 0.5) == 0.0
    ps = PerformanceState(interval=2, verbose=False)
    ps.update_frame_count()
    ps.update_frame_count()
    assert ps.frame_count == 2 and ps.last_fps > 0


def test_block_on_returns_its_argument_on_the_cpu():
    x = torch.ones(3)
    assert block_on(x) is x
    pair = (x, {"a": 1})
    assert block_on(pair) is pair
    d = {"frame": x}
    assert block_on(d) is d


def test_device_profiler_writes_a_trace(tmp_path):
    with DeviceProfiler(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
    assert any("mm" in e.key for e in prof.profile.key_averages())
