"""Performance observability: a frame counter with an FPS line every N
frames, per-step times with P50/P95/P99 and Mrays/s, a wall-clock timer
that waits for the device, a completion fence, a device trace
(torch.profiler), and the program's own spans and counters.

Mrays/s keeps the reference's definition by default: one tile is
128 x 128 pixels x 3 wavelength passes = 49,152 primary rays.

Spans and counters (`span`, `count`) are on only while a torch profiler
runs (`torch.profiler.profile`, `DeviceProfiler`). Then a span is a
`record_function`, a nested `user_annotation` on the device trace's clock,
and the recorder keeps each name's calls and host nanoseconds and each
counter's values; `snapshot()` reads them, `reset()` clears them. With no
profiler a span is one shared null context: it allocates nothing, reads no
clock and issues no device work. A counter's device tensor is kept by
reference and read only in `snapshot()`, never inside a step or frame.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import torch
import torch.autograd.profiler as _autograd_profiler

RAYS_PER_TILE = 128 * 128 * 3


def percentile(sorted_vals: list[float], p: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(int(len(sorted_vals) * p), len(sorted_vals) - 1)
    return sorted_vals[idx]


@dataclass
class ProgressiveTiming:
    """Step times of a progressive pass and their summary."""

    tile_times_ms: list = field(default_factory=list)
    start_time: float = field(default_factory=time.perf_counter)
    rays_per_tile: int = RAYS_PER_TILE

    def record_tile(self, ms: float) -> None:
        self.tile_times_ms.append(ms)

    def summary(self) -> dict:
        ts = sorted(self.tile_times_ms)
        total_s = time.perf_counter() - self.start_time
        n = len(ts)
        tiles_per_s = n / total_s if total_s > 0 else 0.0
        return {
            "tiles": n,
            "total_s": total_s,
            "tiles_per_s": tiles_per_s,
            "mrays_per_s": tiles_per_s * self.rays_per_tile / 1e6,
            "p50_ms": percentile(ts, 0.50),
            "p95_ms": percentile(ts, 0.95),
            "p99_ms": percentile(ts, 0.99),
        }

    def print_summary(self) -> None:
        s = self.summary()
        print(f"=== Progressive pass complete: {s['tiles']} tiles in "
              f"{s['total_s']:.2f}s ({s['tiles_per_s']:.1f} tiles/s, "
              f"{s['mrays_per_s']:.1f} Mrays/s) ===")
        print(f"    tile times p50={s['p50_ms']:.2f}ms "
              f"p95={s['p95_ms']:.2f}ms p99={s['p99_ms']:.2f}ms")


class PerformanceState:
    """Frame counter + FPS print every `interval` frames."""

    def __init__(self, interval: int = 60, verbose: bool = True):
        self.interval = interval
        self.verbose = verbose
        self.frame_count = 0
        self._window_start = time.perf_counter()
        self.last_fps = 0.0

    def update_frame_count(self) -> None:
        self.frame_count += 1
        if self.frame_count % self.interval == 0:
            now = time.perf_counter()
            dt = now - self._window_start
            self.last_fps = self.interval / dt if dt > 0 else 0.0
            self._window_start = now
            if self.verbose:
                print(f"FPS: {self.last_fps:.1f} "
                      f"({1000.0 / max(self.last_fps, 1e-9):.2f} ms/frame)")


class Timer:
    """Context manager measuring wall milliseconds. Given a CUDA device it
    synchronises the device on exit, so the time covers the work enqueued
    inside the block, not only its enqueueing."""

    def __init__(self, device: torch.device | None = None):
        self.device = device
        self.ms = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.ms = (time.perf_counter() - self._t0) * 1000.0
        return False


def block_on(x):
    """Wait until the device has finished the work that produced `x` (a
    tensor, or a tuple / list / dict of them): a synchronise of the current
    stream of each CUDA tensor's device; nothing for CPU tensors. Returns x."""
    leaves = x.values() if isinstance(x, dict) else x if isinstance(x, (tuple, list)) else (x,)
    for t in leaves:
        if isinstance(t, torch.Tensor) and t.device.type == "cuda":
            torch.cuda.current_stream(t.device).synchronize()
    return x


class Recorder:
    """What the program's spans and counters gathered while a profiler ran:
    name -> [calls, host ns] of each span, name -> the values counted."""

    def __init__(self):
        self.spans = {}
        self.counters = {}

    def add_span(self, name: str, ns: int) -> None:
        s = self.spans.get(name)
        if s is None:
            self.spans[name] = [1, ns]
        else:
            s[0] += 1
            s[1] += ns

    def snapshot(self) -> dict:
        """{"spans": {name: {"calls", "ns"}}, "counters": {name: total}}. A
        counter's device tensors are summed on their device and read with
        one synchronise."""
        counters = {}
        for name, values in self.counters.items():
            total, by_device = 0, {}
            for v in values:
                if isinstance(v, torch.Tensor):
                    by_device.setdefault(v.device, []).append(v.reshape(()))
                else:
                    total += int(v)
            for ts in by_device.values():
                total += int(torch.stack(ts).sum())
            counters[name] = total
        return {"spans": {n: {"calls": c, "ns": ns} for n, (c, ns) in self.spans.items()},
                "counters": counters}

    def reset(self) -> None:
        self.spans.clear()
        self.counters.clear()


RECORDER = Recorder()
_NULL_SPAN = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "_rf", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        RECORDER.add_span(self.name, time.perf_counter_ns() - self._t0)
        self._rf.__exit__(*exc)
        return False


def span(name: str):
    """A context manager around one phase of the program: with a torch
    profiler running, a `record_function(name)` whose calls and host time
    the recorder keeps; otherwise one shared null context."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL_SPAN
    return _Span(name)


def count(name: str, value) -> None:
    """Add `value` (a Python int, or a 0-d tensor kept by reference, not
    read) to counter `name` while a torch profiler runs."""
    if _autograd_profiler._is_profiler_enabled:
        RECORDER.counters.setdefault(name, []).append(value)


def snapshot() -> dict:
    """The recorder's spans and counters (`Recorder.snapshot`)."""
    return RECORDER.snapshot()


def reset() -> None:
    RECORDER.reset()


class DeviceProfiler:
    """torch.profiler over a block, CPU and CUDA activities; on exit the
    trace goes to `log_dir` as a Chrome trace (Perfetto), and `profile`
    holds the profiler for `key_averages()`.

        with DeviceProfiler("trace_dir"):
            renderer.render_device()

    The trace carries the program's spans (`span`) as nested
    `user_annotation` events on the kernels' clock: `viewer.input` (a
    camera move, around `renderer.set_camera`), `viewer.run_compute` (around
    `renderer.render`, the frame's kernel wrappers), `pathtracer.step`
    (around `pathtracer.camera_pool`, each depth's `pool.order` and
    `pool.bounce`, and `pathtracer.accumulate`); the camera pool and the
    `pool.*` spans also inside a fly frame and an interleaved step. The
    recorder counts `pool.lanes` and `pool.live`, the lanes handed to the
    bounce kernel and the live ones among them, and at every K2, K2t and K3
    launch `render.table_bytes`, the bytes of the node and triangle tables
    the launch walks (`snapshot()`).
    """

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.profile = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.profile = profile(activities=acts)
        self.profile.__enter__()
        return self

    def __exit__(self, *exc):
        import os

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.profile.__exit__(*exc)
        os.makedirs(self.log_dir, exist_ok=True)
        self.profile.export_chrome_trace(os.path.join(self.log_dir, "trace.json"))
        return False
