"""Interactive application shell, headless: `Viewer`.

A Viewer owns the scene, the camera controller, the progressive tile
schedule and the performance counters, and takes the reference app's input:
WASD movement, mouse-drag look, space to render again, L to load a glTF
scene (keeping the current one when the load fails), P for progressive path
tracing, N / T / I for its denoised preview, temporal reprojection and
fly-through interleave. `update_geometry` moves the mesh's vertices and
refits the BVH on the device (models/scene.py::refit_scene), with the
renderer's and path tracer's tables taken along in place.

Every frame is run_compute (the frame's tiles into the framebuffer) and
then a present (`framebuffer`, `framebuffer_u8`, `present_frame`,
`present_frame_packed`). On a CUDA device a frame is one whole-frame render
(`Renderer.render_device`: K2, or K3 + K4 on a textured scene) left on the
device; on the CPU the frame goes through the plain path in
`config.tile_size` tiles, as the JAX package's CPU run does. A present of a
frame that stays on a CUDA device starts its read-back at once
(`HostFrame`): a non-blocking copy into pinned host memory and an event, so
a presenter that materialises frame N-1 while frame N computes
(engine/server.py, engine/window.py) waits for nothing else. Above
MAX_LIGHTS lights the kernels sample one light per pixel, so idle frames
draw fresh choices and fold them into a running mean.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, RaytracerConfig
from ..models.camera import CameraController
from ..models.scene import Scene, refit_scene
from ..ops.cuda.render import MAX_LIGHTS
from ..utils.image import quantize_u8, to_u8
from .perf import PerformanceState, ProgressiveTiming, Timer, block_on, span
from .progressive import ProgressiveState
from .renderer import Renderer, resolve_device, tiled_pixel_order


class HostFrame:
    """The present handle of a frame on a CUDA device: its u8 bytes on their
    way into pinned host memory (a non-blocking copy) and the event recorded
    after the copy. `Viewer.materialize_frame` takes it. The pinned block
    comes from PyTorch's caching host allocator, which does not hand it out
    again before the copy has passed it and the handle is gone, so every
    handle keeps its own frame, however many presents follow it."""

    __slots__ = ("host", "event")

    def __init__(self, frame: torch.Tensor):
        self.host = torch.empty(frame.shape, dtype=frame.dtype, pin_memory=frame.is_cuda)
        self.host.copy_(frame, non_blocking=True)
        self.event = None
        if frame.is_cuda:
            self.event = torch.cuda.Event()
            self.event.record()

    @property
    def shape(self) -> tuple:
        """[H,W,3] for RGB, [H*3/2, W] for packed YUV 4:2:0."""
        return tuple(self.host.shape)

    def wait(self) -> np.ndarray:
        """Wait for the copy's event (nothing else) -> the bytes."""
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


# WASD: the camera controller's move of each key
_MOVES = {"w": dict(forward=1.0), "s": dict(forward=-1.0), "a": dict(strafe=-1.0),
          "d": dict(strafe=1.0)}


class Viewer:
    def __init__(self, scene: Scene, width: int = 1280, height: int = 720,
                 config: RaytracerConfig = DEFAULT_CONFIG, shadows: bool = False,
                 verbose: bool = True, device=None):
        self.device = resolve_device(device, "Viewer")
        self.config = config
        self.width = width
        self.height = height
        self.shadows = shadows
        self.verbose = verbose
        self.renderer = Renderer(scene, width, height, config=config, shadows=shadows,
                                 device=self.device)
        self.scene = self.renderer.scene
        self.controller = CameraController(scene.camera, config)
        self.progressive = ProgressiveState(width, height, config)
        self.perf = PerformanceState(config.performance_stats_interval, verbose)
        self.timing = ProgressiveTiming()
        # the frame stays on the device in whole-frame mode; the host copy
        # is made when `framebuffer` is read
        self._fb_host = np.zeros((height, width, 3), np.float32)
        self._fb_dev = None
        self._fb_host_dirty = False
        self._fb_rowmajor = False   # True: _fb_dev is a row-major path-traced frame
        self.should_quit = False
        # more than MAX_LIGHTS lights: while the camera stands still, idle
        # frames draw fresh light choices and average into the device frame,
        # which converges to the loop over every light; a move restarts it
        self._light_frame_no = 0
        self._nee_samples = 0
        self.nee_accum_limit = 64
        # 'p': progressive path tracing, one sample per frame
        self.pathtrace = False
        self._pt = None
        # 'n': the à-trous preview while the accumulation is younger than
        # denoise_until samples, then the raw mean
        self.denoise = True
        self.denoise_until = 32
        # 't': camera moves warp the accumulation into the new view
        # (PathTracer.set_camera(temporal=True)) instead of restarting it
        self.temporal = True
        # 'i' cycles 1/2/4/8: a moving path-traced frame samples every m-th
        # pixel (PathTracer.fly_frame); still frames take full steps
        self.fly_interleave = 4
        self._pt_moved = False
        # moving frames reconstruct with one pass fewer than the preview's 4
        self.fly_denoise_iters = 3
        ts = config.tile_size
        self._tile_gx, self._tile_gy = tiled_pixel_order(ts, ts)
        self._tile_coords = {}   # tile -> (px, py) host, (px, py) on the device
        self._sync_mode()

    def _sync_mode(self) -> None:
        """Pick the frame's granularity: on a CUDA device the whole frame is
        one tile (one launch renders it in well under a frame's budget); on
        the CPU the `config.tile_size` cadence, where a frame spans many."""
        self._whole_frame = self.device.type == "cuda"
        self.progressive.resize(self.width, self.height)
        if self._whole_frame:
            self.progressive.tiles_x = self.progressive.tiles_y = 1
            self.progressive.total_tiles = 1
            self.progressive.tiles_per_frame = 1
            self.progressive.current_tile = 0

    # ---- input ----

    def handle_key(self, key: str) -> None:
        key = key.lower()
        if key in _MOVES or key in (" ", "space"):    # space: render again
            with span("viewer.input"):
                if key in _MOVES:
                    self.controller.move(**_MOVES[key])
                self._apply_camera()
            return
        if key == "p":
            self.pathtrace = not self.pathtrace
            if self.pathtrace:
                self._ensure_pathtracer()
        elif key == "n":
            self.denoise = not self.denoise
        elif key == "t":
            self.temporal = not self.temporal
        elif key == "i":
            self.fly_interleave = {1: 2, 2: 4, 4: 8, 8: 1}.get(self.fly_interleave, 4)
        elif key == "l":
            self.load_gltf("model.gltf")
        elif key == "escape":
            self.should_quit = True

    def handle_mouse_drag(self, dx: float, dy: float) -> None:
        with span("viewer.input"):
            self.controller.rotate(dx, dy)
            self._apply_camera()

    def _apply_camera(self) -> None:
        """The controller's camera into the renderer (its camera row
        rewritten in place) and the path tracer: warped into at the next
        frame where it has history and temporal is on, else restarted."""
        self.renderer.set_camera(self.controller.camera())
        self.scene = self.renderer.scene
        if self._pt is not None:
            if self.temporal and self._pt._total_samples() > 0:
                # the warp, the interleaved step and the filter run as one
                # moving frame (PathTracer.fly_frame) in run_compute
                self._pt_moved = True
            else:
                self._pt.set_camera(self.scene.camera, temporal=self.temporal)
        self.progressive.trigger_recompute()
        self.timing = ProgressiveTiming()

    def _ensure_pathtracer(self) -> None:
        if self._pt is None:
            from .pathtracer import PathTracer

            self._pt = PathTracer(self.scene, self.width, self.height, config=self.config,
                                  shadows=self.shadows, device=self.device)

    def load_gltf(self, path: str) -> None:
        """Replace the scene with a glTF file's; on a failed load keep the
        current one (and say why). A full re-render either way."""
        from ..models.gltf import scene_from_gltf

        try:
            new_scene = scene_from_gltf(path, config=self.config)
        except Exception as e:  # noqa: BLE001: any load error keeps the scene, as the reference
            if self.verbose:
                print(f"Failed to load glTF scene '{path}': {e}")
            return
        self.renderer = Renderer(new_scene, self.width, self.height, config=self.config,
                                 shadows=self.shadows, device=self.device)
        self.scene = self.renderer.scene
        self.controller = CameraController(new_scene.camera, self.config)
        # the path tracer of the old scene goes; 'p' makes a new one lazily
        self._pt = None
        self._sync_mode()
        self.progressive.trigger_recompute()
        self.timing = ProgressiveTiming()

    def update_geometry(self, vertices) -> None:
        """Move the mesh's vertices [V,3] (host array or tensor; same
        topology) and refit the BVH on the device (a topology refit:
        models/scene.py::refit_scene), then render again. The renderer's
        tables are rewritten in place; the path tracer, if any, takes the
        new geometry and restarts its accumulation."""
        self.renderer.set_geometry(refit_scene(self.scene, vertices))
        self.scene = self.renderer.scene
        if self._pt is not None:
            self._pt.set_geometry(self.scene)
        self.progressive.trigger_recompute()

    def resize(self, width: int, height: int) -> None:
        """A new resolution: renderer, tile coordinates, framebuffer and
        progressive grid at the new size, then a full re-render; the camera
        and the scene stay."""
        if (width, height) == (self.width, self.height) or width < 1 or height < 1:
            return
        self.width = width
        self.height = height
        self.renderer = Renderer(self.scene, width, height, config=self.config,
                                 shadows=self.shadows, device=self.device)
        self.scene = self.renderer.scene
        self._fb_host = np.zeros((height, width, 3), np.float32)
        self._fb_dev = None
        self._tile_coords = {}
        if self._pt is not None:     # the accumulation is per resolution
            self._pt = None
            if self.pathtrace:
                self._ensure_pathtracer()
        self._sync_mode()
        self.progressive.trigger_recompute()
        self.timing = ProgressiveTiming()

    # ---- frame loop ----

    def _coords(self, tile: int):
        """A tile's pixel coordinates, on the host and on the device, made
        once per resolution. The tile is launched whole, with its pixels
        past the image's edge clamped to the edge: they recompute an edge
        pixel, and the scatter writes each real pixel with its own value."""
        got = self._tile_coords.get(tile)
        if got is None:
            x0, y0, _, _ = self.progressive.tile_rect(tile, self.width, self.height)
            px = np.minimum(x0 + self._tile_gx, self.width - 1).astype(np.int32)
            py = np.minimum(y0 + self._tile_gy, self.height - 1).astype(np.int32)
            got = (px, py, torch.from_numpy(px).to(self.device),
                   torch.from_numpy(py).to(self.device))
            self._tile_coords[tile] = got
        return got

    def _pathtrace_frame(self) -> None:
        pt = self._pt
        moving = self._pt_moved and self.temporal
        self._pt_moved = False
        with Timer() as timer:
            if moving and self.denoise:
                # one moving frame: warp, interleaved step, filter
                self._fb_dev = pt.fly_frame(self.scene.camera, m=self.fly_interleave,
                                            iterations=self.fly_denoise_iters)
            elif moving:
                pt.set_camera(self.scene.camera, temporal=True)
                if self.fly_interleave > 1:
                    pt.step_interleaved(self.fly_interleave)
                else:
                    pt.step()
                self._fb_dev = pt.image_device()
            else:
                pt.step()
                self._fb_dev = (pt.denoised_frame()
                                if self.denoise and pt.samples < self.denoise_until
                                else pt.image_device())
        self.timing.record_tile(timer.ms)

    def run_compute(self) -> int:
        """Render this frame's tiles into the framebuffer -> the number of
        tiles rendered (0 once the frame is complete: an idle frame, which
        above MAX_LIGHTS lights refines the light estimate instead)."""
        with span("viewer.run_compute"):
            return self._run_compute()

    def _run_compute(self) -> int:
        if self.pathtrace:
            self._ensure_pathtracer()
            self._pathtrace_frame()
            self._fb_rowmajor = True
            self._fb_host_dirty = True
            self._nee_samples = 0   # a path-traced frame: nothing to refine
            return 1
        tiles = self.progressive.next_tiles()
        if self._whole_frame:
            if tiles:
                self.renderer.light_frame = self._light_frame_no
                self._light_frame_no += 1
                if self.verbose:    # the timing's only reader is the verbose summary
                    with Timer() as timer:   # the enqueue: frames pipeline, nothing waits
                        self._fb_dev = self.renderer.render_device()
                    self.timing.record_tile(timer.ms)
                    if self.progressive.complete:
                        self.timing.print_summary()
                else:
                    self._fb_dev = self.renderer.render_device()
                self._fb_rowmajor = False
                self._fb_host_dirty = True
                self._nee_samples = 1
            elif self._nee_accum_pending():
                # an idle frame: one more single-sample frame into the mean
                self.renderer.light_frame = self._light_frame_no
                self._light_frame_no += 1
                fb = self.renderer.render_device()
                n = self._nee_samples + 1
                self._fb_dev = self._fb_dev + (fb - self._fb_dev) / n
                self._nee_samples = n
                self._fb_host_dirty = True
            return len(tiles)
        results = []
        with Timer() as timer:
            for t in tiles:
                px, py, dpx, dpy = self._coords(t)
                results.append((px, py, self.renderer.render_rays(dpx, dpy)))
            if results:
                block_on(results[-1][2])
        for px, py, rgb in results:
            self._fb_host[py, px] = rgb.cpu().numpy()
        self._fb_dev = None
        self._fb_rowmajor = False
        for _ in tiles:
            self.timing.record_tile(timer.ms / len(tiles))
        if tiles and self.progressive.complete and self.verbose:
            self.timing.print_summary()
        return len(tiles)

    def _nee_accum_pending(self) -> bool:
        """An idle whole frame whose kernels sample one light per pixel (more
        than MAX_LIGHTS lights), below nee_accum_limit frames averaged."""
        return (self._fb_dev is not None and self._whole_frame
                and self.scene.lights.count > MAX_LIGHTS
                and 0 < self._nee_samples < self.nee_accum_limit)

    # ---- present ----

    @property
    def framebuffer(self) -> np.ndarray:
        """The frame on the host, [H,W,3] f32: one device-to-host copy when
        the device frame changed since the last read."""
        if self._fb_dev is not None and self._fb_host_dirty:
            flat = self._fb_dev.to("cpu", copy=True).numpy()   # a host array of its own
            self._fb_host = flat if self._fb_rowmajor else self.renderer.to_image(flat)
            self._fb_host_dirty = False
        return self._fb_host

    @property
    def framebuffer_u8(self) -> np.ndarray:
        """The display frame, [H,W,3] u8 (sRGB): a path-traced frame is
        quantised on the device and a quarter of the bytes are read back."""
        return self.materialize_frame(self.present_frame())

    def present_frame(self):
        """The display frame, [H,W,3] u8, without waiting for the device: a
        path-traced frame is quantised on its device, and on a CUDA device
        comes back as a `HostFrame` (its read-back already enqueued; on the
        CPU as the tensor); any other frame as a host array. A presenter
        holds the handle and materialises it a frame later, so the read-back
        of frame N-1 overlaps frame N's work."""
        if self._fb_dev is not None and self._fb_host_dirty and self._fb_rowmajor:
            return self._enqueue_read(quantize_u8(self._fb_dev))
        return to_u8(self.framebuffer)

    def present_frame_packed(self):
        """present_frame at half the bytes: a path-traced frame of even size
        comes back as YUV 4:2:0 u8 [H*3/2, W] (utils/yuv.py; a HostFrame on
        a CUDA device, the tensor on the CPU; `materialize_frame` unpacks
        it); anything else as present_frame."""
        if (self._fb_dev is not None and self._fb_host_dirty and self._fb_rowmajor
                and self._fb_dev.dim() == 3 and self._fb_dev.dtype != torch.uint8
                and self.height % 2 == 0 and self.width % 2 == 0):
            from ..utils.yuv import encode_yuv420

            return self._enqueue_read(encode_yuv420(self._fb_dev))
        return self.present_frame()

    def _enqueue_read(self, frame: torch.Tensor):
        return HostFrame(frame) if frame.is_cuda else frame

    @staticmethod
    def materialize_frame(handle) -> np.ndarray:
        """A present_frame / present_frame_packed handle -> display RGB u8
        [H,W,3] on the host."""
        if isinstance(handle, HostFrame):
            arr = handle.wait()
        else:
            arr = handle.cpu().numpy() if isinstance(handle, torch.Tensor) else np.asarray(handle)
        if arr.ndim == 2:    # packed YUV 4:2:0
            from ..utils.yuv import decode_yuv420

            return decode_yuv420(arr)
        return arr

    def frame(self) -> np.ndarray:
        """One turn of the event loop: compute, then present."""
        self.run_compute()
        self.perf.update_frame_count()
        return self.framebuffer

    def render_to_completion(self, max_frames: int = 100000) -> np.ndarray:
        """Compute every remaining tile, presenting once at the end."""
        while not self.progressive.complete and max_frames > 0:
            self.run_compute()
            self.perf.update_frame_count()
            max_frames -= 1
        return self.framebuffer

    def fly_through(self, script: list[tuple], frames_per_step: int = 1) -> list[np.ndarray]:
        """A scripted fly-through: entries ('key', k) or ('mouse', dx, dy), each
        followed by `frames_per_step` frames -> the framebuffer after each."""
        out = []
        for action in script:
            if action[0] == "key":
                self.handle_key(action[1])
            elif action[0] == "mouse":
                self.handle_mouse_drag(action[1], action[2])
            for _ in range(frames_per_step):
                self.frame()
            out.append(self.framebuffer.copy())
            if self.should_quit:
                break
        return out
