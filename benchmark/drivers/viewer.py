"""Driver kind `viewer`: one user moving the camera through the program's
`Viewer`, a closed loop of one input and one frame at a time.

Without `present` in the mix a frame is `handle_key` / `handle_mouse_drag`
then `run_compute()`, left on the device, and it is complete when its device
work has finished (an event recorded after it); before frame N + 1 is
enqueued the host waits for frame N - 1, so one frame is in flight. With
`present` the loop is the producer loop of `engine/server.py::ViewerServer`
without HTTP or PNG: `present_frame_packed()` after each frame, then
`materialize_frame` of the previous frame's handle; a frame is complete when
its pixels are on the host, that is when its own handle has been
materialised.
"""

from __future__ import annotations

import collections
import contextlib

import numpy as np
import torch

from .. import checks, generator, reference, roofline
from .common import (make_inputs, now, percentile, program_config, program_scene,
                     scene_tables)


RING = 4


class Driver:
    unit = "frame"

    def __init__(self, config: dict, mix: dict, seed: int, device, spans):
        self.config, self.mix, self.seed, self.device, self.spans = config, mix, seed, device, spans
        self.width, self.height = config["frame_size"]
        self.present = bool(mix.get("present", False))
        self.cuda = device.type == "cuda"
        self.index = 0               # frames made so far, warm-up included
        self.held = {}               # frame number -> its output, for the check
        self.t_in = {}               # frame number -> host time its input was applied
        self.done = {}               # frame number -> host time it completed
        # on CUDA a frame's completion is an event of a ring of RING, read
        # before frame N + 2 is enqueued: few objects made in the window
        self.ring = None
        self.pending = collections.deque()
        self.anchor = None           # (event, host time) that maps events to the host's clock
        self.handle = None           # (frame number, handle) of the last present
        self.label = None            # torch.profiler.record_function in a profiled burst

    # ---- set-up ----

    def plan(self) -> None:
        """The run's inputs from the seed, without the program: the scene's
        arrays and the camera inputs."""
        p = self.config["program"]
        self.inputs = make_inputs(self.config, self.seed)
        self.camera_events = generator.CameraInputs(
            self.seed, self.inputs.camera_position,
            self.inputs.camera_direction, self.inputs.extent, self.mix,
            p["camera_move_speed"], p["camera_rotate_sensitivity"])

    def setup(self) -> dict:
        self.plan()
        t0 = now()
        rt = program_config(self.config)
        scene = program_scene(self.inputs, rt, "cpu",
                              self.config["scene"].get("atlas_budget_rows"))
        build_s = now() - t0
        from gpu_raytracer_tpu_torch.engine.viewer import Viewer

        self.viewer = Viewer(scene, self.width, self.height, config=rt,
                             shadows=self.config["shadows"], verbose=False, device=self.device)
        self._wrap_renderer()
        self._enter_mode()
        if self.cuda:
            self.ring = [torch.cuda.Event(enable_timing=True) for _ in range(RING)]
        # warm-up: the cell's own frames, each held as the check holds its
        # frames, so that the window allocates nothing new
        for _ in range(self.mix["warm_frames"]):
            self._frame(keep=True)
        self._drain()
        self.held.clear()
        self.t_in.clear()
        self.done.clear()
        self.picks = generator.frame_picks(self.seed, self.index, self.mix["expected_frames"],
                                         self.mix["check_frames"])
        return {"scene_build_s": build_s}

    def _wrap_renderer(self):
        """Keep a reference to each frame the Viewer's renderer returns (on
        CUDA it stays on the device), so that a picked frame can be compared
        after the window: no copy and no wait inside it."""
        r = self.viewer.renderer
        inner = r.render_device
        self._last = None

        def render_device():
            self._last = inner()
            return self._last

        r.render_device = render_device

    def _enter_mode(self) -> None:
        """The Viewer's mode for the cell, before the warm-up (a kind that
        draws another mode sets it here): the Whitted frame, as it starts."""

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def _span(self, name: str):
        return self.label(name) if self.label is not None else contextlib.nullcontext()

    # ---- one frame ----

    def _frame(self, keep: bool) -> None:
        i = self.index
        ev = self.camera_events[i]
        t_in = now()
        with self._span("input_and_run_compute"):
            if ev[0] == "drag":
                self.viewer.handle_mouse_drag(ev[1], ev[2])
            else:
                self.viewer.handle_key(ev[1])
            self.viewer.run_compute()
        t_rc = now()
        self.spans.add("host_enqueue", t_rc - t_in)
        self.t_in[i] = t_in
        if keep:
            self.held[i] = self._hold()
        if self.present:
            with self._span("present"):
                h = self.viewer.present_frame_packed()
                prev, self.handle = self.handle, (i, h)
                if prev is not None:
                    self._materialize(*prev)
            self.spans.add("present", now() - t_rc)
        elif self.cuda:
            self.ring[i % RING].record()
            self.pending.append(i)
        else:
            self.done[i] = now()
        self.index += 1

    def _hold(self):
        """What the check keeps of the frame just made: on CUDA the device
        frame itself (nothing copied or waited for), on the CPU the tile
        path's frame; a presented frame is kept when it is materialised."""
        return (None if self.present else self._last if self.cuda
                else self.viewer.framebuffer.copy())

    def _resolve(self, upto: int) -> None:
        """Wait for every pending frame up to `upto` and note when each
        completed, on the host's clock."""
        while self.pending and self.pending[0] <= upto:
            j = self.pending.popleft()
            ev = self.ring[j % RING]
            ev.synchronize()
            if self.anchor is not None:
                self.done[j] = self.anchor[1] + self.anchor[0].elapsed_time(ev) / 1e3

    def _materialize(self, i: int, handle) -> None:
        img = self.viewer.materialize_frame(handle)
        self.done[i] = now()
        if i in self.held:
            self.held[i] = img

    def _drain(self) -> None:
        if self.present and self.handle is not None:
            self._materialize(*self.handle)
            self.handle = None
        self._resolve(self.index)
        self._sync()

    # ---- the window ----

    def run(self, seconds: float | None = None, count: int | None = None) -> dict:
        """Frames for `seconds` (or `count` frames), then the drain ->
        end-to-end numbers."""
        self._sync()
        t_start = now()
        if self.cuda:
            anchor = torch.cuda.Event(enable_timing=True)
            anchor.record()
            anchor.synchronize()
            t_start = now()
            self.anchor = (anchor, t_start)
        deadline = t_start + (seconds or 0.0)
        first = self.index
        while True:
            i = self.index
            if self.pending and self.pending[0] <= i - 2:
                with self._span("wait_frame_before_last"):
                    self._resolve(i - 2)                # frame N - 1 done before N + 1
            self._frame(keep=i in self.picks)
            if (now() >= deadline if count is None else self.index - first >= count):
                break
        last = self.index - 1
        if last not in self.held:                       # the window's last frame is compared too
            self.held[last] = self._hold()
        self._drain()
        t_end = now()
        lat = [self.done[i] - self.t_in[i] for i in range(first, self.index) if i in self.done]
        n = self.index - first
        self.window = dict(frames=n, seconds=t_end - t_start, first=first)
        return {"frame_ms": (t_end - t_start) * 1e3 / n,
                "frame_p95_ms": percentile(lat, 95) * 1e3,
                "attempted": n, "failed": n - len(lat)}

    # ---- after the window ----

    def outputs(self) -> dict:
        """Frame number -> the program's frame as an [H,W,3] host image (f32,
        or u8 for a presented frame). The Viewer's own order
        (`Renderer.to_image`) places a device frame's pixels."""
        out = {}
        for i, val in sorted(self.held.items()):
            if isinstance(val, torch.Tensor):
                val = self.viewer.renderer.to_image(val.cpu().numpy())
            if val is not None:
                out[i] = np.asarray(val)
        return out

    def release(self) -> None:
        """Drop the program's state before the reference runs."""
        self.viewer = None
        self.held.clear()
        self.done.clear()
        self.ring = self.anchor = None
        self._last = None

    def cameras(self, indices) -> dict:
        """The reference's camera of each frame number: the configuration's
        camera, then every input up to that frame."""
        cam = reference.start_camera(self.inputs.camera_position, self.inputs.camera_direction,
                                     self.inputs.fov)
        p = self.config["program"]
        ctl = reference.Controller(cam, p["camera_move_speed"], p["camera_rotate_sensitivity"])
        want = set(indices)
        out = {}
        for k in range(max(want) + 1 if want else 0):
            ctl.apply(self.camera_events[k])
            if k in want:
                out[k] = ctl.state()
        return out

    # ---- the check, the rooflines and the control ----

    def check(self, outputs: dict, device):
        """The frames against the reference's Whitted frames (checks.py)."""
        return checks.viewer_check(self, outputs, device)

    def least_ms(self, work: dict, tree_bytes: int) -> dict:
        """Least ms a frame: K2, or on a textured scene the pre-pass, K3 and K4."""
        tables = scene_tables(self.inputs, tree_bytes)
        pixels, lights = self.width * self.height, len(self.inputs.lights)
        if self.inputs.images:
            return {"k3k4": roofline.textured_frame(work, tables, pixels, lights)["least_ms"]}
        return {"k2": roofline.whitted_frame(work, tables, pixels, lights)["least_ms"]}

    def control(self, device) -> dict:
        """The reference in bfloat16 in the program's place, on the frames a
        window of the mix would compare."""
        mix, seed = self.mix, self.seed
        frames = sorted(generator.frame_picks(seed, mix["warm_frames"], mix["expected_frames"],
                                              mix["check_frames"]))
        ref, _, _ = checks.frame_references(self, checks.scene_for(self, device), frames, seed,
                                            device, self.present)
        ctl, _, _ = checks.frame_references(self, checks.scene_for(self, device, torch.bfloat16),
                                            frames, seed, device, self.present)
        nums = checks.compare_frames(ctl, ref, mix, self.present)
        nums.pop("frames")
        return nums
