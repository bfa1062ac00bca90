"""Driver kind `pathtracer`: the camera stands still and the program's
`PathTracer.step()` repeats, one sample per pixel a step, accumulated with
no reset: a user waiting for a converged image. Before step N + 1 is
enqueued the host waits for step N - 1; the window closes with a
synchronise."""

from __future__ import annotations

import contextlib

import torch

from .. import checks, generator, reference, roofline
from .common import make_inputs, now, program_config, program_scene, scene_tables


class Driver:
    unit = "step"

    def __init__(self, config: dict, mix: dict, seed: int, device, spans):
        self.config, self.mix, self.seed, self.device, self.spans = config, mix, seed, device, spans
        self.width, self.height = config["pathtracer_size"]
        self.cuda = device.type == "cuda"
        self.label = None            # torch.profiler.record_function in a profiled burst
        self.steps_called = 0        # PathTracer.step() calls: warm-up, window and burst

    def plan(self) -> None:
        """The run's inputs from the seed, without the program."""
        self.inputs = make_inputs(self.config, self.seed)

    def setup(self) -> dict:
        self.plan()
        t0 = now()
        rt = program_config(self.config)
        scene = program_scene(self.inputs, rt, "cpu",
                              self.config["scene"].get("atlas_budget_rows"))
        build_s = now() - t0
        from gpu_raytracer_tpu_torch.engine.pathtracer import PathTracer

        pt = self.config["pathtracer"]
        self.tracer = PathTracer(scene, self.width, self.height, config=rt,
                                 spectral=pt["spectral"], shadows=self.config["shadows"],
                                 antialias=True, seed=0, sampler=pt["sampler"],
                                 device=self.device)
        for _ in range(self.mix["warm_steps"]):
            self.tracer.step()
            self.steps_called += 1
        self._sync()
        return {"scene_build_s": build_s}

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def _span(self, name: str):
        return self.label(name) if self.label is not None else contextlib.nullcontext()

    def run(self, seconds: float | None = None, count: int | None = None) -> dict:
        """Steps for `seconds` (or `count` steps), then a synchronise."""
        self._sync()
        t_start = now()
        deadline = t_start + (seconds or 0.0)
        # a ring of three events: step N's is recorded over step N - 3's,
        # which was waited for before step N - 1 was enqueued
        ring = [torch.cuda.Event() for _ in range(3)] if self.cuda else None
        n = 0
        while True:
            if self.cuda and n >= 2:
                with self._span("wait_step_before_last"):
                    ring[(n - 2) % 3].synchronize()     # step N - 1 done before N + 1
            t0 = now()
            with self._span("step"):
                self.tracer.step()
            self.steps_called += 1
            self.spans.add("host_enqueue", now() - t0)
            if self.cuda:
                ring[n % 3].record()
            n += 1
            if (now() >= deadline if count is None else n >= count):
                break
        self._sync()
        t_end = now()
        self.window = dict(steps=n, seconds=t_end - t_start)
        return {"step_ms": (t_end - t_start) * 1e3 / n, "attempted": n, "failed": 0}

    def outputs(self):
        """The accumulated image, [H,W,3] f32 on the host."""
        return self.tracer.image()

    def release(self) -> None:
        self.tracer = None

    def camera(self) -> reference.CameraState:
        return reference.start_camera(self.inputs.camera_position,
                                      self.inputs.camera_direction, self.inputs.fov)

    # ---- the check, the rooflines and the control ----

    def check(self, image, device):
        """The accumulated image against the reference's estimate (checks.py)."""
        return checks.pathtracer_check(self, image, device)

    def least_ms(self, work: dict, tree_bytes: int) -> dict:
        """Least ms a step: K6 at every depth."""
        tables = scene_tables(self.inputs, tree_bytes)
        depth = self.config["program"]["max_bounce_depth"] + 1
        return {"k6": roofline.path_step(work, tables, self.width * self.height,
                                         depth)["least_ms"]}

    def control(self, device) -> dict:
        """The reference's estimate in bfloat16 in the program's place, with
        random numbers of its own, against the float32 reference's."""
        ref, var, _, _ = checks.image_reference(self, checks.scene_for(self, device), self.seed,
                                                device)
        ctl, _, _, _ = checks.image_reference(self, checks.scene_for(self, device, torch.bfloat16),
                                              self.seed, device, stream=generator.CONTROL)
        return checks.compare_images(ctl, self.mix["check_spp"], ref, var, self.mix)
