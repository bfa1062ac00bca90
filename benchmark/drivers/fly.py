"""Driver kind `fly`: one user walking through the scene in the Viewer's
path-traced mode (key `p`), a closed loop of one input and one moving frame
at a time, as the `viewer` kind's loop (its inputs, its frame bookkeeping
and its camera replay).

Set-up presses `p` and makes `still_frames` frames with the camera standing
(a full PathTracer.step() and the à-trous preview each), which build the
history, then the warm-up's moving frames. Every frame after is an input and
`run_compute()`: PathTracer.fly_frame(camera, m=interleave,
iterations=denoise_iterations), the temporal warp of the accumulation into
the new view (clamped at 8 samples a pixel), one sample for 1/m of the
pixels, the G-buffer's reorder and the à-trous filter. The frame is left on
the device and is complete at an event recorded after `run_compute()`; one
frame is in flight.

At the frames the check compares, the driver keeps on the device the frame
displayed, the G-buffer (PathTracer.gbuffer()), the pre-filter mean
(PathTracer.image_device()) and the per-pixel sample weights, with nothing
waited for.
"""

from __future__ import annotations

from .. import checks, generator, roofline
from . import viewer
from .common import scene_tables


class Driver(viewer.Driver):

    def __init__(self, config: dict, mix: dict, seed: int, device, spans):
        super().__init__(config, mix, seed, device, spans)
        self.width, self.height = config["pathtracer_size"]

    def _enter_mode(self) -> None:
        v = self.viewer
        v.handle_key("p")
        v.fly_interleave = self.mix["interleave"]
        v.fly_denoise_iters = self.mix["denoise_iterations"]
        for _ in range(self.mix["still_frames"]):
            v.run_compute()

    def _hold(self):
        pt = self.viewer._pt
        normal, depth, albedo = pt.gbuffer()
        weight = pt._n_total()[pt._inv_perm].reshape(self.height, self.width)
        return {"shown": self.viewer._fb_dev, "mean": pt.image_device(), "normal": normal,
                "depth": depth, "albedo": albedo, "weight": weight}

    def outputs(self) -> dict:
        """Frame number -> what was kept of it, [H,W,...] tensors on the
        program's device, which outlive the program's state."""
        return {i: dict(held) for i, held in sorted(self.held.items())}

    # ---- the check, the rooflines and the control ----

    def check(self, outputs: dict, device):
        """The fly frames against the reference (checks.fly_check)."""
        return checks.fly_check(self, outputs, device)

    def least_ms(self, work: dict, tree_bytes: int) -> dict:
        """Least ms a fly frame: the warp's walk, the coset's paths, the filter."""
        mix = self.mix
        depth = self.config["program"]["max_bounce_depth"] + 1
        f = roofline.fly_frame(work["primary"], work["paths"],
                               scene_tables(self.inputs, tree_bytes), self.width * self.height,
                               mix["interleave"], depth, mix["denoise_iterations"])
        return {"fly": f["least_ms"]}

    def control(self, device) -> dict:
        """The reference in bfloat16 in the program's place (checks.fly_control)
        on the frames a window of the mix would compare."""
        mix = self.mix
        frames = sorted(generator.frame_picks(self.seed, mix["warm_frames"],
                                              mix["expected_frames"], mix["check_frames"]))
        return checks.fly_control(self, frames, device)
