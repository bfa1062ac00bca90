"""PathTracer.fly_frame against the JAX package: three moving frames of a
fly-through (warp, one coset step, G-buffer reorder, à-trous, optional u8
encode) on the default scene at 64x64, the first without history.

The warps' history jitter is JAX's array, injected (tests/test_torch_temporal.py).
Tolerance: the f32 frames within 1e-5 on at least 99% of the pixels, the
path tracer tests' bar; the u8 frames equal on at least 99%."""

import numpy as np
import pytest
import torch

import jax
from torch_bridge import port_scene_from_jax

from gpu_raytracer_tpu import build_default_scene as jax_default_scene
from gpu_raytracer_tpu.engine.pathtracer import PathTracer as JaxPathTracer
from gpu_raytracer_tpu.models.camera import CameraController as JaxController
from gpu_raytracer_tpu_torch.engine.pathtracer import PathTracer
from gpu_raytracer_tpu_torch.models.camera import Camera

W = H = 64
TOL = 1e-5
MIN_SHARE = 0.99
KEYS = "dwj"   # strafe right, forward, turn left
HISTORY_STEPS = 3   # full steps after the first frame


def _port_camera(jc):
    return Camera(*(torch.from_numpy(np.array(x)) for x in (jc.position, jc.direction, jc.up,
                                                              jc.fov)))


@pytest.fixture(scope="module", params=[False, True], ids=["f32", "u8"])
def flown(request):
    """Per frame: (port frame, JAX frame), and the two tracers after it.
    The first frame follows a restart (no history), the next two
    HISTORY_STEPS full steps."""
    u8 = request.param
    js = jax_default_scene()
    jp = JaxPathTracer(js, W, H)
    pp = PathTracer(port_scene_from_jax(js), W, H, device="cpu")

    def jitter():
        key = jax.random.fold_in(jax.random.fold_in(jp.key, 0x3A97), pp._warp_no)
        return torch.from_numpy(np.array(jax.random.uniform(key, (W * H, 2))))

    pp._warp_jitter = jitter
    ctrl = JaxController(js.camera)
    frames = []
    for i, k in enumerate(KEYS):
        if k == "d":
            ctrl.move(strafe=1.0)
        elif k == "w":
            ctrl.move(forward=1.0)
        else:
            ctrl.rotate(8.0, 0.0)
        jc = ctrl.camera()
        want = np.asarray(jp.fly_frame(jc, m=4, iterations=4, u8=u8))
        got = pp.fly_frame(_port_camera(jc), m=4, iterations=4, u8=u8)
        frames.append((got, want))
        if i == 0:   # history for the next frames
            for _ in range(HISTORY_STEPS):
                jp.step()
                pp.step()
    return u8, frames, jp, pp


@pytest.mark.parametrize("frame", range(len(KEYS)))
def test_fly_frame_matches_jax(flown, frame):
    u8, frames, _, _ = flown
    got, want = frames[frame]
    assert got.shape == want.shape == (H, W, 3)
    assert got.dtype == (torch.uint8 if u8 else torch.float32)
    diff = np.abs(got.numpy().astype(np.float64) - want.astype(np.float64)).max(axis=2)
    share = (diff <= (0 if u8 else TOL)).mean()
    assert share >= MIN_SHARE, f"{share:.4f} of the pixels (max |diff| {diff.max():.3g})"


def test_fly_state_matches_jax(flown):
    _, _, jp, pp = flown
    assert pp._warp_no == 2 and pp._il_step == jp._il_step and pp._il_phase == jp._il_phase
    assert pp.samples == jp.samples == 0
    assert (pp._count_base.numpy() == np.asarray(jp._count_base)).mean() >= 0.999
    assert pp._gbuf_tile is not None
