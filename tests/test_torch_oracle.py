"""The port's NumPy oracle (gpu_raytracer_tpu_torch/reference/cpu_tracer.py)
against the JAX package's: the scene dict of a scene carried across by the
bridge is the JAX one's, value for value, and the two oracles render the
same dict to the same bits. Then the port's plain frame is held to its own
oracle at the RMSE bound of tests/test_torch_render.py (1e-5)."""

import numpy as np
import pytest

from torch_bridge import port_scene_from_jax

from gpu_raytracer_tpu.models.scene import build_default_scene as jax_default
from gpu_raytracer_tpu.reference import cpu_tracer as jax_oracle
from gpu_raytracer_tpu.utils.procgen import make_courtyard_scene as jax_courtyard
from gpu_raytracer_tpu_torch.engine.renderer import Renderer
from gpu_raytracer_tpu_torch.reference import cpu_tracer as oracle
from gpu_raytracer_tpu_torch.utils.image import rmse

# (scene, frame size): the courtyard's oracle frame costs ~25 ms a pixel
SCENES = {"default": (jax_default, 16), "courtyard300": (lambda: jax_courtyard(300, seed=2), 8)}


@pytest.fixture(scope="module")
def pairs():
    out = {}
    for name, (fn, size) in SCENES.items():
        js = fn()
        out[name] = (js, port_scene_from_jax(js), size)
    return out


def _assert_same(a, b, path="scene"):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        x, y = np.asarray(a), np.asarray(b)
        assert x.shape == y.shape, path
        if x.dtype.kind == "f":
            assert np.array_equal(x.astype(np.float32).view(np.uint32),
                                  y.astype(np.float32).view(np.uint32)), path
        else:
            assert np.array_equal(x.astype(np.int64), y.astype(np.int64)), path
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_scene_dict_matches_jax(pairs, name):
    js, ps, _ = pairs[name]
    _assert_same(oracle.scene_dict_from(ps), jax_oracle.scene_dict_from(js))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_oracle_frame_bit_equal_to_jax(pairs, name):
    js, _, size = pairs[name]
    d = jax_oracle.scene_dict_from(js)
    want = jax_oracle.render(d, size, size)
    got = oracle.render(d, size, size)
    assert got.dtype == np.float32 and got.max() > 0.05
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_plain_frame_matches_the_port_oracle(pairs, name):
    _, ps, size = pairs[name]
    want = oracle.render(oracle.scene_dict_from(ps), size, size)
    got = Renderer(ps, size, size, device="cpu").render()
    err = rmse(got, want)
    assert err <= 1e-5, err
