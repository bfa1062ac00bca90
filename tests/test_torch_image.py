"""The port's image and pixel helpers against the JAX package's:
`utils/image.py::srgb_to_linear` and `rmse` to 1e-6, `write_ppm` byte for
byte, `ops/camera_rays.py::pixel_grid` equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import torch_bridge  # noqa: F401  (thread cap)

from gpu_raytracer_tpu.ops.camera_rays import pixel_grid as jax_pixel_grid
from gpu_raytracer_tpu.utils import image as jax_image
from gpu_raytracer_tpu_torch.ops.camera_rays import pixel_grid
from gpu_raytracer_tpu_torch.utils.image import (linear_to_srgb, rmse, srgb_to_linear,
                                                 write_ppm)


def _values(seed=0, n=4096):
    """Encoded values over [-0.1, 1.1] (clipped), with both breakpoints and
    their neighbours."""
    x = np.random.default_rng(seed).uniform(-0.1, 1.1, n).astype(np.float32)
    edges = np.float32([0.0, 0.04045, 0.0031308, 1.0])
    return np.concatenate([x, edges, np.nextafter(edges, np.float32(2)),
                           np.nextafter(edges, np.float32(-1))])


def test_srgb_to_linear_matches_jax():
    x = _values()
    got = srgb_to_linear(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, jax_image.srgb_to_linear(x), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(jax_image.srgb_to_linear(jnp.asarray(x),
                                                                        xp=jnp)),
                               rtol=0, atol=1e-6)
    assert got.dtype == np.float32


def test_srgb_round_trip():
    x = np.linspace(0.0, 1.0, 1001, dtype=np.float32)
    back = srgb_to_linear(linear_to_srgb(torch.from_numpy(x))).numpy()
    np.testing.assert_allclose(back, x, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", [(7, 5, 3), (1, 1, 3), (16, 9, 4)])
def test_rmse_matches_jax(shape):
    rng = np.random.default_rng(len(shape) + shape[0])
    a = rng.normal(size=shape).astype(np.float32)
    b = a + rng.normal(scale=1e-3, size=shape).astype(np.float32)
    got = rmse(a, b)
    assert isinstance(got, float)
    assert abs(got - jax_image.rmse(a, b)) <= 1e-6
    assert rmse(a, a) == 0.0


@pytest.mark.parametrize("srgb", [True, False])
@pytest.mark.parametrize("kind", ["float", "u8"])
def test_write_ppm_bytes_equal_jax(tmp_path, srgb, kind):
    rng = np.random.default_rng(3)
    img = rng.uniform(-0.2, 1.2, (9, 13, 3)).astype(np.float32)
    if kind == "u8":
        img = rng.integers(0, 256, (9, 13, 3)).astype(np.uint8)
    write_ppm(str(tmp_path / "port.ppm"), img, srgb=srgb)
    jax_image.write_ppm(str(tmp_path / "jax.ppm"), img, srgb=srgb)
    got = (tmp_path / "port.ppm").read_bytes()
    assert got == (tmp_path / "jax.ppm").read_bytes()
    assert got.startswith(b"P6\n13 9\n255\n") and len(got) == len(b"P6\n13 9\n255\n") + 9 * 13 * 3


@pytest.mark.parametrize("size", [(1, 1), (7, 3), (64, 48)])
def test_pixel_grid_equals_jax(size):
    W, H = size
    px, py = pixel_grid(W, H)
    jpx, jpy = jax_pixel_grid(W, H)
    assert px.dtype == torch.int32 and px.shape == (W * H,)
    assert np.array_equal(px.numpy(), np.asarray(jpx))
    assert np.array_equal(py.numpy(), np.asarray(jpy))
