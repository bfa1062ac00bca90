"""YUV 4:2:0 present packing (utils/yuv.py) against the JAX package's.

The encode is the same computation: equal bytes. The decode is not: the
JAX package's truncates (`astype(np.uint8)` of the clipped float) where its
encode rounds, darkening every channel by half a count on average (a
reference fault). The port rounds to nearest, so its decode of the same
bytes is the JAX decode or one count above it, never below, and about half
a count above on average."""

import numpy as np
import torch

import jax.numpy as jnp

from gpu_raytracer_tpu.utils.yuv import decode_yuv420 as jax_decode
from gpu_raytracer_tpu.utils.yuv import encode_yuv420 as jax_encode
from gpu_raytracer_tpu_torch.utils.image import linear_to_srgb
from gpu_raytracer_tpu_torch.utils.yuv import decode_yuv420, encode_yuv420


def _image(H=64, W=96, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.0, 1.2, (H, W, 3)) ** 2).astype(np.float32)


def test_encode_matches_jax():
    img = _image()
    got = encode_yuv420(torch.from_numpy(img))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (96, 96)
    assert np.array_equal(got.numpy(), np.asarray(jax_encode(jnp.asarray(img))))


def test_decode_rounds_where_the_reference_truncates():
    packed = np.array(jax_encode(jnp.asarray(_image(seed=1))))
    got = decode_yuv420(packed).astype(int)
    want = jax_decode(packed).astype(int)      # the truncating reference decode
    delta = got - want
    assert delta.min() == 0 and delta.max() == 1   # the declared deviation, and only it
    assert 0.3 < delta.mean() < 0.7
    assert np.array_equal(decode_yuv420(torch.from_numpy(packed)), decode_yuv420(packed))


def test_round_trip_close_on_smooth_content():
    H = W = 64
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    img = 0.2 + 0.6 * np.stack([x / W, y / H, (x + y) / (W + H)], axis=-1)
    rgb = decode_yuv420(encode_yuv420(torch.from_numpy(img.astype(np.float32))))
    want = (linear_to_srgb(torch.from_numpy(img)).numpy() * 255.0 + 0.5).astype(np.uint8)
    err = np.abs(rgb.astype(int) - want.astype(int))
    assert err.mean() < 1.0 and np.percentile(err, 99) <= 4


def test_gray_round_trips_within_a_count():
    img = torch.full((32, 32, 3), 0.5)
    rgb = decode_yuv420(encode_yuv420(img))
    want = round(float(linear_to_srgb(torch.tensor(0.5))) * 255)
    assert np.abs(rgb.astype(int) - want).max() <= 1
