"""The port's texture atlas, textured scene build and sampler against the JAX
package's.

Both build from the same seeds: the atlas, the per-slot uvs and the uv
density code must agree bit for bit (the density decides the mip level of
every hit). The sampler is held to <= 1e-6 against the JAX sampler evaluated
op by op (`jax.disable_jit`). Compiled by XLA:CPU, the JAX sampler's
128-lane one-hot weighted sum loses a few more bits (up to 1.7e-6 from a
float64 evaluation on these inputs, where the port stays within 2 ulps), so
against the compiled function the bound is JIT_TOL."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from torch_bridge import assert_arrays_equal, jax_scene_arrays, port_scene_from_jax, scene_to_arrays

from torch_scenes import synthetic_textured_scene
from gpu_raytracer_tpu.config import RaytracerConfig as JaxConfig
from gpu_raytracer_tpu.models.geometry import Textures as JaxTextures
from gpu_raytracer_tpu.ops import texture as jax_texture
from gpu_raytracer_tpu.ops.pallas.traverse import uv_density_code as jax_uv_density_code
from gpu_raytracer_tpu.ops.trace import _mt_bary as jax_mt_bary
from gpu_raytracer_tpu.utils import procgen as jax_procgen
from gpu_raytracer_tpu_torch.config import RaytracerConfig
from gpu_raytracer_tpu_torch.models.geometry import JAX_ATLAS_BUDGET_ROWS, Textures
from gpu_raytracer_tpu_torch.ops import texture
from gpu_raytracer_tpu_torch.ops.trace import mt_bary
from gpu_raytracer_tpu_torch.utils import procgen

TOL = 1e-6
JIT_TOL = 4e-6


def _textures_equal(port: Textures, jax_tex) -> None:
    for f in dataclasses.fields(Textures):
        a, b = getattr(port, f.name), getattr(jax_tex, f.name)
        if f.name == "n_levels":
            assert a == b
        else:
            assert np.array_equal(a.numpy(), np.asarray(b).astype(np.int64)), f.name


def test_textured_scene_keeps_8_slot_leaves_with_wide_leaf_config():
    """A textured scene asked for 12-triangle leaves keeps the 8-slot leaf
    rows the JAX package packs uvs into, so both build the same BVH and leaf
    order (12-slot rows are for untextured scenes only)."""
    js = jax_procgen.make_courtyard_scene(2000, seed=1, textured=True,
                                          config=JaxConfig(bvh_leaf_size=12))
    ps = procgen.make_courtyard_scene(2000, seed=1, textured=True,
                                      config=RaytracerConfig(bvh_leaf_size=12))
    assert ps.bvh.leaf_align == 8 and js.bvh.leaf_align == 8
    assert_arrays_equal(jax_scene_arrays(js), scene_to_arrays(ps))
    untextured = procgen.make_courtyard_scene(2000, seed=1,
                                              config=RaytracerConfig(bvh_leaf_size=12))
    assert untextured.bvh.leaf_align == 12


@pytest.mark.parametrize("texture_size", [128, 1024])
def test_textured_courtyard_bit_equal(texture_size):
    """Every table, the atlas included, bit for bit; at 1024 texels the JAX
    package's atlas budget drops the finest levels of the largest maps."""
    js = jax_procgen.make_courtyard_scene(2000, seed=1, textured=True,
                                          texture_size=texture_size)
    ps = procgen.make_courtyard_scene(2000, seed=1, textured=True, texture_size=texture_size)
    assert_arrays_equal(jax_scene_arrays(js), scene_to_arrays(ps))
    assert ps.textures.textured and ps.materials.present_slots == (0,)
    levels = ps.textures.levels.tolist()
    if texture_size == 1024:
        assert ps.textures.num_rows <= JAX_ATLAS_BUDGET_ROWS and min(levels) < 8
    else:
        assert levels == [8, 8, 8]
    want = np.asarray(jax_uv_density_code(js.tri_e1, js.tri_e2, js.tri_uv))
    assert np.array_equal(ps.tri_den.numpy(), want) and (want > 0).sum() > 1000
    carried = port_scene_from_jax(js)
    assert_arrays_equal(scene_to_arrays(carried), scene_to_arrays(ps))
    assert torch.equal(carried.tri_den, ps.tri_den)


def test_synthetic_textured_scene_bit_equal():
    """tests/torch_scenes.py's synthetic scene (all wrap modes and map slots) is,
    draw for draw, the JAX package's texture-shade test scene."""
    from test_texshade import _textured_scene

    js = _textured_scene(np.random.default_rng(0))
    ps = synthetic_textured_scene(0)
    assert_arrays_equal(jax_scene_arrays(js), scene_to_arrays(ps))
    assert ps.materials.present_slots == (0, 1, 3, 4)


@pytest.mark.parametrize("mips,budget", [(1, None), (4, None), (8, 40)])
def test_atlas_from_images_bit_equal(mips, budget):
    rng = np.random.default_rng(mips)
    imgs = [rng.integers(0, 256, size=(h, w, 4), dtype=np.uint8)
            for h, w in ((7, 300), (33, 9), (1, 1))]
    wrap = [2, 0, 1]
    _textures_equal(Textures.from_images(imgs, wrap=wrap, mips=mips, budget_rows=budget),
                    JaxTextures.from_images(imgs, wrap=wrap, mips=mips, budget_rows=budget))


@pytest.fixture(scope="module")
def atlas_pair():
    """Three random textures with mip chains (one 300 texels wide, so rows
    span several 127-texel chunks), per wrap mode, in both packages."""
    rng = np.random.default_rng(11)
    imgs = [rng.integers(0, 256, size=(h, w, 4), dtype=np.uint8)
            for h, w in ((24, 300), (13, 40), (64, 64))]
    out = {}
    for wrap in (0, 1, 2):
        out[wrap] = (Textures.from_images(imgs, wrap=[wrap] * 3, mips=5),
                     JaxTextures.from_images(imgs, wrap=[wrap] * 3, mips=5))
    return out


def _sample_inputs(n=4096, seed=5):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 3, n).astype(np.uint32)
    idx[rng.random(n) < 0.1] = 0xFFFFFFFF
    uv = rng.uniform(-1.5, 2.5, (n, 2)).astype(np.float32)
    lam = np.exp2(rng.uniform(-12.0, 0.0, n)).astype(np.float32)
    lod = rng.uniform(-0.5, 6.0, n).astype(np.float32)
    return idx, uv, lam, lod


@pytest.mark.parametrize("filtering", ["nearest", "bilinear", "nearest_mip", "trilinear", "lod"])
@pytest.mark.parametrize("wrap", [0, 1, 2])
def test_sample_texture_matches_jax(atlas_pair, wrap, filtering):
    port_tex, jax_tex = atlas_pair[wrap]
    idx, uv, lam, lod = _sample_inputs()
    kw = dict(nearest=dict(bilinear=False), bilinear={}, nearest_mip=dict(lam=lam),
              trilinear=dict(lam=lam, trilinear=True), lod=dict(lod=np.floor(lod)))[filtering]
    jax_sample = lambda: np.asarray(jax_texture.sample_texture(
        jax_tex, jnp.asarray(idx), jnp.asarray(uv),
        **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}))
    with jax.disable_jit():
        want = jax_sample()
    got = texture.sample_texture(
        port_tex, torch.from_numpy(idx.astype(np.int64)), torch.from_numpy(uv),
        **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()})
    assert got.shape == (uv.shape[0], 4) and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= TOL
    assert np.abs(got.numpy() - jax_sample()).max() <= JIT_TOL
    assert (got.numpy()[idx == 0xFFFFFFFF] == 1.0).all()


def test_mip_level_selection_matches_jax(atlas_pair):
    port_tex, jax_tex = atlas_pair[0]
    idx, _, lam, _ = _sample_inputs()
    safe = np.minimum(idx, 2)
    got = texture.mip_level_params(port_tex, torch.from_numpy(safe.astype(np.int64)),
                                   torch.from_numpy(lam))
    want = jax_texture.mip_level_params(jax_tex, jnp.asarray(safe), jnp.asarray(lam))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    got = texture.mip_lod_frac(port_tex, torch.from_numpy(safe.astype(np.int64)),
                               torch.from_numpy(lam))
    want = jax_texture.mip_lod_frac(jax_tex, jnp.asarray(safe), jnp.asarray(lam))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_density_code_roundtrip_matches_jax():
    from gpu_raytracer_tpu.ops.pallas.traverse import den_decode as jax_den_decode

    rng = np.random.default_rng(3)
    e1 = rng.normal(size=(512, 3)).astype(np.float32)
    e2 = rng.normal(size=(512, 3)).astype(np.float32)
    uv = rng.uniform(-4, 4, (512, 3, 2)).astype(np.float32)
    e2[:8] = 0.0          # degenerate geometry
    uv[8:16] = uv[8:16, :1]   # degenerate uvs
    code = texture.uv_density_code(*(torch.from_numpy(a) for a in (e1, e2, uv)))
    want = np.asarray(jax_uv_density_code(jnp.asarray(e1), jnp.asarray(e2), jnp.asarray(uv)))
    assert np.array_equal(code.numpy(), want) and (want[8:16] == 0).all()
    assert np.array_equal(texture.den_decode(code).numpy().view(np.uint32),
                          np.asarray(jax_den_decode(jnp.asarray(want))).view(np.uint32))


def test_uv_helpers_match_jax():
    rng = np.random.default_rng(4)
    n = 256
    tri_uv = rng.uniform(-2, 2, (16, 3, 2)).astype(np.float32)
    ti = rng.integers(0, 16, n)
    bu = rng.uniform(0, 0.5, n).astype(np.float32)
    bv = rng.uniform(0, 0.5, n).astype(np.float32)
    got = texture.interpolate_uv(torch.from_numpy(tri_uv), torch.from_numpy(ti),
                                 torch.from_numpy(bu), torch.from_numpy(bv))
    want = jax_texture.interpolate_uv(jnp.asarray(tri_uv), jnp.asarray(ti), jnp.asarray(bu),
                                      jnp.asarray(bv))
    assert np.abs(got.numpy() - np.asarray(want)).max() <= TOL
    nrm = rng.normal(size=(n, 3))
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)
    nrm[:4] = [[0, 1, 0], [0, -1, 0], [-1, 0, 0], [1, 0, 0]]
    got = texture.sphere_uv(torch.from_numpy(nrm))
    want = jax_texture.sphere_uv(jnp.asarray(nrm))
    assert np.abs(got.numpy() - np.asarray(want)).max() <= TOL
    o = rng.normal(size=(n, 3)).astype(np.float32)
    d, v0, e1, e2 = (rng.normal(size=(n, 3)).astype(np.float32) for _ in range(4))
    got = mt_bary(*(torch.from_numpy(a) for a in (o, d, v0, e1, e2)))
    want = jax_mt_bary(*(jnp.asarray(a) for a in (o, d, v0, e1, e2)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
