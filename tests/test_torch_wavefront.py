"""The port's wavefront path-tracing pieces against the JAX package's on the
CPU: BSDF sampling (ops/sampling.py), the camera pool with jitter, the
coherence sort, and one bounce of the plain version of the bounce kernel
(`ops/wavefront.py::bounce`) against JAX's XLA bounce from the same pool
and the same uniforms.

Tolerances:
  * sampling and camera pools: <= 1e-6;
  * the sort: the same keys and the same stable permutation;
  * one bounce: integer fields and `active` equal, float fields and the
    radiance <= 1e-5, NaN in the same lanes, except on lanes where a
    discrete decision flips on a one-ulp difference (Fresnel `u3 < fres`,
    roulette `u4 <= p`, an absorbed metal lobe, TIR, an exact-t tie):
    counted, at most 1% of the pool, and each shown to be such a lane (its
    outcome in the plain bounce moves when the uniforms, origins or
    directions are nudged by ULPS ulp);
  * against the interpreted TPU kernel: JAX's own bar for it against its
    XLA bounce, 2e-4 (tests/test_pallas_bounce.py)."""

import dataclasses
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from torch_bridge import port_scene_from_jax

from gpu_raytracer_tpu import build_default_scene as jax_default_scene
from gpu_raytracer_tpu.models.geometry import Textures as JaxTextures
from gpu_raytracer_tpu.ops import sampling as jsampling
from gpu_raytracer_tpu.ops import wavefront as jwf
from gpu_raytracer_tpu.ops.pallas.bounce import pallas_bounce
from gpu_raytracer_tpu.utils.procgen import make_courtyard_scene as jax_courtyard
from gpu_raytracer_tpu_torch.ops import sampling, wavefront
from gpu_raytracer_tpu_torch.ops.pool import bounce_flags
from gpu_raytracer_tpu_torch.ops.cuda.bounce import (fused_bounce, fused_bounce_,
                                                     pack_bounce_tables)

W = H = 32
TOL = 1e-5
MAX_COUNTED_SHARE = 0.01
KERNEL_TOL = 2e-4
ULPS = 4   # the input nudge that moves the outcome of a rounding-sensitive lane
FIELDS_F = ("origin", "direction", "throughput", "medium_ior")
FIELDS_I = ("wavelength_channel", "ray_type", "bounce_depth", "active")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("fn", ["orthonormal_basis", "cosine_hemisphere", "reflect",
                                "refract", "schlick_fresnel", "ior_for_channel"])
def test_sampling_matches_jax(fn):
    rng = np.random.default_rng(0)
    n = 4096
    nrm, d = _unit(rng, n), _unit(rng, n)
    nrm[:8] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, 1, 0]] * 2   # ONB branch and axes
    u1, u2 = rng.random(n, dtype=np.float32), rng.random(n, dtype=np.float32)
    eta = rng.uniform(0.5, 1.6, n).astype(np.float32)
    n1, n2 = (rng.uniform(1.0, 2.0, n).astype(np.float32) for _ in range(2))
    chan = rng.integers(0, 4, n).astype(np.int32)
    args = {"orthonormal_basis": (nrm,), "cosine_hemisphere": (nrm, u1, u2),
            "reflect": (d, nrm), "refract": (d, nrm, eta), "schlick_fresnel": (u1, n1, n2),
            "ior_for_channel": (n1, chan)}[fn]
    want = getattr(jsampling, fn)(*(jnp.asarray(a) for a in args))
    got = getattr(sampling, fn)(*(torch.from_numpy(a) for a in args))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        if w.dtype == jnp.bool_:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)


def _pixels():
    py, px = np.mgrid[0:H, 0:W]
    return px.reshape(-1).astype(np.int32), py.reshape(-1).astype(np.int32)


def _jax_pool(js, channel, jitter):
    px, py = _pixels()
    return jwf.camera_wavefront_rays(js.camera, W, H, jnp.asarray(px), jnp.asarray(py), channel,
                                     jitter=jnp.asarray(jitter))


def _to_port(jr) -> wavefront.WavefrontRays:
    return wavefront.WavefrontRays(**{f.name: _t(getattr(jr, f.name)).contiguous()
                                      for f in dataclasses.fields(wavefront.WavefrontRays)})


def test_camera_pool_with_jitter_matches_jax():
    js = jax_default_scene()
    ps = port_scene_from_jax(js)
    jitter = np.random.default_rng(1).random((W * H, 2), dtype=np.float32)
    want = _jax_pool(js, jwf.RGB_CHANNEL, jitter)
    px, py = _pixels()
    got = wavefront.camera_wavefront_rays(ps.camera, W, H, _t(px), _t(py), wavefront.RGB_CHANNEL,
                                          jitter=_t(jitter))
    for f in dataclasses.fields(wavefront.WavefrontRays):
        g, w = getattr(got, f.name).numpy(), np.asarray(getattr(want, f.name))
        assert g.shape == w.shape, f.name
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=f.name)


def test_sort_perm_matches_jax():
    js = jax_courtyard(2000, seed=1)
    ps = port_scene_from_jax(js)
    rng = np.random.default_rng(2)
    n = 8192
    lo, hi = np.asarray(js.bvh.node_min[0]), np.asarray(js.bvh.node_max[0])
    o = rng.uniform(lo - 1.0, hi + 1.0, (n, 3)).astype(np.float32)
    o[:64] = o[64:128]                      # equal keys: the sort must be stable
    d = _unit(rng, n)
    d[:16, 0] = 0.0                          # direction components on the octant edge
    active = rng.random(n) < 0.7
    want = np.asarray(jwf._sort_perm(js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(active)))
    got = wavefront._sort_perm(ps, _t(o), _t(d), _t(active)).numpy()
    np.testing.assert_array_equal(got, want)


def _synthetic_textured(mips):
    """The JAX texture-shade test scene (tests/test_texshade.py) with mip
    pyramids: live spheres (glass, metal), every map slot and wrap mode."""
    from test_texshade import _textured_scene

    js = _textured_scene(np.random.default_rng(0))
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, size=(5 + 3 * i, 9 + 11 * i, 4), dtype=np.uint8)
            for i in range(3)]
    return dataclasses.replace(js, textures=JaxTextures.from_images(imgs, wrap=[0, 1, 2],
                                                                    mips=mips))


SCENES = {"default": jax_default_scene,
          "courtyard2000": lambda: jax_courtyard(2000, seed=1),   # two lights: sampled NEE
          "textured": lambda: _synthetic_textured(4)}


@pytest.fixture(scope="module")
def bounce_setup():
    """Per scene: the JAX scene, the port's bounce tables, and the pools at
    depth 0 (camera) and depth 1 (after one JAX bounce), jittered."""
    out = {}
    rng = np.random.default_rng(3)
    for name, make in SCENES.items():
        js = make()
        jitter = rng.random((W * H, 2), dtype=np.float32)
        pool0 = _jax_pool(js, jwf.RGB_CHANNEL, jitter)
        u0 = rng.random((W * H, 7), dtype=np.float32)
        pool1 = _jax_bounce(js, pool0, u0, shadows=True, rr=False, light_sample=True,
                            lod_bias=0.0)[0]
        out[name] = (js, pack_bounce_tables(port_scene_from_jax(js)), pool0, pool1)
    return out


def _jax_bounce(js, pool, u, shadows, rr, light_sample, lod_bias):
    """JAX's XLA bounce, op by op (under jit, XLA:CPU would contract
    multiply-adds into FMAs, which the port and the CUDA kernels do not)."""
    return jwf.xla_bounce(js, pool, jnp.asarray(u), shadows=shadows, rr_enabled=rr,
                          rr_now=jnp.bool_(rr), leaf_size=8, use_bvh=js.bvh.num_nodes > 1,
                          light_sample=light_sample and js.lights.count > 1,
                          tex_lod_bias=lod_bias)


CASES = {
    "spectral_depth0": dict(depth=0),
    "spectral_depth1_rr": dict(depth=1, rr=True),
    "channel1": dict(depth=1, channel=1),
    "no_shadows": dict(depth=1, shadows=False),
    "every_light": dict(depth=1, light_sample=False),
    "last": dict(depth=1, last=True),
    "dead_second_half": dict(depth=1, rr=True, dead_half=True),
    "lod_bias": dict(depth=1, lod_bias=1.0),
}


def _compare_pools(got, grad, want, wrad, lanes):
    """-> lanes that differ beyond TOL or in an integer field (each such
    lane a flipped discrete decision); fails on NaN lanes that differ."""
    bad = np.zeros(lanes, bool)
    for name in FIELDS_I:
        bad |= getattr(got, name).numpy() != np.asarray(getattr(want, name))
    pairs = [(getattr(got, n).numpy(), np.asarray(getattr(want, n))) for n in FIELDS_F]
    for g, w in pairs + [(grad.numpy(), np.asarray(wrad))]:
        assert np.array_equal(np.isnan(g), np.isnan(w))
        d = np.nan_to_num(np.abs(g - w), nan=0.0)
        bad |= (d.reshape(lanes, -1) > TOL).any(axis=1)
    return bad


def _rounding_sensitive(tables, r, u, kw, got, grad):
    """Lanes whose outcome in the plain bounce (`got`, `grad`) flips an
    integer field or moves beyond TOL when the uniforms, the origins or the
    directions are scaled by 1 +- ULPS ulp: some discrete decision of theirs
    (Fresnel, roulette, an absorbed metal lobe, TIR, the closer of two
    triangles at one t) sits that close to its threshold."""
    eps = ULPS * float(np.finfo(np.float32).eps)
    out = np.zeros(r.count, bool)
    for k in (1.0 + eps, 1.0 - eps):
        for r2, u2 in ((r, u * k), (r.replace(origin=r.origin * k), u),
                       (r.replace(direction=r.direction * k), u)):
            g2, rad2 = wavefront.bounce(tables.scene, r2, u2, **kw)
            out |= _compare_pools(g2, rad2, got, grad, r.count)
    return out


@pytest.mark.parametrize("scene, case", [(s, c) for s in sorted(SCENES) for c in sorted(CASES)
                                         if s == "textured" or not CASES[c].get("lod_bias")])
def test_bounce_matches_jax_xla_bounce(bounce_setup, scene, case):
    """(The LOD bias case runs on the mip-mapped textured scene only.)"""
    c = CASES[case]
    js, tables, pool0, pool1 = bounce_setup[scene]
    pool = pool1 if c["depth"] else pool0
    if "channel" in c:
        pool = dataclasses.replace(pool, wavelength_channel=jnp.full_like(
            pool.wavelength_channel, c["channel"]))
    if c.get("dead_half"):
        pool = dataclasses.replace(pool, active=pool.active.at[W * H // 2:].set(False))
    u = np.random.default_rng(4).random((W * H, 7), dtype=np.float32)
    shadows, rr = c.get("shadows", True), c.get("rr", False)
    light_sample, bias = c.get("light_sample", True), c.get("lod_bias", 0.0)
    want, wrad = _jax_bounce(js, pool, u, shadows=shadows, rr=rr, light_sample=light_sample,
                             lod_bias=bias)
    r = _to_port(pool)
    kw = dict(shadows=shadows, do_rr=rr, light_sample=light_sample, tex_lod=bias * c["depth"],
              last=c.get("last", False))
    got, grad = fused_bounce(tables, r, _t(u), **kw)
    if c.get("last"):   # the last depth retires every lane and keeps its state
        assert not got.active.any()
        for name in FIELDS_F + FIELDS_I[:3]:
            assert torch.equal(getattr(got, name), getattr(r, name)), name
        want = dataclasses.replace(pool, active=jnp.zeros_like(pool.active))
    bad = _compare_pools(got, grad, want, wrad, W * H)
    assert bad.sum() <= MAX_COUNTED_SHARE * W * H, f"{bad.sum()} lanes differ"
    if bad.any():
        unexplained = bad & ~_rounding_sensitive(tables, r, _t(u), kw, got, grad)
        assert not unexplained.any(), (
            f"lanes {np.nonzero(unexplained)[0].tolist()} differ from JAX, and no decision "
            f"of theirs is within {ULPS} ulp of its threshold")
    if c.get("dead_half"):
        dead = slice(W * H // 2, None)
        assert not got.active[dead].any() and not grad[dead].any()
        assert torch.equal(got.origin[dead], r.origin[dead])
    live = int(r.active.sum())
    assert live > 0 and (grad.abs().sum(dim=1) > 0).sum() > 0


def test_rounding_sensitive_lanes_are_found(bounce_setup):
    """The check that explains counted lanes finds a decision put on its
    threshold: with throughput 2 and u4 = 0.95, the upper clamp of the
    survival probability, roulette keeps exactly the lanes whose probability
    is clamped to 0.95, and a nudge of u4 by ULPS ulp retires each of them."""
    _, tables, _, pool = bounce_setup["default"]
    r = _to_port(pool)
    r = r.replace(throughput=torch.full_like(r.throughput, 2.0))
    u = _t(np.random.default_rng(6).random((W * H, 7), dtype=np.float32))
    u[:, 4] = 0.95
    kw = dict(shadows=True, do_rr=True)
    got, grad = wavefront.bounce(tables.scene, r, u, **kw)
    sensitive = _rounding_sensitive(tables, r, u, kw, got, grad)
    survivors = got.active.numpy()
    assert survivors.sum() > 0
    assert not (survivors & ~sensitive).any()
    assert (sensitive & ~survivors).sum() <= MAX_COUNTED_SHARE * W * H


def test_bounce_matches_the_interpreted_tpu_kernel(bounce_setup):
    """The plain bounce against the Pallas bounce kernel run by the
    interpreter, from the depth-1 pool of the default scene (glass, metal
    and live spheres), at JAX's own bar for that kernel."""
    js, tables, _, pool = bounce_setup["default"]
    u = np.random.default_rng(5).random((W * H, 7), dtype=np.float32)
    o, d, thr, med, chan, rt, bd, act, rad = pallas_bounce(
        js, pool.origin, pool.direction, pool.throughput, pool.medium_ior,
        pool.wavelength_channel, pool.ray_type, pool.bounce_depth, pool.active,
        jnp.asarray(u), shadows=True, do_rr=True, packet_size=1024, interpret=True)
    got, grad = wavefront.bounce(tables.scene, _to_port(pool), _t(u), shadows=True, do_rr=True)
    np.testing.assert_array_equal(got.active.numpy(), np.asarray(act))
    for name, want in (("wavelength_channel", chan), ("ray_type", rt), ("bounce_depth", bd)):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(want), name)
    for name, want in (("origin", o), ("direction", d), ("throughput", thr),
                       ("medium_ior", med)):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(want),
                                   atol=KERNEL_TOL, err_msg=name)
    np.testing.assert_allclose(grad.numpy(), np.asarray(rad), atol=KERNEL_TOL)


def test_single_bounce_matches_jax():
    js = jax_default_scene()
    ps = port_scene_from_jax(js)
    px, py = _pixels()
    want = jwf.wavefront_single_bounce(js, jnp.asarray(px), jnp.asarray(py), W, H, channel=2)
    got = wavefront.wavefront_single_bounce(ps, _t(px), _t(py), W, H, channel=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


# ---- the in-place bounce (the bounce kernel's own contract) ----

def _gather_pool(r, perm):
    """The pool moved into `perm` order, one gather per field."""
    return r.replace(**{name: getattr(r, name)[perm] for name in
                        ("origin", "direction", "ray_type", "bounce_depth", "throughput",
                         "medium_ior", "pixel", "wavelength_channel", "active")})


@pytest.mark.parametrize("ordered", [False, True], ids=["lane_order", "coherence_order"])
@pytest.mark.parametrize("sampler", ["qmc", "rng"])
@pytest.mark.parametrize("scene", ["courtyard2000", "textured"])
def test_in_place_bounce_equals_move_bounce_scatter(bounce_setup, scene, sampler, ordered):
    """`bounce_` (the pool and the radiance updated in place, the live lanes
    visited through an order) against the path it replaces: move the pool
    into the order, draw the uniforms at the moved positions, `bounce`,
    add the radiance, scatter everything back. Lane for lane, bit for bit,
    with dead lanes in the pool, QMC and independent uniforms."""
    from gpu_raytracer_tpu_torch.ops.sampler import QmcStream

    _, tables, _, pool = bounce_setup[scene]
    r = _to_port(pool)
    r.active[::5] = False
    N, depth = r.count, 1
    kw = dict(shadows=True, do_rr=True, light_sample=True, tex_lod=0.5)
    stream = QmcStream(pid_base=11, sample_base=3, seed=2**31 + 9, spp=2)
    u_rng = _t(np.random.default_rng(8).random((N, 7), dtype=np.float32))
    rad0 = _t(np.random.default_rng(9).random((N, 3), dtype=np.float32))
    perm = (wavefront._sort_perm(tables.scene, r.origin, r.direction, r.active) if ordered
            else torch.arange(N))
    # the replaced path
    moved = _gather_pool(r, perm)
    u = (wavefront.pool_uniforms(stream, depth, perm, N) if sampler == "qmc" else u_rng)
    new, rad = wavefront.bounce(tables.scene, moved, u, **kw)
    want_rad = torch.empty_like(rad0)
    want_rad[perm] = rad0[perm] + rad
    want = {}
    for f in dataclasses.fields(wavefront.WavefrontRays):
        back = torch.empty_like(getattr(new, f.name))
        back[perm] = getattr(new, f.name)
        want[f.name] = back
    # in place
    got, grad = r.clone(), rad0.clone()
    out = fused_bounce_(tables, got, grad, depth=depth,
                        order=perm.to(torch.int32) if ordered else None,
                        n_live=r.active.sum() if ordered else None,
                        u=None if sampler == "qmc" else u_rng,
                        qmc=stream if sampler == "qmc" else None, **kw)
    assert out is None
    bits = lambda x: x.view(torch.int32) if x.dtype == torch.float32 else x
    for name, w in want.items():
        assert torch.equal(bits(getattr(got, name)), bits(w)), name
    assert torch.equal(bits(grad), bits(want_rad))
    dead = ~r.active
    assert torch.equal(grad[dead], rad0[dead]) and torch.equal(got.origin[dead], r.origin[dead])
    assert got.active.any() and (grad != rad0).any()


def test_in_place_bounce_leaves_lanes_past_n_live_alone(bounce_setup):
    """Only the first n_live positions of the order are worked on: a live
    lane past them keeps its state, its flag and its radiance."""
    from gpu_raytracer_tpu_torch.ops.sampler import QmcStream

    _, tables, _, pool = bounce_setup["courtyard2000"]
    r = _to_port(pool)
    N = r.count
    order = wavefront.coherence_order(tables.scene, r)
    assert order.dtype == torch.int32 and sorted(order.tolist()) == list(range(N))
    live = int(r.active.sum())
    assert r.active[order[:live].long()].all() and not r.active[order[live:].long()].any()
    half = live // 2
    got, rad = r.clone(), torch.zeros((N, 3))
    fused_bounce_(tables, got, rad, depth=1, order=order, n_live=torch.tensor(half),
                  qmc=QmcStream(), shadows=True, do_rr=False)
    skipped = order[half:].long()
    for f in dataclasses.fields(wavefront.WavefrontRays):
        assert torch.equal(getattr(got, f.name)[skipped], getattr(r, f.name)[skipped]), f.name
    assert not rad[skipped].any() and rad[order[:half].long()].any()
    with pytest.raises(ValueError, match="uniforms"):
        fused_bounce_(tables, got, rad, shadows=True, do_rr=False)


def test_coherence_order_composes_like_moving_the_pool(bounce_setup):
    """An order made from the previous depth's order keeps equal keys in
    that order: the permutation that sorting the moved pool would give."""
    _, tables, pool0, pool1 = bounce_setup["courtyard2000"]
    r0, r1 = _to_port(pool0), _to_port(pool1)
    first = wavefront.coherence_order(tables.scene, r0)
    moved = _gather_pool(r1, first.long())
    perm = wavefront._sort_perm(tables.scene, moved.origin, moved.direction, moved.active)
    want = first[perm]
    got = wavefront.coherence_order(tables.scene, r1, first)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert not torch.equal(got, wavefront.coherence_order(tables.scene, r1))   # ties differ


@pytest.mark.parametrize("scene", ["courtyard2000", "textured"])
def test_pool_after_each_depth_matches_jax(scene):
    """The path tracer's loop, depth by depth, against the JAX package's
    (its `_sort_perm`, `_permute_pool`, `_pool_uniforms` and XLA bounce, op
    by op): before each depth the port takes JAX's pool in lane order, runs
    its own count, coherence order and in-place bounce with the QMC numbers
    of each lane's identity, and must give JAX's pool and radiance after
    that depth, at `test_bounce_matches_jax_xla_bounce`'s tolerances."""
    from gpu_raytracer_tpu_torch.ops.sampler import QmcStream

    js = SCENES[scene]()
    tables = pack_bounce_tables(port_scene_from_jax(js))
    N = W * H
    bias = 0.5 if scene == "textured" else 0.0
    jitter = np.random.default_rng(21).random((N, 2), dtype=np.float32)
    jr = _jax_pool(js, jwf.RGB_CHANNEL, jitter)
    jrad = jnp.zeros((N, 3), jnp.float32)
    jlane = jnp.arange(N, dtype=jnp.int32)
    stream = QmcStream(pid_base=5, sample_base=2, seed=77, spp=1)
    max_depth, rr_start = 3, 2
    order = None
    for depth in range(max_depth + 1):
        inv = np.argsort(np.asarray(jlane))
        unscr = lambda a: np.asarray(a)[inv]
        r = wavefront.WavefrontRays(**{f.name: _t(unscr(getattr(jr, f.name))).contiguous()
                                       for f in dataclasses.fields(wavefront.WavefrontRays)})
        rad = _t(unscr(jrad)).contiguous()
        # JAX: sort, permute, uniforms by identity, bounce
        perm = jwf._sort_perm(js, jr.origin, jr.direction, jr.active)
        jr, jrad, jlane = jwf._permute_pool(jr, jrad, jlane, perm)
        ju = jwf._pool_uniforms(None, depth, N, jlane, True, stream.pid_base,
                                stream.sample_base, np.uint32(stream.seed), 1)
        rr = depth + 1 >= rr_start
        jr, jr_rad = _jax_bounce(js, jr, np.asarray(ju), shadows=True, rr=rr,
                                 light_sample=True, lod_bias=bias)
        jrad = jrad + jr_rad
        # the port, in place from the same pool
        n_live = r.active.sum()
        flags = bounce_flags(tables.scene, depth, max_depth + 1, rr_start, True, bias)
        if depth > 0:   # (JAX also sorts at depth 0, so equal keys may sit in another order)
            order = wavefront.coherence_order(tables.scene, r, order)
            assert sorted(order[: int(n_live)].tolist()) == torch.nonzero(r.active)[:, 0].tolist()
        fused_bounce_(tables, r, rad, depth=depth, order=order,
                      n_live=n_live if depth > 0 else None, qmc=stream, **flags)
        inv = np.argsort(np.asarray(jlane))
        want = dataclasses.replace(jr, **{f.name: jnp.asarray(np.asarray(getattr(jr, f.name))[inv])
                                          for f in dataclasses.fields(wavefront.WavefrontRays)})
        bad = _compare_pools(r, rad, want, np.asarray(jrad)[inv], N)
        assert bad.sum() <= MAX_COUNTED_SHARE * N, f"depth {depth}: {bad.sum()} lanes differ"
        assert int(n_live) > 0
