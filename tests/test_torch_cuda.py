"""The CUDA kernels against their plain versions, on the card.

Marked `cuda`; they skip on machines without a CUDA device. Run them on a
GPU machine with `python -m pytest -m cuda tests/test_torch_cuda.py`.
Tolerance: bit equality of hit masks and materials, t within 1e-6
relative, RGB within 1e-5, the deferred G-buffer's light sum, uv and mip
footprint equal (chip_smoke.GBUF_TOL), K3's pre-pass bit for bit, the
bounce's integer fields equal and its float fields within 1e-5, except
where two triangles share the exact same t and the two traversal orders
keep different ones (counted, and bounded)."""

import dataclasses
from collections import Counter

import numpy as np
import pytest
import torch

import torch_bridge  # noqa: F401  (thread cap)
from chip_smoke import (bounce_compare, gbuffer_compare, k1_compare, k5_compare,
                        mip_boundary_mask, plain_bounces, pools, primary_compare, primary_ties,
                        seeded_light_u, shade_compare)
from torch_scenes import light_shadow_rays, random_gbuffer, synthetic_textured_scene

from gpu_raytracer_tpu_torch.engine.pathtracer import PathTracer
from gpu_raytracer_tpu_torch.engine.renderer import Renderer, light_uniforms
from gpu_raytracer_tpu_torch.ops.render import (gbuffer_planes, render_chunk, render_deferred_chunk,
                                                render_gbuffer, split_gbuffer)
from gpu_raytracer_tpu_torch.models.camera import CameraController
from gpu_raytracer_tpu_torch.models.scene import build_default_scene
from gpu_raytracer_tpu_torch.ops.camera_rays import generate_rays
from gpu_raytracer_tpu_torch.ops.cuda.build import LAUNCHES
from gpu_raytracer_tpu_torch.ops.cuda.bounce import (fused_bounce, fused_bounce_,
                                                     pack_bounce_tables, qmc_uniforms_kernel)
from gpu_raytracer_tpu_torch.ops.cuda.render import (camera_relative, pack_render_tables,
                                                     render_deferred, render_primary)
from gpu_raytracer_tpu_torch.ops.cuda.texshade import pack_shade_tables, texture_shade
from gpu_raytracer_tpu_torch.ops.cuda.traverse import pack_trace_tables, trace, traverse
from gpu_raytracer_tpu_torch.ops.sampler import QmcStream
from gpu_raytracer_tpu_torch.ops.trace import traverse_triangles
from gpu_raytracer_tpu_torch.ops.wavefront import bounce, coherence_order, pool_uniforms
from gpu_raytracer_tpu_torch.utils.procgen import make_courtyard_scene, make_zoo_scene

SCENES = {"default": build_default_scene,
          "courtyard2000": lambda **kw: make_courtyard_scene(2000, seed=1, **kw)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SCENES))
def test_traverse_kernel_matches_plain(cuda, name):
    scene = SCENES[name](device=cuda)
    tables = pack_trace_tables(scene)
    rng = np.random.default_rng(3)
    n = 8192
    o = torch.from_numpy(rng.uniform(-20, 20, (n, 3)).astype(np.float32)).to(cuda)
    o[: n // 2] = scene.camera.position
    d = rng.normal(size=(n, 3))
    d = torch.from_numpy((d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)).to(cuda)
    far = torch.full((n,), 3.4028234663852886e38, device=cuda)
    ties = k1_compare(tables, o, d, far)[1]
    assert ties.sum().item() <= n * 1e-3
    max_t = torch.from_numpy(rng.uniform(0, 20, n).astype(np.float32)).to(cuda)
    blocked = traverse(tables, o, d, max_t, any_hit=True)[2]
    assert torch.equal(blocked, traverse_triangles(scene, o, d, max_t, any_hit=True)[2])


@pytest.mark.cuda
def test_traverse_kernel_axis_aligned_rays(cuda):
    """Zero direction components give infinite slab distances, and NaN ones
    where the origin lies on a box plane; the kernel rejects those boxes as
    the plain slab test does."""
    scene = make_courtyard_scene(2000, seed=1, device=cuda)
    tables = pack_trace_tables(scene)
    v = scene.tri_v0[: 4096 // 6]          # origins on triangle corners (box planes)
    axes = torch.eye(3, device=cuda)
    o = torch.cat([v + torch.tensor([0.0, 0.5, 0.0], device=cuda)] * 6).contiguous()
    d = torch.cat([axes, -axes]).repeat_interleave(v.shape[0], dim=0).contiguous()
    far = torch.full((o.shape[0],), 3.4028234663852886e38, device=cuda)
    stats, ties = k1_compare(tables, o, d, far)
    assert stats["hits"] > 0 and ties.sum().item() <= o.shape[0] * 1e-3
    max_t = torch.full_like(far, 5.0)
    blocked = traverse(tables, o, d, max_t, any_hit=True)[2]
    assert torch.equal(blocked, traverse_triangles(scene, o, d, max_t, any_hit=True)[2])


@pytest.mark.cuda
@pytest.mark.parametrize("shadows", [False, True])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_render_kernel_matches_plain(cuda, name, shadows):
    scene = SCENES[name](device=cuda)
    W, H = 160, 120
    r = Renderer(scene, W, H, shadows=shadows, sky=(0.1, 0.2, 0.3), device=cuda)
    launches = LAUNCHES["k2"]
    got = r.render_device()
    assert LAUNCHES["k2"] == launches + 1
    want = render_chunk(r.scene, r.px, r.py, W, H, shadows=shadows, sky=(0.1, 0.2, 0.3))
    o, d = generate_rays(r.scene.camera, W, H, r.px, r.py)
    far = torch.full((W * H,), 3.4028234663852886e38, device=cuda)
    ties = k1_compare(r.tables.trace, o.contiguous(), d.contiguous(), far)[1]
    diff = (got - want).abs().amax(dim=1)
    assert diff[~ties].max().item() <= 1e-5
    assert ties.sum().item() <= W * H * 1e-4


TEXTURED = {"courtyard2000": lambda **kw: make_courtyard_scene(2000, seed=1, textured=True, **kw),
            "synthetic": lambda **kw: synthetic_textured_scene(0, mips=4, **kw)}
SKY = (0.1, 0.2, 0.3)


@pytest.mark.cuda
@pytest.mark.parametrize("shadows", [False, True])
@pytest.mark.parametrize("name", sorted(TEXTURED))
def test_deferred_kernels_match_plain(cuda, name, shadows):
    """A textured frame is one launch of K3's pre-pass, one of K3 and one of
    K4; K3's G-buffer matches the plain one, K4 the plain deferred shade
    (nearest and trilinear), and the frame the plain two-phase render."""
    scene = TEXTURED[name](device=cuda)
    W, H = 160, 120
    r = Renderer(scene, W, H, shadows=shadows, sky=SKY, device=cuda)
    counts = lambda: (LAUNCHES["k3_pre"], LAUNCHES["k3"], LAUNCHES["k4"], LAUNCHES["k2"])
    before = counts()
    got = r.render_device()
    assert counts() == (before[0] + 1, before[1] + 1, before[2] + 1, before[3])
    ties = primary_ties(r.tables, W, H, r.px, r.py)
    _, gbuf = gbuffer_compare(r.tables, r.px, r.py, W, H, shadows, ties)
    for trilinear in (False, True):
        shade_compare(r.shade_tables, gbuf, SKY, trilinear, keep=~ties)
    want = render_deferred_chunk(r.scene, r.px, r.py, W, H, shadows=shadows, sky=SKY)
    assert (got - want).abs().amax(dim=1)[~ties].max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("moved", [False, True], ids=["camera", "moved_camera"])
@pytest.mark.parametrize("width", [4, 8])
def test_camera_relative_kernel_matches_plain_and_k3_follows_the_camera(cuda, width, moved):
    """K3's pre-pass on the card equals its plain version bit for bit, for
    the scene's camera and after set_camera (read on the device); K3 then
    matches the plain G-buffer at the moved camera."""
    from chip_smoke import camera_relative_compare
    from gpu_raytracer_tpu_torch.config import RaytracerConfig
    from gpu_raytracer_tpu_torch.ops.cuda.render import set_camera

    scene = make_courtyard_scene(2000, seed=1, textured=True,
                                 config=RaytracerConfig(bvh_width=width), device=cuda)
    tables = pack_render_tables(scene)
    if moved:
        set_camera(tables, moved_camera(scene.camera))
    launches = LAUNCHES["k3_pre"]
    assert camera_relative_compare(tables)["max_abs_err"] == 0.0
    assert LAUNCHES["k3_pre"] == launches + 1
    W, H = 96, 64
    py, px = (a.reshape(-1).to(torch.int32).contiguous()
              for a in torch.meshgrid(torch.arange(H, device=cuda), torch.arange(W, device=cuda),
                                      indexing="ij"))
    ties = primary_ties(tables, W, H, px, py)
    for shadows in (False, True):
        stats, _ = gbuffer_compare(tables, px, py, W, H, shadows, ties)
        assert stats["hits"] > 0


SAMPLER_SCENES = {
    "mips1": lambda **kw: synthetic_textured_scene(1, mips=1, **kw),
    "mips4": lambda **kw: synthetic_textured_scene(1, mips=4, **kw),
    "degenerate_glass": lambda **kw: synthetic_textured_scene(1, degenerate_glass=True, **kw),
    "zoo800_multi_slot": lambda **kw: make_zoo_scene(800, seed=0, multi_slot=True, **kw)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SAMPLER_SCENES))
def test_texture_shade_kernel_on_random_gbuffers(cuda, case):
    """Every wrap mode and map slot, miss and invalid-material lanes, mip
    chains, ior-1 glass whose dispersion is 0/0 (NaN in the same lanes), and
    the zoo's four map kinds over 7-8 levels: 0.0 from the plain shade; the
    plain rows are refused."""
    scene = SAMPLER_SCENES[case](device=cuda)
    tables = pack_shade_tables(scene)
    mips = scene.textures.n_levels > 1
    g = random_gbuffer(np.random.default_rng(2), 16_387, scene.materials.count, mips=mips)
    rows = torch.from_numpy(g).to(cuda)
    for trilinear in (False, True):
        assert shade_compare(tables, gbuffer_planes(rows), SKY, trilinear) == 0.0
    with pytest.raises(ValueError, match="planes"):
        texture_shade(tables, rows)


FUSED_TEXTURED = dict(TEXTURED,
                      zoo800=lambda **kw: make_zoo_scene(800, seed=0, **kw),
                      zoo800_multi_slot=lambda **kw: make_zoo_scene(800, seed=0, multi_slot=True,
                                                                    **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("shadows", [False, True])
@pytest.mark.parametrize("name", sorted(FUSED_TEXTURED))
def test_textured_primary_kernel_matches_plain(cuda, name, shadows):
    """K2t: `render_primary` on a textured scene is one launch of K3's
    pre-pass and one of the textured kernel, and matches the plain
    `render_chunk` (live spheres, every wrap mode and map slot, 48
    materials, mip chains)."""
    scene = FUSED_TEXTURED[name](device=cuda)
    W, H = 160, 120
    tables, shade = pack_render_tables(scene), pack_shade_tables(scene)
    r = Renderer(scene, W, H, device=cuda)
    ties = primary_ties(tables, W, H, r.px, r.py)
    near = mip_boundary_mask(shade, render_deferred(tables, r.px, r.py, W, H))
    LAUNCHES.clear()
    stats, frame = primary_compare(tables, shade, r.px, r.py, W, H, shadows, ties | near, sky=SKY)
    assert LAUNCHES == Counter(k2t=1, k3_pre=1)
    assert stats["err"] <= 1e-5 and stats["mean"] > 0.01
    untextured = render_chunk(dataclasses.replace(scene, textures=type(scene.textures).empty()),
                              r.px, r.py, W, H, shadows=shadows, sky=SKY)
    assert (frame - untextured).abs().max().item() > 0.01   # the maps are in the frame
    with pytest.raises(ValueError, match="shade tables"):
        render_primary(tables, r.px, r.py, W, H)


@pytest.mark.cuda
@pytest.mark.parametrize("shadows", [False, True])
@pytest.mark.parametrize("textured", [False, True])
def test_sampled_light_branch_matches_plain(cuda, textured, shadows):
    """64 lights: K2 / K2t and K3 with a seeded light_u against the plain
    single-sample version, and the kernels' loop over every light against
    the plain loop."""
    scene = make_courtyard_scene(2000, seed=3, lights=64, textured=textured, device=cuda)
    W, H = 96, 64
    tables = pack_render_tables(scene)
    shade = pack_shade_tables(scene) if textured else None
    r = Renderer(scene, W, H, device=cuda)
    ties = primary_ties(tables, W, H, r.px, r.py)
    u = seeded_light_u(W * H, 5, cuda)
    sampled, frame = primary_compare(tables, shade, r.px, r.py, W, H, shadows, ties, light_u=u)
    loop, exact = primary_compare(tables, shade, r.px, r.py, W, H, shadows, ties)
    assert sampled["err"] <= 1e-5 and loop["err"] <= 1e-5
    assert not torch.equal(frame, exact)
    got = split_gbuffer(render_deferred(tables, r.px, r.py, W, H, shadows=shadows, light_u=u))
    want = split_gbuffer(render_gbuffer(scene, r.px, r.py, W, H, shadows=shadows, light_u=u))
    assert (got[0] - want[0]).abs().amax(dim=1)[~ties].max().item() <= 1e-5


@pytest.mark.cuda
def test_renderer_samples_one_light_above_16(cuda):
    """Renderer on the card hands the kernels its own light_u above 16
    lights; frames of successive light_frame values average toward the loop
    over every light (within 8% in sum over 8 frames)."""
    scene = make_courtyard_scene(2000, seed=3, lights=64, device=cuda)
    W, H = 96, 64
    r = Renderer(scene, W, H, shadows=True, device=cuda)
    exact = render_chunk(r.scene, r.px, r.py, W, H, shadows=True)
    acc = torch.zeros_like(exact)
    for k in range(8):
        r.light_frame = k
        acc += r.render_device()
    assert torch.equal(r.render_device(), r.render_device())
    rel = abs((acc / 8).sum().item() - exact.sum().item()) / exact.sum().item()
    assert rel < 0.08


BOUNCE = {"courtyard2000": SCENES["courtyard2000"],
          "textured_courtyard2000": TEXTURED["courtyard2000"],
          "synthetic": TEXTURED["synthetic"]}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(BOUNCE))
def test_bounce_kernel_matches_plain(cuda, name):
    """K6 against the plain bounce on 65,536-lane pools of the path tracer
    (depths 0-2 and the last; from depth 1 on through the coherence order
    over the live lanes only, QMC uniforms made by the kernel), texture LOD
    bias 0 and 1, and at depth 1 with shadows off, every light instead of
    one sampled light, no roulette, the last-depth form, channel 1, an
    all-dead half, and uniforms handed in by position (with and without the
    order)."""
    tables = pack_bounce_tables(BOUNCE[name](device=cuda))
    for bias in (0.0, 1.0):
        for depth, r, order, n_live, qmc, flags in pools(tables, 256, 256, (0, 1, 2, 4), bias):
            how = dict(depth=depth, order=order, n_live=n_live, qmc=qmc)
            bounce_compare(tables, r, flags, **how)
            if depth != 1 or bias:
                continue
            for change in (dict(shadows=False), dict(light_sample=False), dict(do_rr=False),
                           dict(last=True)):
                bounce_compare(tables, r, dict(flags, **change), **how)
            chan1 = r.replace(wavelength_channel=torch.ones_like(r.wavelength_channel))
            bounce_compare(tables, chan1, flags, **how)
            half = r.active.clone()
            half[r.count // 2:] = False
            dead_half = r.replace(active=half)
            bounce_compare(tables, dead_half, flags, depth=depth, qmc=qmc)
            live = dead_half.active.sum()
            bounce_compare(tables, dead_half, flags, depth=depth, qmc=qmc, n_live=live,
                           order=coherence_order(tables.scene, dead_half))
            u = torch.from_numpy(np.random.default_rng(7).random((r.count, 7), dtype=np.float32))
            u = u.to(cuda)
            bounce_compare(tables, r, flags, u=u)
            bounce_compare(tables, r, flags, u=u, order=order, n_live=n_live)


@pytest.mark.cuda
def test_bounce_kernel_works_in_place_on_live_lanes_only(cuda):
    """On a sorted pool with dead lanes the launch leaves every dead lane
    bit-unchanged, adds the radiance in place, and with n_live smaller than
    the live count leaves the live lanes past it alone too; the functional
    form leaves its input alone and equals the plain functional bounce."""
    tables = pack_bounce_tables(BOUNCE["courtyard2000"](device=cuda))
    (_, r, order, n_live, qmc, flags), = pools(tables, 128, 128, (2,))
    assert 0 < int(n_live) < r.count
    stats = bounce_compare(tables, r, flags, depth=2, order=order, n_live=n_live, qmc=qmc)
    assert stats["max_abs_err"] <= 1e-5 and stats["live"] == int(n_live)
    half = n_live // 2
    got, rad = r.clone(), torch.zeros_like(r.origin)
    fused_bounce_(tables, got, rad, depth=2, order=order, n_live=half, qmc=qmc, **flags)
    skipped = order[int(half):].long()
    assert r.active[skipped[: int(n_live) - int(half)]].all()
    for name in ("origin", "direction", "throughput", "active", "bounce_depth"):
        assert torch.equal(getattr(got, name)[skipped], getattr(r, name)[skipped]), name
    assert not rad[skipped].any() and rad.abs().sum() > 0
    before = r.clone()
    u = pool_uniforms(qmc, 2, torch.arange(r.count, device=cuda), r.count)
    new, frad = fused_bounce(tables, r, u, **flags)
    assert torch.equal(r.origin, before.origin) and torch.equal(r.active, before.active)
    want, wrad = bounce(tables.scene, r, u, **flags)
    assert torch.equal(new.active, want.active)
    assert (frad - wrad).abs().max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("stream, depth", [(QmcStream(), 0), (QmcStream(5, 9, 2**31 + 5, 4), 3),
                                           (QmcStream(2**32 - 7, 2**32 - 2, 2**32 - 1, 2), 63)])
def test_in_kernel_qmc_uniforms_are_bit_equal(cuda, stream, depth):
    n = 16_384
    got = qmc_uniforms_kernel(stream, depth, n, cuda)
    want = pool_uniforms(stream, depth, torch.arange(n, device=cuda), n)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_misaligned_node_table_raises(cuda):
    """A node record is read as one aligned 128-byte line: a table that
    starts elsewhere (a view into a larger buffer) is refused, not read."""
    scene = SCENES["courtyard2000"](device=cuda)
    tables = pack_trace_tables(scene)
    Q, words = tables.nodes.shape
    buf = torch.zeros(Q * words + 16, dtype=torch.float32, device=cuda)
    shifted = buf[16:].view(Q, words)
    shifted.copy_(tables.nodes)
    assert shifted.data_ptr() % 128 == 64
    bad = dataclasses.replace(tables, nodes=shifted)
    o = scene.camera.position[None, :].repeat(4, 1).contiguous()
    d = scene.camera.direction[None, :].repeat(4, 1).contiguous()
    far = torch.full((4,), 3.0e38, device=cuda)
    launches = LAUNCHES["k1_standalone"]
    with pytest.raises(ValueError, match="128-byte"):
        traverse(bad, o, d, far)
    assert LAUNCHES["k1_standalone"] == launches
    rt = dataclasses.replace(pack_render_tables(scene), trace=bad)
    px = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="128-byte"):
        render_primary(rt, px, px, 8, 8)
    traverse(tables, o, d, far)   # the table as packed is aligned


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SAMPLER_SCENES))
def test_material_sample_kernel_matches_plain(cuda, case):
    tables = pack_bounce_tables(SAMPLER_SCENES[case](device=cuda))
    rng = np.random.default_rng(4)
    n = 16_387   # a ragged last block
    mid = torch.from_numpy(rng.integers(-1, tables.scene.materials.count + 2, n)
                           .astype(np.int32)).to(cuda)
    uv = torch.from_numpy(rng.uniform(-1.5, 2.5, (n, 2)).astype(np.float32)).to(cuda)
    for lod in (0.0, 1.0, 2.5, 9.0):
        assert k5_compare(tables, mid, uv, lod) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["courtyard2000", "textured_courtyard2000"])
def test_pathtracer_step_launches_the_bounce_kernel(cuda, name):
    """A step is max_depth + 1 bounce launches and no other kernel, and
    never synchronises with the device; its 4-spp image matches the plain
    path's on 99.9% of the pixels."""
    scene = BOUNCE[name](device=cuda)
    pt = PathTracer(scene, 64, 64, device=cuda)
    LAUNCHES.clear()
    pt.step()
    n = pt.config.max_bounce_depth + 1
    textured = name.startswith("textured")
    assert LAUNCHES == Counter(k6=n, k5=n if textured else 0)
    torch.cuda.set_sync_debug_mode("error")   # a step never waits for the device
    try:
        pt.step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for _ in range(2):
        pt.step()
    plain = PathTracer(scene, 64, 64, device=cuda)
    with plain_bounces():
        for _ in range(4):
            plain.step()
    got, want = pt.image_device(), plain.image_device()
    assert torch.isfinite(got).all()
    assert ((got - want).abs().amax(dim=2) <= 1e-5).float().mean().item() >= 0.999
    assert pt.counters().rays_per_bounce == plain.counters().rays_per_bounce


def moved_camera(camera):
    """The interactive controller's move: a camera whose fields are on the host."""
    ctrl = CameraController(camera)
    ctrl.move(forward=2.0, strafe=-1.0)
    ctrl.rotate(-15.0, 5.0)
    return ctrl.camera()


@pytest.mark.cuda
def test_renderer_light_salt_draws_per_batch_on_the_card(cuda):
    """Above 16 lights on the card: one batch salt gives the same frame,
    another salt (or frame) other light choices."""
    scene = make_courtyard_scene(2000, seed=3, lights=64, device=cuda)
    r = Renderer(scene, 96, 64, shadows=True, device=cuda)
    assert torch.equal(r._light_u(r.px.shape[0], 2), light_uniforms(r.px.shape[0], 0, 2, cuda))
    a = r.render_rays(r.px, r.py, light_salt=1)
    assert torch.equal(a, r.render_rays(r.px, r.py, light_salt=1))
    assert not torch.equal(a, r.render_rays(r.px, r.py, light_salt=2))
    r.light_frame = 1
    assert not torch.equal(a, r.render_rays(r.px, r.py, light_salt=1))


@pytest.mark.cuda
@pytest.mark.parametrize("textured", [False, True])
def test_set_camera_on_the_card_never_waits_and_repacks_nothing(cuda, textured):
    """The controller's move (a host camera) under sync debug mode "error":
    no read-back, the same table tensors, the frame of a fresh renderer."""
    scene = make_courtyard_scene(2000, seed=1, textured=textured, device=cuda)
    r = Renderer(scene, 96, 64, shadows=True, device=cuda)
    r.render_device()
    kept = (r.tables.camera, r.tables.trace.nodes, r.tables.materials,
            None if r.shade_tables is None else r.shade_tables.atlas)
    cam = moved_camera(scene.camera)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        r.set_camera(cam)
        got = r.render_device()
        r.set_camera(r.scene.camera)   # the same camera again: its fov is the old tensor
    finally:
        torch.cuda.set_sync_debug_mode("default")
    now = (r.tables.camera, r.tables.trace.nodes, r.tables.materials,
           None if r.shade_tables is None else r.shade_tables.atlas)
    assert all(x is y for x, y in zip(now, kept))
    fresh = Renderer(scene.with_camera(cam), 96, 64, shadows=True, device=cuda)
    assert torch.equal(got, fresh.render_device())
    assert torch.equal(r.tables.camera, fresh.tables.camera)


@pytest.mark.cuda
def test_pathtracer_set_camera_on_the_card_never_waits(cuda):
    """The controller's move between steps under sync debug mode "error",
    then the step of a fresh tracer at that camera."""
    scene = make_courtyard_scene(2000, seed=1, textured=True, device="cuda")
    pt = PathTracer(scene, 64, 64, device="cuda")
    pt.step()
    camera_row = pt.tables.render.camera
    cam = moved_camera(scene.camera)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pt.set_camera(cam)
        pt.step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert pt.tables.render.camera is camera_row
    fresh = PathTracer(scene.with_camera(cam), 64, 64, device="cuda")
    fresh.step()
    assert torch.equal(pt.image_device(), fresh.image_device())


@pytest.mark.cuda
@pytest.mark.parametrize("textured", [False, True])
def test_gbuffer_and_warp_trace_through_k1_and_k5(cuda, textured, monkeypatch):
    """PathTracer.gbuffer() and the temporal warp on the card: one K1
    launch per trace, one K5 launch per textured albedo, never the plain
    BVH walk; the planes equal the plain trace and material_textures on the
    same card tensors (normal <= 1e-6, depth 1e-6 relative, albedo 0.0)
    off exact-t ties."""
    from gpu_raytracer_tpu_torch.ops import trace as plain
    from gpu_raytracer_tpu_torch.ops.shading import material_textures

    scene = make_courtyard_scene(2000, seed=1, textured=textured, device=cuda)
    pt = PathTracer(scene, 64, 64, device=cuda)
    grid = torch.arange(64 * 64, device=cuda)
    o, d = generate_rays(pt.scene.camera, 64, 64, grid % 64, grid // 64,
                         fov_scale=pt.tables.render.fov_scale)
    ph = plain.trace(pt.scene, o, d)

    def refuse(*a, **kw):
        raise AssertionError("the plain BVH walk ran on the card")

    monkeypatch.setattr(plain, "bvh_traverse_threaded", refuse)
    LAUNCHES.clear()
    normal, depth, albedo = pt.gbuffer()
    k5 = 1 if textured else 0
    assert LAUNCHES == Counter(k1_standalone=1, k5_standalone=k5)
    kh = trace(pt.tables.render.trace, o, d)    # gbuffer()'s trace again, for its slots
    assert torch.equal(kh.t, depth.reshape(-1)) and torch.equal(kh.hit, ph.hit)
    ties = kh.hit & (kh.prim_id != ph.prim_id) & (kh.t == ph.t)
    assert not (kh.hit & (kh.prim_id != ph.prim_id) & ~ties).any()
    h = kh.hit
    assert ((kh.t - ph.t).abs() / ph.t.abs())[h].max().item() <= 1e-6
    p_alb = material_textures(pt.scene, torch.clamp(ph.material_id, min=0), ph.uv)[0]
    p_alb = torch.where(ph.hit[:, None], p_alb, torch.ones_like(p_alb))
    keep = ~ties
    assert (normal.reshape(-1, 3) - ph.normal)[keep].abs().max().item() <= 1e-6
    assert (albedo.reshape(-1, 3) - p_alb)[keep].abs().max().item() == 0.0
    pt.step()
    cam = moved_camera(scene.camera)
    LAUNCHES.clear()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pt.set_camera(cam, temporal=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert LAUNCHES == Counter(camera_row=1, k1_standalone=1, k5_standalone=k5)
    assert torch.isfinite(pt.image_device()).all()


@pytest.mark.cuda
def test_denoise_on_the_card_matches_the_cpu(cuda):
    """atrous_denoise on the card against the same call on a CPU copy:
    within 1e-5 x max(1, max |ref|), through the kernels: a prepare launch
    and one launch a pass (ops/cuda/denoise.py)."""
    from gpu_raytracer_tpu_torch.ops.denoise import atrous_denoise

    pt = PathTracer(make_courtyard_scene(2000, seed=1, textured=True, device=cuda), 96, 64,
                    device=cuda)
    for _ in range(2):
        pt.step()
    img, planes = pt.image_device(), pt.gbuffer()
    for iterations in (1, 4):
        before = LAUNCHES["denoise"]
        got = atrous_denoise(img, *planes, iterations=iterations).cpu()
        assert LAUNCHES["denoise"] == before + iterations + 1
        ref = atrous_denoise(img.cpu(), *(x.cpu() for x in planes), iterations=iterations)
        assert torch.isfinite(got).all()
        assert (got - ref).abs().max().item() <= 1e-5 * max(1.0, ref.abs().max().item())


def _denoise_inputs(seed, H, W, device):
    """A noisy frame and its G-buffer shaped like a path tracer's (flat walls
    of smoothly varying depth, a patch of random normals, rows, columns and
    a scatter of misses with normal 0, depth f32::MAX and albedo 1)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    normal = np.zeros((H, W, 3), np.float32)
    normal[...] = [0.0, 0.0, 1.0]
    normal[:, W // 2:] = [0.6, 0.0, 0.8]
    rand = rng.normal(size=(H, W, 3)).astype(np.float32)
    normal[2 * H // 3:, : W // 3] = (rand / np.linalg.norm(rand, axis=-1, keepdims=True))[
        2 * H // 3:, : W // 3]
    depth = (4.0 + 0.01 * x + 0.02 * y + rng.uniform(0.0, 0.01, (H, W))).astype(np.float32)
    miss = rng.random((H, W)) < 0.1
    miss[0] = miss[H // 2] = True
    miss[:, W - 1] = miss[:, W // 4] = True
    normal[miss] = 0.0
    depth[miss] = np.float32(3.4028235e38)
    albedo = rng.uniform(0.0, 1.0, (H, W, 3)).astype(np.float32)
    albedo[miss] = 1.0
    color = (albedo * rng.exponential(0.5, (H, W, 3))).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (color, normal, depth, albedo))


@pytest.mark.cuda
def test_denoise_kernel_at_1024_matches_the_cpu(cuda):
    """The fly frame's filter, 1024^2 and 3 passes, on the card against the
    plain call on a CPU copy, within 1e-5 x max(1, max |ref|); the
    G-buffer as strided views of one [C,7] tensor, as the path tracer's
    warp leaves it. The prepare launch's depth subsample is the plain
    version's strided one, bit for bit."""
    from gpu_raytracer_tpu_torch.ops.denoise import atrous_denoise

    color, normal, depth, albedo = _denoise_inputs(7, 1024, 1024, cuda)
    pack = torch.cat([normal.reshape(-1, 3), depth.reshape(-1, 1), albedo.reshape(-1, 3)], 1)
    planes = (pack[:, 0:3].reshape(1024, 1024, 3), pack[:, 3].reshape(1024, 1024),
              pack[:, 4:7].reshape(1024, 1024, 3))
    before = LAUNCHES["denoise"]
    got = atrous_denoise(color, *planes, iterations=3).cpu()
    assert LAUNCHES["denoise"] == before + 4
    hit = (normal * normal).sum(-1) > 0.25
    sub = torch.where(hit, depth, torch.zeros_like(depth))[::4, ::4].reshape(-1)
    assert torch.equal(_filter_subsample(color, *planes), sub)
    ref = atrous_denoise(*(t.cpu() for t in (color, normal, depth, albedo)), iterations=3)
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= 1e-5 * max(1.0, ref.abs().max().item())


def _filter_subsample(color, normal, depth, albedo=None):
    """The filter's prepare launch alone on CUDA tensors -> the depth
    subsample it writes (ops/cuda/denoise.py::_prepare)."""
    from gpu_raytracer_tpu_torch.ops.cuda import denoise as cuda_denoise

    H, W = color.shape[:2]
    rows = [cuda_denoise._pixel_rows(t, H * W, ch, name) for t, ch, name in
            ((color, 3, "color"), (normal, 3, "normal"), (depth, 0, "depth"))]
    rows.append((None, 0) if albedo is None else cuda_denoise._pixel_rows(albedo, H * W, 3, "a"))
    prepare = cuda_denoise._entries("rt_atrous_prepare")[0]
    return cuda_denoise._prepare(prepare, rows, H, W, color.device)[1]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 101, 4097, 65536, 261121])
def test_depth_scale_on_the_card_is_torch_quantile(cuda, n):
    """The depth scale the passes take from torch.sort's order of the
    subsample on the card is torch.quantile(depths, 0.99)'s: one pass with
    a depth sigma of 1e-4 (every tap's weight turns on the scale) on frames
    of n hit pixels under 512 an edge (the subsample is every pixel), held
    to the plain call on a CPU copy at 1e-5 x max(1, max |ref|): depths with
    ties and misses' 0, spread magnitudes with negative values and -0, one
    value repeated, and a NaN of either sign (the frame NaN where the plain
    one is, the card's sort putting a negative NaN first)."""
    from gpu_raytracer_tpu_torch.ops.denoise import atrous_denoise

    shape = {1: (1, 1), 2: (1, 2), 101: (1, 101), 4097: (17, 241), 65536: (256, 256),
             261121: (511, 511)}[n]
    normal = torch.zeros(shape + (3,), device=cuda)
    normal[..., 2] = 1.0
    rng = np.random.default_rng(n)
    color = torch.from_numpy(rng.uniform(0.0, 1.0, shape + (3,)).astype(np.float32)).to(cuda)
    x = rng.uniform(1.0, 40.0, n).astype(np.float32)
    x[rng.random(n) < 0.3] = 0.0
    x[rng.random(n) < 0.2] = np.float32(7.25)
    y = (rng.standard_normal(n) * 10.0 ** rng.integers(-6, 6, n)).astype(np.float32)
    y[rng.random(n) < 0.1] = -0.0
    z = np.full(n, 3.5, np.float32)
    cases = [x, y, z]
    for sign in (1.0, -1.0):
        v = x.copy()
        v[n // 2] = np.copysign(np.float32(np.nan), sign)
        cases.append(v)
    for a in cases:
        depth = torch.from_numpy(a.reshape(shape)).to(cuda)
        kw = dict(iterations=1, sigma_depth=1e-4)
        got = atrous_denoise(color, normal, depth, **kw).cpu()
        ref = atrous_denoise(color.cpu(), normal.cpu(), depth.cpu(), **kw)
        assert torch.equal(torch.isnan(got), torch.isnan(ref))
        fin = ~torch.isnan(ref)
        if fin.any():
            bar = 1e-5 * max(1.0, ref[fin].abs().max().item())
            assert (got[fin] - ref[fin]).abs().max().item() <= bar


@pytest.mark.cuda
def test_denoise_kernel_allocates_no_tap_stack(cuda):
    """The kernels' call at 1024^2 with 4 passes allocates its planes and
    frame, no [25,H,W,...] stack: the peak above what was allocated before
    stays under 4 x the inputs' bytes (the plain version's stack alone is
    25 x 9 floats a pixel, 22.5 x)."""
    from gpu_raytracer_tpu_torch.ops.denoise import atrous_denoise

    inputs = _denoise_inputs(8, 1024, 1024, cuda)
    in_bytes = sum(t.numel() * t.element_size() for t in inputs)
    atrous_denoise(*inputs, iterations=4)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = atrous_denoise(*inputs, iterations=4)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < 4 * in_bytes
    assert out.shape == (1024, 1024, 3) and torch.isfinite(out).all()


@pytest.mark.cuda
def test_fly_frame_on_the_card_matches_the_plain_path(cuda):
    """Two fly frames on the card (warp, coset step, à-trous, u8) without a
    host sync, against the same frames on the CPU with the same history
    jitter: the u8 frames equal on >= 99% of the pixels."""
    from gpu_raytracer_tpu_torch.engine.pathtracer import warp_jitter

    scene = make_courtyard_scene(2000, seed=1, device="cpu")
    tracers = [PathTracer(scene, 64, 64, device=dev) for dev in (cuda, torch.device("cpu"))]
    jitter = {n: warp_jitter(0, n, 64 * 64, "cpu") for n in (1, 2)}
    for pt in tracers:
        on_device = {n: j.to(pt.device) for n, j in jitter.items()}
        pt._warp_jitter = lambda pt=pt, on_device=on_device: on_device[pt._warp_no]
        for _ in range(3):
            pt.step()
    ctrl = CameraController(scene.camera)
    cams = []
    for strafe, forward in ((1.0, 0.0), (0.0, 1.0)):
        ctrl.move(forward=forward, strafe=strafe)
        cams.append(ctrl.camera())
    LAUNCHES.clear()
    torch.cuda.set_sync_debug_mode("error")
    try:
        frames = [tracers[0].fly_frame(c, m=4, u8=True) for c in cams]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    n = tracers[0].config.max_bounce_depth + 1
    assert LAUNCHES == Counter(camera_row=2, k6=2 * n, k1_standalone=3, denoise=2 * (4 + 1))
    want = [tracers[1].fly_frame(c, m=4, u8=True) for c in cams]
    for got, ref in zip(frames, want):
        assert got.dtype == torch.uint8 and got.shape == (64, 64, 3)
        equal = (got.cpu().int() - ref.int()).abs().amax(dim=2) == 0
        assert equal.float().mean().item() >= 0.99


# ---- the Viewer and the geometry refit ----

def _moved_vertices(scene, scale=1.2):
    v = scene.mesh.vertices.cpu().numpy()
    return (v * np.float32(scale) + np.float32([0.1, 0.3, -0.2])).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("textured", [False, True])
@pytest.mark.parametrize("rebuild", [False, True])
def test_refreshed_tables_equal_a_fresh_pack_on_the_card(cuda, textured, rebuild):
    """Renderer.set_geometry / PathTracer.set_geometry take a refit scene's
    tables along (in place after a topology refit): bit for bit a fresh
    pack of the refit scene."""
    from chip_smoke import tables_equal
    from gpu_raytracer_tpu_torch.models.scene import refit_scene

    scene = make_courtyard_scene(2000, seed=1, textured=textured, device=cuda)
    r = Renderer(scene, 64, 48, shadows=True, device=cuda)
    pt = PathTracer(scene, 32, 32, device=cuda)
    nodes = r.tables.trace.nodes
    refit = refit_scene(r.scene, _moved_vertices(scene), rebuild=rebuild)
    r.set_geometry(refit)
    pt.set_geometry(refit)
    assert (r.tables.trace.nodes is nodes) == (not rebuild)
    assert tables_equal(r.tables.trace, pack_render_tables(r.scene).trace) == []
    assert tables_equal(pt.tables.render.trace, pack_bounce_tables(pt.scene).render.trace) == []


@pytest.mark.cuda
def test_lbvh_on_the_card_equals_the_cpu(cuda):
    from chip_smoke import lbvh_cpu_compare

    assert lbvh_cpu_compare(make_courtyard_scene(2000, seed=1, device=cuda))["quads"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("rebuild", [False, True])
def test_k2_frame_on_refit_and_rebuilt_scenes_matches_plain(cuda, rebuild):
    from chip_smoke import refit_frame_compare
    from gpu_raytracer_tpu_torch.models.scene import refit_scene

    scene = make_courtyard_scene(2000, seed=1, device=cuda)
    r = Renderer(scene, 96, 64, shadows=True, device=cuda)
    r.set_geometry(refit_scene(r.scene, _moved_vertices(scene), rebuild=rebuild))
    LAUNCHES.clear()
    stats = refit_frame_compare(r, f"K2 rebuild={rebuild}")
    assert LAUNCHES["k2"] == 1 and stats["max_abs_err"] <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("textured", [False, True])
def test_viewer_frames_and_refit_never_wait(cuda, textured):
    """A camera-moving Viewer frame, a topology refit + frame and a rebuild
    run under set_sync_debug_mode("error"): nothing makes the host wait."""
    from gpu_raytracer_tpu_torch.engine.viewer import Viewer
    from gpu_raytracer_tpu_torch.models.scene import refit_scene

    scene = make_courtyard_scene(2000, seed=1, textured=textured, device=cuda)
    v = Viewer(scene, 96, 64, shadows=True, verbose=False, device=cuda)
    v.run_compute()
    moved = _moved_vertices(scene, 1.05)
    v.update_geometry(moved)
    v.run_compute()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        v.handle_key("w")
        v.run_compute()
        v.update_geometry(moved + np.float32(0.01))
        v.run_compute()
        refit_scene(v.scene, moved, rebuild=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(v._fb_dev).all()


@pytest.mark.cuda
@pytest.mark.parametrize("textured", [False, True])
def test_frame_kernels_count_their_tables_without_waiting(cuda, textured):
    """Under a profiler and set_sync_debug_mode("error"), Viewer frames
    count at each K2 (or K3) launch the bytes of the tables it walks (K3:
    the camera-relative ones too); without a profiler nothing is counted."""
    from torch.profiler import ProfilerActivity, profile

    from gpu_raytracer_tpu_torch.engine import perf
    from gpu_raytracer_tpu_torch.engine.viewer import Viewer

    scene = make_courtyard_scene(2000, seed=1, textured=textured, device=cuda)
    v = Viewer(scene, 96, 64, shadows=True, verbose=False, device=cuda)
    perf.reset()
    v.run_compute()
    torch.cuda.synchronize()
    assert perf.snapshot()["counters"] == {}
    frames = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(frames):
                v.handle_key("w")
                v.run_compute()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    rt = v.renderer.tables
    words = rt.trace.nodes.numel() + rt.trace.tris.numel()
    if textured:
        words += rt.rel_nodes.numel() + rt.rel_tris.numel()
    got = perf.snapshot()["counters"]
    perf.reset()
    assert got["render.table_bytes"] == frames * 4 * words


@pytest.mark.cuda
def test_viewer_present_reads_back_through_pinned_memory(cuda):
    """A path-traced present on the card enqueues its read-back (a
    non-blocking copy into pinned memory, then an event) without a host
    sync; the handle materialises to the bytes of a blocking read, one frame
    later as the server and the window do, and keeps its own frame after
    more presents of its shape."""
    from gpu_raytracer_tpu_torch.engine.pathtracer import to_u8 as device_u8
    from gpu_raytracer_tpu_torch.engine.viewer import HostFrame, Viewer
    from gpu_raytracer_tpu_torch.utils.yuv import decode_yuv420, encode_yuv420

    v = Viewer(build_default_scene(device=cuda), 64, 48, verbose=False, device=cuda)
    v.handle_key("p")
    v.run_compute()
    Viewer.materialize_frame(v.present_frame_packed())    # warm the host allocator
    Viewer.materialize_frame(v.present_frame())
    v.run_compute()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        packed = v.present_frame_packed()
        rgb = v.present_frame()
        v.run_compute()                                    # the next frame, enqueued
        nxt = v.present_frame_packed()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert isinstance(packed, HostFrame) and isinstance(rgb, HostFrame)
    assert packed.host.is_pinned() and rgb.host.is_pinned()
    got = Viewer.materialize_frame(packed)
    fb = v._fb_dev
    assert np.array_equal(Viewer.materialize_frame(nxt), decode_yuv420(encode_yuv420(fb).cpu()))
    assert not np.array_equal(got, Viewer.materialize_frame(nxt))   # a sample later
    assert Viewer.materialize_frame(rgb).shape == (48, 64, 3)
    later = [v.present_frame_packed() for _ in range(3)]   # more presents of its shape
    assert np.array_equal(Viewer.materialize_frame(packed), got)
    for h in later:
        assert np.array_equal(Viewer.materialize_frame(h), Viewer.materialize_frame(nxt))
    assert np.array_equal(Viewer.materialize_frame(v.present_frame()),
                          device_u8(fb).cpu().numpy())


WIDE = {"w8": dict(bvh_width=8), "sbvh": dict(bvh_spatial_splits=True),
        "sbvh_w8": dict(bvh_width=8, bvh_spatial_splits=True)}


def _wide_scene(name, cuda, **kw):
    from gpu_raytracer_tpu_torch.config import RaytracerConfig

    return make_courtyard_scene(2000, seed=1, config=RaytracerConfig(**WIDE[name]), device=cuda,
                                **kw)


def _counter(name, kernel):
    """The launch count of the instance `name`'s tables take."""
    return LAUNCHES[kernel if WIDE[name].get("bvh_width", 4) == 4 else f"{kernel}_w8"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(WIDE))
def test_wide_and_sbvh_traverse_kernel_matches_plain(cuda, name):
    """K1 at width 8 and on the spatial-split tree against the plain walk:
    closest hits of camera and random rays, and any-hit below a max t."""
    scene = _wide_scene(name, cuda)
    tables = pack_trace_tables(scene)
    assert tables.width == WIDE[name].get("bvh_width", 4)
    rng = np.random.default_rng(3)
    n = 8192
    o = torch.from_numpy(rng.uniform(-20, 20, (n, 3)).astype(np.float32)).to(cuda)
    o[: n // 2] = scene.camera.position
    d = rng.normal(size=(n, 3))
    d = torch.from_numpy((d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)).to(cuda)
    far = torch.full((n,), 3.4028234663852886e38, device=cuda)
    before = _counter(name, "k1_standalone")
    ties = k1_compare(tables, o, d, far)[1]
    assert _counter(name, "k1_standalone") == before + 1
    assert ties.sum().item() <= n * 1e-3
    max_t = torch.from_numpy(rng.uniform(0, 20, n).astype(np.float32)).to(cuda)
    blocked = traverse(tables, o, d, max_t, any_hit=True)[2]
    assert torch.equal(blocked, traverse_triangles(scene, o, d, max_t, any_hit=True)[2])


@pytest.mark.cuda
@pytest.mark.parametrize("shadows", [False, True])
@pytest.mark.parametrize("name", sorted(WIDE))
def test_wide_and_sbvh_render_kernel_matches_plain(cuda, name, shadows):
    """K2 at width 8 and on the spatial-split tree: one launch of the
    instance of the tables' width, the frame against render_chunk."""
    scene = _wide_scene(name, cuda)
    W, H = 160, 120
    r = Renderer(scene, W, H, shadows=shadows, sky=SKY, device=cuda)
    before = _counter(name, "k2")
    got = r.render_device()
    assert _counter(name, "k2") == before + 1
    want = render_chunk(r.scene, r.px, r.py, W, H, shadows=shadows, sky=SKY)
    o, d = generate_rays(r.scene.camera, W, H, r.px, r.py)
    far = torch.full((W * H,), 3.4028234663852886e38, device=cuda)
    ties = k1_compare(r.tables.trace, o.contiguous(), d.contiguous(), far)[1]
    diff = (got - want).abs().amax(dim=1)
    assert diff[~ties].max().item() <= 1e-5
    assert ties.sum().item() <= W * H * 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("textured", [False, True])
@pytest.mark.parametrize("name", sorted(WIDE))
def test_wide_and_sbvh_bounce_kernel_matches_plain(cuda, name, textured):
    """K6 at width 8 and on the spatial-split tree against the plain bounce
    on the path tracer's pools (depths 0, 1 and the last)."""
    tables = pack_bounce_tables(_wide_scene(name, cuda, textured=textured))
    before = _counter(name, "k6")
    launches = 0
    for depth, r, order, n_live, qmc, flags in pools(tables, 128, 128, (0, 1, 4)):
        bounce_compare(tables, r, flags, depth=depth, order=order, n_live=n_live, qmc=qmc)
        launches += 1
    assert _counter(name, "k6") == before + launches


@pytest.mark.cuda
def test_width8_refit_keeps_width8_and_rebuild_drops_to_width4_on_the_card(cuda):
    """A topology refit of a width-8 scene keeps its width-8 tables (in
    place) and the next frame launches the width-8 K2; a rebuild brings
    width-4 tables and the next frame launches the width-4 K2."""
    from chip_smoke import refit_frame_compare
    from gpu_raytracer_tpu_torch.models.scene import refit_scene

    scene = _wide_scene("w8", cuda)
    r = Renderer(scene, 96, 64, shadows=True, device=cuda)
    nodes = r.tables.trace.nodes
    r.set_geometry(refit_scene(r.scene, _moved_vertices(scene)))
    assert r.tables.trace.width == 8 and r.tables.trace.nodes is nodes
    w4, w8 = LAUNCHES["k2"], LAUNCHES["k2_w8"]
    assert refit_frame_compare(r, "K2 width-8 refit")["max_abs_err"] <= 1e-5
    assert (LAUNCHES["k2"], LAUNCHES["k2_w8"]) == (w4, w8 + 1)
    r.set_geometry(refit_scene(r.scene, _moved_vertices(scene), rebuild=True))
    assert r.tables.trace.width == 4 and r.tables.trace.nodes.shape[1] == 32
    assert refit_frame_compare(r, "K2 after a rebuild")["max_abs_err"] <= 1e-5
    assert (LAUNCHES["k2"], LAUNCHES["k2_w8"]) == (w4 + 1, w8 + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("textured", [False, True], ids=["k2_w8", "k2t_w8"])
def test_width8_fused_render_matches_plain_after_a_camera_move(cuda, textured):
    """K2 w8 and K2t w8 after a camera move (the camera row rewritten in
    place, so the pre-pass's tables must be made anew), shadows on: one
    launch of K3's pre-pass and one of the width-8 kernel, the frame 0.0
    from render_chunk outside counted exact-t and order ties (and K2t's
    mip-boundary lanes)."""
    from chip_smoke import frame_pixels, order_ties
    from gpu_raytracer_tpu_torch.ops.cuda.render import set_camera

    scene = _wide_scene("w8", cuda, textured=textured)
    tables = pack_render_tables(scene)
    shade = pack_shade_tables(scene) if textured else None
    W, H = 160, 120
    px, py = frame_pixels(W, H, cuda)
    render_primary(tables, px, py, W, H, shadows=True, shade=shade)   # the scene camera's tables
    ctl = CameraController(scene.camera)
    ctl.move(forward=1.0)
    ctl.move(strafe=1.0)
    set_camera(tables, ctl.camera())
    exclude, _ = order_ties(tables, W, H, px, py)
    if textured:
        exclude = exclude | mip_boundary_mask(shade, render_deferred(tables, px, py, W, H))
    LAUNCHES.clear()
    stats, got = primary_compare(tables, shade, px, py, W, H, True, exclude, sky=SKY)
    kernel = "k2t_w8" if textured else "k2_w8"
    assert LAUNCHES == Counter({kernel: 1, "k3_pre": 1})
    assert stats["err"] == 0.0 and torch.isfinite(got).all()


@pytest.mark.cuda
@pytest.mark.parametrize("textured", [False, True], ids=["k2", "k2t"])
@pytest.mark.parametrize("width", [4, 8])
def test_render_primary_launches_the_pre_pass_for_k2t_and_width8(cuda, width, textured):
    """One render_primary call: one launch of K3's pre-pass beside a K2 w8,
    K2t w8 or width-4 K2t launch; K2 at width 4 alone."""
    from chip_smoke import frame_pixels
    from gpu_raytracer_tpu_torch.config import RaytracerConfig

    scene = make_courtyard_scene(2000, seed=1, textured=textured, device=cuda,
                                 config=RaytracerConfig(bvh_width=width))
    tables = pack_render_tables(scene)
    shade = pack_shade_tables(scene) if textured else None
    px, py = frame_pixels(64, 48, cuda)
    LAUNCHES.clear()
    render_primary(tables, px, py, 64, 48, shadows=True, shade=shade)
    kernel = ("k2t" if textured else "k2") + ("_w8" if width == 8 else "")
    want = {kernel: 1, "k3_pre": 1} if width == 8 or textured else {kernel: 1}
    assert LAUNCHES == Counter(want)
    assert (tables.rel_nodes is None) == (width == 4 and not textured)


@pytest.mark.cuda
def test_width4_k2t_matches_plain_after_a_camera_move(cuda):
    """K2t at width 4 after a camera move (the camera row rewritten in
    place, so the pre-pass's tables must be made anew), shadows off and on:
    one launch of K3's pre-pass and one of K2t each, the frame 0.0 from
    render_chunk outside counted exact-t and order ties and mip-boundary
    lanes."""
    from chip_smoke import frame_pixels, order_ties
    from gpu_raytracer_tpu_torch.ops.cuda.render import set_camera

    scene = make_courtyard_scene(2000, seed=1, textured=True, device=cuda)
    tables, shade = pack_render_tables(scene), pack_shade_tables(scene)
    W, H = 160, 120
    px, py = frame_pixels(W, H, cuda)
    render_primary(tables, px, py, W, H, shade=shade)   # the scene camera's tables
    ctl = CameraController(scene.camera)
    ctl.move(forward=1.0)
    ctl.move(strafe=1.0)
    set_camera(tables, ctl.camera())
    exclude, _ = order_ties(tables, W, H, px, py)
    exclude = exclude | mip_boundary_mask(shade, render_deferred(tables, px, py, W, H))
    for shadows in (False, True):
        LAUNCHES.clear()
        stats, got = primary_compare(tables, shade, px, py, W, H, shadows, exclude, sky=SKY)
        assert LAUNCHES == Counter(k2t=1, k3_pre=1)
        assert stats["err"] == 0.0 and torch.isfinite(got).all()


@pytest.mark.cuda
@pytest.mark.parametrize("width", [4, 8])
def test_k2t_entry_refuses_a_launch_without_the_relative_tables(cuda, width):
    """rt_render_primary_textured returns cudaErrorInvalidValue (1), and
    launches nothing, without the camera-relative tables at either node
    width; with them it launches."""
    from chip_smoke import frame_pixels
    from gpu_raytracer_tpu_torch.config import RaytracerConfig
    from gpu_raytracer_tpu_torch.ops.cuda.build import load_kernels
    from gpu_raytracer_tpu_torch.ops.cuda.render import camera_relative
    from gpu_raytracer_tpu_torch.ops.cuda.traverse import nodes_ptr
    from gpu_raytracer_tpu_torch.ops.shading import pixel_footprint_scale

    scene = make_courtyard_scene(2000, seed=1, textured=True, device=cuda,
                                 config=RaytracerConfig(bvh_width=width))
    tables, shade = pack_render_tables(scene), pack_shade_tables(scene)
    tr = tables.trace
    W, H = 64, 48
    px, py = frame_pixels(W, H, cuda)
    rgb = torch.full((W * H, 3), -1.0, device=cuda)
    rel = tuple(x.data_ptr() for x in camera_relative(tables))
    lib = load_kernels().lib

    def launch(rel_nodes, rel_tris):
        return lib.rt_render_primary_textured(
            nodes_ptr(tr), tr.tris.data_ptr(), tr.attrs.data_ptr(), rel_nodes, rel_tris,
            tr.width, tr.stack, tables.camera.data_ptr(), tables.materials.data_ptr(),
            tables.materials.shape[0], tables.lights.data_ptr(), tables.lights.shape[0],
            tables.spheres.data_ptr(), tables.spheres.shape[0], shade.maps.data_ptr(),
            shade.atlas.data_ptr(), shade.present, shade.n_levels,
            pixel_footprint_scale(tables.fov_scale, H), px.data_ptr(), py.data_ptr(), W * H, W,
            H, 0, 0.0, 0.0, 0.0, 0, rgb.data_ptr(), torch.cuda.current_stream().cuda_stream)

    assert launch(0, rel[1]) == 1 and launch(rel[0], 0) == 1 and launch(0, 0) == 1
    torch.cuda.synchronize()
    assert (rgb == -1.0).all()
    assert launch(*rel) == 0
    torch.cuda.synchronize()
    want = render_primary(tables, px, py, W, H, shade=shade)
    assert torch.equal(rgb, want)


@pytest.mark.cuda
def test_traversal_work_counts_the_live_child_slots_of_each_visit(cuda):
    """traversal_work's counts on one tree at both widths: every visit has
    2 .. width non-empty child slots, width 8 visits fewer records than
    width 4, no ray with max_t 0 visits any, and the SIMT efficiencies are
    shares."""
    from chip_smoke import simt_efficiency, walk_flops
    from gpu_raytracer_tpu_torch.config import RaytracerConfig
    from gpu_raytracer_tpu_torch.engine.renderer import tiled_pixel_order
    from gpu_raytracer_tpu_torch.ops.cuda.traverse import traversal_work

    W, H = 96, 64
    work = {}
    for width in (4, 8):
        scene = make_courtyard_scene(2000, seed=1, config=RaytracerConfig(bvh_width=width),
                                     device=cuda)
        tables = pack_trace_tables(scene)
        px, py = (torch.from_numpy(a).to(cuda) for a in tiled_pixel_order(W, H))
        o, d = generate_rays(scene.camera, W, H, px, py)
        far = torch.full((W * H,), 3.4028234663852886e38, device=cuda)
        w = traversal_work(tables, o.contiguous(), d.contiguous(), far)
        assert w.shape == (W * H, 5)
        nodes, slots = w[:, 0].long(), w[:, 4].long()
        assert (nodes >= 1).all() and (slots >= 2 * nodes).all()
        assert (slots <= width * nodes).all()
        assert walk_flops(w) == float(slots.sum() * 25 + w[:, 1].long().sum() * 54)
        eff = simt_efficiency(w)
        assert 0.0 < eff["node_body"] <= 1.0 and 0.0 < eff["triangle_body"] <= 1.0
        none = traversal_work(tables, o.contiguous(), d.contiguous(), torch.zeros_like(far))
        assert int(none.sum()) == 0
        work[width] = w
    assert int(work[8][:, 0].sum()) < int(work[4][:, 0].sum())


@pytest.mark.cuda
def test_children_ahead_adds_up_to_the_width8_visits(cuda):
    """children_ahead's visits by children ahead add up to traversal_work's
    node visits at width 8, closest and any hit (the any-hit walk on shadow
    rays from the camera hits, its mask the plain any-hit's); width-4 tables
    are refused."""
    from gpu_raytracer_tpu_torch.config import RaytracerConfig
    from gpu_raytracer_tpu_torch.ops.cuda.traverse import children_ahead, traversal_work

    W, H = 96, 64
    scene = make_courtyard_scene(2000, seed=1, config=RaytracerConfig(bvh_width=8), device=cuda)
    tables = pack_trace_tables(scene)
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.int32, device=cuda),
                            torch.arange(W, dtype=torch.int32, device=cuda), indexing="ij")
    o, d = generate_rays(scene.camera, W, H, xs.reshape(-1), ys.reshape(-1))
    o, d = o.contiguous(), d.contiguous()
    far = torch.full((W * H,), 3.4028234663852886e38, device=cuda)
    t, _, h, n, _ = traverse(tables, o, d, far)
    cases = [(o, d, far, False)] + [
        (*light_shadow_rays(scene, o, d, t, h, n, W * H, directional=k == 1), True)
        for k in range(2)]
    for ro, rd, rm, any_hit in cases:
        ahead = children_ahead(tables, ro, rd, rm, any_hit=any_hit)
        work = traversal_work(tables, ro, rd, rm, any_hit=any_hit)
        assert ahead.shape == (9,) and int(ahead.sum()) == int(work[:, 0].long().sum()) > 0
        if any_hit:
            blocked = traverse(tables, ro, rd, rm, any_hit=True)[2]
            assert torch.equal(blocked, traverse_triangles(scene, ro, rd, rm, any_hit=True)[2])
    with pytest.raises(ValueError):
        narrow = pack_trace_tables(make_courtyard_scene(2000, seed=1, device=cuda))
        children_ahead(narrow, o, d, far)


# ---- K1's unordered walk and the multi-device layer ----

@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_traverse_threaded_kernel_matches_plain(cuda, name, any_hit, monkeypatch):
    """K1 unordered against the plain threaded walk on the card: every
    output equal, bit for bit; the wrapper launches the kernel, once, and
    never the plain walk."""
    from gpu_raytracer_tpu_torch.ops.bvh_traverse import bvh_traverse_threaded
    from gpu_raytracer_tpu_torch.ops.cuda import traverse as k1
    from gpu_raytracer_tpu_torch.ops.trace import slot_attributes

    scene = SCENES[name](device=cuda)
    tt = k1.pack_threaded_tables(scene)
    # 32-byte records; the lean box test allowed
    assert tt.nodes.shape[1] == 8 and tt.nodes.data_ptr() % 32 == 0 and tt.lean
    rng = np.random.default_rng(7)
    n = 8192
    # from random points toward jittered triangle centroids of the scene
    v0, e1, e2 = (x.cpu().numpy() for x in (scene.tri_v0, scene.tri_e1, scene.tri_e2))
    real = np.nonzero(np.abs(e1).sum(1) > 0)[0]
    pick = real[rng.integers(0, real.shape[0], n)]
    target = v0[pick] + (e1[pick] + e2[pick]) / 3.0 + rng.uniform(-0.2, 0.2, (n, 3))
    src = rng.uniform(-20, 20, (n, 3))
    d = (target - src) / np.linalg.norm(target - src, axis=1, keepdims=True)
    o = torch.from_numpy(src.astype(np.float32)).to(cuda)
    d = torch.from_numpy(d.astype(np.float32)).to(cuda)
    mt = torch.full((n,), 30.0 if any_hit else 3.4028234663852886e38, device=cuda)
    t, slot, hit = bvh_traverse_threaded(scene.bvh, scene.tri_v0, scene.tri_e1, scene.tri_e2,
                                         o, d, mt, leaf_size=scene.bvh.max_leaf,
                                         any_hit=any_hit)
    want = (t, slot, hit) + slot_attributes(scene, slot, hit)

    def refuse(*a, **kw):
        raise AssertionError("the plain threaded walk ran for a CUDA tensor")

    monkeypatch.setattr(k1, "bvh_traverse_threaded", refuse)
    before = LAUNCHES["k1_threaded"]
    got = k1.traverse_threaded(tt, o, d, mt, any_hit=any_hit)
    torch.cuda.synchronize()
    assert LAUNCHES["k1_threaded"] == before + 1
    assert int(hit.sum()) > 100
    for g, w in zip(got, want):
        assert torch.equal(g if g.dtype != torch.int32 else g.long(), w)
    # the counting instance: the same outputs, and, closest hit on a tree of
    # more than one leaf, lanes that walked past a pending leaf while others
    # of their warp still looked for one
    past = torch.full((n,), -1, dtype=torch.int32, device=cuda)
    counted = k1.traverse_threaded(tt, o, d, mt, any_hit=any_hit, past=past)
    for g, w in zip(counted, want):
        assert torch.equal(g if g.dtype != torch.int32 else g.long(), w)
    assert int(past.min()) >= 0
    assert any_hit or scene.bvh.num_nodes == 1 or int(past.sum()) > 0


@pytest.mark.cuda
def test_sharded_paths_launch_their_kernels_never_the_plain_versions(cuda, monkeypatch):
    """Every parallel/shard.py path on a virtual mesh of 4 shards of the
    card: one launch of its kernel per shard (K2; K3 + K4; K1; K1 per shard
    and hop in the ring; K6 five times per shard), no plain version, and
    the single-device result: frames and the step's counts equal, the step
    within 1e-5, the traces as chip_smoke.py phase 25 holds them."""
    from chip_smoke import hold_sharded_hit

    from gpu_raytracer_tpu_torch.engine import renderer as renderer_mod
    from gpu_raytracer_tpu_torch.ops import shading
    from gpu_raytracer_tpu_torch.ops import trace as plain
    from gpu_raytracer_tpu_torch.ops.cuda import bounce as bounce_mod
    from gpu_raytracer_tpu_torch.ops.cuda import render as render_mod
    from gpu_raytracer_tpu_torch.ops.cuda import texshade as texshade_mod
    from gpu_raytracer_tpu_torch.parallel import shard
    from gpu_raytracer_tpu_torch.parallel.mesh import make_mesh

    D, W, H = 4, 128, 96
    scene = make_courtyard_scene(2000, seed=1, device=cuda)
    tscene = make_courtyard_scene(2000, seed=1, textured=True, device=cuda)
    mesh = make_mesh(D, device=cuda)
    frames = {s: Renderer(scene, W, H, shadows=s, device=cuda).render() for s in (False, True)}
    tframe = Renderer(tscene, W, H, device=cuda).render()
    tables = pack_render_tables(scene)
    r = Renderer(scene, W, H, device=cuda)
    o, d = generate_rays(scene.camera, W, H, r.px, r.py)
    single = trace(tables.trace, o.contiguous(), d.contiguous())
    flat = shading.shade(scene, single)
    pt = PathTracer(scene, 64, 64, device=cuda)
    pt.step()
    rt, trt = shard.replicate_tables(mesh, scene), shard.replicate_tables(mesh, tscene)
    st = shard.replicate_tables(mesh, tscene, pack_shade_tables)
    bt = shard.replicate_tables(mesh, scene, pack_bounce_tables)
    shards = shard.GeometryShards(scene, mesh)

    def refuse(*a, **kw):
        raise AssertionError("a plain version ran on the card")

    for mod, name in ((plain, "bvh_traverse_threaded"), (plain, "_triangles_brute"),
                      (renderer_mod, "render_chunk"), (render_mod, "render_chunk"),
                      (render_mod, "render_gbuffer"), (texshade_mod, "shade_deferred"),
                      (bounce_mod, "bounce_")):
        monkeypatch.setattr(mod, name, refuse)

    def launched(want, fn):
        LAUNCHES.clear()
        out = fn()
        torch.cuda.synchronize()
        assert LAUNCHES == Counter(want)
        return out

    for s in (False, True):
        fb = launched(dict(k2=D), lambda: shard.render_frame_fused_multichip(rt, W, H, mesh,
                                                                             shadows=s))
        assert np.array_equal(fb, frames[s])
    fb = launched(dict(k3=D, k3_pre=D, k4=D), lambda: shard.render_frame_fused_multichip(
        trt, W, H, mesh, shade_tables=st))
    assert np.array_equal(fb, tframe)
    rgb = launched(dict(k1_standalone=D), lambda: shard.render_rays_sharded(
        rt, r.px, r.py, W, H, mesh))
    assert torch.equal(rgb, flat)
    for fn, k in ((shard.trace_geometry_sharded, D), (shard.trace_geometry_sharded_ring, D * D)):
        hit = launched(dict(k1_standalone=k), lambda: fn(scene, o, d, mesh, shards))
        hold_sharded_hit(hit, single, scene)
    acc, counts = launched(dict(k6=5 * D), lambda: shard.pathtrace_step_sharded(
        bt, torch.zeros_like(pt.accum), 0, pt._px, pt._py, mesh, width=64, height=64,
        qmc_seed=pt._qmc_seed))
    assert (acc - pt.accum).abs().max().item() <= 1e-5
    assert torch.equal(counts, pt._last_counts)
