"""The courtyard at half a million triangles, the smallest whose wide tree
(11 levels at width 4) takes the kernels' 64-entry traversal stack: 3 x 11
+ 1 = 34 entries do not fit the 32-entry instances every smaller courtyard
runs. The scene is the benchmark's (benchmark/scenes.py), made into the
program's scene as the benchmark's harness makes it (`program_scene`).

  * the walk (csrc/traverse.cuh), built for the host as
    tests/test_torch_walk_host.py builds it, over the tables'
    64-entry instance: closest hit and any hit bit for bit the plain
    `traverse_triangles`, on seeded camera rays, seeded rays inside the
    courtyard and the shadow rays of the camera hits toward both lights;
  * the deepest stack the walk reaches (Work::deepest, its counting
    instance) within `stack_capacity`;
  * the port's CPU Viewer frame at 96 x 54 with shadows, after seeded
    camera inputs, against the benchmark's plain reference
    (benchmark/reference.py: its own SAH tree, nothing of the program) at
    seeded pixels, within the limits of the orbit-1080p mix's check.

Run with -s for the walk's visits and deepest stack."""

import numpy as np
import pytest
import torch

from benchmark import checks, generator, reference, scenes
from benchmark.drivers.common import program_config, program_scene
from benchmark.run import BENCH, load_json
from gpu_raytracer_tpu_torch.engine.viewer import Viewer
from gpu_raytracer_tpu_torch.ops.camera_rays import generate_rays
from gpu_raytracer_tpu_torch.ops.cuda.traverse import pack_trace_tables, stack_capacity
from gpu_raytracer_tpu_torch.ops.trace import traverse_triangles
from test_torch_walk_host import F32_MAX, walk, walk_deepest, walk_host  # noqa: F401

TRIANGLES = 500_000
SEED = 2 ** 31 + 2021           # the run seed the camera inputs and pixels are drawn from
CAMERA_RAYS = 2048              # seeded pixels of a 1920 x 1080 frame
INSIDE_RAYS = 2048              # seeded rays from inside the courtyard
FRAME = (96, 54)
INPUTS = 5                      # camera inputs before the compared frame


@pytest.fixture(scope="module")
def deep():
    """(configuration, inputs, program scene, trace tables) of the 500k
    courtyard with courtyard-100k's program settings."""
    config = load_json(BENCH, "configs", "courtyard-100k.json")
    s = config["scene"]
    inputs = scenes.courtyard(TRIANGLES, seed=generator.scene_seed(SEED), lights=s["lights"],
                              textured=False)
    scene = program_scene(inputs, program_config(config), "cpu")
    return config, inputs, scene, pack_trace_tables(scene)


def test_the_tables_take_the_64_entry_stack(deep):
    tables = deep[3]
    assert tables.width == 4 and tables.depth == 11
    assert 3 * tables.depth + 1 > 32 and tables.stack == stack_capacity(tables.depth) == 64


def seeded_rays(scene, extent):
    """Camera rays through seeded pixels of a 1080p frame, then seeded rays
    from inside the courtyard (0.2-4 m up, any direction, 50 of them level:
    the slab test's NaN-checking branch)."""
    rng = np.random.default_rng(generator.torch_seed(SEED, generator.PIXELS))
    px = torch.from_numpy(rng.integers(0, 1920, CAMERA_RAYS).astype(np.int32))
    py = torch.from_numpy(rng.integers(0, 1080, CAMERA_RAYS).astype(np.int32))
    o, d = generate_rays(scene.camera, 1920, 1080, px, py)
    ro = rng.uniform(-0.9 * extent, 0.9 * extent, (INSIDE_RAYS, 3))
    ro[:, 1] = rng.uniform(0.2, 4.0, INSIDE_RAYS)
    rd = rng.normal(size=(INSIDE_RAYS, 3))
    rd[:50, 1] = 0.0
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    o = torch.cat([o, torch.from_numpy(ro.astype(np.float32))]).contiguous()
    d = torch.cat([d, torch.from_numpy(rd.astype(np.float32))]).contiguous()
    return o, d


def shadow_rays(scene, o, d):
    """The shadow rays of every camera-ray hit toward both lights (the
    directional one unbounded, the point one up to 1e-3 short of it)."""
    from torch_scenes import light_shadow_rays

    far = torch.full((o.shape[0],), F32_MAX)
    t, _, h, n, _ = traverse_triangles(scene, o, d, far)
    rays = [light_shadow_rays(scene, o, d, t, h, n, o.shape[0], directional=directional)
            for directional in (True, False)]
    return tuple(torch.cat(parts).contiguous() for parts in zip(*rays))


@pytest.fixture(scope="module")
def walks(deep):
    """The walks to hold: closest hit of the seeded rays, any hit of the
    shadow rays -> {name: (origins, directions, max_t, any_hit)}."""
    _, inputs, scene, _ = deep
    o, d = seeded_rays(scene, inputs.extent)
    so, sd, smax = shadow_rays(scene, o[:CAMERA_RAYS], d[:CAMERA_RAYS])
    return {"closest": (o, d, torch.full((o.shape[0],), F32_MAX), False),
            "any": (so, sd, smax, True)}


def test_64_entry_walk_matches_the_plain_traversal(walk_host, deep, walks):  # noqa: F811
    _, _, scene, tables = deep
    for name, (ro, rd, rm, any_hit) in walks.items():
        t, slot, nodes, tris, _ = walk(walk_host, tables, ro, rd, rm, any_hit)
        pt, ps, ph, _, _ = traverse_triangles(scene, ro, rd, rm, any_hit=any_hit)
        hit = slot >= 0
        assert 0 < hit.sum() < hit.shape[0]
        assert np.array_equal(hit, ph.numpy())
        if not any_hit:
            assert np.array_equal(t[hit].view(np.int32), pt.numpy()[hit].view(np.int32))
            assert np.array_equal(slot[hit], ps.numpy()[hit])
        print(f"{name}: {ro.shape[0]} rays, {hit.mean():.3f} hit, {nodes.mean():.1f} nodes and "
              f"{tris.mean():.1f} triangles a ray, deepest stack {walk_deepest(walk_host).max()}")


def test_deepest_stack_stays_within_the_capacity(walk_host, deep, walks):  # noqa: F811
    """Work::deepest, the most entries a ray's stack held, over both kinds
    of walk: within (w - 1) x depth + 1 and the instance's capacity."""
    tables = deep[3]
    bound = (tables.width - 1) * tables.depth + 1
    deepest = 0
    for ro, rd, rm, any_hit in walks.values():
        walk(walk_host, tables, ro, rd, rm, any_hit)
        got = walk_deepest(walk_host)
        assert got.shape == (ro.shape[0],) and (got >= 0).all()
        deepest = max(deepest, int(got.max()))
    assert 0 < deepest <= bound <= tables.stack
    print(f"deepest stack {deepest} of {bound} bound, capacity {tables.stack}")


def test_cpu_viewer_frame_matches_the_reference(deep):
    """The Viewer's plain CPU frame after seeded camera inputs, against the
    reference's Whitted frame at seeded pixels, by the orbit-1080p check's
    numbers and limits."""
    config, inputs, scene, _ = deep
    mix = load_json(BENCH, "traffic", "orbit-1080p.json")
    W, H = FRAME
    p = config["program"]
    events = generator.CameraInputs(SEED, inputs.camera_position, inputs.camera_direction,
                                    inputs.extent, mix, p["camera_move_speed"],
                                    p["camera_rotate_sensitivity"])
    v = Viewer(scene, W, H, config=program_config(config), shadows=config["shadows"],
               verbose=False, device="cpu")
    ctl = reference.Controller(reference.start_camera(inputs.camera_position,
                                                      inputs.camera_direction, inputs.fov),
                               p["camera_move_speed"], p["camera_rotate_sensitivity"])
    for i in range(INPUTS):
        ev = events[i]
        if ev[0] == "drag":
            v.handle_mouse_drag(ev[1], ev[2])
        else:
            v.handle_key(ev[1])
        ctl.apply(ev)
    while v.run_compute():
        pass
    frame = v.framebuffer
    px, py = generator.pick_pixels(SEED, generator.PIXELS, 2048, W, H)
    rs = reference.ref_scene(inputs, "cpu", width=p["bvh_width"], leaf=p["bvh_leaf_size"])
    cam = ctl.state()
    o, d = reference.camera_rays(cam, W, H, torch.as_tensor(px), torch.as_tensor(py))
    ref = reference.whitted(rs, o.contiguous(), d.contiguous(), config["shadows"],
                            reference.Work(), reference.pixel_scale(cam, H))
    assert (ref.abs().sum(dim=1) > 0).float().mean() > 0.5      # the frame looks at the scene
    nums = checks.compare_frames({0: frame[py, px]}, {0: ref.numpy()}, mix, u8=False)
    nums.pop("frames")
    ok, rows = checks.judge(nums, mix["limits"])
    print(rows)
    assert ok, rows
