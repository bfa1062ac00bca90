#!/usr/bin/env python3
"""A/B timing of the traversing kernels on one GPU: two trees of this
repository, or one tree built with different compile-time settings, measured
in turn inside one run so that they share a card.

    python3 chip_ab.py --parent build/parent                # parent, change, change, parent
    python3 chip_ab.py --variants "RT_SAMPLER_OFF=1" "RT_RENDER_MIN_BLOCKS=8 RT_RENDER_BLOCK=64"
    python3 chip_ab.py --variants "kShadeMinBlocks=12"      # a csrc constant rewritten
    python3 chip_ab.py --one [--root DIR] [--defines "A=1 B=2"]   # one measurement, one JSON line
    python3 chip_ab.py --sass                               # SASS size of K1's, K3's loops (widths 4, 8)
    python3 chip_ab.py --parent build/parent --k3           # K3's readings alone (below)
    python3 chip_ab.py --parent build/parent --w8           # the width-8 readings alone (below)
    python3 chip_ab.py --w8 --variants "kRenderMinBlocksW8=5"   # width 8's caps, orders
    python3 chip_ab.py --w8-frames --variants "kPrimaryNearAnyW8=0"   # K2 w8, K2t w8 alone
    python3 chip_ab.py --parent build/parent --k2t --threaded   # K2t width 4, K1 unordered

Unpack the other tree first (`git archive <commit> | tar -x -C build/parent`;
build/ is git-ignored). Every measurement is its own process, run from this
file but importing the package and chip_smoke.py of its `--root`, with the
given `-D` settings appended to the kernels' nvcc flags (csrc/traverse.cuh
names them). A variant's setting `kName=VALUE` instead rewrites the one
`constexpr int kName = ...;` of csrc/ in a copy of this tree under
build/variants/ (git-ignored) and measures that copy. Each prints one JSON line: the card, the settings, ptxas's
registers and spills, and median milliseconds (`chip_smoke.timed`, CUDA
events) on the 100k-triangle courtyard:
  K1 on the 1920x1080 camera rays; K2 (render_primary) shadows off and on;
  K3 (render_deferred) on the textured courtyard; each in the row-major tile
  order and, where the tree has it, the 8 x 4 warp order;
  PathTracer.step() at 1024x1024 with K6's device time, the device's busy
  time and the host's enqueue time per sample (torch.profiler);
and the texture sampler, on the textured courtyard (4096-texel floor map)
and on the procedural multi-slot zoo (60k triangles, 48 materials, four map
kinds), 1920x1080 in the warp order:
  K4 (texture_shade) on K3's G-buffer, nearest and trilinear; on the
  courtyard also K4 with no map slot sampled (`present` 0) and a copy of the
  G-buffer's light sums into an RGB buffer (K4's bytes without its work);
  K2t (render_primary with the shade tables) shadows off and on, beside
  K3 + K4 on the same frames; K5 (sample_materials) on the courtyard's
  1024x1024 camera-ray hits; PathTracer.step() with K6's device time; and
  one K6 launch on the main path's depth-0 and depth-1 pools (made by the
  plain bounce, so the same pools under every build), each launch on a
  fresh copy; PathTracer.step() on the textured courtyard with one light,
  whose K6 launches are the all-lights (NEE_ALL) instances, with K6's
  device time. Beside the event times (`k4_...`) the sampler's kernels are
  also read by their own device time (`..._device`, torch.profiler): K4
  and K5 run for less than their wrappers' host time.
`RT_SAMPLER_OFF=1` (csrc/texsample.cuh) builds every kernel with its map
slots read as absent: the same launches without the sampler.
K3 (render_deferred) at node widths 4 and 8 on the textured courtyard, 1920x1080
in the warp order, by device time (torch.profiler, the L2 flushed before each
call), shadows off and on: K3 alone, K3 with its pre-pass (camera_relative,
where the tree has one), the pre-pass alone, the textured frame (pre-pass, K3,
K4); and the textured Viewer's camera-moving frame with shadows (phase 21's
reading): ms pipelined, device time and host enqueue. `--k3` measures only
these (and the SASS digest and registers), for a quicker A/B of K3.
`--w8` measures only the width-8 readings on the 100k courtyard (and the
SASS digest, registers), by device time (torch.profiler, the L2 flushed
before each call): K1 w8 on the 1920x1080 camera rays (closest hit) and on
phase 3's 262,144 shadow rays toward the point light and as many toward the
directional light (any hit), with node visits and triangle tests a ray
(`traversal_work`) and the rays blocked; K2 w8 and K2t w8 shadows off and
on, alone and, where the tree launches it before them, with K3's pre-pass;
K3 w8 with its pre-pass, shadows off and on; K6 w8 per sample of
PathTracer.step() at 1024x1024, untextured and textured, and one K6 w8
launch on the main path's depth-0 and depth-1 pools; width 4's K1, K2 and
K6 per sample as the control; ptxas's registers and spills of every
width-8 instance; the SASS size of K1's closest-hit and any-hit loops at
both widths, and of K3 w8's, K2 w8's and K2t w8's loops (`sass_loops`); and,
where the tree counts them
(`children_ahead`), the width-8 visits by children ahead on the camera rays,
both lights' shadow rays and the depth-0 and depth-1 pools. `--w8-frames`
measures only the frame kernels' part of it (K2 w8, K2t w8, K3 w8 with its
pre-pass, width 4's K2; registers, SASS loops, digests), for a quicker
sweep of K2 w8's and K2t w8's settings.
`--k2t` measures only K2t at node width 4 (`measure_k2t`: the textured and the
GLB-loaded courtyard, alone, with K3's pre-pass, beside pre-pass + K3 + K4),
`--threaded` only K1's unordered walk (`measure_threaded`: camera rays closest
hit, phase 24's shadow rays any hit); either adds `sass_loops` and a digest of
every kernel of every object (`sass_all`), and the summary names the kernels
whose SASS differs between the builds.
Every line also holds a digest of the SASS of each width-4 K1, K2, K2t and K6
instance (`sass_digest`); the summary says whether they are identical in
every build.
With `--out FILE` every line is also appended to FILE.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import re
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def _here_smoke():
    """This tree's chip_smoke.py under another name: its timing helpers, for
    a measurement of any tree (the tree's own chip_smoke may predate them)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


HERE_SMOKE = _here_smoke()
WIDTH, HEIGHT, PT_SIZE = 1920, 1080, 1024
TEXTURE_SIZE = 4096            # the textured courtyard's floor map (chip_smoke.py)
LAUNCHES, REPEATS = 32, 3      # launches per median, medians per reading
PT_STEPS = 8
K6_LAUNCHES = 24               # single K6 launches on fresh pool copies, 3 medians of 8


def measure_k3(out: dict, device, width: int = WIDTH, height: int = HEIGHT) -> None:
    """K3's readings (the module docstring) into `out`, for the tree on
    sys.path: its render module may have no pre-pass (a tree before it)."""
    import itertools

    import torch

    from gpu_raytracer_tpu_torch.config import RaytracerConfig
    from gpu_raytracer_tpu_torch.engine.renderer import tiled_pixel_order
    from gpu_raytracer_tpu_torch.engine.viewer import Viewer
    from gpu_raytracer_tpu_torch.ops.cuda import render as render_mod
    from gpu_raytracer_tpu_torch.ops.cuda.texshade import pack_shade_tables, texture_shade
    from gpu_raytracer_tpu_torch.utils.procgen import make_courtyard_scene

    pre = hasattr(render_mod, "camera_relative")
    k3_words = ("render_deferred_kernel",) + (("camera_relative_kernel",) if pre else ())
    px, py = (torch.from_numpy(a).to(device)
              for a in tiled_pixel_order(width, height, warp=(8, 4)))

    def device_reading(fn, words):
        return [HERE_SMOKE.kernel_device_ms(fn, words, LAUNCHES, device) for _ in range(REPEATS)]

    for w in (4, 8):
        scene = make_courtyard_scene(100_000, seed=0, textured=True, texture_size=TEXTURE_SIZE,
                                     config=RaytracerConfig(bvh_width=w), device=device)
        tables, shade = render_mod.pack_render_tables(scene), pack_shade_tables(scene)
        for shadows in (False, True):
            key = f"k3w{w}_{'shadows' if shadows else 'no_shadows'}"
            k3 = lambda: render_mod.render_deferred(tables, px, py, width, height,
                                                    shadows=shadows)
            out[f"{key}_device"] = device_reading(k3, "render_deferred_kernel")
            out[f"{key}_and_pre_pass_device"] = device_reading(k3, k3_words)
            frame = lambda: texture_shade(shade, k3())
            out[f"{key}_frame_device"] = device_reading(frame, k3_words + ("texshade_kernel",))
        if pre:
            out[f"k3w{w}_pre_pass_device"] = device_reading(
                lambda: render_mod.camera_relative(tables), "camera_relative_kernel")
        del tables, shade
        if w == 4:   # the textured Viewer, camera moving, with shadows (phase 21)
            v = Viewer(scene, width, height, shadows=True, verbose=False, device=device)
            v.run_compute()
            keys = itertools.cycle("ws")

            def move_frame():
                v.handle_key(next(keys))
                v.run_compute()

            move_frame()
            out["viewer_textured_ms_per_frame"] = [
                HERE_SMOKE.pipelined_ms(move_frame, HERE_SMOKE.VIEWER_FRAMES, device)
                for _ in range(REPEATS)]
            prof = [HERE_SMOKE.device_profile(move_frame, HERE_SMOKE.VIEWER_FRAMES, device)
                    for _ in range(REPEATS)]
            out["viewer_textured_device_ms"] = [p["device_ms"] for p in prof]
            out["viewer_textured_host_enqueue_ms"] = [p["host_enqueue_ms"] for p in prof]
            del v
        del scene


SHADOW_RAYS = 262_144          # phase 3's shadow rays, per light


def pre_pass_before_k2(tables, px, py, shade=None) -> bool:
    """Whether the tree on sys.path launches K3's pre-pass (camera_relative)
    before the fused render of these tables (one call, its calls of the
    pre-pass's wrapper recorded)."""
    from gpu_raytracer_tpu_torch.ops.cuda import render as render_mod

    pre = getattr(render_mod, "camera_relative", None)
    if pre is None:
        return False
    calls = []
    render_mod.camera_relative = lambda t: calls.append(t) or pre(t)
    try:
        render_mod.render_primary(tables, px, py, 64, 64, shade=shade)
    finally:
        render_mod.camera_relative = pre
    return bool(calls)


def measure_w8(out: dict, device, ptxas: dict, width: int = WIDTH, height: int = HEIGHT,
               frames_only: bool = False) -> None:
    """The width-8 readings (the module docstring) into `out`, for the tree
    on sys.path, by device time (torch.profiler, the L2 flushed before each
    call); width 4's K1, K2 and K6 beside them as the control. The visits
    by children ahead where the tree counts them (children_ahead).
    `frames_only`: the frame kernels' readings alone (K2 w8, K2t w8, K3 w8
    with its pre-pass, width 4's K2), without K1's and K6's."""
    import torch

    from gpu_raytracer_tpu_torch.config import RaytracerConfig
    from gpu_raytracer_tpu_torch.engine.pathtracer import PathTracer
    from gpu_raytracer_tpu_torch.engine.renderer import tiled_pixel_order
    from gpu_raytracer_tpu_torch.ops.cuda import render as render_mod
    from gpu_raytracer_tpu_torch.ops.cuda.render import (pack_render_tables, render_deferred,
                                                         render_primary)
    from gpu_raytracer_tpu_torch.ops.cuda.texshade import pack_shade_tables
    from gpu_raytracer_tpu_torch.utils.procgen import make_courtyard_scene

    px, py = (torch.from_numpy(a).to(device)
              for a in tiled_pixel_order(width, height, warp=(8, 4)))

    def device_reading(fn, words):
        return [HERE_SMOKE.kernel_device_ms(fn, words, LAUNCHES, device) for _ in range(REPEATS)]

    for w in (8, 4):
        cfg = RaytracerConfig(bvh_width=w)
        scene = make_courtyard_scene(100_000, seed=0, config=cfg, device=device)
        tables = pack_render_tables(scene)
        tr = tables.trace
        if w == 8:
            out["ptxas_w8"] = {k: v for k, v in ptxas.items()
                               if re.search(rf"<8, {tr.stack}[,>]", k)}
            out["w8_registers"] = HERE_SMOKE.w8_registers(ptxas)
        k2_words = ("render_primary_kernel",) + (("camera_relative_kernel",)
                                                 if pre_pass_before_k2(tables, px, py) else ())
        for shadows in (False, True):
            s = "shadows" if shadows else "no_shadows"
            k2 = lambda: render_primary(tables, px, py, width, height, shadows=shadows)
            out[f"k2w{w}_{s}_device"] = device_reading(k2, "render_primary_kernel")
            if len(k2_words) > 1:   # the tree launches K3's pre-pass before K2 w8
                out[f"k2w{w}_{s}_and_pre_pass_device"] = device_reading(k2, k2_words)
        if not frames_only:
            measure_w8_walks(out, device, scene, tables, width, height, px, py)
        del tables, scene
        if w == 4:
            continue
        # the textured courtyard: K2t, K3 with its pre-pass, textured K6
        tscene = make_courtyard_scene(100_000, seed=0, textured=True, texture_size=TEXTURE_SIZE,
                                      config=cfg, device=device)
        ttables, shade = pack_render_tables(tscene), pack_shade_tables(tscene)
        k3_words = ("render_deferred_kernel",) + (
            ("camera_relative_kernel",) if hasattr(render_mod, "camera_relative") else ())
        k2t_pre = pre_pass_before_k2(ttables, px, py, shade)
        for shadows in (False, True):
            s = "shadows" if shadows else "no_shadows"
            k2t = lambda: render_primary(ttables, px, py, width, height, shadows=shadows,
                                         shade=shade)
            out[f"k2tw8_{s}_device"] = device_reading(k2t, "render_primary_kernel")
            if k2t_pre:
                out[f"k2tw8_{s}_and_pre_pass_device"] = device_reading(
                    k2t, ("render_primary_kernel", "camera_relative_kernel"))
            out[f"k3w8_{s}_and_pre_pass_device"] = device_reading(
                lambda: render_deferred(ttables, px, py, width, height, shadows=shadows),
                k3_words)
        if not frames_only:
            pt = PathTracer(tscene, PT_SIZE, PT_SIZE, device=device)
            for _ in range(3):
                pt.step()
            prof = [HERE_SMOKE.device_profile(pt.step, PT_STEPS, device)
                    for _ in range(REPEATS)]
            out["k6w8_textured_device_ms_per_spp"] = [p["k6_device_ms"] for p in prof]
            del pt
        del ttables, shade, tscene


def measure_w8_walks(out: dict, device, scene, tables, width: int, height: int, px,
                     py) -> None:
    """measure_w8's readings of K1 and K6 at the tables' node width on the
    untextured courtyard: K1 on the camera rays and on both lights' shadow
    rays with their visits and tests, the visits by children ahead (width
    8, where the tree counts them), K6 a sample and, at width 8, one K6
    launch on the depth-0 and depth-1 pools."""
    import hashlib

    import torch

    from gpu_raytracer_tpu_torch.engine.pathtracer import PathTracer
    from gpu_raytracer_tpu_torch.ops.cuda import traverse as traverse_mod
    from gpu_raytracer_tpu_torch.ops.cuda.bounce import fused_bounce_, pack_bounce_tables

    traverse = traverse_mod.traverse
    ahead = getattr(traverse_mod, "children_ahead", None)
    tr = tables.trace
    w = tr.width

    def device_reading(fn, words):
        return [HERE_SMOKE.kernel_device_ms(fn, words, LAUNCHES, device) for _ in range(REPEATS)]

    def per_ray(work):
        wk = work.double().mean(dim=0).tolist()
        return dict(nodes=wk[0], tris=wk[1])

    o, d = HERE_SMOKE.primary_rays(scene, width, height, px, py)
    far = torch.full((o.shape[0],), HERE_SMOKE.F32_MAX, device=device)
    key = f"k1w{w}"
    out[f"{key}_camera_device"] = device_reading(lambda: traverse(tr, o, d, far),
                                                 "traverse_kernel")
    work = {"camera": traverse_mod.traversal_work(tr, o, d, far)}
    t, _, h, n, _ = traverse(tr, o, d, far)
    rays = {"camera": (o, d, far, False)}
    for light in ("point", "directional"):
        so, sd, smax = HERE_SMOKE.light_shadow_rays(scene, o, d, t, h, n, SHADOW_RAYS,
                                                    directional=light == "directional")
        rays[f"shadow_{light}"] = (so, sd, smax, True)
        out[f"{key}_shadow_{light}_device"] = device_reading(
            lambda: traverse(tr, so, sd, smax, any_hit=True), "traverse_kernel")
        work[f"shadow_{light}"] = traverse_mod.traversal_work(tr, so, sd, smax, any_hit=True)
        out[f"{key}_shadow_{light}_blocked"] = int(traverse(tr, so, sd, smax,
                                                            any_hit=True)[2].sum())
    out[f"{key}_per_ray"] = {k: per_ray(v) for k, v in work.items()}
    # every camera ray's visits, tests and live slots (not the warp-led
    # counts, which depend on timing): equal digests, the same walk
    out[f"{key}_camera_work_digest"] = hashlib.sha256(
        work["camera"][:, [0, 1, 4]].cpu().numpy().tobytes()).hexdigest()[:16]
    if w == 8 and ahead is not None:
        out["children_ahead_w8"] = {k: ahead(tr, ro, rd, rm, any_hit=a).tolist()
                                    for k, (ro, rd, rm, a) in rays.items()}
    pt = PathTracer(scene, PT_SIZE, PT_SIZE, device=device)
    for _ in range(3):
        pt.step()
    prof = [HERE_SMOKE.device_profile(pt.step, PT_STEPS, device) for _ in range(REPEATS)]
    out[f"k6w{w}_device_ms_per_spp"] = [p["k6_device_ms"] for p in prof]
    del pt
    if w == 4:
        return
    btab = pack_bounce_tables(scene)
    for depth, pool, order, n_live, qmc, flags in HERE_SMOKE.pools(btab, PT_SIZE, PT_SIZE,
                                                                  (0, 1)):
        rad = torch.zeros((pool.count, 3), dtype=torch.float32, device=device)
        out[f"k6w8_depth{depth}_device"] = device_reading(
            lambda: fused_bounce_(btab, pool.clone(), rad, depth=depth, order=order,
                                  n_live=n_live, qmc=qmc, **flags), "bounce_kernel")
        if ahead is not None:
            live = pool.active
            out["children_ahead_w8"][f"k6_depth{depth}"] = ahead(
                tr, pool.origin[live].contiguous(), pool.direction[live].contiguous(),
                torch.full((int(live.sum()),), HERE_SMOKE.F32_MAX, device=device)).tolist()
        del pool, rad


def measure_k2t(out: dict, device, ptxas: dict, width: int = WIDTH,
                height: int = HEIGHT) -> None:
    """`--k2t`: K2t at node width 4 on the 100k textured courtyard and on
    the same courtyard through the GLB writer and loader, 1920x1080 in the
    warp order, shadows off and on, by device time (torch.profiler, the L2
    flushed before each call): K2t alone, K2t with K3's pre-pass where the
    tree launches it first, and the pre-pass + K3 + K4 of the same frames
    (the Renderer's textured path); ptxas of the width-4 K2t instances."""
    import tempfile

    import torch

    from gpu_raytracer_tpu_torch.engine.renderer import tiled_pixel_order
    from gpu_raytracer_tpu_torch.ops.cuda import render as render_mod
    from gpu_raytracer_tpu_torch.ops.cuda.render import (pack_render_tables, render_deferred,
                                                         render_primary)
    from gpu_raytracer_tpu_torch.ops.cuda.texshade import pack_shade_tables, texture_shade
    from gpu_raytracer_tpu_torch.utils.procgen import (courtyard_source_images,
                                                       make_courtyard_scene)

    px, py = (torch.from_numpy(a).to(device)
              for a in tiled_pixel_order(width, height, warp=(8, 4)))
    out["ptxas_k2t_w4"] = {k: v for k, v in ptxas.items()
                           if re.fullmatch(r"render_primary_kernel<4, \d+, 1>", k)}
    k3_words = ("render_deferred_kernel",) + (
        ("camera_relative_kernel",) if hasattr(render_mod, "camera_relative") else ())

    def device_reading(fn, words):
        return [HERE_SMOKE.kernel_device_ms(fn, words, LAUNCHES, device) for _ in range(REPEATS)]

    scene = make_courtyard_scene(100_000, seed=0, textured=True, texture_size=TEXTURE_SIZE,
                                 device=device)
    with tempfile.TemporaryDirectory() as tmp:
        glb, _ = HERE_SMOKE.glb_round_trip(scene, courtyard_source_images(0, TEXTURE_SIZE), tmp,
                                           "courtyard", device)
    for label, sc in (("courtyard", scene), ("glb", glb)):
        tables, shade = pack_render_tables(sc), pack_shade_tables(sc)
        pre = pre_pass_before_k2(tables, px, py, shade)
        out[f"k2tw4_{label}_pre_pass"] = pre
        for shadows in (False, True):
            key = f"{label}_{'shadows' if shadows else 'no_shadows'}"
            k2t = lambda: render_primary(tables, px, py, width, height, shadows=shadows,
                                         shade=shade)
            out[f"k2tw4_{key}_device"] = device_reading(k2t, "render_primary_kernel")
            if pre:
                out[f"k2tw4_{key}_and_pre_pass_device"] = device_reading(
                    k2t, ("render_primary_kernel", "camera_relative_kernel"))
            frame = lambda: texture_shade(shade, render_deferred(tables, px, py, width, height,
                                                                 shadows=shadows))
            out[f"k3k4w4_{key}_device"] = device_reading(frame, k3_words + ("texshade_kernel",))
        del tables, shade


def measure_threaded(out: dict, device, ptxas: dict, width: int = WIDTH,
                     height: int = HEIGHT) -> None:
    """`--threaded`: K1's unordered walk on the 100k courtyard by device
    time (torch.profiler, the L2 flushed before each call): closest hit on
    the 1920x1080 camera rays (warp order) and any hit on chip_smoke.py
    phase 24's shadow rays, from every K1 hit toward the point light; the
    plain walk's visits and triangle tests a ray, the rays hit or blocked,
    ptxas of both instances, and, where the tree has the counting instance,
    the rays that walked past a pending leaf and the visits made so
    (`postponed_visits`)."""
    import torch

    from gpu_raytracer_tpu_torch.engine.renderer import tiled_pixel_order
    from gpu_raytracer_tpu_torch.ops.bvh_traverse import bvh_traverse_threaded
    from gpu_raytracer_tpu_torch.ops.cuda.render import pack_render_tables
    from gpu_raytracer_tpu_torch.ops.cuda.traverse import (pack_threaded_tables, traverse,
                                                           traverse_threaded)
    from gpu_raytracer_tpu_torch.ops.linalg import dot
    from gpu_raytracer_tpu_torch.utils.procgen import make_courtyard_scene

    out["ptxas_threaded"] = {k: v for k, v in ptxas.items()
                             if k.startswith("traverse_threaded_kernel")}
    px, py = (torch.from_numpy(a).to(device)
              for a in tiled_pixel_order(width, height, warp=(8, 4)))
    scene = make_courtyard_scene(100_000, seed=0, device=device)
    tr = pack_render_tables(scene).trace
    tt = pack_threaded_tables(scene)
    o, d = HERE_SMOKE.primary_rays(scene, width, height, px, py)
    far = torch.full((o.shape[0],), HERE_SMOKE.F32_MAX, device=device)
    # phase 24's shadow rays: from every K1 hit toward the point light
    t, _, h, n, _ = traverse(tr, o, d, far)
    hit = torch.nonzero(h).squeeze(1)
    L = scene.lights
    p = o[hit] + d[hit] * t[hit, None]
    to_light = L.position[int(torch.nonzero(L.light_type == 1)[0])][None, :] - p
    dist = torch.sqrt(dot(to_light, to_light))
    rays = dict(camera=(o, d, far, False),
                shadow=((p + n[hit] * 1e-3).contiguous(),
                        (to_light / dist[:, None]).contiguous(), (dist - 1e-3).contiguous(),
                        True))
    for key, (ro, rd, rm, any_hit) in rays.items():
        fn = lambda: traverse_threaded(tt, ro, rd, rm, any_hit=any_hit)
        out[f"threaded_{key}_device"] = [HERE_SMOKE.kernel_device_ms(
            fn, "traverse_threaded_kernel", LAUNCHES, device) for _ in range(REPEATS)]
        work = torch.zeros((ro.shape[0], 2), dtype=torch.int64, device=device)
        bvh = scene.bvh
        bvh_traverse_threaded(bvh, scene.tri_v0, scene.tri_e1, scene.tri_e2, ro, rd, rm,
                              leaf_size=bvh.max_leaf, any_hit=any_hit, work=work)
        wk = work.double().mean(dim=0).tolist()
        out[f"threaded_{key}_per_ray"] = dict(rays=int(ro.shape[0]), nodes=wk[0], tris=wk[1],
                                              hits=int(fn()[2].sum()))
        if "past" in inspect.signature(traverse_threaded).parameters:
            # the counting instance: the lanes that walked past a pending leaf
            out[f"threaded_{key}_postponed"] = HERE_SMOKE.postponed_visits(
                tt, ro, rd, rm, any_hit, work)


def measure(root: str, defines: list[str], label: str, k3_only: bool = False,
            w8_only: bool = False, frames_only: bool = False, k2t: bool = False,
            threaded: bool = False) -> dict:
    sys.path.insert(0, root)
    import dataclasses

    import torch

    import chip_smoke as cs
    from gpu_raytracer_tpu_torch.engine.pathtracer import PathTracer
    from gpu_raytracer_tpu_torch.engine.renderer import tiled_pixel_order
    from gpu_raytracer_tpu_torch.ops.cuda import build
    from gpu_raytracer_tpu_torch.ops.cuda.bounce import (fused_bounce_, pack_bounce_tables,
                                                         sample_materials)
    from gpu_raytracer_tpu_torch.ops.cuda.render import (pack_render_tables, render_deferred,
                                                         render_primary)
    from gpu_raytracer_tpu_torch.ops.cuda.texshade import pack_shade_tables, texture_shade
    from gpu_raytracer_tpu_torch.ops.cuda.traverse import traverse
    from gpu_raytracer_tpu_torch.ops.trace import trace
    from gpu_raytracer_tpu_torch.utils.procgen import make_courtyard_scene, make_zoo_scene
    try:   # the plain G-buffer split: ops.render, or engine.renderer in an older tree
        from gpu_raytracer_tpu_torch.ops.render import split_gbuffer
    except ImportError:
        from gpu_raytracer_tpu_torch.engine.renderer import split_gbuffer

    build.NVCC_FLAGS = (*build.NVCC_FLAGS, *(f"-D{d}" for d in defines))
    k = build.load_kernels()
    device = torch.device("cuda", 0)
    out = dict(label=label, root=os.path.relpath(root, HERE), defines=defines,
               card=cs.card_line(), nvcc_s=k.seconds)
    ptxas = HERE_SMOKE.ptxas_summary(k.log)
    out["sass_width4"] = sass_digest(k.path)
    out["ptxas"] = {name: v for name, v in ptxas.items()   # the 32-entry stack instances
                    if re.search(r"<(?:[48], )?32[,>]", name)
                    or name.startswith(("texshade_kernel", "sample_materials_kernel",
                                        "camera_relative_kernel"))}
    if w8_only:
        out["sass_w8_primary"] = sass_digest(k.path, ("render_primary_w8",
                                                      "render_primary_textured_w8"))
        out["sass_w8_other"] = sass_digest(k.path, W8_OTHER_OBJECTS)
        out["sass_loops"] = {k: dict(instructions=v["instructions"],
                                     loops=[lp["instructions"] for lp in v["loops"]])
                             for k, v in sass_loops(root).items()}
        measure_w8(out, device, ptxas, frames_only=frames_only)
        return out
    if k2t or threaded:
        out["sass_all"] = sass_digest(k.path, None, every_function=True)
        out["sass_loops"] = {k: dict(instructions=v["instructions"],
                                     loops=[lp["instructions"] for lp in v["loops"]])
                             for k, v in sass_loops(root).items()}
        if k2t:
            measure_k2t(out, device, ptxas)
        if threaded:
            measure_threaded(out, device, ptxas)
        return out
    measure_k3(out, device)
    if k3_only:
        return out

    def reading(fn):
        return [cs.timed(fn, LAUNCHES, device) for _ in range(REPEATS)]

    def device_reading(fn, words):   # the kernels' own time, with this file's helper
        return [HERE_SMOKE.kernel_device_ms(fn, words, LAUNCHES, device)
                for _ in range(REPEATS)]

    scene = make_courtyard_scene(100_000, seed=0, device=device)
    tables = pack_render_tables(scene)
    tscene = make_courtyard_scene(100_000, seed=0, textured=True, texture_size=TEXTURE_SIZE,
                                  device=device)
    ttables = pack_render_tables(tscene)
    orders = {"rows": tiled_pixel_order(WIDTH, HEIGHT)}
    if "warp" in inspect.signature(tiled_pixel_order).parameters:
        orders["warp8x4"] = tiled_pixel_order(WIDTH, HEIGHT, warp=(8, 4))
    far = torch.full((WIDTH * HEIGHT,), 3.4028234663852886e38, device=device)
    for name, (px, py) in orders.items():
        px, py = torch.from_numpy(px).to(device), torch.from_numpy(py).to(device)
        o, d = cs.primary_rays(scene, WIDTH, HEIGHT, px, py)
        out[f"k1_{name}"] = reading(lambda: traverse(tables.trace, o, d, far))
        for shadows in (False, True):
            key = f"k2_{name}_{'shadows' if shadows else 'no_shadows'}"
            out[key] = reading(lambda: render_primary(tables, px, py, WIDTH, HEIGHT,
                                                      shadows=shadows))
        out[f"k3_{name}"] = reading(lambda: render_deferred(ttables, px, py, WIDTH, HEIGHT))

    pt = PathTracer(scene, PT_SIZE, PT_SIZE, device=device)
    for _ in range(3):
        pt.step()
    out["pt_ms_per_spp"] = reading(pt.step)
    prof = [cs.device_profile(pt.step, PT_STEPS, device) for _ in range(REPEATS)]
    out["k6_device_ms_per_spp"] = [p["k6_device_ms"] for p in prof]
    out["pt_device_ms_per_spp"] = [p["device_ms"] for p in prof]
    out["pt_host_enqueue_ms"] = [p["host_enqueue_ms"] for p in prof]
    out["pt_device_ms_by_kind"] = prof[-1]["device_ms_by_kind"]
    del pt

    # the texture sampler: K4, K2t beside K3 + K4, K5, textured K6
    px, py = (torch.from_numpy(a).to(device) for a in orders.get("warp8x4", orders["rows"]))
    zoo = make_zoo_scene(60_000, n_mats=48, n_texs=24, seed=0, multi_slot=True, device=device)
    for name, sc in (("courtyard", tscene), ("zoo_multi_slot", zoo)):
        rtab, shade = pack_render_tables(sc), pack_shade_tables(sc)
        gbuf = render_deferred(rtab, px, py, WIDTH, HEIGHT)
        for tri in (False, True):
            k4 = lambda: texture_shade(shade, gbuf, trilinear=tri)
            key = f"k4_{name}_{'trilinear' if tri else 'nearest'}"
            out[key] = reading(k4)
            out[key + "_device"] = device_reading(k4, "texshade_kernel")
        for shadows in (False, True):
            s = "shadows" if shadows else "no_shadows"
            k2t = lambda: render_primary(rtab, px, py, WIDTH, HEIGHT, shadows=shadows,
                                         shade=shade)
            k3k4 = lambda: texture_shade(shade, render_deferred(rtab, px, py, WIDTH, HEIGHT,
                                                                shadows=shadows))
            out[f"k2t_{name}_{s}"] = reading(k2t)
            out[f"k3k4_{name}_{s}"] = reading(k3k4)
            out[f"k2t_{name}_{s}_device"] = device_reading(k2t, "render_primary_kernel")
            out[f"k3k4_{name}_{s}_device"] = device_reading(
                k3k4, ("render_deferred_kernel", "texshade_kernel"))
        if name == "courtyard":
            k4 = lambda: texture_shade(dataclasses.replace(shade, present=0), gbuf)
            out["k4_courtyard_present0"] = reading(k4)
            out["k4_courtyard_present0_device"] = device_reading(k4, "texshade_kernel")
            light = split_gbuffer(gbuf)[0]
            rgb = torch.empty((light.shape[0], 3), dtype=torch.float32, device=device)
            out["k4_courtyard_bytes_copy"] = reading(lambda: rgb.copy_(light))
            btab = pack_bounce_tables(sc)
            pool = cs.camera_pool(btab, PT_SIZE, PT_SIZE)
            hit = trace(sc, pool.origin, pool.direction)
            mid = hit.material_id[hit.hit].to(torch.int32).contiguous()
            uv = hit.uv[hit.hit].contiguous()
            out["k5_courtyard_hits"] = int(mid.shape[0])
            k5 = lambda: sample_materials(btab, mid, uv)
            out["k5_courtyard"] = reading(k5)
            out["k5_courtyard_device"] = device_reading(k5, "sample_materials_kernel")
            del btab, pool, hit, mid, uv, rgb, light
        del gbuf
        btab = pack_bounce_tables(sc)
        for depth, pool, order, n_live, qmc, flags in cs.pools(btab, PT_SIZE, PT_SIZE, (0, 1)):
            copies = [pool.clone() for _ in range(K6_LAUNCHES)]
            rad = torch.zeros((pool.count, 3), dtype=torch.float32, device=device)
            out[f"k6_{name}_depth{depth}"] = [cs.timed(
                lambda: fused_bounce_(btab, copies.pop(), rad, depth=depth, order=order,
                                      n_live=n_live, qmc=qmc, **flags), K6_LAUNCHES // REPEATS,
                device) for _ in range(REPEATS)]
            del copies, pool
        del btab
        pt = PathTracer(sc, PT_SIZE, PT_SIZE, device=device)
        for _ in range(3):
            pt.step()
        out[f"pt_{name}_ms_per_spp"] = reading(pt.step)
        prof = [cs.device_profile(pt.step, PT_STEPS, device) for _ in range(REPEATS)]
        out[f"k6_{name}_device_ms_per_spp"] = [p["k6_device_ms"] for p in prof]
        del pt

    # textured K6's all-lights instances (NEE_ALL): with one light every hit
    # shades it, so the main path runs them
    one = make_courtyard_scene(100_000, seed=0, lights=1, textured=True,
                               texture_size=TEXTURE_SIZE, device=device)
    pt = PathTracer(one, PT_SIZE, PT_SIZE, device=device)
    for _ in range(3):
        pt.step()
    out["pt_courtyard_1light_ms_per_spp"] = reading(pt.step)
    prof = [HERE_SMOKE.device_profile(pt.step, PT_STEPS, device) for _ in range(REPEATS)]
    out["k6_courtyard_1light_device_ms_per_spp"] = [p["k6_device_ms"] for p in prof]
    return out


# template arguments of the K2 and K6 kernels in a tree without a node-width
# argument: such a tree's instances are the width-4 ones
ARGS_WITHOUT_WIDTH = {"render_primary_kernel": 2, "bounce_kernel": 4, "traverse_kernel": 2,
                      "render_deferred_kernel": 1}
# the objects of the width-4 K1, K2, K2t and K6 instances (build.py SOURCES)
WIDTH4_OBJECTS = ("render_primary", "render_primary_textured", "bounce", "bounce_textured",
                  "traverse")
# the width-8 K1, K3 and K6 instances
W8_OTHER_OBJECTS = ("traverse_w8", "render_deferred_w8", "bounce_w8", "bounce_textured_w8")


def instance_key(mangled: str) -> str | None:
    """`kernel<width, stack, flags...>` of a K2 or K2t instance (the last
    flag: textured), a K6 instance (the third: textured), a K1 closest-hit /
    any-hit instance or a K3 instance from its mangled name (in namespace rt, or in an
    anonymous one as K1 was before it took the width), the width 4 filled in
    for a tree whose kernels do not take it; None for any other function."""
    m = re.match(r"_ZN.*?\d+(render_primary_kernel|bounce_kernel|traverse_kernel|"
                 r"render_deferred_kernel)"
                 r"I((?:L[bi]\d+E)+)E", mangled)
    if m is None:
        return None
    args = re.findall(r"L[bi](\d+)E", m.group(2))
    if len(args) == ARGS_WITHOUT_WIDTH[m.group(1)]:
        args = ["4", *args]
    return f"{m.group(1)}<{', '.join(args)}>"


def sass_digest(lib_path: str, objects=WIDTH4_OBJECTS, every_function: bool = False) -> dict:
    """A digest of the SASS of each width-4 K1, K2, K2t and K6 instance
    (untextured and textured; cuobjdump of the built objects), keyed by
    `instance_key`: equal digests in two builds mean the same machine code,
    which changes elsewhere (K3, the width-8 instances, compiled in other
    objects) must leave alone. `objects`: other built objects instead
    (None: every object of the build). `every_function`: every kernel of
    those objects, keyed by object and mangled name."""
    import glob
    import hashlib

    from gpu_raytracer_tpu_torch.ops.cuda import build

    tool = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    if objects is None:
        objects = [os.path.splitext(s)[0] for s in build.SOURCES]
    out = {}
    for obj in objects:
        path = glob.glob(os.path.join(os.path.dirname(lib_path), f"*.{obj}.o"))[0]
        text = subprocess.run([tool, "-sass", path], capture_output=True, text=True,
                              check=True).stdout
        for name, body in re.findall(r"Function : (\S+)\n(.*?)(?=\n\s+Function :|\Z)", text,
                                     re.S):
            # an anonymous namespace's name holds a hash that differs per build
            key = (f"{obj}:{re.sub(r'_GLOBAL__N__[0-9a-f]+_', '_GLOBAL__N__', name)}"
                   if every_function else instance_key(name))
            if key is not None:
                out[key] = hashlib.sha256(body.encode()).hexdigest()[:16]
    return out


def sass_loops(root: str) -> dict:
    """Static SASS size of K1's closest-hit and any-hit instances and of
    K3's for a 32-entry stack, at width 4 (the traverse and render_deferred objects)
    and, where the tree has them, width 8 (traverse_w8, render_deferred_w8),
    and of K2 w8's and K2t w8's for the 64-entry stack that the 100k
    courtyard's width-8 tables take (render_primary_w8,
    render_primary_textured_w8), of width 4's K2 and K2t for the 32-entry
    stack of the 100k courtyard, and of K1's unordered walk (closest and any
    hit), from `cuobjdump -sass`: each one's instruction count, opcode histogram,
    loops (every backward branch: first and last address and the
    instructions between) and registers (ptxas), a yardstick for how many
    instruction slots a node visit and a triangle test take. K3 holds three
    walks (the camera ray's closest hit, and the shadow rays' any hit, the
    light loop's and the sampled light's); the loops whose sizes differ
    from another tree's are the camera walk's. K2 w8 and K2t w8 hold the
    same three walks (their camera walk first, then the shadow walks)."""
    import glob

    sys.path.insert(0, root)
    from gpu_raytracer_tpu_torch.ops.cuda import build

    k = build.load_kernels()
    ptxas = HERE_SMOKE.ptxas_summary(k.log)
    tool = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    out = {}
    for label, width, obj, pattern, ptxas_key in (
            ("k1_width4", 4, "traverse", r"traverse_kernelI(?:Li4E)?Li32ELb0",
             "traverse_kernel<4, 32, 0>"),
            ("k1_width8", 8, "traverse_w8", r"traverse_kernelILi8ELi32ELb0",
             "traverse_kernel<8, 32, 0>"),
            ("k1_width4_any_hit", 4, "traverse", r"traverse_kernelI(?:Li4E)?Li32ELb1",
             "traverse_kernel<4, 32, 1>"),
            ("k1_width8_any_hit", 8, "traverse_w8", r"traverse_kernelILi8ELi32ELb1",
             "traverse_kernel<8, 32, 1>"),
            ("k3_width4", 4, "render_deferred", r"render_deferred_kernelI(?:Li4E)?Li32EE",
             "render_deferred_kernel<4, 32>"),
            ("k3_width8", 8, "render_deferred_w8", r"render_deferred_kernelILi8ELi32EE",
             "render_deferred_kernel<8, 32>"),
            ("k2_width8", 8, "render_primary_w8", r"render_primary_kernelILi8ELi64ELb0E",
             "render_primary_kernel<8, 64, 0>"),
            ("k2t_width8", 8, "render_primary_textured_w8",
             r"render_primary_kernelILi8ELi64ELb1E", "render_primary_kernel<8, 64, 1>"),
            ("k2_width4", 4, "render_primary", r"render_primary_kernelI(?:Li4E)?Li32ELb0E",
             "render_primary_kernel<4, 32, 0>"),
            ("k2t_width4", 4, "render_primary_textured",
             r"render_primary_kernelI(?:Li4E)?Li32ELb1E", "render_primary_kernel<4, 32, 1>"),
            # the main instances, not the counting ones (a tree before those: <any hit>)
            ("k1_threaded", 2, "traverse_threaded", r"traverse_threaded_kernelILb0E(?:Lb0E)?E",
             ("traverse_threaded_kernel<0, 0>", "traverse_threaded_kernel<0>")),
            ("k1_threaded_any_hit", 2, "traverse_threaded",
             r"traverse_threaded_kernelILb1E(?:Lb0E)?E",
             ("traverse_threaded_kernel<1, 0>", "traverse_threaded_kernel<1>"))):
        objs = glob.glob(os.path.join(os.path.dirname(k.path), f"*.{obj}.o"))
        if not objs:
            continue
        text = subprocess.run([tool, "-sass", objs[0]], capture_output=True, text=True,
                              check=True).stdout
        for name, body in re.findall(r"Function : (\S+)\n(.*?)(?=\n\s+Function :|\Z)", text,
                                     re.S):
            if not re.search(pattern, name):
                continue
            ins = re.findall(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\d+\s+)?([A-Z0-9_.]+)([^;]*);",
                             body)
            addr = [int(a, 16) for a, _, _ in ins]
            hist = {}
            for _, op, _ in ins:
                hist[op.split(".")[0]] = hist.get(op.split(".")[0], 0) + 1
            loops = []
            for a, op, rest in ins:
                m = re.search(r"0x([0-9a-f]+)", rest)
                if op.startswith("BRA") and m and int(m.group(1), 16) < int(a, 16):
                    lo, hi = int(m.group(1), 16), int(a, 16)
                    loops.append(dict(first=lo, last=hi,
                                      instructions=sum(1 for x in addr if lo <= x <= hi)))
            keys = (ptxas_key,) if isinstance(ptxas_key, str) else ptxas_key
            out[label] = dict(function=name, instructions=len(ins), loops=loops,
                              ptxas=next((ptxas[k] for k in keys if k in ptxas), None),
                              opcodes=dict(sorted(hist.items(), key=lambda kv: -kv[1])[:16]))
    return out


def run_one(root: str, defines: str, label: str, out: str | None, mode: str = "") -> dict:
    """One measurement in its own process (`mode`: "", "--k3", "--w8",
    "--w8-frames", or "--k2t" and / or "--threaded")
    -> its JSON line, also printed (and appended to `out`)."""
    cmd = [sys.executable, os.path.abspath(__file__), "--one", "--root", root,
           "--defines", defines, "--label", label] + mode.split()
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=root)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if proc.returncode != 0 or not lines:
        print(f"[{label}] failed ({proc.returncode}):\n{proc.stdout[-3000:]}\n"
              f"{proc.stderr[-6000:]}", flush=True)
        return dict(label=label, failed=True)
    print(lines[-1], flush=True)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "a") as f:
            f.write(lines[-1] + "\n")
    return json.loads(lines[-1])


def variant_tree(settings: list[str], label: str) -> tuple[str, list[str]]:
    """A variant's settings -> (the tree to measure, its -D settings). Each
    `kName=VALUE` rewrites the one `constexpr int kName = ...;` of csrc/ in a
    fresh copy of this tree under build/variants/<label>; the others stay -D
    settings of this tree."""
    import re
    import shutil

    consts = [s for s in settings if s.startswith("k")]
    defines = [s for s in settings if not s.startswith("k")]
    if not consts:
        return HERE, defines
    root = os.path.join(HERE, "build", "variants", re.sub(r"[^\w.=,-]", "_", label))
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(HERE, root, ignore=shutil.ignore_patterns(
        "build", ".git", "__pycache__"))
    csrc = os.path.join(root, "gpu_raytracer_tpu_torch", "csrc")
    for setting in consts:
        name, value = setting.split("=", 1)
        pat = re.compile(rf"constexpr int {name} = [^;]+;")
        hits = []
        for fname in sorted(os.listdir(csrc)):
            path = os.path.join(csrc, fname)
            with open(path) as f:
                text = f.read()
            if len(pat.findall(text)) == 1:
                hits.append((path, text))
        if len(hits) != 1:
            raise SystemExit(f"{name}: {len(hits)} csrc files define it once, want 1")
        path, text = hits[0]
        with open(path, "w") as f:
            f.write(pat.sub(f"constexpr int {name} = {value};", text))
    return root, defines


def summary(rows: list[dict]) -> None:
    keys = []
    for r in rows:   # an older tree has no warp-order readings
        keys += [k for k, v in r.items() if k not in keys and isinstance(v, list) and v
                 and all(isinstance(x, float) for x in v)]
    for k in keys:
        cells = [f"{r['label']}={statistics.median(r[k]):.4f}" for r in rows
                 if not r.get("failed") and k in r]
        print(f"{k}: " + "  ".join(cells), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--one", action="store_true", help="measure one tree, print one JSON line")
    ap.add_argument("--root", default=HERE, help="the tree whose package is measured")
    ap.add_argument("--defines", default="", help="-D settings, space separated (NAME=VALUE)")
    ap.add_argument("--label", default="change")
    ap.add_argument("--parent", help="another tree: run parent, change, change, parent")
    ap.add_argument("--variants", nargs="*", default=[],
                    help="settings to build this tree with, one measurement each, between "
                         "two measurements of the tree as it is")
    ap.add_argument("--out", help="a file to append every measurement's JSON line to")
    ap.add_argument("--sass", action="store_true",
                    help="print the static SASS size of K1's closest-hit instances and K3's")
    ap.add_argument("--k3", action="store_true",
                    help="measure K3's readings only (and the SASS digest, registers)")
    ap.add_argument("--w8", action="store_true",
                    help="measure the width-8 readings only (and the SASS digest, registers)")
    ap.add_argument("--k2t", action="store_true",
                    help="K2t at width 4 beside pre-pass + K3 + K4 only (and the SASS of "
                         "every kernel, registers)")
    ap.add_argument("--threaded", action="store_true",
                    help="K1's unordered walk only (and the SASS of every kernel, registers)")
    ap.add_argument("--w8-frames", action="store_true",
                    help="the width-8 frame kernels' readings only (K2 w8, K2t w8, K3 w8; "
                         "width 4's K2; the SASS digest, registers)")
    args = ap.parse_args()
    mode = ("--w8-frames" if args.w8_frames else "--w8" if args.w8 else "--k3" if args.k3
            else " ".join(f for f, on in (("--k2t", args.k2t), ("--threaded", args.threaded))
                          if on))
    if args.sass:
        print(json.dumps(dict(sass=sass_loops(os.path.abspath(args.root)))), flush=True)
        return 0
    if args.one:
        print(json.dumps(measure(os.path.abspath(args.root), args.defines.split(), args.label,
                                 args.k3, args.w8 or args.w8_frames, args.w8_frames, args.k2t,
                                 args.threaded)),
              flush=True)
        return 0
    rows = []
    if args.parent:
        parent = os.path.abspath(args.parent)
        for label, root in (("parent_a", parent), ("change_a", HERE), ("change_b", HERE),
                            ("parent_b", parent)):
            rows.append(run_one(root, "", label, args.out, mode))
    if args.variants:
        rows.append(run_one(HERE, "", "default_a", args.out, mode))
        for v in args.variants:
            label = v.replace("RT_", "").replace(" ", ",")
            root, defines = variant_tree(v.split(), label)
            rows.append(run_one(root, " ".join(defines), label, args.out, mode))
        rows.append(run_one(HERE, "", "default_b", args.out, mode))
    good = [r for r in rows if not r.get("failed")]
    if good:
        summary(good)
        digests = {r["label"]: r.get("sass_width4") for r in good}
        for kernel in ("render_primary_kernel", "bounce_kernel", "traverse_kernel"):
            kept = [{k: v for k, v in (d or {}).items() if k.startswith(kernel + "<")}
                    for d in digests.values()]
            same = len({json.dumps(d, sort_keys=True) for d in kept}) == 1
            print(f"{kernel} (width 4, every instance) SASS identical in every build: {same} "
                  f"({len(kept[0])} instances)", flush=True)
        w8 = [r["sass_w8_primary"] for r in good if "sass_w8_primary" in r]
        if w8:
            same = len({json.dumps(d, sort_keys=True) for d in w8}) == 1
            print(f"render_primary_kernel (width 8, every instance) SASS identical in every "
                  f"build: {same} ({len(w8[0])} instances)", flush=True)
        every = [r["sass_all"] for r in good if "sass_all" in r]
        if every:   # --k2t, --threaded: every kernel of every object
            names = sorted(set().union(*every))
            differ = [n for n in names if len({d.get(n) for d in every}) > 1]
            print(f"SASS of {len(names) - len(differ)} of {len(names)} kernels identical in "
                  f"every build; differing: {differ}", flush=True)
        other = [r["sass_w8_other"] for r in good if "sass_w8_other" in r]
        for kernel in ("traverse_kernel", "render_deferred_kernel", "bounce_kernel"):
            kept = [{k: v for k, v in d.items() if k.startswith(kernel + "<8")} for d in other]
            if kept and kept[0]:
                same = len({json.dumps(d, sort_keys=True) for d in kept}) == 1
                print(f"{kernel} (width 8, every instance) SASS identical in every build "
                      f"that reads it: {same} ({len(kept[0])} instances)", flush=True)
    return 0 if len(good) == len(rows) and rows else 1


if __name__ == "__main__":
    sys.exit(main())
