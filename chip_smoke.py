#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (gpu_raytracer_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one line of numbers each; any failure raises and exits non-zero:
  0. the card's name and power limit (nvidia-smi); a CUDA device is required;
  1. build the CUDA kernels from csrc/ with nvcc;
  2. build the 100k-triangle courtyard (host BVH build, tables to the card);
  3. K1 (wide-BVH traversal, width 4) against the plain traversal on every camera ray of
     the 1920x1080 frame and on 262,144 shadow rays toward the point light;
     its any-hit masks there and on as many toward the directional light
     against the plain any hit and closest hit below max_t, timed;
  4. K2 (fused render) against the plain render_chunk on the full frame,
     shadows off and on, and on the default scene at 256x256;
  5. the main path, Renderer.render_device() at 1920x1080 (on the card in
     8 x 4-pixel warps), timed with CUDA events, with the kernel launch
     counts of that run;
 5b. a camera move on the 100k courtyard: ms per Renderer.set_camera and
     PathTracer.set_camera (the camera row rewritten in place) beside the
     code path they replace (every table repacked), the move under sync
     debug mode "error", the frame after it against a fresh renderer's;
  6. build the textured 100k courtyard (4096-texel floor map, mips) and
     pack its tables to the card;
  7. K3 (deferred trace) against the plain G-buffer on the full frame,
     shadows off and on, and on a textured scene with spheres, bit for bit;
     its ms (the wrapper: the pre-pass, then K3) and the device time of K3
     alone and with its pre-pass (L2 flushed);
 7b. K3's pre-pass (csrc/camera_relative.cu, the camera-relative node and
     triangle tables its camera walk reads) against its plain version, bit
     for bit, on both courtyards' width-4 tables at their camera and at a
     moved one; its device time, plain time and bound;
  8. K4 (texture shade) against the plain deferred shade on the phase-7
     G-buffer and on random G-buffers over a synthetic scene with every wrap
     mode, map slot and mip chains, nearest and trilinear;
  9. the textured main path, Renderer.render_device() at 1920x1080 (K3's
     pre-pass, K3, then K4), timed, with the launch counts of that run;
 10. K6 (the path tracer's bounce, in place on the live lanes of a coherence
     order, QMC uniforms made in the kernel) against its plain version on
     the 1024x1024 camera pool (depth 0) and on the depth-2 pool of the main
     path (spectral, shadows, one sampled light, roulette): every lane of
     the pool compared, dead lanes bit-unchanged;
 11. the same on the textured courtyard (two lights and, for the all-lights
     instances, one) and on a textured synthetic scene
     with live spheres (glass, metal, split lanes; mip chains), texture LOD
     bias 0 and 1, and on glass of IOR 1 (NaN lanes); then K5 (the material
     sampler, a device function of K6) launched on its own against its
     plain version; then the kernel's QMC stream launched on its own, bit for
     bit against ops/sampler.py's;
 12. the main path, PathTracer.step() at 1024x1024 on both courtyards
     (spectral, shadows, QMC anti-aliasing, depth 4): ms per sample, the
     launch counts of that run (K6 five times per step, no other kernel),
     the per-stage breakdown (no uniform tensor is drawn outside the
     bounce), the plain step on the card, the 4-spp image against the plain
     path's, the K6 roofline bound beside the previous design's, the SIMT
     efficiency of the walk per depth, and the time per sample with the
     coherence order skipped (a reading, not an option);
 13. the GLB round trip at scale: the textured 100k courtyard through
     export_glb and scene_from_gltf (seconds, file size), both scenes
     rendered at 1920x1080 by Renderer, max |frame(GLB) - frame(procedural)|
     which must be 0.0;
 14. the 60k-triangle zoo (48 materials, 24 textures) through the same
     writer and loader, base-colour maps only and with metallic-roughness,
     occlusion and emissive maps, Renderer at 1920x1080 (K3 then K4):
     median ms, shadows off and on, nearest mip and trilinear, each held
     against the plain two-phase render on the centre crop;
 15. K2t (the textured fused render, render_primary on a textured scene)
     on the textured courtyard and on both zoos at 1920x1080, shadows off
     and on, against the plain render_chunk; its ms beside K3 + K4's on the
     same frames, its launches (1 per frame, each after 1 of K3's
     pre-pass, whose tables its camera walk reads), its distance to K3 +
     K4's frame, its roofline bound; on the courtyard also after the
     Viewer's "w", "d" (0.0 outside counted order ties) and its device
     time alone and with the pre-pass;
 16. the 100k courtyard under 64 lights, untextured and textured: K2, K2t
     and K3 with a seeded light_u against the plain single-sample version,
     their ms beside the 2-light frame's, the mean of 8 draws against the
     loop over every light (the kernel's, itself held to the plain loop on
     the centre crop), and Renderer's own route (it draws light_u itself:
     the same batch salt gives the same uniforms and frame, another salt
     others, and frames of one salt average to the loop);
 17. PathTracer on the GLB-loaded zoo at 1024x1024, 2 samples: K6 five
     times per sample, no host sync inside a step;
 18. PathTracer.gbuffer() at 1024x1024 on the textured courtyard (K1 and K5
     launched alone, once each) against the plain trace and
     material_textures on the same card tensors (hit masks equal, depth
     within T_REL_TOL, normal 1e-6 and albedo 0.0 off exact-t ties), and
     the à-trous filter (4 passes) on the card against the same call on a
     CPU copy, within DENOISE_TOL x max(1, max |ref|), its launches
     counted from 0 (DENOISE_ITERS + 1 of the filter's kernels); its ms,
     device time and host enqueue time;
 18b. the à-trous filter's kernels (csrc/atrous.cu) at 1024x1024, 3 and 4
     passes, on a path-traced frame of the 100k courtyard: the frame within
     DENOISE_TOL x max(1, max |ref|) of the plain version on the same card
     tensors, under sync debug "error"; the call's device time with the L2
     flushed (events behind a spin kernel), its kernels' own device time
     (torch.profiler: the prepare launch, torch.sort's kernels, the passes;
     any other kernel named apart), launches (counted from 0: passes + 1)
     and host enqueue,
     beside its bound (the filter term of benchmark/roofline.py::fly_frame)
     and the plain version's time on the card;
 19. the fly-through on both courtyards at 1024x1024: 8 steps, then
     PathTracer.fly_frame(camera, m=8, iterations=4, u8=True) along a
     strafe / forward / turn path, under sync debug mode "error": ms per
     frame (pipelined and one at a time), device busy and host enqueue
     time, the per-stage device time (torch.profiler: warp trace, history
     gather, coset step, G-buffer reorder, image, denoise, encode),
     launches per frame
     (K1 and K5 alone once each, the filter's iterations + 1), the share of
     pixels whose history is
     accepted; one coset step held against the plain bounce on the same
     pool (PT_IMAGE_SHARE);
 20. AdaptivePathTracer(tiles_per_step=16) at 1024x1024: adaptive_from + 4
     steps, then the tile selection from CPU copies of the accumulators
     equal to the card's, tile for tile, and to the tiles the next step
     refines; ms per step;
 21. the Viewer at 1920x1080 with shadows on the 100k courtyard (the JAX
     benchmark's section 3): 8 camera-moving frames (handle_key +
     run_compute, one K2 launch each) x 3, ms per frame pipelined between
     CUDA events, device and host enqueue time (profiler), launches; then 4
     frames of moving geometry (update_geometry(host vertices + offset), a
     topology refit with the tables rewritten in place, + run_compute) x 3;
     a camera-moving frame and a refit frame under sync debug "error"; the
     refit, the rebuild (grouped LBVH + BVH4 collapse) and refit + table
     refresh alone (device ms, host enqueue, launches); the refreshed tables
     bit-equal to a fresh pack; the refit and the LBVH arrays on the card
     equal to the CPU's; K2 on the refit and on a rebuilt scene against the
     plain path; a textured Viewer's K3 + K4 after a scaling refit,
     another's after a camera move, and a textured Renderer's after an LBVH
     rebuild, against the plain path, each with K3's G-buffer bit for bit
     the plain one outside exact-t ties (after the move and the rebuild
     also outside the counted order ties of K1 and the plain walk,
     order_ties); the
     pre-pass's tables follow the refit, the camera and the rebuild;
     memory_stats of both scenes;
 22. BVH width 8 (config.bvh_width = 8) on both 100k courtyards: the scenes
     built through make_courtyard_scene, sharing width 4's binary tree and
     slots (asserted), the depth against the stack; K1 on the camera and
     shadow rays (any hit toward both lights, timed in turns with width 4;
     the visits by children ahead, children_ahead, on the camera rays, the
     shadow rays and K6's depth-0 and depth-1 pools), K3's pre-pass, K2
     (shadows off and on), K3 + K4, K2t and
     K6 (the main path's pools) against their plain versions (phases 3-11's plain
     outputs, kept in PLAIN_REFS: the same tree and slots give the same
     plain path; K2t's and the refit frame's rendered here); the main paths (Renderer
     frames, the fused textured render, PathTracer.step()) with the launch
     counts of the width-8 instances, each timed in turns with width 4; the
     4-spp images against phase 12's plain images; node visits and triangle
     tests per ray, SIMT efficiency, registers and spills, the width-aware
     bounds; K2 w8's and K2t w8's device time with and without the
     pre-pass that the wrapper launches before each of them, and both held
     to their plain frames at 0.0 after the Viewer's "w", "d" (order ties
     counted, order_ties); a width-8 Viewer's topology refit (width-8
     tables kept) and its frame, then a rebuild (width-4 tables) and its
     frame (width 4's K2, equal to a fresh renderer's);
 22b. the spatial-split 100k courtyard (config.bvh_spatial_splits): its
     references and tree checked, K2 shadows off and on against
     render_chunk on its own tree and timed in turns with the SAH tree's,
     one PathTracer.step(), K6 on the depth-0 pool, node visits per camera
     ray against the SAH tree's;
 23. the HTTP server (engine/server.py::ViewerServer on 127.0.0.1, port 0)
     around a CUDA Viewer of the 100k courtyard with shadows, at 640x360 (the
     serve default) and 1920x1080, and of the textured one at 640x360; two
     /stream clients read with urllib: camera-moving frames (the frame's
     kernels once per served frame: K2, or K3 + K4), a /key and /drag, the
     settled PNG part decoded to exactly framebuffer_u8 and the served frame
     (K2, or K3 + K4) held to the plain path, still-camera frames,
     path-traced frames after 'p' (K6 five times a frame, the still
     preview's filter PREVIEW_ITERS + 1 launches, the pinned YUV present) and one served frame's five K6 launches held to the plain
     bounce on their pools, /resize, stop() and no server thread left; served frames per
     second, the producer's frame split (compute between CUDA events;
     present, quantise, materialise and PNG encode in host ms), launches per
     frame and the device's busy share (torch.profiler);
 23b. NativeWindow (engine/window.py) on a CUDA Viewer through the tests'
     stand-in Tk (tests/fake_tk.py): K2 a tick, the settled PPM equal to
     framebuffer_u8 and its K2 frame held to the plain path, a resize, K6 five times a path-traced tick
     and the still preview's filter PREVIEW_ITERS + 1 launches;
     window_available() of the machine;
 23c. K2's frame (Renderer at 48x48, the default scene and the 2,000-triangle
     courtyard) against the port's NumPy oracle (reference/cpu_tracer.py,
     its rows over spawned processes): RMSE <= 1e-5 without shadows, and
     with shadows on the pixels no shadow ray darkens (the oracle casts
     none), the others no brighter;
 23d. the courtyard atlas's disk cache: a cold 4096-texel build and a load
     from the file in a temporary directory, bit-equal;
 23e. the single-leaf tree's walk (the default scene; the JAX package's
     binary `_ordered_traverse`): K1 over its synthesised width-4 root on
     the 256x256 camera rays against the plain walk, timed, with its bound;
 24. K1's unordered walk (csrc/traverse_threaded.cu, the JAX package's
     `pallas_packet_traverse(ordered=False)`) on the 1920x1080 camera rays
     of the 100k courtyard (closest hit) and on shadow rays from their hits
     toward the point light (any hit): t, slot, hit, normal and material
     equal to the plain threaded walk on every lane; its closest t equal to
     K1's outside counted exact-t ties; its ms (CUDA events) and device
     time (torch.profiler), registers (ptxas), bound (the plain walk's
     node visits and triangle tests at 25 and 54 operations) and launches
     on the main path (none); its counting instance, equal bit for bit, and
     the visits lanes made past a pending leaf;
 25. the multi-device layer (parallel/) on virtual meshes of 1, 2, 4 and 8
     shards of the one card: render_frame_fused_multichip at 1920x1080
     (untextured, shadows off and on; the textured courtyard) 0.0 from the
     single-device Renderer frame; trace_geometry_sharded and
     trace_geometry_sharded_ring on the camera rays (and the ring on 1,003
     rays) against the single-device trace through K1: hit, t, material and
     the winner's original id equal outside counted exact-t ties;
     pathtrace_step_sharded at 1024x1024 within 1e-5 of PathTracer.step(),
     counts equal; per mesh size the ms per call, launches per call by
     kernel and the collectives' share (one card's numbers: no multi-card
     speed-up is measured);
 26. the million-triangle courtyard (the benchmark's courtyard-1m), whose
     11-level wide tree takes the 64-entry stack: Renderer frames at
     1920x1080, shadows off and on, one K2 launch each and only the
     `render_primary_kernel<4, 64, false>` instance on the device trace,
     held to the plain render_chunk outside counted ties; K2's device time
     with shadows, back to back and L2 flushed, beside the 100k courtyard's
     on its 32-entry instance and on the 64-entry one (the same frame).
K4, K5 (alone and inside textured K6) and K2t are held to 0.0 from their
plain versions (SAMPLER_TOL), nearest and trilinear, all three wraps.
Then the frame kernels' roofline bounds with the SIMT efficiency of the
walk on camera and shadow rays (a counter in the kernel), the profiler
sessions each device-time reading needed, and the seconds of each phase.
The card line, then the per-kernel JSON summary, then the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.append(os.path.join(ROOT, "tests"))
from torch_scenes import light_shadow_rays, random_gbuffer, synthetic_textured_scene  # noqa: E402

WIDTH, HEIGHT = 1920, 1080
TRIANGLES = 100_000
TEXTURE_SIZE = 4096    # the textured courtyard's floor map edge (bench.py section 4)
SHADOW_RAYS = 262_144
TIE_BUDGET = 1e-4      # tie pixels allowed, as a share of the frame
RGB_TOL = 1e-5         # max |diff| against the plain version outside ties
SAMPLER_TOL = 0.0      # K4, K5 (alone and inside K6) and K2t: the same bits as the plain sampler
T_REL_TOL = 1e-6       # K1 hit distance, relative
GBUF_TOL = 0.0         # K3 light sum and uv, absolute; mip footprint, relative: K3 and
                       # its plain G-buffer round alike (0.0 in every run), so the same bits
FRAMES = 8             # timed frames of the kernel path
PLAIN_FRAMES = 3       # timed frames of the plain path (seconds each)
ZOO_TRIANGLES = 60_000     # bench.py section 4d
ZOO_MATERIALS, ZOO_TEXTURES = 48, 24
CROP = 256                 # centre crop edge for the plain side of the zoo frames
MANY_LIGHTS = 64
LIGHT_DRAWS = 8            # light_u draws averaged against the loop over every light
LIGHT_MEAN_TOL = 0.08      # |sum(mean) - sum(exact)| / sum(exact)
ZOO_PT_SAMPLES = 2


PHASE_SECONDS = {}     # seconds from the previous "phase" line to each one (the run's time)
_last_phase = [time.perf_counter()]


def log(msg: str) -> None:
    if msg.startswith("phase "):
        now = time.perf_counter()
        key = " ".join(msg.split(" ", 3)[:2]).rstrip(":")
        PHASE_SECONDS[key] = PHASE_SECONDS.get(key, 0.0) + now - _last_phase[0]
        _last_phase[0] = now
    print(msg, flush=True)


# The plain versions' outputs of the width-4 phases, kept under a key that
# names the scene and the call (None: not kept). Phase 22's width-8 scenes
# share the width-4 scenes' binary tree and triangle slots (asserted before
# any use), so the plain path gives them the same outputs bit for bit, and
# the width-8 kernels are held to these instead of to a second plain run.
PLAIN_REFS = {}


def plain_ref(key, fn):
    """fn(), computed once per key and kept in PLAIN_REFS (key None: not kept)."""
    if key is None:
        return fn()
    if key not in PLAIN_REFS:
        PLAIN_REFS[key] = fn()
    return PLAIN_REFS[key]


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip()


def ptxas_summary(nvcc_log: str) -> dict:
    """Registers, stack frame and spill bytes per compiled kernel instance,
    from nvcc's -Xptxas -v report."""
    out, name = {}, None
    for line in nvcc_log.splitlines():
        m = re.search(r"Compiling entry function '\S*?\d(traverse_kernel|traverse_work_kernel|"
                      r"traverse_threaded_kernel|"
                      r"render_primary_kernel|render_deferred_kernel|texshade_kernel|"
                      r"bounce_kernel|sample_materials_kernel|camera_relative_kernel)"
                      r"(?:I((?:L[bi]\d+E)+)E)?", line)
        if m:
            name = m.group(1)
            if m.group(2):   # template arguments: stack, then the flags
                name += f"<{', '.join(re.findall(r'L[bi](\d+)E', m.group(2)))}>"
            out[name] = {}
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)
        if m and name:
            out[name].update(stack_frame=int(m.group(1)), spill_stores=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def timed(fn, n: int, device) -> float:
    """Median milliseconds of n calls of fn, each between two CUDA events
    (host clock after a synchronize on the CPU)."""
    import torch

    times = []
    for _ in range(n):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def frame_pixels(width, height, device):
    """The frame's pixel coordinates on `device` in Renderer's order there:
    tile-major, on a CUDA device in 8 x 4 blocks inside the tiles."""
    import torch

    from gpu_raytracer_tpu_torch.engine.renderer import WARP_BLOCK, tiled_pixel_order

    warp = WARP_BLOCK if torch.device(device).type == "cuda" else None
    return tuple(torch.from_numpy(a).to(device)
                 for a in tiled_pixel_order(width, height, warp=warp))


def simt_efficiency(work) -> dict:
    """SIMT efficiency of the walk's two bodies from traversal_work's [N,5]
    counts: the lanes at work per warp iteration, as a share of 32."""
    n, t, wn, wt = (float(x) for x in work.sum(dim=0).tolist()[:4])
    return dict(node_body=n / (32.0 * wn) if wn else None,
                triangle_body=t / (32.0 * wt) if wt else None)


def primary_rays(scene, width, height, px, py):
    from gpu_raytracer_tpu_torch.ops.camera_rays import generate_rays

    o, d = generate_rays(scene.camera, width, height, px, py)
    return o.contiguous(), d.contiguous()


def k1_compare(tables, o, d, max_t, ref=None):
    """Closest hit through K1 and the plain traversal (kept under `ref`,
    plain_ref) -> (stats, tie mask)."""
    import torch

    from gpu_raytracer_tpu_torch.ops.cuda.traverse import traverse
    from gpu_raytracer_tpu_torch.ops.trace import traverse_triangles

    kt, ks, kh, kn, km = traverse(tables, o, d, max_t)
    pt, ps, ph, pn, pm = plain_ref(ref, lambda: traverse_triangles(tables.scene, o, d, max_t))
    if not torch.equal(kh, ph):
        raise AssertionError(f"K1 hit mask differs on {(kh != ph).sum().item()} rays")
    h = kh
    rel = ((kt - pt).abs() / pt.abs().clamp(min=1e-30))[h]
    t_rel = rel.max().item() if h.any() else 0.0
    if t_rel > T_REL_TOL:
        raise AssertionError(f"K1 t off by {t_rel:.3g} relative")
    other = h & (ks.long() != ps)
    ties = other & (kt == pt)
    if (other & ~ties).any():
        raise AssertionError(f"{(other & ~ties).sum().item()} rays hit another triangle "
                             f"at another t")
    same = h & ~ties
    n_err = (kn - pn).abs().amax(dim=1)[same]
    n_err = n_err.max().item() if same.any() else 0.0
    if n_err > 1e-6 or not torch.equal(km.long()[same], pm[same]):
        raise AssertionError(f"K1 normal/material differ off ties (normal {n_err:.3g})")
    t_abs = (kt - pt).abs()[h].max().item() if h.any() else 0.0
    return dict(rays=o.shape[0], hits=int(h.sum()), ties=int(ties.sum()),
                t_rel=t_rel, t_abs=t_abs, normal_abs=n_err), ties


def phase_k1(scene, tables, width, height, n_shadow, device, card, phase="3", ref=None):
    """K1 against the plain traversal on every camera ray of the frame (in
    the main path's order) and on n_shadow shadow rays from
    those hits toward the point light; its any-hit masks on those rays and on
    as many toward the directional light against the plain any-hit and the
    plain closest hit below max_t, timed -> (stats, per-pixel tie mask). The
    plain outputs and time are kept under `ref` (a scene's name, plain_ref)."""
    import torch

    from gpu_raytracer_tpu_torch.ops.cuda.traverse import traverse
    from gpu_raytracer_tpu_torch.ops.trace import traverse_triangles

    px, py = frame_pixels(width, height, device)
    o, d = primary_rays(scene, width, height, px, py)
    far = torch.full((px.shape[0],), 3.4028234663852886e38, device=device)
    key = (lambda *k: None if ref is None else (ref,) + k)
    prim, ties = k1_compare(tables, o, d, far, ref=key("k1_camera"))

    t, _, h, n, _ = plain_ref(key("k1_camera"), lambda: traverse_triangles(scene, o, d, far))
    so, sd, smax = light_shadow_rays(scene, o, d, t, h, n, n_shadow)
    shadow, _ = k1_compare(tables, so, sd, torch.full_like(smax, 3.4028234663852886e38),
                           ref=key("k1_shadow"))
    any_hit = {}
    for light, (lo, ld, lmax) in (("point", (so, sd, smax)), ("directional", light_shadow_rays(
            scene, o, d, t, h, n, n_shadow, directional=True))):
        suffix = "" if light == "point" else "_directional"
        blocked = traverse(tables, lo, ld, lmax, any_hit=True)[2]
        closest = plain_ref(key("k1_shadow_below" + suffix),
                            lambda: traverse_triangles(scene, lo, ld, lmax))[2]
        if not torch.equal(blocked, closest):
            raise AssertionError(f"K1 any-hit differs from closest t < max_t on "
                                 f"{(blocked != closest).sum().item()} {light} shadow rays")
        plain_anyhit = plain_ref(key("k1_shadow_any" + suffix), lambda: traverse_triangles(
            scene, lo, ld, lmax, any_hit=True))[2]
        if not torch.equal(blocked, plain_anyhit):
            raise AssertionError(f"K1 any-hit differs from the plain any-hit ({light} light)")
        any_hit[light] = dict(rays=int(lo.shape[0]), blocked=int(blocked.sum()), ms=timed(
            lambda: traverse(tables, lo, ld, lmax, any_hit=True), FRAMES, device))
    ms = timed(lambda: traverse(tables, o, d, far), FRAMES, device)
    plain_ms = plain_ref(key("k1_plain_ms"), lambda: timed(
        lambda: traverse_triangles(scene, o, d, far), PLAIN_FRAMES, device))
    stats = dict(primary=prim, shadow=shadow, shadow_blocked=any_hit["point"]["blocked"],
                 any_hit=any_hit, ms=ms, plain_ms=plain_ms, card=card)
    log(f"phase {phase} K1 (width {tables.width}): {json.dumps(stats)}")
    return stats, ties


def k2_compare(scene, width, height, shadows, device, ties=None, ref=None):
    """Renderer's frame (K2 on the card) against the plain render_chunk,
    kept under `ref` (a scene's name, plain_ref)."""
    import torch

    from gpu_raytracer_tpu_torch.engine.renderer import Renderer
    from gpu_raytracer_tpu_torch.ops.render import render_chunk

    r = Renderer(scene, width, height, shadows=shadows, device=device)
    got = r.render_device()
    ref = plain_ref(None if ref is None else (ref, "frame", width, height, shadows),
                    lambda: render_chunk(r.scene, r.px, r.py, width, height, shadows=shadows))
    if got.shape != (width * height, 3) or not torch.isfinite(got).all():
        raise AssertionError(f"K2 frame: shape {tuple(got.shape)}, finite "
                             f"{bool(torch.isfinite(got).all())}")
    diff = (got - ref).abs().amax(dim=1)
    keep = torch.ones_like(diff, dtype=torch.bool) if ties is None else ~ties
    err = diff[keep].max().item()
    n_ties = 0 if ties is None else int(ties.sum())
    if err > RGB_TOL:
        raise AssertionError(f"K2 max |diff| {err:.3g} > {RGB_TOL} outside {n_ties} ties")
    if n_ties > TIE_BUDGET * width * height:
        raise AssertionError(f"{n_ties} tie pixels > {TIE_BUDGET:.2%} of the frame")
    return dict(err=err, err_with_ties=diff.max().item(), tie_pixels=n_ties,
                mean=got.mean().item())


def phase_main(scene, width, height, device, card):
    """The main path: Renderer.render_device() at full size, warm, timed."""
    import torch

    from gpu_raytracer_tpu_torch.engine.renderer import Renderer
    from gpu_raytracer_tpu_torch.ops.render import render_chunk

    out = {}
    for shadows in (False, True):
        r = Renderer(scene, width, height, shadows=shadows, device=device)
        first = r.render_device()
        launch_tally().clear()
        ms = timed(r.render_device, FRAMES, device)
        launches = frame_launches()
        k2, k1 = launches["k2"], launches["k1_standalone"]
        frame = r.render_device()
        if not torch.equal(frame, first) or not torch.isfinite(frame).all():
            raise AssertionError("main-path frames differ between runs or are not finite")
        if device.type == "cuda" and k2 < FRAMES:
            raise AssertionError(f"K2 launched {k2} times in {FRAMES} frames")
        plain_ms = timed(lambda: render_chunk(r.scene, r.px, r.py, width, height,
                                              shadows=shadows), PLAIN_FRAMES, device)
        rays = width * height * 3
        out["shadows" if shadows else "no_shadows"] = dict(
            ms=ms, mrays_per_s=rays / (ms * 1e-3) / 1e6, plain_ms=plain_ms,
            plain_mrays_per_s=rays / (plain_ms * 1e-3) / 1e6,
            k2_launches=k2, k1_standalone_launches=k1)
    out["card"] = card
    log(f"phase 5 main path {width}x{height}: {json.dumps(out)}")
    return out


CAMERA_MOVES = 8        # timed camera moves of phase 5b, each way


def phase_camera_move(scene, width, height, pt_size, device, card):
    """Phase 5b: ms per camera move of Renderer and PathTracer (host clock
    to a synchronize) against the code path they replace, on the same
    moves: the scene's camera moved field by field (`to_device`), then
    pack_render_tables / pack_bounce_tables."""
    import dataclasses

    import torch

    from gpu_raytracer_tpu_torch.engine.pathtracer import PathTracer
    from gpu_raytracer_tpu_torch.engine.renderer import Renderer
    from gpu_raytracer_tpu_torch.models.camera import CameraController
    from gpu_raytracer_tpu_torch.models.scene import to_device
    from gpu_raytracer_tpu_torch.ops.cuda.bounce import pack_bounce_tables
    from gpu_raytracer_tpu_torch.ops.cuda.render import pack_render_tables

    ctrl = CameraController(scene.camera)
    cams = []
    for k in range(CAMERA_MOVES):
        ctrl.move(forward=0.25, strafe=0.1 * (k % 3 - 1))
        ctrl.rotate(3.0, 0.5)
        cams.append(ctrl.camera())

    def per_move(fn) -> float:
        times = []
        for cam in cams:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            fn(cam)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    r = Renderer(scene, width, height, device=device)
    pt = PathTracer(scene, pt_size, pt_size, device=device)
    r.render_device()
    pt.step()
    repack = lambda cam: dataclasses.replace(scene, camera=to_device(cam, scene.device))
    out = dict(renderer_ms=per_move(r.set_camera),
               renderer_repack_ms=per_move(lambda cam: pack_render_tables(repack(cam))),
               pathtracer_ms=per_move(pt.set_camera),
               pathtracer_repack_ms=per_move(lambda cam: pack_bounce_tables(repack(cam))))
    kept = (r.tables.camera, r.tables.trace.nodes, pt.tables.render.camera)
    cam = cams[0]
    if device.type == "cuda":   # the controller's move never waits for the card
        torch.cuda.set_sync_debug_mode("error")
    try:
        r.set_camera(cam)
        pt.set_camera(cam)
        frame = r.render_device()
        pt.step()
    finally:
        if device.type == "cuda":
            torch.cuda.set_sync_debug_mode("default")
    if any(a is not b for a, b in zip(kept, (r.tables.camera, r.tables.trace.nodes,
                                             pt.tables.render.camera))):
        raise AssertionError("set_camera replaced a table tensor")
    fresh = Renderer(scene.with_camera(cam), width, height, device=device)
    if not torch.equal(frame, fresh.render_device()):
        raise AssertionError("the frame after set_camera differs from a fresh renderer's")
    out.update(moves=len(cams), frame_equal_to_fresh=True, card=card)
    log(f"phase 5b camera move: {json.dumps(out)}")
    return out


def phase_textured_scene(device, triangles, texture_size):
    """Phase 6: the textured courtyard and its tables on the card."""
    import torch

    from gpu_raytracer_tpu_torch.ops.cuda.render import pack_render_tables
    from gpu_raytracer_tpu_torch.ops.cuda.texshade import pack_shade_tables
    from gpu_raytracer_tpu_torch.utils.procgen import make_courtyard_scene

    t0 = time.perf_counter()
    scene = make_courtyard_scene(triangles, seed=0, textured=True,
                                 texture_size=texture_size, device="cpu")
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scene = scene.to(device)
    tables = pack_render_tables(scene)
    shade = pack_shade_tables(scene)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    tex = scene.textures
    info = dict(triangles=scene.num_triangles, texture_size=texture_size, build_s=build_s,
                to_card_s=time.perf_counter() - t0, atlas_rows=tex.num_rows,
                atlas_mb=tex.data_u32.numel() * 4 / 2**20,
                widths=tex.width.tolist(), levels=tex.levels.tolist(), n_levels=tex.n_levels,
                materials=scene.materials.count,
                present_slots=list(scene.materials.present_slots),
                bvh4_depth=tables.trace.depth, stack=tables.trace.stack)
    log(f"phase 6 textured scene: {json.dumps(info)}")
    return scene, tables, shade


def gbuffer_compare(tables, px, py, width, height, shadows, ties, ref=None):
    """K3 against the plain G-buffer on the same pixels (kept under `ref`, a
    scene's name, plain_ref) -> (stats, K3's G-buffer)."""
    import torch

    from gpu_raytracer_tpu_torch.ops.render import render_gbuffer, split_gbuffer
    from gpu_raytracer_tpu_torch.ops.cuda.render import render_deferred

    got = render_deferred(tables, px, py, width, height, shadows=shadows)
    ref = plain_ref(None if ref is None else (ref, "gbuffer", width, height, shadows),
                    lambda: render_gbuffer(tables.scene, px, py, width, height, shadows=shadows))
    (gs, gm, guv, glam), (rs, rm, ruv, rlam) = split_gbuffer(got), split_gbuffer(ref)
    finite = all(bool(torch.isfinite(x).all()) for x in (gs, guv, glam))
    if got.shape != (2, px.shape[0], 4) or not finite:
        raise AssertionError(f"K3 G-buffer: shape {tuple(got.shape)}, finite {finite}")
    keep = ~ties
    if not torch.equal(gm[keep], rm[keep]):
        raise AssertionError(f"K3 material ids differ on {(gm != rm)[keep].sum().item()} "
                             f"rays outside {int(ties.sum())} ties")
    err = dict(S=(gs - rs).abs().amax(dim=1)[keep].max().item(),
               uv=(guv - ruv).abs().amax(dim=1)[keep].max().item(),
               lam_rel=((glam - rlam).abs() / rlam.abs().clamp(min=1e-30))[keep].max().item())
    if max(err.values()) > GBUF_TOL:
        raise AssertionError(f"K3 G-buffer off by {err} outside ties")
    if int(ties.sum()) > TIE_BUDGET * px.shape[0]:
        raise AssertionError(f"{int(ties.sum())} tie pixels > {TIE_BUDGET:.2%} of the frame")
    return dict(err, tie_pixels=int(ties.sum()), hits=int((gm >= 0).sum()),
                triangle_hits=int((glam > 0).sum())), got


def shade_compare(shade, gbuf, sky, trilinear, keep=None):
    """K4 against the plain deferred shade on one G-buffer -> max |diff|."""
    import torch

    from gpu_raytracer_tpu_torch.ops.render import split_gbuffer
    from gpu_raytracer_tpu_torch.ops.cuda.texshade import texture_shade
    from gpu_raytracer_tpu_torch.ops.shading import shade_deferred

    got = texture_shade(shade, gbuf, sky=sky, trilinear=trilinear)
    S, mat, uv, lam = split_gbuffer(gbuf)
    ref = shade_deferred(shade.scene, S, mat, uv, sky_color=sky, lam=lam, trilinear=trilinear)
    if not torch.equal(torch.isnan(got), torch.isnan(ref)):
        raise AssertionError("K4 NaN lanes differ from the plain shade")
    diff = torch.nan_to_num((got - ref).abs(), nan=0.0).amax(dim=1)
    if keep is not None:
        diff = diff[keep]
    err = diff.max().item()
    if err > SAMPLER_TOL:
        raise AssertionError(f"K4 max |diff| {err:.3g} > {SAMPLER_TOL} (trilinear={trilinear})")
    return err


def mip_boundary_rays(shade, gbuf, rel: float = 1e-6) -> int:
    return int(mip_boundary_mask(shade, gbuf, rel).sum())


def mip_boundary_mask(shade, gbuf, rel: float = 1e-6):
    """[N] bool: hits whose nearest mip level of some sampled map sits
    within `rel` of a level boundary (lam * w * sqrt2 near a power of two,
    judged in float64): there a one-ulp change of the hit distance picks
    the other level, so another evaluation order of the trace may differ
    there."""
    import torch

    from gpu_raytracer_tpu_torch.ops.render import split_gbuffer

    _, mat, _, lam = split_gbuffer(gbuf)
    hit = mat >= 0
    meta = shade.maps[torch.clamp(mat, 0, shade.maps.shape[0] - 1)]     # [N,4,8]
    near = torch.zeros_like(hit)
    for k in range(meta.shape[1]):
        if not (shade.present >> k) & 1:
            continue
        x = lam.double() * meta[:, k, 3].double() * 2.0 ** 0.5
        lo = torch.floor(torch.log2(x * (1.0 - rel)))
        hi = torch.floor(torch.log2(x * (1.0 + rel)))
        near |= (meta[:, k, 0] > 0) & (x > 0) & (lo != hi)
    return near & hit


def primary_ties(tables, width, height, px, py, ref=None):
    """Camera rays whose closest triangle K1 and the plain traversal pick
    differently at the exact same t; `ref` (a scene's name) keeps the plain
    hits of the frame's pixels (frame_pixels) as phase_k1 does."""
    import torch

    o, d = primary_rays(tables.scene, width, height, px, py)
    far = torch.full((px.shape[0],), 3.4028234663852886e38, device=px.device)
    return k1_compare(tables.trace, o, d, far,
                      ref=None if ref is None else (ref, "k1_camera"))[1]


def order_ties(tables, width, height, px, py):
    """Camera rays whose closest triangle K1 and the plain walk pick
    differently -> (mask, counts): exact-t ties, and order ties, where two
    triangles meet at an edge and their computed t differ by a few ulps:
    K1's near-first walk reaches one first and culls the other's leaf by
    its slab entry, which rounds to no less than the first's t, while the
    plain left-first walk keeps the smaller t (PERF.md §2; the JAX
    package's walks keep K1's winner on the one such ray found,
    tests/test_torch_walk_host.py). Hit masks must be equal, t within
    T_REL_TOL relative; both kinds are counted and bounded by TIE_BUDGET."""
    import torch

    from gpu_raytracer_tpu_torch.ops.cuda.traverse import traverse
    from gpu_raytracer_tpu_torch.ops.trace import traverse_triangles

    o, d = primary_rays(tables.scene, width, height, px, py)
    far = torch.full((px.shape[0],), F32_MAX, device=px.device)
    kt, ks, kh, _, _ = traverse(tables.trace, o, d, far)
    pt, ps, ph, _, _ = traverse_triangles(tables.scene, o, d, far)
    if not torch.equal(kh, ph):
        raise AssertionError(f"K1 hit mask differs on {(kh != ph).sum().item()} rays")
    rel = ((kt - pt).abs() / pt.abs().clamp(min=1e-30))[kh]
    if kh.any() and rel.max().item() > T_REL_TOL:
        raise AssertionError(f"K1 t off by {rel.max().item():.3g} relative")
    other = kh & (ks.long() != ps)
    counts = dict(exact_t_ties=int((other & (kt == pt)).sum()),
                  order_ties=int((other & (kt != pt)).sum()))
    if int(other.sum()) > TIE_BUDGET * px.shape[0]:
        raise AssertionError(f"{counts} tie rays > {TIE_BUDGET:.2%} of the frame")
    return other, counts


def phase_k3(scene, tables, width, height, device, card, ref=None):
    """Phase 7: K3 against the plain G-buffer on the full frame, shadows off
    and on, and on the synthetic scene (live spheres, so sphere uvs)."""
    import torch

    from gpu_raytracer_tpu_torch.ops.render import render_gbuffer
    from gpu_raytracer_tpu_torch.ops.cuda.render import pack_render_tables, render_deferred

    px, py = frame_pixels(width, height, device)
    ties = primary_ties(tables, width, height, px, py, ref=ref)
    out, gbufs = {}, {}
    for shadows in (False, True):
        key = "courtyard_shadows" if shadows else "courtyard_no_shadows"
        out[key], gbufs[shadows] = gbuffer_compare(tables, px, py, width, height, shadows, ties,
                                                   ref=ref)
    synth = synthetic_textured_scene(0, mips=4, device=device)
    st = pack_render_tables(synth)
    spx, spy = frame_pixels(256, 256, device)
    sties = primary_ties(st, 256, 256, spx, spy)
    for shadows in (False, True):
        key = f"synthetic_256_{'shadows' if shadows else 'no_shadows'}"
        out[key] = gbuffer_compare(st, spx, spy, 256, 256, shadows, sties)[0]
    k3 = lambda: render_deferred(tables, px, py, width, height)
    out["ms"] = timed(k3, FRAMES, device)   # the wrapper: the pre-pass, then K3
    if device.type == "cuda":   # device time, the L2 flushed before each call
        out["k3_device_ms"] = kernel_device_ms(k3, "render_deferred_kernel", FRAMES, device)
        out["k3_and_pre_pass_device_ms"] = kernel_device_ms(
            k3, ("render_deferred_kernel", "camera_relative_kernel"), FRAMES, device)
    out["plain_ms"] = plain_ref(None if ref is None else (ref, "gbuffer_plain_ms"), lambda: timed(
        lambda: render_gbuffer(scene, px, py, width, height), PLAIN_FRAMES, device))
    out["card"] = card
    log(f"phase 7 K3 {width}x{height}: {json.dumps(out)}")
    return out, gbufs[False], ties


def camera_relative_compare(tables) -> dict:
    """K3's pre-pass (`camera_relative`, csrc/camera_relative.cu) against its
    plain version `camera_relative_tables` on the tables' current camera:
    every word of both tables the same bits, or this raises -> stats."""
    import torch

    from gpu_raytracer_tpu_torch.ops.cuda.render import camera_relative, camera_relative_tables

    got = [x.clone() for x in camera_relative(tables)]
    ref = camera_relative_tables(tables)
    for name, g, r in zip(("rel_nodes", "rel_tris"), got, ref):
        if g.shape != r.shape or not torch.equal(g.view(torch.int32), r.view(torch.int32)):
            raise AssertionError(f"K3 pre-pass {name}: "
                                 f"{int((g.view(torch.int32) != r.view(torch.int32)).sum())} "
                                 f"words differ from the plain version")
    return dict(max_abs_err=0.0, node_records=int(got[0].shape[0]),
                triangle_rows=int(got[1].shape[0]), width=tables.trace.width,
                camera=tables.camera[:3].tolist())


def camera_relative_work(tables) -> tuple[int, int]:
    """The pre-pass's bytes and operations: the node records and the
    triangle rows (48 bytes a slot) and the camera's position read once, the
    node records and 64 bytes a slot written once; one subtraction a box word
    and TRI_FLOPS - TRI_REL_FLOPS (s, q, e2 . q) a slot."""
    tr = tables.trace
    q, tp, w = tr.nodes.shape[0], tr.tris.shape[0], tr.width
    node_bytes = tr.nodes.numel() * 4
    return (2 * node_bytes + tp * (48 + REL_TRI_BYTES) + 12,
            6 * w * q + (TRI_FLOPS - TRI_REL_FLOPS) * tp)


def camera_relative_bound(tables) -> tuple[float, str]:
    """The pre-pass's roofline bound (camera_relative_work)."""
    return bound_ms(*camera_relative_work(tables))


def phase_camera_relative(tscene, ttables, tables, device, card):
    """Phase 7b: K3's pre-pass against its plain version, bit for bit, on the
    node and triangle tables of both 100k courtyards (width 4; width 8 in
    phase 22) at their camera and at a moved one (the camera row rewritten
    in place by set_camera: the kernel reads the new position on the
    device); its device time (L2 flushed), plain time and bound."""
    from gpu_raytracer_tpu_torch.models.camera import CameraController
    from gpu_raytracer_tpu_torch.ops.cuda.render import (camera_relative,
                                                         camera_relative_tables,
                                                         pack_render_tables, set_camera)

    out = dict(textured_courtyard=camera_relative_compare(ttables),
               courtyard=camera_relative_compare(tables))
    moved = pack_render_tables(tscene)
    ctl = CameraController(tscene.camera)
    ctl.move(forward=3.0, strafe=-1.5)
    ctl.rotate(40.0, 12.0)
    set_camera(moved, ctl.camera())
    out["textured_courtyard_moved_camera"] = camera_relative_compare(moved)
    if out["textured_courtyard_moved_camera"]["camera"] == out["textured_courtyard"]["camera"]:
        raise AssertionError("the moved camera did not move")
    del moved
    out["max_abs_err"] = 0.0
    if device.type == "cuda":
        out["device_ms"] = kernel_device_ms(lambda: camera_relative(ttables),
                                            "camera_relative_kernel", FRAMES, device)
    out["plain_ms"] = timed(lambda: camera_relative_tables(ttables), PLAIN_FRAMES, device)
    out["bound_ms"], out["bound_by"] = camera_relative_bound(ttables)
    out["card"] = card
    log(f"phase 7b K3 pre-pass: {json.dumps(out)}")
    return out


def phase_k4(shade, gbuf, ties, device, card):
    """Phase 8: K4 against the plain deferred shade on K3's full-frame
    G-buffer and on random G-buffers over the synthetic scene."""
    import numpy as np
    import torch

    from gpu_raytracer_tpu_torch.ops.render import gbuffer_planes, split_gbuffer
    from gpu_raytracer_tpu_torch.ops.cuda.texshade import pack_shade_tables, texture_shade
    from gpu_raytracer_tpu_torch.ops.shading import shade_deferred

    sky = (0.1, 0.2, 0.3)
    near = mip_boundary_rays(shade, gbuf)
    if near > TIE_BUDGET * split_gbuffer(gbuf)[1].shape[0]:
        raise AssertionError(f"{near} rays on a mip level boundary > {TIE_BUDGET:.2%}")
    err = {}
    for tri in (False, True):
        err[f"courtyard_{'trilinear' if tri else 'nearest'}"] = shade_compare(
            shade, gbuf, sky, tri, keep=~ties)
    rng = np.random.default_rng(0)
    for mips in (1, 4):
        synth = pack_shade_tables(synthetic_textured_scene(0, mips=mips, device=device))
        g = gbuffer_planes(torch.from_numpy(random_gbuffer(
            rng, 65_536, synth.scene.materials.count, mips=mips > 1)).to(device))
        for tri in (False, True):
            err[f"synthetic_mips{mips}_{'trilinear' if tri else 'nearest'}"] = shade_compare(
                synth, g, sky, tri)
    S, mat, uv, lam = split_gbuffer(gbuf)
    out = dict(max_abs_diff=err, mip_boundary_rays=near)
    out["ms"] = timed(lambda: texture_shade(shade, gbuf), FRAMES, device)
    if device.type == "cuda":   # the kernel's own time: shorter than its wrapper's host time
        out["device_ms"] = kernel_device_ms(lambda: texture_shade(shade, gbuf),
                                            "texshade_kernel", FRAMES, device)
    out["plain_ms"] = timed(lambda: shade_deferred(shade.scene, S, mat, uv, lam=lam),
                            PLAIN_FRAMES, device)
    out["card"] = card
    log(f"phase 8 K4: {json.dumps(out)}")
    return out


def phase_textured_main(scene, width, height, device, card, ties, ref=None):
    """Phase 9: the textured main path, Renderer.render_device() at full
    size (K3 then K4 on a CUDA device), warm, timed."""
    import torch

    from gpu_raytracer_tpu_torch.engine.renderer import Renderer
    from gpu_raytracer_tpu_torch.ops.render import render_deferred_chunk

    out = {}
    for shadows in (False, True):
        r = Renderer(scene, width, height, shadows=shadows, device=device)
        first = r.render_device()
        launch_tally().clear()
        ms = timed(r.render_device, FRAMES, device)
        launches = frame_launches()
        k3, k4, k3_pre = launches["k3"], launches["k4"], launches["k3_pre"]
        k2, k1 = launches["k2"], launches["k1_standalone"]
        frame = r.render_device()
        if not torch.equal(frame, first) or not torch.isfinite(frame).all():
            raise AssertionError("textured frames differ between runs or are not finite")
        if frame.shape != (width * height, 3):
            raise AssertionError(f"textured frame shape {tuple(frame.shape)}")
        if device.type == "cuda" and (k3 < FRAMES or k4 < FRAMES or k3_pre != k3 or k2 or k1):
            raise AssertionError(f"textured path launched K3 {k3}, its pre-pass {k3_pre}, "
                                 f"K4 {k4}, K2 {k2}, K1 {k1} times in {FRAMES} frames")
        plain = lambda: render_deferred_chunk(r.scene, r.px, r.py, width, height,
                                              shadows=shadows, sky=r.sky)
        want = plain_ref(None if ref is None else (ref, "frame", width, height, shadows), plain)
        diff = (frame - want).abs().amax(dim=1)
        err = diff[~ties].max().item()
        if err > RGB_TOL:
            raise AssertionError(f"textured frame max |diff| {err:.3g} outside ties")
        plain_ms = timed(plain, PLAIN_FRAMES, device)
        rays = width * height * 3
        out["shadows" if shadows else "no_shadows"] = dict(
            ms=ms, mrays_per_s=rays / (ms * 1e-3) / 1e6, plain_ms=plain_ms,
            plain_mrays_per_s=rays / (plain_ms * 1e-3) / 1e6, k3_launches=k3,
            k3_pre_launches=k3_pre, k4_launches=k4, k2_launches=k2, k1_standalone_launches=k1,
            max_abs_err=err,
            err_with_ties=diff.max().item(), tie_pixels=int(ties.sum()),
            mean=frame.mean().item())
    out["card"] = card
    log(f"phase 9 textured main path {width}x{height}: {json.dumps(out)}")
    return out


# ---- the path tracer (phases 10-12) ----

F32_MAX = 3.4028234663852886e38
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (HBM3 peak rate)
FP32_FLOPS_PER_S = 67e12    # H100 SXM FP32 outside the tensor cores
# FP32 operations per unit of work, counted from the kernel sources:
SLAB_FLOPS = 25      # one child's slab test: 6 sub, 6 mul, 10 min/max, 1 max, 2 compares;
                     # charged once per non-empty child slot of each visited node
                     # (traversal_work's slots), at either width: the walk also tests a
                     # record's empty slots, work that the closest hit does not need
TRI_FLOPS = 54       # one Moller-Trumbore test (traverse.cuh leaf_test)
# K3's camera walk over its pre-pass's tables (traverse.cuh REL): the box
# planes come as plane - o, so a slab test has no subtraction, and s = o - v0,
# q = s x e1 and e2 . q (3 + 9 + 5 operations) are read from the triangle rows
SLAB_REL_FLOPS = SLAB_FLOPS - 6
TRI_REL_FLOPS = TRI_FLOPS - 17
REL_TRI_BYTES = 64   # a camera-relative triangle row: four float4
SPHERE_FLOPS = 25    # one sphere test (render_common.cuh sphere_hit)
SHADE_FLOPS = 120    # per hit: normal, one light's intensity, ambient, blend (K2, K3, K6)
SAMPLE_FLOPS = 150   # per K6 continuation: ONB, cosine lobe, mirror, Fresnel, roulette
TEXEL_FLOPS = 60     # one bilinear map sample (texsample.cuh bilinear + tap setup)
MAX_DEPTH = 4        # config.max_bounce_depth: the path tracer's main path
RR_START = 2         # config.russian_roulette_start
PT_SIZE = 1024       # the path tracer's frame edge (the JAX benchmark's sections 2 and 4b)
PT_STEPS = 8         # timed steps of the kernel path
PT_PLAIN_STEPS = 4   # steps of the plain path on the card (timed; its 4-spp image)
PT_IMAGE_SHARE = 0.999   # pixels of the 4-spp image within RGB_TOL of the plain path's
SYNTH_SIZE = 256     # the synthetic textured scene's frame edge


def bound_ms(bytes_moved: float, flops: float) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the FP32 operations over the FP32 peak."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def table_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def sampler_table_bytes(shade) -> int:
    """The sampler's tables as the work needs them: metadata, level records
    and every texel once (the pair atlas holds each texel twice)."""
    return table_bytes(shade.maps, shade.levels) + shade.atlas.numel() * 2


def walk_flops(work) -> float:
    """FP32 operations of K1 walks from traversal_work's counts: a slab test
    per non-empty child slot of a visited node, a triangle test per
    triangle."""
    w = work.sum(dim=0).tolist()
    return float(w[4] * SLAB_FLOPS + w[1] * TRI_FLOPS)


def camera_pool(tables, width, height, sample=0, seed=0):
    """The path tracer's depth-0 pool: one QMC-jittered full-RGB camera ray
    per pixel, tile-major (engine/pathtracer.py::_sample_chunk)."""
    import torch

    from gpu_raytracer_tpu_torch.engine.renderer import tiled_pixel_order
    from gpu_raytracer_tpu_torch.ops.sampler import qmc_jitter
    from gpu_raytracer_tpu_torch.ops.wavefront import RGB_CHANNEL, camera_wavefront_rays

    dev = tables.device
    px, py = (torch.from_numpy(a).to(dev) for a in tiled_pixel_order(width, height))
    lane = torch.arange(px.shape[0], dtype=torch.int64, device=dev)
    jitter = qmc_jitter(lane, torch.full_like(lane, sample), seed)
    return camera_wavefront_rays(tables.scene.camera, width, height, px, py, RGB_CHANNEL,
                                 jitter=jitter, fov_scale=tables.render.fov_scale)


def pools(tables, width, height, depths, tex_lod_bias=0.0):
    """(depth, pool, order, live count, QMC stream, bounce arguments) of one
    path-tracer sample at each of `depths`: the main path's pools, advanced
    in place by the plain bounce and ordered between depths as the main path
    orders them. The pool yielded is a copy."""
    import torch

    from gpu_raytracer_tpu_torch.ops.sampler import QmcStream
    from gpu_raytracer_tpu_torch.ops.pool import bounce_flags
    from gpu_raytracer_tpu_torch.ops.wavefront import bounce_, coherence_order

    scene = tables.scene
    r = camera_pool(tables, width, height)
    rad = torch.zeros((r.count, 3), dtype=torch.float32, device=tables.device)
    qmc = QmcStream()
    order = None
    for depth in range(max(depths) + 1):
        n_live = r.active.sum()
        if depth > 0:
            order = coherence_order(scene, r, order)
        flags = bounce_flags(scene, depth, MAX_DEPTH, RR_START, True, tex_lod_bias)
        if depth in depths:
            yield depth, r.clone(), order, n_live if depth else None, qmc, flags
        if depth < max(depths):
            bounce_(scene, r, rad, depth=depth, order=order, n_live=n_live if depth else None,
                    qmc=qmc, **flags)


def bounce_compare(tables, r, flags, *, depth=0, order=None, n_live=None, qmc=None, u=None,
                   ref=None):
    """K6 against its plain version on one pool, both in place on copies:
    over the WHOLE pool (so a lane the launch must not touch is held to bit
    equality) integer fields and `active` equal, float fields and the
    radiance (accumulated onto a non-zero start) within RGB_TOL with NaN in
    the same lanes, outside live lanes whose closest triangle the two
    traversal orders pick differently at the exact same t (counted). The
    uniforms are `u` by position, or the QMC stream `qmc` at `depth`, which
    the kernel computes itself. The plain bounce's pool and radiance and
    the plain hits are kept under `ref` (plain_ref)."""
    import torch

    from gpu_raytracer_tpu_torch.ops.cuda.bounce import fused_bounce_
    from gpu_raytracer_tpu_torch.ops.wavefront import bounce_

    start = torch.full((r.count, 3), 0.25, dtype=torch.float32, device=tables.device)
    got, grad = r.clone(), start.clone()
    kw = dict(flags, depth=depth, order=order, n_live=n_live, qmc=qmc, u=u)
    fused_bounce_(tables, got, grad, **kw)

    def plain():
        want, wrad = r.clone(), start.clone()
        bounce_(tables.scene, want, wrad, **kw)
        return want, wrad

    want, wrad = plain_ref(ref, plain)
    far = torch.full((r.count,), F32_MAX, device=tables.device)
    ties = k1_compare(tables.render.trace, r.origin, r.direction, far,
                      ref=None if ref is None else ref + ("k1",))[1] & r.active
    keep = ~ties
    n_ties = int(ties.sum())
    for name in ("wavelength_channel", "ray_type", "bounce_depth", "active"):
        a, b = getattr(got, name)[keep], getattr(want, name)[keep]
        if not torch.equal(a, b):
            raise AssertionError(f"K6 {name} differs on {(a != b).sum().item()} lanes "
                                 f"outside {n_ties} ties ({flags})")
    err = {}
    for name, a, b in (("origin", got.origin, want.origin),
                       ("direction", got.direction, want.direction),
                       ("throughput", got.throughput, want.throughput),
                       ("medium_ior", got.medium_ior, want.medium_ior),
                       ("radiance", grad, wrad)):
        a, b = a[keep], b[keep]
        if not torch.equal(torch.isnan(a), torch.isnan(b)):
            raise AssertionError(f"K6 {name}: NaN lanes differ from the plain bounce")
        d = torch.nan_to_num((a - b).abs(), nan=0.0)
        err[name] = d.max().item() if d.numel() else 0.0
    tol = SAMPLER_TOL if tables.shade is not None else RGB_TOL   # K5 inside: exact
    if max(err.values()) > tol:
        raise AssertionError(f"K6 off the plain bounce by {err} > {tol} ({flags})")
    if n_ties > TIE_BUDGET * r.count:
        raise AssertionError(f"{n_ties} tie lanes > {TIE_BUDGET:.2%} of the pool")
    # what the launch must leave alone: a dead lane, bit for bit
    dead = ~r.active
    for name in ("origin", "direction", "throughput", "medium_ior", "wavelength_channel",
                 "ray_type", "bounce_depth", "active"):
        if not torch.equal(getattr(got, name)[dead], getattr(r, name)[dead]):
            raise AssertionError(f"K6 wrote {name} of a dead lane")
    if not torch.equal(grad[dead], start[dead]):
        raise AssertionError("K6 added radiance to a dead lane")
    return dict(lanes=r.count, live=int(r.active.sum()), next_live=int(got.active.sum()),
                ties=n_ties, max_abs_err=max(err.values()),
                nan_lanes=int(torch.isnan(grad).any(dim=1).sum()))


def phase_k6(tables, width, height, label, biases=(0.0,), depths=(0, 2), ref=None):
    """K6 against the plain bounce on the main path's pools of one scene;
    the pools (made by the plain bounce) and the plain outputs are kept
    under `ref` (a scene's name, plain_ref)."""
    out = {}
    for bias in biases:
        key = None if ref is None else (ref, "k6", width, height, bias)
        made = plain_ref(None if key is None else key + ("pools", depths),
                         lambda: list(pools(tables, width, height, depths, bias)))
        for depth, r, order, n_live, qmc, flags in made:
            out[f"{label}_lod_bias{bias:g}_depth{depth}"] = bounce_compare(
                tables, r, flags, depth=depth, order=order, n_live=n_live, qmc=qmc,
                ref=None if key is None else key + (depth,))
    return out


def k5_compare(tables, mat_id, uv, lod):
    """The standalone K5 launch against its plain version -> max |diff|."""
    import torch

    from gpu_raytracer_tpu_torch.ops.cuda.bounce import material_channels, sample_materials

    got = sample_materials(tables, mat_id, uv, lod)
    want = material_channels(tables.scene, mat_id, uv, lod)
    if not torch.equal(torch.isnan(got), torch.isnan(want)):
        raise AssertionError("K5 NaN channels differ from the plain material sample")
    err = torch.nan_to_num((got - want).abs(), nan=0.0).max().item()
    if err > SAMPLER_TOL:
        raise AssertionError(f"K5 max |diff| {err:.3g} > {SAMPLER_TOL} at lod {lod}")
    return err


def phase_k5(ttables, synth_tables, device, card, size):
    """K5 on its own: on the textured courtyard's camera-ray hits (the main
    path's depth-0 inputs) and on random ids and uvs of the synthetic scene
    (every wrap mode and map slot, mip chains), at several levels."""
    import numpy as np
    import torch

    from gpu_raytracer_tpu_torch.ops.cuda.bounce import material_channels, sample_materials
    from gpu_raytracer_tpu_torch.ops.trace import trace

    r = camera_pool(ttables, size, size)
    hit = trace(ttables.scene, r.origin, r.direction)
    mid = hit.material_id[hit.hit].to(torch.int32).contiguous()
    uv = hit.uv[hit.hit].contiguous()
    err = {f"courtyard_lod{lod:g}": k5_compare(ttables, mid, uv, lod) for lod in (0.0, 1.0)}
    rng = np.random.default_rng(5)
    n = 65_536
    smid = torch.from_numpy(rng.integers(-1, synth_tables.scene.materials.count + 2, n)
                            .astype(np.int32)).to(device)
    suv = torch.from_numpy(rng.uniform(-1.5, 2.5, (n, 2)).astype(np.float32)).to(device)
    for lod in (0.0, 1.0, 2.5):
        err[f"synthetic_lod{lod:g}"] = k5_compare(synth_tables, smid, suv, lod)
    sh = ttables.shade
    n_maps = bin(sh.present).count("1")
    bytes_moved = mid.shape[0] * (4 + 8 + 44) + table_bytes(sh.materials) + sampler_table_bytes(sh)
    bms, by = bound_ms(bytes_moved, mid.shape[0] * n_maps * TEXEL_FLOPS)
    out = dict(max_abs_diff=err, hits=int(mid.shape[0]),
               ms=timed(lambda: sample_materials(ttables, mid, uv), FRAMES, device),
               device_ms=(kernel_device_ms(lambda: sample_materials(ttables, mid, uv),
                                           "sample_materials_kernel", FRAMES, device)
                          if device.type == "cuda" else None),
               plain_ms=timed(lambda: material_channels(ttables.scene, mid, uv), PLAIN_FRAMES,
                              device),
               bound_ms=bms, bound_by=by, card=card)
    log(f"phase 11b K5: {json.dumps(out)}")
    return out


def phase_qmc(device, card, n):
    """Phase 11c: the bounce kernel's own QMC numbers (a standalone launch of
    its stream, csrc/qmc.cu) against ops/sampler.py's on the card, bit for
    bit, over seeds, depths, sample bases and samples per step across the
    uint32 range."""
    import torch

    from gpu_raytracer_tpu_torch.ops.cuda.bounce import qmc_uniforms_kernel
    from gpu_raytracer_tpu_torch.ops.sampler import QmcStream
    from gpu_raytracer_tpu_torch.ops.wavefront import pool_uniforms

    cases = [(QmcStream(), 0), (QmcStream(0, 7, 12345, 1), 2), (QmcStream(0, 3, 2**31 + 5, 4), 4),
             (QmcStream(2**32 - 1000, 2**32 - 3, 2**32 - 1, 2), 63)]
    lane = torch.arange(n, device=device)
    checked = 0
    for stream, depth in cases:
        got = qmc_uniforms_kernel(stream, depth, n, device)
        want = pool_uniforms(stream, depth, lane, n)
        if not torch.equal(got, want):
            bad = int((got != want).any(dim=1).sum())
            raise AssertionError(f"in-kernel QMC uniforms differ from qmc_uniforms on {bad} of "
                                 f"{n} lanes ({stream}, depth {depth})")
        if got.min().item() < 0.0 or got.max().item() >= 1.0:
            raise AssertionError("in-kernel QMC uniforms outside [0, 1)")
        checked += got.numel()
    stream, depth = cases[1]
    out = dict(bit_equal_values=checked, cases=len(cases),
               ms=timed(lambda: qmc_uniforms_kernel(stream, depth, n, device), FRAMES, device),
               plain_ms=timed(lambda: pool_uniforms(stream, depth, lane, n), PLAIN_FRAMES,
                              device), card=card)
    log(f"phase 11c in-kernel QMC uniforms of {n} lanes: {json.dumps(out)}")
    return out


class _swap:
    """Replace an attribute for the duration of a `with` block."""

    def __init__(self, obj, name, value):
        self.obj, self.name, self.value = obj, name, value

    def __enter__(self):
        self.old = getattr(self.obj, self.name)
        setattr(self.obj, self.name, self.value)

    def __exit__(self, *exc):
        setattr(self.obj, self.name, self.old)
        return False


BOUNCE_KERNELS = ("k5", "k5_w8", "k6", "k6_w8")


@contextlib.contextmanager
def plain_bounces():
    """Within the block the path tracer runs the plain bounce on the card
    (the name path_trace_pool calls, ops.pool.fused_bounce_, is swapped);
    it raises if K5 or K6 launched inside the block all the same."""
    from gpu_raytracer_tpu_torch.ops import pool
    from gpu_raytracer_tpu_torch.ops.wavefront import bounce_

    before = {k: launch_tally()[k] for k in BOUNCE_KERNELS}
    with _swap(pool, "fused_bounce_",
               lambda tables, r, radiance, **kw: bounce_(tables.scene, r, radiance, **kw)):
        yield
    moved = {k: launch_tally()[k] - n for k, n in before.items() if launch_tally()[k] != n}
    if moved:
        raise AssertionError(f"the plain bounce launched kernels: {moved}")


def recorded_bounces(record: list):
    """Within the block every K6 call also appends a copy of its pool as it
    was before the bounce, and its arguments, to `record`."""
    from gpu_raytracer_tpu_torch.ops import pool

    kernel = pool.fused_bounce_

    def rec(tables, r, radiance, **kw):
        record.append((r.clone(), kw))
        return kernel(tables, r, radiance, **kw)

    return _swap(pool, "fused_bounce_", rec)


class StageTimer:
    """Per-stage CUDA events of PathTracer steps, recorded by wrapping
    module functions for the duration of a `with` block (the package has
    no timing hook): the camera pool ends where the depth loop
    (path_trace_pool) is entered; each coherence order, uniforms block (the
    independent stream only: the QMC numbers are made inside the bounce) and
    bounce ends where it returns (a depth's live count falls into its order,
    or at depth 0 its bounce); what the loop does after its last bounce ends
    where it returns, the accumulate with the step. Off the card it records
    nothing."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.events, self.seen = [], {}

    def mark(self, stage: str) -> None:
        import torch

        if not self.cuda:
            return
        if stage in ("sort", "uniforms", "bounce"):
            n = self.seen.get(stage, 0)
            self.seen[stage] = n + 1
            stage = f"{stage}{n + 1 if stage == 'sort' else n}"
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append((stage, ev))

    def _wrap(self, module, name, stage_in=None, stage_out=None):
        fn = getattr(module, name)

        def wrapper(*args, **kw):
            if stage_in:
                self.mark(stage_in)
            out = fn(*args, **kw)
            self.mark(stage_out)
            return out

        return _swap(module, name, wrapper)

    def __enter__(self):
        from gpu_raytracer_tpu_torch.engine import pathtracer
        from gpu_raytracer_tpu_torch.ops import pool

        self.stack = contextlib.ExitStack()
        for swap in (self._wrap(pathtracer, "path_trace_pool", "camera", "counts"),
                     self._wrap(pool, "coherence_order", stage_out="sort"),
                     self._wrap(pool, "stream_uniforms", stage_out="uniforms"),
                     self._wrap(pool, "fused_bounce_", stage_out="bounce")):
            self.stack.enter_context(swap)
        return self

    def __exit__(self, *exc):
        return self.stack.__exit__(*exc)

    def step(self, tracer_) -> dict:
        """One step -> {stage: ms} (empty off the card)."""
        import torch

        self.events, self.seen = [], {}
        self.mark("begin")
        tracer_.step()
        self.mark("accumulate")
        if not self.cuda:
            return {}
        torch.cuda.synchronize()
        ev = self.events
        return {stage: a.elapsed_time(b) for (_, a), (stage, b) in zip(ev, ev[1:])}


def median_stages(runs) -> dict:
    """Per-stage medians over steps (empty off the card: no events)."""
    return {k: statistics.median(r[k] for r in runs) for k in runs[0]}


L2_FLUSH_BYTES = 256 << 20   # > 5x the H100's 50 MB L2
PROFILE_SESSIONS = 3         # profiler sessions kernel_device_ms tries before it raises
PROFILER_SESSIONS = {}       # kernel name -> sessions each kernel_device_ms call needed


def kernel_device_ms(fn, words, calls: int, device, flush: bool = True) -> float:
    """Device time per call of fn spent in the kernels whose names hold one
    of `words`, each launched once a call (torch.profiler): a kernel's own
    time. Between CUDA events around one call, a kernel shorter than its
    wrapper's host time reads the host's time instead. The L2 is flushed (a
    256 MB write) before each call, so every call reads its inputs from
    memory, as its roofline bound counts them; back to back (`flush`
    false), a call finds what of the last one's inputs the L2 kept. Each
    word's time is the mean over the launches the profiler recorded (it has
    been seen to drop one of a session's kernels, and once to record none
    of a first session's); a session that recorded none of a word's, or
    more than one a call, is profiled again, and after PROFILE_SESSIONS
    such sessions it raises. The sessions each call needed are listed in
    PROFILER_SESSIONS (the run prints them), so that a recurring drop
    shows."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    words = (words,) if isinstance(words, str) else tuple(words)
    scratch = torch.empty(L2_FLUSH_BYTES if flush else 0, dtype=torch.uint8, device=device)
    fn()
    torch.cuda.synchronize(device)
    seen = []
    for _ in range(PROFILE_SESSIONS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                if flush:
                    scratch.zero_()
                fn()
            torch.cuda.synchronize(device)
        us, counts = dict.fromkeys(words, 0.0), dict.fromkeys(words, 0)
        for e in prof.key_averages():
            for w in words:
                if w in e.key:
                    t = getattr(e, "self_device_time_total", None)
                    us[w] += e.self_cuda_time_total if t is None else t
                    counts[w] += e.count
        seen.append(counts)
        if all(0 < c <= calls for c in counts.values()):
            PROFILER_SESSIONS.setdefault("+".join(words), []).append(len(seen))
            return sum(us[w] / counts[w] for w in words) / 1e3
    raise RuntimeError(f"kernel_device_ms: the profiler saw {seen} launches in {calls} calls "
                       f"in each of {PROFILE_SESSIONS} sessions")


def device_profile(fn, steps: int, device) -> dict:
    """Kernel time on the device per call of fn (torch.profiler), in all and
    by kind of kernel, the kernels and copies launched per call, and the
    host's time to enqueue one call (median; the device idle at its start,
    no synchronise inside)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    enqueue = []
    for _ in range(steps):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        fn()
        enqueue.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize(device)
    int64_elementwise = 0.0
    kinds = (("k6", "bounce_kernel"), ("sort", "sort"), ("sort", "radix"),
             ("gather_scatter", "index"), ("elementwise", "elementwise"),
             ("reduce", "reduce"), ("copy", "memcpy"), ("copy", "memset"))
    by_kind, launches = {}, {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        t = e.self_cuda_time_total if t is None else t
        if t > 0:
            kind = next((k for k, word in kinds if word in e.key.lower()), "other")
            by_kind[kind] = by_kind.get(kind, 0.0) + t / steps / 1e3
            launches[kind] = launches.get(kind, 0) + e.count / steps
            if kind == "elementwise" and ("long" in e.key or "int64" in e.key):
                int64_elementwise += t / steps / 1e3
    return dict(device_ms=sum(by_kind.values()), k6_device_ms=by_kind.get("k6", 0.0),
                host_enqueue_ms=statistics.median(enqueue), device_ms_by_kind=by_kind,
                int64_elementwise_ms=int64_elementwise,
                kernels_per_call=sum(v for k, v in launches.items() if k != "copy"),
                copies_per_call=launches.get("copy", 0))


POOL_READ_BYTES = 45      # per lane worked on: origin, direction, throughput 12 each, medium
                          # and channel 4 each, active 1
POOL_WRITE_BYTES = 52     # per survivor: origin, direction, throughput, channel, type, depth
                          # (read and written)
RADIANCE_BYTES = 24       # per lane worked on: 12 read, 12 written


def bounce_bound(tables, record):
    """Bytes and FP32 operations of the recorded K6 launches of one step.
    Bytes: per lane worked on the pool fields it reads and its radiance
    read and written, 4 bytes of order where the launch has one, per
    survivor the continuation written over it and per retired lane its
    flag; the uniforms only where the launch is handed them (28 bytes per
    hit; none when the kernel makes them); the tables once per launch.
    Operations: the closest-hit and shadow walks that these pools need
    (K1's own walk, counted on the card, in the launch's lane order, which
    also gives the SIMT efficiency of both bodies), spheres, shading and
    sampling per lane. `old_design` is the same step under the design
    before the in-place kernel: every lane of the pool read (53 bytes) and
    written (65), alive or not, and 4 bytes per uniform a live hit read."""
    import torch

    from gpu_raytracer_tpu_torch.ops.cuda.traverse import trace, traversal_work
    from gpu_raytracer_tpu_torch.ops.wavefront import pool_uniforms, sampled_shadow_rays

    scene, rt, sh = tables.scene, tables.render, tables.shade
    tr = rt.trace
    tbytes = table_bytes(tr.nodes, tr.tris, rt.materials, rt.lights, rt.spheres)
    if sh is not None:
        tbytes += table_bytes(tr.attrs, sh.maps, sh.atlas)
    n_sph = rt.spheres.shape[0]
    n_maps = bin(sh.present).count("1") if sh is not None else 0
    total_bytes = total_flops = old_bytes = 0.0
    walks = []
    lives = [int(r.active.sum()) for r, _ in record] + [0]
    for k, (r, kw) in enumerate(record):
        N = r.count
        order, n_live = kw.get("order"), kw.get("n_live")
        sel = torch.arange(N, device=tables.device) if order is None else order.long()
        if n_live is not None:
            sel = sel[:int(n_live)]
        sel = sel[r.active[sel]]                     # the lanes worked on, in launch order
        o, d = r.origin[sel].contiguous(), r.direction[sel].contiguous()
        far = torch.full((sel.shape[0],), F32_MAX, device=tables.device)
        closest = traversal_work(tr, o, d, far)
        hit = trace(tr, o, d, max_t=far)     # K1, held to the plain walk in phases 3 and 10
        flops = walk_flops(closest)
        n_live_lanes, n_hit = int(sel.shape[0]), int(hit.hit.sum())
        if n_live_lanes != lives[k]:
            raise AssertionError(f"launch {k} works on {n_live_lanes} lanes, {lives[k]} live")
        n_shadow, shadow_simt = 0, None
        if kw["shadows"]:
            if not kw["light_sample"]:
                raise AssertionError("the main path samples one light per hit")
            u = (kw["u"][:sel.shape[0]] if kw.get("u") is not None
                 else pool_uniforms(kw["qmc"], kw["depth"], sel, N))
            _, _, so, sd, smax = sampled_shadow_rays(scene, hit, hit.hit, u[:, 6])
            shadow = traversal_work(tr, so.contiguous(), sd.contiguous(), smax.contiguous(),
                                    any_hit=True)
            flops += walk_flops(shadow)
            n_shadow = int((smax > 0).sum())
            shadow_simt = simt_efficiency(shadow)
        flops += (n_live_lanes + n_shadow) * n_sph * SPHERE_FLOPS
        flops += n_hit * (SHADE_FLOPS + n_maps * TEXEL_FLOPS)
        if not kw["last"]:
            flops += n_hit * SAMPLE_FLOPS
        total_flops += flops
        survivors = lives[k + 1]
        u_cols = (1 if kw["light_sample"] else 0) + (0 if kw["last"] else 6)
        given_u = kw.get("u") is not None
        total_bytes += (n_live_lanes * (POOL_READ_BYTES + RADIANCE_BYTES
                                        + (4 if order is not None else 0))
                        + survivors * POOL_WRITE_BYTES + (n_live_lanes - survivors)
                        + (n_hit * 4 * u_cols if given_u else 0)
                        + (8 if n_live is not None else 0) + tbytes)
        old_bytes += N * (53 + 65) + n_hit * 4 * u_cols + tbytes
        walks.append(dict(live=n_live_lanes, hits=n_hit, shadow_rays=n_shadow, node_width=tr.width,
                          nodes=int(closest[:, 0].sum()), tris=int(closest[:, 1].sum()),
                          live_slots=int(closest[:, 4].sum()),
                          simt_closest=simt_efficiency(closest), simt_shadow=shadow_simt))
    ms, by = bound_ms(total_bytes, total_flops)
    old_ms, old_by = bound_ms(old_bytes, total_flops)
    return dict(bound_ms=ms, bound_by=by, bytes=total_bytes, flops=total_flops, walks=walks,
                old_design=dict(bound_ms=old_ms, bound_by=old_by, bytes=old_bytes))


def launch_tally() -> Counter:
    """The package's launch tally, build.LAUNCHES (imported at the call:
    chip_ab.py puts another tree's package on sys.path first)."""
    from gpu_raytracer_tpu_torch.ops.cuda.build import LAUNCHES

    return LAUNCHES


def frame_launches() -> Counter:
    """The launches tallied since `launch_tally().clear()` by kernel id,
    without camera_row: a camera move's own launch, which these checks
    leave to tests/test_torch_camera_row.py."""
    return Counter({k: n for k, n in launch_tally().items() if k != "camera_row"})


def phase_pathtracer(scene, label, device, card, size, keep=None):
    """Phase 12 for one scene: the main path, PathTracer.step() at
    PT_SIZE^2 (spectral, shadows, QMC-jittered anti-aliasing, depth 4):
    ms per sample, launch counts, the per-stage breakdown, the plain path
    on the card, the 4-spp image against it, and the sort-skipped reading.
    The plain path's 4-spp image goes into `keep[label]` where given."""
    import torch

    from gpu_raytracer_tpu_torch.engine.pathtracer import PathTracer
    from gpu_raytracer_tpu_torch.ops import pool

    def tracer():
        return PathTracer(scene, size, size, spectral=True, shadows=True,
                          antialias=True, sampler="qmc", device=device)

    pt = tracer()
    pt.step()
    if device.type == "cuda":   # a step never waits for the device: this raises if it does
        torch.cuda.set_sync_debug_mode("error")
        pt.step()
        torch.cuda.set_sync_debug_mode("default")
    pt.reset()
    launch_tally().clear()
    ms = timed(pt.step, PT_STEPS, device)
    launches = frame_launches()
    frame = pt.image_device()
    if frame.shape != (size, size, 3) or not torch.isfinite(frame).all():
        raise AssertionError(f"{label}: frame {tuple(frame.shape)} not finite")
    textured = pt.tables.shade is not None
    want = Counter(k6=PT_STEPS * (MAX_DEPTH + 1),
                   k5=PT_STEPS * (MAX_DEPTH + 1) if textured else 0)
    if device.type == "cuda" and launches != want:
        raise AssertionError(f"{label}: launches {launches}, want {want}")
    counts = pt.counters().rays_per_bounce[:MAX_DEPTH + 1]

    cuda = device.type == "cuda"

    def stages_of(tracer_, steps):
        """Median per-stage milliseconds of `steps` steps, one at a time."""
        with StageTimer(device) as timer:
            return median_stages([timer.step(tracer_) for _ in range(steps)])

    stages = stages_of(pt, PT_STEPS)
    if any(k.startswith("uniforms") for k in stages):
        raise AssertionError(f"{label}: a QMC step drew a uniform tensor outside the bounce: "
                             f"{sorted(stages)}")
    bound = None
    if cuda:   # K1's own walk is counted on the card
        record = []
        with recorded_bounces(record):
            pt.step()
        bound = bounce_bound(pt.tables, record)
        del record

    profile = device_profile(pt.step, PT_STEPS, device) if cuda else {}
    with _swap(pool, "coherence_order", lambda scene, r, previous=None: None):
        ms_unsorted = timed(pt.step, PT_STEPS, device)
        unsorted_stages = stages_of(pt, PT_STEPS)
        unsorted_profile = device_profile(pt.step, PT_STEPS, device) if cuda else {}

    kern = tracer()
    for _ in range(PT_PLAIN_STEPS):
        kern.step()
    plain = tracer()
    with plain_bounces():
        plain_stages = stages_of(plain, PT_PLAIN_STEPS)
    plain_ms = sum(plain_stages.values())
    diff = (kern.image_device() - plain.image_device()).abs().amax(dim=2)
    share = (diff <= RGB_TOL).float().mean().item()
    if share < PT_IMAGE_SHARE:
        raise AssertionError(f"{label}: {share:.4%} of the 4-spp image within {RGB_TOL} "
                             f"of the plain path < {PT_IMAGE_SHARE:.1%}")
    if keep is not None:
        keep[label] = plain.image_device()
    k6 = lambda st: sum(v for k, v in st.items() if k.startswith("bounce"))
    out = dict(ms_per_spp=ms, plain_ms_per_spp=plain_ms, ms_per_spp_unsorted=ms_unsorted,
               launches=launches, active_per_depth=counts, stages_ms=stages,
               unsorted_stages_ms=unsorted_stages, plain_stages_ms=plain_stages,
               k6_ms_per_spp=k6(stages), k6_ms_per_spp_unsorted=k6(unsorted_stages),
               k6_plain_ms_per_spp=k6(plain_stages), profile=profile,
               unsorted_profile=unsorted_profile,
               device_busy_share=profile["device_ms"] / ms if cuda else None,
               image_share_within_tol=share,
               image_max_abs_diff=diff.max().item(), mean=frame.mean().item(),
               k6_bound=bound, card=card)
    log(f"phase 12 path tracer {label} {size}x{size}: {json.dumps(out)}")
    return out


# ---- the glTF asset path, K2t and the many-light branch (phases 13-17) ----

def crop_pixels(width, height, edge, device):
    """Pixel coordinates of the centre `edge` x `edge` crop of the frame."""
    import torch

    w, h = min(edge, width), min(edge, height)
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.int32) + (height - h) // 2,
                            torch.arange(w, dtype=torch.int32) + (width - w) // 2, indexing="ij")
    return xs.reshape(-1).contiguous().to(device), ys.reshape(-1).contiguous().to(device)


def seeded_light_u(n: int, seed: int, device):
    import numpy as np
    import torch

    return torch.from_numpy(np.random.default_rng(seed).random(n, dtype=np.float32)).to(device)


def primary_compare(tables, shade, px, py, width, height, shadows, exclude, light_u=None,
                    sky=(0.1, 0.2, 0.3)):
    """The fused render (K2, or K2t with `shade` tables) against the plain
    render_chunk on the same pixels -> (stats, the kernel's frame). `exclude`
    marks the lanes left out of the bound (exact-t ties, mip-boundary lanes);
    their count is bounded too."""
    import torch

    from gpu_raytracer_tpu_torch.ops.render import render_chunk
    from gpu_raytracer_tpu_torch.ops.cuda.render import render_primary

    got = render_primary(tables, px, py, width, height, shadows=shadows, sky=sky,
                         light_u=light_u, shade=shade)
    ref = render_chunk(tables.scene, px, py, width, height, shadows=shadows, sky=sky,
                       light_u=light_u)
    if got.shape != (px.shape[0], 3) or not torch.isfinite(got).all():
        raise AssertionError(f"fused frame: shape {tuple(got.shape)}, finite "
                             f"{bool(torch.isfinite(got).all())}")
    diff = (got - ref).abs().amax(dim=1)
    err = diff[~exclude].max().item()
    n_ex = int(exclude.sum())
    tol = SAMPLER_TOL if shade is not None else RGB_TOL
    if err > tol:
        raise AssertionError(f"fused render max |diff| {err:.3g} > {tol} outside {n_ex} "
                             f"excluded lanes (textured={shade is not None}, "
                             f"sampled={light_u is not None}, shadows={shadows})")
    if n_ex > TIE_BUDGET * px.shape[0]:
        raise AssertionError(f"{n_ex} tie or mip-boundary lanes > {TIE_BUDGET:.2%}")
    return dict(err=err, err_with_excluded=diff.max().item(), excluded=n_ex,
                mean=got.mean().item()), got


def glb_round_trip(scene, images, tmp, name, device, wraps=None):
    """scene -> export_glb -> scene_from_gltf on `device` -> (scene, stats)."""
    from gpu_raytracer_tpu_torch.models.gltf import scene_from_gltf
    from gpu_raytracer_tpu_torch.models.gltf_export import export_glb
    from gpu_raytracer_tpu_torch.utils.jpeg import scan_decoder

    path = os.path.join(tmp, f"{name}.glb")
    t0 = time.perf_counter()
    export_glb(scene, path, images=images, texture_wrap=wraps)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = scene_from_gltf(path, device=device)
    load_s = time.perf_counter() - t0
    tex = loaded.textures
    stats = dict(export_s=export_s, load_s=load_s, glb_bytes=os.path.getsize(path),
                 triangles=loaded.num_triangles, bvh_nodes=loaded.bvh.num_nodes,
                 materials=loaded.materials.count, textures=tex.count,
                 atlas_rows=tex.num_rows, atlas_bytes=tex.data_u32.numel() * 4,
                 levels=sorted(set(tex.levels.tolist())), lights=loaded.lights.count,
                 present_slots=list(loaded.materials.present_slots),
                 jpeg_scan_decoder=scan_decoder())
    return loaded, stats


def phase_glb_round_trip(tscene, texture_size, tmp, width, height, device, card):
    """Phase 13: the textured courtyard through the writer and the loader;
    both scenes through Renderer; the two frames must be equal."""
    import torch

    from gpu_raytracer_tpu_torch.engine.renderer import Renderer
    from gpu_raytracer_tpu_torch.utils.procgen import courtyard_source_images

    loaded, out = glb_round_trip(tscene, courtyard_source_images(0, texture_size), tmp,
                                 "courtyard", device)
    if loaded.num_triangles != tscene.num_triangles:
        raise AssertionError(f"GLB scene has {loaded.num_triangles} triangles, the "
                             f"procedural one {tscene.num_triangles}")
    launch_tally().clear()
    for shadows in (False, True):
        want = Renderer(tscene, width, height, shadows=shadows, device=device).render_device()
        r = Renderer(loaded, width, height, shadows=shadows, device=device)
        got = r.render_device()
        parity = (got - want).abs().max().item()
        if parity != 0.0 or not torch.isfinite(got).all():
            raise AssertionError(f"gltf_parity_vs_procedural {parity} (shadows={shadows}), "
                                 f"must be 0.0")
        out[f"gltf_parity_{'shadows' if shadows else 'no_shadows'}"] = parity
        out[f"ms_{'shadows' if shadows else 'no_shadows'}"] = timed(r.render_device, FRAMES,
                                                                    device)
    out["launches"] = frame_launches()
    out["card"] = card
    log(f"phase 13 GLB round trip {width}x{height}: {json.dumps(out)}")
    return loaded, out


def phase_zoo(multi_slot, triangles, tmp, width, height, crop, device, card):
    """Phase 14 for one zoo: through the writer and the loader, then
    Renderer at full size (K3 then K4), nearest mip and trilinear, shadows
    off and on, timed, each held against the plain two-phase render on the
    centre crop -> (the loaded scene, stats)."""
    import torch

    from gpu_raytracer_tpu_torch.config import RaytracerConfig
    from gpu_raytracer_tpu_torch.engine.renderer import Renderer
    from gpu_raytracer_tpu_torch.ops.render import render_deferred_chunk
    from gpu_raytracer_tpu_torch.ops.cuda.render import pack_render_tables, render_deferred
    from gpu_raytracer_tpu_torch.ops.cuda.texshade import pack_shade_tables, texture_shade
    from gpu_raytracer_tpu_torch.utils.procgen import make_zoo_scene, zoo_source_images

    t0 = time.perf_counter()
    scene = make_zoo_scene(triangles, n_mats=ZOO_MATERIALS, n_texs=ZOO_TEXTURES, seed=0,
                           multi_slot=multi_slot)
    build_s = time.perf_counter() - t0
    loaded, out = glb_round_trip(scene, zoo_source_images(ZOO_TEXTURES, 0), tmp,
                                 f"zoo{int(multi_slot)}", device)
    out["build_s"] = build_s
    cpx, cpy = crop_pixels(width, height, crop, device)
    # K4 alone on the full frame's G-buffer: against the plain deferred shade, and timed
    px, py = frame_pixels(width, height, device)
    shade, tables = pack_shade_tables(loaded), pack_render_tables(loaded)
    out.update(bvh4_nodes=tables.trace.nodes.shape[0], bvh4_depth=tables.trace.depth)
    gbuf = render_deferred(tables, px, py, width, height)
    out["k3_ms"] = timed(lambda: render_deferred(tables, px, py, width, height), FRAMES, device)
    for trilinear in (False, True):
        name = "trilinear" if trilinear else "nearest"
        out[f"k4_max_abs_err_{name}"] = shade_compare(shade, gbuf, (0.1, 0.2, 0.3), trilinear)
        out[f"k4_ms_{name}"] = timed(lambda: texture_shade(shade, gbuf, trilinear=trilinear),
                                     FRAMES, device)
    del gbuf
    for trilinear in (False, True):
        config = RaytracerConfig(texture_trilinear=trilinear)
        for shadows in (False, True):
            r = Renderer(loaded, width, height, config=config, shadows=shadows,
                         sky=(0.1, 0.2, 0.3), device=device)
            first = r.render_device()
            launch_tally().clear()
            ms = timed(r.render_device, FRAMES, device)
            launches = frame_launches()
            if first.shape != (width * height, 3) or not torch.isfinite(first).all():
                raise AssertionError("zoo frame not finite or misshapen")
            if device.type == "cuda" and (launches["k3"] != FRAMES or launches["k4"] != FRAMES
                                          or launches["k3_pre"] != FRAMES
                                          or launches["k2"] or launches["k2t"]):
                raise AssertionError(f"zoo frames launched {launches} in {FRAMES} frames")
            ties = primary_ties(r.tables, width, height, cpx, cpy)
            got = r.render_rays(cpx, cpy)
            ref = render_deferred_chunk(r.scene, cpx, cpy, width, height, shadows=shadows,
                                        sky=r.sky, trilinear=trilinear)
            diff = (got - ref).abs().amax(dim=1)
            err = diff[~ties].max().item()
            if err > RGB_TOL or int(ties.sum()) > TIE_BUDGET * cpx.shape[0]:
                raise AssertionError(f"zoo frame (multi_slot={multi_slot}, trilinear="
                                     f"{trilinear}, shadows={shadows}) max |diff| {err:.3g} "
                                     f"outside {int(ties.sum())} ties")
            key = f"{'trilinear' if trilinear else 'nearest'}_{'shadows' if shadows else 'no_shadows'}"
            out[key] = dict(ms=ms, mrays_per_s=width * height * 3 / (ms * 1e-3) / 1e6,
                            max_abs_err_crop=err, crop_ties=int(ties.sum()),
                            k3_launches=launches["k3"], k4_launches=launches["k4"],
                            mean=first.mean().item())
    out["card"] = card
    log(f"phase 14 zoo multi_slot={multi_slot} {width}x{height}: {json.dumps(out)}")
    return loaded, out


def phase_k2t(scenes, width, height, device, card):
    """Phase 15: K2t on each textured scene at full size, shadows off and on,
    against the plain render_chunk; K3 + K4 on the same frames beside it.
    Each K2t call is one launch of K3's pre-pass and one of K2t. On the
    textured courtyard also K2t after the Viewer's "w", "d", 0.0 from the
    plain frame outside counted exact-t and order ties and mip-boundary
    lanes (moved_camera_compare), and its device time alone and with the
    pre-pass. -> (stats, K2t launches, pre-pass launches) of the timed
    frames."""
    import torch

    from gpu_raytracer_tpu_torch.ops.render import render_chunk
    from gpu_raytracer_tpu_torch.ops.cuda.render import (pack_render_tables, render_deferred,
                                                         render_primary)
    from gpu_raytracer_tpu_torch.ops.cuda.texshade import pack_shade_tables, texture_shade

    px, py = frame_pixels(width, height, device)
    sky = (0.1, 0.2, 0.3)
    out, launches_total, pre_total = {}, 0, 0
    for label, scene in scenes.items():
        tables, shade = pack_render_tables(scene), pack_shade_tables(scene)
        ties = primary_ties(tables, width, height, px, py)
        near = mip_boundary_mask(shade, render_deferred(tables, px, py, width, height))
        for shadows in (False, True):
            stats, frame = primary_compare(tables, shade, px, py, width, height, shadows,
                                           ties | near, sky=sky)
            stats.update(tie_pixels=int(ties.sum()), mip_boundary_pixels=int(near.sum()))
            two_phase = lambda: texture_shade(shade, render_deferred(
                tables, px, py, width, height, shadows=shadows), sky=sky)
            stats["max_abs_diff_to_k3_k4"] = (frame - two_phase()).abs().max().item()
            fused = lambda: render_primary(tables, px, py, width, height, shadows=shadows,
                                           sky=sky, shade=shade)
            launch_tally().clear()
            stats["ms"] = timed(fused, FRAMES, device)
            launches = frame_launches()
            if device.type == "cuda" and launches != Counter(k2t=FRAMES, k3_pre=FRAMES):
                raise AssertionError(f"K2t frames launched {launches} in {FRAMES} frames")
            launches_total += launches["k2t"]
            pre_total += launches["k3_pre"]
            stats["k2t_launches"] = launches["k2t"]
            stats["k3_k4_ms"] = timed(two_phase, FRAMES, device)
            stats["plain_ms"] = timed(lambda: render_chunk(scene, px, py, width, height,
                                                           shadows=shadows, sky=sky), 2, device)
            out[f"{label}_{'shadows' if shadows else 'no_shadows'}"] = stats
        if label == "textured_courtyard":
            out["moved_camera"] = moved_camera_compare((("k2t", tables, shade),), width, height,
                                                       device)["k2t"]
            if device.type == "cuda":
                out["k2t_device_ms"] = primary_device_ms(tables, px, py, width, height, shade,
                                                         device)
    out["card"] = card
    log(f"phase 15 K2t {width}x{height}: {json.dumps(out)}")
    return out, launches_total, pre_total


def phase_many_lights(triangles, texture_size, width, height, crop, device, card, ms_2_lights):
    """Phase 16: 64 lights. K2, K2t and K3 with a seeded light_u against the
    plain single-sample version on the full frame; their ms; the mean of
    LIGHT_DRAWS draws against the loop over every light."""
    import torch

    from gpu_raytracer_tpu_torch.engine.renderer import Renderer
    from gpu_raytracer_tpu_torch.ops.render import render_chunk, render_gbuffer, split_gbuffer
    from gpu_raytracer_tpu_torch.ops.cuda.render import (MAX_LIGHTS, pack_render_tables,
                                                         render_deferred, render_primary)
    from gpu_raytracer_tpu_torch.ops.cuda.texshade import pack_shade_tables
    from gpu_raytracer_tpu_torch.utils.procgen import make_courtyard_scene

    px, py = frame_pixels(width, height, device)
    cpx, cpy = crop_pixels(width, height, crop, device)
    N = px.shape[0]
    u = seeded_light_u(N, 64, device)
    out = {}
    for textured in (False, True):
        label = "textured" if textured else "untextured"
        scene = make_courtyard_scene(triangles, seed=0, lights=MANY_LIGHTS, textured=textured,
                                     texture_size=texture_size, device=device)
        if scene.lights.count != MANY_LIGHTS or MANY_LIGHTS <= MAX_LIGHTS:
            raise AssertionError(f"{scene.lights.count} lights")
        tables = pack_render_tables(scene)
        shade = pack_shade_tables(scene) if textured else None
        res = dict(scene=dict(
            triangles=scene.num_triangles, bvh_nodes=scene.bvh.num_nodes,
            bvh4_nodes=tables.trace.nodes.shape[0], lights=scene.lights.count,
            materials=scene.materials.count, textures=scene.textures.count if textured else 0,
            atlas_rows=scene.textures.num_rows if textured else 0,
            light_table_bytes=table_bytes(tables.lights)))
        ties = primary_ties(tables, width, height, px, py)
        exclude = ties
        if textured:
            exclude = ties | mip_boundary_mask(shade, render_deferred(tables, px, py, width,
                                                                      height))
        for shadows in (False, True):
            key = "shadows" if shadows else "no_shadows"
            stats, _ = primary_compare(tables, shade, px, py, width, height, shadows, exclude,
                                       light_u=u)
            fused = lambda: render_primary(tables, px, py, width, height, shadows=shadows,
                                           light_u=u, shade=shade)
            stats["ms"] = timed(fused, FRAMES, device)
            stats["ms_2_lights"] = ms_2_lights[label, shadows]
            res[f"{'K2t' if textured else 'K2'}_{key}"] = stats
            if textured:   # K3's sampled light sum against the plain G-buffer's
                got = split_gbuffer(render_deferred(tables, px, py, width, height,
                                                    shadows=shadows, light_u=u))
                ref = split_gbuffer(render_gbuffer(scene, px, py, width, height,
                                                   shadows=shadows, light_u=u))
                if not torch.equal(got[1][~ties], ref[1][~ties]):
                    raise AssertionError("K3 material ids differ under sampled lights")
                err = (got[0] - ref[0]).abs().amax(dim=1)[~ties].max().item()
                if err > GBUF_TOL:
                    raise AssertionError(f"K3 sampled light sum off by {err:.3g}")
                res[f"K3_{key}"] = dict(
                    S_err=err, ms=timed(lambda: render_deferred(
                        tables, px, py, width, height, shadows=shadows, light_u=u), FRAMES,
                        device))
        # the loop over every light: the kernel's against the plain one on the
        # crop, then the mean of the draws against the kernel's on the frame
        cties = primary_ties(tables, width, height, cpx, cpy)
        loop_crop = render_primary(tables, cpx, cpy, width, height, shadows=True, shade=shade)
        plain_crop = render_chunk(scene, cpx, cpy, width, height, shadows=True)
        err = (loop_crop - plain_crop).abs().amax(dim=1)[~cties].max().item()
        if err > RGB_TOL:
            raise AssertionError(f"{MANY_LIGHTS}-light loop max |diff| {err:.3g} on the crop")
        exact = render_primary(tables, px, py, width, height, shadows=True, shade=shade)
        res["loop_ms_shadows"] = timed(lambda: render_primary(
            tables, px, py, width, height, shadows=True, shade=shade), 2, device)
        acc = torch.zeros_like(exact)
        for k in range(LIGHT_DRAWS):
            acc += render_primary(tables, px, py, width, height, shadows=True,
                                  light_u=seeded_light_u(N, 100 + k, device), shade=shade)
        rel = abs((acc / LIGHT_DRAWS).sum().item() - exact.sum().item()) / exact.sum().item()
        if rel > LIGHT_MEAN_TOL:
            raise AssertionError(f"mean of {LIGHT_DRAWS} sampled frames off the loop's sum by "
                                 f"{rel:.3%} > {LIGHT_MEAN_TOL:.0%}")
        res.update(loop_max_abs_err_crop=err, sampled_mean_rel_err=rel)
        # Renderer's own route draws light_u itself; another frame number, other choices
        r = Renderer(scene, width, height, shadows=True, device=device)
        launch_tally().clear()
        f0 = r.render_device()
        r.light_frame = 1
        f1 = r.render_device()
        launches = frame_launches()
        want = (Counter(k3=2, k3_pre=2, k4=2) if textured
                else Counter(k2=2))
        if device.type == "cuda" and (launches != want or torch.equal(f0, f1)):
            raise AssertionError(f"Renderer under {MANY_LIGHTS} lights: launches {launches}, "
                                 f"frames equal {torch.equal(f0, f1)}")
        rel_r = abs(f0.sum().item() - exact.sum().item()) / exact.sum().item()
        res.update(renderer_launches=launches, renderer_frame_rel_err=rel_r,
                   renderer_ms=timed(r.render_device, FRAMES, device))
        res["light_salt"] = light_salt_check(r, exact)
        out[label] = res
    out["card"] = card
    log(f"phase 16 {MANY_LIGHTS} lights {width}x{height}: {json.dumps(out)}")
    return out


def light_salt_check(r, exact) -> dict:
    """Renderer's single-sample light choice per batch: the uniforms of
    (light_frame, salt) are light_uniforms', the same salt repeats its
    frame, another salt draws others, and the frames 0..LIGHT_DRAWS-1 of one
    salt average to the loop over every light (`exact`)."""
    import torch

    from gpu_raytracer_tpu_torch.engine.renderer import light_uniforms

    n = r.px.shape[0]
    if r.device.type == "cuda" and not torch.equal(r._light_u(n, 3),
                                                   light_uniforms(n, r.light_frame, 3, r.device)):
        raise AssertionError("Renderer's light uniforms are not light_uniforms(frame, salt)")
    a = r.render_rays(r.px, r.py, light_salt=3)
    b = r.render_rays(r.px, r.py, light_salt=3)
    c = r.render_rays(r.px, r.py, light_salt=4)
    acc = torch.zeros_like(exact)
    for k in range(LIGHT_DRAWS):
        r.light_frame = k
        acc += r.render_rays(r.px, r.py, light_salt=3)
    rel = abs((acc / LIGHT_DRAWS).sum().item() - exact.sum().item()) / exact.sum().item()
    if r.device.type == "cuda" and (not torch.equal(a, b) or torch.equal(a, c)
                                    or rel > LIGHT_MEAN_TOL):
        raise AssertionError(f"light salt: same salt equal {torch.equal(a, b)}, other salt "
                             f"equal {torch.equal(a, c)}, mean over frames off by {rel:.3%}")
    return dict(same_salt_equal=torch.equal(a, b),
                other_salt_pixels_differ=int((a != c).any(dim=1).sum()),
                frames_mean_rel_err=rel)


def phase_zoo_pathtrace(scene, size, device, card):
    """Phase 17: the path tracer on the GLB-loaded zoo, ZOO_PT_SAMPLES samples."""
    import torch

    from gpu_raytracer_tpu_torch.engine.pathtracer import PathTracer

    pt = PathTracer(scene, size, size, spectral=True, shadows=True, antialias=True,
                    sampler="qmc", device=device)
    pt.step()
    if device.type == "cuda":   # a step never waits for the device: this raises if it does
        torch.cuda.set_sync_debug_mode("error")
        try:
            pt.step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    pt.reset()
    launch_tally().clear()
    ms = timed(pt.step, ZOO_PT_SAMPLES, device)
    launches = frame_launches()
    n = ZOO_PT_SAMPLES * (MAX_DEPTH + 1)
    if device.type == "cuda" and launches != Counter(k6=n, k5=n):
        raise AssertionError(f"zoo path tracer launched {launches}")
    frame = pt.image_device()
    if frame.shape != (size, size, 3) or not torch.isfinite(frame).all():
        raise AssertionError("zoo path-traced frame not finite")
    out = dict(ms_per_spp=ms, samples=pt.samples, launches=launches,
               active_per_depth=pt.counters().rays_per_bounce[:MAX_DEPTH + 1],
               mean=frame.mean().item(), card=card)
    log(f"phase 17 path tracer on the GLB zoo {size}x{size}: {json.dumps(out)}")
    return out


# ---- the interactive stack: G-buffer, à-trous, fly-through, adaptive (phases 18-20) ----

DENOISE_ITERS = 4
PREVIEW_ITERS = 4        # PathTracer.denoised_frame's default: the Viewer's still preview
DENOISE_TOL = 1e-5       # the filter on the card against the CPU copy, x max(1, max |ref|)
DENOISE_CALLS = 8        # profiled filter calls
FLY_WARMUP_STEPS = 8     # full steps before the fly-through
FLY_WARMUP_FRAMES = 2    # fly frames before the timed ones (the first warp traces the old depth)
FLY_FRAMES = 16          # timed fly frames of each reading
FLY_INTERLEAVE = 8       # m: a fly frame samples 1/8 of the pixels (bench.py section 3b)
FLY_PATH = "dadawjdadawldada"   # strafe right / left, forward, turn left / right
FLY_TURN = 8.0           # mouse pixels of a turn
ADAPTIVE_TILES = 16      # tiles_per_step of phase 20
ADAPTIVE_EXTRA_STEPS = 4     # steps past the warm-up before the selection check


def no_host_sync(fn, device):
    """Run fn under set_sync_debug_mode("error"): it raises if fn makes the
    host wait for the device."""
    import torch

    if device.type != "cuda":
        return fn()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def phase_gbuffer_denoise(scene, size, device, card):
    """Phase 18: PathTracer.gbuffer() at size^2 on the textured courtyard (K1
    for the triangles, K5 for the albedo) against the plain trace and
    material_textures on the same card tensors; the à-trous filter on the
    card against the same call on a CPU copy; the filter's device time,
    host enqueue time and launches."""
    import torch

    from gpu_raytracer_tpu_torch.engine.pathtracer import PathTracer, primary_gbuffer
    from gpu_raytracer_tpu_torch.ops.camera_rays import generate_rays
    from gpu_raytracer_tpu_torch.ops.cuda.traverse import trace
    from gpu_raytracer_tpu_torch.ops.denoise import atrous_denoise
    from gpu_raytracer_tpu_torch.ops.shading import material_textures
    from gpu_raytracer_tpu_torch.ops.trace import trace as plain_trace

    cuda = device.type == "cuda"
    pt = PathTracer(scene, size, size, device=device)
    launch_tally().clear()
    normal, depth, albedo = no_host_sync(pt.gbuffer, device)
    launches = frame_launches()
    textured = pt.tables.shade is not None
    want = Counter(k1_standalone=1, k5_standalone=1 if textured else 0)
    if cuda and launches != want:
        raise AssertionError(f"gbuffer() launched {launches}, want {want}")

    grid = torch.arange(size * size, device=device)
    o, d = generate_rays(pt.scene.camera, size, size, grid % size, grid // size,
                         fov_scale=pt.tables.render.fov_scale)
    kh = trace(pt.tables.render.trace, o, d)      # gbuffer()'s trace again, for its slots
    ph = plain_trace(pt.scene, o, d)
    if not torch.equal(kh.t, depth.reshape(-1)):
        raise AssertionError("gbuffer() depth is not the K1 trace's t")
    if not torch.equal(kh.hit, ph.hit):
        raise AssertionError(f"G-buffer hit masks differ on {(kh.hit != ph.hit).sum().item()} "
                             f"pixels")
    h = kh.hit
    ties = h & (kh.prim_id != ph.prim_id) & (kh.t == ph.t)
    if (h & (kh.prim_id != ph.prim_id) & ~ties).any():
        raise AssertionError("G-buffer: another primitive at another t")
    t_rel = ((kh.t - ph.t).abs() / ph.t.abs().clamp(min=1e-30))[h].max().item()
    mid = torch.clamp(ph.material_id, min=0)
    p_alb = material_textures(pt.scene, mid, ph.uv)[0]
    p_alb = torch.where(ph.hit[:, None], p_alb, torch.ones_like(p_alb))
    keep = ~ties
    n_err = (normal.reshape(-1, 3) - ph.normal).abs().amax(dim=1)[keep].max().item()
    a_err = (albedo.reshape(-1, 3) - p_alb).abs().amax(dim=1)[keep].max().item()
    if t_rel > T_REL_TOL or n_err > 1e-6 or a_err > SAMPLER_TOL:
        raise AssertionError(f"G-buffer off the plain version: depth {t_rel:.3g} relative, "
                             f"normal {n_err:.3g}, albedo {a_err:.3g}")
    plain_ms = timed(lambda: plain_trace(pt.scene, o, d), 1, device)

    for _ in range(2):
        pt.step()
    img = pt.image_device()
    launch_tally().clear()
    den = no_host_sync(lambda: atrous_denoise(img, normal, depth, albedo,
                                              iterations=DENOISE_ITERS), device)
    den_launches = frame_launches()
    want = Counter(denoise=DENOISE_ITERS + 1)
    if cuda and den_launches != want:
        raise AssertionError(f"atrous_denoise launched {den_launches}, want {want}")
    t0 = time.perf_counter()
    ref = atrous_denoise(img.cpu(), normal.cpu(), depth.cpu(), albedo.cpu(),
                         iterations=DENOISE_ITERS)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    d_err = (den.cpu() - ref).abs().max().item()
    bar = DENOISE_TOL * max(1.0, ref.abs().max().item())
    if den.shape != (size, size, 3) or not torch.isfinite(den).all() or d_err > bar:
        raise AssertionError(f"à-trous on the card off the CPU copy by {d_err:.3g} "
                             f"(bar {bar:.3g})")
    denoise = lambda: atrous_denoise(img, normal, depth, albedo, iterations=DENOISE_ITERS)
    gbuf = lambda: primary_gbuffer(pt.tables, grid % size, grid // size, size, size)
    out = dict(gbuffer=dict(pixels=size * size, hits=int(h.sum()), ties=int(ties.sum()),
                            depth_rel=t_rel, normal_abs=n_err, albedo_abs=a_err,
                            launches=launches, ms=timed(gbuf, FRAMES, device),
                            plain_trace_ms=plain_ms),
               denoise=dict(iterations=DENOISE_ITERS, max_abs_diff_to_cpu=d_err, bar=bar,
                            launches=den_launches,
                            ms=timed(denoise, DENOISE_CALLS, device), cpu_ms=cpu_ms,
                            **(device_profile(denoise, DENOISE_CALLS, device) if cuda else {})),
               card=card)
    log(f"phase 18 G-buffer and à-trous {size}x{size}: {json.dumps(out)}")
    return out


FLY_ITERS = 3             # the Viewer's moving frames' passes (Viewer.fly_denoise_iters)
ATROUS_ITERS = (FLY_ITERS, PREVIEW_ITERS)   # phase 18b: a moving frame's, the still preview's
ATROUS_CALLS = 8          # timed calls of each reading
FILTER_FIELD_BYTES = 36   # benchmark/roofline.py fly_frame: a pass's field, read once
FILTER_TAP_FLOPS = 30     # and one tap's operations


def filter_bound(pixels: int, passes: int) -> tuple[float, str]:
    """The filter term of benchmark/roofline.py::fly_frame: each pass reads
    the packed field once and writes the colour; demodulation and
    remodulation read colour and albedo and write colour; 25 taps a pixel
    and pass."""
    return bound_ms(pixels * (passes * (FILTER_FIELD_BYTES + 12) + 2 * (12 + 12 + 12)),
                    pixels * passes * 25 * FILTER_TAP_FLOPS)


def flushed_device_ms(fn, calls: int, device) -> float:
    """Median device milliseconds of one call of fn, the L2 flushed (a 256 MB
    write) before each, timed between events enqueued behind a spin kernel
    (torch.cuda._sleep), so that they time the device's work for the call
    and not the host's launches."""
    import torch

    scratch = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=device)
    fn()
    times = []
    for _ in range(calls):
        scratch.zero_()
        torch.cuda._sleep(20_000_000)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_atrous(scene, size, device, card):
    """Phase 18b: the à-trous filter's kernels at size^2 on a path-traced
    frame of `scene` (8 samples) and its G-buffer, against the plain
    version on the same tensors, and timed beside its bound and the plain
    version's time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gpu_raytracer_tpu_torch.engine.pathtracer import PathTracer
    from gpu_raytracer_tpu_torch.ops.denoise import atrous_denoise, plain_atrous_denoise

    cuda = device.type == "cuda"
    pt = PathTracer(scene, size, size, device=device)
    for _ in range(8):
        pt.step()
    img, planes = pt.image_device(), pt.gbuffer()
    out = dict(size=size, card=card)
    for iters in ATROUS_ITERS:
        call = lambda: atrous_denoise(img, *planes, iterations=iters)
        plain = lambda: plain_atrous_denoise(img, *planes, iterations=iters)
        launch_tally().clear()
        got = no_host_sync(call, device)
        launches = frame_launches()
        ref = plain()
        err = (got - ref).abs().max().item()
        bar = DENOISE_TOL * max(1.0, ref.abs().max().item())
        if not torch.isfinite(got).all() or err > bar:
            raise AssertionError(f"à-trous kernels ({iters} passes) off the plain version by "
                                 f"{err:.3g} (bar {bar:.3g})")
        if cuda and launches != Counter(denoise=iters + 1):
            raise AssertionError(f"à-trous ({iters} passes) launched {launches}, want "
                                 f"{iters + 1} of the filter's kernels")
        bound, bound_by = filter_bound(size * size, iters)
        r = dict(passes=iters, max_abs_diff_to_plain=err, bar=bar, launches=launches["denoise"],
                 bound_ms=bound, bound_by=bound_by, plain_ms=timed(plain, 2, device))
        if cuda:
            r["device_ms"] = flushed_device_ms(call, ATROUS_CALLS, device)
            r["device_ms_back_to_back"] = device_batch_ms(call, ATROUS_CALLS, device)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(ATROUS_CALLS):
                    call()
                torch.cuda.synchronize(device)
            # the kernels of the call: the two hand-written ones, torch.sort's
            # (cub's radix sort) and any other, by name
            split, others = dict(prepare=0.0, sort=0.0, passes=0.0), {}
            for e in prof.key_averages():
                t = getattr(e, "self_device_time_total", None)
                t = (e.self_cuda_time_total if t is None else t) / ATROUS_CALLS / 1e3
                key = e.key.lower()
                part = ("prepare" if "atrous_prepare" in key else "passes" if "atrous_pass" in key
                        else "sort" if "sort" in key or "radix" in key else None)
                if part is not None:
                    split[part] += t
                elif t > 0:
                    others[e.key[:120]] = e.count / ATROUS_CALLS
            other = sum(others.values())
            r.update(kernels_device_ms=sum(split.values()), kernels_split_ms=split,
                     hand_written_device_ms=split["prepare"] + split["passes"],
                     other_kernels_per_call=other, other_kernels=others,
                     roofline_pct=100.0 * bound / r["device_ms"],
                     host_enqueue_ms=device_profile(call, ATROUS_CALLS, device)[
                         "host_enqueue_ms"],
                     plain_device_ms=device_profile(plain, 2, device)["device_ms"])
        out[f"passes_{iters}"] = r
    log(f"phase 18b à-trous kernels {size}x{size}: {json.dumps(out)}")
    return out


def fly_cameras(camera):
    """Host cameras along FLY_PATH, repeated without end: the Viewer's keys
    d / a (strafe), w (forward) and a turn of FLY_TURN mouse pixels (j left,
    l right)."""
    from gpu_raytracer_tpu_torch.models.camera import CameraController

    ctrl = CameraController(camera)   # reads the camera back now, not inside a frame

    def path():
        for i in itertools.count():
            k = FLY_PATH[i % len(FLY_PATH)]
            if k in "da":
                ctrl.move(strafe=1.0 if k == "d" else -1.0)
            elif k == "w":
                ctrl.move(forward=1.0)
            else:
                ctrl.rotate(FLY_TURN if k == "j" else -FLY_TURN, 0.0)
            yield ctrl.camera()

    return path()


FLY_STAGE_CALLS = (("module", "primary_gbuffer", "warp_trace"),
                   ("module", "_warp_history", "warp"),
                   ("class", "_coset_step", "coset_step"),
                   ("class", "gbuffer", "gbuffer_reorder"),
                   ("class", "image_device", "image"),
                   ("module", "atrous_denoise", "denoise"),
                   ("module", "to_u8", "encode"),
                   ("class", "fly_frame", "frame"))


def fly_stage_device_ms(fly, frames: int, device) -> dict:
    """Device time per fly frame of each stage's kernels (torch.profiler:
    the kernels launched inside a record_function range around the
    stage's function), the warp split into its trace and the rest
    (history: reprojection, gather, depth test), and `other` for what the
    frame runs outside the stages (the camera row's rewrite, the weights'
    fold, the jitter)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from gpu_raytracer_tpu_torch.engine import pathtracer

    def ranged(fn, stage):
        def wrapper(*args, **kw):
            with record_function(f"fly:{stage}"):
                return fn(*args, **kw)
        return wrapper

    with contextlib.ExitStack() as stack:
        for where, name, stage in FLY_STAGE_CALLS:
            owner = pathtracer if where == "module" else pathtracer.PathTracer
            stack.enter_context(_swap(owner, name, ranged(getattr(owner, name), stage)))
        torch.cuda.synchronize(device)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(frames):
                fly()
            torch.cuda.synchronize(device)
    out = {}
    for e in prof.key_averages():
        if e.key.startswith("fly:"):
            t = getattr(e, "device_time_total", None)
            out[e.key[4:]] = (e.cuda_time_total if t is None else t) / frames / 1e3
    # a range counts the kernels launched in it outside the ranges nested in
    # it: the warp's own are the history's, the frame's own the rest
    out["history"] = out.pop("warp")
    out["other"] = out.pop("frame")
    return out


def device_batch_ms(fn, calls: int, device) -> float:
    """Device milliseconds per call of fn over `calls` calls enqueued behind
    a spin kernel (torch.cuda._sleep), so that the events around them time
    the device back to back and not the host's launches: for kernels too
    short to time one at a time."""
    import torch

    torch.cuda.synchronize(device)
    torch.cuda._sleep(50_000_000)   # ~25 ms of spinning: the host enqueues ahead
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / calls


def phase_fly(scene, label, size, device, card):
    """Phase 19: the fly-through, FLY_WARMUP_STEPS full steps then
    PathTracer.fly_frame(camera, m=FLY_INTERLEAVE, iterations=4, u8=True)
    along FLY_PATH, under set_sync_debug_mode("error"): ms per frame
    (pipelined, and one frame at a time), the device's busy time and the
    host's enqueue time per frame, the per-stage device time, launches per
    frame, the share of pixels whose history the warp accepts; one coset
    step held against the plain bounce on the same pool."""
    import torch

    from gpu_raytracer_tpu_torch.engine import pathtracer

    cuda = device.type == "cuda"

    def tracer():
        return pathtracer.PathTracer(scene, size, size, spectral=True, shadows=True,
                                     antialias=True, sampler="qmc", device=device)

    pt = tracer()
    for _ in range(FLY_WARMUP_STEPS):
        pt.step()
    cams = fly_cameras(scene.camera)
    fly = lambda u8=True: pt.fly_frame(next(cams), m=FLY_INTERLEAVE, iterations=DENOISE_ITERS,
                                       u8=u8)
    for _ in range(FLY_WARMUP_FRAMES):
        no_host_sync(fly, device)

    launch_tally().clear()
    t0 = time.perf_counter()
    if cuda:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
    frames = no_host_sync(lambda: [fly() for _ in range(FLY_FRAMES)], device)
    if cuda:
        b.record()
        b.synchronize()
        burst_ms = a.elapsed_time(b) / FLY_FRAMES
    else:
        burst_ms = (time.perf_counter() - t0) * 1e3 / FLY_FRAMES
    launches = frame_launches()
    textured = pt.tables.shade is not None
    n_k6 = FLY_FRAMES * (MAX_DEPTH + 1)
    want = Counter(k6=n_k6, k5=n_k6 if textured else 0, k1_standalone=FLY_FRAMES,
                   k5_standalone=FLY_FRAMES if textured else 0,
                   denoise=FLY_FRAMES * (DENOISE_ITERS + 1))
    if cuda and launches != want:
        raise AssertionError(f"{label}: fly frames launched {launches}, want {want}")
    last = frames[-1]
    if last.shape != (size, size, 3) or last.dtype != torch.uint8:
        raise AssertionError(f"{label}: fly frame {tuple(last.shape)} {last.dtype}")
    del frames

    accepted = []
    warp = pathtracer._warp_history

    def kept_warp(*args, **kw):   # each warp's accepted share, kept on the device
        out = warp(*args, **kw)
        accepted.append((out[1] > 0).float().mean())
        return out

    with _swap(pathtracer, "_warp_history", kept_warp):
        ms = timed(fly, FLY_FRAMES, device)
    accepted = [x.item() for x in accepted]
    stages, profile, accumulate_ms = {}, {}, None
    if cuda:
        stages = fly_stage_device_ms(fly, FLY_FRAMES, device)
        profile = device_profile(fly, FLY_FRAMES, device)
        # the coset step's accumulate alone: one index_add_ over C/m unique rows
        rows = pt._cosets(FLY_INTERLEAVE)[0][0]
        contrib = torch.rand((rows.shape[0], 3), device=device)
        acc = pt.accum.clone()
        accumulate_ms = device_batch_ms(lambda: acc.index_add_(0, rows, contrib), 32, device)
    frame = fly(u8=False)
    if frame.shape != (size, size, 3) or not torch.isfinite(frame).all():
        raise AssertionError(f"{label}: f32 fly frame not finite")

    # one coset step on the kernel and on the plain bounce, the same pool
    k, p = tracer(), tracer()
    k.step()
    p.step()
    if not torch.equal(k.accum, p.accum):
        raise AssertionError(f"{label}: two tracers' first steps differ")
    k._coset_step(FLY_INTERLEAVE)
    with plain_bounces():
        p._coset_step(FLY_INTERLEAVE)
    rows = k._cosets(FLY_INTERLEAVE)[0][0]
    diff = (k.accum[rows] - p.accum[rows]).abs().amax(dim=1)
    share = (diff <= RGB_TOL).float().mean().item()
    if share < PT_IMAGE_SHARE:
        raise AssertionError(f"{label}: {share:.4%} of the coset step within {RGB_TOL} of the "
                             f"plain bounce < {PT_IMAGE_SHARE:.1%}")
    out = dict(interleave=FLY_INTERLEAVE, iterations=DENOISE_ITERS, ms_per_frame=ms,
               burst_ms_per_frame=burst_ms, launches=launches,
               launches_per_frame={k_: v / FLY_FRAMES for k_, v in launches.items()},
               stages_device_ms=stages, profile=profile, accumulate_device_ms=accumulate_ms,
               device_busy_share=profile["device_ms"] / ms if cuda else None,
               history_accepted_share=statistics.median(accepted) if accepted else None,
               history_accepted_min=min(accepted) if accepted else None,
               coset_step_share_within_tol=share, coset_step_max_abs_diff=diff.max().item(),
               mean=frame.mean().item(), card=card)
    log(f"phase 19 fly-through {label} {size}x{size}: {json.dumps(out)}")
    return out


def phase_adaptive(scene, size, device, card):
    """Phase 20: AdaptivePathTracer(tiles_per_step=ADAPTIVE_TILES) at size^2:
    adaptive_from + ADAPTIVE_EXTRA_STEPS steps, then the tile selection made
    from copies of the accumulators on the CPU against the card's, tile for
    tile, and the tiles the card's next step refined; ms per step."""
    import torch

    from gpu_raytracer_tpu_torch.engine.adaptive import TILE_PX, AdaptivePathTracer, select_tiles

    pt = AdaptivePathTracer(scene, size, size, tiles_per_step=ADAPTIVE_TILES, shadows=True,
                            device=device)
    warm = pt.adaptive_from + ADAPTIVE_EXTRA_STEPS
    no_host_sync(pt.step, device)
    launch_tally().clear()
    ms_warm = timed(pt.step, warm - 1, device)
    launches = frame_launches()
    if device.type == "cuda" and launches != Counter(k6=(warm - 1) * (MAX_DEPTH + 1)):
        raise AssertionError(f"adaptive steps launched {launches}")
    g = pt._steps
    args = (g, pt.K, pt.T, pt.adaptive_from)
    on_card = select_tiles(pt.accum, pt.accum_sq, pt.counts, *args).cpu()
    on_cpu = select_tiles(pt.accum.cpu(), pt.accum_sq.cpu(), pt.counts.cpu(), *args)
    if not torch.equal(on_card, on_cpu):
        raise AssertionError(f"adaptive selection: card {on_card.tolist()} != CPU "
                             f"{on_cpu.tolist()}")
    before = pt.counts.clone().cpu()
    no_host_sync(pt.step, device)
    added = (pt.counts.cpu() - before).reshape(pt.T, TILE_PX)[:, 0]
    want = torch.bincount(on_cpu, minlength=pt.T).to(added.dtype)
    if not torch.equal(added, want):
        raise AssertionError("the adaptive step refined other tiles than its selection")
    ms = timed(pt.step, FRAMES, device)
    frame = pt.image_device()
    if not torch.isfinite(frame).all():
        raise AssertionError("adaptive frame not finite")
    counts = pt.counts.reshape(pt.T, TILE_PX)[:, 0]
    out = dict(tiles=pt.T, tiles_per_step=pt.K, adaptive_from=pt.adaptive_from,
               checked_step=g, selection=on_cpu.tolist(), ms_per_step=ms,
               warmup_ms_per_step=ms_warm, launches=launches, samples=pt.samples,
               tile_counts_min=int(counts.min()), tile_counts_max=int(counts.max()),
               mean=frame.mean().item(), card=card)
    log(f"phase 20 adaptive {size}x{size}: {json.dumps(out)}")
    return out


# ---- the Viewer and the geometry refit (phase 21) ----

VIEWER_FRAMES = 8        # camera-moving frames per reading (bench.py section 3: VK)
VIEWER_REPS = 3          # readings (VR)
REFIT_FRAMES = 4         # update_geometry + run_compute per reading (RFI)
REFIT_PROFILE_CALLS = 4  # profiled refits


def pipelined_ms(fn, n: int, device) -> float:
    """Milliseconds per call of n calls of fn enqueued back to back between
    two CUDA events, no synchronise inside (host clock on the CPU)."""
    import torch

    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize(device)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def tables_equal(a, b) -> list:
    """Names of the trace-table tensors (node lines, triangle and attribute
    rows) that differ in a bit between two TraceTables, plus depth / stack."""
    import torch

    bad = [n for n in ("nodes", "tris", "attrs")
           if getattr(a, n).shape != getattr(b, n).shape
           or not torch.equal(getattr(a, n).view(torch.int32), getattr(b, n).view(torch.int32))]
    return bad + [n for n in ("depth", "stack", "width") if getattr(a, n) != getattr(b, n)]


def lbvh_cpu_compare(scene) -> dict:
    """The grouped LBVH build and the BVH4 collapse of the scene's triangles
    on its device against the same calls on a CPU copy: every array equal."""
    import torch

    from gpu_raytracer_tpu_torch.ops.lbvh import build_lbvh_grouped_arrays, collapse4_device

    def build(vertices, indices):
        a, b, c = (vertices[indices[:, k]] for k in range(3))
        tri_min = torch.minimum(a, torch.minimum(b, c))
        tri_max = torch.maximum(a, torch.maximum(b, c))
        arrs = build_lbvh_grouped_arrays(tri_min, tri_max)
        return list(arrs) + list(collapse4_device(*arrs[:6]))

    v, i = scene.mesh.vertices, scene.mesh.indices.long()
    dev, cpu = build(v, i), build(v.cpu(), i.cpu())
    bad = [k for k, (x, y) in enumerate(zip(dev, cpu)) if not torch.equal(x.cpu(), y)]
    if bad:
        raise AssertionError(f"LBVH arrays {bad} differ between the card and the CPU")
    return dict(arrays=len(dev), nodes=int(dev[2].shape[0]), quads=int(dev[9].shape[0]))


def refit_frame_compare(r, label, frame=None, ref=None, ties=None):
    """A frame of renderer `r` (K2, or K3 + K4 textured; `frame`, or a new
    one) on its current scene against the plain path on the same pixels,
    outside the camera rays whose closest triangle K1 and the plain walk
    pick differently at the same t (or outside `ties`, a mask the caller
    made). `ref` (a scene's name) reads the plain frame and hits that phases
    3-9 kept for the scene's frame pixels."""
    from gpu_raytracer_tpu_torch.ops.render import render_chunk, render_deferred_chunk

    if frame is None:
        frame = r.render_device()
    plain = render_deferred_chunk if r.textured else render_chunk
    ref_ = plain_ref(None if ref is None else (ref, "frame", r.width, r.height, r.shadows),
                     lambda: plain(r.scene, r.px, r.py, r.width, r.height, shadows=r.shadows,
                                   sky=r.sky))
    if ties is None:
        ties = primary_ties(r.tables, r.width, r.height, r.px, r.py, ref=ref)
    diff = (frame - ref_).abs().amax(dim=1)
    err = diff[~ties].max().item()
    n_ties = int(ties.sum())
    if err > RGB_TOL or n_ties > TIE_BUDGET * diff.shape[0]:
        raise AssertionError(f"{label}: max |diff| {err:.3g} outside {n_ties} ties")
    return dict(max_abs_err=err, err_with_ties=diff.max().item(), tie_pixels=n_ties,
                mean=frame.mean().item())


def phase_viewer_refit(scene, tscene, width, height, device, card):
    """Phase 21: the Viewer at width x height with shadows on the 100k
    courtyard, as the JAX benchmark's section 3 drives it: camera-moving
    frames (handle_key("w" / "s") + run_compute), then frames with moving
    geometry (update_geometry(host vertices + offset) + run_compute, a
    topology refit). ms per frame pipelined, device and host time, launches;
    the refit and the rebuild alone; a frame and a refit under sync debug
    "error"; the refreshed tables against a fresh pack; the LBVH on the card
    against the CPU's; K2 on a refit and a rebuilt scene against the plain
    path; a textured Viewer's K3 + K4 after a scaling refit, another's after
    a camera move, and a textured Renderer's after a rebuild, against the
    plain path, each with K3's G-buffer against the plain G-buffer (its
    pre-pass then reads the refit, the moved camera and the rebuilt tables;
    after the move and the rebuild outside order ties too, order_ties);
    the scene's resident bytes."""
    import numpy as np
    import torch

    from gpu_raytracer_tpu_torch.engine.pathtracer import PathTracer
    from gpu_raytracer_tpu_torch.engine.renderer import Renderer
    from gpu_raytracer_tpu_torch.engine.viewer import Viewer
    from gpu_raytracer_tpu_torch.models.scene import memory_stats, refit_scene
    from gpu_raytracer_tpu_torch.ops.cuda.bounce import pack_bounce_tables
    from gpu_raytracer_tpu_torch.ops.cuda.render import pack_render_tables
    from gpu_raytracer_tpu_torch.ops.cuda.traverse import pack_trace_tables, refit_trace_tables

    cuda = device.type == "cuda"
    out = dict(card=card)
    v = Viewer(scene, width, height, shadows=True, verbose=False, device=device)
    v.run_compute()
    keys = itertools.cycle("ws")

    def move_frame():
        v.handle_key(next(keys))
        v.run_compute()

    move_frame()
    launch_tally().clear()
    ms = [pipelined_ms(move_frame, VIEWER_FRAMES, device) for _ in range(VIEWER_REPS)]
    launches = frame_launches()
    frames = VIEWER_FRAMES * VIEWER_REPS
    if cuda and launches != Counter(k2=frames):
        raise AssertionError(f"camera-moving Viewer frames launched {launches}, want K2 {frames}")
    no_host_sync(move_frame, device)
    out["camera_moving"] = dict(ms_per_frame=ms, frames=VIEWER_FRAMES, reps=VIEWER_REPS,
                                launches=launches, k2_per_frame=launches["k2"] / frames,
                                sync_debug_error_frame="passed" if cuda else None)
    if cuda:
        out["camera_moving"]["profile"] = device_profile(move_frame, VIEWER_FRAMES, device)

    # moving geometry: host vertices every frame, as bench.py section 3 passes
    base = scene.mesh.vertices.cpu().numpy()
    offsets = itertools.count(1)

    def geometry(i):
        off = np.zeros(3, np.float32)
        off[1] = 0.05 * i
        return base + off

    def refit_frame():
        v.update_geometry(geometry(next(offsets)))
        v.run_compute()

    refit_frame()
    kept = (v.renderer.tables.trace.nodes, v.renderer.tables.trace.tris,
            v.renderer.tables.trace.attrs)
    launch_tally().clear()
    ms = [pipelined_ms(refit_frame, REFIT_FRAMES, device) for _ in range(VIEWER_REPS)]
    launches = frame_launches()
    frames = REFIT_FRAMES * VIEWER_REPS
    if cuda and launches != Counter(k2=frames):
        raise AssertionError(f"refit frames launched {launches}, want K2 {frames}")
    if any(a is not b for a, b in zip(kept, (v.renderer.tables.trace.nodes,
                                             v.renderer.tables.trace.tris,
                                             v.renderer.tables.trace.attrs))):
        raise AssertionError("a topology refit replaced a trace table")
    no_host_sync(refit_frame, device)
    fresh = pack_render_tables(v.scene)
    bad = tables_equal(v.renderer.tables.trace, fresh.trace)
    if bad:
        raise AssertionError(f"refreshed trace tables differ from a fresh pack in {bad}")
    out["refit_and_frame"] = dict(ms_per_frame=ms, frames=REFIT_FRAMES, reps=VIEWER_REPS,
                                  launches=launches, k2_per_frame=launches["k2"] / frames,
                                  sync_debug_error_frame="passed" if cuda else None,
                                  tables_equal_fresh_pack=True)
    out["refit_and_frame"].update(refit_frame_compare(v.renderer, "K2 on a refit scene",
                                                      v._fb_dev))

    # the refit and the rebuild alone, and the table refresh
    vert = geometry(REFIT_FRAMES * VIEWER_REPS + 3)
    refit = lambda: refit_scene(v.scene, vert)
    rebuild = lambda: refit_scene(v.scene, vert, rebuild=True)
    tables = pack_render_tables(v.scene).trace
    refresh = lambda: refit_trace_tables(tables, refit_scene(tables.scene, vert))
    for label, fn in (("refit", refit), ("rebuild", rebuild), ("refit_and_refresh", refresh)):
        if cuda:
            out[f"{label}_alone"] = device_profile(fn, REFIT_PROFILE_CALLS, device)
            out[f"{label}_alone"]["ms"] = pipelined_ms(fn, REFIT_PROFILE_CALLS, device)
    no_host_sync(rebuild, device)
    rebuilt = rebuild()
    rt = pack_trace_tables(rebuilt)
    out["rebuild_tables"] = dict(nodes=int(rt.nodes.shape[0]), slots=int(rt.tris.shape[0]),
                                 depth=rt.depth, stack=rt.stack,
                                 bvh4_depth_read=wide_depth_of(rebuilt))
    if rt.depth < out["rebuild_tables"]["bvh4_depth_read"]:
        raise AssertionError(f"rebuilt tree deeper than its declared bound: {out['rebuild_tables']}")
    if cuda:   # the refit on the card, bit for bit the CPU's
        on_cpu = refit_scene(v.scene.to("cpu"), vert)
        on_card = refit()
        for name in ("tri_v0", "tri_e1", "tri_e2", "tri_den"):
            if not torch.equal(getattr(on_cpu, name), getattr(on_card, name).cpu()):
                raise AssertionError(f"refit {name} differs between the card and the CPU")
        if not torch.equal(on_cpu.bvh.q_min, on_card.bvh.q_min.cpu()):
            raise AssertionError("refit quad boxes differ between the card and the CPU")
    out["lbvh_card_vs_cpu"] = lbvh_cpu_compare(v.scene)

    # K2 on a rebuilt scene, through the Viewer's renderer and path tracer
    r = Renderer(scene, width, height, shadows=True, device=device)
    r.set_geometry(rebuilt)
    launch_tally().clear()
    out["rebuilt_frame"] = refit_frame_compare(r, "K2 on a rebuilt scene")
    out["rebuilt_frame"]["k2_launches"] = frame_launches()["k2"]
    if cuda and out["rebuilt_frame"]["k2_launches"] != 1:
        raise AssertionError(f"rebuilt frame launched {frame_launches()}")
    pt = PathTracer(scene, 256, 256, device=device)
    pt.set_geometry(rebuilt)
    if tables_equal(pt.tables.render.trace, pack_bounce_tables(pt.scene).render.trace):
        raise AssertionError("the path tracer's rebuilt tables differ from a fresh pack")
    pt.step()
    if not torch.isfinite(pt.image_device()).all():
        raise AssertionError("path tracer on the rebuilt scene: image not finite")
    del r, pt

    # a textured Viewer after a scaling refit (K3 + K4 read the refreshed
    # triangle rows and uv densities), another after a camera move (the
    # Viewer's "w", "d": one order tie at 1080p) and a textured Renderer
    # after an LBVH rebuild (tables of other shapes), these two outside the
    # counted order ties of order_ties: the frame's K3 pre-pass remakes the
    # camera-relative tables each time, so neither a stale camera nor stale
    # geometry shows
    def textured_frame(r, label, frame=None, order=False):
        """The textured frame just rendered (or one rendered here) with its
        launches, against the plain path; K3's G-buffer on the same tables
        against the plain G-buffer, bit for bit, outside the exact-t ties
        (and, with `order`, the order ties: order_ties) of K1 and the plain
        walk."""
        launch_tally().clear()
        frame = r.render_device() if frame is None else frame()
        tl = frame_launches()
        if cuda and tl != Counter(k3=1, k3_pre=1, k4=1):
            raise AssertionError(f"textured frame {label} launched {tl}")
        ties, counts = (order_ties(r.tables, width, height, r.px, r.py) if order else
                        (primary_ties(r.tables, width, height, r.px, r.py), None))
        stats = refit_frame_compare(r, f"K3 + K4 {label}", frame, ties=ties)
        stats["gbuffer"] = gbuffer_compare(r.tables, r.px, r.py, width, height, r.shadows,
                                           ties)[0]
        if counts is not None:
            stats["ties"] = counts
        stats["launches"] = tl
        return stats

    def viewer_frame():
        tv.run_compute()
        return tv._fb_dev

    tv = Viewer(tscene, width, height, shadows=True, verbose=False, device=device)
    tv.run_compute()
    tbase = tscene.mesh.vertices.cpu().numpy()
    scaled = (tbase * np.float32(1.25)).astype(np.float32)
    tv.update_geometry(scaled)
    out["textured_scaled_refit"] = textured_frame(tv.renderer, "on a scaled refit", viewer_frame)
    tv = Viewer(tscene, width, height, shadows=True, verbose=False, device=device)
    tv.run_compute()
    tv.handle_key("w")
    tv.handle_key("d")
    out["textured_camera_move"] = textured_frame(tv.renderer, "after a camera move",
                                                 viewer_frame, order=True)
    tr = Renderer(tscene, width, height, shadows=True, device=device)
    tr.render_device()
    tr.set_geometry(refit_scene(tr.scene, scaled, rebuild=True))
    out["textured_rebuilt"] = textured_frame(tr, "on a rebuilt scene", order=True)
    if tr.tables.rel_nodes.shape != tr.tables.trace.nodes.shape:
        raise AssertionError("a rebuild left camera-relative buffers of the old shape")
    del tr
    out["memory_stats"] = memory_stats(v.scene)
    out["memory_stats_textured"] = memory_stats(tv.scene)
    log(f"phase 21 viewer and refit {width}x{height}: {json.dumps(out)}")
    return out


def wide_depth_of(scene) -> int:
    """The BVH4 depth of a scene, read back from the device (a check only)."""
    from gpu_raytracer_tpu_torch.ops.cuda.traverse import wide_depth

    b = scene.bvh
    return wide_depth(b.q_child.cpu().numpy(), b.q_leafc.cpu().numpy()) if b.has_wide else 1


def frame_bounds(tables, width, height, shade=None):
    """Bytes and FP32 operations of the phase 3-9 and 15 kernels on the
    1080p frame, shadows off (the times the kernels line reports): K1's
    closest hit of every camera ray, counted on the card, plus each kernel's
    own reads and writes and per-hit work; for the texture kernels the maps
    that these hits' materials hold, and the atlas bytes once. K3's and
    K2t's camera walk, and at node width 8 K2's, at the relative costs plus
    the pre-pass's operations (its own bound: camera_relative_bound)."""
    import torch

    from gpu_raytracer_tpu_torch.engine.renderer import tiled_pixel_order
    from gpu_raytracer_tpu_torch.ops.render import split_gbuffer
    from gpu_raytracer_tpu_torch.ops.cuda.render import render_deferred
    from gpu_raytracer_tpu_torch.ops.cuda.traverse import traversal_work, traverse
    from gpu_raytracer_tpu_torch.ops.linalg import dot

    tr = tables.trace
    px, py = frame_pixels(width, height, tr.device)
    o, d = primary_rays(tables.scene, width, height, px, py)
    far = torch.full((px.shape[0],), F32_MAX, device=tr.device)
    work = traversal_work(tr, o, d, far)
    N = px.shape[0]
    # SIMT efficiency of the walk: camera rays in the kernels' order (8 x 4
    # pixels per warp) and in the row-major tile order (32 x 1), and the
    # shadow rays of every hit toward the first point light (any-hit)
    simt = dict(camera=simt_efficiency(work))
    rx, ry = (torch.from_numpy(a).to(tr.device) for a in tiled_pixel_order(width, height))
    ro, rd = primary_rays(tables.scene, width, height, rx, ry)
    simt["camera_row_major_tiles"] = simt_efficiency(traversal_work(tr, ro, rd, far))
    t, _, h, n, _ = traverse(tr, o, d, far)
    L = tables.scene.lights
    point = torch.nonzero(L.light_type == 1)
    if point.numel() and bool(h.any()):
        p = o[h] + d[h] * t[h, None]
        to_light = L.position[int(point[0])][None, :] - p
        dist = torch.sqrt(dot(to_light, to_light))
        simt["shadow_any_hit"] = simt_efficiency(traversal_work(
            tr, (p + n[h] * 1e-3).contiguous(), (to_light / dist[:, None]).contiguous(),
            (dist - 1e-3).contiguous(), any_hit=True))
    walk = walk_flops(work)
    sph = N * tables.spheres.shape[0] * SPHERE_FLOPS
    n_hit = int(h.sum())
    tb = table_bytes(tr.nodes, tr.tris, tables.materials, tables.lights, tables.spheres)
    out = dict(rays=N, hits=n_hit, node_width=tr.width, nodes=int(work[:, 0].sum()),
               tris=int(work[:, 1].sum()), live_slots=int(work[:, 4].sum()),
               simt_efficiency=simt)
    out["live_slots_per_visit"] = out["live_slots"] / max(out["nodes"], 1)
    out["K1"] = bound_ms(N * (28 + 24) + table_bytes(tr.nodes, tr.tris), walk)
    # K3, K2t, and K2 at width 8: the camera walk at the relative costs;
    # their rows time the wrapper, the pre-pass then the kernel, so "K3"
    # ("K2", "K2t") bounds the two kernels' work on the function's inputs and
    # outputs, "K3_alone" ("K2_alone") the kernel's own over the pre-pass's
    # tables (the winner's rows of `tris` read once)
    ws = work.sum(dim=0).tolist()
    rel_walk = float(ws[4] * SLAB_REL_FLOPS + ws[1] * TRI_REL_FLOPS)
    pre_bytes, pre_ops = camera_relative_work(tables)
    rel_bytes = tr.tris.shape[0] * REL_TRI_BYTES   # the pre-pass's rows, read by K3 / K2 w8
    k2_ops = sph + n_hit * SHADE_FLOPS
    if tr.width == 8:
        out["K2"] = bound_ms(N * (8 + 12) + tb, rel_walk + k2_ops + pre_ops)
        out["K2_alone"] = bound_ms(N * (8 + 12) + tb + rel_bytes, rel_walk + k2_ops)
    else:
        out["K2"] = bound_ms(N * (8 + 12) + tb, walk + k2_ops)
    k3_ops = rel_walk + sph + n_hit * (SHADE_FLOPS + 30)
    out["K3"] = bound_ms(N * (8 + 32) + tb + table_bytes(tr.attrs), k3_ops + pre_ops)
    out["K3_alone"] = bound_ms(
        N * (8 + 32) + table_bytes(tr.nodes, tr.tris, tr.attrs, tables.materials, tables.lights,
                                   tables.spheres) + rel_bytes, k3_ops)
    if shade is not None:
        mat = split_gbuffer(render_deferred(tables, px, py, width, height))[1]
        held = shade.maps[torch.clamp(mat, 0, shade.maps.shape[0] - 1), :, 0] > 0     # [N,4]
        sampled = torch.tensor([(shade.present >> k) & 1 for k in range(held.shape[1])],
                               dtype=torch.bool, device=held.device)
        n_samples = int((held & sampled[None, :] & (mat >= 0)[:, None]).sum())
        out["map_samples"] = n_samples
        sb = sampler_table_bytes(shade)
        # K4 reads 16 bytes of every ray, 16 more of a hit, and writes 12
        out["K4"] = bound_ms(N * (16 + 12) + n_hit * 16 + table_bytes(shade.materials) + sb,
                             n_hit * SHADE_FLOPS + n_samples * TEXEL_FLOPS)
        k2t_ops = sph + n_hit * (SHADE_FLOPS + 30) + n_samples * TEXEL_FLOPS
        k2t_bytes = N * (8 + 12) + tb + table_bytes(tr.attrs) + sb
        out["K2t"] = bound_ms(k2t_bytes, rel_walk + k2t_ops + pre_ops)
        out["K2t_alone"] = bound_ms(k2t_bytes + rel_bytes, rel_walk + k2t_ops)
    return out

# ---- BVH width 8 and the spatial-split tree (phase 22) ----

def preorder_tree(scene):
    """The scene's binary tree in left-first preorder -> NumPy (node_min,
    node_max, tri_start, tri_count, leaf flags): equal results are the same
    tree over the same slots, whatever the builder's node numbering."""
    import numpy as np

    b = scene.bvh
    left, right = b.left.cpu().numpy(), b.right.cpu().numpy()
    order, stack = [], [0]
    while stack:
        n = stack.pop()
        order.append(n)
        if left[n] >= 0:
            stack += [int(right[n]), int(left[n])]
    order = np.asarray(order)
    return [t.cpu().numpy()[order] for t in (b.node_min, b.node_max, b.tri_start, b.tri_count)] \
        + [left[order] < 0]


def same_tree_and_slots(a, b) -> bool:
    """Whether scenes a and b hold one binary tree over one leaf-ordered
    triangle table (their wide overlays aside)."""
    import numpy as np
    import torch

    slots = all(torch.equal(getattr(a, n).view(torch.int32), getattr(b, n).view(torch.int32))
                for n in ("tri_v0", "tri_e1", "tri_e2", "tri_mat", "tri_src"))
    return slots and all(np.array_equal(x, y) for x, y in zip(preorder_tree(a), preorder_tree(b)))


def alternating_ms(fn4, fn8, n: int, device) -> dict:
    """Median ms of n calls of fn4 (width 4) and fn8 (width 8), read in turns
    w4, w8, w8, w4."""
    out = dict(w4=[], w8=[])
    for key, fn in (("w4", fn4), ("w8", fn8), ("w8", fn8), ("w4", fn4)):
        out[key].append(timed(fn, n, device))
    return out


def w8_registers(ptxas: dict) -> dict:
    """The width-8 instances of each traversing kernel (ptxas_summary's
    names, the width first) -> registers (least, most) and the most spill
    stores of any instance."""
    out = {}
    for name, v in ptxas.items():
        kernel, _, args = name.partition("<")
        if args.startswith("8,") and "registers" in v:
            o = out.setdefault(kernel, dict(instances=0, registers=[v["registers"]] * 2,
                                            spill_stores=0))
            o["instances"] += 1
            o["registers"] = [min(o["registers"][0], v["registers"]),
                              max(o["registers"][1], v["registers"])]
            o["spill_stores"] = max(o["spill_stores"], v.get("spill_stores", 0))
    return out


def main_path_launches(fn, n: int, device, want: dict, label: str) -> tuple[float, dict]:
    """Median ms of n calls of fn with the launch tally cleared before and
    read after; on the card the counts must be `want` (none elsewhere)."""
    launch_tally().clear()
    ms = timed(fn, n, device)
    launches = frame_launches()
    if device.type == "cuda" and launches != Counter(want):
        raise AssertionError(f"{label}: launches {launches}, want {want}")
    return ms, launches


def primary_device_ms(tables, px, py, width, height, shade, device) -> dict:
    """Device time of one fused frame (shadows off, on): the kernel alone
    and, where the wrapper launches it first (K2t, and K2 at node width 8),
    with K3's pre-pass (torch.profiler, the L2 flushed before each call)."""
    out = {}
    words = ("render_primary_kernel",) + (("camera_relative_kernel",)
                                          if tables.trace.width == 8 or shade is not None
                                          else ())
    for shadows in (False, True):
        from gpu_raytracer_tpu_torch.ops.cuda.render import render_primary

        fn = lambda: render_primary(tables, px, py, width, height, shadows=shadows, shade=shade)
        key = "shadows" if shadows else "no_shadows"
        out[key] = kernel_device_ms(fn, "render_primary_kernel", FRAMES, device)
        if len(words) > 1:
            out[f"{key}_and_pre_pass"] = kernel_device_ms(fn, words, FRAMES, device)
    return out


def moved_camera_compare(cases, width, height, device) -> dict:
    """Each case (launch-count label, render tables, shade tables or None:
    K2 w8, K2t w8, K2t at width 4) after the Viewer's keys "w", "d" (the
    move of PERF.md §2's order tie at 1080p), shadows off and on, against
    render_chunk, on copies of the tables whose camera row set_camera
    rewrites in place: on the card each call must be one launch of K3's
    pre-pass and one of the kernel, and the frame 0.0 from the plain one
    outside the counted exact-t and order ties (order_ties) and, textured,
    the mip-boundary lanes; the ties are bounded by TIE_BUDGET."""
    import dataclasses

    from gpu_raytracer_tpu_torch.models.camera import CameraController
    from gpu_raytracer_tpu_torch.ops.cuda.render import render_deferred, set_camera

    px, py = frame_pixels(width, height, device)
    out = {}
    for label, tab, sh in cases:
        tab = dataclasses.replace(tab, camera=tab.camera.clone(),
                                  trace=dataclasses.replace(tab.trace), rel_nodes=None,
                                  rel_tris=None)
        ctl = CameraController(tab.scene.camera)
        ctl.move(forward=1.0)
        ctl.move(strafe=1.0)
        set_camera(tab, ctl.camera())
        exclude, ties = order_ties(tab, width, height, px, py)
        if sh is not None:
            exclude = exclude | mip_boundary_mask(sh, render_deferred(tab, px, py, width, height))
        out[label] = dict(ties=ties, camera=tab.camera[:6].tolist(), frames={})
        for shadows in (False, True):
            launch_tally().clear()
            stats, _ = primary_compare(tab, sh, px, py, width, height, shadows, exclude)
            launches = frame_launches()
            if device.type == "cuda" and launches != Counter({label: 1, "k3_pre": 1}):
                raise AssertionError(f"{label} after a camera move launched {launches}")
            if stats["err"] != 0.0:
                raise AssertionError(f"{label} after a camera move: max |diff| {stats['err']:.3g} "
                                     f"from the plain frame outside {stats['excluded']} lanes")
            out[label]["frames"]["shadows" if shadows else "no_shadows"] = stats
    return out


def phase_width8(scene, tables, tscene, ttables, tshade, width, height, pt_size, triangles,
                 texture_size, shadow_rays, plain_images, device, card):
    """Phase 22: BVH width 8 (config.bvh_width = 8) on both 100k courtyards.
    The width-8 scenes built through the user's path, asserted to share
    width 4's binary tree and slots, their stack asserted against their
    depth; K1 on the camera and shadow rays (any hit toward both lights in
    turns with width 4, and on the card the visits by children ahead of the
    camera rays, the shadow rays and K6's depth-0 and depth-1 pools), K2
    (shadows off, on), K3 + K4,
    K2t and K6 (the main path's pools, both courtyards) against their plain
    versions; the main paths (Renderer frames, render_primary with the
    shade tables, PathTracer.step()) with their launch counts, each timed in
    turns with width 4 in this process; the 4-spp images against phase 12's
    plain images; node visits and triangle tests per ray, SIMT efficiency,
    the width-aware bounds, registers and spills; K2 w8 and K2t w8 by
    device time and after a camera move (moved_camera_compare); a topology
    refit of a width-8 Viewer (tables kept, width 8) and its frame, then a
    rebuild (width 4) and the frame after it. The same binary tree and slots give
    the same plain path, so the plain outputs are phases 3-12's (PLAIN_REFS)
    wherever the inputs are theirs; only K2t's frames (phase 15's are of the
    GLB courtyard), the moved camera's and the refit frame (moved geometry)
    are rendered plain here."""
    import torch

    from gpu_raytracer_tpu_torch.config import RaytracerConfig
    from gpu_raytracer_tpu_torch.engine.pathtracer import PathTracer
    from gpu_raytracer_tpu_torch.engine.renderer import Renderer
    from gpu_raytracer_tpu_torch.engine.viewer import Viewer
    from gpu_raytracer_tpu_torch.models.scene import refit_scene
    from gpu_raytracer_tpu_torch.ops.cuda.bounce import pack_bounce_tables
    from gpu_raytracer_tpu_torch.ops.cuda.build import load_kernels
    from gpu_raytracer_tpu_torch.ops.cuda.render import (pack_render_tables, render_deferred,
                                                         render_primary)
    from gpu_raytracer_tpu_torch.ops.cuda.texshade import pack_shade_tables
    from gpu_raytracer_tpu_torch.ops.cuda.traverse import children_ahead, traverse
    from gpu_raytracer_tpu_torch.ops.trace import traverse_triangles
    from gpu_raytracer_tpu_torch.utils.procgen import make_courtyard_scene

    cuda = device.type == "cuda"
    cfg = RaytracerConfig(bvh_width=8)
    out = dict(card=card)
    t0 = time.perf_counter()
    s8 = make_courtyard_scene(triangles, seed=0, config=cfg, device=device)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    t8 = make_courtyard_scene(triangles, seed=0, textured=True, texture_size=texture_size,
                              config=cfg, device=device)
    tbuild_s = time.perf_counter() - t0
    tab8, ttab8, shade8 = pack_render_tables(s8), pack_render_tables(t8), pack_shade_tables(t8)
    tr4, tr8 = tables.trace, tab8.trace
    for label, a, b in (("courtyard", scene, s8), ("textured courtyard", tscene, t8)):
        if not same_tree_and_slots(a, b):
            raise AssertionError(f"{label}: the width-8 scene has another binary tree or slots")
    depth_read = wide_depth_of(s8)
    if (tr8.width, ttab8.trace.width, tr8.nodes.shape[1]) != (8, 8, 64) \
            or tr8.depth != depth_read or 7 * tr8.depth + 1 > tr8.stack:
        raise AssertionError(f"width-8 tables: width {tr8.width}, {tuple(tr8.nodes.shape)}, "
                             f"depth {tr8.depth} (read {depth_read}), stack {tr8.stack}")
    ptxas = ptxas_summary(load_kernels().log) if cuda else {}
    out["scene"] = dict(
        build_s=build_s, textured_build_s=tbuild_s, slots=int(s8.tri_v0.shape[0]),
        bvh8_nodes=int(tr8.nodes.shape[0]), bvh4_nodes=int(tr4.nodes.shape[0]),
        bvh8_table_mb=tr8.nodes.numel() * 4 / 2**20, bvh4_table_mb=tr4.nodes.numel() * 4 / 2**20,
        bvh8_depth=tr8.depth, bvh4_depth=tr4.depth, bvh8_stack=tr8.stack, bvh4_stack=tr4.stack,
        shares_binary_tree_and_slots=True,
        ptxas={k: v for k, v in ptxas.items()
               if re.search(rf"<(8, {tr8.stack}|4, {tr4.stack})[,>]", k)})
    out["scene"]["w8_registers_and_spills"] = w8_registers(ptxas)
    log(f"phase 22 width-8 scenes: {json.dumps(out['scene'])}")

    # K1: the camera and shadow rays against the plain walk, then in turns with width 4
    out["k1"], ties = phase_k1(s8, tr8, width, height, shadow_rays, device, card, phase="22",
                               ref="courtyard")
    px, py = frame_pixels(width, height, device)
    o, d = primary_rays(scene, width, height, px, py)
    far = torch.full((px.shape[0],), F32_MAX, device=device)
    out["k1"]["w4_w8_ms"] = alternating_ms(lambda: traverse(tr4, o, d, far),
                                           lambda: traverse(tr8, o, d, far), FRAMES, device)
    # the any-hit walk on phase 3's shadow rays of both lights, in turns
    # with width 4, and the width-8 visits by children ahead (0 .. 8)
    t, _, h, n, _ = plain_ref(("courtyard", "k1_camera"),
                              lambda: traverse_triangles(scene, o, d, far))
    shadow = {light: light_shadow_rays(scene, o, d, t, h, n, shadow_rays,
                                       directional=light == "directional")
              for light in ("point", "directional")}
    out["k1"]["any_hit_w4_w8_ms"] = {
        light: alternating_ms(lambda: traverse(tr4, *r, any_hit=True),
                              lambda: traverse(tr8, *r, any_hit=True), FRAMES, device)
        for light, r in shadow.items()}
    if cuda:
        ahead = dict(camera=children_ahead(tr8, o, d, far))
        ahead.update({f"shadow_{light}": children_ahead(tr8, *r, any_hit=True)
                      for light, r in shadow.items()})
        for depth, pool, _, _, _, _ in pools(pack_bounce_tables(s8), pt_size, pt_size, (0, 1)):
            live = pool.active
            ahead[f"k6_depth{depth}"] = children_ahead(
                tr8, pool.origin[live].contiguous(), pool.direction[live].contiguous(),
                torch.full((int(live.sum()),), F32_MAX, device=device))
        out["k1"]["children_ahead"] = {
            k: dict(visits=v.tolist(), share_two_or_more=float(v[2:].sum()) / float(v.sum()))
            for k, v in ahead.items()}
    log(f"phase 22 K1 in turns with width 4: "
        f"{json.dumps(dict(closest=out['k1']['w4_w8_ms'], any_hit=out['k1']['any_hit_w4_w8_ms']))}"
        f"; width-8 visits by children ahead: {json.dumps(out['k1'].get('children_ahead'))}")
    launches = dict(k2_w8=0, k2t_w8=0, k3_w8=0, k3_pre=0, k6_w8=0, k5_w8=0)   # the main paths

    # K2: Renderer.render_device(), the main path, shadows off and on
    out["k2"] = {}
    for shadows in (False, True):
        key = "shadows" if shadows else "no_shadows"
        stats = k2_compare(s8, width, height, shadows, device, ties, ref="courtyard")
        r4 = Renderer(scene, width, height, shadows=shadows, device=device)
        r8 = Renderer(s8, width, height, shadows=shadows, device=device)
        r4.render_device()
        r8.render_device()
        stats["ms"], got = main_path_launches(r8.render_device, FRAMES, device,
                                              dict(k2_w8=FRAMES, k3_pre=FRAMES),
                                              f"width-8 K2 {key}")
        launches["k2_w8"] += got["k2_w8"]
        launches["k3_pre"] += got["k3_pre"]
        stats["w4_w8_ms"] = alternating_ms(r4.render_device, r8.render_device, FRAMES, device)
        out["k2"][key] = stats
        del r4, r8
    if cuda:   # device times, the L2 flushed before each call: K2 w8, and with its pre-pass
        out["k2_device_ms"] = primary_device_ms(tab8, px, py, width, height, None, device)
    log(f"phase 22 K2 width 8: "
        f"{json.dumps(dict(out['k2'], device_ms=out.get('k2_device_ms')))}")

    # K3's pre-pass at width 8, then K3 (+ K4) and K2t on the textured courtyard
    out["k3_pre"] = dict(textured_courtyard=camera_relative_compare(ttab8),
                         courtyard=camera_relative_compare(tab8))
    tties = primary_ties(ttab8, width, height, px, py, ref="textured_courtyard")
    out["k3"] = {}
    for shadows in (False, True):
        key = "shadows" if shadows else "no_shadows"
        out["k3"][key] = gbuffer_compare(ttab8, px, py, width, height, shadows, tties,
                                         ref="textured_courtyard")[0]
    rt8 = Renderer(t8, width, height, shadows=False, device=device)
    rt8.render_device()
    ms, got = main_path_launches(rt8.render_device, FRAMES, device,
                                 dict(k3_w8=FRAMES, k3_pre=FRAMES, k4=FRAMES),
                                 "width-8 textured frames")
    launches["k3_w8"] += got["k3_w8"]
    launches["k3_pre"] += got["k3_pre"]
    out["k3"]["frame_ms"] = ms
    out["k3"]["frame"] = refit_frame_compare(rt8, "K3 + K4 at width 8", ref="textured_courtyard")
    out["k3"]["w4_w8_ms"] = alternating_ms(
        lambda: render_deferred(ttables, px, py, width, height),
        lambda: render_deferred(ttab8, px, py, width, height), FRAMES, device)
    if cuda:   # device times, the L2 flushed before each call
        k3_8 = lambda: render_deferred(ttab8, px, py, width, height)
        out["k3"]["device_ms"] = kernel_device_ms(k3_8, "render_deferred_kernel", FRAMES, device)
        out["k3"]["and_pre_pass_device_ms"] = kernel_device_ms(
            k3_8, ("render_deferred_kernel", "camera_relative_kernel"), FRAMES, device)
    del rt8
    near = mip_boundary_mask(shade8, render_deferred(ttab8, px, py, width, height))
    out["k2t"] = {}
    for shadows in (False, True):
        key = "shadows" if shadows else "no_shadows"
        stats, _ = primary_compare(ttab8, shade8, px, py, width, height, shadows, tties | near)
        fused = lambda: render_primary(ttab8, px, py, width, height, shadows=shadows,
                                       sky=(0.1, 0.2, 0.3), shade=shade8)
        stats["ms"], got = main_path_launches(fused, FRAMES, device,
                                              dict(k2t_w8=FRAMES, k3_pre=FRAMES),
                                              f"width-8 K2t {key}")
        launches["k2t_w8"] += got["k2t_w8"]
        launches["k3_pre"] += got["k3_pre"]
        stats["w4_w8_ms"] = alternating_ms(
            lambda: render_primary(ttables, px, py, width, height, shadows=shadows,
                                   sky=(0.1, 0.2, 0.3), shade=tshade), fused, FRAMES, device)
        out["k2t"][key] = stats
    if cuda:
        out["k2t_device_ms"] = primary_device_ms(ttab8, px, py, width, height, shade8, device)
    log(f"phase 22 K3, K2t width 8: {json.dumps(dict(k3_pre=out['k3_pre'], k3=out['k3'],
                                                      k2t=out['k2t'],
                                                      k2t_device_ms=out.get('k2t_device_ms')))}")
    # K2 w8 and K2t w8 after a camera move: the pre-pass's tables made anew
    out["moved_camera"] = moved_camera_compare((("k2_w8", tab8, None),
                                                ("k2t_w8", ttab8, shade8)), width, height,
                                               device)
    log(f"phase 22 K2 w8, K2t w8 after a camera move: {json.dumps(out['moved_camera'])}")

    # K6: the main path's pools, then PathTracer.step() on both courtyards
    k6 = phase_k6(pack_bounce_tables(s8), pt_size, pt_size, "courtyard_w8", ref="courtyard")
    k6.update(phase_k6(pack_bounce_tables(t8), pt_size, pt_size, "textured_courtyard_w8",
                       ref="textured_courtyard"))
    out["k6_pools"] = k6

    def tracer(sc):
        return PathTracer(sc, pt_size, pt_size, spectral=True, shadows=True, antialias=True,
                          sampler="qmc", device=device)

    out["pathtracer"] = {}
    for label, sc4, sc8 in (("courtyard", scene, s8), ("textured_courtyard", tscene, t8)):
        textured = sc8.textures.textured
        pt8 = tracer(sc8)
        pt8.step()
        no_host_sync(pt8.step, device)
        pt8.reset()
        steps = PT_STEPS * (MAX_DEPTH + 1)
        ms, got = main_path_launches(pt8.step, PT_STEPS, device,
                                     dict(k6_w8=steps, k5_w8=steps if textured else 0),
                                     f"width-8 PathTracer.step() on the {label}")
        launches["k6_w8"] += got["k6_w8"]
        launches["k5_w8"] += got["k5_w8"]
        img = tracer(sc8)
        for _ in range(PT_PLAIN_STEPS):
            img.step()
        diff = (img.image_device() - plain_images[label]).abs().amax(dim=2)
        share = (diff <= RGB_TOL).float().mean().item()
        if share < PT_IMAGE_SHARE:
            raise AssertionError(f"width-8 {label}: {share:.4%} of the 4-spp image within "
                                 f"{RGB_TOL} of the plain path < {PT_IMAGE_SHARE:.1%}")
        stats = dict(ms_per_spp=ms, launches=got, image_share_within_tol=share,
                     image_max_abs_diff=diff.max().item())
        if cuda:
            pt4 = tracer(sc4)
            pt4.step()
            prof = [device_profile(p.step, PT_STEPS, device) for p in (pt4, pt8, pt8, pt4)]
            stats["k6_device_ms_per_spp"] = dict(w4=[prof[0]["k6_device_ms"],
                                                     prof[3]["k6_device_ms"]],
                                                 w8=[prof[1]["k6_device_ms"],
                                                     prof[2]["k6_device_ms"]])
            stats["device_ms_per_spp"] = dict(w4=[prof[0]["device_ms"], prof[3]["device_ms"]],
                                              w8=[prof[1]["device_ms"], prof[2]["device_ms"]])
            record = []
            with recorded_bounces(record):
                pt8.step()
            stats["k6_bound"] = bounce_bound(pt8.tables, record)
            record = []
            with recorded_bounces(record):
                pt4.step()
            stats["k6_bound_w4"] = bounce_bound(pt4.tables, record)
            del record, pt4
        out["pathtracer"][label] = stats
        del pt8, img
    log(f"phase 22 K6 width 8: {json.dumps(dict(pools=k6, pathtracer=out['pathtracer']))}")

    # the Viewer: a topology refit keeps width 8; a rebuild gives width 4
    v = Viewer(s8, width, height, shadows=True, verbose=False, device=device)
    v.run_compute()
    base = s8.mesh.vertices.cpu().numpy()
    moved = base.copy()
    moved[:, 1] += 0.05
    nodes = v.renderer.tables.trace.nodes
    v.update_geometry(moved)
    if v.renderer.tables.trace.width != 8 or v.renderer.tables.trace.nodes is not nodes:
        raise AssertionError("a topology refit of a width-8 scene replaced its width-8 tables")
    _, got = main_path_launches(v.run_compute, 1, device, dict(k2_w8=1, k3_pre=1),
                                "the width-8 Viewer's refit frame")
    launches["k2_w8"] += got["k2_w8"]
    launches["k3_pre"] += got["k3_pre"]
    bad = tables_equal(v.renderer.tables.trace, pack_render_tables(v.scene).trace)
    if bad:
        raise AssertionError(f"width-8 refreshed tables differ from a fresh pack in {bad}")
    out["viewer_refit"] = refit_frame_compare(v.renderer, "K2 width 8 after a topology refit",
                                              v._fb_dev)
    # the rebuilt tree's frame: phase 21 holds K2 on a rebuilt tree to the
    # plain path; here the frame after set_geometry must be width 4's K2 on
    # the new tables, bit for bit a fresh renderer's of the rebuilt scene
    r = v.renderer
    rebuilt = refit_scene(v.scene, moved, rebuild=True)
    r.set_geometry(rebuilt)
    if (r.tables.trace.width, r.tables.trace.nodes.shape[1]) != (4, 32):
        raise AssertionError(f"a rebuild left width-{r.tables.trace.width} tables")
    launch_tally().clear()
    frame = r.render_device()
    got = frame_launches()
    if cuda and (got["k2"], got["k2_w8"]) != (1, 0):
        raise AssertionError(f"the rebuilt width-8 scene's frame launched {got}")
    fresh = Renderer(rebuilt, width, height, shadows=True, device=device).render_device()
    if not torch.isfinite(frame).all() or not torch.equal(frame, fresh):
        raise AssertionError("the frame after a rebuild differs from a fresh renderer's")
    out["rebuilt_frame"] = dict(launches=got, equal_to_fresh_renderer=True,
                                mean=frame.mean().item())
    del v, r, rebuilt, fresh

    if cuda:
        out["bounds"] = dict(w8=frame_bounds(tab8, width, height),
                             w8_textured=frame_bounds(ttab8, width, height, shade=shade8))
        for key, fb in out["bounds"].items():
            fb["nodes_per_ray"], fb["tris_per_ray"] = fb["nodes"] / fb["rays"], fb["tris"] / fb["rays"]
    out["launches"] = launches
    out["max_abs_err"] = dict(
        k1=max(out["k1"]["primary"]["t_abs"], out["k1"]["primary"]["normal_abs"],
               out["k1"]["shadow"]["t_abs"], out["k1"]["shadow"]["normal_abs"]),
        k2=max([v["err"] for v in out["k2"].values()] + [out["viewer_refit"]["max_abs_err"]]
               + [v["err"] for v in out["moved_camera"]["k2_w8"]["frames"].values()]),
        k3=max([e for v in out["k3"].values() if isinstance(v, dict) and "S" in v
                for e in (v["S"], v["uv"], v["lam_rel"])] + [out["k3"]["frame"]["max_abs_err"]]),
        k3_pre=max(v["max_abs_err"] for v in out["k3_pre"].values()),
        k2t=max([v["err"] for v in out["k2t"].values()]
                + [v["err"] for v in out["moved_camera"]["k2t_w8"]["frames"].values()]),
        k6=max(v["max_abs_err"] for v in k6.values()))
    log(f"phase 22 width 8 summary: {json.dumps(dict(launches=launches, bounds=out.get('bounds'), max_abs_err=out['max_abs_err'], viewer_refit=out['viewer_refit'], rebuilt_frame=out['rebuilt_frame']))}")
    return out


def phase_sbvh(scene, tables, width, height, pt_size, triangles, device, card):
    """Phase 22b: the spatial-split courtyard (config.bvh_spatial_splits,
    the NumPy SBVH builder; ~9 s on the host): its references and tree
    checked, K2 through Renderer (shadows off and on) against render_chunk
    on its own tree, timed in turns with the SAH courtyard's, one
    PathTracer.step() (K6 five times) and K6 on the depth-0 pool against the
    plain bounce, node visits per camera ray against the SAH tree's."""
    import torch

    from gpu_raytracer_tpu_torch.config import RaytracerConfig
    from gpu_raytracer_tpu_torch.engine.pathtracer import PathTracer
    from gpu_raytracer_tpu_torch.engine.renderer import Renderer
    from gpu_raytracer_tpu_torch.models.bvh import scene_tree, validate_bvh
    from gpu_raytracer_tpu_torch.ops.cuda.bounce import pack_bounce_tables
    from gpu_raytracer_tpu_torch.ops.cuda.render import pack_render_tables
    from gpu_raytracer_tpu_torch.ops.cuda.traverse import traversal_work
    from gpu_raytracer_tpu_torch.utils.procgen import make_courtyard_scene

    cuda = device.type == "cuda"
    t0 = time.perf_counter()
    sb = make_courtyard_scene(triangles, seed=0, config=RaytracerConfig(bvh_spatial_splits=True),
                              device=device)
    build_s = time.perf_counter() - t0
    tb = pack_render_tables(sb)
    src = sb.tri_src[sb.tri_src >= 0]
    if int(src.unique().numel()) != sb.num_triangles:
        raise AssertionError("the spatial-split tree leaves a triangle out")
    validate_bvh(scene_tree(sb), sb.num_triangles, allow_refs=True)
    out = dict(card=card, build_s=build_s, binary_nodes=sb.bvh.num_nodes,
               bvh4_nodes=int(tb.trace.nodes.shape[0]), bvh4_depth=tb.trace.depth,
               stack=tb.trace.stack, slots=int(sb.tri_v0.shape[0]), references=int(src.numel()),
               sah_binary_nodes=scene.bvh.num_nodes, sah_bvh4_nodes=int(tables.trace.nodes.shape[0]))
    px, py = frame_pixels(width, height, device)
    ties = primary_ties(tb, width, height, px, py)
    launches = dict(k2=0, k6=0)
    out["k2"] = {}
    for shadows in (False, True):
        key = "shadows" if shadows else "no_shadows"
        stats = k2_compare(sb, width, height, shadows, device, ties)
        r4 = Renderer(scene, width, height, shadows=shadows, device=device)
        rs = Renderer(sb, width, height, shadows=shadows, device=device)
        r4.render_device()
        rs.render_device()
        stats["ms"], got = main_path_launches(rs.render_device, FRAMES, device, dict(k2=FRAMES),
                                              f"SBVH K2 {key}")
        launches["k2"] += got["k2"]
        ab = alternating_ms(r4.render_device, rs.render_device, FRAMES, device)
        stats["sah_sbvh_ms"] = dict(sah=ab["w4"], sbvh=ab["w8"])
        out["k2"][key] = stats
        del r4, rs
    pt = PathTracer(sb, pt_size, pt_size, spectral=True, shadows=True, antialias=True,
                    sampler="qmc", device=device)
    pt.step()
    pt.reset()
    ms, got = main_path_launches(pt.step, 1, device, dict(k6=MAX_DEPTH + 1),
                                 "SBVH PathTracer.step()")
    launches["k6"] += got["k6"]
    if not torch.isfinite(pt.image_device()).all():
        raise AssertionError("SBVH path tracer: image not finite")
    out["pathtracer_step_ms"] = ms
    out["k6_pools"] = phase_k6(pack_bounce_tables(sb), pt_size, pt_size, "sbvh", depths=(0,))
    if cuda:
        o, d = primary_rays(scene, width, height, px, py)
        far = torch.full((px.shape[0],), F32_MAX, device=device)
        per_ray = lambda w: dict(nodes=w[:, 0].sum().item() / w.shape[0],
                                 tris=w[:, 1].sum().item() / w.shape[0])
        out["camera_ray_work"] = dict(sah=per_ray(traversal_work(tables.trace, o, d, far)),
                                      sbvh=per_ray(traversal_work(tb.trace, o, d, far)))
    out["launches"] = launches
    out["k2_err"] = max(v["err"] for v in out["k2"].values())
    out["k6_err"] = max(v["max_abs_err"] for v in out["k6_pools"].values())
    log(f"phase 22b spatial-split courtyard: {json.dumps(out)}")
    return out


SERVE_SIZES = ((640, 360), (1920, 1080))   # the serve command's default, and 1080p
SERVE_MAX_FPS = 30.0       # the serve command's default cap
SERVE_FRAMES = 24          # served frames of a camera-moving reading
SERVE_STILL_S = 1.5        # seconds of a still-camera reading
SERVE_PT_FRAMES = 6        # path-traced frames after the 'p' key
HTTP_TIMEOUT = 120.0       # seconds: every request, every read of a stream, every wait
THREAD_EXIT_S = 5.0        # after stop(), the server's threads are gone within this
WINDOW_SIZE = (640, 360)
WINDOW_TICKS = 4
ORACLE_SIZE = 48
ORACLE_TRIANGLES = 2000
ORACLE_RMSE = 1e-5         # tests/test_torch_render.py's bound
ORACLE_WORKERS = 6         # processes the oracle's rows are split over


class StreamClient:
    """A /stream client over urllib; every read bounded by HTTP_TIMEOUT."""

    def __init__(self, server):
        import urllib.request

        self.resp = urllib.request.urlopen(f"http://{server.host}:{server.port}/stream",
                                           timeout=HTTP_TIMEOUT)

    def part(self) -> bytes:
        """The next PNG part of the multipart stream."""
        from gpu_raytracer_tpu_torch.engine.server import BOUNDARY

        line = self.resp.readline()
        if line != b"--" + BOUNDARY + b"\r\n":
            raise AssertionError(f"stream: {line[:60]!r} where a part starts")
        length = None
        while True:
            line = self.resp.readline()
            if line in (b"\r\n", b""):
                break
            name, _, value = line.decode().partition(":")
            if name.lower() == "content-length":
                length = int(value)
        png = self.resp.read(length)
        if len(png) != length or self.resp.read(2) != b"\r\n":
            raise AssertionError("stream: a part cut short")
        return png

    def close(self) -> None:
        self.resp.close()


def http(server, method: str, path: str):
    """One request to the server -> its JSON answer (the page's bytes for /)."""
    import urllib.request

    req = urllib.request.Request(f"http://{server.host}:{server.port}{path}", method=method)
    with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT) as r:
        body = r.read()
    return body if path == "/" else json.loads(body)


def wait_until(cond, what: str) -> None:
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > HTTP_TIMEOUT:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.005)


class ServeProbe:
    """The producer's frame split without a hook in the package: wraps the
    served Viewer's run_compute (CUDA events around it; a camera move before
    it while `moving`), present_frame_packed and materialize_frame (host
    ms), and engine/viewer.py's to_u8 (the host quantise inside a Whitted
    present) and engine/server.py's encode_png (host ms) for the run."""

    LISTS = ("events", "compute", "present", "quantise", "materialize", "encode", "handles")

    def __init__(self, server, device):
        import torch

        from gpu_raytracer_tpu_torch.engine import server as server_module
        from gpu_raytracer_tpu_torch.engine import viewer as viewer_module

        self.server, self.device = server, device
        self.moving = False
        self._keys = itertools.cycle("ws")
        self.clear()
        v = server.viewer
        run_compute, present = v.run_compute, v.present_frame_packed
        materialize, to_u8, encode = v.materialize_frame, viewer_module.to_u8, server_module.encode_png
        cuda = device.type == "cuda"

        def timed_into(name, fn):
            def wrapped(*a, **kw):
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                getattr(self, name).append((time.perf_counter() - t0) * 1e3)
                return out
            return wrapped

        def compute():
            if self.moving:
                v.handle_key(next(self._keys))
            if cuda:
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
            t0 = time.perf_counter()
            n = run_compute()
            self.compute.append((time.perf_counter() - t0) * 1e3)
            if cuda:
                b.record()
                self.events.append((a, b))
            return n

        def present_packed():
            h = timed_into("present", present)()
            self.handles.append(h)
            return h

        v.run_compute = compute
        v.present_frame_packed = present_packed
        v.materialize_frame = timed_into("materialize", materialize)
        viewer_module.to_u8 = timed_into("quantise", to_u8)
        server_module.encode_png = timed_into("encode", encode)

        def restore():
            for k in ("run_compute", "present_frame_packed", "materialize_frame"):
                v.__dict__.pop(k, None)
            viewer_module.to_u8 = to_u8
            server_module.encode_png = encode
        self.restore = restore

    def clear(self) -> None:
        for name in self.LISTS:
            setattr(self, name, [])

    def window(self, clients, frames=None, seconds=None, moving=False, profile=False) -> dict:
        """Serve `frames` frames (or `seconds`) to `clients`, each reading
        every part it is sent: frames per second at the producer, the
        frame's split, the launches of the window (checked per frame by
        the caller), the device's busy share (torch.profiler, `profile`)."""
        import torch

        s = self.server
        cuda = self.device.type == "cuda"
        prof = None
        if profile:
            from torch.profiler import ProfilerActivity, profile as torch_profile

            prof = torch_profile(activities=[ProfilerActivity.CUDA])
        with prof if prof is not None else contextlib.nullcontext():
            with s._lock:
                self.clear()
                launch_tally().clear()
                self.moving = moving
                seq0, t0 = s._seq, time.perf_counter()
            parts = 0
            while (s._seq - seq0 < frames) if frames else (time.perf_counter() - t0 < seconds):
                for c in clients:
                    c.part()
                parts += 1
            with s._lock:
                self.moving = False
                seq1, t1 = s._seq, time.perf_counter()
                launches = frame_launches()
                split = {k: list(getattr(self, k)) for k in self.LISTS}
            if cuda:
                torch.cuda.synchronize(self.device)
        n, served = len(split["compute"]), seq1 - seq0
        if abs(n - served) > 1:
            raise AssertionError(f"{n} frames computed for {served} served")
        med = lambda xs: statistics.median(xs) if xs else None
        out = dict(frames=served, computed=n, parts_per_client=parts,
                   fps=served / (t1 - t0), wall_ms=(t1 - t0) * 1e3, launches=launches,
                   launches_per_frame={k: c / n for k, c in launches.items() if c} if n else {},
                   compute_device_ms=med([a.elapsed_time(b) for a, b in split["events"]])
                   if cuda else None,
                   compute_host_ms=med(split["compute"]), present_ms=med(split["present"]),
                   quantise_ms=med(split["quantise"]), materialize_ms=med(split["materialize"]),
                   encode_ms=med(split["encode"]),
                   handles=sorted({type(h).__name__ + str(tuple(getattr(h, "shape", ())))
                                   for h in split["handles"]}))
        if prof is not None:
            device_us = 0.0
            for e in prof.key_averages():
                t = getattr(e, "self_device_time_total", None)
                device_us += e.self_cuda_time_total if t is None else t
            out["device_busy_share"] = device_us / 1e3 / out["wall_ms"]
        return out


def settled_png(server) -> bytes:
    """The part a new client gets once the camera stands still and the
    frame is complete (two frames later, through the pipelined present)."""
    def complete():
        with server._lock:
            return server.viewer.progressive.complete
    wait_until(complete, "a complete frame")
    seq = server._seq
    wait_until(lambda: server._seq >= seq + 2, "two more frames")
    c = StreamClient(server)
    try:
        return c.part()
    finally:
        c.close()


def served_bounces_compare(v) -> dict:
    """One frame of path-tracing Viewer `v` with its K6 launches recorded,
    each held to the plain bounce on the same pool (bounce_compare), at the
    lane count the Viewer serves. The caller holds the server's lock."""
    record = []
    with recorded_bounces(record):
        v.run_compute()
    if v._pt is None or (v.device.type == "cuda" and len(record) != MAX_DEPTH + 1):
        raise AssertionError(f"a served path-traced frame made {len(record)} K6 launches")
    out = {}
    for r, kw in record:
        flags = dict(kw)
        args = {k: flags.pop(k, None) for k in ("depth", "order", "n_live", "qmc", "u")}
        out[f"depth{args['depth']}"] = bounce_compare(v._pt.tables, r, flags, **args)
    return out


def serve_reading(scene, width, height, device, pathtrace: bool) -> dict:
    """One ViewerServer on 127.0.0.1 (port 0) around a Viewer of `scene`
    with shadows, two /stream clients: camera-moving frames (the frame's
    kernels once per served frame), a key and a drag over HTTP, the
    settled part against framebuffer_u8 and the frame against the plain
    path, still-camera frames, path-traced frames after 'p' (K6 five times a
    frame, the YUV present) and one frame's K6 launches against the plain
    bounce, a resize, stop() and no thread of the server left."""
    import threading

    import numpy as np
    import torch

    from gpu_raytracer_tpu_torch.engine.server import ViewerServer
    from gpu_raytracer_tpu_torch.engine.viewer import Viewer
    from gpu_raytracer_tpu_torch.models.gltf import decode_png

    cuda = device.type == "cuda"
    textured = scene.textures.textured
    frame_kernels = dict(k3=1, k3_pre=1, k4=1) if textured else dict(k2=1)
    v = Viewer(scene, width, height, shadows=True, verbose=False, device=device)
    v.run_compute()            # the first frame before any request
    if cuda:
        torch.cuda.synchronize(device)
    before = set(threading.enumerate())
    s = ViewerServer(v, host="127.0.0.1", port=0, max_fps=SERVE_MAX_FPS)
    probe = ServeProbe(s, device)
    out = dict(size=f"{width}x{height}", textured=textured, max_fps=SERVE_MAX_FPS)
    clients = []
    launches = Counter()

    def check(label, w, per_frame, free=()):
        """The window's launches: per_frame[k] a computed frame of each
        kernel, none of the others outside `free`."""
        want = Counter({k: n * w["computed"] for k, n in per_frame.items() if k not in free})
        if cuda and Counter({k: c for k, c in w["launches"].items() if k not in free}) != want:
            raise AssertionError(f"{label}: {w['launches']} for {w['computed']} frames, "
                                 f"want {want}")
        for k, c in w["launches"].items():
            launches[k] += c
        out[label] = w

    try:
        s.start()
        if b"/stream" not in http(s, "GET", "/"):
            raise AssertionError("the page does not stream")
        clients = [StreamClient(s), StreamClient(s)]
        for c in clients:
            c.part()
        check("moving", probe.window(clients, frames=SERVE_FRAMES, moving=True), frame_kernels)
        if cuda:
            check("moving_profiled", probe.window(clients, frames=SERVE_FRAMES // 2,
                                                  moving=True, profile=True), frame_kernels)
        cam0 = http(s, "GET", "/stats")["camera"]
        if not (http(s, "POST", "/key?k=w")["ok"] and http(s, "POST", "/drag?dx=12&dy=-4")["ok"]):
            raise AssertionError("/key or /drag refused")
        stats = http(s, "GET", "/stats")
        if stats["camera"] == cam0 or not stats["fps"] > 0:
            raise AssertionError(f"/stats did not move after /key: {cam0} -> {stats}")
        got = decode_png(settled_png(s))[..., :3]
        with s._lock:
            want = v.framebuffer_u8
        if not np.array_equal(got, want):
            raise AssertionError(f"a served part differs from framebuffer_u8 in "
                                 f"{int((got != want).any(axis=-1).sum())} pixels")
        out["png_equals_framebuffer_u8"] = True
        out["stats_after_key"] = stats
        with s._lock:       # the served frame's kernels against the plain path
            out["frame_vs_plain"] = refit_frame_compare(
                v.renderer, f"served {'K3 + K4' if textured else 'K2'} {width}x{height}",
                v._fb_dev)
        check("still", probe.window(clients, seconds=SERVE_STILL_S), {})
        if pathtrace:
            http(s, "POST", "/key?k=p")
            w = probe.window(clients, frames=SERVE_PT_FRAMES)
            # the denoised preview traces its camera's G-buffer once (K1 alone)
            check("pathtrace", w, dict(k6=5, denoise=PREVIEW_ITERS + 1), free=("k1_standalone",))
            yuv = f"{'HostFrame' if cuda else 'Tensor'}({height * 3 // 2}, {width})"
            if w["handles"] != [yuv]:
                raise AssertionError(f"path-traced presents {w['handles']}, want {yuv}")
            with s._lock:
                out["k6_vs_plain"] = served_bounces_compare(v)
            http(s, "POST", "/key?k=p")
        http(s, "POST", f"/resize?w={width // 2}&h={height // 2}")
        shape = decode_png(settled_png(s)).shape[:2]
        if shape != (height // 2, width // 2):
            raise AssertionError(f"after /resize a part of {shape}")
    finally:
        for c in clients:
            c.close()
        t0 = time.perf_counter()
        s.stop()
        out["stop_s"] = time.perf_counter() - t0
        probe.restore()
    t0 = time.perf_counter()
    while [t for t in threading.enumerate() if t not in before and t.is_alive()]:
        if time.perf_counter() - t0 > THREAD_EXIT_S:
            left = [t.name for t in threading.enumerate() if t not in before]
            raise AssertionError(f"threads left after stop(): {left}")
        time.sleep(0.01)
    out["threads_gone_s"] = time.perf_counter() - t0
    out["launches_total"] = launches
    return out


def phase_server(scene, tscene, device, card):
    """Phase 23: the HTTP server (engine/server.py) on the card."""
    out = dict(card=card)
    for w, h in SERVE_SIZES:
        out[f"courtyard_{w}x{h}"] = serve_reading(scene, w, h, device, pathtrace=True)
    w, h = SERVE_SIZES[0]
    out[f"textured_courtyard_{w}x{h}"] = serve_reading(tscene, w, h, device, pathtrace=False)
    log(f"phase 23 server: {json.dumps(out)}")
    total = Counter()
    for r in out.values():
        if isinstance(r, dict):
            for k, c in r["launches_total"].items():
                total[k] += c
    return total


def phase_window(scene, device, card):
    """Phase 23b: NativeWindow (engine/window.py) on a CUDA Viewer through the
    tests' stand-in Tk (no display exists): camera-moving ticks (K2 once a
    tick), the settled PPM against framebuffer_u8 and K2's frame against
    the plain path, a drag, a resize, 'p'
    (K6 five times a tick), Escape."""
    from types import SimpleNamespace

    import numpy as np

    from gpu_raytracer_tpu_torch.engine.viewer import Viewer
    from gpu_raytracer_tpu_torch.engine.window import NativeWindow, window_available

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from fake_tk import FakePhoto, FakeTk

    def ppm_pixels():
        header, pix = FakePhoto.last_data.split(b"\n", 1)
        _, w, h, _ = header.split()
        return np.frombuffer(pix, np.uint8).reshape(int(h), int(w), 3)

    cuda = device.type == "cuda"
    width, height = WINDOW_SIZE
    v = Viewer(scene, width, height, shadows=True, verbose=False, device=device)
    win = NativeWindow(v, tk=FakeTk, max_fps=0.0)
    win.tick()
    key = lambda k: win.root.bindings["<KeyPress>"](SimpleNamespace(keysym=k))
    out = dict(card=card, window_available=window_available())
    launch_tally().clear()
    for i in range(WINDOW_TICKS):
        key("ws"[i % 2])
        win.tick()
    out["moving_launches"] = frame_launches()
    if cuda and out["moving_launches"] != Counter(k2=WINDOW_TICKS):
        raise AssertionError(f"window ticks launched {out['moving_launches']}")
    win.tick()
    win.tick()
    if not np.array_equal(ppm_pixels(), v.framebuffer_u8):
        raise AssertionError("the window's settled PPM differs from framebuffer_u8")
    out["frame_vs_plain"] = refit_frame_compare(v.renderer, f"window K2 {width}x{height}",
                                                v._fb_dev)
    win.root.bindings["<ButtonPress-1>"](SimpleNamespace(x=10, y=10))
    win.root.bindings["<B1-Motion>"](SimpleNamespace(x=40, y=14))
    win.root.bindings["<Configure>"](SimpleNamespace(widget=win.root, width=width // 2,
                                                     height=height // 2))
    win.tick()
    win.tick()
    if ppm_pixels().shape != (height // 2, width // 2, 3):
        raise AssertionError(f"after a resize the window shows {ppm_pixels().shape}")
    key("p")
    launch_tally().clear()
    for _ in range(WINDOW_TICKS):
        win.tick()
    out["pathtrace_launches"] = frame_launches()
    k6 = out["pathtrace_launches"]["k6"]
    if cuda and (k6 != 5 * WINDOW_TICKS
                 or out["pathtrace_launches"]["denoise"] != (PREVIEW_ITERS + 1) * WINDOW_TICKS):
        raise AssertionError(f"path-traced window ticks launched {out['pathtrace_launches']}")
    key("Escape")
    if not (win.closed and win.root.destroyed):
        raise AssertionError("Escape did not close the window")
    out["frames"] = v.perf.frame_count
    log(f"phase 23b window: {json.dumps(out)}")
    return dict(k2=out["moving_launches"]["k2"], k6=k6,
                k5=out["pathtrace_launches"]["k5"],
                denoise=out["pathtrace_launches"]["denoise"])


def oracle_rows(args):
    """A band of the NumPy oracle's rows (run in a spawned process)."""
    from gpu_raytracer_tpu_torch.reference import cpu_tracer

    scene_dict, width, height, rows = args
    return cpu_tracer.render(scene_dict, width, height, rows=rows)


def oracle_frame(scene_dict, width, height):
    """The port's NumPy oracle frame, its rows interleaved over
    ORACLE_WORKERS spawned processes (each band's other rows are 0)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np

    n = max(1, min(ORACLE_WORKERS, os.cpu_count() or 1))
    bands = [(scene_dict, width, height, range(i, height, n)) for i in range(n)]
    with ProcessPoolExecutor(n, mp_context=multiprocessing.get_context("spawn")) as ex:
        parts = list(ex.map(oracle_rows, bands))
    return np.sum(parts, axis=0, dtype=np.float32)


def phase_oracle(device, card):
    """Phase 23c: K2's frame on the card (Renderer at ORACLE_SIZE^2, the
    default scene and the 2,000-triangle courtyard) against the port's NumPy
    oracle (reference/cpu_tracer.py), which shares no code with the
    renderer. The oracle casts no shadow rays: the frame without shadows is
    held to it at ORACLE_RMSE; with shadows, the pixels no shadow ray darkens
    are, and the others may only be darker."""
    import numpy as np

    from gpu_raytracer_tpu_torch.engine.renderer import Renderer
    from gpu_raytracer_tpu_torch.models.scene import build_default_scene
    from gpu_raytracer_tpu_torch.reference import cpu_tracer
    from gpu_raytracer_tpu_torch.utils.image import rmse
    from gpu_raytracer_tpu_torch.utils.procgen import make_courtyard_scene

    size = ORACLE_SIZE
    out = dict(card=card, size=size, bound=ORACLE_RMSE)
    k2 = 0
    for label, scene in (("default", build_default_scene(device=device)),
                         (f"courtyard_{ORACLE_TRIANGLES}",
                          make_courtyard_scene(ORACLE_TRIANGLES, seed=0, device=device))):
        t0 = time.perf_counter()
        want = oracle_frame(cpu_tracer.scene_dict_from(scene), size, size)
        oracle_s = time.perf_counter() - t0
        launch_tally().clear()
        plain, shadowed = (Renderer(scene, size, size, shadows=s, device=device).render()
                           for s in (False, True))
        launches = frame_launches()
        k2 += launches["k2"]
        if device.type == "cuda" and launches != Counter(k2=2):
            raise AssertionError(f"oracle frames launched {launches}")
        lit = (shadowed == plain).all(axis=-1)
        r = dict(rmse_no_shadows=rmse(plain, want),
                 rmse_shadows_unshadowed_pixels=rmse(shadowed[lit], want[lit]),
                 rmse_shadows=rmse(shadowed, want), shadowed_pixels=int((~lit).sum()),
                 shadows_over_oracle=float((shadowed - want).max()),
                 max_abs_no_shadows=float(np.abs(plain - want).max()),
                 oracle_s=oracle_s, mean=float(plain.mean()))
        if not (np.isfinite(plain).all() and plain.max() > 0.05):
            raise AssertionError(f"{label}: an empty or non-finite frame")
        if (r["rmse_no_shadows"] > ORACLE_RMSE or r["rmse_shadows_unshadowed_pixels"] > ORACLE_RMSE
                or r["shadows_over_oracle"] > RGB_TOL):
            raise AssertionError(f"{label} against the NumPy oracle: {r}")
        out[label] = r
    log(f"phase 23c oracle: {json.dumps(out)}")
    return k2


def phase_texture_cache(texture_size, device, card):
    """Phase 23d: the courtyard atlas's disk cache (utils/procgen.py::
    courtyard_textures) in a temporary directory: a cold build that writes
    the file, then a load from it, bit-equal, on the card."""
    import dataclasses

    import torch

    from gpu_raytracer_tpu_torch.config import DEFAULT_CONFIG
    from gpu_raytracer_tpu_torch.models.geometry import JAX_ATLAS_BUDGET_ROWS
    from gpu_raytracer_tpu_torch.models.scene import to_device
    from gpu_raytracer_tpu_torch.utils.procgen import CACHE_ENV, CACHE_MIN_TEXELS
    from gpu_raytracer_tpu_torch.utils.procgen import courtyard_textures as host_textures

    texture_size = max(texture_size, CACHE_MIN_TEXELS)   # smaller sizes are not cached
    mips = DEFAULT_CONFIG.texture_mips
    args = dict(mips=mips, budget_rows=JAX_ATLAS_BUDGET_ROWS if mips > 1 else None)
    courtyard_textures = lambda *a, **kw: to_device(host_textures(*a, **kw), device)
    old = os.environ.get(CACHE_ENV)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            os.environ[CACHE_ENV] = tmp
            t0 = time.perf_counter()
            cold = courtyard_textures(0, texture_size, **args)
            cold_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            warm = courtyard_textures(0, texture_size, **args)
            warm_s = time.perf_counter() - t0
            files = {f: os.path.getsize(os.path.join(tmp, f)) for f in os.listdir(tmp)}
    finally:
        if old is None:
            os.environ.pop(CACHE_ENV, None)
        else:
            os.environ[CACHE_ENV] = old
    bad = [f.name for f in dataclasses.fields(cold) if f.name != "n_levels"
           and not torch.equal(getattr(cold, f.name), getattr(warm, f.name))]
    if bad or cold.n_levels != warm.n_levels or len(files) != 1:
        raise AssertionError(f"cached atlas differs in {bad}, files {files}")
    out = dict(card=card, texture_size=texture_size, cold_build_s=cold_s, warm_load_s=warm_s,
               files=files, device=str(warm.data_u32.device), bit_equal=True)
    log(f"phase 23d texture cache: {json.dumps(out)}")


SINGLE_LEAF_SIZE = 256     # phase 4's default-scene frame


def phase_single_leaf(device, card):
    """Phase 23e: the walk a single-leaf tree takes (the default scene: two
    triangles, one BVH node). The JAX package walks it with the binary
    near-first walk (`_ordered_traverse`); the port gives it one synthesised
    width-4 root in K1's tables (ops/cuda/traverse.py::wide_arrays). K1 on
    the 256x256 camera rays against the plain walk: its ms, the plain ms and
    the bound (frame_bounds on these tables)."""
    import torch

    from gpu_raytracer_tpu_torch.models.scene import build_default_scene
    from gpu_raytracer_tpu_torch.ops.cuda.render import pack_render_tables
    from gpu_raytracer_tpu_torch.ops.cuda.traverse import traverse
    from gpu_raytracer_tpu_torch.ops.trace import traverse_triangles

    size = SINGLE_LEAF_SIZE
    demo = build_default_scene(device=device)
    tables = pack_render_tables(demo)
    if demo.bvh.has_wide or tables.trace.nodes.shape[0] != 1:
        raise AssertionError("the default scene is no longer a single-leaf tree")
    px, py = frame_pixels(size, size, device)
    o, d = primary_rays(demo, size, size, px, py)
    far = torch.full((o.shape[0],), F32_MAX, device=device)
    stats, _ = k1_compare(tables.trace, o, d, far)
    stats.update(ms=timed(lambda: traverse(tables.trace, o, d, far), FRAMES, device),
                 plain_ms=timed(lambda: traverse_triangles(demo, o, d, far), PLAIN_FRAMES,
                                device),
                 card=card)
    if device.type == "cuda":
        b = frame_bounds(tables, size, size)
        stats.update(bound_ms=b["K1"][0], bound_by=b["K1"][1], k2_bound_ms=b["K2"][0],
                     nodes_per_ray=b["nodes"] / b["rays"], tris_per_ray=b["tris"] / b["rays"])
    log(f"phase 23e single-leaf walk {size}x{size}: {json.dumps(stats)}")
    return stats


# ---- phase 24: K1's unordered walk ----

def threaded_compare(tt, o, d, max_t, any_hit=False):
    """K1 unordered against its plain version (the threaded walk with its
    work counted) -> (stats, the plain walk's [N,2] visits and triangle
    tests, the kernel's (t, slot)). Every output equal, bit for bit, on
    every lane."""
    import torch

    from gpu_raytracer_tpu_torch.ops.bvh_traverse import bvh_traverse_threaded
    from gpu_raytracer_tpu_torch.ops.cuda.traverse import traverse_threaded
    from gpu_raytracer_tpu_torch.ops.trace import slot_attributes

    scene = tt.scene
    work = torch.zeros((o.shape[0], 2), dtype=torch.int64, device=o.device)
    pt, ps, ph = bvh_traverse_threaded(scene.bvh, scene.tri_v0, scene.tri_e1, scene.tri_e2, o,
                                       d, max_t, leaf_size=scene.bvh.max_leaf, any_hit=any_hit,
                                       work=work)
    pn, pm = slot_attributes(scene, ps, ph)
    kt, ks, kh, kn, km = traverse_threaded(tt, o, d, max_t, any_hit=any_hit)
    same = dict(t=torch.equal(kt, pt), slot=torch.equal(ks.long(), ps), hit=torch.equal(kh, ph),
                normal=torch.equal(kn, pn), material=torch.equal(km.long(), pm))
    if not all(same.values()):
        raise AssertionError(f"K1 unordered differs from the plain threaded walk: {same}")
    return dict(rays=o.shape[0], hits=int(kh.sum()), max_abs_err=0.0,
                nodes_per_ray=work[:, 0].float().mean().item(),
                tris_per_ray=work[:, 1].float().mean().item()), work, (kt, ks)


def postponed_visits(tt, o, d, max_t, any_hit, work):
    """The counting instance of K1 unordered (`past`): its outputs equal to
    the main instance's, bit for bit -> the rays that walked past a pending
    leaf, and the visits made so, a ray and as a share of the plain walk's
    visits (`work`)."""
    import torch

    from gpu_raytracer_tpu_torch.ops.cuda.traverse import traverse_threaded

    past = torch.zeros((o.shape[0],), dtype=torch.int32, device=o.device)
    counted = traverse_threaded(tt, o, d, max_t, any_hit=any_hit, past=past)
    for got, want in zip(counted, traverse_threaded(tt, o, d, max_t, any_hit=any_hit)):
        if not torch.equal(got, want):
            raise AssertionError("K1 unordered's counting instance differs from its main one")
    total = int(past.sum())
    return dict(rays_past=int((past > 0).sum()), rays=o.shape[0],
                visits_past_per_ray=total / o.shape[0],
                share_of_plain_visits=total / max(int(work[:, 0].sum()), 1))


def phase_threaded(scene, tables, width, height, device, card):
    """Phase 24: K1's unordered walk (csrc/traverse_threaded.cu, the JAX
    package's `pallas_packet_traverse(ordered=False)`) on the frame's camera
    rays, closest hit, and on shadow rays from their hits toward the point
    light, any hit: t, slot, hit, normal and material equal to the plain
    threaded walk on every lane (the lean box test and the postponed leaf,
    csrc/threaded_walk.cuh), its counting instance too, which reads how
    far lanes walked past a pending leaf (`postponed`); the closest t equal
    to K1's
    (near-first) outside counted exact-t ties (another slot at the same t);
    its time between events and on the device (torch.profiler, the L2
    flushed), its registers, its bound from the plain walk's visits and
    triangle tests, and its launches on the main path: none (no entry point
    calls it)."""
    import torch

    from gpu_raytracer_tpu_torch.ops.bvh_traverse import bvh_traverse_threaded
    from gpu_raytracer_tpu_torch.ops.cuda.traverse import (pack_threaded_tables, traverse,
                                                           traverse_threaded)
    from gpu_raytracer_tpu_torch.ops.linalg import dot

    tt = pack_threaded_tables(scene)
    px, py = frame_pixels(width, height, device)
    o, d = primary_rays(scene, width, height, px, py)
    far = torch.full((o.shape[0],), F32_MAX, device=device)
    camera, work, (tt_t, tt_s) = threaded_compare(tt, o, d, far)
    kt, ks, kh, kn = traverse(tables.trace, o, d, far)[:4]
    if not torch.equal(kh, tt_s >= 0):
        raise AssertionError("K1 unordered and K1 disagree on which rays hit")
    t_off = int((kt != tt_t).sum())
    ties = int(((ks != tt_s) & (kt == tt_t)).sum())
    if t_off:
        raise AssertionError(f"K1 unordered's closest t differs from K1's on {t_off} rays")
    # shadow rays from every hit toward the point light, any hit
    hit = torch.nonzero(kh).squeeze(1)
    L = scene.lights
    li = int(torch.nonzero(L.light_type == 1)[0])
    p = o[hit] + d[hit] * kt[hit, None]
    so = (p + kn[hit] * 1e-3).contiguous()
    to_light = L.position[li][None, :] - p
    dist = torch.sqrt(dot(to_light, to_light))
    sd = (to_light / dist[:, None]).contiguous()
    smax = (dist - 1e-3).contiguous()
    shadow, swork, _ = threaded_compare(tt, so, sd, smax, any_hit=True)
    ms = timed(lambda: traverse_threaded(tt, o, d, far), FRAMES, device)
    shadow_ms = timed(lambda: traverse_threaded(tt, so, sd, smax, any_hit=True), FRAMES, device)
    scene_ = tt.scene
    plain_ms = timed(lambda: bvh_traverse_threaded(
        scene_.bvh, scene_.tri_v0, scene_.tri_e1, scene_.tri_e2, o, d, far,
        leaf_size=scene_.bvh.max_leaf), PLAIN_FRAMES, device)
    w = work.sum(dim=0).tolist()
    flops = float(w[0] * SLAB_FLOPS + w[1] * TRI_FLOPS)
    # rays in (origin, direction, max_t), both tables once, results out (t, slot, normal, material)
    nbytes = o.shape[0] * (28 + 24) + table_bytes(tt.nodes, tt.tris)
    b_ms, b_by = bound_ms(nbytes, flops)
    ws = swork.sum(dim=0).tolist()
    s_ms, s_by = bound_ms(so.shape[0] * 52 + table_bytes(tt.nodes, tt.tris),
                          float(ws[0] * SLAB_FLOPS + ws[1] * TRI_FLOPS))
    regs, device_ms, postponed = {}, {}, {}
    if device.type == "cuda":
        from gpu_raytracer_tpu_torch.ops.cuda.build import load_kernels

        regs = {k: v for k, v in ptxas_summary(load_kernels().log).items()
                if k.startswith("traverse_threaded_kernel")}
        postponed = dict(camera=postponed_visits(tt, o, d, far, False, work),
                         shadow=postponed_visits(tt, so, sd, smax, True, swork))
        device_ms = dict(
            camera=kernel_device_ms(lambda: traverse_threaded(tt, o, d, far),
                                    "traverse_threaded_kernel", FRAMES, device),
            shadow=kernel_device_ms(lambda: traverse_threaded(tt, so, sd, smax, any_hit=True),
                                    "traverse_threaded_kernel", FRAMES, device))
    stats = dict(camera=camera, shadow=shadow, k1_ties=ties, k1_t_off=t_off, ms=ms,
                 shadow_ms=shadow_ms, device_ms=device_ms,
                 lean=tt.lean, postponed=postponed, plain_ms=plain_ms,
                 bound_ms=b_ms, bound_by=b_by,
                 shadow_bound_ms=s_ms, shadow_bound_by=s_by, k1_ms=timed(
                     lambda: traverse(tables.trace, o, d, far), FRAMES, device),
                 ptxas=regs, main_path_launches=0, card=card)
    log(f"phase 24 K1 unordered {width}x{height}: {json.dumps(stats)}")
    return stats


# ---- phase 25: the multi-device layer on virtual meshes of one card ----

MESH_SIZES = (1, 2, 4, 8)
MESH_CALLS = 3           # timed calls of each sharded path, per mesh size
ODD_RAYS = 1003          # the ring's odd batch (block padding), spread over the frame


class CollectiveTimer:
    """CUDA events around every collective (pmin, psum, ppermute_next,
    gather) that parallel/shard.py calls inside a `with` block: their summed
    time is the combine's share of a call (off the card: nothing)."""

    NAMES = ("pmin", "psum", "ppermute_next", "gather")

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.pairs = []

    def _wrap(self, fn):
        import torch

        def timed_fn(*args, **kw):
            if not self.cuda:
                return fn(*args, **kw)
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args, **kw)
            b.record()
            self.pairs.append((a, b))
            return out

        return timed_fn

    def __enter__(self):
        from gpu_raytracer_tpu_torch.parallel import shard

        self.stack = contextlib.ExitStack()
        for name in self.NAMES:
            self.stack.enter_context(_swap(shard, name, self._wrap(getattr(shard, name))))
        return self

    def __exit__(self, *exc):
        return self.stack.__exit__(*exc)

    def ms(self) -> float:
        import torch

        if not self.cuda:
            return 0.0
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.pairs)


def sharded_reading(fn, device, want: dict) -> dict:
    """One call of fn with its launches counted (on the card exactly `want`,
    by kernel), then MESH_CALLS timed calls (median ms between events) and
    the collectives' share of one more."""
    launch_tally().clear()
    out = fn()
    launches = {k: v for k, v in frame_launches().items() if v}
    if device.type == "cuda" and launches != want:
        raise AssertionError(f"a sharded call launched {launches}, want {want}")
    ms = timed(fn, MESH_CALLS, device)
    total = CollectiveTimer(device)
    with total:
        call_ms = timed(fn, 1, device)
    combine = total.ms()
    prof = {}
    if device.type == "cuda":
        # the profiler has been seen to drop some or all of a short call's
        # kernels, never to add any: keep the session that recorded the most
        p = max((device_profile(fn, MESH_CALLS, device) for _ in range(PROFILE_SESSIONS)),
                key=lambda q: (q["kernels_per_call"], q["device_ms"]))
        empty = p["device_ms"] == 0.0
        prof = dict(device_ms=None if empty else p["device_ms"],
                    host_enqueue_ms=p["host_enqueue_ms"],
                    kernels_per_call=None if empty else p["kernels_per_call"])
    return out, dict(ms=ms, launches=launches, combine_ms=combine,
                     combine_share=combine / call_ms if call_ms else None, **prof)


def hold_sharded_hit(got, single, scene, rows=slice(None)) -> dict:
    """A sharded trace against the single-device trace (K1): hit equal; t
    bit-equal and material and prim_id (the single winner's original id)
    equal outside counted exact-t ties (the same t, another triangle)."""
    import torch

    from gpu_raytracer_tpu_torch.ops.trace import TRIANGLE

    h = single.hit[rows]
    if not torch.equal(got.hit, h):
        raise AssertionError(f"sharded hit mask differs on {(got.hit != h).sum().item()} rays")
    t_off = int((got.t != single.t[rows]).sum())
    if t_off:
        raise AssertionError(f"sharded t differs on {t_off} rays")
    tri = single.prim_kind[rows] == TRIANGLE
    want_id = torch.where(tri, scene.tri_src[single.prim_id[rows].clamp(min=0)].long(),
                          single.prim_id[rows])
    ties = got.prim_id != want_id
    mat_off = int(((got.material_id != single.material_id[rows]) & ~ties).sum())
    if mat_off:
        raise AssertionError(f"sharded material differs on {mat_off} rays off ties")
    if int(ties.sum()) > TIE_BUDGET * h.shape[0]:
        raise AssertionError(f"{int(ties.sum())} tie rays > {TIE_BUDGET:.2%}")
    nrm = (got.normal - single.normal[rows]).abs().amax(dim=1)[~ties]
    return dict(rays=int(h.shape[0]), hits=int(h.sum()), ties=int(ties.sum()),
                tie_material_off=int(((got.material_id != single.material_id[rows])
                                      & ties).sum()),
                normal_abs=nrm.max().item() if nrm.numel() else 0.0)


def phase_multidevice(scene, tables, tscene, width, height, pt_size, device, card):
    """Phase 25: parallel/ on virtual meshes of 1, 2, 4 and 8 shards of one
    card (make_mesh(D, device=...)), full width on the 100k courtyards:
    render_frame_fused_multichip at width x height (untextured, shadows off
    and on, and the textured courtyard: K2, or K3 + K4, a launch per shard)
    0.0 from the single-device Renderer frame; trace_geometry_sharded and
    trace_geometry_sharded_ring on the frame's camera rays (and the ring on
    an odd batch of ODD_RAYS) against the single-device trace through K1;
    pathtrace_step_sharded at pt_size^2, one step, within 1e-5 of
    PathTracer.step(), counts equal. Per mesh size: ms per call, launches
    per call by kernel and the collectives' share. One card's numbers: the
    speed-up on several cards is not measured."""
    import numpy as np
    import torch

    from gpu_raytracer_tpu_torch.engine.pathtracer import PathTracer
    from gpu_raytracer_tpu_torch.engine.renderer import Renderer
    from gpu_raytracer_tpu_torch.ops.cuda.bounce import pack_bounce_tables
    from gpu_raytracer_tpu_torch.ops.cuda.render import render_deferred
    from gpu_raytracer_tpu_torch.ops.cuda.texshade import pack_shade_tables, texture_shade
    from gpu_raytracer_tpu_torch.ops.cuda.traverse import trace
    from gpu_raytracer_tpu_torch.parallel.mesh import make_mesh
    from gpu_raytracer_tpu_torch.parallel.shard import (
        GeometryShards, pathtrace_step_sharded, render_frame_fused_multichip,
        replicate_tables, trace_geometry_sharded, trace_geometry_sharded_ring)

    cases = {("courtyard", False): scene, ("courtyard", True): scene,
             ("textured_courtyard", False): tscene}
    frames = {}
    for (label, shadows), sc in cases.items():
        r = Renderer(sc, width, height, shadows=shadows, device=device)
        if label == "textured_courtyard":   # the two phases, as Renderer takes them on the card
            gbuf = render_deferred(r.tables, r.px, r.py, width, height, shadows=shadows)
            frames[(label, shadows)] = r.to_image(texture_shade(
                pack_shade_tables(r.scene), gbuf).cpu().numpy())
        else:
            frames[(label, shadows)] = r.render()
    px, py = frame_pixels(width, height, device)
    o, d = primary_rays(scene, width, height, px, py)
    single = trace(tables.trace, o, d)
    # the odd batch: ODD_RAYS rays spread over the frame
    odd_rows = torch.arange(ODD_RAYS, device=device) * (o.shape[0] // ODD_RAYS)
    pt = PathTracer(scene, pt_size, pt_size, device=device)
    pt.step()
    step_ref, counts_ref = pt.accum.clone(), pt._last_counts.clone()
    totals = Counter()
    out = {}
    for D in MESH_SIZES:
        mesh = make_mesh(D, device=device)
        t0 = time.perf_counter()
        shards = GeometryShards(scene, mesh)
        shards_s = time.perf_counter() - t0
        rt = {"courtyard": replicate_tables(mesh, scene),
              "textured_courtyard": replicate_tables(mesh, tscene)}
        st = replicate_tables(mesh, tscene, pack_shade_tables)
        r = dict(geometry_shards_s=shards_s,
                 shard_bvh_nodes=[s.scene.bvh.num_nodes for s in shards.shards])
        for (label, shadows), sc in cases.items():
            fb, reading = sharded_reading(lambda: render_frame_fused_multichip(
                rt[label], width, height, mesh, shadows=shadows,
                shade_tables=st if label == "textured_courtyard" else None, host=False),
                device,
                dict(k3=D, k3_pre=D, k4=D) if label == "textured_courtyard" else dict(k2=D))
            err = float(np.abs(fb.cpu().numpy() - frames[(label, shadows)]).max())
            if err != 0.0:
                raise AssertionError(f"D={D} fused frame {label} shadows={shadows}: "
                                     f"max |diff| {err} from the single device")
            r[f"fused_{label}_{'shadows' if shadows else 'no_shadows'}"] = dict(
                max_abs_err=err, **reading)
        hit, reading = sharded_reading(
            lambda: trace_geometry_sharded(scene, o, d, mesh, shards), device,
            dict(k1_standalone=D))
        r["geometry"] = dict(**hold_sharded_hit(hit, single, scene), **reading)
        hit, reading = sharded_reading(
            lambda: trace_geometry_sharded_ring(scene, o, d, mesh, shards), device,
            dict(k1_standalone=D * D))
        r["ring"] = dict(**hold_sharded_hit(hit, single, scene), **reading)
        odd = trace_geometry_sharded_ring(scene, o[odd_rows], d[odd_rows], mesh, shards)
        r["ring_odd"] = hold_sharded_hit(odd, single, scene, odd_rows)
        bt = replicate_tables(mesh, scene, pack_bounce_tables)
        zero = torch.zeros_like(step_ref)
        (acc, counts), reading = sharded_reading(lambda: pathtrace_step_sharded(
            bt, zero, 0, pt._px, pt._py, mesh, width=pt_size, height=pt_size,
            max_depth=MAX_DEPTH, rr_start=RR_START, qmc_seed=pt._qmc_seed,
            tex_lod_bias=pt.config.bounce_lod_bias), device, dict(k6=D * (MAX_DEPTH + 1)))
        step_err = (acc - step_ref).abs().max().item()
        if step_err > 1e-5 or not torch.equal(counts, counts_ref):
            raise AssertionError(f"D={D} sharded step: max |diff| {step_err}, counts "
                                 f"{counts.tolist()} against {counts_ref.tolist()}")
        r["step"] = dict(max_abs_err=step_err, counts=counts.tolist(), **reading)
        for v in r.values():
            if isinstance(v, dict):
                for k, n in v.get("launches", {}).items():
                    totals[k] = totals.get(k, 0) + n
        out[f"D={D}"] = r
        del shards, rt, st, bt
    out["note"] = ("virtual shards on one card: one card's numbers; the speed-up on several "
                   "cards is not measured and not claimed")
    out["card"] = card
    log(f"phase 25 multi-device (virtual meshes on one card): {json.dumps(out)}")
    out["launch_totals"] = totals
    return out


DEEP_TRIANGLES = 1_000_000   # the benchmark's courtyard-1m: an 11-level wide tree, stack 64
DEEP_CALLS = 20              # K2 launches per device-time reading of phase 26


# Profiler sessions phase 26 tries for a trace that holds its frames. In a
# process older than a minute or two the profiler records anything from
# none to all of a session's 8 K2 frames, while the launch counters count
# every one (PERF.md section 7): a session that recorded none is profiled
# again, as kernel_device_ms does, and the sessions needed are printed.
DEEP_PROFILE_SESSIONS = 5


def phase_deep(scene, width, height, device, card):
    """Phase 26: the million-triangle courtyard, whose 11-level wide tree
    takes the kernels' 64-entry stack. Renderer frames at full size, shadows
    off and on, launched under torch.profiler with the launch counts reset
    just before: one K2 launch a frame, and on the device trace only
    `render_primary_kernel<4, 64, false>`; each frame held to the plain
    render_chunk outside counted ties (order_ties). Then K2's device time
    with shadows, back to back and with the L2 flushed before each launch,
    on these tables, on `scene`'s (the 100k courtyard, stack 32) and on
    `scene`'s launched through the 64-entry instance, whose frame must equal
    the 32-entry one's bit for bit: the stack instance's cost apart from
    the tables' size."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    from gpu_raytracer_tpu_torch.engine.renderer import Renderer
    from gpu_raytracer_tpu_torch.ops.render import render_chunk
    from gpu_raytracer_tpu_torch.utils.procgen import make_courtyard_scene

    cuda = device.type == "cuda"
    t0 = time.perf_counter()
    deep = make_courtyard_scene(DEEP_TRIANGLES, seed=0, device=device)
    out = dict(triangles=deep.num_triangles, build_s=time.perf_counter() - t0)
    instance = "render_primary_kernel<4, 64, false>"
    ties = None
    for shadows in (False, True):
        key = "shadows" if shadows else "no_shadows"
        r = Renderer(deep, width, height, shadows=shadows, device=device)
        tr = r.tables.trace
        if (tr.width, tr.depth, tr.stack) != (4, 11, 64):
            raise AssertionError(f"the {DEEP_TRIANGLES} courtyard's tables: width {tr.width}, "
                                 f"depth {tr.depth}, stack {tr.stack}; want 4, 11, 64")
        if ties is None:
            ties, counts = order_ties(r.tables, width, height, r.px, r.py)
            out["ties"] = counts
            out["tables_mb"] = 4 * (tr.nodes.numel() + tr.tris.numel()) / 1e6
        first = r.render_device()
        if cuda:
            torch.cuda.synchronize(device)
        for session in range(1, DEEP_PROFILE_SESSIONS + 1):
            launch_tally().clear()
            with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
                for _ in range(FRAMES):
                    got = r.render_device()
                if cuda:
                    torch.cuda.synchronize(device)
            launches = frame_launches()
            seen = {}
            for e in prof.key_averages():
                if "render_primary_kernel" in e.key:
                    name = e.key[e.key.index("render_primary_kernel"):].split(">")[0] + ">"
                    seen[name] = seen.get(name, 0) + e.count
            if seen or not cuda:
                break
        PROFILER_SESSIONS.setdefault(f"phase 26 {key}", []).append(session)
        if cuda and (launches != Counter(k2=FRAMES) or set(seen) != {instance}
                     or not 0 < seen[instance] <= FRAMES):
            raise AssertionError(f"{FRAMES} frames launched {launches}; the trace holds {seen} "
                                 f"after {session} sessions, want only {instance}")
        if not torch.equal(got, first) or not torch.isfinite(got).all():
            raise AssertionError("the deep courtyard's frames differ between runs or are "
                                 "not finite")
        ref = render_chunk(r.scene, r.px, r.py, width, height, shadows=shadows)
        diff = (got - ref).abs().amax(dim=1)
        err = diff[~ties].max().item()
        if err > RGB_TOL:
            raise AssertionError(f"deep courtyard K2 max |diff| {err:.3g} > {RGB_TOL} outside "
                                 f"{int(ties.sum())} ties")
        out[key] = dict(err=err, err_with_ties=diff.max().item(), mean=got.mean().item(),
                        k2_launches=launches["k2"], instances_traced=seen)
    if cuda:
        small = Renderer(scene, width, height, shadows=True, device=device)
        small_tr = small.tables.trace
        if small_tr.stack != 32:
            raise AssertionError(f"the 100k courtyard's stack {small_tr.stack}, want 32")
        frame32 = small.render_device()
        forced = Renderer(scene, width, height, shadows=True, device=device)
        forced.tables = dataclasses.replace(
            small.tables, trace=dataclasses.replace(small_tr, stack=64))
        frame64 = forced.render_device()
        if not torch.equal(frame32, frame64):
            raise AssertionError("the 100k courtyard's frame through the 64-entry instance "
                                 "differs from the 32-entry one's")
        ms = {}
        for label, rr in (("1m_stack64", r), ("100k_stack32", small),
                          ("100k_stack64", forced)):
            for flush in (False, True):
                ms[f"{label}_{'flushed' if flush else 'warm'}"] = kernel_device_ms(
                    rr.render_device, "render_primary_kernel", DEEP_CALLS, device, flush=flush)
        out["k2_device_ms"] = ms
        out["ratios"] = {f"{a}_over_{b}_{w}": ms[f"{a}_{w}"] / ms[f"{b}_{w}"]
                         for a, b in (("1m_stack64", "100k_stack32"),
                                      ("100k_stack64", "100k_stack32"),
                                      ("1m_stack64", "100k_stack64"))
                         for w in ("warm", "flushed")}
        out["flushed_over_warm"] = {label: ms[f"{label}_flushed"] / ms[f"{label}_warm"]
                                    for label in ("1m_stack64", "100k_stack32", "100k_stack64")}
        out["peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    out["card"] = card
    log(f"phase 26 the {DEEP_TRIANGLES:,}-triangle courtyard (64-entry stack): "
        f"{json.dumps(out)}")
    return out


def run(device, width, height, triangles, shadow_rays, card, texture_size=TEXTURE_SIZE,
        pt_size=PT_SIZE, synth_size=SYNTH_SIZE, zoo_triangles=ZOO_TRIANGLES, crop=CROP):
    import tempfile

    import torch

    from gpu_raytracer_tpu_torch.models.bvh_native import load_builder
    from gpu_raytracer_tpu_torch.models.scene import build_default_scene
    from gpu_raytracer_tpu_torch.ops.cuda.bounce import pack_bounce_tables
    from gpu_raytracer_tpu_torch.ops.cuda.render import pack_render_tables
    from gpu_raytracer_tpu_torch.utils.procgen import make_courtyard_scene

    cuda = device.type == "cuda"
    t0 = time.perf_counter()
    scene = make_courtyard_scene(triangles, seed=0, device=device)
    build_s = time.perf_counter() - t0
    builder = load_builder()
    tables = pack_render_tables(scene)
    info = dict(triangles=scene.num_triangles, bvh_nodes=scene.bvh.num_nodes,
                bvh4_nodes=tables.trace.nodes.shape[0], bvh4_depth=tables.trace.depth,
                stack=tables.trace.stack, build_s=build_s, builder=builder.origin,
                builder_lib=os.path.relpath(builder.path, ROOT))
    log(f"phase 2 scene: {json.dumps(info)}")

    k1, ties = phase_k1(scene, tables.trace, width, height, shadow_rays, device, card,
                        ref="courtyard")
    k2 = {f"courtyard_{'shadows' if s else 'no_shadows'}":
          k2_compare(scene, width, height, s, device, ties, ref="courtyard")
          for s in (False, True)}
    demo = build_default_scene(device=device)
    k2.update({f"default_256_{'shadows' if s else 'no_shadows'}":
               k2_compare(demo, 256, 256, s, device) for s in (False, True)})
    log(f"phase 4 K2: {json.dumps(k2)}")

    main = phase_main(scene, width, height, device, card)
    phase_camera_move(scene, width, height, pt_size, device, card)
    k2_err = max(v["err"] for v in k2.values())
    k2_launches = main["no_shadows"]["k2_launches"] + main["shadows"]["k2_launches"]

    tscene, ttables, tshade = phase_textured_scene(device, triangles, texture_size)
    k3, gbuf, ties = phase_k3(tscene, ttables, width, height, device, card,
                              ref="textured_courtyard")
    k3_pre = phase_camera_relative(tscene, ttables, tables, device, card)
    k4 = phase_k4(tshade, gbuf, ties, device, card)
    tmain = phase_textured_main(tscene, width, height, device, card, ties,
                                ref="textured_courtyard")
    k3_launches = tmain["no_shadows"]["k3_launches"] + tmain["shadows"]["k3_launches"]
    k3_pre_launches = (tmain["no_shadows"]["k3_pre_launches"]
                       + tmain["shadows"]["k3_pre_launches"])
    k4_launches = tmain["no_shadows"]["k4_launches"] + tmain["shadows"]["k4_launches"]
    k3_err = max(v[e] for v in k3.values() if isinstance(v, dict)
                 for e in ("S", "uv", "lam_rel"))
    del gbuf

    btables = pack_bounce_tables(scene)
    k6 = phase_k6(btables, pt_size, pt_size, "courtyard", ref="courtyard")
    log(f"phase 10 K6 {pt_size}x{pt_size}: {json.dumps(k6)}")
    tbtables = pack_bounce_tables(tscene)
    k6t = phase_k6(tbtables, pt_size, pt_size, "textured_courtyard", biases=(0.0, 1.0),
                   ref="textured_courtyard")
    synth = pack_bounce_tables(synthetic_textured_scene(0, mips=4, device=device))
    k6t.update(phase_k6(synth, synth_size, synth_size, "synthetic", biases=(0.0, 1.0),
                        depths=(0, 1, 2)))
    degenerate = pack_bounce_tables(synthetic_textured_scene(1, degenerate_glass=True,
                                                             device=device))
    k6t.update(phase_k6(degenerate, synth_size, synth_size, "synthetic_ior1_glass",
                        depths=(0, 1)))
    # one light: the all-lights (NEE_ALL) textured instances on the main path's pools
    one_light = pack_bounce_tables(make_courtyard_scene(
        triangles, seed=0, lights=1, textured=True, texture_size=texture_size, device=device))
    k6t.update(phase_k6(one_light, pt_size, pt_size, "textured_courtyard_1light", depths=(0, 1)))
    log(f"phase 11 K6 textured: {json.dumps(k6t)}")
    k5 = phase_k5(tbtables, synth, device, card, pt_size)
    if cuda:   # the kernel's stream exists only on the card
        phase_qmc(device, card, pt_size * pt_size)
    del btables, tbtables, synth, degenerate, one_light

    plain_images = {}   # phase 12's plain 4-spp images: phase 22's width-8 reference
    pt = {label: phase_pathtracer(sc, label, device, card, pt_size, keep=plain_images)
          for label, sc in (("courtyard", scene), ("textured_courtyard", tscene))}
    k6_launches = sum(v["launches"]["k6"] for v in pt.values())
    k5_launches = sum(v["launches"]["k5"] for v in pt.values())

    with tempfile.TemporaryDirectory() as tmp:
        glb_scene, glb = phase_glb_round_trip(tscene, texture_size, tmp, width, height, device,
                                              card)
        zoos = {}
        for multi_slot in (False, True):
            label = "zoo_multi_slot" if multi_slot else "zoo"
            zoos[label], _ = phase_zoo(multi_slot, zoo_triangles, tmp, width, height, crop,
                                       device, card)
    k2t, k2t_launches, k2t_pre = phase_k2t(dict(textured_courtyard=glb_scene, **zoos), width,
                                           height, device, card)
    k3_pre_launches += k2t_pre
    ms_2_lights = {(label, s): v["shadows" if s else "no_shadows"]["ms"]
                   for label, v in (("untextured", main), ("textured", {
                       "no_shadows": k2t["textured_courtyard_no_shadows"],
                       "shadows": k2t["textured_courtyard_shadows"]}))
                   for s in (False, True)}
    phase_many_lights(triangles, texture_size, width, height, crop, device, card, ms_2_lights)
    phase_zoo_pathtrace(zoos["zoo_multi_slot"], pt_size, device, card)
    gd = phase_gbuffer_denoise(tscene, pt_size, device, card)
    atrous = phase_atrous(scene, pt_size, device, card)
    fly = {label: phase_fly(sc, label, pt_size, device, card)
           for label, sc in (("courtyard", scene), ("textured_courtyard", tscene))}
    ada = phase_adaptive(scene, pt_size, device, card)
    vr = phase_viewer_refit(scene, tscene, width, height, device, card)
    viewer_k2 = (vr["camera_moving"]["launches"]["k2"] + vr["refit_and_frame"]["launches"]["k2"]
                 + vr["rebuilt_frame"].get("k2_launches", 0))
    textured_viewer = [vr[k]["launches"] for k in ("textured_camera_move",
                                                   "textured_scaled_refit", "textured_rebuilt")]
    viewer_k3 = sum(t["k3"] for t in textured_viewer)
    viewer_k4 = sum(t["k4"] for t in textured_viewer)
    k3_pre_launches += sum(t["k3_pre"] for t in textured_viewer)
    k2_launches += viewer_k2
    k2_err = max(k2_err, vr["refit_and_frame"]["max_abs_err"], vr["rebuilt_frame"]["max_abs_err"])
    k3_launches += viewer_k3
    k4_launches += viewer_k4
    k3_err = max([k3_err] + [vr[k]["gbuffer"][e] for k in ("textured_camera_move",
                                                          "textured_scaled_refit",
                                                          "textured_rebuilt")
                             for e in ("S", "uv", "lam_rel")])
    interactive = [gd["gbuffer"]["launches"], ada["launches"]] + [v["launches"]
                                                                  for v in fly.values()]
    k1_standalone = sum(v["k1_standalone"] for v in interactive)
    k5_standalone = sum(v["k5_standalone"] for v in interactive)
    k6_launches += sum(v["k6"] for v in interactive)
    k5_launches += sum(v["k5"] for v in interactive)
    k2t_err = max([v["err"] for k, v in k2t.items() if k.endswith("shadows")]
                  + [v["err"] for v in k2t["moved_camera"]["frames"].values()])
    w8 = phase_width8(scene, tables, tscene, ttables, tshade, width, height, pt_size, triangles,
                      texture_size, shadow_rays, plain_images, device, card)
    del plain_images
    PLAIN_REFS.clear()
    sbvh = phase_sbvh(scene, tables, width, height, pt_size, triangles, device, card)
    k2_launches += sbvh["launches"]["k2"]
    k6_launches += sbvh["launches"]["k6"]
    k2_err = max(k2_err, sbvh["k2_err"])
    served = phase_server(scene, tscene, device, card)
    k2_launches += served["k2"]
    k3_launches += served["k3"]
    k3_pre_launches += served["k3_pre"]
    k4_launches += served["k4"]
    k6_launches += served["k6"]
    k5_launches += served["k5"]
    k1_standalone += served["k1_standalone"]
    windowed = phase_window(scene, device, card)
    # the filter through the port's entry points: phase 18's call, the fly
    # frames, the served and the windowed still previews
    denoise_launches = (gd["denoise"]["launches"]["denoise"] + windowed["denoise"]
                        + served["denoise"] + sum(v["launches"]["denoise"] for v in fly.values()))
    k2_launches += windowed["k2"]
    k6_launches += windowed["k6"]
    k5_launches += windowed["k5"]
    k2_launches += phase_oracle(device, card)
    phase_texture_cache(texture_size, device, card)
    phase_single_leaf(device, card)
    thr = phase_threaded(scene, tables, width, height, device, card)
    md = phase_multidevice(scene, tables, tscene, width, height, pt_size, device, card)
    mt = md["launch_totals"]   # the shards' launches in phase 25's main-path calls
    k2_launches += mt["k2"]
    k3_launches += mt["k3"]
    k3_pre_launches += mt["k3_pre"]
    k4_launches += mt["k4"]
    k6_launches += mt["k6"]
    k1_standalone += mt["k1_standalone"]
    deep = phase_deep(scene, width, height, device, card)
    k2_launches += deep["no_shadows"]["k2_launches"] + deep["shadows"]["k2_launches"]
    k2_err = max(k2_err, deep["no_shadows"]["err"], deep["shadows"]["err"])

    w8l, w8e, w8b = w8["launches"], w8["max_abs_err"], w8.get("bounds", {})
    k3_pre_launches += w8l["k3_pre"]
    # one pre-pass before every K3 launch, every K2t launch and every
    # width-8 K2 launch
    pre_for = k3_launches + k2t_launches + w8l["k3_w8"] + w8l["k2_w8"] + w8l["k2t_w8"]
    if cuda and k3_pre_launches != pre_for:
        raise AssertionError(f"{k3_pre_launches} launches of K3's pre-pass for {pre_for} of K3, "
                             f"K2t, K2 w8 and K2t w8 on the main paths")
    fb = frame_bounds(tables, width, height) if cuda else {}
    tfb = frame_bounds(ttables, width, height, shade=tshade) if cuda else {}
    bound = lambda b: dict(bound_ms=b[0], bound_by=b[1]) if b else dict(bound_ms=None,
                                                                           bound_by=None)
    ptc = pt["courtyard"]
    kb = ptc["k6_bound"] or {}
    kernels = [
        dict(name="K1 bvh4_traverse (device function run by every K2, K2t, K3 and K6 launch; "
                  "standalone kernel checked in phase 3 and launched by the G-buffer and the "
                  "fly-through's warp, phases 18-19, and once per shard by the sharded traces "
                  "of phase 25)",
             route="cuda", source="gpu_raytracer_tpu_torch/csrc/traverse.cu",
             replaces="gpu_raytracer_tpu/ops/pallas/traverse.py:851",
             launches=k2_launches + k2t_launches + k3_launches + k6_launches + k1_standalone,
             max_abs_err=max(k1["primary"]["t_abs"], k1["primary"]["normal_abs"],
                             k1["shadow"]["t_abs"], k1["shadow"]["normal_abs"]),
             ms=k1["ms"], plain_ms=k1["plain_ms"], **bound(fb.get("K1")), library_ms=None),
        dict(name="K2 render_primary (also one launch per Viewer frame, on refit and rebuilt "
                  "trees, phase 21, per camera-moving frame served over HTTP and window tick, "
                  "phase 23, on the NumPy oracle's frames, phase 23c, and once per shard of a "
                  "sharded frame, phase 25)", route="cuda",
             source="gpu_raytracer_tpu_torch/csrc/render_primary.cu",
             replaces="gpu_raytracer_tpu/ops/pallas/render.py:701",
             launches=k2_launches, max_abs_err=k2_err,
             ms=main["no_shadows"]["ms"], plain_ms=main["no_shadows"]["plain_ms"],
             **bound(fb.get("K2")), library_ms=None),
        dict(name="K2t render_primary_textured (ms, plain_ms and the bound on the GLB-loaded "
                  "textured courtyard, shadows off; held to the plain render_chunk on that "
                  "scene, after a camera move and on both zoos, phase 15; ms: the wrapper "
                  "between CUDA events, K3's pre-pass then K2t, whose camera walk reads its "
                  "tables; bound_ms: the two kernels' work, the camera walk at its relative "
                  "costs; k2_device_ms, k2_and_pre_pass_device_ms: torch.profiler, the L2 "
                  "flushed before each call; k2_alone_bound_ms: K2t's own work)",
             route="cuda",
             source="gpu_raytracer_tpu_torch/csrc/render_primary_textured.cu",
             replaces="gpu_raytracer_tpu/ops/pallas/render.py:363",
             launches=k2t_launches, max_abs_err=k2t_err,
             ms=k2t["textured_courtyard_no_shadows"]["ms"],
             plain_ms=k2t["textured_courtyard_no_shadows"]["plain_ms"],
             **bound(tfb.get("K2t")), library_ms=None,
             k2_device_ms=k2t.get("k2t_device_ms", {}).get("no_shadows"),
             k2_and_pre_pass_device_ms=k2t.get("k2t_device_ms", {}).get(
                 "no_shadows_and_pre_pass"),
             k2_alone_bound_ms=tfb["K2t_alone"][0] if tfb else None),
        dict(name="K3 render_deferred (G-buffer; max_abs_err is the largest of "
                  "S, uv and the footprint's relative error, phases 7 and 21; ms: the "
                  "wrapper between CUDA events, its pre-pass then K3, whose camera walk "
                  "reads the pre-pass's tables; bound_ms: the two kernels' work, the camera "
                  "walk at its relative costs; k3_device_ms, k3_and_pre_pass_device_ms: "
                  "torch.profiler, the L2 flushed before each call; k3_alone_bound_ms: K3's "
                  "own work; once per shard of a sharded textured frame, phase 25)",
             route="cuda", source="gpu_raytracer_tpu_torch/csrc/render_deferred.cu",
             replaces="gpu_raytracer_tpu/ops/pallas/render.py:787",
             launches=k3_launches, max_abs_err=k3_err, ms=k3["ms"], plain_ms=k3["plain_ms"],
             **bound(tfb.get("K3")), library_ms=None, k3_device_ms=k3.get("k3_device_ms"),
             k3_and_pre_pass_device_ms=k3.get("k3_and_pre_pass_device_ms"),
             k3_alone_bound_ms=tfb["K3_alone"][0] if tfb else None),
        dict(name="K3 pre-pass camera_relative (the camera-relative node and triangle tables "
                  "the camera walks of K3 and of K2 w8 / K2t w8 read, one launch before each "
                  "K3 launch of either width and each width-8 K2 / K2t launch; "
                  "held to its plain version bit for bit at widths 4 and 8, phases 7b and "
                  "22; ms: device time, the L2 flushed, plain_ms and the bound on the "
                  "textured 100k courtyard)", route="cuda",
             source="gpu_raytracer_tpu_torch/csrc/camera_relative.cu",
             replaces="gpu_raytracer_tpu/ops/pallas/render.py:787",
             launches=k3_pre_launches, max_abs_err=max(k3_pre["max_abs_err"], w8e["k3_pre"]),
             ms=k3_pre.get("device_ms"), plain_ms=k3_pre["plain_ms"],
             bound_ms=k3_pre["bound_ms"], bound_by=k3_pre["bound_by"], library_ms=None),
        dict(name="K4 texture_shade (ms: the kernel's device time, torch.profiler, the L2 "
                  "flushed before each call; between CUDA events around one call it reads "
                  "the wrapper's host time; once per shard of a sharded textured frame, "
                  "phase 25)", route="cuda",
             source="gpu_raytracer_tpu_torch/csrc/texshade.cu",
             replaces="gpu_raytracer_tpu/ops/pallas/texshade.py:463",
             launches=k4_launches,
             max_abs_err=max(max(k4["max_abs_diff"].values()),
                             vr["textured_scaled_refit"]["max_abs_err"]),
             ms=k4["device_ms"], plain_ms=k4["plain_ms"], **bound(tfb.get("K4")),
             library_ms=None),
        dict(name="K5 sample_material (device function inside K6's textured launches, "
                  "launched alone for the G-buffer's albedo, phases 18-19; "
                  "ms (device time, torch.profiler, the L2 flushed before each call), "
                  "plain_ms and the bound from its "
                  "standalone launch on the textured courtyard's camera hits, "
                  "csrc/materials.cu)", route="cuda",
             source="gpu_raytracer_tpu_torch/csrc/texsample.cuh",
             replaces="gpu_raytracer_tpu/ops/pallas/texshade.py:506",
             launches=k5_launches + k5_standalone,
             max_abs_err=max(max(k5["max_abs_diff"].values()), gd["gbuffer"]["albedo_abs"]),
             ms=k5["device_ms"], plain_ms=k5["plain_ms"], bound_ms=k5.get("bound_ms"),
             bound_by=k5.get("bound_by"), library_ms=None),
        dict(name=f"K6 bounce ({MAX_DEPTH + 1} launches per sample; ms (kernel device time, "
                  f"torch.profiler), plain_ms and the bound are per sample of the untextured "
                  f"courtyard at {pt_size}^2; five per shard of a sharded step, phase 25)",
             route="cuda", source="gpu_raytracer_tpu_torch/csrc/bounce.cuh",
             replaces="gpu_raytracer_tpu/ops/pallas/bounce.py:505",
             launches=k6_launches,
             max_abs_err=max(v["max_abs_err"] for v in list(k6.values()) + list(k6t.values())),
             ms=ptc["profile"].get("k6_device_ms"), plain_ms=ptc["k6_plain_ms_per_spp"],
             bound_ms=kb.get("bound_ms"), bound_by=kb.get("bound_by"), library_ms=None),
    ]
    a3 = atrous[f"passes_{FLY_ITERS}"]
    kernels.append(dict(
        name=f"Filter atrous (no TPU kernel: the JAX package's filter is plain JAX; a prepare "
             f"launch and one a pass, torch.sort between; launches: phases 18, 19, 23 and "
             f"23b; ms: device time of a {FLY_ITERS}-pass call at {pt_size}^2, the L2 flushed "
             f"before each, phase 18b; plain_ms: the plain version on the card, events; "
             f"plain_device_ms: its kernels' device time)",
        route="cuda", source="gpu_raytracer_tpu_torch/csrc/atrous.cu", replaces=None,
        launches=denoise_launches,
        max_abs_err=max([gd["denoise"]["max_abs_diff_to_cpu"]]
                        + [v["max_abs_diff_to_plain"] for v in atrous.values()
                           if isinstance(v, dict)]),
        ms=a3.get("device_ms"), plain_ms=a3["plain_ms"], bound_ms=a3["bound_ms"],
        bound_by=a3["bound_by"], library_ms=None, plain_device_ms=a3.get("plain_device_ms")))
    kernels.append(dict(
        name="K1 unordered traverse_threaded (the stackless walk over the binary tree's "
             "threaded hit / miss links, one ray per thread; no entry point calls it, as in "
             "the JAX package: launches 0 on the main path; held to the plain threaded walk "
             "bit for bit, phase 24; ms, plain_ms and the bound on the 1080p camera rays, "
             "closest hit; the bound from the plain walk's node visits and triangle tests; "
             "device_ms: torch.profiler, the L2 flushed before each call, camera rays and "
             "any-hit shadow rays)",
        route="cuda", source="gpu_raytracer_tpu_torch/csrc/traverse_threaded.cu",
        replaces="gpu_raytracer_tpu/ops/pallas/traverse.py:690", launches=0,
        max_abs_err=max(thr["camera"]["max_abs_err"], thr["shadow"]["max_abs_err"]),
        ms=thr["ms"], plain_ms=thr["plain_ms"], bound_ms=thr["bound_ms"],
        bound_by=thr["bound_by"], library_ms=None, device_ms=thr["device_ms"]))
    w8pt = w8["pathtracer"]["courtyard"]
    bound8 = lambda key, kernel: bound(w8b.get(key, {}).get(kernel))
    mean = lambda xs: sum(xs) / len(xs)
    w8_note = "width-8 instance (config.bvh_width=8, phase 22, 100k courtyard); plain_ms: "
    kernels += [
        dict(name="K1 bvh8_traverse (the width-8 walk, a device function in every width-8 K2, "
                  "K2t, K3 and K6 launch, whose launches it counts; " + w8_note + "phase 3's "
                  "plain walk, the same binary tree and slots; ms on the 1080p camera rays; "
                  "any_hit_ms: the any-hit walk on phase 3's shadow rays of each light)",
             route="cuda", source="gpu_raytracer_tpu_torch/csrc/traverse_w8.cu",
             replaces="gpu_raytracer_tpu/ops/pallas/traverse.py:476",
             launches=w8l["k2_w8"] + w8l["k2t_w8"] + w8l["k3_w8"] + w8l["k6_w8"],
             max_abs_err=w8e["k1"], ms=w8["k1"]["ms"], plain_ms=w8["k1"]["plain_ms"],
             **bound8("w8", "K1"), library_ms=None,
             any_hit_ms={k: v["ms"] for k, v in w8["k1"]["any_hit"].items()}),
        dict(name="K2 render_primary, " + w8_note + "phase 5's, the same binary tree and "
                  "slots; ms: Renderer.render_device() at 1080p, shadows off (K3's pre-pass, "
                  "then K2 w8, whose camera walk reads its tables); bound_ms: the two "
                  "kernels' work, the camera walk at its relative costs; k2_device_ms, "
                  "k2_and_pre_pass_device_ms: torch.profiler, the L2 flushed before each "
                  "call; k2_alone_bound_ms: K2 w8's own work; max_abs_err also after a camera "
                  "move, outside counted order ties",
             route="cuda", source="gpu_raytracer_tpu_torch/csrc/render_primary_w8.cu",
             replaces="gpu_raytracer_tpu/ops/pallas/render.py:701", launches=w8l["k2_w8"],
             max_abs_err=w8e["k2"], ms=w8["k2"]["no_shadows"]["ms"],
             plain_ms=main["no_shadows"]["plain_ms"], **bound8("w8", "K2"), library_ms=None,
             k2_device_ms=w8.get("k2_device_ms", {}).get("no_shadows"),
             k2_and_pre_pass_device_ms=w8.get("k2_device_ms", {}).get("no_shadows_and_pre_pass"),
             k2_alone_bound_ms=w8b.get("w8", {}).get("K2_alone", (None,))[0]),
        dict(name="K2t render_primary_textured, " + w8_note + "phase 15's on the GLB courtyard "
                  "(frame equal to the procedural one); ms on the textured courtyard, "
                  "shadows off (K3's pre-pass, then K2t w8); bound_ms, k2_device_ms, "
                  "k2_and_pre_pass_device_ms and k2_alone_bound_ms as K2 w8's",
             route="cuda",
             source="gpu_raytracer_tpu_torch/csrc/render_primary_textured_w8.cu",
             replaces="gpu_raytracer_tpu/ops/pallas/render.py:363", launches=w8l["k2t_w8"],
             max_abs_err=w8e["k2t"], ms=w8["k2t"]["no_shadows"]["ms"],
             plain_ms=k2t["textured_courtyard_no_shadows"]["plain_ms"],
             **bound8("w8_textured", "K2t"), library_ms=None,
             k2_device_ms=w8.get("k2t_device_ms", {}).get("no_shadows"),
             k2_and_pre_pass_device_ms=w8.get("k2t_device_ms", {}).get("no_shadows_and_pre_pass"),
             k2_alone_bound_ms=w8b.get("w8_textured", {}).get("K2t_alone", (None,))[0]),
        dict(name="K3 render_deferred, " + w8_note + "phase 7's, the same binary tree and "
                  "slots; ms: render_deferred at 1080p, shadows off (its pre-pass then K3); "
                  "bound_ms, k3_device_ms, k3_and_pre_pass_device_ms and k3_alone_bound_ms "
                  "as K3's", route="cuda",
             source="gpu_raytracer_tpu_torch/csrc/render_deferred_w8.cu",
             replaces="gpu_raytracer_tpu/ops/pallas/render.py:787", launches=w8l["k3_w8"],
             max_abs_err=w8e["k3"], ms=mean(w8["k3"]["w4_w8_ms"]["w8"]), plain_ms=k3["plain_ms"],
             **bound8("w8_textured", "K3"), library_ms=None,
             k3_device_ms=w8["k3"].get("device_ms"),
             k3_and_pre_pass_device_ms=w8["k3"].get("and_pre_pass_device_ms"),
             k3_alone_bound_ms=w8b.get("w8_textured", {}).get("K3_alone", (None,))[0]),
        dict(name="K6 bounce, " + w8_note + "phase 12's per sample on the same tree and slots; "
                  f"ms: kernel device time per sample at {pt_size}^2 (torch.profiler)",
             route="cuda", source="gpu_raytracer_tpu_torch/csrc/bounce_w8.cu",
             replaces="gpu_raytracer_tpu/ops/pallas/bounce.py:505", launches=w8l["k6_w8"],
             max_abs_err=w8e["k6"],
             ms=mean(w8pt["k6_device_ms_per_spp"]["w8"]) if cuda else None,
             plain_ms=ptc["k6_plain_ms_per_spp"],
             bound_ms=(w8pt.get("k6_bound") or {}).get("bound_ms"),
             bound_by=(w8pt.get("k6_bound") or {}).get("bound_by"), library_ms=None),
    ]
    log(f"bounds 1080p: {json.dumps(dict(untextured=fb, textured=tfb))}")
    log(f"profiler sessions per kernel_device_ms call: {json.dumps(PROFILER_SESSIONS)}")
    log(f"seconds per phase (to its line from the one before): {json.dumps(PHASE_SECONDS)}")
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "gpu_raytracer_tpu_torch")):
        print("chip_smoke.py: gpu_raytracer_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is false; this smoke run needs "
              "a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    card = card_line()
    log(f"phase 0 card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from gpu_raytracer_tpu_torch.ops.cuda.build import load_kernels

    k = load_kernels()
    info = dict(nvcc_s=k.seconds, library=os.path.relpath(k.path, ROOT),
                ptxas=ptxas_summary(k.log))
    log(f"phase 1 build: {json.dumps(info)}")
    device = torch.device("cuda", 0)
    from gpu_raytracer_tpu_torch.utils.procgen import CACHE_ENV

    # the run's texture cache lives and dies with it (phase 23d times its own)
    with tempfile.TemporaryDirectory() as cache:
        os.environ[CACHE_ENV] = cache
        run(device, WIDTH, HEIGHT, TRIANGLES, SHADOW_RAYS, card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
