#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (gpu_raytracer_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one line of numbers each; any failure raises and exits non-zero:
  0. the card's name and power limit (nvidia-smi); a CUDA device is required;
  1. build the CUDA kernels from csrc/ with nvcc;
  2. build the 100k-triangle courtyard (host BVH build, tables to the card);
  3. K1 (BVH4 traversal) against the plain traversal on every camera ray of
     the 1920x1080 frame and on 262,144 shadow rays toward the point light;
  4. K2 (fused render) against the plain render_chunk on the full frame,
     shadows off and on, and on the default scene at 256x256;
  5. the main path, Renderer.render_device() at 1920x1080, timed with CUDA
     events, with the kernel launch counts of that run;
  6. build the textured 100k courtyard (4096-texel floor map, mips) and
     pack its tables to the card;
  7. K3 (deferred trace) against the plain G-buffer on the full frame,
     shadows off and on, and on a textured scene with spheres;
  8. K4 (texture shade) against the plain deferred shade on the phase-7
     G-buffer and on random G-buffers over a synthetic scene with every wrap
     mode, map slot and mip chains, nearest and trilinear;
  9. the textured main path, Renderer.render_device() at 1920x1080 (K3 then
     K4), timed, with the launch counts of that run.
The line before the last is the per-kernel JSON summary, the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WIDTH, HEIGHT = 1920, 1080
TRIANGLES = 100_000
TEXTURE_SIZE = 4096    # the textured courtyard's floor map edge (bench.py section 4)
SHADOW_RAYS = 262_144
TIE_BUDGET = 1e-4      # tie pixels allowed, as a share of the frame
RGB_TOL = 1e-5         # max |diff| against the plain version outside ties
T_REL_TOL = 1e-6       # K1 hit distance, relative
GBUF_TOL = 1e-5        # K3 light sum and uv, absolute; mip footprint, relative
FRAMES = 8             # timed frames of the kernel path
PLAIN_FRAMES = 3       # timed frames of the plain path (seconds each)


def log(msg: str) -> None:
    print(msg, flush=True)


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
        m = re.search(r"Compiling entry function '\S*?(traverse_kernel|render_primary_kernel|"
                      r"render_deferred_kernel|texshade_kernel)(?:ILi(\d+)E(?:Lb(\d))?)?", line)
        if m:
            name = m.group(1)
            if m.group(2):
                name += f"<{m.group(2)}{', any_hit' if m.group(3) == '1' else ''}>"
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


def primary_rays(scene, width, height, px, py):
    from gpu_raytracer_tpu_torch.ops.camera_rays import generate_rays

    o, d = generate_rays(scene.camera, width, height, px, py)
    return o.contiguous(), d.contiguous()


def k1_compare(tables, o, d, max_t):
    """Closest hit through K1 and the plain traversal -> (stats, tie mask)."""
    import torch

    from gpu_raytracer_tpu_torch.ops.cuda.traverse import traverse
    from gpu_raytracer_tpu_torch.ops.trace import traverse_triangles

    kt, ks, kh, kn, km = traverse(tables, o, d, max_t)
    pt, ps, ph, pn, pm = traverse_triangles(tables.scene, o, d, max_t)
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


def phase_k1(scene, tables, width, height, n_shadow, device, card):
    """K1 against the plain traversal on every camera ray of the frame (in
    the main path's tile-major order) and on n_shadow shadow rays from
    those hits toward the point light -> (stats, per-pixel tie mask)."""
    import numpy as np
    import torch

    from gpu_raytracer_tpu_torch.engine.renderer import tiled_pixel_order
    from gpu_raytracer_tpu_torch.ops.cuda.traverse import traverse
    from gpu_raytracer_tpu_torch.ops.linalg import dot
    from gpu_raytracer_tpu_torch.ops.trace import traverse_triangles

    px, py = (torch.from_numpy(a).to(device) for a in tiled_pixel_order(width, height))
    o, d = primary_rays(scene, width, height, px, py)
    far = torch.full((px.shape[0],), 3.4028234663852886e38, device=device)
    prim, ties = k1_compare(tables, o, d, far)

    t, _, h, n, _ = traverse_triangles(scene, o, d, far)
    hits = torch.nonzero(h).squeeze(1).cpu().numpy()
    pick = np.sort(np.random.default_rng(0).choice(hits, min(n_shadow, hits.shape[0]),
                                                   replace=False))
    pick = torch.from_numpy(pick).to(device)
    L = scene.lights
    li = int(torch.nonzero(L.light_type == 1)[0])
    p = o[pick] + d[pick] * t[pick, None]
    so = (p + n[pick] * 1e-3).contiguous()
    to_light = L.position[li][None, :] - p
    dist = torch.sqrt(dot(to_light, to_light))
    sd = (to_light / dist[:, None]).contiguous()
    smax = (dist - 1e-3).contiguous()
    shadow, _ = k1_compare(tables, so, sd, torch.full_like(smax, 3.4028234663852886e38))
    blocked = traverse(tables, so, sd, smax, any_hit=True)[2]
    closest = traverse_triangles(scene, so, sd, smax)[2]
    if not torch.equal(blocked, closest):
        raise AssertionError(f"K1 any-hit differs from closest t < max_t on "
                             f"{(blocked != closest).sum().item()} shadow rays")
    plain_anyhit = traverse_triangles(scene, so, sd, smax, any_hit=True)[2]
    if not torch.equal(blocked, plain_anyhit):
        raise AssertionError("K1 any-hit differs from the plain any-hit")
    ms = timed(lambda: traverse(tables, o, d, far), FRAMES, device)
    plain_ms = timed(lambda: traverse_triangles(scene, o, d, far), PLAIN_FRAMES, device)
    stats = dict(primary=prim, shadow=shadow, shadow_blocked=int(blocked.sum()),
                 ms=ms, plain_ms=plain_ms, card=card)
    log(f"phase 3 K1: {json.dumps(stats)}")
    return stats, ties


def k2_compare(scene, width, height, shadows, device, ties=None):
    import torch

    from gpu_raytracer_tpu_torch.engine.renderer import Renderer, render_chunk

    r = Renderer(scene, width, height, shadows=shadows, device=device)
    got = r.render_device()
    ref = render_chunk(r.scene, r.px, r.py, width, height, shadows=shadows)
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

    from gpu_raytracer_tpu_torch.engine.renderer import Renderer, render_chunk
    from gpu_raytracer_tpu_torch.ops.cuda.render import render_primary
    from gpu_raytracer_tpu_torch.ops.cuda.traverse import traverse

    out = {}
    for shadows in (False, True):
        r = Renderer(scene, width, height, shadows=shadows, device=device)
        first = r.render_device()
        render_primary.launches = 0
        traverse.launches = 0
        ms = timed(r.render_device, FRAMES, device)
        k2, k1 = render_primary.launches, traverse.launches
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


def synthetic_textured_scene(seed: int = 0, n_mats: int = 6, mips: int = 1,
                             degenerate_glass: bool = False, device="cpu"):
    """The default scene's geometry (spheres and triangles) with n_mats
    random materials over three random RGBA8 textures, one per wrap mode:
    every second material has a base-colour map, every third metallic-
    roughness, occlusion and emissive maps. With mips=1 it is, draw for
    draw, the JAX package's texture-shade test scene
    (tests/test_texshade.py::_textured_scene)."""
    import numpy as np

    from gpu_raytracer_tpu_torch.models.geometry import Textures
    from gpu_raytracer_tpu_torch.models.material import MaterialBuilder
    from gpu_raytracer_tpu_torch.models.scene import build_default_scene, prepare_scene

    rng = np.random.default_rng(seed)
    mb = MaterialBuilder()
    imgs = [rng.integers(0, 256, size=(5 + 3 * i, 9 + 11 * i, 4), dtype=np.uint8)
            for i in range(3)]
    for i in range(n_mats):
        ti = np.full(8, 0xFFFFFFFF, np.uint32)
        if i % 2 == 0:
            ti[0] = i % 3
        if i % 3 == 0:
            ti[1] = (i + 1) % 3
            ti[3] = (i + 2) % 3
            ti[4] = i % 3
        ior = 1.0 + 0.5 * (i % 3)
        trans = 0.5 * (i % 2)
        if not degenerate_glass and trans > 0.0 and ior == 1.0:
            ior = 1.3   # ior 1 with transmission is 0/0 in the dispersion blend
        mb.add(albedo=rng.uniform(0.2, 1.0, 3), metallic=float(i % 2), roughness=0.5,
               emission=rng.uniform(0, 0.3, 3), ior=ior, transmission=trans,
               texture_indices=ti)
    tex = Textures.from_images(imgs, wrap=[0, 1, 2], mips=mips)
    base = build_default_scene()
    return prepare_scene(base.camera, base.spheres, base.mesh, mb.build(), base.lights,
                         textures=tex, device=device)


def random_gbuffer(rng, n: int, n_mats: int, mips: bool = False):
    """[n,8] f32 G-buffer of random rays: light sums in [0, 3), material ids
    from -1 (a miss) to n_mats + 1 (invalid), uvs in [-1.5, 2.5) (every wrap
    period), mip footprints 0 or (mips) from 2^-10 to 1."""
    import numpy as np

    light = rng.uniform(0, 3, (n, 3)).astype(np.float32)
    mat = rng.integers(-1, n_mats + 2, n).astype(np.int32)
    uv = rng.uniform(-1.5, 2.5, (n, 2)).astype(np.float32)
    lam = (np.exp2(rng.uniform(-10.0, 0.0, n)) if mips else np.zeros(n)).astype(np.float32)
    return np.concatenate([light, mat.view(np.float32)[:, None], uv, lam[:, None],
                           np.zeros((n, 1), np.float32)], axis=1)


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


def gbuffer_compare(tables, px, py, width, height, shadows, ties):
    """K3 against the plain G-buffer on the same pixels -> (stats, K3's
    G-buffer)."""
    import torch

    from gpu_raytracer_tpu_torch.engine.renderer import render_gbuffer, split_gbuffer
    from gpu_raytracer_tpu_torch.ops.cuda.render import render_deferred

    got = render_deferred(tables, px, py, width, height, shadows=shadows)
    ref = render_gbuffer(tables.scene, px, py, width, height, shadows=shadows)
    (gs, gm, guv, glam), (rs, rm, ruv, rlam) = split_gbuffer(got), split_gbuffer(ref)
    finite = all(bool(torch.isfinite(x).all()) for x in (gs, guv, glam))
    if got.shape != ref.shape or not finite:
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

    from gpu_raytracer_tpu_torch.engine.renderer import split_gbuffer
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
    if err > RGB_TOL:
        raise AssertionError(f"K4 max |diff| {err:.3g} > {RGB_TOL} (trilinear={trilinear})")
    return err


def mip_boundary_rays(shade, gbuf, rel: float = 1e-6) -> int:
    """Hits whose nearest mip level of some sampled map sits within `rel`
    of a level boundary (lam * w * sqrt2 near a power of two, judged in
    float64): there a one-ulp change of the hit distance picks the other
    level, so another evaluation order of the trace may differ there."""
    import torch

    from gpu_raytracer_tpu_torch.engine.renderer import split_gbuffer

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
    return int((near & hit).sum())


def primary_ties(tables, width, height, px, py):
    """Camera rays whose closest triangle K1 and the plain traversal pick
    differently at the exact same t."""
    import torch

    o, d = primary_rays(tables.scene, width, height, px, py)
    far = torch.full((px.shape[0],), 3.4028234663852886e38, device=px.device)
    return k1_compare(tables.trace, o, d, far)[1]


def phase_k3(scene, tables, width, height, device, card):
    """Phase 7: K3 against the plain G-buffer on the full frame, shadows off
    and on, and on the synthetic scene (live spheres, so sphere uvs)."""
    import torch

    from gpu_raytracer_tpu_torch.engine.renderer import render_gbuffer, tiled_pixel_order
    from gpu_raytracer_tpu_torch.ops.cuda.render import pack_render_tables, render_deferred

    px, py = (torch.from_numpy(a).to(device) for a in tiled_pixel_order(width, height))
    ties = primary_ties(tables, width, height, px, py)
    out, gbufs = {}, {}
    for shadows in (False, True):
        key = "courtyard_shadows" if shadows else "courtyard_no_shadows"
        out[key], gbufs[shadows] = gbuffer_compare(tables, px, py, width, height, shadows, ties)
    synth = synthetic_textured_scene(0, mips=4, device=device)
    st = pack_render_tables(synth)
    spx, spy = (torch.from_numpy(a).to(device) for a in tiled_pixel_order(256, 256))
    sties = primary_ties(st, 256, 256, spx, spy)
    for shadows in (False, True):
        key = f"synthetic_256_{'shadows' if shadows else 'no_shadows'}"
        out[key] = gbuffer_compare(st, spx, spy, 256, 256, shadows, sties)[0]
    out["ms"] = timed(lambda: render_deferred(tables, px, py, width, height), FRAMES, device)
    out["plain_ms"] = timed(lambda: render_gbuffer(scene, px, py, width, height),
                            PLAIN_FRAMES, device)
    out["card"] = card
    log(f"phase 7 K3 {width}x{height}: {json.dumps(out)}")
    return out, gbufs[False], ties


def phase_k4(shade, gbuf, ties, device, card):
    """Phase 8: K4 against the plain deferred shade on K3's full-frame
    G-buffer and on random G-buffers over the synthetic scene."""
    import numpy as np
    import torch

    from gpu_raytracer_tpu_torch.engine.renderer import split_gbuffer
    from gpu_raytracer_tpu_torch.ops.cuda.texshade import pack_shade_tables, texture_shade
    from gpu_raytracer_tpu_torch.ops.shading import shade_deferred

    sky = (0.1, 0.2, 0.3)
    near = mip_boundary_rays(shade, gbuf)
    if near > TIE_BUDGET * gbuf.shape[0]:
        raise AssertionError(f"{near} rays on a mip level boundary > {TIE_BUDGET:.2%}")
    err = {}
    for tri in (False, True):
        err[f"courtyard_{'trilinear' if tri else 'nearest'}"] = shade_compare(
            shade, gbuf, sky, tri, keep=~ties)
    rng = np.random.default_rng(0)
    for mips in (1, 4):
        synth = pack_shade_tables(synthetic_textured_scene(0, mips=mips, device=device))
        g = torch.from_numpy(random_gbuffer(rng, 65_536, synth.scene.materials.count,
                                            mips=mips > 1)).to(device)
        for tri in (False, True):
            err[f"synthetic_mips{mips}_{'trilinear' if tri else 'nearest'}"] = shade_compare(
                synth, g, sky, tri)
    S, mat, uv, lam = split_gbuffer(gbuf)
    out = dict(max_abs_diff=err, mip_boundary_rays=near)
    out["ms"] = timed(lambda: texture_shade(shade, gbuf), FRAMES, device)
    out["plain_ms"] = timed(lambda: shade_deferred(shade.scene, S, mat, uv, lam=lam),
                            PLAIN_FRAMES, device)
    out["card"] = card
    log(f"phase 8 K4: {json.dumps(out)}")
    return out


def phase_textured_main(scene, width, height, device, card, ties):
    """Phase 9: the textured main path, Renderer.render_device() at full
    size (K3 then K4 on a CUDA device), warm, timed."""
    import torch

    from gpu_raytracer_tpu_torch.engine.renderer import Renderer, render_deferred_chunk
    from gpu_raytracer_tpu_torch.ops.cuda.render import render_deferred, render_primary
    from gpu_raytracer_tpu_torch.ops.cuda.texshade import texture_shade
    from gpu_raytracer_tpu_torch.ops.cuda.traverse import traverse

    out = {}
    for shadows in (False, True):
        r = Renderer(scene, width, height, shadows=shadows, device=device)
        first = r.render_device()
        for fn in (render_deferred, texture_shade, render_primary, traverse):
            fn.launches = 0
        ms = timed(r.render_device, FRAMES, device)
        k3, k4 = render_deferred.launches, texture_shade.launches
        k2, k1 = render_primary.launches, traverse.launches
        frame = r.render_device()
        if not torch.equal(frame, first) or not torch.isfinite(frame).all():
            raise AssertionError("textured frames differ between runs or are not finite")
        if frame.shape != (width * height, 3):
            raise AssertionError(f"textured frame shape {tuple(frame.shape)}")
        if device.type == "cuda" and (k3 < FRAMES or k4 < FRAMES or k2 or k1):
            raise AssertionError(f"textured path launched K3 {k3}, K4 {k4}, K2 {k2}, "
                                 f"K1 {k1} times in {FRAMES} frames")
        plain = lambda: render_deferred_chunk(r.scene, r.px, r.py, width, height,
                                              shadows=shadows, sky=r.sky)
        ref = plain()
        diff = (frame - ref).abs().amax(dim=1)
        err = diff[~ties].max().item()
        if err > RGB_TOL:
            raise AssertionError(f"textured frame max |diff| {err:.3g} outside ties")
        plain_ms = timed(plain, PLAIN_FRAMES, device)
        rays = width * height * 3
        out["shadows" if shadows else "no_shadows"] = dict(
            ms=ms, mrays_per_s=rays / (ms * 1e-3) / 1e6, plain_ms=plain_ms,
            plain_mrays_per_s=rays / (plain_ms * 1e-3) / 1e6, k3_launches=k3,
            k4_launches=k4, k2_launches=k2, k1_standalone_launches=k1, max_abs_err=err,
            err_with_ties=diff.max().item(), tie_pixels=int(ties.sum()),
            mean=frame.mean().item())
    out["card"] = card
    log(f"phase 9 textured main path {width}x{height}: {json.dumps(out)}")
    return out


def run(device, width, height, triangles, shadow_rays, card, texture_size=TEXTURE_SIZE):
    import torch

    from gpu_raytracer_tpu_torch.models.bvh_native import load_builder
    from gpu_raytracer_tpu_torch.models.scene import build_default_scene
    from gpu_raytracer_tpu_torch.ops.cuda.render import pack_render_tables
    from gpu_raytracer_tpu_torch.utils.procgen import make_courtyard_scene

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

    k1, ties = phase_k1(scene, tables.trace, width, height, shadow_rays, device, card)
    k2 = {f"courtyard_{'shadows' if s else 'no_shadows'}":
          k2_compare(scene, width, height, s, device, ties) for s in (False, True)}
    demo = build_default_scene(device=device)
    k2.update({f"default_256_{'shadows' if s else 'no_shadows'}":
               k2_compare(demo, 256, 256, s, device) for s in (False, True)})
    log(f"phase 4 K2: {json.dumps(k2)}")

    main = phase_main(scene, width, height, device, card)
    k2_err = max(v["err"] for v in k2.values())
    k2_launches = main["no_shadows"]["k2_launches"] + main["shadows"]["k2_launches"]

    tscene, ttables, tshade = phase_textured_scene(device, triangles, texture_size)
    k3, gbuf, ties = phase_k3(tscene, ttables, width, height, device, card)
    k4 = phase_k4(tshade, gbuf, ties, device, card)
    tmain = phase_textured_main(tscene, width, height, device, card, ties)
    k3_launches = tmain["no_shadows"]["k3_launches"] + tmain["shadows"]["k3_launches"]
    k4_launches = tmain["no_shadows"]["k4_launches"] + tmain["shadows"]["k4_launches"]
    k3_err = max(v[e] for v in k3.values() if isinstance(v, dict)
                 for e in ("S", "uv", "lam_rel"))
    kernels = [
        dict(name="K1 bvh4_traverse (device function run by every K2 and K3 launch; "
                  "standalone kernel checked in phase 3)",
             route="cuda", source="gpu_raytracer_tpu_torch/csrc/traverse.cu",
             replaces="gpu_raytracer_tpu/ops/pallas/traverse.py:851",
             launches=k2_launches + k3_launches,
             max_abs_err=max(k1["primary"]["t_abs"], k1["primary"]["normal_abs"],
                             k1["shadow"]["t_abs"], k1["shadow"]["normal_abs"]),
             ms=k1["ms"], plain_ms=k1["plain_ms"]),
        dict(name="K2 render_primary", route="cuda",
             source="gpu_raytracer_tpu_torch/csrc/render_primary.cu",
             replaces="gpu_raytracer_tpu/ops/pallas/render.py:701",
             launches=k2_launches, max_abs_err=k2_err,
             ms=main["no_shadows"]["ms"], plain_ms=main["no_shadows"]["plain_ms"]),
        dict(name="K3 render_deferred (G-buffer; max_abs_err is the largest of "
                  "S, uv and the footprint's relative error)", route="cuda",
             source="gpu_raytracer_tpu_torch/csrc/render_deferred.cu",
             replaces="gpu_raytracer_tpu/ops/pallas/render.py:787",
             launches=k3_launches, max_abs_err=k3_err, ms=k3["ms"], plain_ms=k3["plain_ms"]),
        dict(name="K4 texture_shade", route="cuda",
             source="gpu_raytracer_tpu_torch/csrc/texshade.cu",
             replaces="gpu_raytracer_tpu/ops/pallas/texshade.py:463",
             launches=k4_launches,
             max_abs_err=max(k4["max_abs_diff"].values()),
             ms=k4["ms"], plain_ms=k4["plain_ms"]),
    ]
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
    run(device, WIDTH, HEIGHT, TRIANGLES, SHADOW_RAYS, card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
