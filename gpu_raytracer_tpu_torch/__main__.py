"""Command-line application: the `render`, `pathtrace`, `fly`, `serve`,
`window`, `export` and `info` subcommands.

    python -m gpu_raytracer_tpu_torch render \
        [--demo | --courtyard N [--textured] | --gltf FILE] \
        [--width W --height H] [--shadows] [--device cuda|cpu] -o out.png
    python -m gpu_raytracer_tpu_torch pathtrace [scene flags] [--spp N] [--spectral] \
        [--no-shadows] [--seed S] [--sampler qmc|rng] [--adaptive K] \
        [--denoise [--denoise-iters N]] [--checkpoint F] [--resume F] \
        [--linear] [--device cuda|cpu] -o out.png
    python -m gpu_raytracer_tpu_torch fly [scene flags] [--script "w w d mouse:40,0 w"] \
        [--frames-per-step N] [--shadows] [--pathtrace] [--device cuda|cpu] -o frames_dir
    python -m gpu_raytracer_tpu_torch serve [--demo | --courtyard N [--textured] | --gltf FILE] \
        [--width W --height H] [--shadows] [--host H --port P] [--max-fps F] [--device cuda|cpu]
    python -m gpu_raytracer_tpu_torch window [scene flags] [--width W --height H] [--shadows] \
        [--max-fps F] [--device cuda|cpu]
    python -m gpu_raytracer_tpu_torch export [scene flags] -o out.glb
    python -m gpu_raytracer_tpu_torch info --gltf FILE [--scene-index I]

`fly` drives the Viewer through a script of keys (w/a/s/d/space/l/p/n/t/i)
and mouse drags (mouse:dx,dy) and writes the frame after each step as
frame_0000.png, ... in the output directory; `--pathtrace` path-traces the
flight with temporal reprojection and the denoised preview. `serve` is the
interactive Viewer over HTTP (engine/server.py: open http://HOST:PORT/),
`window` the same in a Tk window (engine/window.py; it exits with 1 where no
display server can be reached). Both render their first frame, which builds
the CUDA kernels, before they take input.

`--gltf` loads a .gltf or .glb file; a file that does not load gives the
default scene and a message saying why. `export` writes the chosen scene as
a self-contained binary glTF; `info` lists what a glTF file holds. Neither
needs a device.

`--device cuda` (the default) renders through the CUDA kernels and fails
without a CUDA device; `--device cpu` renders through the plain PyTorch path.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from .config import RaytracerConfig, add_config_args, config_from_args


def _load_scene(args, config, device):
    from .models.scene import build_default_scene

    if args.gltf:
        from .models.gltf import scene_from_gltf_or_default

        return scene_from_gltf_or_default(args.gltf, config=config, device=device)
    if args.courtyard:
        from .utils.procgen import make_courtyard_scene

        return make_courtyard_scene(args.courtyard, seed=0, config=config,
                                    textured=args.textured, device=device)
    return build_default_scene(config, device=device)


def cmd_render(args, config):
    from .engine.renderer import Renderer
    from .models.bvh_native import load_builder
    from .utils.image import write_png

    device = torch.device(args.device)
    t0 = time.perf_counter()
    scene = _load_scene(args, config, "cpu")
    print(f"scene: {scene.num_triangles} triangles, {scene.bvh.num_nodes} BVH nodes "
          f"({time.perf_counter() - t0:.2f} s build, {load_builder().origin} BVH builder)")
    r = Renderer(scene, args.width, args.height, config=config, shadows=args.shadows,
                 device=device)
    if device.type == "cuda":
        from .ops.cuda.build import load_kernels

        k = load_kernels()
        print(f"kernels: {k.path} ({k.seconds:.1f} s nvcc)" if k.seconds else
              f"kernels: {k.path} (built before)")
    t0 = time.perf_counter()
    fb = r.render_device()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    rays = args.width * args.height * 3
    print(f"first frame on {device}: {dt * 1e3:.1f} ms ({rays / dt / 1e6:.1f} Mrays/s "
          f"ray-equivalent; a cold frame, not a benchmark)")
    write_png(args.output, r.to_image(fb.cpu().numpy()))
    print(f"wrote {args.output}")


def cmd_pathtrace(args, config):
    from .engine.pathtracer import PathTracer
    from .utils.image import write_png

    device = torch.device(args.device)
    scene = _load_scene(args, config, "cpu")
    kw = dict(config=config, spectral=args.spectral, shadows=not args.no_shadows,
              seed=args.seed, device=device)
    if args.adaptive:
        from .engine.adaptive import AdaptivePathTracer

        pt = AdaptivePathTracer(scene, args.width, args.height, tiles_per_step=args.adaptive,
                                **kw)
    else:
        pt = PathTracer(scene, args.width, args.height, sampler=args.sampler, **kw)
    if args.resume and os.path.exists(args.resume):
        pt.load_checkpoint(args.resume)
        print(f"resumed at {pt.samples} spp")
    img = pt.render(args.spp, progress=True)
    if args.checkpoint:
        pt.save_checkpoint(args.checkpoint)
        print(f"checkpoint -> {args.checkpoint}")
    if args.denoise:
        img = pt.denoised_image(iterations=args.denoise_iters)
        print(f"denoised ({args.denoise_iters} a-trous iterations)")
    write_png(args.output, img, srgb=not args.linear)
    print(f"wrote {args.output} ({pt.samples} spp)")


def cmd_fly(args, config):
    from .engine.viewer import Viewer
    from .utils.image import write_png

    scene = _load_scene(args, config, "cpu")
    v = Viewer(scene, args.width, args.height, config=config, shadows=args.shadows,
               device=torch.device(args.device))
    if args.pathtrace:
        v.handle_key("p")
    os.makedirs(args.output, exist_ok=True)
    script = []
    for tok in args.script.split():
        if tok.startswith("mouse:"):
            dx, dy = tok[6:].split(",")
            script.append(("mouse", float(dx), float(dy)))
        else:
            script.append(("key", tok))
    frames = v.fly_through(script, frames_per_step=args.frames_per_step)
    for i, f in enumerate(frames):
        write_png(os.path.join(args.output, f"frame_{i:04d}.png"), f)
    print(f"wrote {len(frames)} frames to {args.output}/")


def _interactive_viewer(args, config):
    """The Viewer of `serve` and `window`, its first frame rendered (and on
    CUDA finished), so the kernels are built before any input arrives."""
    from .engine.viewer import Viewer

    device = torch.device(args.device)
    scene = _load_scene(args, config, "cpu")
    v = Viewer(scene, args.width, args.height, config=config, shadows=args.shadows,
               device=device)
    v.run_compute()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return v


def cmd_serve(args, config):
    from .engine.server import ViewerServer

    v = _interactive_viewer(args, config)
    ViewerServer(v, host=args.host, port=args.port, max_fps=args.max_fps).serve_forever()


def cmd_window(args, config):
    from .engine.window import NativeWindow, window_available

    if not window_available():
        print("error: no display server reachable (Tk root failed); "
              "use `serve` for the HTTP live viewer on headless hosts", file=sys.stderr)
        raise SystemExit(1)
    NativeWindow(_interactive_viewer(args, config), max_fps=args.max_fps).run()


def cmd_info(args, config):
    from .models.gltf import GltfError, GltfLoader

    try:
        loader = GltfLoader.load_from_path(args.gltf)
    except GltfError as e:   # a clean error, not a traceback
        print(f"error: {e}", file=sys.stderr)
        raise SystemExit(1)
    print("scenes: ", loader.list_scenes())
    print("cameras:", loader.list_cameras())
    print("lights: ", loader.list_lights())
    loaded = loader.extract_scene(args.scene_index)
    print(f"triangles={loaded.triangles.shape[0]} vertices={loaded.vertices.shape[0]} "
          f"materials={len(loaded.materials)} lights={len(loaded.lights)} "
          f"images={len(loaded.images)}")


def cmd_export(args, config):
    """Scene -> .glb through models/gltf_export.py: the demo and courtyard
    scenes, or a loaded glTF re-packed, as a self-contained binary asset."""
    from .models.gltf_export import export_glb

    scene = _load_scene(args, config, "cpu")
    images = wraps = None
    if args.courtyard and args.textured:
        from .utils.procgen import courtyard_source_images

        images = courtyard_source_images(0)
    elif args.gltf:
        from .models.gltf import load_gltf

        loaded = load_gltf(args.gltf)
        if loaded.images:
            # one image per texture, alignment kept: a dangling source index
            # gets the white placeholder, so no later texture shifts
            images = [loaded.images[i] if i < len(loaded.images)
                      else np.full((1, 1, 4), 255, np.uint8) for i in loaded.texture_image]
            wraps = [loaded.texture_wrap[t] if t < len(loaded.texture_wrap) else 0
                     for t in range(len(loaded.texture_image))]
    export_glb(scene, args.output, images=images, texture_wrap=wraps)
    print(f"wrote {args.output} ({os.path.getsize(args.output)} bytes, "
          f"{scene.num_triangles} triangles)")


def _add_scene_args(p, device: bool = True):
    p.add_argument("--gltf", type=str, default=None, help="glTF/GLB scene file")
    p.add_argument("--demo", action="store_true", help="built-in demo scene (default)")
    p.add_argument("--courtyard", type=int, default=0, metavar="TRIS",
                   help="procedural courtyard with ~TRIS triangles")
    p.add_argument("--textured", action="store_true",
                   help="courtyard variant with procedural texture atlases")
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("-o", "--output", type=str, default="out.png")
    if device:
        p.add_argument("--device", type=str, default="cuda",
                       help="cuda (the CUDA kernels) or cpu (the plain PyTorch path)")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="gpu_raytracer_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("render", help="single-frame Whitted render")
    _add_scene_args(p)
    p.add_argument("--shadows", action="store_true")
    add_config_args(p)
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("pathtrace", help="progressive path tracing")
    _add_scene_args(p)
    p.add_argument("--spp", type=int, default=16)
    p.add_argument("--spectral", action="store_true",
                   help="full-RGB rays that split to one wavelength at dispersive glass")
    p.add_argument("--no-shadows", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--linear", action="store_true",
                   help="write raw linear u8 instead of the default sRGB display encode")
    p.add_argument("--denoise", action="store_true",
                   help="edge-avoiding a-trous reconstruction filter")
    p.add_argument("--denoise-iters", type=int, default=4)
    p.add_argument("--sampler", choices=("qmc", "rng"), default="qmc",
                   help="qmc: low-discrepancy lattice sampling; rng: independent "
                        "torch.Generator streams")
    p.add_argument("--adaptive", type=int, default=0, metavar="K",
                   help="variance-weighted sampling: each step refines the K highest-error "
                        "64x64 tiles (0 = uniform; --spp then counts steps, average spp = "
                        "spp*K/tiles)")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--resume", type=str, default=None)
    add_config_args(p)
    p.set_defaults(fn=cmd_pathtrace)
    p = sub.add_parser("fly", help="scripted interactive fly-through")
    _add_scene_args(p)
    p.add_argument("--script", type=str, default="w w d mouse:40,0 w",
                   help="space-separated keys (w/a/s/d/space/l) and mouse:dx,dy")
    p.add_argument("--frames-per-step", type=int, default=1)
    p.add_argument("--shadows", action="store_true")
    p.add_argument("--pathtrace", action="store_true",
                   help="path-traced fly-through: temporal reprojection carries the "
                        "accumulation across camera moves, frames-per-step samples at each "
                        "stop, young frames present denoised")
    add_config_args(p)
    p.set_defaults(fn=cmd_fly, output="frames")

    for name, help_, max_fps in (("serve", "live viewer over HTTP (browser WASD)", 30.0),
                                 ("window", "native OS-window viewer (Tk present)", 120.0)):
        p = sub.add_parser(name, help=help_)
        p.add_argument("--gltf", type=str, default=None, help="glTF/GLB scene file")
        p.add_argument("--demo", action="store_true", help="built-in demo scene (default)")
        p.add_argument("--courtyard", type=int, default=0, metavar="TRIS",
                       help="procedural courtyard with ~TRIS triangles")
        p.add_argument("--textured", action="store_true",
                       help="with --courtyard: procedural texture atlases")
        p.add_argument("--width", type=int, default=640)
        p.add_argument("--height", type=int, default=360)
        p.add_argument("--shadows", action="store_true")
        if name == "serve":
            p.add_argument("--host", type=str, default="127.0.0.1")
            p.add_argument("--port", type=int, default=8642)
        p.add_argument("--max-fps", type=float, default=max_fps)
        p.add_argument("--device", type=str, default="cuda",
                       help="cuda (the CUDA kernels) or cpu (the plain PyTorch path)")
        p.set_defaults(fn=cmd_serve if name == "serve" else cmd_window)

    p = sub.add_parser("export", help="write a scene as a binary glTF (.glb)")
    _add_scene_args(p, device=False)
    p.set_defaults(fn=cmd_export, output="out.glb")

    p = sub.add_parser("info", help="inspect a glTF file")
    p.add_argument("--gltf", type=str, required=True)
    p.add_argument("--scene-index", type=int, default=None)
    p.set_defaults(fn=cmd_info)

    args = parser.parse_args(argv)
    config = config_from_args(args) if hasattr(args, "tile_size") else RaytracerConfig()
    args.fn(args, config)


if __name__ == "__main__":
    main()
