"""The port never reaches for JAX, and its CUDA path never quietly carries on
without the device or the kernel."""

import ast
import dataclasses
import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_bridge  # noqa: F401  (thread cap)

from gpu_raytracer_tpu_torch.config import RaytracerConfig
from gpu_raytracer_tpu_torch.engine.renderer import Renderer
from gpu_raytracer_tpu_torch.models.light import LightBuilder
from gpu_raytracer_tpu_torch.models.scene import build_default_scene
from gpu_raytracer_tpu_torch.ops.cuda import build
from gpu_raytracer_tpu_torch.ops.cuda.render import pack_render_tables, render_primary
from gpu_raytracer_tpu_torch.ops.cuda.traverse import (ThreadedTables, TraceTables, traverse,
                                                      traverse_threaded)
from gpu_raytracer_tpu_torch.utils.procgen import make_courtyard_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_never_imports_jax():
    code = (
        "import sys\n"
        "import gpu_raytracer_tpu_torch\n"
        "from gpu_raytracer_tpu_torch.engine.renderer import Renderer\n"
        "from gpu_raytracer_tpu_torch.models.scene import build_default_scene\n"
        "from gpu_raytracer_tpu_torch.utils.procgen import make_courtyard_scene\n"
        "from gpu_raytracer_tpu_torch.engine.pathtracer import PathTracer\n"
        "from gpu_raytracer_tpu_torch.engine.adaptive import AdaptivePathTracer\n"
        "from gpu_raytracer_tpu_torch.ops.denoise import atrous_denoise\n"
        "from gpu_raytracer_tpu_torch.ops.cuda import bounce, build, render, texshade, traverse\n"
        "from gpu_raytracer_tpu_torch import bridge, __main__\n"
        "from gpu_raytracer_tpu_torch.models import gltf, gltf_export\n"
        "from gpu_raytracer_tpu_torch.utils import jpeg\n"
        "from gpu_raytracer_tpu_torch.utils.procgen import make_zoo_scene, zoo_source_images\n"
        "import os, tempfile\n"
        "zoo = make_zoo_scene(600, multi_slot=True)\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    gltf_export.export_glb(zoo, os.path.join(d, 'z.glb'), images=zoo_source_images(24))\n"
        "    back = gltf.scene_from_gltf(os.path.join(d, 'z.glb'))\n"
        "assert back.num_triangles == zoo.num_triangles and jpeg.scan_decoder() == 'native'\n"
        "assert Renderer(back, 16, 12, device='cpu').render().shape == (12, 16, 3)\n"
        "for textured in (False, True):\n"
        "    scene = make_courtyard_scene(500, textured=textured)\n"
        "    img = Renderer(scene, 16, 12, shadows=True, device='cpu').render()\n"
        "    assert img.shape == (12, 16, 3)\n"
        "    pt = PathTracer(scene, 16, 12, device='cpu')\n"
        "    pt.step()\n"
        "    assert pt.image().shape == (12, 16, 3) and pt.counters().rays_per_bounce[0] == 192\n"
        "    assert pt.fly_frame(scene.camera, m=4, u8=True).shape == (12, 16, 3)\n"
        "from gpu_raytracer_tpu_torch.engine.viewer import Viewer\n"
        "from gpu_raytracer_tpu_torch.engine import perf, progressive\n"
        "from gpu_raytracer_tpu_torch.models.scene import memory_stats, refit_scene\n"
        "from gpu_raytracer_tpu_torch.models.bvh import scene_tree, validate_bvh\n"
        "from gpu_raytracer_tpu_torch.ops import lbvh\n"
        "from gpu_raytracer_tpu_torch.utils import packing, yuv\n"
        "v = Viewer(make_courtyard_scene(500, textured=True), 16, 12, shadows=True,\n"
        "           verbose=False, device='cpu')\n"
        "v.render_to_completion()\n"
        "v.handle_key('p')\n"
        "v.run_compute()\n"
        "v.update_geometry(v.scene.mesh.vertices * 1.1)\n"
        "assert v.materialize_frame(v.present_frame_packed()).shape == (12, 16, 3)\n"
        "r = refit_scene(v.scene, v.scene.mesh.vertices, rebuild=True)\n"
        "validate_bvh(scene_tree(r), r.num_triangles)\n"
        "assert memory_stats(r)['triangles'] == r.num_triangles\n"
        "ada = AdaptivePathTracer(make_courtyard_scene(500), 64, 64, tiles_per_step=1,\n"
        "                         device='cpu')\n"
        "ada.step()\n"
        "assert ada.denoised_image(iterations=1).shape == (64, 64, 3)\n"
        "from gpu_raytracer_tpu_torch.engine import server, window\n"
        "from gpu_raytracer_tpu_torch.reference import cpu_tracer\n"
        "server.ViewerServer(v, port=0).stop()\n"
        "assert window._ppm_bytes(v.framebuffer).startswith(b'P6 16 12 255')\n"
        "assert cpu_tracer.render(cpu_tracer.scene_dict_from(v.scene), 4, 3).shape == (3, 4, 3)\n"
        "from gpu_raytracer_tpu_torch.parallel import mesh as pmesh, shard\n"
        "from gpu_raytracer_tpu_torch.ops.cuda.traverse import pack_threaded_tables\n"
        "from gpu_raytracer_tpu_torch.utils.image import rmse, srgb_to_linear, write_ppm\n"
        "m2 = pmesh.make_mesh(2, device='cpu')\n"
        "c = make_courtyard_scene(500)\n"
        "fb = shard.render_frame_fused_multichip(shard.replicate_tables(m2, c), 16, 12, m2)\n"
        "assert rmse(fb, Renderer(c, 16, 12, device='cpu').render()) == 0.0\n"
        "gs = shard.GeometryShards(c, m2)\n"
        "o = c.camera.position.expand(8, 3).contiguous()\n"
        "d = c.camera.direction.expand(8, 3).contiguous()\n"
        "assert shard.trace_geometry_sharded_ring(c, o, d, m2, gs).t.shape == (8,)\n"
        "assert pack_threaded_tables(c).nodes.shape == (c.bvh.num_nodes, 8)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib',"
        " 'gpu_raytracer_tpu.')) or m == 'gpu_raytracer_tpu')\n"
        "print('LOADED', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def _imported_modules(node: ast.AST, module: str) -> list[str]:
    """What an import statement of `module` names: each `a.b` of `import
    a.b`, each m.x of `from m import x` (x a module or a name in m), a
    relative m resolved against `module`'s package."""
    if isinstance(node, ast.Import):
        return [a.name for a in node.names]
    base = node.module or ""
    if node.level:
        base = ".".join(module.split(".")[:-node.level] + ([base] if base else []))
    return [f"{base}.{a.name}" for a in node.names]


def test_ops_and_models_import_only_downward():
    """The layers point one way: no module under ops/ or models/ imports
    engine (but engine.perf, the spans and counters), parallel or
    __main__, anywhere in its body; and no module under ops/ imports inside
    a function (an import there would hide a cycle)."""
    pkg = "gpu_raytracer_tpu_torch"
    upward = tuple(f"{pkg}.{m}" for m in ("engine", "parallel", "__main__"))
    bad = []
    for layer in ("ops", "models"):
        for path in sorted(glob.glob(os.path.join(REPO, pkg, layer, "**", "*.py"),
                                     recursive=True)):
            rel = os.path.relpath(path, REPO)
            module = rel[:-3].replace(os.sep, ".")
            with open(path) as f:
                tree = ast.parse(f.read(), path)
            for fn in ast.walk(tree):
                if layer == "ops" and isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    bad += [f"{rel}:{n.lineno} imports inside {fn.name}" for n in ast.walk(fn)
                            if isinstance(n, (ast.Import, ast.ImportFrom))]
            for n in ast.walk(tree):
                if not isinstance(n, (ast.Import, ast.ImportFrom)):
                    continue
                for m in _imported_modules(n, module):
                    if m.startswith(tuple(u + "." for u in upward)) and not m.startswith(
                            f"{pkg}.engine.perf."):
                        bad.append(f"{rel}:{n.lineno} imports {m}")
    assert not bad, "\n".join(sorted(set(bad)))


def test_make_mesh_never_falls_back_to_the_cpu(monkeypatch):
    """make_mesh() takes CUDA devices only: with none, or fewer than asked
    for, it raises; virtual shards on one device are asked for by name."""
    from gpu_raytracer_tpu_torch.parallel.mesh import make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    for args, kw in (((), {}), ((2,), {}), ((2,), dict(device="cuda:0"))):
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh(*args, **kw)
    assert make_mesh(2, device="cpu").devices == (torch.device("cpu"),) * 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="1 CUDA device"):
        make_mesh(2)
    assert make_mesh().devices == (torch.device("cuda", 0),)
    assert make_mesh(4, device="cuda:0").devices == (torch.device("cuda", 0),) * 4


def test_cuda_renderer_raises_without_a_device():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        Renderer(build_default_scene(), 16, 16, device="cuda")


def test_wrappers_refuse_other_devices():
    """A tensor neither on the CPU nor on a CUDA device is an error, not a
    reason to take the plain version."""
    meta = torch.device("meta")
    tables = TraceTables(scene=None, nodes=torch.empty((1, 32), device=meta),
                         tris=torch.empty((8, 12), device=meta),
                         attrs=torch.empty((8, 8), device=meta), depth=1, stack=16)
    o = torch.empty((4, 3), device=meta)
    with pytest.raises(ValueError, match="unsupported device"):
        traverse(tables, o, o, torch.empty(4, device=meta))
    threaded = ThreadedTables(scene=None, nodes=torch.empty((1, 12), device=meta),
                              tris=torch.empty((8, 12), device=meta))
    with pytest.raises(ValueError, match="unsupported device"):
        traverse_threaded(threaded, o, o, torch.empty(4, device=meta))
    rt = pack_render_tables(build_default_scene())
    px = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        render_primary(rt, px.to(meta), px.to(meta), 2, 2)
    with pytest.raises(ValueError):   # int64 coordinates
        render_primary(rt, px.long(), px.long(), 2, 2)


def test_deferred_wrappers_refuse_other_devices_and_take_plain_on_cpu(monkeypatch):
    """K3 and K4's wrappers: the plain versions for CPU tensors, an error
    for other devices, malformed inputs or an atlas past int32 addresses."""
    from gpu_raytracer_tpu_torch.ops.render import gbuffer_planes, render_gbuffer, split_gbuffer
    from gpu_raytracer_tpu_torch.ops.cuda import texshade
    from gpu_raytracer_tpu_torch.ops.cuda.render import render_deferred
    from gpu_raytracer_tpu_torch.ops.shading import shade_deferred

    scene = make_courtyard_scene(500, textured=True)
    rt, st = pack_render_tables(scene), texshade.pack_shade_tables(scene)
    py, px = (a.reshape(-1).to(torch.int32).contiguous()
              for a in torch.meshgrid(torch.arange(12), torch.arange(16), indexing="ij"))
    gbuf = render_deferred(rt, px, py, 16, 12, shadows=True)
    ref = gbuffer_planes(render_gbuffer(scene, px, py, 16, 12, shadows=True))
    assert torch.equal(gbuf.view(torch.int32), ref.view(torch.int32))   # a miss's id is NaN bits
    S, mat, uv, lam = split_gbuffer(gbuf)
    assert (mat >= 0).any() and (lam > 0).any()
    assert torch.equal(texshade.texture_shade(st, gbuf),
                       shade_deferred(scene, S, mat, uv, lam=lam))
    meta = torch.device("meta")
    with pytest.raises(ValueError):
        render_deferred(rt, px.to(meta), py.to(meta), 16, 12)
    with pytest.raises(ValueError):   # int64 coordinates
        render_deferred(rt, px.long(), py.long(), 16, 12)
    with pytest.raises(ValueError):
        texshade.texture_shade(st, gbuf.to(meta))
    with pytest.raises(ValueError):   # not the planes [2,N,4]
        texshade.texture_shade(st, gbuf[:, :, :3].contiguous())
    with pytest.raises(ValueError):   # the plain rows [N,8]
        texshade.texture_shade(st, render_gbuffer(scene, px, py, 16, 12))
    monkeypatch.setattr(texshade, "MAX_ATLAS_WORDS", scene.textures.data_u32.numel() - 1)
    with pytest.raises(ValueError, match="int32"):
        texshade.pack_shade_tables(scene)


def _meta_bounce_inputs():
    """Bounce tables and a 4-lane pool on the meta device."""
    from gpu_raytracer_tpu_torch.ops.cuda.bounce import BounceTables
    from gpu_raytracer_tpu_torch.ops.wavefront import WavefrontRays

    meta = torch.device("meta")
    trace = TraceTables(scene=None, nodes=torch.empty((1, 32), device=meta),
                        tris=torch.empty((8, 12), device=meta),
                        attrs=torch.empty((8, 8), device=meta), depth=1, stack=16)
    rt = dataclasses.replace(pack_render_tables(build_default_scene()), trace=trace)
    f = lambda *shape: torch.empty(shape, device=meta)
    i = lambda: torch.empty(4, dtype=torch.int32, device=meta)
    pool = WavefrontRays(origin=f(4, 3), direction=f(4, 3), ray_type=i(), bounce_depth=i(),
                         throughput=f(4, 3), medium_ior=f(4), pixel=i(), inv_pdf=f(4),
                         t_min=f(4), t_max=f(4), wavelength_channel=i(),
                         active=torch.empty(4, dtype=torch.bool, device=meta))
    return BounceTables(rt, None), pool, f(4, 7)


def test_bounce_wrappers_refuse_other_devices():
    """K6 and K5's wrappers: an error for a tensor neither on the CPU nor on
    a CUDA device, or for malformed inputs."""
    from gpu_raytracer_tpu_torch.ops.cuda.bounce import fused_bounce, sample_materials

    tables, pool, u = _meta_bounce_inputs()
    with pytest.raises(ValueError, match="unsupported device"):
        fused_bounce(tables, pool, u, shadows=True, do_rr=True)
    with pytest.raises(ValueError, match="unsupported device"):
        sample_materials(tables, torch.empty(4, dtype=torch.int32, device="meta"),
                         torch.empty((4, 2), device="meta"))
    cpu = pack_render_tables(build_default_scene())
    from gpu_raytracer_tpu_torch.ops.cuda.bounce import BounceTables

    with pytest.raises(ValueError, match="meta"):   # pool and tables on different devices
        fused_bounce(BounceTables(cpu, None), pool, u, shadows=True, do_rr=True)
    with pytest.raises(ValueError):   # int64 material ids
        sample_materials(BounceTables(cpu, None), torch.zeros(4, dtype=torch.int64),
                         torch.zeros((4, 2)))


def test_bounce_on_cuda_raises_when_the_kernels_do_not_load(tmp_path, monkeypatch):
    """On a CUDA pool K6's wrapper launches the kernel or raises: with no
    nvcc the library does not build, and the plain bounce is never taken."""
    from gpu_raytracer_tpu_torch.ops.cuda import bounce as bounce_mod

    tables, pool, u = _meta_bounce_inputs()
    monkeypatch.setattr(type(tables), "device", property(lambda self: torch.device("cuda")))
    monkeypatch.setattr(bounce_mod, "_check", lambda *args: None)
    monkeypatch.setattr(bounce_mod, "bounce",
                        lambda *a, **k: pytest.fail("the plain bounce was taken"))
    monkeypatch.setattr(build, "BUILD_ROOT", str(tmp_path / "build"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path / "no-bin"))
    build.load_kernels.cache_clear()
    try:
        launches = build.LAUNCHES.copy()
        with pytest.raises(RuntimeError, match="nvcc"):
            bounce_mod.fused_bounce(tables, pool, u, shadows=True, do_rr=True)
        assert build.LAUNCHES == launches
    finally:
        build.load_kernels.cache_clear()


def test_failed_build_raises(tmp_path, monkeypatch):
    """No nvcc: the kernel library does not load, and that is an error."""
    monkeypatch.setattr(build, "BUILD_ROOT", str(tmp_path / "build"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path / "no-bin"))
    build.load_kernels.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc"):
            build.load_kernels()
    finally:
        build.load_kernels.cache_clear()


def test_nvcc_command_line():
    """One compile per source, all for sm_90a without FMA contraction or
    fast math, then one link of their objects into the shared library."""
    compiles, link = build.nvcc_commands("out.so", "nvcc")
    for cmd in compiles:
        line = " ".join(cmd)
        assert "arch=compute_90a,code=sm_90a" in line
        assert "-fmad=false" in cmd and "-O3" in cmd and "-c" in cmd
        assert not any("fast_math" in a or "fast-math" in a for a in cmd)
        assert all(os.path.exists(a) for a in cmd if a.endswith(".cu"))
    sources = [os.path.basename(a) for cmd in compiles for a in cmd if a.endswith(".cu")]
    assert sorted(sources) == sorted(build.SOURCES)
    objs = [cmd[cmd.index("-o") + 1] for cmd in compiles]
    assert "-shared" in link and link[link.index("-o") + 1] == "out.so"
    assert [a for a in link if a.endswith(".o")] == objs
    assert all(os.path.exists(os.path.join(build.CSRC, h)) for h in build.HEADERS)


def test_source_hash_follows_the_sources():
    h = build.source_hash()
    assert len(h) == 16 and h == build.source_hash()


def test_wrapper_sources_have_no_fallback():
    """The kernel wrappers hold no try/except that could fall back."""
    for name in ("traverse.py", "render.py", "texshade.py", "bounce.py", "build.py",
                 "denoise.py"):
        with open(os.path.join(REPO, "gpu_raytracer_tpu_torch", "ops", "cuda", name)) as f:
            src = f.read()
        assert "try:" not in src and "except" not in src, name


def test_denoise_on_cuda_raises_without_the_filter_kernels(monkeypatch):
    """atrous_denoise on a CUDA tensor launches the filter's kernels or
    raises: a library without their entry points is an error, nothing is
    launched or counted, and the plain filter is never taken."""
    from types import SimpleNamespace

    from gpu_raytracer_tpu_torch.ops import denoise
    from gpu_raytracer_tpu_torch.ops.cuda import denoise as cuda_denoise

    class CudaTyped(torch.Tensor):
        """A CPU tensor that says it lies on a CUDA device."""
        device = torch.device("cuda", 0)

    color, albedo = torch.rand(12, 16, 3), torch.rand(12, 16, 3)
    normal = torch.nn.functional.normalize(torch.randn(12, 16, 3), dim=-1)
    depth = torch.rand(12, 16) + 1.0
    args = [t.as_subclass(CudaTyped) for t in (color, normal, depth, albedo)]
    refuse = lambda *a, **k: pytest.fail("the plain filter was taken")
    monkeypatch.setattr(denoise, "plain_atrous_denoise", refuse)
    monkeypatch.setattr(denoise, "_cos_power", refuse)
    monkeypatch.setattr(cuda_denoise, "load_kernels",
                        lambda: SimpleNamespace(lib=SimpleNamespace(rt_atrous_prepare=refuse)))
    launches = build.LAUNCHES.copy()
    for alb in (args[3], None):
        with pytest.raises(RuntimeError, match="rt_atrous_pass"):   # prepare alone is there
            denoise.atrous_denoise(*args[:3], alb, iterations=3)
    assert build.LAUNCHES == launches
    with pytest.raises(ValueError, match="unsupported device"):
        denoise.atrous_denoise(*(t.to("meta") for t in (color, normal, depth)))
    # the CPU keeps the plain filter
    monkeypatch.undo()
    out = denoise.atrous_denoise(color, normal, depth, albedo, iterations=2)
    assert torch.equal(out, denoise.plain_atrous_denoise(color, normal, depth, albedo,
                                                         iterations=2))


def test_textured_render_primary_never_renders_untextured(monkeypatch):
    """`render_primary` on a textured scene: the textured plain version on
    the CPU; on a CUDA-typed call it asks for the shade tables and then
    builds the kernel or raises: never an untextured frame."""
    from gpu_raytracer_tpu_torch.ops.cuda import render as render_mod
    from gpu_raytracer_tpu_torch.ops.cuda.texshade import pack_shade_tables
    from gpu_raytracer_tpu_torch.ops.render import render_chunk

    scene = make_courtyard_scene(500, textured=True)
    rt = pack_render_tables(scene)
    py, px = (a.reshape(-1).to(torch.int32).contiguous()
              for a in torch.meshgrid(torch.arange(12), torch.arange(16), indexing="ij"))
    got = render_primary(rt, px, py, 16, 12, shadows=True)
    assert torch.equal(got, render_chunk(scene, px, py, 16, 12, shadows=True))
    flat = dataclasses.replace(scene, textures=type(scene.textures).empty())
    assert not torch.equal(got, render_chunk(flat, px, py, 16, 12, shadows=True))

    class CudaTyped(torch.Tensor):
        """A CPU tensor that says it lies on a CUDA device."""
        device = torch.device("cuda", 0)

    cpx, cpy = px.as_subclass(CudaTyped), py.as_subclass(CudaTyped)
    cuda_rt = dataclasses.replace(rt, trace=dataclasses.replace(
        rt.trace, nodes=rt.trace.nodes.as_subclass(CudaTyped)))
    monkeypatch.setattr(render_mod, "render_chunk",
                        lambda *a, **k: pytest.fail("the plain version was taken"))
    with pytest.raises(ValueError, match="shade tables"):
        render_primary(cuda_rt, cpx, cpy, 16, 12)
    monkeypatch.setattr(render_mod, "load_kernels",
                        lambda: (_ for _ in ()).throw(RuntimeError("nvcc not found")))
    shade = pack_shade_tables(scene)
    shade.materials = shade.materials.as_subclass(CudaTyped)
    launches = build.LAUNCHES["k2t"]
    with pytest.raises(RuntimeError, match="nvcc"):
        render_primary(cuda_rt, cpx, cpy, 16, 12, shade=shade)
    assert build.LAUNCHES["k2t"] == launches


def test_many_lights_are_not_refused():
    """17 lights, one past the loop bound of the JAX package's kernels: the
    CPU route renders them all, and more light than the one-light scene."""
    lb = LightBuilder()
    for i in range(17):
        lb.add_point((float(i), 5.0, 0.0), (1.0, 1.0, 1.0), 1.0)
    scene = dataclasses.replace(build_default_scene(), lights=lb.build())
    frame = Renderer(scene, 8, 8, shadows=True, device="cpu").render()
    one_light = Renderer(build_default_scene(), 8, 8, shadows=True, device="cpu").render()
    assert frame.shape == (8, 8, 3) and np.isfinite(frame).all()
    assert frame.sum() > 2.0 * one_light.sum()


def test_trace_on_a_device_tensor_takes_k1_never_the_plain_walk(monkeypatch):
    """`ops/cuda/traverse.py::trace` on a tensor that is not on the CPU
    hands the triangles to the K1 wrapper (here on the meta device, where a
    recording stand-in answers for the kernel) and never reaches the plain
    BVH walk; on CPU tensors it is the plain trace."""
    from gpu_raytracer_tpu_torch.ops import trace as plain
    from gpu_raytracer_tpu_torch.ops.cuda import traverse as k1

    scene = make_courtyard_scene(500, textured=True)
    tables = k1.pack_trace_tables(scene)
    o = scene.camera.position.expand(64, 3)
    d = torch.nn.functional.normalize(torch.randn(64, 3), dim=1)
    want = plain.trace(scene, o, d)
    got = k1.trace(tables, o, d)
    for f in ("t", "hit", "prim_id", "normal", "material_id", "uv"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f

    def refuse(*a, **kw):
        raise AssertionError("the plain BVH walk ran for a device tensor")

    monkeypatch.setattr(plain, "bvh_traverse_threaded", refuse)
    monkeypatch.setattr(plain, "_triangles_brute", refuse)
    calls = []

    def kernel(tables_, orig, dirn, max_t, any_hit=False):
        calls.append((orig.device, orig.is_contiguous(), tuple(max_t.shape)))
        n = orig.shape[0]
        return (torch.empty(n, device=orig.device), torch.empty(n, dtype=torch.int32,
                                                                 device=orig.device),
                torch.empty(n, dtype=torch.bool, device=orig.device), torch.empty_like(orig),
                torch.empty(n, dtype=torch.int32, device=orig.device))

    monkeypatch.setattr(k1, "traverse", kernel)
    meta = torch.device("meta")
    hit = k1.trace(dataclasses.replace(tables, scene=scene.to(meta)), o.to(meta), d.to(meta))
    assert calls == [(meta, True, (64,))]
    assert hit.t.device == meta and hit.uv.shape == (64, 2)


def test_gbuffer_and_warp_trace_through_the_kernel_wrappers(monkeypatch):
    """The path tracer's G-buffer and temporal warp trace with
    `ops/cuda/traverse.py::trace` (K1 on a CUDA device) and sample a
    textured albedo with `ops/cuda/bounce.py::sample_materials` (K5)."""
    from gpu_raytracer_tpu_torch.engine import pathtracer
    from gpu_raytracer_tpu_torch.ops.cuda import bounce as bounce_mod
    from gpu_raytracer_tpu_torch.ops.cuda import traverse as k1

    assert pathtracer.trace is k1.trace
    assert pathtracer.sample_materials is bounce_mod.sample_materials
    seen = []
    spy = lambda name, fn: (lambda *a, **kw: (seen.append(name), fn(*a, **kw))[1])
    monkeypatch.setattr(pathtracer, "trace", spy("k1", k1.trace))
    monkeypatch.setattr(pathtracer, "sample_materials", spy("k5", bounce_mod.sample_materials))
    pt = pathtracer.PathTracer(make_courtyard_scene(500, textured=True), 16, 12, device="cpu")
    pt.gbuffer()
    assert seen == ["k1", "k5"]
    pt.step()
    pt.set_camera(pt.scene.camera, temporal=True)   # the old depth from gbuffer()'s planes
    assert seen == ["k1", "k5"] * 2
    pt._gbuf = pt._gbuf_tile = None
    pt.set_camera(pt.scene.camera, temporal=True)   # no cached depth: it is traced first
    assert seen == ["k1", "k5"] * 2 + ["k1", "k1", "k5"]


def test_unported_inputs_raise(monkeypatch):
    """BVH width 8, spatial splits and both build, and a width-8 table on a
    CUDA tensor goes to the width-8 kernel instance or raises: the wrappers
    never take the plain walk or a width-4 instance for it. Only another
    width than 4 or 8 is refused."""
    from gpu_raytracer_tpu_torch.ops import trace as plain
    from gpu_raytracer_tpu_torch.ops.cuda import render as render_mod
    from gpu_raytracer_tpu_torch.ops.cuda import traverse as k1

    for kw in (dict(bvh_width=8), dict(bvh_spatial_splits=True),
               dict(bvh_width=8, bvh_spatial_splits=True)):
        scene = make_courtyard_scene(500, config=RaytracerConfig(**kw))
        assert scene.bvh.q_child.shape[1] == kw.get("bvh_width", 4)
        tables = pack_render_tables(scene)
        assert tables.trace.width == kw.get("bvh_width", 4)
        assert tables.trace.nodes.shape[1] == 8 * tables.trace.width
    with pytest.raises(ValueError, match="4 or 8"):
        make_courtyard_scene(500, config=RaytracerConfig(bvh_width=2))

    class CudaTyped(torch.Tensor):
        """A CPU tensor that says it lies on a CUDA device."""
        device = torch.device("cuda", 0)

    scene = make_courtyard_scene(500, config=RaytracerConfig(bvh_width=8))
    rt = pack_render_tables(scene)
    cuda_trace = dataclasses.replace(rt.trace, nodes=rt.trace.nodes.as_subclass(CudaTyped))
    cuda_rt = dataclasses.replace(rt, trace=cuda_trace)
    refuse = lambda *a, **k: pytest.fail("the plain version was taken")
    monkeypatch.setattr(plain, "bvh_traverse_threaded", refuse)
    monkeypatch.setattr(k1, "traverse_triangles", refuse)
    monkeypatch.setattr(render_mod, "render_chunk", refuse)
    no_nvcc = lambda: (_ for _ in ()).throw(RuntimeError("nvcc not found"))
    monkeypatch.setattr(k1, "load_kernels", no_nvcc)
    monkeypatch.setattr(render_mod, "load_kernels", no_nvcc)
    o = scene.camera.position.expand(64, 3).contiguous().as_subclass(CudaTyped)
    d = torch.nn.functional.normalize(torch.randn(64, 3), dim=1).as_subclass(CudaTyped)
    far = torch.full((64,), 3.0e38).as_subclass(CudaTyped)
    py, px = (a.reshape(-1).to(torch.int32).contiguous().as_subclass(CudaTyped)
              for a in torch.meshgrid(torch.arange(12), torch.arange(16), indexing="ij"))
    counts = lambda: (build.LAUNCHES["k1_standalone"], build.LAUNCHES["k1_standalone_w8"],
                      build.LAUNCHES["k2"], build.LAUNCHES["k2_w8"])
    before = counts()
    with pytest.raises(RuntimeError, match="nvcc"):
        k1.traverse(cuda_trace, o, d, far)
    with pytest.raises(RuntimeError, match="nvcc"):
        render_primary(cuda_rt, px, py, 16, 12, shadows=True)
    assert counts() == before


def test_in_place_bounce_takes_the_plain_version_only_on_cpu(monkeypatch):
    """`fused_bounce_` on CPU tensors is `ops/wavefront.py::bounce_` (the
    same in-place result); it wants the uniforms or the QMC stream, never
    both or neither; and it launches nothing."""
    from gpu_raytracer_tpu_torch.ops import wavefront
    from gpu_raytracer_tpu_torch.ops.cuda import bounce as bounce_mod
    from gpu_raytracer_tpu_torch.ops.sampler import QmcStream

    scene = make_courtyard_scene(500)
    tables = bounce_mod.pack_bounce_tables(scene)
    py, px = (a.reshape(-1).to(torch.int32).contiguous()
              for a in torch.meshgrid(torch.arange(12), torch.arange(16), indexing="ij"))
    pool = lambda: wavefront.camera_wavefront_rays(scene.camera, 16, 12, px, py,
                                                   wavefront.RGB_CHANNEL)
    kw = dict(depth=0, qmc=QmcStream(seed=3), shadows=True, do_rr=False, light_sample=True)
    a, b = pool(), pool()
    ra, rb = torch.zeros((192, 3)), torch.zeros((192, 3))
    launches = build.LAUNCHES.copy()
    assert bounce_mod.fused_bounce_(tables, a, ra, **kw) is None
    wavefront.bounce_(scene, b, rb, **kw)
    assert build.LAUNCHES == launches
    assert torch.equal(ra, rb) and ra.abs().sum() > 0
    for name in ("origin", "direction", "throughput", "active", "bounce_depth"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert not torch.equal(a.origin, pool().origin)   # updated in place
    with pytest.raises(ValueError, match="uniforms"):
        bounce_mod.fused_bounce_(tables, a, ra, shadows=True, do_rr=False)
    with pytest.raises(ValueError, match="uniforms"):
        bounce_mod.fused_bounce_(tables, a, ra, u=torch.zeros((192, 7)), qmc=QmcStream(),
                                 shadows=True, do_rr=False)
    with pytest.raises(ValueError, match="order"):   # int64 order
        bounce_mod.fused_bounce_(tables, a, ra, order=torch.arange(192), **kw)
    with pytest.raises(ValueError, match="CUDA"):
        bounce_mod.qmc_uniforms_kernel(QmcStream(), 0, 16, "cpu")


@pytest.mark.cuda
def test_bounce_on_a_misaligned_node_table_raises_and_touches_nothing():
    """On the card K6's wrapper refuses a node table off its 128-byte line
    before it counts a launch or writes a lane."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gpu_raytracer_tpu_torch.ops import wavefront
    from gpu_raytracer_tpu_torch.ops.cuda import bounce as bounce_mod
    from gpu_raytracer_tpu_torch.ops.sampler import QmcStream

    cuda = torch.device("cuda")
    scene = make_courtyard_scene(500, device=cuda)
    tables = bounce_mod.pack_bounce_tables(scene)
    trace = tables.render.trace
    Q, words = trace.nodes.shape
    buf = torch.zeros(Q * words + 16, dtype=torch.float32, device=cuda)
    shifted = buf[16:].view(Q, words)
    shifted.copy_(trace.nodes)
    bad = bounce_mod.BounceTables(dataclasses.replace(
        tables.render, trace=dataclasses.replace(trace, nodes=shifted)), None)
    py, px = (a.reshape(-1).to(torch.int32).contiguous().to(cuda)
              for a in torch.meshgrid(torch.arange(12), torch.arange(16), indexing="ij"))
    r = wavefront.camera_wavefront_rays(scene.camera, 16, 12, px, py, wavefront.RGB_CHANNEL)
    before = r.origin.clone()
    rad = torch.zeros((192, 3), device=cuda)
    launches = build.LAUNCHES["k6"]
    with pytest.raises(ValueError, match="128-byte"):
        bounce_mod.fused_bounce_(bad, r, rad, qmc=QmcStream(), shadows=True, do_rr=False)
    assert build.LAUNCHES["k6"] == launches
    assert torch.equal(r.origin, before) and not rad.any()
    bounce_mod.fused_bounce_(tables, r, rad, qmc=QmcStream(), shadows=True, do_rr=False)
    assert build.LAUNCHES["k6"] == launches + 1 and rad.any()


def test_refit_and_table_refresh_never_read_the_device():
    """refit_scene (both modes) and the table refresh run on the meta device,
    whose tensors hold no data: any read back to the host, a copy to the CPU
    or a data-dependent shape raises there. So on a CUDA scene they stay on
    the card and take no CPU path."""
    from gpu_raytracer_tpu_torch.models.scene import refit_scene
    from gpu_raytracer_tpu_torch.ops.cuda.traverse import (pack_trace_tables,
                                                           refit_trace_tables)

    scene = make_courtyard_scene(500, textured=True)
    host = pack_trace_tables(scene)
    meta = torch.device("meta")
    tables = dataclasses.replace(host, scene=scene.to(meta), nodes=host.nodes.to(meta),
                                 tris=host.tris.to(meta), attrs=host.attrs.to(meta))
    v = torch.empty((scene.mesh.num_vertices, 3), device=meta)
    refit = refit_scene(tables.scene, v)
    nodes = tables.nodes
    refit_trace_tables(tables, refit)       # in place
    assert tables.nodes is nodes and tables.scene is refit
    rebuilt = refit_scene(refit, v, rebuild=True)
    refit_trace_tables(tables, rebuilt)     # packed anew, on the device
    assert tables.nodes.device == meta and tables.stack == 128
    assert all(t.device == meta for t in (rebuilt.tri_v0, rebuilt.tri_den, rebuilt.bvh.q_min))
