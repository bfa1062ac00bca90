"""Build and load the hand-written CUDA kernels (csrc/*.cu).

The sources are compiled once per content hash by `nvcc` into a shared
library with a plain C interface under `build/cuda/<hash>/` (git-ignored),
at first use, and loaded with ctypes. Nothing here runs at import time.
Each source compiles in its own `nvcc` process, all started together, and
one more links the objects.

Flags: `sm_90a` (Hopper), `-fmad=false` so that `a*b + c` rounds like the
plain PyTorch version (each PyTorch op rounds on its own; FMA contraction
would move slab and Moller-Trumbore results by an ulp and flip edge
pixels), and no `--use_fast_math` (it flushes denormals and approximates
division and sqrt).
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass

PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(PKG, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(PKG), "build", "cuda")
# the width-8 instances of the traversing kernels (*_w8.cu) compile in
# sources of their own, in parallel with the width-4 ones
SOURCES = ("traverse.cu", "render_primary.cu", "render_primary_textured.cu",
           "render_deferred.cu", "texshade.cu", "bounce.cu", "bounce_textured.cu",
           "materials.cu", "qmc.cu", "traverse_w8.cu", "render_primary_w8.cu",
           "render_primary_textured_w8.cu", "render_deferred_w8.cu", "bounce_w8.cu",
           "bounce_textured_w8.cu", "traverse_threaded.cu", "camera_relative.cu",
           "atrous.cu")
HEADERS = ("traverse.cuh", "traverse_kernels.cuh", "render_common.cuh", "render_primary.cuh",
           "primary_pixel.cuh", "render_deferred.cuh", "texsample.cuh", "bounce.cuh",
           "threaded_walk.cuh", "camera_row.cuh", "atrous.cuh")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
LIB_NAME = "librt_kernels.so"
# Kernel launches by kernel id, added to at every launch (`tally`) and
# cleared by whoever reads them: k1_standalone, k1_threaded, k2, k2t, k3,
# k3_pre (K3's pre-pass), k4, k5 (inside K6's textured launches),
# k5_standalone, k6, the width-8 instances as k1_standalone_w8, k2_w8,
# k2t_w8, k3_w8, k5_w8 and k6_w8, camera_row, qmc, and denoise (the à-trous
# filter's prepare and pass launches).
LAUNCHES: collections.Counter = collections.Counter()

_p = ctypes.c_void_p
_i = ctypes.c_int
_f = ctypes.c_float
ARGTYPES = {
    # every traversing entry takes the node table's width (4 or 8) before
    # the stack capacity, and launches that width's instance
    # nodes, tris, node width, stack, orig, dirn, max_t, n, any_hit,
    # t_out, slot_out, normal_out, mat_out, stream
    "rt_traverse": [_p, _p, _i, _i, _p, _p, _p, _i, _i, _p, _p, _p, _p, _p],
    # nodes, tris, node width, stack, orig, dirn, max_t, n, any_hit, work_out,
    # ahead_out (null, or [9] visits by children ahead at width 8), stream
    "rt_traverse_work": [_p, _p, _i, _i, _p, _p, _p, _i, _i, _p, _p, _p],
    # binary nodes, n_nodes, the tables' flags, tris, orig, dirn, max_t, n,
    # any_hit, t_out, slot_out, normal_out, mat_out, stream
    "rt_traverse_threaded": [_p, _i, _i, _p, _p, _p, _p, _i, _i, _p, _p, _p, _p, _p, _p],
    # nodes, tris, rel_nodes, rel_tris (the camera-relative tables, read at
    # width 8; null at width 4), node width, stack, camera, materials,
    # n_mats, lights, n_lights, spheres, n_spheres, px, py, n, width, height,
    # shadows, sky_r, sky_g, sky_b, light_u (null: every light), rgb_out,
    # stream
    "rt_render_primary": [_p, _p, _p, _p, _i, _i, _p, _p, _i, _p, _i, _p, _i, _p, _p, _i,
                          _i, _i, _i, _f, _f, _f, _p, _p, _p],
    # nodes, tris, attrs, rel_nodes, rel_tris, node width, stack, camera,
    # materials, n_mats, lights, n_lights, spheres, n_spheres, maps, atlas,
    # present, n_levels, pix_scale, px, py, n, width, height, shadows, sky_r,
    # sky_g, sky_b, light_u, rgb_out, stream
    "rt_render_primary_textured": [_p, _p, _p, _p, _p, _i, _i, _p, _p, _i, _p, _i, _p, _i,
                                   _p, _p, _i, _i, _f, _p, _p, _i, _i, _i, _i, _f, _f, _f,
                                   _p, _p, _p],
    # nodes, tris, attrs, rel_nodes, rel_tris (the camera-relative tables),
    # node width, stack, camera, lights, n_lights, spheres, n_spheres, px,
    # py, n, width, height, shadows, pix_scale, light_u, gbuf_out, stream
    "rt_render_deferred": [_p, _p, _p, _p, _p, _i, _i, _p, _p, _i, _p, _i, _p, _p, _i, _i, _i,
                           _i, _f, _p, _p, _p],
    # camera, nodes, node width, n_nodes, tris, n_slots, rel_nodes_out,
    # rel_tris_out, stream
    "rt_camera_relative": [_p, _p, _i, _i, _p, _i, _p, _p, _p],
    # position, direction, up, fov (device words, or null: the values
    # p0-p2, d0-d2, u0-u2, fov that follow), fov_scale, row_out, fields_out,
    # stream
    "rt_camera_row": [_p, _p, _p, _p, _f, _f, _f, _f, _f, _f, _f, _f, _f, _f, _f, _p, _p, _p],
    # gbuf, n, materials, n_mats, maps, atlas, present, n_levels, trilinear,
    # sky_r, sky_g, sky_b, rgb_out, stream
    "rt_texture_shade": [_p, _i, _p, _i, _p, _p, _i, _i, _i, _f, _f, _f, _p, _p],
    # nodes, tris, attrs, node width, stack, materials, n_mats, lights,
    # n_lights, spheres, n_spheres, maps, atlas, present, n_levels, textured,
    # tex_lod, the pool in place: origin, direction, throughput, medium,
    # channel, ray_type, depth, active, radiance; n, order, n_live, u (each
    # may be null), qmc (host words, read when u is null), nee, cont, stream
    "rt_bounce": [_p, _p, _p, _i, _i, _p, _i, _p, _i, _p, _i, _p, _p, _i, _i, _i, _f,
                  _p, _p, _p, _p, _p, _p, _p, _p, _p, _i, _p, _p, _p, _p, _i, _i, _p],
    # qmc (host words), n, u_out, stream
    "rt_qmc_uniforms": [_p, _i, _p, _p],
    # color, its pixel stride, normal, stride, depth, stride, albedo (null:
    # none), stride, height, width, sub_y, sub_x, c_plane, g_plane,
    # sub_depth, out (null unless no pass follows), stream
    "rt_atrous_prepare": [_p, _i, _p, _i, _p, _i, _p, _i, _i, _i, _i, _i, _p, _p, _p, _p, _p],
    # c_in, g_plane, sorted sub_depth, its length, height, width, step,
    # sigma_color, sigma_depth, sigma_normal, power, c_out, albedo, albedo
    # stride, out (null but on the last pass), stream
    "rt_atrous_pass": [_p, _p, _p, _i, _i, _i, _i, _f, _f, _f, _i, _p, _p, _i, _p, _p],
    # materials, n_mats, maps, atlas, present, n_levels, mat_id, uv, lod, n,
    # out, stream
    "rt_sample_materials": [_p, _i, _p, _p, _i, _i, _p, _p, _f, _i, _p, _p],
}


@dataclass(frozen=True)
class KernelLibrary:
    lib: ctypes.CDLL
    path: str
    seconds: float   # nvcc time in this process (0.0 when the build dir had it)
    log: str         # nvcc's output: ptxas registers, spills, stack frame


def find_nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found ($CUDA_HOME/bin, /usr/local/cuda/bin, PATH)")


def nvcc_commands(out_path: str, nvcc: str = "nvcc"):
    """-> (one compile command per source, the link command). Objects go
    beside `out_path`."""
    objs = [f"{out_path}.{os.path.splitext(s)[0]}.o" for s in SOURCES]
    compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, os.path.join(CSRC, s)]
                for s, o in zip(SOURCES, objs)]
    return compiles, [nvcc, *ARCH_FLAGS, "-shared", "-o", out_path, *objs]


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


@functools.cache
def load_kernels() -> KernelLibrary:
    """Compile (if this source hash has no library yet) and load the kernels."""
    out_dir = os.path.join(BUILD_ROOT, source_hash())
    path = os.path.join(out_dir, LIB_NAME)
    log_path = os.path.join(out_dir, "nvcc.log")
    seconds = 0.0
    if not os.path.exists(path):
        os.makedirs(out_dir, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        compiles, link = nvcc_commands(tmp, find_nvcc())
        t0 = time.perf_counter()
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for c in compiles]
        runs = [(c, p.communicate()[0], p.returncode) for c, p in zip(compiles, procs)]
        if all(rc == 0 for _, _, rc in runs):
            proc = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
            runs.append((link, proc.stdout, proc.returncode))
        seconds = time.perf_counter() - t0
        log = "".join(" ".join(c) + "\n" + out for c, out, _ in runs)
        with open(log_path, "w") as f:
            f.write(log)
        failed = [rc for _, _, rc in runs if rc != 0]
        if failed:
            raise RuntimeError(f"nvcc failed ({failed[0]}):\n{log}")
        os.replace(tmp, path)
    with open(log_path) as f:
        log = f.read()
    lib = ctypes.CDLL(path)
    for name, argtypes in ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return KernelLibrary(lib, path, seconds, log)


def tally(kernel: str, width: int = 4) -> None:
    """Count one launch of `kernel` in LAUNCHES; at node width 8 as
    `kernel` + "_w8", the instance of that width."""
    LAUNCHES[kernel if width == 4 else f"{kernel}_w8"] += 1


def check(status: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status}")
