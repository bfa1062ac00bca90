"""ctypes binding for the native C++ binned-SAH BVH builder (csrc/bvh_builder.cpp).

The repository ships the builder compiled (`csrc/libbvh_builder.so`); the
JAX package loads the same file, which is what keeps the two packages' trees
bit-equal. Where that library does not load on this host, the source is
compiled with g++ into `build/`. `load_builder` raises when neither works:
the NumPy builder (models/bvh.py::build_bvh with use_native=False) is a
choice the caller makes, never taken in the native builder's place.
`collapse4_native` collapses a binary tree into its 4- or 8-wide overlay.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
from dataclasses import dataclass

import numpy as np

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
COMMITTED_LIB = os.path.join(REPO, "csrc", "libbvh_builder.so")
SOURCE = os.path.join(REPO, "csrc", "bvh_builder.cpp")
BUILT_LIB = os.path.join(REPO, "build", "libbvh_builder.so")
GXX_CMD = ["g++", "-O3", "-std=c++17", "-fPIC", "-shared", "-pthread"]

_i32p = ctypes.POINTER(ctypes.c_int32)
_f32p = ctypes.POINTER(ctypes.c_float)


@dataclass(frozen=True)
class NativeBuilder:
    lib: ctypes.CDLL
    path: str       # the shared library that was loaded
    origin: str     # "committed" or "compiled"


def _bind(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    lib.bvh_build.argtypes = [
        _f32p, ctypes.c_int64,                        # vertices, V
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,  # indices, T
        ctypes.c_int32,                               # leaf_size
        _f32p, _f32p,                                 # node_min/max out
        _i32p, _i32p,                                 # left/right out
        _i32p, _i32p,                                 # start/count out
        ctypes.POINTER(ctypes.c_int64),               # tri_order out
        _i32p,                                        # max_depth out
    ]
    lib.bvh_build.restype = ctypes.c_int64
    lib.bvh_collapse_wide.argtypes = [
        _i32p, _i32p, _i32p, _i32p, _f32p, _f32p, ctypes.c_int64, ctypes.c_int32,
        _i32p, _i32p, _f32p, _f32p, _i32p, _i32p,
    ]
    lib.bvh_collapse_wide.restype = ctypes.c_int64
    return lib


@functools.cache
def load_builder() -> NativeBuilder:
    """The committed library, or a fresh g++ build of its source."""
    try:
        return NativeBuilder(_bind(COMMITTED_LIB), COMMITTED_LIB, "committed")
    except OSError as committed_error:
        os.makedirs(os.path.dirname(BUILT_LIB), exist_ok=True)
        cmd = GXX_CMD + ["-o", BUILT_LIB, SOURCE]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"no native BVH builder: {COMMITTED_LIB} does not load "
                f"({committed_error}) and `{' '.join(cmd)}` failed:\n{proc.stderr}")
        return NativeBuilder(_bind(BUILT_LIB), BUILT_LIB, "compiled")


def build_bvh_native(vertices: np.ndarray, indices: np.ndarray, leaf_size: int):
    from .bvh import BvhBuildResult

    lib = load_builder().lib
    vertices = np.ascontiguousarray(vertices, np.float32)
    indices = np.ascontiguousarray(indices, np.uint32)
    T = indices.shape[0]
    cap = max(2 * T + 2, 16)
    node_min = np.zeros((cap, 3), np.float32)
    node_max = np.zeros((cap, 3), np.float32)
    left = np.zeros(cap, np.int32)
    right = np.zeros(cap, np.int32)
    start = np.zeros(cap, np.int32)
    count = np.zeros(cap, np.int32)
    order = np.zeros(T, np.int64)
    depth = np.zeros(1, np.int32)

    p = lambda a, t: a.ctypes.data_as(ctypes.POINTER(t))
    n = lib.bvh_build(
        p(vertices, ctypes.c_float), vertices.shape[0],
        p(indices, ctypes.c_uint32), T, leaf_size,
        p(node_min, ctypes.c_float), p(node_max, ctypes.c_float),
        p(left, ctypes.c_int32), p(right, ctypes.c_int32),
        p(start, ctypes.c_int32), p(count, ctypes.c_int32),
        p(order, ctypes.c_int64), p(depth, ctypes.c_int32))
    if n < 0:
        raise RuntimeError(f"native bvh_build failed ({n})")
    n = int(n)
    return BvhBuildResult(node_min[:n].copy(), node_max[:n].copy(),
                          left[:n].copy(), right[:n].copy(),
                          start[:n].copy(), count[:n].copy(), order, int(depth[0]))


def collapse4_native(left, right, tri_start, tri_count, node_min, node_max,
                     width: int = 4):
    """Native wide collapse -> (q_child, q_leafc, q_min, q_max, q_axis, q_src),
    the same tuple as models/bvh.py::collapse4."""
    lib = load_builder().lib
    left = np.ascontiguousarray(left, np.int32)
    right = np.ascontiguousarray(right, np.int32)
    tri_start = np.ascontiguousarray(tri_start, np.int32)
    tri_count = np.ascontiguousarray(tri_count, np.int32)
    node_min = np.ascontiguousarray(node_min, np.float32)
    node_max = np.ascontiguousarray(node_max, np.float32)
    n = left.shape[0]
    q_child = np.empty((n, width), np.int32)
    q_leafc = np.empty((n, width), np.int32)
    q_min = np.empty((n, width, 3), np.float32)
    q_max = np.empty((n, width, 3), np.float32)
    q_axis = np.empty(n, np.int32)
    q_src = np.empty((n, width), np.int32)

    i32 = lambda a: a.ctypes.data_as(_i32p)
    f32 = lambda a: a.ctypes.data_as(_f32p)
    q = lib.bvh_collapse_wide(i32(left), i32(right), i32(tri_start), i32(tri_count),
                              f32(node_min), f32(node_max), n, width,
                              i32(q_child), i32(q_leafc), f32(q_min), f32(q_max),
                              i32(q_axis), i32(q_src))
    if q <= 0:
        raise RuntimeError(f"native bvh_collapse_wide failed ({q})")
    return (q_child[:q], q_leafc[:q], q_min[:q], q_max[:q], q_axis[:q], q_src[:q])
