"""A camera move (ops/cuda/render.py::set_camera): the camera row kernel
(csrc/camera_relative.cu rt_camera_row, csrc/camera_row.cuh) and the
field-of-view cache.

On CUDA tables a move is one launch of one thread that rewrites the 16-word
camera row in place and writes the new camera's 10 fields into a fresh
buffer, which the scene's camera then views. Its arithmetic,
`camera_row.cuh::camera_row`, compiles for the host too: g++ builds it
(-ffp-contract=off, as the kernels are built -fmad=false) and it must equal
the plain version, `camera_row`, bit for bit, over seeded cameras, the
controller's moves, a direction parallel to up and other fields of view.
CPU tables keep the plain version; tan(fov/2) is evaluated again only when
the field of view's value changes. The tests marked `cuda` hold the kernel
to the plain version on the card: the row and its address, the scene's
camera, a camera held from before the move, a device camera into the path
tracer's temporal warp, and one kernel launch a move (torch.profiler)."""

import dataclasses
import math
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from gpu_raytracer_tpu_torch.config import DEFAULT_CONFIG
from gpu_raytracer_tpu_torch.engine import perf
from gpu_raytracer_tpu_torch.models.camera import Camera, CameraController, tan_half_fov
from gpu_raytracer_tpu_torch.models.scene import build_default_scene
from gpu_raytracer_tpu_torch.ops.cuda import render
from gpu_raytracer_tpu_torch.ops.cuda.build import LAUNCHES
from gpu_raytracer_tpu_torch.ops.cuda.render import camera_row, pack_render_tables, set_camera
from gpu_raytracer_tpu_torch.utils.procgen import make_courtyard_scene

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "gpu_raytracer_tpu_torch", "csrc")

# Reads n cameras of 11 floats (the fields, then fov_scale), writes n rows.
HARNESS = r"""
#define __host__
#define __device__
#include <cstdio>
#include <vector>
#include "camera_row.cuh"

int main(int argc, char** argv) {
  FILE* f = std::fopen(argv[1], "rb");
  std::vector<float> in;
  float x;
  while (std::fread(&x, sizeof x, 1, f) == 1) in.push_back(x);
  std::fclose(f);
  const size_t n = in.size() / 11;
  std::vector<float> out(n * rt::kCameraRowWords);
  for (size_t i = 0; i < n; ++i)
    rt::camera_row(&in[11 * i], in[11 * i + 10], &out[rt::kCameraRowWords * i]);
  FILE* g = std::fopen(argv[2], "wb");
  std::fwrite(out.data(), sizeof(float), out.size(), g);
  std::fclose(g);
  return 0;
}
"""


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def _fields(camera: Camera):
    return (camera.position, camera.direction, camera.up, camera.fov)


def _flat(camera: Camera) -> torch.Tensor:
    return torch.cat([f.detach().reshape(-1).cpu() for f in _fields(camera)])


def _seeded_cameras(seed: int, n: int):
    g = np.random.default_rng(seed)
    cams = []
    for _ in range(n):
        d = g.normal(size=3)
        u = g.normal(size=3)
        cams.append(Camera.create(g.normal(scale=20.0, size=3), d, u / np.linalg.norm(u),
                                  fov=float(g.uniform(10.0, 120.0))))
    return cams


def _orbit_cameras(seed: int, n: int):
    """The orbit mix's moves: drags of up to +-20 px (70%) or one of w, a,
    s, d, by the controller."""
    g = np.random.default_rng(seed)
    ctrl = CameraController(Camera.create((0.0, 2.0, 12.0), (0.1, -0.1, -1.0)), DEFAULT_CONFIG)
    moves = [dict(forward=1.0), dict(forward=-1.0), dict(strafe=-1.0), dict(strafe=1.0)]
    cams = []
    for _ in range(n):
        if g.random() < 0.7:
            ctrl.rotate(*g.integers(-20, 21, size=2).tolist())
        else:
            ctrl.move(**moves[int(g.integers(0, 4))])
        cams.append(ctrl.camera())
    return cams


CASES = {
    "seeded": lambda: _seeded_cameras(5, 64),
    "orbit": lambda: _orbit_cameras(7, 96),
    # zero right and true_up, no NaN: the row is not normalised
    "parallel_up": lambda: [Camera.create((1.0, 2.0, 3.0), (0.0, 1.0, 0.0)),
                            Camera.create((1.0, 2.0, 3.0), (0.0, -1.0, 0.0)),
                            Camera.create((0.5, -4.0, 2.0), (0.0, 0.6, 0.8), up=(0.0, 0.6, 0.8))],
    "fov": lambda: [Camera.create((0.0, 1.0, 5.0), (0.3, 0.0, -1.0), fov=f)
                    for f in (1.0, 30.0, 59.5, 75.25, 90.0, 170.0)],
}


@pytest.fixture(scope="module")
def row_host(tmp_path_factory):
    """The host build of `camera_row` -> a function of (cameras, fov scales)
    that returns the rows [n,16] f32."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.fail("g++ is needed to build the host camera row")
    d = tmp_path_factory.mktemp("camera_row_host")
    shutil.copy(os.path.join(CSRC, "camera_row.cuh"), d / "camera_row.cuh")
    (d / "row.cpp").write_text(HARNESS)
    exe = d / "row"
    proc = subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-o", str(exe),
                           str(d / "row.cpp")], capture_output=True, text=True, cwd=d)
    assert proc.returncode == 0, proc.stderr[-4000:]

    def rows(cams, scales):
        inp = torch.stack([torch.cat([_flat(c), torch.tensor([s], dtype=torch.float32)])
                           for c, s in zip(cams, scales)])
        inp.numpy().astype(np.float32).tofile(d / "cams.bin")
        subprocess.run([str(exe), str(d / "cams.bin"), str(d / "rows.bin")], check=True)
        return torch.from_numpy(np.fromfile(d / "rows.bin", np.float32).reshape(-1, 16))

    return rows


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_camera_row_equals_the_plain_row_bit_for_bit(row_host, case):
    cams = CASES[case]()
    scales = [c.fov_scale() for c in cams]
    got = row_host(cams, scales)
    want = torch.stack([camera_row(c, s) for c, s in zip(cams, scales)])
    assert got.shape == (len(cams), 16)
    assert torch.equal(_bits(got), _bits(want))
    assert torch.isfinite(got).all()
    if case == "parallel_up":   # right and true_up are zero vectors
        assert (got[:, 6:12] == 0).all()


def test_fov_scale_is_evaluated_again_only_when_the_fov_changes(monkeypatch):
    tables = pack_render_tables(build_default_scene())
    calls = []

    def counting(fov):
        calls.append(fov)
        return tan_half_fov(fov)

    monkeypatch.setattr(render, "tan_half_fov", counting)
    fov0 = tables.fov
    assert tables.fov_scale == tan_half_fov(fov0)
    # a host camera of the same field of view (a new tensor): no tan
    set_camera(tables, Camera.create((1.0, 2.0, 3.0), (0.0, 0.0, -1.0), fov=fov0))
    assert calls == [] and tables.fov == fov0
    # a new value: once, then cached for every camera of that value
    set_camera(tables, Camera.create((1.0, 2.0, 3.0), (0.0, 0.0, -1.0), fov=60.0))
    assert calls == [60.0] and tables.fov == 60.0
    assert tables.fov_scale == Camera.create((0, 0, 0), (0, 0, -1), fov=60.0).fov_scale()
    for pos in ((2.0, 0.0, 1.0), (3.0, 1.0, 0.0)):
        set_camera(tables, Camera.create(pos, (0.3, 0.0, -1.0), fov=60.0))
    assert calls == [60.0]
    # the tables' own fov tensor: taken without reading it (the value
    # cached beside it is not compared)
    tables.fov = math.nan
    own = tables.scene.camera
    set_camera(tables, Camera(own.position + 1.0, own.direction, own.up, own.fov))
    assert calls == [60.0] and math.isnan(tables.fov)
    set_camera(tables, Camera.create((0.0, 0.0, 0.0), (0.0, 0.0, -1.0), fov=fov0))
    assert calls == [60.0, fov0] and tables.fov_scale == tan_half_fov(fov0)
    assert torch.equal(_bits(tables.camera), _bits(camera_row(tables.scene.camera,
                                                              tables.fov_scale)))


def test_cpu_tables_take_the_plain_row():
    """CPU tables: the row rewritten in place by the plain ops, no launch;
    the scene's camera is the new camera's fields."""
    tables = pack_render_tables(build_default_scene())
    row = tables.camera
    launches = LAUNCHES.copy()
    cam = _orbit_cameras(3, 4)[-1]
    set_camera(tables, cam)
    assert LAUNCHES == launches
    assert tables.camera is row
    assert torch.equal(_bits(row), _bits(camera_row(cam, cam.fov_scale())))
    assert all(torch.equal(a, b) for a, b in zip(_fields(tables.scene.camera), _fields(cam)))


def test_kernel_wrapper_refuses_a_camera_field_of_another_size():
    """A field the kernel would read past is refused before any launch."""
    tables = pack_render_tables(build_default_scene())
    cam = Camera.default()
    launches = LAUNCHES["camera_row"]
    for bad in (dict(position=torch.zeros(4)), dict(up=torch.zeros(2)),
                dict(fov=torch.full((2,), 45.0))):
        with pytest.raises(ValueError, match="camera field"):
            render.write_camera_row(tables, dataclasses.replace(cam, **bad), 1.0)
    assert LAUNCHES["camera_row"] == launches


# ---- on the card ----


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _device_camera(camera: Camera, device) -> Camera:
    return Camera(*(f.to(device).clone() for f in _fields(camera)))


def _plain_write_camera_row(tables, camera, fov_scale):
    """The plain version on the card, for `render.write_camera_row`: the
    fields copied into a fresh device camera, the row of PyTorch's ops
    copied into the tables' row."""
    cam = _device_camera(camera, tables.camera.device)
    tables.camera.copy_(camera_row(cam, fov_scale))
    return cam


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["host", "device"])
@pytest.mark.parametrize("textured", [False, True])
def test_set_camera_kernel_writes_the_plain_row_in_place(cuda, textured, source):
    from gpu_raytracer_tpu_torch.engine.renderer import Renderer

    scene = make_courtyard_scene(2000, seed=1, textured=textured, device=cuda)
    r = Renderer(scene, 96, 64, shadows=True, device=cuda)
    r.render_device()
    row, ptr = r.tables.camera, r.tables.camera.data_ptr()
    for i, cam in enumerate(_orbit_cameras(11, 12) + [CASES["fov"]()[3]]):
        held = r.scene.camera
        held_values = _flat(held)
        launches = LAUNCHES["camera_row"]
        new = cam if source == "host" else _device_camera(cam, cuda)
        r.set_camera(new)
        assert LAUNCHES["camera_row"] == launches + 1
        assert r.tables.camera is row and row.data_ptr() == ptr
        want = camera_row(_device_camera(cam, cuda), cam.fov_scale())
        assert torch.equal(_bits(row), _bits(want)), i
        assert r.tables.fov_scale == cam.fov_scale()
        got = r.scene.camera
        assert all(f.device == row.device for f in _fields(got))
        assert torch.equal(_bits(_flat(got)), _bits(_flat(cam)))
        assert all(g.data_ptr() != n.data_ptr() for g, n in zip(_fields(got), _fields(new)))
        assert torch.equal(_bits(_flat(held)), _bits(held_values))   # the old camera kept
    fresh = Renderer(scene.with_camera(cam), 96, 64, shadows=True, device=cuda)
    assert torch.equal(r.render_device(), fresh.render_device())


@pytest.mark.cuda
def test_set_camera_with_the_old_fov_never_waits(cuda):
    """A device camera that keeps the tables' fov tensor, and a host camera:
    nothing read back (sync debug mode "error")."""
    scene = make_courtyard_scene(2000, seed=1, device=cuda)
    tables = pack_render_tables(scene)
    old = tables.scene.camera
    moved = Camera(old.position + 0.5, old.direction, old.up, old.fov)
    host = _orbit_cameras(2, 3)[-1]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        set_camera(tables, moved)
        set_camera(tables, host)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(_bits(tables.camera), _bits(camera_row(_device_camera(host, cuda),
                                                              host.fov_scale())))


@pytest.mark.cuda
def test_device_camera_into_the_temporal_warp_equals_the_plain_path(cuda, monkeypatch):
    from gpu_raytracer_tpu_torch.engine.pathtracer import PathTracer

    scene = make_courtyard_scene(2000, seed=1, device=cuda)
    cams = _orbit_cameras(4, 3)

    def run():
        pt = PathTracer(scene, 64, 64, device=cuda)
        pt.step()
        for cam in cams:
            held = pt.scene.camera
            held_values = _flat(held)
            # the Viewer's path: the renderer's new camera, already on the card
            pt.set_camera(_device_camera(cam, cuda), temporal=True)
            pt.step()
            assert torch.equal(_bits(_flat(held)), _bits(held_values))
        pt.set_camera(pt.scene.camera, temporal=True)   # the tracer's own camera again
        pt.step()
        return pt.image_device(), pt.accum.clone(), pt.tables.render.camera.clone()

    launches = LAUNCHES["camera_row"]
    got = run()
    assert LAUNCHES["camera_row"] == launches + len(cams) + 1
    monkeypatch.setattr(render, "write_camera_row", _plain_write_camera_row)
    want = run()
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))


def _device_ops(prof) -> list:
    """The names of the kernels, copies and memsets a profile saw on the
    device; the spans' annotations on the device's timeline left out."""
    from torch.autograd import DeviceType

    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith(("renderer.", "viewer."))]


@pytest.mark.cuda
def test_a_camera_move_is_one_kernel_launch(cuda):
    """Under torch.profiler: one kernel on the device a move, no copy, no
    memset and no PyTorch kernel; no pinned allocation or copy on the host;
    LAUNCHES counts every move as camera_row, also through the Viewer."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gpu_raytracer_tpu_torch.engine.viewer import Viewer

    scene = make_courtyard_scene(2000, seed=1, device="cpu")
    v = Viewer(scene, 96, 64, shadows=True, verbose=False, device=cuda)
    v.handle_mouse_drag(3.0, 1.0)
    v.run_compute()
    torch.cuda.synchronize()
    moves = []   # the controller's moves: the scene's field of view, so no tan either
    for dx, dy in ((4.0, -1.0), (-7.0, 2.0), (0.0, 0.0), (12.0, 5.0), (-3.0, -3.0)):
        v.controller.rotate(dx, dy)
        v.controller.move(forward=0.5)
        moves.append(v.controller.camera())
    perf.reset()
    launches = LAUNCHES["camera_row"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for cam in moves:
            v.renderer.set_camera(cam)
        torch.cuda.synchronize()
    device_ops = _device_ops(prof)
    assert len(device_ops) == len(moves), device_ops
    assert all("camera_row_kernel" in n for n in device_ops), device_ops
    host_ops = {e.name for e in prof.events() if e.device_type == DeviceType.CPU}
    assert not any(w in n for n in host_ops for w in ("pin_memory", "HostAlloc", "Memcpy",
                                                      "aten::to", "copy_")), host_ops
    assert LAUNCHES["camera_row"] == launches + len(moves)
    perf.reset()
    launches = LAUNCHES["camera_row"]
    # a traced burst of Viewer frames: one row launch a frame
    frames = 6
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(frames):
            if i % 2:
                v.handle_key("w")
            else:
                v.handle_mouse_drag(-4.0, 2.0)
            v.run_compute()
        torch.cuda.synchronize()
    kernels = _device_ops(prof)
    assert sum("camera_row_kernel" in n for n in kernels) == frames, kernels
    assert LAUNCHES["camera_row"] == launches + frames
    perf.reset()


@pytest.mark.cuda
def test_width_8_tables_follow_the_kernel_row(cuda):
    """Width-8 tables take the same launch; K2 w8's pre-pass reads the row."""
    from gpu_raytracer_tpu_torch.config import RaytracerConfig
    from gpu_raytracer_tpu_torch.engine.renderer import Renderer

    scene = make_courtyard_scene(2000, seed=1, config=RaytracerConfig(bvh_width=8), device=cuda)
    r = Renderer(scene, 96, 64, shadows=True, device=cuda)
    r.render_device()
    cam = _orbit_cameras(9, 4)[-1]
    r.set_camera(cam)
    fresh = Renderer(scene.with_camera(cam), 96, 64, shadows=True, device=cuda)
    assert torch.equal(_bits(r.tables.camera), _bits(fresh.tables.camera))
    assert torch.equal(r.render_device(), fresh.render_device())
