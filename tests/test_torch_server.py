"""The port's HTTP live viewer (engine/server.py) on the CPU: the five cases
of the JAX package's tests/test_server.py on a 64x64 default-scene Viewer,
then a streamed frame against the JAX server's for the same scene and the
same requests, and the producer's one-render-per-frame rule.

Every request has a timeout and every server is stopped by its fixture. The
streamed frames are held to their own Viewer's `framebuffer_u8` bit for bit;
the two servers' frames are equal outside the counted rounding-sensitive
pixels of tests/test_torch_viewer.py (at most 1% of a frame), and within one
count of each other there (the float frames differ by at most 1e-5)."""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from torch_bridge import (f16_attenuation_flips, port_scene_from_jax,
                          rounding_sensitive_pixels)

from gpu_raytracer_tpu.engine.server import ViewerServer as JaxViewerServer
from gpu_raytracer_tpu.engine.viewer import Viewer as JaxViewer
from gpu_raytracer_tpu.models.scene import build_default_scene as jax_default
from gpu_raytracer_tpu_torch.engine import server as server_module
from gpu_raytracer_tpu_torch.engine.server import BOUNDARY, ViewerServer
from gpu_raytracer_tpu_torch.engine.viewer import Viewer
from gpu_raytracer_tpu_torch.models.gltf import decode_png
from gpu_raytracer_tpu_torch.models.scene import build_default_scene
from gpu_raytracer_tpu_torch.ops.camera_rays import generate_rays
from gpu_raytracer_tpu_torch.ops.trace import trace

TIMEOUT = 30   # seconds, every request and every wait
MAX_COUNTED_SHARE = 0.01


def _serve(viewer, cls=ViewerServer, **kw):
    viewer.run_compute()
    s = cls(viewer, port=0, **kw)
    s.start()
    return s


@pytest.fixture(scope="module")
def server():
    s = _serve(Viewer(build_default_scene(), 64, 64, shadows=False, verbose=False,
                      device="cpu"), max_fps=60)
    yield s
    s.stop()


def _url(server, path):
    return f"http://{server.host}:{server.port}{path}"


def _get(server, path):
    return urllib.request.urlopen(_url(server, path), timeout=TIMEOUT)


def _post(server, path):
    req = urllib.request.Request(_url(server, path), method="POST")
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        return json.loads(r.read())


def _wait_for(cond, what):
    t0 = time.perf_counter()
    while not cond():
        assert time.perf_counter() - t0 < TIMEOUT, f"timed out waiting for {what}"
        time.sleep(0.01)


def _read_part(resp) -> bytes:
    """One PNG part of a multipart stream."""
    assert resp.readline() == b"--" + BOUNDARY + b"\r\n"
    length = None
    while True:
        line = resp.readline()
        if line == b"\r\n":
            break
        name, _, value = line.decode().partition(":")
        if name.lower() == "content-length":
            length = int(value)
    png = resp.read(length)
    assert resp.read(2) == b"\r\n"
    return png


def test_page_and_stats(server):
    page = _get(server, "/").read()
    assert b"/stream" in page and b"gpu_raytracer_tpu_torch" in page
    stats = json.loads(_get(server, "/stats").read())
    assert set(stats) == {"fps", "frame_ms", "camera"}
    assert len(stats["camera"]) == 3


def test_key_moves_camera(server):
    z0 = json.loads(_get(server, "/stats").read())["camera"][2]
    assert _post(server, "/key?k=w")["ok"]
    z1 = json.loads(_get(server, "/stats").read())["camera"][2]
    assert z1 < z0    # the default camera looks down -Z; 'w' moves forward


def test_stream_emits_png_frames(server):
    with _get(server, "/stream") as resp:
        assert "multipart/x-mixed-replace" in resp.headers["Content-Type"]
        png = _read_part(resp)
    assert png.startswith(b"\x89PNG\r\n\x1a\n")
    assert decode_png(png).shape[:2] == (server.viewer.height, server.viewer.width)


def test_resize_endpoint(server):
    assert _post(server, "/resize?w=48&h=32")["ok"]
    assert (server.viewer.width, server.viewer.height) == (48, 32)
    with server._lock:
        server.viewer.run_compute()
        assert server.viewer.framebuffer.shape == (32, 48, 3)


def test_second_stream_client_shares_one_render_loop(server):
    """Two /stream clients do not double-advance the viewer: the one
    producer feeds both."""
    a = _get(server, "/stream")
    b = _get(server, "/stream")
    try:
        assert _read_part(a) and _read_part(b)
        assert server._producer is not None and server._producer.is_alive()
        _wait_for(lambda: server._clients == 2, "two clients")
        names = [t.name for t in threading.enumerate()]
        assert names.count("viewer-producer") == 1
    finally:
        a.close()
        b.close()


def test_unknown_path_is_404(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, "/nothing")
    assert e.value.code == 404


def _counted(ps, W, H):
    py, px = torch.meshgrid(torch.arange(H, dtype=torch.int32),
                            torch.arange(W, dtype=torch.int32), indexing="ij")
    o, d = generate_rays(ps.camera, W, H, px.reshape(-1), py.reshape(-1))
    flips = f16_attenuation_flips(ps, trace(ps, o, d)).reshape(H, W)
    return flips | rounding_sensitive_pixels(ps, W, H)


def _settled_frame(server) -> bytes:
    """The PNG a new client gets once the camera stands still and the frame
    is complete: two frames later the pipelined present shows it."""
    def complete():
        with server._lock:
            return server.viewer.progressive.complete
    _wait_for(complete, "a complete frame")
    seq = server._seq
    _wait_for(lambda: server._seq >= seq + 2, "two more frames")
    with _get(server, "/stream") as resp:
        return _read_part(resp)


def test_stream_frame_matches_the_jax_server():
    """The same scene, the same requests to both servers: the PNG parts
    decode to each Viewer's framebuffer_u8 and agree with each other."""
    js = jax_default()
    W = H = 64
    servers = [_serve(JaxViewer(js, W, H, verbose=False), JaxViewerServer, max_fps=60),
               _serve(Viewer(port_scene_from_jax(js), W, H, verbose=False, device="cpu"),
                      max_fps=60)]
    clients = []
    try:
        frames = []
        for s in servers:
            clients.append(_get(s, "/stream"))   # keeps the producer running
            for path in ("/key?k=w", "/drag?dx=20&dy=-6", "/key?k=d"):
                assert _post(s, path)["ok"]
            png = _settled_frame(s)
            with s._lock:
                want = np.asarray(s.viewer.framebuffer_u8)
            got = decode_png(png)[..., :3]
            assert np.array_equal(got, want)
            frames.append(got)
        jax_frame, frame = frames
        counted = _counted(servers[1].viewer.scene, W, H)
        assert counted.sum() <= MAX_COUNTED_SHARE * counted.size
        diff = np.abs(frame.astype(int) - jax_frame.astype(int)).max(axis=-1)
        assert (diff[~counted] == 0).all() and diff.max() <= 1
        assert frame.max() > 0
    finally:
        for c in clients:
            c.close()
        for s in servers:
            s.stop()


def test_producer_renders_once_per_frame_and_stop_joins():
    """With the camera moving every frame, each produced frame renders once
    (one pass of the plain render over the frame's one tile), whatever the
    number of clients; stop() ends the producer and the serving thread."""
    v = Viewer(build_default_scene(), 32, 32, verbose=False, device="cpu")
    renders = []
    render_rays = v.renderer.render_rays
    run_compute = v.run_compute

    def moving_frame():
        v.handle_key("w" if len(renders) % 2 else "s")
        return run_compute()

    s = _serve(v, max_fps=200)
    v.renderer.render_rays = lambda *a, **kw: renders.append(1) or render_rays(*a, **kw)
    v.run_compute = moving_frame
    a, b = _get(s, "/stream"), _get(s, "/stream")
    try:
        for _ in range(3):
            _read_part(a)
            _read_part(b)
        with s._lock:   # at most one frame computed and not yet published
            n_renders, seq = len(renders), s._seq
        assert seq >= 3 and seq <= n_renders <= seq + 1
    finally:
        a.close()
        b.close()
        t0 = time.perf_counter()
        s.stop()
    assert time.perf_counter() - t0 < server_module.STOP_TIMEOUT_S
    assert not s._producer.is_alive() and not s._thread.is_alive()
