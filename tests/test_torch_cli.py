"""`python -m gpu_raytracer_tpu_torch render` and `pathtrace` write a PNG of
the frame; `export` writes a GLB that `render --gltf`, `pathtrace --gltf` and
`info` read back."""

import os
import struct
import subprocess
import sys

import pytest

import torch_bridge  # noqa: F401  (thread cap)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, tmp_path, command="render"):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-m", "gpu_raytracer_tpu_torch", command, *args],
                          capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)


def _png_size(path):
    data = path.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    return struct.unpack(">II", data[16:24])


@pytest.mark.parametrize("scene_args", [["--courtyard", "2000", "--shadows"], ["--demo"],
                                        ["--courtyard", "2000", "--textured"]])
def test_render_writes_a_png(tmp_path, scene_args):
    out = tmp_path / "frame.png"
    proc = _run([*scene_args, "--width", "64", "--height", "48", "--device", "cpu",
                 "-o", str(out)], tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert _png_size(out) == (64, 48)
    assert "wrote" in proc.stdout


def test_pathtrace_writes_a_png_and_resumes(tmp_path):
    out, ckpt = tmp_path / "pt.png", tmp_path / "pt.npz"
    args = ["--courtyard", "500", "--width", "16", "--height", "12", "--spp", "2", "--spectral",
            "--device", "cpu", "--checkpoint", str(ckpt), "-o", str(out)]
    proc = _run(args, tmp_path, "pathtrace")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert _png_size(out) == (16, 12)
    assert "(2 spp)" in proc.stdout and ckpt.exists()
    proc = _run([*args, "--resume", str(ckpt)], tmp_path, "pathtrace")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "resumed at 2 spp" in proc.stdout and "(4 spp)" in proc.stdout


@pytest.mark.parametrize("mode", [["--denoise", "--denoise-iters", "2"],
                                  ["--adaptive", "2", "--denoise"]])
def test_pathtrace_denoise_and_adaptive(tmp_path, mode):
    out = tmp_path / "pt.png"
    proc = _run(["--courtyard", "500", "--width", "128", "--height", "64", "--spp", "2",
                 *mode, "--device", "cpu", "-o", str(out)], tmp_path, "pathtrace")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert _png_size(out) == (128, 64)
    iters = mode[mode.index("--denoise-iters") + 1] if "--denoise-iters" in mode else "4"
    assert f"denoised ({iters} a-trous iterations)" in proc.stdout
    # adaptive: 2 steps of 2 tiles of the 2 make 2 samples per pixel on average
    assert ("(2.0 spp)" if "--adaptive" in mode else "(2 spp)") in proc.stdout


def test_render_refuses_unported_scenes(tmp_path):
    """BVH width 8 renders; a glTF file that does not load is not refused
    either: the default scene is rendered and the message says why."""
    proc = _run(["--courtyard", "500", "--bvh-width", "8", "--width", "16", "--height", "12",
                 "--device", "cpu", "-o", "w8.png"], tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert _png_size(tmp_path / "w8.png") == (16, 12)
    proc = _run(["--gltf", "absent.glb", "--width", "16", "--height", "12", "--device", "cpu",
                 "-o", "x.png"], tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "Failed to load glTF scene 'absent.glb'" in proc.stderr
    assert "using default scene" in proc.stderr and _png_size(tmp_path / "x.png") == (16, 12)


W8, SBVH = ["--bvh-width", "8"], ["--bvh-spatial-splits", "true"]


@pytest.mark.parametrize("command, bvh", [("render", W8), ("render", SBVH),
                                          ("render", W8 + SBVH), ("pathtrace", W8 + SBVH),
                                          ("fly", W8 + SBVH)])
def test_commands_take_width8_and_spatial_splits(tmp_path, command, bvh):
    """render builds the width-8 and the spatial-split BVH, alone and
    together; pathtrace and fly build both together; each writes its frames."""
    out = tmp_path / ("frames" if command == "fly" else "x.png")
    extra = {"render": ["--shadows"], "pathtrace": ["--spp", "1"],
             "fly": ["--script", "w d", "--shadows"]}[command]
    proc = _run(["--courtyard", "500", *bvh, "--width", "16", "--height", "12", *extra,
                 "--device", "cpu", "-o", str(out)], tmp_path, command)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    if command == "fly":
        assert sorted(os.listdir(out)) == ["frame_0000.png", "frame_0001.png"]
        assert _png_size(out / "frame_0001.png") == (16, 12)
    else:
        assert _png_size(out) == (16, 12)


@pytest.fixture(scope="module")
def exported_glb(tmp_path_factory):
    d = tmp_path_factory.mktemp("glb")
    proc = _run(["--courtyard", "2000", "--textured", "-o", "court.glb"], d, "export")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "wrote court.glb" in proc.stdout and "triangles)" in proc.stdout
    return d


def test_export_writes_a_glb(exported_glb):
    data = (exported_glb / "court.glb").read_bytes()
    assert data[:4] == b"glTF" and struct.unpack("<I", data[8:12])[0] == len(data)


def test_render_gltf_equals_the_procedural_render(exported_glb):
    for args, out in ((["--gltf", "court.glb"], "glb.png"),
                      (["--courtyard", "2000", "--textured"], "proc.png")):
        proc = _run([*args, "--width", "64", "--height", "48", "--shadows", "--device", "cpu",
                     "-o", out], exported_glb)
        assert proc.returncode == 0, proc.stdout + proc.stderr
    assert (exported_glb / "glb.png").read_bytes() == (exported_glb / "proc.png").read_bytes()


def test_info_lists_the_file(exported_glb):
    proc = _run(["--gltf", "court.glb"], exported_glb, "info")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "cameras: ['camera_0']" in proc.stdout and "lights:  ['light_0', 'light_1']" in proc.stdout
    assert "materials=5 lights=2 images=3" in proc.stdout
    proc = _run(["--gltf", "absent.glb"], exported_glb, "info")
    assert proc.returncode == 1 and "error: cannot read absent.glb" in proc.stderr


def test_export_repacks_a_loaded_gltf_and_pathtrace_reads_it(exported_glb):
    proc = _run(["--gltf", "court.glb", "-o", "again.glb"], exported_glb, "export")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    # the loader re-orders vertices per primitive, so the bytes differ; the content does not
    summary = [_run(["--gltf", name], exported_glb, "info").stdout
               for name in ("court.glb", "again.glb")]
    assert summary[0] == summary[1] and "triangles=" in summary[0]
    proc = _run(["--gltf", "again.glb", "--width", "16", "--height", "12", "--spp", "1",
                 "--device", "cpu", "-o", "pt.png"], exported_glb, "pathtrace")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert _png_size(exported_glb / "pt.png") == (16, 12)


@pytest.mark.parametrize("flags", [["--adaptive", "4"], ["--denoise"]])
def test_pathtrace_refuses_unported_options(tmp_path, flags):
    """Both options are ported: on an 8x8 frame --denoise runs, and
    --adaptive refuses the frame (not whole 64x64 tiles) as the JAX CLI
    does, with a ValueError, not NotImplementedError."""
    proc = _run([*flags, "--width", "8", "--height", "8", "--device", "cpu", "-o", "x.png"],
                tmp_path, "pathtrace")
    assert "NotImplementedError" not in proc.stderr
    if "--adaptive" in flags:
        assert proc.returncode != 0 and "ValueError" in proc.stderr
        assert "whole 64x64 tiles" in proc.stderr
    else:
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert _png_size(tmp_path / "x.png") == (8, 8)


def test_serve_runs_the_http_viewer(monkeypatch, capsys):
    """`serve` builds the Viewer, renders its first frame and serves it: the
    page, /stats and a key answer over HTTP (serve_forever stands in for a
    browser's visit here)."""
    import json
    import urllib.request

    from gpu_raytracer_tpu_torch.__main__ import main
    from gpu_raytracer_tpu_torch.engine.server import ViewerServer

    seen = {}

    def visit(self):
        self.start()
        try:
            seen["frames"] = self.viewer.perf.frame_count, self.viewer.progressive.complete
            base = f"http://{self.host}:{self.port}"
            seen["page"] = urllib.request.urlopen(base + "/", timeout=30).read()
            req = urllib.request.Request(base + "/key?k=w", method="POST")
            seen["key"] = json.loads(urllib.request.urlopen(req, timeout=30).read())
            seen["stats"] = json.loads(urllib.request.urlopen(base + "/stats", timeout=30).read())
        finally:
            self.stop()
        seen["size"] = (self.viewer.width, self.viewer.height, self.viewer.shadows,
                        self.max_fps, self.host, self.viewer.device.type)

    monkeypatch.setattr(ViewerServer, "serve_forever", visit)
    main(["serve", "--demo", "--width", "32", "--height", "16", "--shadows", "--port", "0",
          "--max-fps", "12", "--device", "cpu"])
    assert seen["size"] == (32, 16, True, 12.0, "127.0.0.1", "cpu")
    assert seen["frames"][1]                        # the first frame came before serving
    assert b"/stream" in seen["page"] and seen["key"] == {"ok": True}
    assert seen["stats"]["camera"][2] < 5.0         # 'w' moved the camera forward


def test_window_runs_and_exits_without_a_display(monkeypatch, capsys):
    """`window` exits 1 with the JAX package's message where no Tk root can
    be made, and runs the Tk loop where one can (a stand-in module)."""
    import sys
    import types

    from gpu_raytracer_tpu_torch.__main__ import main

    class Dead:
        @staticmethod
        def Tk():
            raise RuntimeError("no display")

    monkeypatch.setitem(sys.modules, "tkinter", Dead)
    with pytest.raises(SystemExit) as e:
        main(["window", "--demo", "--width", "16", "--height", "16", "--device", "cpu"])
    assert e.value.code == 1
    assert "no display server reachable" in capsys.readouterr().err

    ticks = []

    class Root:
        def __init__(self):
            self.queue = []

        def __getattr__(self, name):       # title, geometry, bind, protocol, pack, configure
            return lambda *a, **kw: None

        def after(self, ms, fn):
            self.queue.append(fn)

        def mainloop(self):
            while self.queue and len(ticks) < 3:
                ticks.append(1)
                self.queue.pop(0)()

    photos = []
    fake = types.SimpleNamespace(Tk=Root, Label=lambda root: Root(),
                                 PhotoImage=lambda data: photos.append(data) or data)
    monkeypatch.setitem(sys.modules, "tkinter", fake)
    main(["window", "--demo", "--width", "16", "--height", "8", "--max-fps", "0",
          "--device", "cpu"])
    assert len(ticks) == 3 and len(photos) == 3
    assert all(p.startswith(b"P6 16 8 255\n") for p in photos)


@pytest.mark.parametrize("command", ["serve", "window"])
def test_serve_and_window_need_a_card_by_default(command, monkeypatch):
    """--device cuda is the default: without a CUDA device the command
    raises instead of serving from the CPU."""
    import sys
    import types

    import torch

    from gpu_raytracer_tpu_torch.__main__ import main

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the command would serve")
    monkeypatch.setitem(sys.modules, "tkinter", types.SimpleNamespace(
        Tk=lambda: types.SimpleNamespace(destroy=lambda: None)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([command, "--demo", "--width", "16", "--height", "16"])
