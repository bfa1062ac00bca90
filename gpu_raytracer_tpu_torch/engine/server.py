"""The live viewer over HTTP: the reference app's windowed event loop,
headless, in any browser.

Frames stream as a `multipart/x-mixed-replace` PNG stream and key and mouse
events come back as POST requests. The render loop, camera controller,
progressive schedule and counters are the `engine/viewer.py::Viewer`'s: on a
CUDA device each frame is one K2 launch (K3 + K4 on a textured scene, K6
after the `p` key); the server only adds transport.

    python -m gpu_raytracer_tpu_torch serve --courtyard 100000 --shadows --port 8642
    # then open http://127.0.0.1:8642/

Endpoints: `/` (the page), `/stream` (the PNG stream), POST `/key?k=w`,
`/drag?dx=..&dy=..`, `/resize?w=..&h=..`, GET `/stats` (JSON: fps, frame
ms, camera position).

One producer thread renders, whatever the number of `/stream` clients, and
parks while there are none; clients read the latest encoded frame. Every
viewer call (the producer's frames, the handlers' keys) runs under one lock,
so all device work of the server is serialised on the device's default
stream.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from ..utils.image import encode_png

_PAGE = """<!doctype html>
<html><head><title>gpu_raytracer_tpu_torch</title><style>
body { background:#111; color:#ddd; font-family:monospace; margin:0 }
#hud { padding:6px 10px } img { display:block; margin:auto;
image-rendering:pixelated; outline:none }
</style></head><body>
<div id="hud">gpu_raytracer_tpu_torch &mdash; WASD move &middot; drag to look &middot;
P path-trace &middot; Esc quit &middot; <span id="stats"></span></div>
<img id="v" src="/stream" tabindex="0">
<script>
const send = (p) => fetch(p, {method: "POST"});
document.addEventListener("keydown", (e) => {
  const k = e.key === " " ? "space" : e.key;
  send("/key?k=" + encodeURIComponent(k));
});
let drag = null;
const img = document.getElementById("v");
img.addEventListener("mousedown", (e) => { drag = [e.clientX, e.clientY]; });
document.addEventListener("mouseup", () => { drag = null; });
document.addEventListener("mousemove", (e) => {
  if (!drag) return;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
  drag = [e.clientX, e.clientY];
  if (dx || dy) send(`/drag?dx=${dx}&dy=${dy}`);
});
setInterval(async () => {
  const s = await (await fetch("/stats")).json();
  document.getElementById("stats").textContent =
    `${s.fps.toFixed(1)} fps  ${s.frame_ms.toFixed(1)} ms  ` +
    `cam ${s.camera.map(v => v.toFixed(1)).join(",")}`;
}, 1000);
let rs = null;   // debounced window resize -> /resize
window.addEventListener("resize", () => {
  clearTimeout(rs);
  rs = setTimeout(() => {
    const w = Math.max(64, Math.floor(window.innerWidth / 64) * 64);
    const h = Math.max(64, Math.floor((window.innerHeight - 40) / 64) * 64);
    send(`/resize?w=${w}&h=${h}`);
  }, 400);
});
</script></body></html>"""

BOUNDARY = b"tpuframe"
STOP_TIMEOUT_S = 10.0   # stop() waits this long for each thread it started


class ViewerServer:
    """Wraps a `Viewer` in a threaded HTTP server (standard library only).
    `port=0` takes a free port; `host` and `port` say which was bound."""

    def __init__(self, viewer, host: str = "127.0.0.1", port: int = 8642,
                 max_fps: float = 30.0):
        self.viewer = viewer
        self.max_fps = max_fps
        self._lock = threading.Lock()     # serialises viewer access
        self._frame_ms = 0.0
        self._fps = 0.0
        # the producer publishes under _cond: _seq counts encoded frames,
        # _latest holds the newest PNG, _clients the connected streams
        self._cond = threading.Condition()
        self._clients = 0
        self._seq = 0
        self._latest: bytes | None = None
        self._producer: threading.Thread | None = None
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _json(self, obj, code=200):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                u = urlparse(self.path)
                q = parse_qs(u.query)
                with server._lock:
                    if u.path == "/key":
                        server.viewer.handle_key(q.get("k", [""])[0])
                    elif u.path == "/drag":
                        server.viewer.handle_mouse_drag(float(q.get("dx", ["0"])[0]),
                                                        float(q.get("dy", ["0"])[0]))
                    elif u.path == "/resize":
                        server.viewer.resize(int(q.get("w", ["0"])[0]),
                                             int(q.get("h", ["0"])[0]))
                    else:
                        return self._json({"err": "unknown"}, 404)
                self._json({"ok": True})

            def do_GET(self):
                u = urlparse(self.path)
                if u.path == "/":
                    body = _PAGE.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif u.path == "/stats":
                    with server._lock:
                        cam = [float(x) for x in server.viewer.controller.position]
                    self._json({"fps": server._fps, "frame_ms": server._frame_ms,
                                "camera": cam})
                elif u.path == "/stream":
                    self.send_response(200)
                    self.send_header("Content-Type", "multipart/x-mixed-replace; boundary="
                                     + BOUNDARY.decode())
                    self.end_headers()
                    try:
                        server._stream(self.wfile)
                    except (BrokenPipeError, ConnectionResetError):
                        pass
                else:
                    self._json({"err": "unknown"}, 404)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: threading.Thread | None = None
        self._serving = False   # serve_forever entered: shutdown() then returns

    def _produce(self) -> None:
        """The render loop (one per server): a frame computed under the lock,
        encoded once and handed to every connected /stream client. Parks
        while no client is connected. A failure stops the server's loops
        (should_quit) and is raised in this thread."""
        min_dt = 1.0 / self.max_fps
        last = None
        pending = None      # the previous frame's present handle
        try:
            while not self.viewer.should_quit:
                with self._cond:
                    if self._clients == 0:
                        last = None                 # the rate window restarts
                        pending = None              # and the pipeline
                        self._cond.wait(timeout=0.25)
                        continue
                t0 = time.perf_counter()
                if last is not None:                # presented loop-to-loop rate
                    self._fps = 1.0 / max(t0 - last, 1e-6)
                last = t0
                with self._lock:
                    self.viewer.run_compute()
                    self.viewer.perf.update_frame_count()
                    nxt = self.viewer.present_frame_packed()
                # one frame of present pipelining: the previous frame's
                # handle is materialised while this one computes; the first
                # frame after a connect shows itself
                frame = self.viewer.materialize_frame(pending if pending is not None else nxt)
                pending = nxt
                png = encode_png(frame, level=1)    # speed over size
                dt = time.perf_counter() - t0
                self._frame_ms = dt * 1e3
                with self._cond:
                    self._seq += 1
                    self._latest = png
                    self._cond.notify_all()
                if dt < min_dt:
                    time.sleep(min_dt - dt)
        except BaseException:
            self.viewer.should_quit = True
            raise
        finally:
            with self._cond:                        # release waiting clients
                self._cond.notify_all()

    def _stream(self, wfile) -> None:
        """One /stream client: waits for the producer's frames and writes
        each as a PNG part. Starts the producer if none is running."""
        with self._cond:
            self._clients += 1
            if self._producer is None or not self._producer.is_alive():
                self._producer = threading.Thread(target=self._produce, daemon=True,
                                                  name="viewer-producer")
                self._producer.start()
            self._cond.notify_all()
        seen = -1
        try:
            while not self.viewer.should_quit:
                with self._cond:
                    self._cond.wait_for(lambda: self._seq != seen or self.viewer.should_quit,
                                        timeout=1.0)
                    if self._seq == seen:
                        continue
                    seen, png = self._seq, self._latest
                if png is None:
                    continue
                wfile.write(b"--" + BOUNDARY + b"\r\n"
                            b"Content-Type: image/png\r\n"
                            b"Content-Length: " + str(len(png)).encode()
                            + b"\r\n\r\n" + png + b"\r\n")
                wfile.flush()
        finally:
            with self._cond:
                self._clients -= 1

    def start(self) -> None:
        """Serve from a background thread."""
        self._serving = True
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True,
                                        name="viewer-http")
        self._thread.start()

    def stop(self) -> None:
        """Quit the viewer, close the listening socket and wait for the
        producer and the serving thread (STOP_TIMEOUT_S each). Connected
        streams end within a second."""
        self.viewer.should_quit = True
        with self._cond:
            self._cond.notify_all()
        if self._serving:
            self._httpd.shutdown()
            self._serving = False
        self._httpd.server_close()
        for t in (self._producer, self._thread):
            if t is not None and t is not threading.current_thread():
                t.join(timeout=STOP_TIMEOUT_S)

    def serve_forever(self) -> None:
        print(f"serving http://{self.host}:{self.port}/  (Esc in the page quits)", flush=True)
        self._serving = True
        try:
            self._httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()
