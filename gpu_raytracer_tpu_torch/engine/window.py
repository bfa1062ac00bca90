"""The present path into an OS window, through the standard library's Tk.

The reference app presents through a window with a continuous redraw loop:
every redraw runs compute and then a present, and the next redraw is asked
for at once; WASD / space / P / L and left-button drags move the camera.
`NativeWindow` wraps the same `engine/viewer.py::Viewer` the HTTP server
(engine/server.py) and the `fly` command use, in a Tk window:

  * present: one `Viewer.run_compute()` and a PPM-encoded `PhotoImage`
    swap per turn of the event loop, re-armed with `after`;
  * `<KeyPress>` keysyms go to `Viewer.handle_key` (Escape quits);
  * left-drag deltas go to `Viewer.handle_mouse_drag`;
  * a `<Configure>` size change of the toplevel calls `Viewer.resize`.

The Tk module is injectable, so the window logic runs without a display
(tests/test_torch_window.py drives a stand-in); `window_available()` says
whether a display server can be reached.
"""

from __future__ import annotations

import time

import numpy as np

from ..utils.image import to_u8


def window_available(tk=None) -> bool:
    """True when a display server is reachable (a Tk root can be created)."""
    try:
        if tk is None:
            import tkinter as tk  # noqa: F811
        root = tk.Tk()
        root.destroy()
        return True
    except Exception:  # noqa: BLE001: no tkinter, no display (TclError), ...
        return False


def _ppm_bytes(fb: np.ndarray) -> bytes:
    """[H,W,3] frame (linear f32, or already quantised u8) -> binary PPM
    (P6), the raster format Tk's PhotoImage reads without PIL. Float frames
    get the sRGB display encode (utils/image.py::to_u8)."""
    u8 = fb if fb.dtype == np.uint8 else to_u8(fb)
    h, w = u8.shape[:2]
    return b"P6 %d %d 255\n" % (w, h) + u8.tobytes()


class NativeWindow:
    """A Tk window around a `Viewer`.

    viewer: the engine/viewer.py Viewer (compute, camera, progressive
        state), as the server and the CLI use it.
    tk: a tkinter-compatible module (tests pass a stand-in; the standard
        library's tkinter by default).
    max_fps: the present rate's cap (0: none); a frame's compute still
        runs every turn of the event loop."""

    def __init__(self, viewer, tk=None, title: str = "gpu_raytracer_tpu_torch",
                 max_fps: float = 120.0):
        if tk is None:
            import tkinter as tk  # noqa: F811
        self._tk = tk
        self.viewer = viewer
        self.closed = False
        self._min_dt = 1.0 / max_fps if max_fps > 0 else 0.0
        self._last_present = 0.0
        self._drag_last = None
        self._photo = None    # Tk drops an image that nothing references
        self._pending = None  # the previous tick's present handle

        self.root = tk.Tk()
        self.root.title(title)
        self.label = tk.Label(self.root)
        self.label.pack(fill="both", expand=True)
        self.root.geometry(f"{viewer.width}x{viewer.height}")
        self.root.bind("<KeyPress>", self._on_key)
        self.root.bind("<ButtonPress-1>", self._on_press)
        self.root.bind("<B1-Motion>", self._on_drag)
        self.root.bind("<ButtonRelease-1>", self._on_release)
        self.root.bind("<Configure>", self._on_configure)
        self.root.protocol("WM_DELETE_WINDOW", self.close)

    # ---- input ----

    def _on_key(self, event) -> None:
        key = getattr(event, "keysym", "") or ""
        if key:
            self.viewer.handle_key(key)
        if self.viewer.should_quit:           # Escape
            self.close()

    def _on_press(self, event) -> None:
        self._drag_last = (event.x, event.y)

    def _on_drag(self, event) -> None:
        if self._drag_last is None:           # motion without a press
            self._drag_last = (event.x, event.y)
            return
        dx = event.x - self._drag_last[0]
        dy = event.y - self._drag_last[1]
        self._drag_last = (event.x, event.y)
        if dx or dy:
            self.viewer.handle_mouse_drag(float(dx), float(dy))

    def _on_release(self, event) -> None:
        self._drag_last = None

    def _on_configure(self, event) -> None:
        # Configure also fires for child widgets and for moves: resize only
        # on a real size change of the toplevel
        if getattr(event, "widget", self.root) is not self.root:
            return
        w, h = int(getattr(event, "width", 0)), int(getattr(event, "height", 0))
        if w >= 16 and h >= 16 and (w, h) != (self.viewer.width, self.viewer.height):
            self.viewer.resize(w, h)

    # ---- present loop ----

    def tick(self) -> None:
        """One turn of the event loop: compute, present, re-arm."""
        if self.closed:
            return
        if self.viewer.should_quit:
            self.close()
            return
        self.viewer.run_compute()
        self.viewer.perf.update_frame_count()
        now = time.perf_counter()
        if now - self._last_present >= self._min_dt:
            self._present()
            self._last_present = now
        if not self.closed:
            self.root.after(1, self.tick)

    def _present(self) -> None:
        # one frame of pipelining: the previous tick's handle is
        # materialised while this tick's frame computes; the first tick
        # shows its own
        nxt = self.viewer.present_frame_packed()
        fb = self.viewer.materialize_frame(self._pending if self._pending is not None else nxt)
        self._pending = nxt
        self._photo = self._tk.PhotoImage(data=_ppm_bytes(fb))
        self.label.configure(image=self._photo)

    def run(self) -> None:
        """The blocking event loop."""
        self.root.after(0, self.tick)
        self.root.mainloop()

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        try:
            self.root.destroy()
        except Exception:  # noqa: BLE001: a window the display already closed
            pass
