"""A stand-in for the part of tkinter that engine/window.py uses, so the
window's logic runs without a display: tests/test_torch_window.py and
chip_smoke.py's window phase drive `NativeWindow(viewer, tk=FakeTk)`."""


class FakeWidget:
    def __init__(self, *a, **kw):
        self.config_calls = []

    def pack(self, **kw):
        pass

    def configure(self, **kw):
        self.config_calls.append(kw)


class FakeRoot(FakeWidget):
    def __init__(self, *a, **kw):
        super().__init__()
        self.bindings = {}
        self.after_queue = []
        self.destroyed = False
        self._title = None

    def title(self, t):
        self._title = t

    def geometry(self, g):
        self._geometry = g

    def bind(self, seq, fn):
        self.bindings[seq] = fn

    def protocol(self, name, fn):
        self.bindings[name] = fn

    def after(self, ms, fn):
        self.after_queue.append(fn)

    def mainloop(self):
        # run queued callbacks until the queue drains or the window dies
        for _ in range(1000):
            if self.destroyed or not self.after_queue:
                return
            self.after_queue.pop(0)()

    def destroy(self):
        self.destroyed = True
        self.after_queue.clear()


class FakePhoto:
    last_data = None

    def __init__(self, data=None):
        FakePhoto.last_data = data
        self.data = data


class FakeTk:
    """Module-shaped namespace matching the tkinter surface window.py uses."""
    Tk = FakeRoot
    Label = FakeWidget
    PhotoImage = FakePhoto
