"""The general traffic generator: one mix file's parameters and a seed in,
the inputs of a run out. Every mix of every driver kind goes through here;
a new mix is a new data file (traffic/<mix>.json), not new code."""

from __future__ import annotations

import math

import numpy as np

MASK64 = (1 << 64) - 1


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent generator per (run seed, stream): the same pair gives
    the same numbers, any whole seed (negative or past 64 bits) included."""
    return np.random.default_rng([int(seed) & MASK64, (int(seed) >> 64) & MASK64, stream])


def torch_seed(seed: int, stream: int) -> int:
    """A torch.Generator seed from (run seed, stream)."""
    return int(rng(seed, stream).integers(0, 2 ** 63 - 1))


INPUTS, PIXELS, FRAMES, PATHS, SCENE, CONTROL = range(6)    # the streams


def scene_seed(seed: int) -> int:
    """The scene generator's seed of a run."""
    return int(rng(seed, SCENE).integers(0, 2 ** 31 - 1))


DRAWS = 1024      # camera inputs' random numbers drawn at once (a fraction of a millisecond)


class CameraInputs:
    """The camera inputs of a run, one a frame, each made when the run first
    asks for it (a few microseconds: no frame waits for a batch of inputs):
    a mouse drag of up to +-drag_px in x and y (share drag_share), else one
    of the keys w, a, s, d. The inputs keep the camera inside the courtyard
    (|x|, |z| <= keep * extent, y in y_band) and its pitch in pitch_band: a
    drag that would leave the band pulls back into it, a key that would
    leave the box is swapped for its opposite. Decided on a float64 copy of
    the controller (reference.py replays the inputs in float32). The same
    seed gives the same inputs."""

    def __init__(self, seed: int, position, direction, extent: float, mix: dict,
                 speed: float, sens: float):
        self.g = rng(seed, INPUTS)
        self.mix, self.speed, self.sens = mix, speed, sens
        self.keep = mix["keep"] * extent
        self.pos = [float(x) for x in position]
        d = np.asarray(direction, np.float64)
        self.d = list(d / np.linalg.norm(d))
        self.events = []
        self.drawn = 0

    def __getitem__(self, i: int):
        while i >= len(self.events):
            self.events.append(self._next())
        return self.events[i]

    def _draw(self) -> None:
        g, mix = self.g, self.mix
        self.kind = g.random(DRAWS).tolist()
        self.dxy = g.integers(-mix["drag_px"], mix["drag_px"] + 1, size=(DRAWS, 2)).tolist()
        self.keys = g.integers(0, 4, size=DRAWS).tolist()
        self.drawn = 0

    def _next(self):
        if self.drawn in (0, DRAWS):
            self._draw()
        mix, k = self.mix, self.drawn
        self.drawn += 1
        y_lo, y_hi = mix["y_band"]
        p_lo, p_hi = mix["pitch_band"]
        pos, d, speed = self.pos, self.d, self.speed
        if self.kind[k] < mix["drag_share"]:
            dx, dy = self.dxy[k]
            if d[1] > p_hi:
                dy = abs(dy)          # drag down: the pitch falls
            elif d[1] < p_lo:
                dy = -abs(dy)
            yaw, pitch = -dx * self.sens, -dy * self.sens
            c, s = math.cos(yaw), math.sin(yaw)
            x, y, z = d
            nd = [x * c - z * s, max(-0.99, min(0.99, y + pitch)), x * s + z * c]
            nn = math.sqrt(sum(v * v for v in nd))
            self.d = [v / nn for v in nd]
            return ("drag", dx, dy)
        key = "wasd"[self.keys[k]]
        for attempt in (key, {"w": "s", "s": "w", "a": "d", "d": "a"}[key]):
            fwd = {"w": 1.0, "s": -1.0}.get(attempt, 0.0)
            strafe = {"d": 1.0, "a": -1.0}.get(attempt, 0.0)
            rx, rz = -d[2], d[0]                    # direction x up, up = +y
            rn = math.hypot(rx, rz) or 1.0
            p = [pos[0] + d[0] * fwd * speed + rx / rn * strafe * speed,
                 pos[1] + d[1] * fwd * speed,
                 pos[2] + d[2] * fwd * speed + rz / rn * strafe * speed]
            if abs(p[0]) <= self.keep and abs(p[2]) <= self.keep and y_lo <= p[1] <= y_hi:
                break
        self.pos = p
        return ("key", attempt)


def pick_pixels(seed: int, stream: int, n: int, width: int, height: int):
    """`n` distinct pixels of a width x height frame -> (px, py) int64."""
    flat = rng(seed, stream).choice(width * height, size=n, replace=False)
    return flat % width, flat // width


def frame_picks(seed: int, first: int, expected: int, count: int) -> set:
    """The window's frames to compare: `count` drawn from the seed among
    frame numbers first .. first + expected - 1 (those the window reaches
    are kept)."""
    g = rng(seed, FRAMES)
    return set(int(x) for x in first + g.choice(expected, size=min(count, expected),
                                                 replace=False))
