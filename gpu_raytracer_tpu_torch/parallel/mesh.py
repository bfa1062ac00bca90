"""A mesh of devices for multi-device rendering, driven by one process.

The JAX package's `parallel/mesh.py` is a 1-D `jax.sharding.Mesh` whose
axis `RAY_AXIS` carries ray batches or geometry under `shard_map`: one
controller drives every device, and its tests run on 8 virtual CPU
devices. This is the same thing in PyTorch: `Mesh` is the ordered list of
the axis' devices, one per shard, and a device may be listed several times
(a virtual mesh: D shards on one card, or on the CPU). Each shard's work
is an ordinary call on its device; the collectives of `parallel/shard.py`
are plain functions over a list of per-shard tensors, which move between
devices with non-blocking copies. No process group is made: a real mesh of
several cards needs only that `torch.cuda` sees them.

`Mesh.replicate` and `Mesh.split` replace `replicated` / `ray_sharded`: one
copy per distinct device, or contiguous blocks, one per shard.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

RAY_AXIS = "rays"


@dataclass(frozen=True)
class Mesh:
    devices: tuple          # torch.device per shard along RAY_AXIS, in order (repeats allowed)

    @property
    def size(self) -> int:
        return len(self.devices)

    def on_devices(self, fn) -> list:
        """[fn(device) for each shard], fn called once per distinct device:
        shards on one device share the result."""
        made = {}
        for dev in self.devices:
            if dev not in made:
                made[dev] = fn(dev)
        return [made[dev] for dev in self.devices]

    def replicate(self, x) -> list:
        """x (a tensor, or anything with `.to(device)`) on every shard's
        device, copied once per distinct device."""
        return self.on_devices(lambda dev: _to(x, dev))

    def split(self, x: torch.Tensor) -> list:
        """Contiguous blocks of x along its first axis, block i on shard i's
        device; the length must divide by the mesh size (pad first)."""
        n = x.shape[0]
        if n % self.size:
            raise ValueError(f"{n} rows do not divide over {self.size} shards")
        blk = n // self.size
        return [_to(x[i * blk:(i + 1) * blk], dev) for i, dev in enumerate(self.devices)]


def _to(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device, non_blocking=True)
    return x.to(device)


def make_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """The mesh of `n_devices` shards. Without `device`: the first
    n_devices CUDA devices (all of them for None); it raises where there are
    fewer, or no CUDA device at all, and never falls back to the CPU. With
    `device` ("cpu", "cuda:0", ...): n_devices virtual shards on that one
    device (one for None)."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"make_mesh(device={str(dev)!r}): no CUDA device is available")
        return Mesh(tuple([dev] * (1 if n_devices is None else int(n_devices))))
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    want = have if n_devices is None else int(n_devices)
    if have == 0 or want > have or want < 1:
        raise RuntimeError(f"make_mesh({n_devices}): {have} CUDA device(s) available; pass "
                           f"device='cpu' (or 'cuda:0') for virtual shards on one device")
    return Mesh(tuple(torch.device("cuda", i) for i in range(want)))


# ---- collectives over per-shard tensors (one per shard, in axis order) ----

def _reduce(xs: list, op) -> torch.Tensor:
    acc = xs[0]
    for x in xs[1:]:
        acc = op(acc, x.to(acc.device, non_blocking=True))
    return acc


def _everywhere(mesh: Mesh, x: torch.Tensor) -> list:
    return mesh.on_devices(lambda dev: x.to(dev, non_blocking=True))


def pmin(mesh: Mesh, xs: list) -> list:
    """Elementwise minimum over the shards, on every shard's device."""
    return _everywhere(mesh, _reduce(xs, torch.minimum))


def psum(mesh: Mesh, xs: list) -> list:
    """Elementwise sum over the shards (in axis order), on every shard's device."""
    return _everywhere(mesh, _reduce(xs, torch.add))


def ppermute_next(mesh: Mesh, xs: list) -> list:
    """Shard i's tensor moved to shard i + 1 (mod the mesh size): the ring
    step of JAX's ppermute with perm [(i, i + 1 mod D)]."""
    D = mesh.size
    return [xs[(i - 1) % D].to(mesh.devices[i], non_blocking=True) for i in range(D)]


def gather(mesh: Mesh, xs: list) -> torch.Tensor:
    """The shards' blocks concatenated in axis order on the first device."""
    return torch.cat([x.to(mesh.devices[0], non_blocking=True) for x in xs])
