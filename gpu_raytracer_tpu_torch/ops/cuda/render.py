"""K2 and K2t (fused primary render, untextured and textured) and K3 (deferred
trace), one pixel per thread (CUDA).

K2 replaces the TPU kernel `gpu_raytracer_tpu/ops/pallas/render.py`
(`pallas_render_primary` -> `_kernel`, untextured branch). Kernel source:
csrc/render_primary.cuh, instantiated in csrc/render_primary.cu, which calls
K1's device function (csrc/traverse.cuh) for the primary ray and for one
shadow ray per light. Its plain version is `ops/render.py::render_chunk`.

K2t replaces the textured branch of the same TPU kernel: the same kernel
template with the hit's uv, its mip footprint and the material sampled from
the atlas at the nearest mip of that footprint (csrc/texsample.cuh), in one
launch with no G-buffer; instantiated in csrc/render_primary_textured.cu.
Its plain version is `render_chunk` on the textured scene (`trilinear=False`).
`render_primary` launches it for a textured scene.

Every launch takes the instance of the node table's width (4 or 8,
`TraceTables.width`), counted apart in build.py's LAUNCHES: k2 and k2t at
width 4, k2_w8 and k2t_w8 at width 8.

K3 replaces `pallas_render_deferred` -> `_kernel_deferred` of the same file:
the first phase of the textured render. Kernel source:
csrc/render_deferred.cu, which shares K2's camera ray, sphere pass and
per-light shadowed intensity (csrc/render_common.cuh) and writes the
G-buffer as two planes [2,N,4]: (S rgb, material id) for every ray, then
(uv, mip footprint, 0). Its plain version is
`ops/render.py::render_gbuffer`, whose rows [N,8] hold the same words;
`render_deferred` returns planes on either device (`gbuffer_planes`).
On the card every K3 launch, every K2t launch and every K2 launch at node
width 8 comes after one launch of K3's pre-pass, `camera_relative`
(csrc/camera_relative.cu): the camera-relative node and triangle tables that
their camera walk reads (the camera's position taken off every box plane;
s = o - v0, q = s x e1 and e2 . q per triangle), made from the device
camera row into two buffers of `RenderTables`, which it allocates at its
first launch and again when a rebuild changes the trace tables' shapes
(tables that never run it hold none). Its plain version is
`camera_relative_tables`, the same operations in the same order; K3's and
K2's plain versions stay `render_gbuffer` and `render_chunk`. A width-4 K2
launch takes no pre-pass.

All three loop over every light in light order, or, given `light_u` (one
uniform per ray), evaluate the one light min(floor(u * L), L - 1) with one
shadow ray and weight it by L: the TPU kernels' branch above MAX_LIGHTS
lights (`_sampled_light`), whose plain version is `render_chunk(...,
light_u=)` / `render_gbuffer(..., light_u=)`.

The small per-scene rows are packed here with the same PyTorch ops the
plain path evaluates, on the scene's device, so both read identical values:

  * camera [16] f32: position, forward, right = forward x up,
    true_up = right x forward, tan(fov/2), 3 pad; after a camera move on
    CUDA tables written by one launch of the camera row kernel
    (csrc/camera_relative.cu rt_camera_row, csrc/camera_row.cuh), the same
    operations in the same order (`set_camera`);
  * materials [M,16] f32: albedo, emission, metallic, IOR, transmission,
    roughness (the f16 fields unpacked; roughness only for the bounce
    kernel), 6 pad;
  * lights [L,16] f32: position, type, colour, intensity, unit direction
    (NaN for a zero vector, silenced by max0 as in the plain path), 5 pad;
  * spheres [S,8] f32: centre, radius, material id as int32 bits, 3 pad.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ...engine.perf import count
from ...models.camera import Camera, tan_half_fov
from ...models.scene import Scene
from ..f16 import unpack_f16_high, unpack_f16_low
from ..linalg import cross, normalize
from ..render import gbuffer_planes, render_chunk, render_gbuffer
from ..shading import pixel_footprint_scale
from .build import check, load_kernels, tally
from .traverse import TraceTables, nodes_ptr, pack_trace_tables

MAX_LIGHTS = 16   # above this `Renderer` hands the kernels a `light_u`, as the JAX package
REL_TRI_WORDS = 16   # f32 words of a camera-relative triangle row: (e1, e2.q), (e2, 0), (s, 0), (q, 0)


@dataclass
class RenderTables:
    trace: TraceTables
    camera: torch.Tensor      # [16] f32
    materials: torch.Tensor   # [M,16] f32
    lights: torch.Tensor      # [L,16] f32
    spheres: torch.Tensor     # [S,8] f32
    fov_scale: float          # the camera's tan(fov/2), evaluated on the host once
    fov: float                # the field of view (degrees) `fov_scale` was evaluated for
    # the camera-relative tables K3's pre-pass writes before every K3 launch
    # and every K2t and width-8 K2 launch (`camera_relative`, which allocates them)
    rel_nodes: torch.Tensor | None = None   # [Q,8w] f32, the node records' layout
    rel_tris: torch.Tensor | None = None    # [Tp,16] f32

    @property
    def scene(self) -> Scene:
        return self.trace.scene


def _pad(x: torch.Tensor, words: int) -> torch.Tensor:
    return torch.cat([x, x.new_zeros((x.shape[0], words - x.shape[1]))], dim=1).contiguous()


def material_rows(scene: Scene) -> torch.Tensor:
    """[M,16] f32: albedo, emission, metallic, IOR, transmission, roughness
    (read by the bounce kernel only), 6 pad."""
    m = scene.materials
    return _pad(torch.cat(
        [m.albedo, m.emission, unpack_f16_low(m.metallic_roughness_f16)[:, None],
         unpack_f16_low(m.ior_transmission_f16)[:, None],
         unpack_f16_high(m.ior_transmission_f16)[:, None],
         unpack_f16_high(m.metallic_roughness_f16)[:, None]], dim=1), 16)


def camera_row(cam: Camera, fov_scale: float) -> torch.Tensor:
    """[16] f32 on the camera's device: position, forward, right, true_up,
    `fov_scale`, 3 pad (no host copy: a fill, not a pageable upload)."""
    dev = cam.position.device
    right = cross(cam.direction, cam.up)
    true_up = cross(right, cam.direction)
    fov = torch.full((1,), fov_scale, dtype=torch.float32, device=dev)
    return torch.cat([cam.position, cam.direction, right, true_up, fov,
                      torch.zeros(3, device=dev)])


def set_camera(tables: RenderTables, camera: Camera) -> None:
    """Point the tables at a moved camera: the camera row is rewritten in
    place (its address stays valid for a launch captured earlier),
    `fov_scale` and the tables' scene follow; no other table is repacked.

    CUDA tables take one launch of the camera row kernel and nothing else on
    the device (`write_camera_row`); the scene's camera then views a fresh
    buffer, so a camera held from before the move keeps its values. Other
    tables take the plain version: `camera_row` of `Scene.with_camera`.
    tan(fov/2) is evaluated again only when the field of view's value
    changed (`_fov_scale`)."""
    fov, fov_scale = _fov_scale(tables, camera.fov)
    if tables.trace.device.type == "cuda":
        scene = dataclasses.replace(tables.scene,
                                    camera=write_camera_row(tables, camera, fov_scale))
    else:
        scene = tables.scene.with_camera(camera)
        tables.camera.copy_(camera_row(scene.camera, fov_scale))
    tables.fov, tables.fov_scale = fov, fov_scale
    tables.trace.scene = scene


def _fov_scale(tables: RenderTables, fov: torch.Tensor) -> tuple[float, float]:
    """(field of view, tan(fov/2)) of a new camera's `fov`: the tables' own
    where `fov` is their camera's tensor (a device fov is then never read
    back) or has the value they were evaluated for; else tan is evaluated
    again. A host fov is read on the host; a device fov of another camera
    is read back."""
    if fov is tables.scene.camera.fov:
        return tables.fov, tables.fov_scale
    value = float(fov)
    if value == tables.fov:
        return tables.fov, tables.fov_scale
    return value, tan_half_fov(value)


CAMERA_FIELDS = (3, 3, 3, 1)   # words of position, direction, up, fov


def write_camera_row(tables: RenderTables, camera: Camera, fov_scale: float) -> Camera:
    """The camera row kernel on CUDA tables -> the new camera, views of a
    fresh [10] f32 device buffer that the same launch fills with its fields
    (position, direction, up, fov). The row `tables.camera` is rewritten in
    place. A field on the host goes in as launch arguments by value (nothing
    is staged in memory a later move could overwrite); a field on the card
    is read there through its pointer, never on the host. Counted in
    LAUNCHES as camera_row."""
    dev = tables.camera.device
    ptrs, values = [], []
    for f, n in zip((camera.position, camera.direction, camera.up, camera.fov), CAMERA_FIELDS):
        if f.numel() != n:
            raise ValueError(f"a camera field of {f.numel()} words, want {n}")
        if f.device.type == "cpu":
            ptrs.append(None)
            values += f.reshape(n).tolist()
        else:
            f = f.to(dev, torch.float32).contiguous()
            ptrs.append(f.data_ptr())
            values += [0.0] * n
    fields = torch.empty(sum(CAMERA_FIELDS), dtype=torch.float32, device=dev)
    k = load_kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream
    tally("camera_row")
    check(k.lib.rt_camera_row(*ptrs, *values, fov_scale, tables.camera.data_ptr(),
                              fields.data_ptr(), stream), "rt_camera_row")
    return Camera(fields[0:3], fields[3:6], fields[6:9], fields[9])


def pack_render_tables(scene: Scene) -> RenderTables:
    fov = float(scene.camera.fov)
    fov_scale = tan_half_fov(fov)
    camera = camera_row(scene.camera, fov_scale).contiguous()
    materials = material_rows(scene)
    L = scene.lights
    lights = _pad(torch.cat(
        [L.position, L.light_type.to(torch.float32)[:, None], L.color,
         L.intensity[:, None], normalize(L.direction)], dim=1), 16)
    S = scene.spheres
    mat_bits = S.material_id.to(torch.int32).view(torch.float32)[:, None]
    spheres = _pad(torch.cat([S.center, S.radius[:, None], mat_bits], dim=1), 8)
    return RenderTables(pack_trace_tables(scene), camera, materials, lights, spheres, fov_scale,
                        fov)


def camera_relative_tables(tables: RenderTables) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of K3's pre-pass (csrc/camera_relative.cu) ->
    (rel_nodes [Q,8w] f32, rel_tris [Tp,16] f32), new tensors on the
    tables' device. With o the camera row's position: the node records with
    o's coordinate taken off each box word (plane - o of the plane's axis;
    codes, axis and pad as they are), and per triangle slot (e1, e2 . q),
    (e2, 0), (s, 0), (q, 0) for s = o - v0 and q = s x e1, each product and
    sum in the order of the walk's triangle test (traverse.cuh leaf_test)."""
    tr = tables.trace
    w = tr.width
    o = tables.camera[:3]
    rel_nodes = tr.nodes.clone()
    planes = tr.nodes[:, :6 * w].reshape(-1, 6, w)   # lo_x, lo_y, lo_z, hi_x, hi_y, hi_z
    rel_nodes[:, :6 * w] = (planes - torch.cat([o, o])[None, :, None]).reshape(-1, 6 * w)
    rows = tr.tris.reshape(-1, 3, 4)
    v0, e1, e2 = rows[:, 0, :3], rows[:, 1, :3], rows[:, 2, :3]
    s = o[None, :] - v0
    q = cross(s, e1)
    e2q = e2[:, 0] * q[:, 0] + e2[:, 1] * q[:, 1] + e2[:, 2] * q[:, 2]
    zero = torch.zeros_like(e2q)[:, None]
    rel_tris = torch.cat([e1, e2q[:, None], e2, zero, s, zero, q, zero], dim=1).contiguous()
    return rel_nodes, rel_tris


def relative_buffers(tables: RenderTables) -> tuple[torch.Tensor, torch.Tensor]:
    """The buffers of the camera-relative tables, (rel_nodes [Q,8w] f32,
    rel_tris [Tp,16] f32) on the tables' device: the tables' own, allocated
    here when there are none yet or when a rebuild changed the trace tables'
    shapes. A fresh CUDA block starts on a 512-byte boundary, so the node
    records lie in whole aligned 128-byte lines, as `nodes_ptr` requires of
    `nodes`."""
    tr = tables.trace
    bufs = []
    for x, shape in ((tables.rel_nodes, tuple(tr.nodes.shape)),
                     (tables.rel_tris, (tr.tris.shape[0], REL_TRI_WORDS))):
        if x is None or tuple(x.shape) != shape:
            x = torch.empty(shape, dtype=torch.float32, device=tr.device)
        bufs.append(x)
    tables.rel_nodes, tables.rel_tris = bufs
    return tables.rel_nodes, tables.rel_tris


def camera_relative(tables: RenderTables) -> tuple[torch.Tensor, torch.Tensor]:
    """K3's pre-pass, also launched before every K2t and width-8 K2 launch:
    the camera-relative tables of the tables' current camera written into
    `relative_buffers(tables)`, which it returns. CUDA tensors launch
    csrc/camera_relative.cu on the current stream (counted in LAUNCHES as
    k3_pre; the camera's position is read on the device), CPU tensors take
    the plain `camera_relative_tables`."""
    tr = tables.trace
    dev = tr.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"camera_relative: unsupported device {dev}")
    rel_nodes, rel_tris = relative_buffers(tables)
    if dev.type == "cpu":
        nodes, tris = camera_relative_tables(tables)
        rel_nodes.copy_(nodes)
        rel_tris.copy_(tris)
        return rel_nodes, rel_tris
    nodes = nodes_ptr(tr)
    k = load_kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream
    tally("k3_pre")
    check(k.lib.rt_camera_relative(tables.camera.data_ptr(), nodes, tr.width, tr.nodes.shape[0],
                                   tr.tris.data_ptr(), tr.tris.shape[0], rel_nodes.data_ptr(),
                                   rel_tris.data_ptr(), stream), "rt_camera_relative")
    return rel_nodes, rel_tris


def count_walk(tables: RenderTables, rel: bool) -> None:
    """Count `render.table_bytes` while a profiler runs: at a frame kernel's
    launch (K2, K2t, K3), the bytes of the node records and triangle rows
    its walks read, the camera-relative tables too where `rel` (the launch
    reading them in its camera walk). A host integer from the tables'
    shapes: no device read."""
    tr = tables.trace
    words = tr.nodes.numel() + tr.tris.numel()
    if rel:
        words += tables.rel_nodes.numel() + tables.rel_tris.numel()
    count("render.table_bytes", 4 * words)


def _check_pixels(tables: RenderTables, px: torch.Tensor, py: torch.Tensor,
                  light_u: torch.Tensor | None, name: str) -> int:
    """Validate the pixel coordinates and the light uniforms -> N; raise for
    a device that is neither the CPU nor CUDA."""
    N = px.shape[0]
    wanted = [("px", px, torch.int32), ("py", py, torch.int32)]
    if light_u is not None:
        wanted.append(("light_u", light_u, torch.float32))
    for arg, x, dtype in wanted:
        if x.dtype != dtype or tuple(x.shape) != (N,) or not x.is_contiguous():
            raise ValueError(f"{arg}: want contiguous {dtype} ({N},), got {x.dtype} "
                             f"{tuple(x.shape)}")
        if x.device != tables.trace.device:
            raise ValueError(f"{arg} is on {x.device}, the tables on {tables.trace.device}")
    if px.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {px.device}")
    return N


def _light_u_ptr(tables: RenderTables, light_u: torch.Tensor | None) -> int:
    """The kernels' `light_u` argument: null selects the loop over every
    light (also where there is nothing to choose between)."""
    return 0 if light_u is None or tables.lights.shape[0] <= 1 else light_u.data_ptr()


def render_primary(tables: RenderTables, px: torch.Tensor, py: torch.Tensor,
                   width: int, height: int, shadows: bool = False,
                   sky=(0.0, 0.0, 0.0), light_u: torch.Tensor | None = None,
                   shade=None) -> torch.Tensor:
    """Fused frame render of pixels (px, py) [N] int32 -> RGB [N,3] f32 in
    the given order, one launch: K2, or K2t for a textured scene, which needs
    `shade`, the scene's `ops/cuda/texshade.py::pack_shade_tables` (textures
    at the nearest mip of each hit's footprint). `light_u` [N] f32 selects
    single-sample light selection. CUDA tensors launch the kernel (K2 at
    node width 8, and K2t at both widths, after K3's pre-pass
    `camera_relative`, whose tables their camera walk reads), CPU tensors
    take the plain version."""
    N = _check_pixels(tables, px, py, light_u, "render_primary")
    if px.device.type == "cpu":
        return render_chunk(tables.scene, px, py, width, height, shadows=shadows, sky=sky,
                            light_u=light_u)
    textured = tables.scene.textures.textured
    if textured and (shade is None or shade.device != px.device):
        raise ValueError("render_primary: a textured scene needs its shade tables "
                         "(pack_shade_tables) on the pixels' device")
    k = load_kernels()
    rgb = torch.empty((N, 3), dtype=torch.float32, device=px.device)
    tr = tables.trace
    sky_r, sky_g, sky_b = (float(c) for c in sky)
    stream = torch.cuda.current_stream(px.device).cuda_stream
    nodes = nodes_ptr(tr)
    # width 8 and K2t: the camera walk reads the pre-pass's tables of this
    # camera, made anew for every launch (every camera move rewrites the
    # camera row)
    use_rel = tr.width == 8 or textured
    rel = tuple(x.data_ptr() for x in camera_relative(tables)) if use_rel else (0, 0)
    scene_args = (tables.camera.data_ptr(), tables.materials.data_ptr(),
                  tables.materials.shape[0], tables.lights.data_ptr(), tables.lights.shape[0],
                  tables.spheres.data_ptr(), tables.spheres.shape[0])
    frame_args = (px.data_ptr(), py.data_ptr(), N, width, height, int(shadows), sky_r, sky_g,
                  sky_b, _light_u_ptr(tables, light_u), rgb.data_ptr(), stream)
    count_walk(tables, use_rel)
    if textured:
        tally("k2t", tr.width)
        check(k.lib.rt_render_primary_textured(
            nodes, tr.tris.data_ptr(), tr.attrs.data_ptr(), *rel, tr.width, tr.stack, *scene_args,
            shade.maps.data_ptr(), shade.atlas.data_ptr(), shade.present, shade.n_levels,
            pixel_footprint_scale(tables.fov_scale, height), *frame_args),
            "rt_render_primary_textured")
    else:
        tally("k2", tr.width)
        check(k.lib.rt_render_primary(nodes, tr.tris.data_ptr(), *rel, tr.width, tr.stack,
                                      *scene_args, *frame_args), "rt_render_primary")
    return rgb


def render_deferred(tables: RenderTables, px: torch.Tensor, py: torch.Tensor,
                    width: int, height: int, shadows: bool = False,
                    light_u: torch.Tensor | None = None) -> torch.Tensor:
    """Deferred trace of pixels (px, py) [N] int32 -> G-buffer planes
    [2,N,4] f32 in the given order: (S rgb, material id), then (u, v,
    footprint, 0). `light_u` [N] f32 selects single-sample light selection.
    CUDA tensors launch K3's pre-pass (`camera_relative`) and then K3,
    whose camera walk reads its tables; CPU tensors take the plain version
    (ops/render.py::render_gbuffer, whose rows [N,8] hold the same
    words, laid out as planes)."""
    N = _check_pixels(tables, px, py, light_u, "render_deferred")
    if px.device.type == "cpu":
        return gbuffer_planes(render_gbuffer(tables.scene, px, py, width, height,
                                             shadows=shadows, light_u=light_u))
    k = load_kernels()
    gbuf = torch.empty((2, N, 4), dtype=torch.float32, device=px.device)
    tr = tables.trace
    pix = pixel_footprint_scale(tables.fov_scale, height)
    stream = torch.cuda.current_stream(px.device).cuda_stream
    nodes = nodes_ptr(tr)
    rel_nodes, rel_tris = (x.data_ptr() for x in camera_relative(tables))
    count_walk(tables, True)
    tally("k3", tr.width)
    check(k.lib.rt_render_deferred(
        nodes, tr.tris.data_ptr(), tr.attrs.data_ptr(), rel_nodes, rel_tris, tr.width, tr.stack,
        tables.camera.data_ptr(), tables.lights.data_ptr(), tables.lights.shape[0],
        tables.spheres.data_ptr(), tables.spheres.shape[0], px.data_ptr(), py.data_ptr(),
        N, width, height, int(shadows), pix, _light_u_ptr(tables, light_u), gbuf.data_ptr(),
        stream), "rt_render_deferred")
    return gbuf
