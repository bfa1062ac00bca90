"""glTF 2.0 / GLB scene loader (pure Python, no external gltf crate/lib).

NumPy on the host, then `prepare_scene` onto a device; field for field the
JAX package's `models/gltf.py` (the same `LoadedScene`, the same `Scene`):

* scene selection: explicit index, else default scene, else first
  (gltf_loader.rs:77-85);
* recursive node walk with mat4 transform composition (column-major,
  local = node.matrix or T·R·S; world = parent · local) (gltf_loader.rs:187-227);
* camera: position = M·0, direction = normalize(M·(-Z)), up = normalize(M·Y),
  fov = degrees(yfov), 45° for orthographic (gltf_loader.rs:230-250);
* KHR_lights_punctual → directional/point/spot with transformed -Z direction,
  range default ∞, spot cone angles (gltf_loader.rs:253-284);
* primitives → indexed triangles with **bit-exact position-based vertex
  dedup per primitive** (HashMap on f32 bits, gltf_loader.rs:306-330),
  supporting Triangles (indexed + non-indexed), TriangleFan, TriangleStrip
  with alternating winding (gltf_loader.rs:333-391);
* materials: KHR_materials_pbrSpecularGlossiness workflow, else
  metallic-roughness; emissive factor; KHR transmission / ior / specular /
  volume extensions; up to 8 texture indices in base-color, metallic-
  roughness, normal, emissive order (gltf_loader.rs:397-489);
* textures decoded to RGBA8 into one flat byte buffer (gltf_loader.rs:128-184)
  — PNG decoded natively here; other formats are skipped with a warning
  (the package depends on no image library).

Accessor/index readers handle the little-endian component types directly
(gltf_loader.rs:499-594 of the original renderer does the same by hand).
"""

from __future__ import annotations

import base64
import json
import os
import struct
import sys
import zlib
from dataclasses import dataclass, field

import numpy as np

from ..config import DEFAULT_CONFIG, RaytracerConfig
from .camera import Camera
from .geometry import JAX_ATLAS_BUDGET_ROWS, Mesh, Spheres, Textures
from .light import LightBuilder
from .material import (TEX_BASE_COLOR, TEX_EMISSIVE, TEX_METALLIC_ROUGHNESS, TEX_NORMAL,
                       TEX_OCCLUSION, TEX_SG_SPECGLOSS, MaterialBuilder)
from .scene import Scene, build_default_scene, prepare_scene


class GltfError(Exception):
    """Load/validation failure (GltfError enum, gltf_loader.rs:15-39)."""


_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
                "MAT2": 4, "MAT3": 9, "MAT4": 16}

MODE_TRIANGLES, MODE_TRIANGLE_STRIP, MODE_TRIANGLE_FAN = 4, 5, 6


@dataclass
class LoadedScene:
    """What a glTF file holds, before the scene build (gltf_loader.rs:42-51)."""

    vertices: np.ndarray          # [V,3] f32
    triangles: np.ndarray         # [T,3] u32
    tri_materials: np.ndarray     # [T] u32
    materials: MaterialBuilder
    lights: LightBuilder
    cameras: list = field(default_factory=list)    # list[Camera]
    images: list = field(default_factory=list)     # list[np.ndarray RGBA8]
    texture_image: list = field(default_factory=list)  # texture -> image idx
    texture_wrap: list = field(default_factory=list)   # texture -> wrap mode
    image_warnings: list = field(default_factory=list)  # skipped images + why
    uvs: np.ndarray | None = None                  # [V,2] f32 TEXCOORD_0


# ---------------------------------------------------------------- transforms

def _trs_matrix(node: dict) -> np.ndarray:
    """Local transform: `matrix` (column-major) or T·R·S."""
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float32).reshape(4, 4).T
    m = np.eye(4, dtype=np.float32)
    if "scale" in node:
        m = m @ np.diag(np.asarray(list(node["scale"]) + [1.0], np.float32))
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        r = np.asarray([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w), 0],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w), 0],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y), 0],
            [0, 0, 0, 1]], np.float32)
        m = r @ m
    if "translation" in node:
        t = np.eye(4, dtype=np.float32)
        t[:3, 3] = node["translation"]
        m = t @ m
    return m


def _transform_points(m: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """glam transform_point3: rotate+scale+translate."""
    return (pts @ m[:3, :3].T + m[:3, 3]).astype(np.float32)


def _transform_vector(m: np.ndarray, v) -> np.ndarray:
    return (np.asarray(v, np.float32) @ m[:3, :3].T).astype(np.float32)


def _normalize(v: np.ndarray) -> np.ndarray:
    """Unit vector, IDEMPOTENT at f32: a vector already unit to f32
    precision returns unchanged (renormalising an exported-then-reloaded
    direction would shift its bits by an ulp and break the scene-vs-round-
    trip bit equality that prepare_scene's canonical normalisation — the
    same rule — establishes)."""
    n = float(np.linalg.norm(np.asarray(v, np.float64)))
    if abs(n - 1.0) <= 1e-6:
        return np.asarray(v, np.float32)
    return (np.asarray(v, np.float64) / n).astype(np.float32)


# ---------------------------------------------------------------- PNG decode

def _paeth(a, b, c):
    p = a.astype(np.int32) + b.astype(np.int32) - c.astype(np.int32)
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c)).astype(np.uint8)


def _unfilter(raw: bytes, offset: int, w: int, h: int, bpp: int,
              stride: int) -> tuple[np.ndarray, int]:
    """Reverse PNG scanline filters for one (sub-)image of `h` scanlines of
    `stride` bytes (filters operate on BYTES, pixel unit = `bpp` bytes).
    Returns ([h, stride] u8, bytes consumed from `raw`)."""
    img = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    pos = offset
    for y in range(h):
        f = raw[pos]
        line = np.frombuffer(raw, np.uint8, stride, pos + 1).copy()
        pos += stride + 1
        if f == 0:
            out = line
        elif f == 2:  # up
            out = line + prev
        else:
            out = line
            left = np.zeros(bpp, np.uint8)
            if f == 1:  # sub
                for x in range(0, stride, bpp):
                    out[x:x + bpp] = out[x:x + bpp] + left
                    left = out[x:x + bpp]
            elif f == 3:  # average
                for x in range(0, stride, bpp):
                    avg = ((left.astype(np.int32)
                            + prev[x:x + bpp].astype(np.int32)) // 2)
                    out[x:x + bpp] = out[x:x + bpp] + avg.astype(np.uint8)
                    left = out[x:x + bpp]
            elif f == 4:  # paeth
                ul = np.zeros(bpp, np.uint8)
                for x in range(0, stride, bpp):
                    pred = _paeth(left, prev[x:x + bpp], ul)
                    out[x:x + bpp] = out[x:x + bpp] + pred
                    ul = prev[x:x + bpp]
                    left = out[x:x + bpp]
            else:
                raise GltfError(f"bad PNG filter {f}")
        img[y] = out
        prev = img[y]
    return img, pos - offset


def _unpack_samples(rows: np.ndarray, w: int, channels: int,
                    bit_depth: int) -> np.ndarray:
    """[h, stride] filtered bytes → [h, w, channels] u8 samples.
    Sub-byte depths (1/2/4, gray or palette indices) unpack MSB-first;
    16-bit samples truncate to the high byte (the standard to_rgba8)."""
    h = rows.shape[0]
    if bit_depth == 16:
        return rows.reshape(h, w, channels, 2)[..., 0]
    if bit_depth == 8:
        return rows.reshape(h, w, channels)
    per_byte = 8 // bit_depth
    bits = np.unpackbits(rows, axis=1).reshape(h, -1, per_byte, bit_depth)
    vals = np.zeros(bits.shape[:3], np.uint8)
    for b in range(bit_depth):
        vals = (vals << 1) | bits[..., b]
    return vals.reshape(h, -1)[:, :w].reshape(h, w, 1)


# Adam7 pass layout: (x offset, y offset, x step, y step) — libpng order
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def decode_png(data: bytes) -> np.ndarray:
    """Minimal PNG decoder: gray / gray-alpha / RGB / RGBA / PALETTED
    (tRNS transparency for palettes AND gray/RGB color keys), bit depths
    1/2/4/8/16,
    non-interlaced AND Adam7-interlaced (what real asset packs carry;
    16-bit samples truncate to their high byte, the standard to_rgba8
    conversion). Returns [H,W,4] uint8, always expanded to RGBA."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise GltfError("not a PNG")
    pos, w = 8, 0
    idat = b""
    palette = trns = None
    h = bit_depth = color_type = interlace = 0
    while pos < len(data):
        (length,), tag = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h, bit_depth, color_type, _, _, interlace = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
        pos += 12 + length
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}.get(color_type)
    if channels is None:
        raise GltfError(f"unsupported PNG color type {color_type}")
    if color_type == 3 and palette is None:
        raise GltfError("paletted PNG without PLTE chunk")
    valid_depths = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
                    4: (8, 16), 6: (8, 16)}[color_type]
    if bit_depth not in valid_depths:
        raise GltfError(f"unsupported PNG (depth={bit_depth}, "
                        f"color_type={color_type})")
    raw = zlib.decompress(idat)

    def stride_of(width):
        return (width * channels * bit_depth + 7) // 8

    bpp = max(channels * bit_depth // 8, 1)      # filter pixel unit, bytes
    # tRNS color keys on 16-bit gray/RGB need the EXACT 16-bit samples
    # (high-byte matching would mark 1/256 of non-key pixels transparent)
    want16 = (bit_depth == 16 and trns is not None and color_type in (0, 2))
    px16 = None

    def full16(rows, width):
        r = rows.reshape(rows.shape[0], width, channels, 2).astype(np.uint16)
        return (r[..., 0] << 8) | r[..., 1]

    if interlace == 0:
        rows, _ = _unfilter(raw, 0, w, h, bpp, stride_of(w))
        px = _unpack_samples(rows, w, channels, bit_depth)
        if want16:
            px16 = full16(rows, w)
    elif interlace == 1:                         # Adam7
        px = np.zeros((h, w, channels), np.uint8)
        px16 = np.zeros((h, w, channels), np.uint16) if want16 else None
        off = 0
        for (x0, y0, dx, dy) in _ADAM7:
            pw = (w - x0 + dx - 1) // dx
            ph = (h - y0 + dy - 1) // dy
            if pw == 0 or ph == 0:
                continue
            rows, used = _unfilter(raw, off, pw, ph, bpp, stride_of(pw))
            off += used
            px[y0::dy, x0::dx] = _unpack_samples(rows, pw, channels,
                                                 bit_depth)
            if want16:
                px16[y0::dy, x0::dx] = full16(rows, pw)
    else:
        raise GltfError(f"unsupported PNG interlace method {interlace}")

    rgba = np.zeros((h, w, 4), np.uint8)
    rgba[..., 3] = 255
    if color_type == 3:                          # palette lookup + tRNS
        idx = px[..., 0]
        if int(idx.max(initial=0)) >= palette.shape[0]:
            raise GltfError("paletted PNG index out of palette range")
        rgba[..., :3] = palette[idx]
        if trns is not None:
            alpha = np.full(palette.shape[0], 255, np.uint8)
            alpha[:trns.shape[0]] = trns
            rgba[..., 3] = alpha[idx]
        return rgba
    if bit_depth in (1, 2, 4):                   # grayscale scale-to-8-bit
        px = (px.astype(np.uint16) * 255 // ((1 << bit_depth) - 1)).astype(np.uint8)
    if trns is not None and color_type in (0, 2):
        # Color-key transparency (PNG §11.3.2): pixels matching the tRNS key
        # decode fully transparent. Keys are big-endian
        # u16 at source depth; map into the decoded samples' 8-bit space
        # (high byte for 16-bit, identity for 8-bit, scale for 1/2/4-bit).
        key = np.frombuffer(trns[:2 * channels], ">u2").astype(np.uint32)
        if bit_depth == 16:
            # exact 16-bit compare: the key applies before the to-8-bit
            # conversion
            transparent = np.all(px16 == key.astype(np.uint16), axis=-1)
        else:
            if bit_depth == 8:
                key8 = key.astype(np.uint8)
            else:
                key8 = (key * 255 // ((1 << bit_depth) - 1)).astype(np.uint8)
            transparent = np.all(px == key8, axis=-1)
        rgba[..., 3] = np.where(transparent, 0, 255).astype(np.uint8)
    if channels == 1:
        rgba[..., :3] = px
    elif channels == 2:
        rgba[..., :3] = px[..., :1]
        rgba[..., 3] = px[..., 1]
    elif channels == 3:
        rgba[..., :3] = px
    else:
        rgba[:] = px
    return rgba


# ---------------------------------------------------------------- the loader

class GltfLoader:
    def __init__(self, doc: dict, buffers: list[bytes],
                 base_dir: str | None = None):
        self.doc = doc
        self.buffers = buffers
        self.base_dir = base_dir    # for external image/buffer URIs

    # -- constructors (load_from_path / load_from_glb, gltf_loader.rs:55-74)

    @staticmethod
    def load_from_path(path: str) -> "GltfLoader":
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError as e:
            raise GltfError(f"cannot read {path}: {e}") from e
        if data[:4] == b"glTF":
            return GltfLoader.load_from_glb(data)
        try:
            doc = json.loads(data)
        except json.JSONDecodeError as e:
            raise GltfError(f"invalid glTF JSON: {e}") from e
        base = os.path.dirname(os.path.abspath(path))
        return GltfLoader(doc, GltfLoader._load_buffers(doc, base, None),
                          base_dir=base)

    @staticmethod
    def load_from_glb(data: bytes) -> "GltfLoader":
        magic, version, _length = struct.unpack("<III", data[:12])
        if magic != 0x46546C67:
            raise GltfError("bad GLB magic")
        if version != 2:
            raise GltfError(f"unsupported GLB version {version}")
        pos = 12
        doc = None
        bin_chunk = None
        while pos + 8 <= len(data):
            clen, ctype = struct.unpack("<II", data[pos:pos + 8])
            chunk = data[pos + 8:pos + 8 + clen]
            if ctype == 0x4E4F534A:  # JSON
                doc = json.loads(chunk)
            elif ctype == 0x004E4942:  # BIN
                bin_chunk = bytes(chunk)
            pos += 8 + clen
        if doc is None:
            raise GltfError("GLB missing JSON chunk")
        return GltfLoader(doc, GltfLoader._load_buffers(doc, None, bin_chunk))

    @staticmethod
    def _load_buffers(doc, base_dir, glb_bin) -> list[bytes]:
        out = []
        for i, buf in enumerate(doc.get("buffers", [])):
            uri = buf.get("uri")
            if uri is None:
                if glb_bin is None:
                    raise GltfError(f"buffer {i} has no uri and no GLB BIN chunk")
                out.append(glb_bin)
            elif uri.startswith("data:"):
                out.append(base64.b64decode(uri.split(",", 1)[1]))
            else:
                if base_dir is None:
                    raise GltfError(f"external buffer {uri} in GLB")
                with open(os.path.join(base_dir, uri), "rb") as f:
                    out.append(f.read())
        return out

    # -- binary readers (accessor/index readers, gltf_loader.rs:499-594)

    def _buffer_view_bytes(self, view_idx: int) -> tuple[bytes, int]:
        view = self.doc["bufferViews"][view_idx]
        buf = self.buffers[view["buffer"]]
        off = view.get("byteOffset", 0)
        return buf[off:off + view["byteLength"]], view.get("byteStride", 0)

    def read_accessor(self, acc_idx: int) -> np.ndarray:
        acc = self.doc["accessors"][acc_idx]
        n = acc["count"]
        ncomp = _TYPE_COUNTS[acc["type"]]
        dt = _COMPONENT_DTYPES[acc["componentType"]]
        if "bufferView" not in acc:
            data = np.zeros((n, ncomp), dt)
        else:
            raw, stride = self._buffer_view_bytes(acc["bufferView"])
            off = acc.get("byteOffset", 0)
            isz = np.dtype(dt).itemsize * ncomp
            if stride and stride != isz:
                rows = [np.frombuffer(raw, dt, ncomp, off + i * stride) for i in range(n)]
                data = np.stack(rows)
            else:
                data = np.frombuffer(raw, dt, n * ncomp, off).reshape(n, ncomp).copy()
        if "sparse" in acc:
            sp = acc["sparse"]
            idx_dt = _COMPONENT_DTYPES[sp["indices"]["componentType"]]
            iraw, _ = self._buffer_view_bytes(sp["indices"]["bufferView"])
            ioff = sp["indices"].get("byteOffset", 0)
            sidx = np.frombuffer(iraw, idx_dt, sp["count"], ioff)
            vraw, _ = self._buffer_view_bytes(sp["values"]["bufferView"])
            voff = sp["values"].get("byteOffset", 0)
            svals = np.frombuffer(vraw, dt, sp["count"] * ncomp, voff).reshape(-1, ncomp)
            data = data.copy()
            data[sidx] = svals
        if acc.get("normalized") and dt != np.float32:
            info = np.iinfo(dt)
            data = data.astype(np.float32) / float(info.max)
        return data.squeeze(-1) if ncomp == 1 else data

    # -- introspection (list_scenes/cameras/lights, gltf_loader.rs:597-629)

    def list_scenes(self) -> list[str]:
        return [s.get("name", f"scene_{i}")
                for i, s in enumerate(self.doc.get("scenes", []))]

    def list_cameras(self) -> list[str]:
        return [c.get("name", f"camera_{i}")
                for i, c in enumerate(self.doc.get("cameras", []))]

    def list_lights(self) -> list[str]:
        ext = self.doc.get("extensions", {}).get("KHR_lights_punctual", {})
        return [l.get("name", f"light_{i}")
                for i, l in enumerate(ext.get("lights", []))]

    # -- extraction (extract_scene, gltf_loader.rs:77-125)

    def extract_scene(self, scene_index: int | None = None) -> LoadedScene:
        scenes = self.doc.get("scenes", [])
        if scene_index is not None:
            if scene_index >= len(scenes):
                raise GltfError(f"Scene {scene_index} not found")
            scene = scenes[scene_index]
        elif scenes:
            scene = scenes[self.doc.get("scene", 0)]
        else:
            raise GltfError("No scenes found in glTF file")

        out = LoadedScene(
            vertices=np.zeros((0, 3), np.float32),
            triangles=np.zeros((0, 3), np.uint32),
            tri_materials=np.zeros((0,), np.uint32),
            materials=MaterialBuilder(),
            lights=LightBuilder(),
        )
        self._process_images(out)
        for gm in self.doc.get("materials", []):
            self._convert_material(gm, out.materials)

        verts: list[np.ndarray] = []
        tris: list[np.ndarray] = []
        tmats: list[np.ndarray] = []
        uvs: list[np.ndarray] = []
        self._vcount = 0
        for node_idx in scene.get("nodes", []):
            self._process_node(node_idx, np.eye(4, dtype=np.float32),
                               out, verts, tris, tmats, uvs)
        if verts:
            out.vertices = np.concatenate(verts)
            out.uvs = np.concatenate(uvs)
        if tris:
            out.triangles = np.concatenate(tris).astype(np.uint32)
            out.tri_materials = np.concatenate(tmats).astype(np.uint32)
        return out

    def _decode_image(self, raw: bytes) -> np.ndarray:
        """Format dispatch by magic: PNG (`decode_png`) and baseline or
        progressive JPEG (utils/jpeg.py), which together cover real glTF
        asset corpora."""
        if raw[:8] == b"\x89PNG\r\n\x1a\n":
            return decode_png(raw)
        if raw[:2] == b"\xff\xd8":
            from ..utils.jpeg import JpegError, decode_jpeg

            try:
                return decode_jpeg(raw)
            except JpegError as e:
                raise GltfError(str(e)) from e
        raise GltfError("unknown image format (not PNG / JPEG)")

    def _process_images(self, out: LoadedScene) -> None:
        for i, img in enumerate(self.doc.get("images", [])):
            desc = img.get("uri", f"bufferView {img.get('bufferView')}")
            try:
                if "bufferView" in img:
                    raw, _ = self._buffer_view_bytes(img["bufferView"])
                elif "uri" in img and img["uri"].startswith("data:"):
                    raw = base64.b64decode(img["uri"].split(",", 1)[1])
                elif "uri" in img:
                    # external file relative to the asset
                    if self.base_dir is None:
                        raise GltfError("external image uri inside GLB/bytes")
                    from urllib.parse import unquote

                    p = os.path.join(self.base_dir, unquote(img["uri"]))
                    with open(p, "rb") as f:
                        raw = f.read()
                else:
                    raise GltfError("image has neither bufferView nor uri")
                out.images.append(self._decode_image(bytes(raw)))
            except (GltfError, OSError) as e:
                # LOUD, recorded, and non-fatal: geometry still loads, the
                # slot gets a 1x1 white placeholder (albedo passthrough)
                msg = f"glTF image {i} ({desc}): {e} -> 1x1 white placeholder"
                out.image_warnings.append(msg)
                print(f"WARNING: {msg}", file=sys.stderr)
                out.images.append(np.full((1, 1, 4), 255, np.uint8))
        samplers = self.doc.get("samplers", [])
        wrap_codes = {10497: 0, 33071: 1, 33648: 2}  # REPEAT/CLAMP/MIRRORED
        for tex in self.doc.get("textures", []):
            out.texture_image.append(tex.get("source", 0))
            smp = samplers[tex["sampler"]] if "sampler" in tex and \
                tex["sampler"] < len(samplers) else {}
            out.texture_wrap.append(wrap_codes.get(smp.get("wrapS", 10497), 0))

    def _process_node(self, node_idx, parent, out, verts, tris, tmats,
                      uvs) -> None:
        node = self.doc["nodes"][node_idx]
        m = parent @ _trs_matrix(node)
        if "mesh" in node:
            mesh = self.doc["meshes"][node["mesh"]]
            for prim in mesh.get("primitives", []):
                self._process_primitive(prim, m, verts, tris, tmats, uvs)
        if "camera" in node:
            out.cameras.append(self._convert_camera(node["camera"], m))
        light_ext = node.get("extensions", {}).get("KHR_lights_punctual")
        if light_ext is not None:
            self._convert_light(light_ext["light"], m, out.lights)
        for child in node.get("children", []):
            self._process_node(child, m, out, verts, tris, tmats, uvs)

    def _convert_camera(self, cam_idx: int, m: np.ndarray) -> Camera:
        cam = self.doc["cameras"][cam_idx]
        position = _transform_points(m, np.zeros((1, 3), np.float32))[0]
        direction = _normalize(_transform_vector(m, [0.0, 0.0, -1.0]))
        up = _normalize(_transform_vector(m, [0.0, 1.0, 0.0]))
        if cam.get("type") == "perspective":
            fov = float(np.degrees(cam["perspective"]["yfov"]))
        else:
            fov = 45.0
        return Camera.create(position, direction, up, fov)

    def _convert_light(self, light_idx: int, m: np.ndarray, lb: LightBuilder) -> None:
        light = self.doc["extensions"]["KHR_lights_punctual"]["lights"][light_idx]
        position = _transform_points(m, np.zeros((1, 3), np.float32))[0]
        direction = _normalize(_transform_vector(m, [0.0, 0.0, -1.0]))
        color = light.get("color", [1.0, 1.0, 1.0])
        intensity = light.get("intensity", 1.0)
        kind = light.get("type")
        rng = light.get("range", float("inf"))
        if kind == "directional":
            lb.add_directional(direction, color, intensity)
        elif kind == "point":
            lb.add_point(position, color, intensity, rng)
        elif kind == "spot":
            spot = light.get("spot", {})
            lb.add_spot(position, direction, color, intensity, rng,
                        spot.get("innerConeAngle", 0.0),
                        spot.get("outerConeAngle", np.pi / 4.0))

    def _convert_material(self, gm: dict, mb: MaterialBuilder) -> None:
        ext = gm.get("extensions", {})
        sg = ext.get("KHR_materials_pbrSpecularGlossiness")
        kw = {}
        if sg is not None:
            diffuse = sg.get("diffuseFactor", [1, 1, 1, 1])[:3]
            specular = sg.get("specularFactor", [1, 1, 1])
            gloss = sg.get("glossinessFactor", 1.0)
            kw.update(albedo=diffuse, metallic=0.0, roughness=1.0 - gloss,
                      material_type=1, diffuse_factor=diffuse,
                      specular_color=specular, glossiness_factor=gloss)
        else:
            pbr = gm.get("pbrMetallicRoughness", {})
            base = pbr.get("baseColorFactor", [1, 1, 1, 1])
            kw.update(albedo=base[:3],
                      metallic=pbr.get("metallicFactor", 1.0),
                      roughness=pbr.get("roughnessFactor", 1.0))
        kw["emission"] = gm.get("emissiveFactor", [0.0, 0.0, 0.0])
        tr = ext.get("KHR_materials_transmission")
        kw["transmission"] = tr.get("transmissionFactor", 0.0) if tr else 0.0
        io = ext.get("KHR_materials_ior")
        kw["ior"] = io.get("ior", 1.5) if io else 1.5
        sp = ext.get("KHR_materials_specular")
        if sp:
            kw["specular_factor"] = sp.get("specularFactor", 1.0)
            kw["specular_color"] = sp.get("specularColorFactor", [1, 1, 1])
        vol = ext.get("KHR_materials_volume")
        if vol:
            kw["thickness_factor"] = vol.get("thicknessFactor", 0.0)
            kw["attenuation_distance"] = vol.get("attenuationDistance", float("inf"))
            kw["attenuation_color"] = vol.get("attenuationColor", [1, 1, 1])
        # Fixed texture-slot assignment (models/material.py TEX_*): the
        # indices are addressable by meaning. The spec-gloss workflow is
        # folded into albedo / metallic / roughness here, at load time: no
        # shading code reads material_type.
        ti = np.full(8, 0xFFFFFFFF, np.uint32)
        pbr = gm.get("pbrMetallicRoughness", {})
        slots = {
            TEX_BASE_COLOR: (sg or {}).get("diffuseTexture")
            or pbr.get("baseColorTexture"),
            TEX_METALLIC_ROUGHNESS: pbr.get("metallicRoughnessTexture"),
            TEX_NORMAL: gm.get("normalTexture"),
            TEX_OCCLUSION: gm.get("occlusionTexture"),
            TEX_EMISSIVE: gm.get("emissiveTexture"),
            TEX_SG_SPECGLOSS: (sg or {}).get("specularGlossinessTexture"),
        }
        for slot, tex in slots.items():
            if tex is not None:
                ti[slot] = tex["index"]
        kw["texture_indices"] = ti
        mb.add(**kw)

    def _process_primitive(self, prim, m, verts, tris, tmats, uvs) -> None:
        mode = prim.get("mode", MODE_TRIANGLES)
        if mode not in (MODE_TRIANGLES, MODE_TRIANGLE_STRIP, MODE_TRIANGLE_FAN):
            print(f"Warning: unsupported primitive mode {mode}",
                  file=sys.stderr)
            return
        if "POSITION" not in prim.get("attributes", {}):
            raise GltfError("Primitive missing position data")
        pos = self.read_accessor(prim["attributes"]["POSITION"]).astype(np.float32)
        if "TEXCOORD_0" in prim["attributes"]:
            uv = self.read_accessor(
                prim["attributes"]["TEXCOORD_0"]).astype(np.float32)[:, :2]
            if uv.shape[0] != pos.shape[0]:
                uv = np.zeros((pos.shape[0], 2), np.float32)
        else:
            uv = np.zeros((pos.shape[0], 2), np.float32)
        material_id = prim.get("material", 0)

        if mode == MODE_TRIANGLES:
            if "indices" in prim:
                idx = self.read_accessor(prim["indices"]).astype(np.int64)
                idx = idx[: (len(idx) // 3) * 3].reshape(-1, 3)
            else:
                n = (len(pos) // 3) * 3
                idx = np.arange(n, dtype=np.int64).reshape(-1, 3)
        elif mode == MODE_TRIANGLE_FAN:
            n = len(pos)
            if n < 3:
                return
            i = np.arange(1, n - 1, dtype=np.int64)
            idx = np.stack([np.zeros_like(i), i, i + 1], axis=1)
        else:  # strip with alternating winding (gltf_loader.rs:373-387)
            n = len(pos)
            if n < 3:
                return
            i = np.arange(n - 2, dtype=np.int64)
            a, b, c = i, i + 1, i + 2
            odd = (i % 2) == 1
            idx = np.stack([a, np.where(odd, c, b), np.where(odd, b, c)], axis=1)

        if idx.size == 0:
            return
        # transform then dedup by exact bits, per primitive, in first-appearance
        # order of the corner stream (matches get_vertex_index semantics). The
        # key includes the UV bits: two corners sharing a position but not
        # texture coords must stay distinct.
        corners = _transform_points(m, pos[idx.reshape(-1)])
        corner_uv = uv[idx.reshape(-1)]
        bits = np.concatenate([corners.view(np.uint32),
                               corner_uv.view(np.uint32)], axis=1)
        _, first, inverse = np.unique(bits, axis=0, return_index=True,
                                      return_inverse=True)
        order = np.argsort(first, kind="stable")
        rank = np.empty_like(order)
        rank[order] = np.arange(order.size)
        unique_verts = corners[np.sort(first)]
        local = rank[inverse].reshape(-1, 3)

        verts.append(unique_verts)
        uvs.append(corner_uv[np.sort(first)])
        tris.append(local + self._vcount)
        self._vcount += unique_verts.shape[0]
        tmats.append(np.full(local.shape[0], material_id, np.uint32))


# ---------------------------------------------------------------- top level

def load_gltf(path: str, scene_index: int | None = None) -> LoadedScene:
    return GltfLoader.load_from_path(path).extract_scene(scene_index)


def scene_from_gltf(path: str, scene_index: int | None = None,
                    config: RaytracerConfig = DEFAULT_CONFIG,
                    camera: Camera | None = None, device="cpu") -> Scene:
    """glTF file -> Scene on `device`. Camera preference: explicit arg >
    first glTF camera > default. The atlas keeps the JAX package's row
    budget (JAX_ATLAS_BUDGET_ROWS), so both packages build the same one."""
    loaded = load_gltf(path, scene_index)
    if camera is None:
        camera = loaded.cameras[0] if loaded.cameras else Camera.default()
    mesh = Mesh.from_arrays(loaded.vertices, loaded.triangles,
                            loaded.tri_materials, uv=loaded.uvs)
    # texture table: resolve texture -> image, pack RGBA8 atlas
    images, wraps = [], []
    for ti, i in enumerate(loaded.texture_image):
        if i < len(loaded.images):
            images.append(loaded.images[i])
            wraps.append(loaded.texture_wrap[ti]
                         if ti < len(loaded.texture_wrap) else 0)
    if images:
        textures = Textures.from_images(
            images, wrap=wraps, mips=config.texture_mips,
            budget_rows=(JAX_ATLAS_BUDGET_ROWS if config.texture_mips > 1
                         else None))
    else:
        textures = None
    # stderr: stdout belongs to callers' machine-readable output
    print(f"Loaded glTF scene: {mesh.num_triangles} triangles, "
          f"{mesh.num_vertices} vertices, {len(loaded.materials)} materials, "
          f"{len(loaded.lights)} lights, {len(loaded.cameras)} cameras, "
          f"{len(images)} textures", file=sys.stderr)
    return prepare_scene(camera, Spheres.from_rows([]), mesh,
                         loaded.materials.build(), loaded.lights.build(),
                         textures=textures, config=config, device=device)


def scene_from_gltf_or_default(path: str, **kw) -> Scene:
    """A file that does not load gives the default scene and a message on
    stderr saying why: the documented behaviour for a bad asset (it concerns
    the file, never the device)."""
    try:
        return scene_from_gltf(path, **kw)
    except Exception as e:  # noqa: BLE001: any load error, as the JAX package
        print(f"Failed to load glTF scene '{path}': {e}; using default scene",
              file=sys.stderr)
        return build_default_scene(kw.get("config", DEFAULT_CONFIG),
                                   device=kw.get("device", "cpu"))
