"""The port's glTF asset path (on the CPU) against the JAX package's: the PNG
and JPEG decoders, the glTF / GLB loader, the scene it builds, the GLB writer
and the material zoo.

Everything here is host code that both packages evaluate in NumPy, so the bar
is equality: decoded images and GLB files byte for byte, every `LoadedScene`
field and every `Scene` table bit for bit (binary BVH nodes compared after a
depth-first relabel, tests/torch_bridge.py), and a frame rendered from a scene
that went through the writer and the loader equal to the frame of the
procedural scene (max |diff| 0.0: the same triangle set, materials, lights
and camera give the same arithmetic)."""

import base64
import dataclasses
import io
import json
import struct
import zlib

import numpy as np
import pytest
import torch

from gltf_fixtures import cornell_box_gltf, to_glb, write_gltf
from torch_bridge import (assert_arrays_equal, canonical_binary_tree, jax_scene_arrays,
                          scene_to_arrays)

from gpu_raytracer_tpu.models import gltf as jax_gltf
from gpu_raytracer_tpu.models.gltf_export import export_glb as jax_export_glb
from gpu_raytracer_tpu.utils import jpeg as jax_jpeg
from gpu_raytracer_tpu.utils import procgen as jax_procgen
from gpu_raytracer_tpu_torch.engine.renderer import Renderer
from gpu_raytracer_tpu_torch.models import gltf as port_gltf
from gpu_raytracer_tpu_torch.models.gltf_export import export_glb
from gpu_raytracer_tpu_torch.models.material import NO_TEXTURE
from gpu_raytracer_tpu_torch.utils import jpeg as port_jpeg
from gpu_raytracer_tpu_torch.utils import procgen


# ---------------------------------------------------------------- PNG

def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _filter_rows(rows: np.ndarray, bpp: int, filters) -> bytes:
    """PNG-filter [h, stride] u8 rows, row y with filter type filters[y % len]."""
    out = bytearray()
    prev = np.zeros(rows.shape[1], np.int32)
    for y, row in enumerate(rows.astype(np.int32)):
        f = filters[y % len(filters)]
        left = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if f == 0:
            pred = np.zeros_like(row)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, ul))
        out += bytes([f]) + ((row - pred) % 256).astype(np.uint8).tobytes()
        prev = row
    return bytes(out)


_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def _pack_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """[h, w, c] integer samples at `depth` bits -> [h, stride] u8 rows."""
    h = samples.shape[0]
    flat = samples.reshape(h, -1)
    if depth == 16:
        return np.stack([flat >> 8, flat & 255], axis=-1).reshape(h, -1).astype(np.uint8)
    if depth == 8:
        return flat.astype(np.uint8)
    bits = ((flat[..., None] >> np.arange(depth - 1, -1, -1)) & 1).reshape(h, -1)
    return np.packbits(bits.astype(np.uint8), axis=1)


def _png(samples: np.ndarray, depth: int, color_type: int, filters=(0,), interlace=0,
         palette=None, trns=None) -> bytes:
    h, w, c = samples.shape
    bpp = max(c * depth // 8, 1)
    if interlace:
        raw = b""
        for x0, y0, dx, dy in _ADAM7:
            sub = samples[y0::dy, x0::dx]
            if sub.size:
                raw += _filter_rows(_pack_rows(sub, depth), bpp, filters)
    else:
        raw = _filter_rows(_pack_rows(samples, depth), bpp, filters)
    data = b"\x89PNG\r\n\x1a\n" + _png_chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0, interlace))
    if palette is not None:
        data += _png_chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        data += _png_chunk(b"tRNS", trns)
    half = len(raw) // 2   # two IDAT chunks: the decoder joins them
    z = zlib.compress(raw)
    return (data + _png_chunk(b"IDAT", z[:half]) + _png_chunk(b"IDAT", z[half:])
            + _png_chunk(b"IEND", b""))


def _png_cases():
    rng = np.random.default_rng(11)
    r = lambda h, w, c, hi: rng.integers(0, hi, (h, w, c))
    all_filters = (0, 1, 2, 3, 4)
    return {
        "rgba8_all_filters": _png(r(13, 9, 4, 256), 8, 6, all_filters),
        "rgb8_paeth": _png(r(7, 11, 3, 256), 8, 2, (4,)),
        "rgb8_color_key": _png(r(6, 6, 3, 4), 8, 2, (1,), trns=struct.pack(">HHH", 1, 2, 3)),
        "gray8_average": _png(r(9, 5, 1, 256), 8, 0, (3,)),
        "gray_alpha8": _png(r(5, 8, 2, 256), 8, 4, (2, 1)),
        "gray4": _png(r(6, 7, 1, 16), 4, 0),
        "gray1_color_key": _png(r(5, 13, 1, 2), 1, 0, trns=struct.pack(">H", 1)),
        "palette2_trns": _png(r(8, 9, 1, 4), 2, 3, palette=r(4, 3, 1, 256)[..., 0],
                              trns=bytes([0, 128, 255])),
        "palette8": _png(r(4, 4, 1, 17), 8, 3, (4,), palette=r(17, 3, 1, 256)[..., 0]),
        "rgb16_color_key": _png(r(5, 5, 3, 3) * 257, 16, 2, (0, 4),
                                trns=struct.pack(">HHH", 257, 514, 0)),
        "rgba16": _png(r(6, 4, 4, 65536), 16, 6, all_filters),
        "rgba8_adam7": _png(r(11, 10, 4, 256), 8, 6, (0, 1, 4), interlace=1),
        "gray2_adam7": _png(r(9, 9, 1, 4), 2, 0, interlace=1),
    }


PNG_CASES = _png_cases()


@pytest.mark.parametrize("name", sorted(PNG_CASES))
def test_decode_png_matches_jax(name):
    data = PNG_CASES[name]
    got, want = port_gltf.decode_png(data), jax_gltf.decode_png(data)
    assert got.dtype == np.uint8 and got.shape == want.shape and got.shape[2] == 4
    assert np.array_equal(got, want)
    assert got[..., :3].any()


@pytest.mark.parametrize("data", [b"nope", _png(np.zeros((2, 2, 1), int), 8, 5),
                                  _png(np.zeros((2, 2, 3), int), 4, 2),
                                  _png(np.zeros((2, 2, 1), int), 8, 3),
                                  _png(np.full((2, 2, 1), 9), 8, 3, palette=np.zeros((4, 3)))],
                         ids=["not_png", "bad_color_type", "bad_depth", "palette_without_plte",
                              "index_past_palette"])
def test_decode_png_rejects_what_jax_rejects(data):
    with pytest.raises(port_gltf.GltfError):
        port_gltf.decode_png(data)
    with pytest.raises(jax_gltf.GltfError):
        jax_gltf.decode_png(data)


# ---------------------------------------------------------------- JPEG

def _smooth(w, h, seed=0):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    rng = np.random.default_rng(seed)
    a, b, c = rng.uniform(15, 35, 3)
    img = np.stack([127 + 100 * np.sin(xx / a) * np.cos(yy / b), 127 + 100 * np.cos(xx / c + 1.0),
                    127 + 100 * np.sin((xx + yy) / 31.0)], -1)
    return np.clip(img, 0, 255).astype(np.uint8)


def _jpeg(img, **kw):
    pil = pytest.importorskip("PIL.Image")
    buf = io.BytesIO()
    pil.fromarray(img).save(buf, format="JPEG", **kw)
    return buf.getvalue()


JPEG_CASES = {
    "baseline_444": lambda: _jpeg(_smooth(67, 45, 1), quality=92, subsampling=0),
    "baseline_422": lambda: _jpeg(_smooth(50, 38, 2), quality=85, subsampling=1),
    "baseline_420": lambda: _jpeg(_smooth(130, 94, 3), quality=90, subsampling=2),
    "progressive_420": lambda: _jpeg(_smooth(90, 70, 4), quality=88, progressive=True,
                                     subsampling=2),
    "progressive_444": lambda: _jpeg(_smooth(41, 33, 5), quality=80, progressive=True,
                                     subsampling=0),
    "gray": lambda: _jpeg(_smooth(64, 48, 6)[..., 0], quality=95),
    "gray_progressive": lambda: _jpeg(_smooth(72, 56, 7)[..., 0], quality=92, progressive=True),
}


@pytest.mark.parametrize("scan", ["native", "python"])
@pytest.mark.parametrize("name", sorted(JPEG_CASES))
def test_decode_jpeg_matches_jax(name, scan, monkeypatch):
    """Both scan decoders of the port give the JAX package's bytes."""
    data = JPEG_CASES[name]()
    monkeypatch.setattr(port_jpeg, "use_native", scan == "native")
    assert port_jpeg.scan_decoder() == scan
    got, want = port_jpeg.decode_jpeg(data), jax_jpeg.decode_jpeg(data)
    assert got.shape == want.shape and np.array_equal(got, want)
    assert (got[..., 3] == 255).all() and got[..., :3].std() > 10


def test_jpeg_scan_decoder_is_named_and_never_switches_silently(tmp_path, monkeypatch):
    """The Python scan takes over only when the library file is absent; a
    file that is there and does not load is an error."""
    assert port_jpeg.scan_decoder() == "native"
    monkeypatch.setattr(port_jpeg, "_NATIVE", None)
    monkeypatch.setattr(port_jpeg, "NATIVE_LIB", str(tmp_path / "absent.so"))
    assert port_jpeg.scan_decoder() == "python"
    broken = tmp_path / "broken.so"
    broken.write_bytes(b"not a shared library")
    monkeypatch.setattr(port_jpeg, "_NATIVE", None)
    monkeypatch.setattr(port_jpeg, "NATIVE_LIB", str(broken))
    with pytest.raises(OSError):
        port_jpeg.scan_decoder()
    with pytest.raises(port_jpeg.JpegError):
        port_jpeg.decode_jpeg(b"\x89PNG\r\n\x1a\nnope")


# ---------------------------------------------------------------- glTF fixtures

def _uri(data: bytes, mime="application/octet-stream") -> str:
    return f"data:{mime};base64," + base64.b64encode(data).decode()


def rich_gltf() -> dict:
    """A glTF document that reaches every branch of the loader: an
    interleaved (byte-strided) vertex buffer with u8 indices, a triangle
    strip with normalised u16 uvs, a triangle fan, u32 indices without uvs, a
    sparse accessor, nested nodes with TRS and a column-major matrix, a
    camera, a directional, a point and a spot light, metallic-roughness,
    spec-gloss and transmission / ior / specular / volume materials with all
    six texture kinds, CLAMP and MIRRORED samplers, PNG images in a buffer
    view and in a data URI, and an image of an unknown format (a warning and
    a white placeholder)."""
    rng = np.random.default_rng(7)
    blob = bytearray()
    views, accessors = [], []

    def view(data: bytes, stride=None) -> int:
        while len(blob) % 4:
            blob.append(0)
        v = {"buffer": 0, "byteOffset": len(blob), "byteLength": len(data)}
        if stride:
            v["byteStride"] = stride
        blob.extend(data)
        views.append(v)
        return len(views) - 1

    def accessor(view_idx, ctype, count, type_, offset=0, **kw) -> int:
        accessors.append({"bufferView": view_idx, "byteOffset": offset, "componentType": ctype,
                          "count": count, "type": type_, **kw})
        return len(accessors) - 1

    # A: a 3x3 grid, position + uv interleaved (stride 20), u8 indices
    gx, gy = np.meshgrid(np.arange(3, dtype=np.float32), np.arange(3, dtype=np.float32))
    pos_a = np.stack([gx.reshape(-1), gy.reshape(-1), np.zeros(9, np.float32)], 1)
    uv_a = rng.uniform(-1.0, 2.0, (9, 2)).astype(np.float32)
    inter = view(np.concatenate([pos_a, uv_a], 1).astype(np.float32).tobytes(), stride=20)
    a_pos = accessor(inter, 5126, 9, "VEC3")
    a_uv = accessor(inter, 5126, 9, "VEC2", offset=12)
    quads = [(r * 3 + c, r * 3 + c + 1, r * 3 + c + 4, r * 3 + c, r * 3 + c + 4, r * 3 + c + 3)
             for r in range(2) for c in range(2)]
    a_idx = accessor(view(np.asarray(quads, np.uint8).tobytes()), 5121, 24, "SCALAR")
    # B: a strip of 7 vertices, uvs as normalised u16, two vertices repeated bit for bit
    pos_b = rng.uniform(-2, 2, (7, 3)).astype(np.float32)
    pos_b[5] = pos_b[1]
    uv_b = rng.integers(0, 65536, (7, 2)).astype(np.uint16)
    uv_b[5] = uv_b[1]
    b_pos = accessor(view(pos_b.tobytes()), 5126, 7, "VEC3")
    b_uv = accessor(view(uv_b.tobytes()), 5123, 7, "VEC2", normalized=True)
    # C: a fan of 6 vertices with a sparse override of two positions
    pos_c = rng.uniform(-1, 1, (6, 3)).astype(np.float32)
    c_pos = accessor(view(pos_c.tobytes()), 5126, 6, "VEC3")
    accessors[c_pos]["sparse"] = {
        "count": 2,
        "indices": {"bufferView": view(np.asarray([1, 4], np.uint16).tobytes()),
                    "componentType": 5123},
        "values": {"bufferView": view(rng.uniform(2, 3, (2, 3)).astype(np.float32).tobytes())}}
    c_uv = accessor(view(rng.uniform(0, 1, (6, 2)).astype(np.float32).tobytes()), 5126, 6, "VEC2")
    # D: u32 indices, no uvs, 2 triangles and a dangling fourth-to-seventh index
    pos_d = rng.uniform(-3, 3, (5, 3)).astype(np.float32)
    d_pos = accessor(view(pos_d.tobytes()), 5126, 5, "VEC3")
    d_idx = accessor(view(np.asarray([0, 1, 2, 2, 3, 4, 1], np.uint32).tobytes()), 5125, 7,
                     "SCALAR")
    # E: non-indexed triangles, points (skipped with a warning)
    e_pos = accessor(view(rng.uniform(-1, 1, (6, 3)).astype(np.float32).tobytes()), 5126, 6,
                     "VEC3")

    images = [rng.integers(0, 256, (5, 9, 4)), rng.integers(0, 256, (8, 4, 3))]
    png0 = _png(images[0], 8, 6, (0, 1, 2, 3, 4))
    png1 = _png(images[1], 8, 2, (4,))
    img_view = view(png0)
    tex = lambda i: {"index": i}
    doc = {
        "asset": {"version": "2.0"},
        "scene": 1,
        "scenes": [{"nodes": []}, {"name": "main", "nodes": [0, 3, 4]}],
        "nodes": [
            {"name": "root", "translation": [0.5, -1.0, 2.0],
             "rotation": [0.1825742, 0.3651484, 0.5477226, 0.7302967],
             "scale": [1.5, 0.5, 2.0], "children": [1, 2]},
            {"mesh": 0, "matrix": [0.0, 1.0, 0.0, 0.0, -1.0, 0.0, 0.0, 0.0,
                                   0.0, 0.0, 1.0, 0.0, 3.0, 2.0, 1.0, 1.0]},
            {"camera": 0, "translation": [0.0, 1.0, 6.0],
             "rotation": [0.0, 0.3826834, 0.0, 0.9238795]},
            {"mesh": 1, "translation": [0.0, 0.0, -4.0],
             "extensions": {"KHR_lights_punctual": {"light": 0}}},
            {"children": [5, 6], "rotation": [0.7071068, 0.0, 0.0, 0.7071068]},
            {"translation": [1.0, 4.0, 2.0],
             "extensions": {"KHR_lights_punctual": {"light": 1}}},
            {"translation": [-2.0, 3.0, 1.0], "rotation": [0.0, 0.0, 0.3826834, 0.9238795],
             "extensions": {"KHR_lights_punctual": {"light": 2}}},
        ],
        "cameras": [{"name": "eye", "type": "perspective",
                     "perspective": {"yfov": 0.8, "znear": 0.01}},
                    {"type": "orthographic",
                     "orthographic": {"xmag": 1, "ymag": 1, "znear": 0.1, "zfar": 10}}],
        "extensions": {"KHR_lights_punctual": {"lights": [
            {"name": "sun", "type": "directional", "color": [1.0, 0.9, 0.8], "intensity": 2.5},
            {"type": "point", "color": [0.2, 0.4, 1.0], "intensity": 30.0, "range": 12.5},
            {"type": "spot", "intensity": 8.0,
             "spot": {"innerConeAngle": 0.2, "outerConeAngle": 0.6}}]}},
        "meshes": [
            {"primitives": [
                {"attributes": {"POSITION": a_pos, "TEXCOORD_0": a_uv}, "indices": a_idx,
                 "material": 0},
                {"attributes": {"POSITION": b_pos, "TEXCOORD_0": b_uv}, "mode": 5,
                 "material": 1},
                {"attributes": {"POSITION": e_pos}, "mode": 0, "material": 0}]},
            {"primitives": [
                {"attributes": {"POSITION": c_pos, "TEXCOORD_0": c_uv}, "mode": 6,
                 "material": 2},
                {"attributes": {"POSITION": d_pos}, "indices": d_idx, "material": 3},
                {"attributes": {"POSITION": e_pos}}]},
        ],
        "materials": [
            {"pbrMetallicRoughness": {"baseColorFactor": [0.8, 0.7, 0.6, 1.0],
                                      "metallicFactor": 0.25, "roughnessFactor": 0.75,
                                      "baseColorTexture": tex(0),
                                      "metallicRoughnessTexture": tex(1)},
             "normalTexture": tex(2), "occlusionTexture": tex(1),
             "emissiveTexture": tex(0), "emissiveFactor": [0.1, 0.2, 0.3]},
            {"extensions": {"KHR_materials_pbrSpecularGlossiness": {
                "diffuseFactor": [0.3, 0.5, 0.7, 1.0], "specularFactor": [0.9, 0.8, 0.7],
                "glossinessFactor": 0.35, "diffuseTexture": tex(1),
                "specularGlossinessTexture": tex(2)}}},
            {"pbrMetallicRoughness": {"baseColorFactor": [0.9, 0.95, 1.0, 1.0],
                                      "metallicFactor": 0.0, "roughnessFactor": 0.05},
             "extensions": {"KHR_materials_transmission": {"transmissionFactor": 0.85},
                            "KHR_materials_ior": {"ior": 1.33},
                            "KHR_materials_specular": {"specularFactor": 0.5,
                                                       "specularColorFactor": [1.0, 0.5, 0.25]},
                            "KHR_materials_volume": {"thicknessFactor": 0.4,
                                                     "attenuationDistance": 2.5,
                                                     "attenuationColor": [0.2, 0.9, 0.4]}}},
            {},
        ],
        "samplers": [{"wrapS": 33071, "wrapT": 33071}, {"wrapS": 33648}],
        "textures": [{"source": 0, "sampler": 0}, {"source": 1, "sampler": 1}, {"source": 2},
                     {"source": 1, "sampler": 7}],
        "images": [{"bufferView": img_view, "mimeType": "image/png"},
                   {"uri": _uri(png1, "image/png")},
                   {"uri": _uri(b"GIF89a not an image this loader reads", "image/gif")}],
        "accessors": accessors,
        "bufferViews": views,
    }
    doc["buffers"] = [{"byteLength": len(blob), "uri": _uri(bytes(blob))}]
    return doc


GLTF_DOCS = {"cornell": cornell_box_gltf, "rich": rich_gltf}


@pytest.fixture(scope="module")
def gltf_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("gltf")
    out = {}
    for name, make in GLTF_DOCS.items():
        doc = make()
        out[name, "gltf"] = write_gltf(d / f"{name}.gltf", doc)
        (d / f"{name}.glb").write_bytes(to_glb(doc))
        out[name, "glb"] = str(d / f"{name}.glb")
    return out


def _built(rows) -> dict:
    built = rows.build()
    return {f.name: getattr(built, f.name) for f in dataclasses.fields(built)}


def _same(a, b) -> bool:
    if isinstance(a, (tuple, list)) and not isinstance(a, np.ndarray):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if a is None or isinstance(a, (str, int, bool)):
        return a == b
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    if a.dtype.kind == "f":
        a, b = (np.ascontiguousarray(x, np.float32).view(np.uint32) for x in (a, b))
    return a.shape == b.shape and np.array_equal(a.astype(np.int64), b.astype(np.int64))


def _loaded_fields(loaded) -> dict:
    out = {k: getattr(loaded, k) for k in ("vertices", "triangles", "tri_materials", "uvs",
                                           "images", "texture_image", "texture_wrap",
                                           "image_warnings")}
    out.update({f"materials.{k}": v for k, v in _built(loaded.materials).items()})
    out.update({f"lights.{k}": v for k, v in _built(loaded.lights).items()})
    for i, cam in enumerate(loaded.cameras):
        out.update({f"camera{i}.{f.name}": getattr(cam, f.name)
                    for f in dataclasses.fields(cam)})
    out["n_cameras"] = len(loaded.cameras)
    return out


@pytest.mark.parametrize("container", ["gltf", "glb"])
@pytest.mark.parametrize("name", sorted(GLTF_DOCS))
def test_load_gltf_matches_jax(gltf_files, name, container):
    path = gltf_files[name, container]
    got, want = _loaded_fields(port_gltf.load_gltf(path)), _loaded_fields(jax_gltf.load_gltf(path))
    assert sorted(got) == sorted(want)
    bad = [k for k in got if not _same(got[k], want[k])]
    assert not bad, f"LoadedScene fields differ: {bad}"
    assert got["triangles"].shape[0] >= 10


def test_rich_fixture_reaches_every_loader_branch(gltf_files, capsys):
    """What the rich fixture is for, so that the equality above means
    something: strips, fans, dedup, three light kinds, the spec-gloss fold,
    the KHR extensions, wrap modes and the placeholder image are all there."""
    loaded = port_gltf.load_gltf(gltf_files["rich", "glb"])
    assert "unsupported primitive mode 0" in capsys.readouterr().err
    # 8 grid + 5 strip + 4 fan + 2 indexed + 2 non-indexed triangles
    assert loaded.triangles.shape[0] == 21
    # the strip's repeated vertex is one vertex: 9 + 6 + 6 + 5 + 6
    assert loaded.vertices.shape[0] == 32
    m = loaded.materials.build()
    assert m.material_type.tolist() == [0, 1, 0, 0]
    assert torch.equal(m.albedo[1], torch.tensor([0.3, 0.5, 0.7]))     # diffuse -> albedo
    ti = m.texture_indices
    assert ti[0].tolist()[:5] == [0, 1, 2, 1, 0] and ti[1, 5] == 2
    assert (ti[2] == int(NO_TEXTURE)).all() and m.present_slots == (0, 1, 2, 3, 4, 5)
    assert float(m.attenuation_distance[2]) == 2.5 and float(m.thickness_factor[2]) == pytest.approx(0.4)
    L = loaded.lights.build()
    assert L.light_type.tolist() == [0, 1, 2]
    assert loaded.texture_wrap == [1, 2, 0, 0] and loaded.texture_image == [0, 1, 2, 1]
    assert len(loaded.image_warnings) == 1 and loaded.images[2].shape == (1, 1, 4)
    assert len(loaded.cameras) == 1 and float(loaded.cameras[0].fov) == pytest.approx(
        np.degrees(0.8))


def _scenes_equal(port_scene, jax_scene) -> None:
    assert_arrays_equal(canonical_binary_tree(scene_to_arrays(port_scene)),
                        canonical_binary_tree(jax_scene_arrays(jax_scene)))


@pytest.mark.parametrize("container", ["gltf", "glb"])
@pytest.mark.parametrize("name", sorted(GLTF_DOCS))
def test_scene_from_gltf_bit_equal(gltf_files, name, container):
    path = gltf_files[name, container]
    scene = port_gltf.scene_from_gltf(path)
    _scenes_equal(scene, jax_gltf.scene_from_gltf(path))
    frame = Renderer(scene, 32, 24, shadows=True, device="cpu").render()
    assert np.isfinite(frame).all() and (name != "cornell" or frame.max() > 0.01)


def test_scene_from_gltf_takes_the_callers_camera_and_scene_index(gltf_files):
    from gpu_raytracer_tpu_torch.models.camera import Camera

    cam = Camera.create((1.0, 2.0, 3.0), (0.0, 0.0, -1.0), fov=30.0)
    scene = port_gltf.scene_from_gltf(gltf_files["rich", "gltf"], camera=cam)
    assert scene.camera.position.tolist() == [1.0, 2.0, 3.0]
    empty = port_gltf.scene_from_gltf(gltf_files["rich", "gltf"], scene_index=0)
    assert empty.num_triangles == 1 and empty.lights.count == 1   # the guard rows
    with pytest.raises(port_gltf.GltfError, match="Scene 5 not found"):
        port_gltf.load_gltf(gltf_files["rich", "gltf"], scene_index=5)


@pytest.mark.parametrize("bad", ["missing", "truncated_glb", "bad_json", "no_scenes"])
def test_scene_from_gltf_or_default_says_why_it_fell_back(tmp_path, capsys, bad):
    path = tmp_path / ("scene.glb" if bad == "truncated_glb" else "scene.gltf")
    if bad == "truncated_glb":
        path.write_bytes(to_glb(cornell_box_gltf())[:40])
    elif bad == "bad_json":
        path.write_text("{ not json")
    elif bad == "no_scenes":
        path.write_text(json.dumps({"asset": {"version": "2.0"}}))
    with pytest.raises(Exception):
        port_gltf.scene_from_gltf(str(path))
    capsys.readouterr()
    scene = port_gltf.scene_from_gltf_or_default(str(path))
    err = capsys.readouterr().err
    assert f"Failed to load glTF scene '{path}'" in err and "using default scene" in err
    assert scene.spheres.count == 6 and scene.num_triangles == 2


def test_jpeg_textures_load_through_the_glb(tmp_path):
    """A JPEG image in a GLB buffer view decodes to the JAX package's bytes."""
    doc = cornell_box_gltf()
    jpg = JPEG_CASES["baseline_420"]()
    raw = base64.b64decode(doc["buffers"][0]["uri"].split(",", 1)[1])
    raw += b"\x00" * (-len(raw) % 4)
    doc["bufferViews"].append({"buffer": 0, "byteOffset": len(raw), "byteLength": len(jpg)})
    doc["buffers"][0] = {"byteLength": len(raw) + len(jpg), "uri": _uri(raw + jpg)}
    doc["images"] = [{"bufferView": len(doc["bufferViews"]) - 1, "mimeType": "image/jpeg"}]
    doc["textures"] = [{"source": 0}]
    doc["materials"][0]["pbrMetallicRoughness"]["baseColorTexture"] = {"index": 0}
    path = tmp_path / "jpeg.glb"
    path.write_bytes(to_glb(doc))
    got, want = port_gltf.load_gltf(str(path)), jax_gltf.load_gltf(str(path))
    assert not got.image_warnings and got.images[0].shape == (94, 130, 4)
    assert np.array_equal(got.images[0], want.images[0])
    _scenes_equal(port_gltf.scene_from_gltf(str(path)), jax_gltf.scene_from_gltf(str(path)))


# ---------------------------------------------------------------- the zoo, the writer

@pytest.mark.parametrize("multi_slot", [False, True])
def test_zoo_scene_tables_bit_equal(multi_slot):
    got = procgen.make_zoo_scene(800, seed=0, multi_slot=multi_slot)
    _scenes_equal(got, jax_procgen.make_zoo_scene(800, seed=0, multi_slot=multi_slot))
    assert got.materials.count == 48 and got.textures.count == 24
    assert got.materials.present_slots == ((0, 1, 3, 4) if multi_slot else (0,))
    assert got.materials.material_type.sum() == 8            # every sixth is spec-gloss
    # the 2048-row budget dropped levels: 24 full chains would need more
    assert got.textures.num_rows <= 2048 and got.textures.levels.min() < 8


def test_zoo_source_images_equal():
    for a, b in zip(procgen.zoo_source_images(7, seed=3), jax_procgen.zoo_source_images(7, seed=3),
                    strict=True):
        assert np.array_equal(a, b)


def _export_case(name):
    """(port scene, JAX scene, source images, wraps) of one writer case."""
    if name == "courtyard2000_textured":
        return (procgen.make_courtyard_scene(2000, seed=0, textured=True),
                jax_procgen.make_courtyard_scene(2000, seed=0, textured=True),
                procgen.courtyard_source_images(0), None)
    if name == "courtyard1500_64_lights":
        return (procgen.make_courtyard_scene(1500, seed=3, lights=64),
                jax_procgen.make_courtyard_scene(1500, seed=3, lights=64), None, None)
    if name == "default":
        from gpu_raytracer_tpu.models.scene import build_default_scene as jax_default
        from gpu_raytracer_tpu_torch.models.scene import build_default_scene

        return build_default_scene(), jax_default(), None, None
    multi = name == "zoo800_multi_slot"
    wraps = [i % 3 for i in range(24)] if multi else None
    return (procgen.make_zoo_scene(800, seed=0, multi_slot=multi),
            jax_procgen.make_zoo_scene(800, seed=0, multi_slot=multi),
            procgen.zoo_source_images(24, 0), wraps)


EXPORT_CASES = ["courtyard1500_64_lights", "courtyard2000_textured", "default", "zoo800",
                "zoo800_multi_slot"]


@pytest.mark.parametrize("name", EXPORT_CASES)
def test_export_glb_bytes_equal(tmp_path, name):
    ps, js, images, wraps = _export_case(name)
    export_glb(ps, str(tmp_path / "port.glb"), images=images, texture_wrap=wraps)
    jax_export_glb(js, str(tmp_path / "jax.glb"), images=images, texture_wrap=wraps)
    got = (tmp_path / "port.glb").read_bytes()
    assert got[:4] == b"glTF" and got == (tmp_path / "jax.glb").read_bytes()


def test_export_glb_needs_the_source_images(tmp_path):
    scene = procgen.make_zoo_scene(800, seed=0)
    with pytest.raises(ValueError, match="source images"):
        export_glb(scene, str(tmp_path / "x.glb"), images=procgen.zoo_source_images(3, 0))


@pytest.mark.parametrize("shadows", [False, True])
@pytest.mark.parametrize("name", ["courtyard2000_textured", "courtyard1500_64_lights"])
def test_round_trip_frame_equals_the_procedural_frame(tmp_path, name, shadows):
    """scene -> GLB -> scene -> frame: the loader re-orders vertices and
    triangles, the canonical scene build undoes it, and the frame is the
    procedural scene's to the bit (max |diff| 0.0)."""
    ps, _, images, wraps = _export_case(name)
    path = str(tmp_path / "scene.glb")
    export_glb(ps, path, images=images, texture_wrap=wraps)
    loaded = port_gltf.scene_from_gltf(path)
    assert loaded.num_triangles == ps.num_triangles
    W, H = 64, 48
    want = Renderer(ps, W, H, shadows=shadows, device="cpu").render()
    got = Renderer(loaded, W, H, shadows=shadows, device="cpu").render()
    assert want.max() > 0.05 and np.abs(got - want).max() == 0.0


@pytest.mark.parametrize("name", ["zoo800", "zoo800_multi_slot"])
def test_zoo_round_trip_scene_bit_equal(tmp_path, name):
    """The zoo through the writer and the loader is another scene than the
    procedural one in both packages (the loader folds spec-gloss materials to
    metallic 0 / roughness 1 - glossiness and packs the atlas under the
    general row budget, not the zoo's): it is held to the JAX package's load
    of the same file, and still shows every material and map."""
    ps, _, images, wraps = _export_case(name)
    path = str(tmp_path / "zoo.glb")
    export_glb(ps, path, images=images, texture_wrap=wraps)
    loaded = port_gltf.scene_from_gltf(path)
    _scenes_equal(loaded, jax_gltf.scene_from_gltf(path))
    assert loaded.materials.present_slots == ps.materials.present_slots
    assert loaded.textures.num_rows > ps.textures.num_rows
    assert loaded.textures.wrap.tolist() == (wraps or [0] * 24)
    frame = Renderer(loaded, 64, 48, shadows=True, device="cpu").render()
    ref = Renderer(ps, 64, 48, shadows=True, device="cpu").render()
    assert np.isfinite(frame).all() and 0.0 < np.abs(frame - ref).mean() < 0.05
