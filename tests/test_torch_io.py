"""The port's PLY / OBJ / PNG I/O (isopoints_torch/utils/io.py) against the
JAX package's (isopoints_tpu/utils/io.py, which reads and writes images
through imageio).

PNG: every pixel bit for bit. Files written by JAX's `save_image` load in
the port exactly as in JAX (RGB, a gray mask, RGBA, all-zero, all-one:
`load_image` divides by 255 only where the largest value is above 1), and
the port's files load in JAX exactly as in the port. The decoder covers
each of the five row filters (files encoded here row by row with a chosen
filter, and files written by Pillow, which picks filters itself), each
equal to imageio's reading; 16-bit, palette, 1-bit and interlaced files
raise. PLY: ascii and binary files written by either package read the same
in both (points, normals, colours, faces, extra properties), also a
big-endian file with a list property; OBJ with quads and negative indices.
"""

import struct
import zlib

import imageio.v2 as imageio
import numpy as np
import pytest
import torch
from PIL import Image

from isopoints_tpu.utils import io as jio
from isopoints_torch.utils import io as tio


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _images():
    rng = np.random.RandomState(0)
    return {
        "rgb": rng.uniform(0, 1, (19, 23, 3)).astype(np.float32),
        "mask": (rng.uniform(size=(19, 23)) > 0.5).astype(np.float32),
        "rgba": rng.uniform(0, 1, (19, 23, 4)).astype(np.float32),
        "all-zero": np.zeros((8, 9, 3), np.float32),
        "all-one": np.ones((8, 9), np.float32),
        "out of range": rng.uniform(-0.5, 1.5, (7, 5, 3)).astype(np.float32),
        "uint8": rng.randint(0, 256, (6, 7, 3)).astype(np.uint8),
    }


@pytest.mark.parametrize("name", list(_images()))
def test_png_written_by_jax_loads_as_in_jax(tmp_path, name):
    img = _images()[name]
    path = str(tmp_path / "a.png")
    jio.save_image(path, img)
    ref = jio.load_image(path)
    out = tio.load_image(path)
    assert out.dtype == ref.dtype == np.float32 and out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("name", list(_images()))
def test_png_written_by_the_port_loads_as_in_the_port(tmp_path, name):
    img = _images()[name]
    path = str(tmp_path / "sub" / "a.png")
    tio.save_image(path, img)
    out = tio.load_image(path)
    np.testing.assert_array_equal(jio.load_image(path), out)
    # the 8-bit truncation of save_image, then load_image's division
    u8 = img if img.dtype == np.uint8 else np.clip(img * 255.0, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(imageio.imread(path), u8)
    want = u8.astype(np.float32)
    np.testing.assert_array_equal(out, want / 255.0 if want.max() > 1.0 else want)


def _encode(img: np.ndarray, path: str, filters) -> None:
    """A PNG whose row y carries filter filters[y % len(filters)] (PNG spec
    §9.2), the encoder's side of the decoder under test."""
    h, w = img.shape[:2]
    bpp = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, w * bpp).astype(np.int64)
    raw = bytearray()
    for y in range(h):
        kind = filters[y % len(filters)]
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = up
        elif kind == 3:
            pred = (left + up) // 2
        else:
            p = left + up - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, upleft))
        raw.append(kind)
        raw += ((cur - pred) % 256).astype(np.uint8).tobytes()
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[bpp]
    chunk = lambda k, d: (struct.pack(">I", len(d)) + k + d
                          + struct.pack(">I", zlib.crc32(k + d) & 0xFFFFFFFF))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
                + chunk(b"tEXt", b"Comment\x00an ancillary chunk")
                + chunk(b"IDAT", zlib.compress(bytes(raw)))
                + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)])
def test_png_decoder_each_row_filter_against_imageio(tmp_path, channels, filters):
    rng = np.random.RandomState(channels)
    shape = (21, 13) if channels == 1 else (21, 13, channels)
    # noise plus a gradient, so the predictors differ from one another
    img = ((rng.randint(0, 256, shape) // 3
            + np.arange(13)[None, :, None].reshape((1, 13) + (1,) * (len(shape) - 2)) * 9)
           % 256).astype(np.uint8)
    path = str(tmp_path / "f.png")
    _encode(img, path, filters)
    ref = imageio.imread(path)
    np.testing.assert_array_equal(ref, img)
    np.testing.assert_array_equal(tio.read_png(path), ref)
    np.testing.assert_array_equal(tio.load_image(path), jio.load_image(path))


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_png_written_by_pillow(tmp_path, mode):
    rng = np.random.RandomState(3)
    ch = len(mode)
    base = np.add.outer(np.arange(40), np.arange(50)) * 3 % 256
    img = (base[..., None] + rng.randint(0, 4, (40, 50, ch))) % 256
    img = img.astype(np.uint8)
    if ch == 1:
        img = img[..., 0]
    path = str(tmp_path / "p.png")
    Image.fromarray(img, mode).save(path, optimize=True)
    np.testing.assert_array_equal(tio.read_png(path), imageio.imread(path))


def test_png_unsupported_formats_raise(tmp_path):
    p16 = str(tmp_path / "16.png")
    imageio.imwrite(p16, np.arange(64, dtype=np.uint16).reshape(8, 8) * 1000)
    with pytest.raises(ValueError, match="16-bit"):
        tio.load_image(p16)
    pal = str(tmp_path / "pal.png")
    Image.fromarray(np.arange(64, dtype=np.uint8).reshape(8, 8)).convert(
        "P").save(pal)
    with pytest.raises(ValueError, match="palette"):
        tio.read_png(pal)
    one = str(tmp_path / "one.png")
    Image.fromarray(np.eye(8, dtype=bool)).save(one)
    with pytest.raises(ValueError, match="1-bit"):
        tio.read_png(one)
    inter = str(tmp_path / "adam7.png")
    tio.write_png(inter, np.zeros((4, 4), np.uint8))
    blob = bytearray(open(inter, "rb").read())
    blob[28] = 1                                   # IHDR's interlace byte
    blob[29:33] = struct.pack(">I", zlib.crc32(bytes(blob[12:29])) & 0xFFFFFFFF)
    open(inter, "wb").write(bytes(blob))
    with pytest.raises(ValueError, match="interlaced"):
        tio.read_png(inter)
    with pytest.raises(ValueError, match="not a PNG"):
        tio.read_png(_write(tmp_path / "x.png", b"GIF89a"))
    with pytest.raises(ValueError, match="only PNG"):
        tio.load_image(str(tmp_path / "depth.exr"))
    with pytest.raises(ValueError, match="uint8"):
        tio.write_png(str(tmp_path / "b.png"), np.zeros((4, 4), np.uint16))


def _write(path, data: bytes) -> str:
    with open(path, "wb") as f:
        f.write(data)
    return str(path)


def _cloud(n=37, seed=0):
    rng = np.random.RandomState(seed)
    nrm = rng.normal(size=(n, 3))
    return (rng.uniform(-1, 1, (n, 3)).astype(np.float32),
            (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).astype(np.float32),
            rng.uniform(0, 1, (n, 3)).astype(np.float32),
            rng.randint(0, n, (11, 3)),
            rng.uniform(0, 5, n).astype(np.float32))


def _assert_same_ply(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("parts", ["points", "normals", "all"])
def test_ply_round_trip_against_jax(tmp_path, binary, writer, parts):
    pts, nrm, col, faces, q = _cloud()
    kw = {}
    if parts in ("normals", "all"):
        kw["normals"] = nrm
    if parts == "all":
        kw.update(colors=col, faces=faces, extra_props={"quality": q})
    path = str(tmp_path / "c.ply")
    (jio if writer == "jax" else tio).save_ply(path, pts, binary=binary, **kw)
    ref, out = jio.read_ply(path), tio.read_ply(path)
    _assert_same_ply(out, ref)
    np.testing.assert_array_equal(out["points"], pts)
    if parts == "all":
        np.testing.assert_array_equal(out["faces"], faces)
    if writer == "port":
        other = str(tmp_path / "j.ply")
        jio.save_ply(other, pts, binary=binary, **kw)
        assert open(other, "rb").read() == open(path, "rb").read()


def test_ply_big_endian_with_lists(tmp_path):
    pts, nrm, _, faces, _ = _cloud(9, 1)
    header = ("ply\nformat binary_big_endian 1.0\nelement vertex 9\n"
              "property float x\nproperty float y\nproperty float z\n"
              "property double nx\nproperty double ny\nproperty double nz\n"
              "property ushort tag\n"
              "element face 11\nproperty list uchar int vertex_indices\n"
              "end_header\n").encode()
    rec = np.empty(9, [("x", ">f4"), ("y", ">f4"), ("z", ">f4"), ("nx", ">f8"),
                       ("ny", ">f8"), ("nz", ">f8"), ("tag", ">u2")])
    for i, k in enumerate("xyz"):
        rec[k] = pts[:, i]
        rec["n" + k] = nrm[:, i]
    rec["tag"] = np.arange(9)
    body = b"".join(struct.pack(">B3i", 3, *f) for f in faces.tolist())
    path = _write(tmp_path / "be.ply", header + rec.tobytes() + body)
    ref, out = jio.read_ply(path), tio.read_ply(path)
    _assert_same_ply(out, ref)
    np.testing.assert_array_equal(out["faces"], faces)
    np.testing.assert_array_equal(out["tag"], np.arange(9))


def test_obj_and_load_mesh_against_jax(tmp_path):
    text = ("# a quad and a triangle\nv 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
            "vt 0 0\nvn 0 0 1\nf 1/1/1 2/1/1 3/1/1 4/1/1\nv 0 0 1\nf -1 1 2\n")
    path = _write(tmp_path / "m.obj", text.encode())
    _assert_same_ply(tio.read_obj(path), jio.read_obj(path))
    _assert_same_ply(tio.load_mesh(path), jio.load_mesh(path))
    assert tio.load_mesh(path)["faces"].tolist() == [[0, 1, 2], [0, 2, 3], [4, 0, 1]]
    cloud = str(tmp_path / "cloud.ply")
    tio.save_ply(cloud, _cloud()[0])
    with pytest.raises(ValueError, match="not a mesh"):
        tio.load_mesh(cloud)


@pytest.mark.parametrize("binary", [True, False])
def test_save_ply_property_against_jax(tmp_path, binary):
    """Points coloured by a scalar through "jet", the scalar as `quality`:
    the port's file equals JAX's byte for byte."""
    rng = np.random.RandomState(4)
    pts = rng.normal(size=(40, 3)).astype(np.float32)
    nrm = rng.normal(size=(40, 3)).astype(np.float32)
    prop = rng.uniform(-2, 3, 40).astype(np.float32)
    prop[3] = np.nan
    tio.save_ply_property(str(tmp_path / "t.ply"), pts, prop, normals=nrm,
                          binary=binary)
    jio.save_ply_property(str(tmp_path / "j.ply"), pts, prop, normals=nrm,
                          binary=binary)
    with open(tmp_path / "t.ply", "rb") as a, open(tmp_path / "j.ply", "rb") as b:
        assert a.read() == b.read()
    got = tio.read_ply(str(tmp_path / "t.ply"))
    # ascii keeps the printed digits of a float32
    np.testing.assert_allclose(got["quality"], prop, rtol=0 if binary else 1e-7,
                               atol=0)
    assert got["colors"].shape == (40, 3)
