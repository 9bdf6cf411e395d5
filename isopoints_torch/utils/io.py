"""PLY, OBJ and PNG I/O (own copy of isopoints_tpu/utils/io.py: `read_ply`,
`read_obj`, `load_mesh`, `save_ply`, `save_ply_property`, `save_image`,
`load_image`).

numpy and the standard library only. Images go through this module's own
PNG codec (`zlib` + `struct`), since imageio and Pillow are not part of
the port's requirements: 8-bit gray, gray + alpha, RGB and RGBA,
non-interlaced, all five row filters on reading; the writer uses filter 0.
16-bit, palette and interlaced files raise, naming the format.
"""

import os
import struct
import zlib
from typing import Dict, Optional

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "uchar": "u1", "int8": "i1", "uint8": "u1",
    "short": "i2", "ushort": "u2", "int16": "i2", "uint16": "u2",
    "int": "i4", "uint": "u4", "int32": "i4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}
_INV_DTYPES = {"f4": "float", "f8": "double", "u1": "uchar", "i4": "int", "u4": "uint"}


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Read a PLY file (ascii, binary little or big endian; list
    properties). Returns `points` (N, 3); optional `normals` (N, 3),
    `colors` (N, 3) in [0, 1], `faces` (F, 3), and any other vertex
    property under its own name."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # [name, count, [(prop, dtype) | ("list", idx_dt, val_dt, name)]]
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unexpected EOF in header")
            tokens = line.strip().decode("ascii", "replace").split()
            if not tokens:
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "element":
                elements.append([tokens[1], int(tokens[2]), []])
            elif tokens[0] == "property":
                if tokens[1] == "list":
                    elements[-1][2].append(("list", _PLY_DTYPES[tokens[2]],
                                            _PLY_DTYPES[tokens[3]], tokens[4]))
                else:
                    elements[-1][2].append((tokens[2], _PLY_DTYPES[tokens[1]]))
            elif tokens[0] == "end_header":
                break
        out: Dict[str, np.ndarray] = {}
        for name, count, props in elements:
            if fmt == "ascii":
                data = _read_ascii_element(f, count, props)
            else:
                endian = "<" if "little" in fmt else ">"
                data = _read_binary_element(f, count, props, endian)
            if name == "vertex":
                _collect_vertex(out, data)
            elif name == "face":
                lst = data.get("vertex_indices", data.get("vertex_index"))
                if lst is not None:
                    out["faces"] = np.asarray(lst, dtype=np.int64)
    return out


def _read_ascii_element(f, count, props):
    data: Dict[str, list] = {}
    for _ in range(count):
        vals = f.readline().split()
        i = 0
        for p in props:
            if p[0] == "list":
                n = int(vals[i])
                i += 1
                data.setdefault(p[3], []).append([float(v) for v in vals[i:i + n]])
                i += n
            else:
                data.setdefault(p[0], []).append(float(vals[i]))
                i += 1
    return {k: np.asarray(v) for k, v in data.items()}


def _read_binary_element(f, count, props, endian):
    if all(p[0] != "list" for p in props):
        dt = np.dtype([(p[0], endian + p[1]) for p in props])
        arr = np.frombuffer(f.read(dt.itemsize * count), dtype=dt, count=count)
        return {p[0]: np.asarray(arr[p[0]]) for p in props}
    data: Dict[str, list] = {}
    for _ in range(count):
        for p in props:
            if p[0] == "list":
                idx_dt = np.dtype(endian + p[1])
                n = int(np.frombuffer(f.read(idx_dt.itemsize), idx_dt)[0])
                val_dt = np.dtype(endian + p[2])
                vals = np.frombuffer(f.read(val_dt.itemsize * n), val_dt, count=n)
                data.setdefault(p[3], []).append(vals)
            else:
                dt = np.dtype(endian + p[1])
                data.setdefault(p[0], []).append(np.frombuffer(f.read(dt.itemsize), dt)[0])
    return {k: np.asarray(v) for k, v in data.items()}


def _collect_vertex(out, data):
    out["points"] = np.stack([data["x"], data["y"], data["z"]], -1).astype(np.float32)
    if all(k in data for k in ("nx", "ny", "nz")):
        out["normals"] = np.stack([data["nx"], data["ny"], data["nz"]], -1).astype(np.float32)
    if all(k in data for k in ("red", "green", "blue")):
        c = np.stack([data["red"], data["green"], data["blue"]], -1).astype(np.float32)
        out["colors"] = c / 255.0 if c.max() > 1.0 else c
    for k, v in data.items():
        if k not in ("x", "y", "z", "nx", "ny", "nz", "red", "green", "blue", "alpha"):
            out[k] = np.asarray(v)


def read_obj(path: str) -> Dict[str, np.ndarray]:
    """Wavefront OBJ mesh: `v` and `f` records (faces fan-triangulated,
    v/vt/vn and negative indices handled) as {'points': (V, 3),
    'faces': (F, 3)}."""
    verts: list = []
    faces: list = []
    with open(path, "r", errors="replace") as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            if tok[0] == "v" and len(tok) >= 4:
                verts.append([float(tok[1]), float(tok[2]), float(tok[3])])
            elif tok[0] == "f" and len(tok) >= 4:
                idx = []
                for t in tok[1:]:
                    i = int(t.split("/")[0])
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return {"points": np.asarray(verts, np.float32),
            "faces": np.asarray(faces, np.int64)}


def load_mesh(path: str) -> Dict[str, np.ndarray]:
    """Load a PLY or OBJ mesh as {'points', 'faces'}."""
    ext = os.path.splitext(path)[1].lower()
    out = read_obj(path) if ext == ".obj" else read_ply(path)
    if "faces" not in out or len(out["faces"]) == 0:
        raise ValueError(f"{path}: no faces — not a mesh")
    return out


def save_ply(path: str, points: np.ndarray, normals: Optional[np.ndarray] = None,
             colors: Optional[np.ndarray] = None, faces: Optional[np.ndarray] = None,
             binary: bool = True,
             extra_props: Optional[Dict[str, np.ndarray]] = None) -> None:
    """Write a PLY point cloud or mesh (float colours in [0, 1] stored as
    uchar, extra properties as float)."""
    points = np.asarray(points, np.float32).reshape(-1, 3)
    n = points.shape[0]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    cols: list = [("x", "f4", points[:, 0]), ("y", "f4", points[:, 1]), ("z", "f4", points[:, 2])]
    if normals is not None:
        nr = np.asarray(normals, np.float32).reshape(-1, 3)
        cols += [("nx", "f4", nr[:, 0]), ("ny", "f4", nr[:, 1]), ("nz", "f4", nr[:, 2])]
    if colors is not None:
        c = np.asarray(colors)
        if c.dtype.kind == "f":
            c = np.clip(c * 255.0, 0, 255).astype(np.uint8)
        c = c.reshape(-1, 3)
        cols += [("red", "u1", c[:, 0]), ("green", "u1", c[:, 1]), ("blue", "u1", c[:, 2])]
    for k, v in (extra_props or {}).items():
        cols.append((k, "f4", np.asarray(v, np.float32).reshape(-1)))

    header = ["ply",
              "format binary_little_endian 1.0" if binary else "format ascii 1.0",
              f"element vertex {n}"]
    header += [f"property {_INV_DTYPES[dt]} {name}" for name, dt, _ in cols]
    if faces is not None:
        faces = np.asarray(faces, np.int32).reshape(-1, 3)
        header.append(f"element face {faces.shape[0]}")
        header.append("property list uchar int vertex_indices")
    header.append("end_header")

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if binary:
            dt = np.dtype([(name, "<" + d) for name, d, _ in cols])
            rec = np.empty(n, dtype=dt)
            for name, _, v in cols:
                rec[name] = v
            f.write(rec.tobytes())
            if faces is not None:
                fdt = np.dtype([("n", "u1"), ("a", "<i4"), ("b", "<i4"), ("c", "<i4")])
                frec = np.empty(faces.shape[0], dtype=fdt)
                frec["n"] = 3
                frec["a"], frec["b"], frec["c"] = faces[:, 0], faces[:, 1], faces[:, 2]
                f.write(frec.tobytes())
        else:
            for i in range(n):
                f.write((" ".join(str(v[i]) for _, _, v in cols) + "\n").encode())
            if faces is not None:
                for tri in faces:
                    f.write(f"3 {tri[0]} {tri[1]} {tri[2]}\n".encode())


# ---- PNG
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels, for the 8-bit types this codec handles
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_PNG_TYPES = {1: 0, 2: 4, 3: 2, 4: 6}


def save_ply_property(path: str, points: np.ndarray, prop: np.ndarray,
                      cmap_name: str = "jet", normals=None, binary=True) -> None:
    """Points coloured by a scalar through the colour map, the scalar kept
    as the float property `quality` (io.py:206-212)."""
    from isopoints_torch.utils import scaler_to_color

    colors = scaler_to_color(np.asarray(prop), cmap=cmap_name)
    save_ply(path, points, normals=normals, colors=colors, binary=binary,
             extra_props={"quality": np.asarray(prop, np.float32)})


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """uint8 (H, W) gray, (H, W, 1) gray, (H, W, 2) gray + alpha, (H, W, 3)
    RGB or (H, W, 4) RGBA, as a non-interlaced 8-bit PNG, every row with
    filter 0."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"{path}: the PNG writer takes uint8 pixels, got {img.dtype}")
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    channels = 1 if img.ndim == 2 else img.shape[-1]
    if img.ndim not in (2, 3) or channels not in _PNG_TYPES:
        raise ValueError(f"{path}: cannot write an image of shape {img.shape} as PNG")
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(img).reshape(h, w * channels)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _PNG_TYPES[channels], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + _chunk(b"IEND", b""))


def _unfilter_row(kind: int, line: np.ndarray, prev: np.ndarray, bpp: int,
                  path: str) -> np.ndarray:
    """One reconstructed row of a PNG scanline (PNG spec §9.2)."""
    if kind == 0:
        return line
    if kind == 1:   # Sub: running sums per channel, mod 256
        return np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
    if kind == 2:   # Up
        return line + prev
    if kind not in (3, 4):
        raise ValueError(f"{path}: unknown PNG row filter {kind}")
    out = bytearray(line.tobytes())
    up = prev.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = up[i]
        if kind == 3:   # Average
            out[i] = (out[i] + ((a + b) >> 1)) & 0xFF
        else:           # Paeth
            c = up[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out[i] = (out[i] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def read_png(path: str) -> np.ndarray:
    """An 8-bit non-interlaced gray, gray + alpha, RGB or RGBA PNG as uint8
    (H, W) or (H, W, C). Ancillary chunks are skipped; 16-bit, palette,
    low-bit-depth and interlaced files raise."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos + 8 <= len(blob):
        n, kind = struct.unpack(">I4s", blob[pos:pos + 8])
        data = blob[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if ctype == 3:
        raise ValueError(f"{path}: palette PNG (colour type 3) is not supported")
    if depth != 8:
        raise ValueError(f"{path}: {depth}-bit PNG is not supported (8-bit only)")
    if ctype not in _PNG_CHANNELS:
        raise ValueError(f"{path}: unknown PNG colour type {ctype}")
    if interlace:
        raise ValueError(f"{path}: interlaced (Adam7) PNG is not supported")
    bpp = _PNG_CHANNELS[ctype]
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"{path}: PNG data holds {raw.size} bytes, expected "
                         f"{h * (stride + 1)}")
    raw = raw.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        prev = out[y] = _unfilter_row(int(raw[y, 0]), raw[y, 1:], prev, bpp, path)
    return out.reshape(h, w) if bpp == 1 else out.reshape(h, w, bpp)


def save_image(path: str, img: np.ndarray) -> None:
    """Save an HWC float image in [0, 1] (truncated to 8 bits:
    clip(img·255, 0, 255) cast to uint8) or a uint8 image, as PNG."""
    img = np.asarray(img)
    if img.dtype.kind == "f":
        img = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    write_png(path, img)


def load_image(path: str) -> np.ndarray:
    """Load a PNG as float32 HWC, divided by 255 only when its largest value
    is above 1."""
    ext = os.path.splitext(path)[1].lower()
    if ext != ".png":
        raise ValueError(f"{path}: only PNG images are read ({ext!r} is not)")
    img = read_png(path).astype(np.float32)
    if img.max() > 1.0:
        img = img / 255.0
    return img
