"""Film IO in numpy: a minimal OpenEXR 2.0 codec (uncompressed 32-bit
float scanlines, RGBA, single part; the reference saves Rgba32F EXRs,
fragment.rs:417-474) and tonemapped PNG output (main.rs:352-366). Files
are byte-compatible with ``voxtracer/render/film.py``."""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np
import torch

from voxtracer_torch.core.color import tonemap_to_u8

_MAGIC = 20000630
_FLOAT = 2  # OpenEXR pixel type


def _attr(name: str, typ: str, data: bytes) -> bytes:
    return name.encode() + b"\0" + typ.encode() + b"\0" \
        + struct.pack("<i", len(data)) + data


def _chlist_rgba() -> bytes:
    # channels are stored sorted by name: A, B, G, R
    out = b""
    for ch in ("A", "B", "G", "R"):
        out += ch.encode() + b"\0"
        out += struct.pack("<i", _FLOAT)  # pixel type
        out += struct.pack("<BBBB", 0, 0, 0, 0)  # pLinear + reserved
        out += struct.pack("<ii", 1, 1)  # x/y sampling
    return out + b"\0"


def save_exr(path, rgba: np.ndarray):
    """Write float32 RGB(A) (H, W, 3|4) as an uncompressed scanline EXR."""
    rgba = np.asarray(rgba, np.float32)
    if rgba.ndim == 3 and rgba.shape[2] == 3:
        rgba = np.concatenate([rgba, np.ones_like(rgba[..., :1])], axis=-1)
    h, w, c = rgba.shape
    if c != 4:
        raise ValueError(f"save_exr: expected 3 or 4 channels, got {c}")

    header = b""
    header += _attr("channels", "chlist", _chlist_rgba())
    header += _attr("compression", "compression", b"\0")  # NONE
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header += _attr("dataWindow", "box2i", box)
    header += _attr("displayWindow", "box2i", box)
    header += _attr("lineOrder", "lineOrder", b"\0")  # INCREASING_Y
    header += _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
    header += _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\0"  # end of header

    preamble = struct.pack("<Ii", _MAGIC, 2) + header
    data_start = len(preamble) + 8 * h
    row_bytes = 4 * w * 4  # 4 channels * w * float32
    offsets = [data_start + i * (8 + row_bytes) for i in range(h)]
    with open(path, "wb") as f:
        f.write(preamble)
        f.write(struct.pack(f"<{h}Q", *offsets))
        for y in range(h):
            f.write(struct.pack("<ii", y, row_bytes))
            row = rgba[y]  # channel-planar rows in sorted order A, B, G, R
            f.write(row[:, 3].tobytes())
            f.write(row[:, 2].tobytes())
            f.write(row[:, 1].tobytes())
            f.write(row[:, 0].tobytes())


def load_exr(path) -> np.ndarray:
    """Read an EXR written by save_exr (uncompressed FLOAT RGBA)."""
    buf = Path(path).read_bytes()
    magic, _ = struct.unpack_from("<Ii", buf, 0)
    if magic != _MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    pos = 8
    attrs = {}
    while buf[pos] != 0:
        nul = buf.index(b"\0", pos)
        name = buf[pos:nul].decode()
        pos = nul + 1
        nul = buf.index(b"\0", pos)
        typ = buf[pos:nul].decode()
        pos = nul + 1
        (size,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        attrs[name] = (typ, buf[pos: pos + size])
        pos += size
    pos += 1  # header terminator

    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
    w, h = x1 - x0 + 1, y1 - y0 + 1
    if attrs["compression"][1] != b"\0":
        raise ValueError(f"{path}: only uncompressed EXR is supported")

    ch_raw = attrs["channels"][1]
    names = []
    cpos = 0
    while ch_raw[cpos] != 0:
        nul = ch_raw.index(b"\0", cpos)
        names.append(ch_raw[cpos:nul].decode())
        cpos = nul + 1 + 4 + 4 + 8  # type + plinear/reserved + sampling
    offsets = struct.unpack_from(f"<{h}Q", buf, pos)

    img = np.zeros((h, w, 4), np.float32)
    order = {"R": 0, "G": 1, "B": 2, "A": 3}
    for off in offsets:
        y, _ = struct.unpack_from("<ii", buf, off)
        data = np.frombuffer(buf, np.float32, count=len(names) * w,
                             offset=off + 8)
        for k, nm in enumerate(names):
            if nm in order:
                img[y - y0, :, order[nm]] = data[k * w: (k + 1) * w]
    return img


def save_png(path, linear_rgb):
    """Tonemap linear radiance to an 8-bit sRGB PNG."""
    from PIL import Image

    u8 = tonemap_to_u8(torch.as_tensor(np.asarray(linear_rgb, np.float32)))
    Image.fromarray(u8.numpy()).save(path)
