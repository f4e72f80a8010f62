"""A small PNG codec on the standard library's ``zlib`` for the two
formats of the demo: non-interlaced 8-bit RGB (``assets/demo/rgb.png``, the
output panel) and 16-bit grey (``depth.png``, millimetres). The port adds no
imaging dependency.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

__all__ = ["read_png", "write_png"]

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_FORMATS = {(8, 2): 3, (16, 0): 1}  # (bit depth, colour type) -> channels: 8-bit RGB, 16-bit grey


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (None, Sub, Up, Average, Paeth)."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for r in range(h):
        kind = raw[r * (stride + 1)]
        line = np.frombuffer(raw, np.uint8, stride, r * (stride + 1) + 1)
        if kind == 0:
            cur = line.copy()
        elif kind == 2:
            cur = line + prev
        elif kind in (1, 3, 4):
            cur_l, up = bytearray(line.tobytes()), prev.tobytes()
            for i in range(stride):
                a = cur_l[i - bpp] if i >= bpp else 0
                c = up[i - bpp] if i >= bpp else 0
                pred = a if kind == 1 else (a + up[i]) >> 1 if kind == 3 else _paeth(a, up[i], c)
                cur_l[i] = (cur_l[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur_l), np.uint8)
        else:
            raise ValueError(f"PNG row {r}: unknown filter type {kind}")
        out[r] = prev = cur
    return out


def read_png(path) -> np.ndarray:
    """(H, W, 3) uint8 for 8-bit RGB, (H, W) uint16 for 16-bit grey."""
    data = Path(path).read_bytes()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = len(_SIGNATURE), [], None
    while pos < len(data):
        (n,), kind = struct.unpack(">I", data[pos : pos + 4]), data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + n]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, colour, _, _, interlace = header
    if interlace or (depth, colour) not in _FORMATS:
        raise ValueError(f"{path}: unsupported PNG (bit depth {depth}, colour type {colour}, interlace {interlace}); "
                         "8-bit RGB and 16-bit grey, not interlaced, are read")
    bpp = _FORMATS[depth, colour] * depth // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, w * bpp, bpp)
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(h, w)
    return rows.reshape(h, w, 3)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def write_png(path, image: np.ndarray) -> None:
    """Write (H, W, 3) uint8 or (H, W) uint16, rows unfiltered."""
    image = np.asarray(image)
    if image.dtype == np.uint16 and image.ndim == 2:
        depth, colour, rows = 16, 0, image.astype(">u2").view(np.uint8)
    elif image.dtype == np.uint8 and image.ndim == 3 and image.shape[-1] == 3:
        depth, colour, rows = 8, 2, image.reshape(image.shape[0], -1)
    else:
        raise ValueError(f"write_png: unsupported image {image.dtype} {image.shape}")
    h, w = image.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows.reshape(h, -1)], axis=1).tobytes()
    Path(path).write_bytes(_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, 0))
                           + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b""))
