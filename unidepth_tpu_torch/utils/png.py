"""A PNG codec on the standard library's ``zlib`` and the native unfilter
(``unidepth_tpu_torch/native``): no imaging dependency.

It reads every non-interlaced PNG that the datasets carry: grey, RGB,
palette, grey + alpha and RGBA at 8 bits, grey and RGB at 16 bits.
``png_samples`` gives the samples at their bit depth; ``png_asarray`` what
``numpy.asarray(PIL.Image.open(...))`` gives (palette indices, 16-bit RGB
cut to its high bytes); ``png_to_rgb`` what PIL's ``convert("RGB")`` gives
(grey replicated, alpha dropped, the palette looked up with missing entries
black, 16-bit grey clipped to 255). ``encode_png`` writes grey and RGB at 8
and 16 bits, each row under a filter type of a given cycle.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from unidepth_tpu_torch import native

__all__ = ["encode_png", "is_png", "png_asarray", "png_samples", "png_to_rgb", "read_png", "write_png"]

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# (bit depth, colour type) -> channels: grey, RGB, palette, grey + alpha, RGBA
# at 8 bits; grey and RGB at 16
_FORMATS = {(8, 0): 1, (8, 2): 3, (8, 3): 1, (8, 4): 2, (8, 6): 4, (16, 0): 1, (16, 2): 3}


def is_png(data: bytes) -> bool:
    return data[:8] == _SIGNATURE


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        (n,), kind = struct.unpack(">I", data[pos : pos + 4]), data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + n]
        if len(body) != n:
            raise ValueError(f"PNG: chunk {kind!r} truncated")
        yield kind, body, data[pos + 8 + n : pos + 12 + n]
        if kind == b"IEND":
            return
        pos += 12 + n


def png_samples(data: bytes) -> tuple[np.ndarray, int, np.ndarray | None]:
    """Decode a PNG -> (samples (H, W, channels) uint8 or uint16, colour
    type, palette (256, 3) uint8 for colour type 3, else None)."""
    if not is_png(data):
        raise ValueError("not a PNG")
    header, palette, idat = None, None, []
    for kind, body, crc in _chunks(data):
        if kind in (b"IHDR", b"PLTE") and struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF) != crc:
            raise ValueError(f"PNG: bad {kind.decode()} checksum")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.zeros((256, 3), np.uint8)
            entries = np.frombuffer(body, np.uint8)[: 3 * 256]
            palette.reshape(-1)[: entries.size] = entries
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG: no IHDR chunk")
    w, h, depth, colour, _, _, interlace = header
    if interlace or (depth, colour) not in _FORMATS:
        raise ValueError(f"unsupported PNG (bit depth {depth}, colour type {colour}, interlace {interlace}): "
                         "grey, RGB, palette, grey + alpha and RGBA at 8 bits, grey and RGB at 16, not interlaced, "
                         "are read")
    if colour == 3 and palette is None:
        raise ValueError("PNG: palette image without a PLTE chunk")
    channels = _FORMATS[depth, colour]
    bpp = channels * depth // 8
    raw, stride = zlib.decompress(b"".join(idat)), w * bpp
    if len(raw) < h * (stride + 1):
        raise ValueError(f"PNG: {len(raw)} bytes of image data for {h} rows of 1 + {stride}")
    kinds = np.frombuffer(raw, np.uint8, count=h * (stride + 1))[:: stride + 1]
    if (kinds > 4).any():
        raise ValueError(f"PNG: unknown filter type {int(kinds.max())}")
    rows = native.png_unfilter(raw, h, stride, bpp)
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(h, w, channels), colour, None
    return rows.reshape(h, w, channels), colour, palette


def png_asarray(data: bytes) -> np.ndarray:
    """What ``numpy.asarray(PIL.Image.open(...))`` gives for this PNG: (H,
    W) for grey and palette (the indices), (H, W, C) otherwise; 16-bit grey
    as uint16, 16-bit RGB as its high bytes."""
    samples, colour, _ = png_samples(data)
    if samples.dtype == np.uint16 and colour == 2:
        samples = (samples >> 8).astype(np.uint8)
    return samples[..., 0] if samples.shape[-1] == 1 else samples


def png_to_rgb(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8, as PIL's ``Image.open(...).convert("RGB")``."""
    samples, colour, palette = png_samples(data)
    if samples.dtype == np.uint16:
        samples = (samples >> 8).astype(np.uint8) if colour == 2 else np.minimum(samples, 255).astype(np.uint8)
    if colour == 3:
        return palette[samples[..., 0]]
    if colour in (0, 4):
        return np.repeat(samples[..., :1], 3, axis=-1)
    return np.ascontiguousarray(samples[..., :3])


def read_png(path) -> np.ndarray:
    """``png_asarray`` of a file: (H, W, 3) uint8 for 8-bit RGB, (H, W) uint16
    for 16-bit grey, and so on."""
    return png_asarray(Path(path).read_bytes())


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def _filter_rows(rows: np.ndarray, bpp: int, kinds) -> np.ndarray:
    """Filter each row of ``rows`` (h, stride) uint8 with the filter type
    ``kinds[row % len(kinds)]``; returns (h, 1 + stride) with the type bytes."""
    cur = rows.astype(np.int16)
    up = np.zeros_like(cur)
    up[1:] = cur[:-1]
    left = np.zeros_like(cur)
    left[:, bpp:] = cur[:, :-bpp]
    upleft = np.zeros_like(cur)
    upleft[:, bpp:] = up[:, :-bpp]
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    preds = (np.zeros_like(cur), left, up, (left + up) >> 1, paeth)
    kind = np.asarray([kinds[r % len(kinds)] for r in range(rows.shape[0])], np.uint8)
    out = np.empty((rows.shape[0], rows.shape[1] + 1), np.uint8)
    out[:, 0] = kind
    for k in set(kind.tolist()):
        sel = kind == k
        out[sel, 1:] = ((cur[sel] - preds[k][sel]) & 0xFF).astype(np.uint8)
    return out


def encode_png(image: np.ndarray, filters=(0,), level: int = 6) -> bytes:
    """A PNG of (H, W) or (H, W, 3) uint8 or uint16; row r filtered with
    type ``filters[r % len(filters)]`` (0 None, 1 Sub, 2 Up, 3 Average, 4
    Paeth), compressed at zlib ``level``."""
    image = np.asarray(image)
    channels = 1 if image.ndim == 2 else image.shape[-1]
    colour = {(np.dtype(np.uint8), 1): 0, (np.dtype(np.uint8), 3): 2, (np.dtype(np.uint16), 1): 0,
              (np.dtype(np.uint16), 3): 2}.get((image.dtype, channels))
    if colour is None or image.ndim not in (2, 3) or not set(filters) <= {0, 1, 2, 3, 4}:
        raise ValueError(f"encode_png: unsupported image {image.dtype} {image.shape} or filters {filters}")
    depth = 8 * image.dtype.itemsize
    h, w = image.shape[:2]
    rows = image.astype(image.dtype.newbyteorder(">")).view(np.uint8).reshape(h, -1)
    raw = _filter_rows(rows, channels * image.dtype.itemsize, tuple(filters)).tobytes()
    return (_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw, level)) + _chunk(b"IEND", b""))


def write_png(path, image: np.ndarray) -> None:
    """Write (H, W, 3) uint8 or (H, W) uint16 (or any image ``encode_png``
    takes), rows unfiltered."""
    Path(path).write_bytes(encode_png(image))
