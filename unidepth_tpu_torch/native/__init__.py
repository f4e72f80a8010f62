"""Native host-side helpers of the data loader (the counterpart of
unidepth_tpu/native, which the port may not import).

``depth_decode.c`` is built with the system C compiler (``$CC``, else
``cc``) at the first call into ``build/unidepth_tpu_torch/native/<hash of
the source>/`` at the root of the checkout and bound with ctypes, which
releases the interpreter lock during each call, so the loader's threads
decode in parallel. A failed build raises; there is no silent fallback.
Each helper has its plain numpy version beside it (``*_plain``), computing
the same float arithmetic in the same order, so the two agree bit for bit:
the tests hold them to each other. Each C helper counts its calls in its
``calls`` attribute, which a caller can read to see that the C code ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["library", "normalize_u8", "normalize_u8_plain", "png_unfilter", "png_unfilter_plain", "scale_u16",
           "scale_u16_plain", "unpack24_scale", "unpack24_scale_plain"]

SOURCE = Path(__file__).with_name("depth_decode.c")
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "unidepth_tpu_torch" / "native"
# no -march=native: a checkout (and its build/) may move between hosts with other CPUs
CFLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def build() -> Path:
    """Compile ``depth_decode.c`` unless this source is already built;
    returns the shared library's path. Raises RuntimeError with the
    compiler's output on a failed build."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(CFLAGS).encode()).hexdigest()[:16]
    out = BUILD_ROOT / tag / "libdepth_decode.so"
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [os.environ.get("CC", "cc"), *CFLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"building {out} failed: {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"building {out} failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent process sees all or nothing
    return out


def library() -> ctypes.CDLL:
    """The loaded helper library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            u8, f32, i64 = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float), ctypes.c_int64
            lib.unpack24_scale.argtypes = [u8, f32, i64, ctypes.c_float]
            lib.scale_u16.argtypes = [ctypes.POINTER(ctypes.c_uint16), f32, i64, ctypes.c_float]
            lib.normalize_u8.argtypes = [u8, f32, i64, f32, f32]
            lib.png_unfilter.argtypes = [u8, u8, i64, i64, ctypes.c_int]
            for fn in (lib.unpack24_scale, lib.scale_u16, lib.normalize_u8, lib.png_unfilter):
                fn.restype = None
            _lib = lib
        return _lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _rgb(img: np.ndarray, name: str) -> np.ndarray:
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError(f"{name}: expected (H, W, 3) uint8, got {img.shape}")
    return img


def unpack24_scale(img: np.ndarray, depth_scale: float) -> np.ndarray:
    """(H, W, 3) uint8 packed depth -> (H, W) float32 metric depth:
    (b2 + b1 * 255 + b0 * 255^2) / depth_scale."""
    img = _rgb(img, "unpack24_scale")
    out = np.empty(img.shape[:2], np.float32)
    library().unpack24_scale(_ptr(img, ctypes.c_uint8), _ptr(out, ctypes.c_float), out.size, 1.0 / depth_scale)
    unpack24_scale.calls += 1
    return out


def unpack24_scale_plain(img: np.ndarray, depth_scale: float) -> np.ndarray:
    img = _rgb(img, "unpack24_scale").astype(np.float64)
    v = img[..., 2] + img[..., 1] * 255.0 + img[..., 0] * 255.0 * 255.0
    return (v * np.float64(np.float32(1.0 / depth_scale))).astype(np.float32)


def scale_u16(img: np.ndarray, depth_scale: float) -> np.ndarray:
    """uint16 depth -> float32 depth / depth_scale."""
    img = np.ascontiguousarray(img, dtype=np.uint16)
    out = np.empty(img.shape, np.float32)
    library().scale_u16(_ptr(img, ctypes.c_uint16), _ptr(out, ctypes.c_float), out.size, 1.0 / depth_scale)
    scale_u16.calls += 1
    return out


def scale_u16_plain(img: np.ndarray, depth_scale: float) -> np.ndarray:
    img = np.asarray(img, dtype=np.uint16)
    return (img.astype(np.float64) * np.float64(np.float32(1.0 / depth_scale))).astype(np.float32)


def normalize_u8(img: np.ndarray, mean, std) -> np.ndarray:
    """(H, W, 3) uint8 -> float32 (x / 255 - mean) * (1 / std), a channel each."""
    img = _rgb(img, "normalize_u8")
    out = np.empty(img.shape, np.float32)
    m = np.ascontiguousarray(mean, np.float32)
    si = (1.0 / np.asarray(std, np.float32)).astype(np.float32)
    if m.shape != (3,) or si.shape != (3,):
        raise ValueError(f"normalize_u8: mean and std need 3 channels, got {m.shape}, {si.shape}")
    library().normalize_u8(_ptr(img, ctypes.c_uint8), _ptr(out, ctypes.c_float), img.shape[0] * img.shape[1],
                           _ptr(m, ctypes.c_float), _ptr(si, ctypes.c_float))
    normalize_u8.calls += 1
    return out


def normalize_u8_plain(img: np.ndarray, mean, std) -> np.ndarray:
    x = _rgb(img, "normalize_u8").astype(np.float32) / np.float32(255.0)
    si = (1.0 / np.asarray(std, np.float32)).astype(np.float32)
    return (x - np.asarray(mean, np.float32)) * si


def _filtered_rows(raw: bytes, h: int, stride: int) -> np.ndarray:
    if h < 0 or stride < 0 or len(raw) < h * (stride + 1):
        raise ValueError(f"png_unfilter: {len(raw)} bytes hold no {h} rows of 1 + {stride}")
    return np.frombuffer(raw, np.uint8, count=h * (stride + 1)).reshape(h, stride + 1)


def png_unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Reconstruct ``h`` PNG scanlines of ``stride`` bytes, each led by its
    filter byte (None, Sub, Up, Average, Paeth; ``bpp`` bytes a pixel) ->
    (h, stride) uint8."""
    src = np.ascontiguousarray(_filtered_rows(raw, h, stride))
    out = np.empty((h, stride), np.uint8)
    library().png_unfilter(_ptr(src, ctypes.c_uint8), _ptr(out, ctypes.c_uint8), h, stride, bpp)
    png_unfilter.calls += 1
    return out


def png_unfilter_plain(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """The unfilter row by row: None and Up as vectors, Sub, Average and
    Paeth byte by byte (a filter byte past 4 leaves its row as None does)."""
    rows = _filtered_rows(raw, h, stride)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        f, line = int(rows[y, 0]), rows[y, 1:].astype(np.int64)
        if f == 2:
            cur = (line + prev) & 0xFF
        elif f in (1, 3, 4):
            cur = line.copy()
            for x in range(stride):
                a = int(cur[x - bpp]) if x >= bpp else 0
                b = int(prev[x])
                if f == 1:
                    pred = a
                elif f == 3:
                    pred = (a + b) >> 1
                else:
                    c = int(prev[x - bpp]) if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[x] = (cur[x] + pred) & 0xFF
        else:
            cur = line
        out[y] = cur
        prev = cur
    return out


for _fn in (unpack24_scale, scale_u16, normalize_u8, png_unfilter):
    _fn.calls = 0
