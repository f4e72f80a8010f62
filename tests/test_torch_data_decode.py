"""The port's image decoding against the JAX package, bit for bit on the CPU:
every PNG kind a shard carries (grey, RGB, palette, grey + alpha and RGBA at
8 bits, grey and RGB at 16), encoded by PIL with its adaptive row filters
and by the port's encoder with each of the five filter types, through
``decode_rgb``, ``decode_depth`` and ``decode_flow``; the native helpers
against their numpy versions and against the JAX package's; and the import
boundary: the port's data layer loads neither PIL, h5py nor JAX."""

import io
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from unidepth_tpu import native as j_native
from unidepth_tpu.datasets import base as j_base
from unidepth_tpu_torch import native
from unidepth_tpu_torch.datasets import base
from unidepth_tpu_torch.utils.png import encode_png, png_asarray, png_to_rgb

ROOT = Path(__file__).resolve().parents[1]
SHAPE = (23, 37)


def _pil_png(arr, mode=None) -> bytes:
    buf = io.BytesIO()
    (Image.fromarray(arr) if mode is None else Image.fromarray(arr, mode=mode)).save(buf, format="PNG")
    return buf.getvalue()


def _smooth(rng, channels, dtype=np.uint8, top=255):
    """Smooth rows, which PIL's adaptive filter encodes with several types."""
    steps = rng.integers(-3, 4, (*SHAPE, channels))
    return np.clip(np.cumsum(steps, axis=1) + top // 2, 0, top).astype(dtype).squeeze(-1 if channels == 1 else ())


def _pil_blobs(rng) -> dict[str, bytes]:
    rgb = _smooth(rng, 3)
    return {
        "L": _pil_png(_smooth(rng, 1)),
        "RGB": _pil_png(rgb),
        "P": _save(Image.fromarray(rgb).convert("P")).getvalue(),
        "LA": _pil_png(_smooth(rng, 2), mode="LA"),
        "RGBA": _pil_png(_smooth(rng, 4)),
        "I;16": _pil_png(_smooth(rng, 1, np.uint16, 65535) * 7),
    }


def _save(img) -> io.BytesIO:
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf


@pytest.mark.parametrize("kind", ["L", "RGB", "P", "LA", "RGBA", "I;16"])
def test_decode_rgb_and_depth_match_jax(kind):
    blob = _pil_blobs(np.random.default_rng(0))[kind]
    np.testing.assert_array_equal(base.decode_rgb(blob), j_base.decode_rgb(blob))
    np.testing.assert_array_equal(png_asarray(blob), np.asarray(Image.open(io.BytesIO(blob))))
    if kind in ("LA", "RGBA"):  # not depth formats (JAX's C unpack would read 3 bytes a pixel of them)
        return
    got, want = base.decode_depth(blob, 256.0), j_base.decode_depth(blob, 256.0)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("image", ["rgb8", "grey8", "grey16", "rgb16"])
def test_each_filter_type_decodes_as_pil(filt, image):
    rng = np.random.default_rng(filt)
    arr = {"rgb8": lambda: _smooth(rng, 3), "grey8": lambda: _smooth(rng, 1),
           "grey16": lambda: _smooth(rng, 1, np.uint16, 65535) * 5,
           "rgb16": lambda: rng.integers(0, 65536, (*SHAPE, 3)).astype(np.uint16)}[image]()
    blob = encode_png(arr, filters=(filt, 0) if filt else (0,))
    np.testing.assert_array_equal(png_to_rgb(blob), np.asarray(Image.open(io.BytesIO(blob)).convert("RGB")))
    np.testing.assert_array_equal(png_asarray(blob), np.asarray(Image.open(io.BytesIO(blob))))
    np.testing.assert_array_equal(base.decode_rgb(blob), j_base.decode_rgb(blob))
    np.testing.assert_array_equal(base.decode_depth(blob, 1000.0), j_base.decode_depth(blob, 1000.0))
    if image == "rgb16":  # the 12-bit flow payload: all 16 bits, past PIL
        for got, want in zip(base.decode_flow(blob), j_base.decode_flow(blob)):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(base._decode_png16_rgb(blob), arr)


def test_decode_flow_of_8_bit_pngs_matches_jax():
    rng = np.random.default_rng(3)
    for blob in (_pil_png(_smooth(rng, 3)), encode_png(_smooth(rng, 3), filters=(4, 1))):
        for got, want in zip(base.decode_flow(blob), j_base.decode_flow(blob)):
            np.testing.assert_array_equal(got, want)


def test_png_refusals():
    with pytest.raises(ValueError, match="not a PNG"):
        png_asarray(b"\xff\xd8\xff" + bytes(20))
    blob = bytearray(encode_png(np.zeros((4, 5, 3), np.uint8)))
    blob[16] ^= 1  # the IHDR width: its checksum no longer matches
    with pytest.raises(ValueError, match="checksum"):
        png_asarray(bytes(blob))
    with pytest.raises(ValueError, match="unsupported"):
        encode_png(np.zeros((4, 4, 4), np.uint8))


def test_native_helpers_match_numpy_and_jax():
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    d16 = rng.integers(0, 65536, (20, 30), dtype=np.uint16)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    before = native.unpack24_scale.calls
    for scale in (256.0, 512.0, 1000.0):
        got = native.unpack24_scale(img, scale)
        np.testing.assert_array_equal(got, native.unpack24_scale_plain(img, scale))
        np.testing.assert_array_equal(got, j_native.unpack24_scale(img, scale))
        got = native.scale_u16(d16, scale)
        np.testing.assert_array_equal(got, native.scale_u16_plain(d16, scale))
        np.testing.assert_array_equal(got, j_native.scale_u16(d16, scale))
    assert native.unpack24_scale.calls == before + 3
    got = native.normalize_u8(img, mean, std)
    np.testing.assert_array_equal(got, native.normalize_u8_plain(img, mean, std))
    np.testing.assert_array_equal(got, j_native.normalize_u8(img, mean, std))
    h, stride, bpp = 10, 30, 6
    raw = b"".join(bytes([y % 5]) + rng.integers(0, 256, stride, dtype=np.uint8).tobytes() for y in range(h))
    got = native.png_unfilter(raw, h, stride, bpp)
    np.testing.assert_array_equal(got, native.png_unfilter_plain(raw, h, stride, bpp))
    np.testing.assert_array_equal(got, j_native.png_unfilter(raw, h, stride, bpp))
    with pytest.raises(ValueError, match="rows"):
        native.png_unfilter(raw[:-1], h, stride, bpp)


def test_native_build_failure_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path)
    monkeypatch.setenv("CC", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        native.build()


def test_non_png_blobs_need_pil(monkeypatch):
    png = _save(Image.fromarray(np.zeros((8, 8, 3), np.uint8))).getvalue()
    buf = io.BytesIO()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(buf, format="JPEG")
    np.testing.assert_array_equal(base.decode_rgb(buf.getvalue()), j_base.decode_rgb(buf.getvalue()))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="JPEG image needs PIL"):
        base.decode_rgb(buf.getvalue())
    assert base.decode_rgb(png).shape == (8, 8, 3)  # a PNG decodes without PIL


def test_data_layer_imports_neither_pil_nor_h5py_nor_jax():
    code = ("import sys; before = set(sys.modules); "
            "import unidepth_tpu_torch.datasets, unidepth_tpu_torch.datasets.synthetic; "
            "bad = sorted(m for m in set(sys.modules) - before if m.split('.')[0] in ('PIL', 'h5py', 'jax', "
            "'unidepth_tpu')); print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
