"""Synthetic HDF5 shard contents under the names, node paths and split
files of real ``SPECS`` rows, made from a seed: no dataset ships with the
repository, so the tests and the card's smoke train and evaluate on these.

``make_shards`` returns {shard path: {node path: uint8 array}} for KITTI (its
pre-crop size and per-date intrinsics, 16-bit depth), NYUv2Depth (24-bit
packed depth) and ARKit (a sequence-kind row: ``sequences.json`` with
inline K, 16-bit depth); each RGB PNG's rows cycle through the five PNG
filter types (zlib level 1: quick to make). ``write_hdf5`` writes them
as HDF5 files (h5py is imported there).
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from unidepth_tpu_torch.datasets.specs import KITTI_INTRINSICS, SPECS
from unidepth_tpu_torch.utils.png import encode_png

__all__ = ["SHAPES", "make_shards", "write_hdf5"]

# each row's image size: KITTI's raw frames, the others' VGA
SHAPES = {"KITTI": (375, 1242), "NYUv2Depth": (480, 640), "ARKit": (480, 640)}
_FILTERS = (0, 1, 2, 3, 4)
_FRAMES_PER_SEQUENCE = 12


def _image(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Blocky colour fields with pixel noise: (h, w, 3) uint8."""
    coarse = rng.integers(8, 248, (h // 8 + 1, w // 8 + 1, 3), dtype=np.int16)
    img = np.repeat(np.repeat(coarse, 8, axis=0), 8, axis=1)[:h, :w] + rng.integers(-8, 9, (h, w, 3), dtype=np.int16)
    return img.astype(np.uint8)


def _depth(rng: np.random.Generator, h: int, w: int, lo: float, hi: float, valid: float) -> np.ndarray:
    """A ground plane receding towards the top with noise, a ``valid`` share
    of the pixels kept (the rest 0): (h, w) float64 metres."""
    rows = np.linspace(hi, lo, h)[:, None] * rng.uniform(0.9, 1.1, (h, w))
    return np.where(rng.random((h, w)) < valid, np.clip(rows, lo, hi), 0.0)


def _png(image: np.ndarray, filters=(0,)) -> np.ndarray:
    return np.frombuffer(encode_png(image, filters=filters, level=1), np.uint8)


def _png16(depth: np.ndarray, scale: float) -> np.ndarray:
    return _png(np.clip(np.round(depth * scale), 0, 65535).astype(np.uint16))


def _png24(depth: np.ndarray, scale: float) -> np.ndarray:
    """24-bit packed depth: v = b2 + b1 * 255 + b0 * 255^2."""
    v = np.round(depth * scale).astype(np.int64)
    return _png(np.stack([v // (255 * 255), v % (255 * 255) // 255, v % 255], axis=-1).astype(np.uint8))


def _text(text: str) -> np.ndarray:
    return np.frombuffer(text.encode("ascii"), np.uint8)


# each row: its depth range (metres), valid share and depth encoding
_LAYOUT = {"KITTI": (2.0, 75.0, 0.3, _png16), "NYUv2Depth": (0.5, 9.5, 1.0, _png24), "ARKit": (0.3, 8.0, 0.9, _png16)}


def _sample(name: str, shape, seed) -> tuple[np.ndarray, np.ndarray]:
    """One sample's RGB PNG (rows through the five filter types) and depth PNG."""
    rng = np.random.default_rng(seed)
    lo, hi, valid, encode = _LAYOUT[name]
    return _png(_image(rng, *shape), _FILTERS), encode(_depth(rng, *shape, lo, hi, valid), SPECS[name].depth_scale)


def make_shards(names, n: int, seed: int, shapes: dict | None = None) -> dict[str, dict[str, np.ndarray]]:
    """``n`` samples (ARKit: frames) of each of ``names`` (KITTI,
    NYUv2Depth, ARKit) at ``shapes`` (default ``SHAPES``), every sample in
    both splits; sample i of row r made from the seed (seed, r, i), the
    samples encoded in threads."""
    shapes = {**SHAPES, **(shapes or {})}
    unknown = set(names) - set(_LAYOUT)
    if unknown:
        raise ValueError(f"make_shards: no synthetic layout for {sorted(unknown)}")
    with ThreadPoolExecutor(max_workers=os.cpu_count()) as pool:
        blobs = {name: list(pool.map(lambda i, name=name, r=r: _sample(name, shapes[name], (seed, r, i)), range(n)))
                 for r, name in enumerate(names)}
    shards = {}
    for name in names:
        spec = SPECS[name]
        h, w = shapes[name]
        nodes, lines = {}, []
        if name == "ARKit":
            sequences = {}
            for s in range(-(-n // _FRAMES_PER_SEQUENCE)):
                frames = {}
                count = min(_FRAMES_PER_SEQUENCE, n - s * _FRAMES_PER_SEQUENCE)
                for f in range(count):
                    image, depth = f"seq_{s:03d}/rgb_{f:04d}.png", f"seq_{s:03d}/depth_{f:04d}.png"
                    nodes[image], nodes[depth] = blobs[name][s * _FRAMES_PER_SEQUENCE + f]
                    focal = (0.8 + 0.4 * f / _FRAMES_PER_SEQUENCE) * w
                    frames[str(f)] = {"image": image, "depth": depth,
                                      "K": [[focal, 0.0, w / 2], [0.0, focal, h / 2], [0.0, 0.0, 1.0]]}
                sequences[f"seq_{s:03d}"] = frames
                lines.append(f"seq_{s:03d} {count}")
            nodes["sequences.json"] = _text(json.dumps(sequences))
        else:
            dates = list(KITTI_INTRINSICS)
            for i in range(n):
                # KITTI's image names carry the date its intrinsics table is keyed by
                stem = f"{dates[i % len(dates)]}/{dates[i % len(dates)]}_drive_{i:04d}_sync" if name == "KITTI" \
                    else "nyu"
                image, depth = f"{stem}/rgb/{i:010d}.png", f"{stem}/depth/{i:010d}.png"
                nodes[image], nodes[depth] = blobs[name][i]
                lines.append(f"{image} {depth}")
        for split in {spec.train_split, spec.test_split}:
            nodes[split] = _text("\n".join(lines) + "\n")
        shards[spec.hdf5_paths[0]] = nodes
    return shards


def write_hdf5(root, shards: dict[str, dict[str, np.ndarray]]) -> None:
    """Each shard of ``make_shards`` as an HDF5 file under ``root``."""
    import h5py

    for path, nodes in shards.items():
        full = os.path.join(root, path)
        os.makedirs(os.path.dirname(full) or ".", exist_ok=True)
        with h5py.File(full, "w") as f:
            for node, data in nodes.items():
                f.create_dataset(node, data=data)
