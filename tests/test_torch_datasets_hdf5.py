"""The port's HDF5 readers against the JAX package's over the same shards,
on the CPU: small shards under the names, node paths and split files of
real SPECS rows (the port's ``synthetic`` writer) and hand-made ones with
PIL-encoded PNGs and flows; test-mode items (index-seeded) and train-mode
items (a shared seed) equal key for key; the KITTI pre-crop and per-date
intrinsics, ``make_dataset``'s dispatch on the spec's kind, and the retry
on a corrupt blob."""

import io
import json

import h5py
import numpy as np
import pytest
import torch_threads  # noqa: F401  (sets this process's torch thread count)
from PIL import Image

from unidepth_tpu.datasets import base as j_base
from unidepth_tpu.datasets import sequence as j_sequence
from unidepth_tpu.datasets.specs import DatasetSpec as JSpec
from unidepth_tpu_torch.datasets import base, sequence, synthetic
from unidepth_tpu_torch.datasets.specs import KITTI_INTRINSICS, SPECS, DatasetSpec
from unidepth_tpu_torch.utils.png import encode_png

SMALL = {"KITTI": (356, 1222), "NYUv2Depth": (48, 64), "ARKit": (48, 64)}
TARGET = (28, 42)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("shards")
    synthetic.write_hdf5(root, synthetic.make_shards(list(SMALL), 5, 0, shapes=SMALL))
    return str(root)


def _same(got: dict, want: dict):
    assert got.keys() == want.keys(), got.keys() ^ want.keys()
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("name", list(SMALL))
@pytest.mark.parametrize("test_mode", [True, False])
def test_items_match_jax(shards, name, test_mode):
    kw = dict(data_root=shards, test_mode=test_mode, image_shape=TARGET)
    port, jax_ = base.make_dataset(name, **kw), j_base.make_dataset(name, **kw)
    assert type(port).__name__ == type(jax_).__name__ == ("SequenceHDF5Dataset" if name == "ARKit" else "HDF5Dataset")
    assert port.samples == jax_.samples and len(port) == len(jax_)
    for idx in range(len(port)):
        if test_mode:  # __getitem__ seeds its generator by the index
            _same(port[idx], jax_[idx])
        else:
            rp, rj = np.random.default_rng(idx), np.random.default_rng(idx)
            _same(port.get_single_item(idx, rp, image_shape=(42, 28)),
                  jax_.get_single_item(idx, rj, image_shape=(42, 28)))
            assert rp.bit_generator.state == rj.bit_generator.state


def test_kitti_pre_crop_and_intrinsics(shards):
    ds = base.make_dataset("KITTI", data_root=shards, test_mode=True, image_shape=TARGET)
    raw = ds._read(1)
    date = ds.samples[1][0].split("/")[0]
    np.testing.assert_array_equal(raw["K"], np.asarray(KITTI_INTRINSICS[date], np.float32))
    cropped = ds.pre_cropper({k: raw[k] for k in ("image", "depth", "K", "validity")}, None)
    assert cropped["image"].shape[:2] == SPECS["KITTI"].pre_crop
    top, left = SMALL["KITTI"][0] - 352, (SMALL["KITTI"][1] - 1216) // 2
    np.testing.assert_array_equal(cropped["K"][:2, 2], raw["K"][:2, 2] - [left, top])
    item = ds[1]
    assert item["depth_mask"].shape == TARGET and item["dataset"] == "KITTI" and item["quality"] == 1


def _png(arr, mode=None):
    buf = io.BytesIO()
    (Image.fromarray(arr) if mode is None else Image.fromarray(arr, mode=mode)).save(buf, format="PNG")
    return np.frombuffer(buf.getvalue(), np.uint8)


def _text(f, name, text):
    f.create_dataset(name, data=np.frombuffer(text.encode(), np.uint8))


def _spec(cls, kind, path):
    return cls(name="Fake", kind=kind, min_depth=0.01, max_depth=80.0, depth_scale=1000.0, hdf5_paths=(path,),
               train_split="train.txt", test_split="train.txt")


def test_pil_shard_with_a_corrupt_blob_retries_as_jax(tmp_path):
    rng = np.random.default_rng(2)
    with h5py.File(tmp_path / "fake.hdf5", "w") as f:
        lines = []
        for i in range(6):
            f.create_dataset(f"rgb/{i}.png", data=_png(rng.integers(0, 255, (40, 56, 3), dtype=np.uint8)))
            blob = _png(rng.integers(500, 60000, (40, 56)).astype(np.uint16))
            f.create_dataset(f"depth/{i}.png", data=blob[: len(blob) // 2] if i == 2 else blob)  # 2: truncated
            lines.append(f"rgb/{i}.png depth/{i}.png")
        _text(f, "train.txt", "\n".join(lines) + "\nrgb/x.png None\n")
    kw = dict(data_root=str(tmp_path), test_mode=True, image_shape=TARGET)
    port, jax_ = base.HDF5Dataset(_spec(DatasetSpec, "image", "fake.hdf5"), **kw), \
        j_base.HDF5Dataset(_spec(JSpec, "image", "fake.hdf5"), **kw)
    assert len(port) == 6  # the None depth is not a sample
    with pytest.raises(Exception):
        port.get_single_item(2, np.random.default_rng(0))
    _same(port[2], jax_[2])  # retried with the same index-seeded draw


def test_sequence_shard_with_flows_points_and_camera_params(tmp_path):
    rng = np.random.default_rng(4)
    hw = (40, 60)
    seqs = {"drive": {}}
    with h5py.File(tmp_path / "seq.hdf5", "w") as f:
        for i in range(4):
            f.create_dataset(f"drive/rgb_{i}.png", data=_png(rng.integers(0, 255, (*hw, 3), dtype=np.uint8)))
            f.create_dataset(f"drive/depth_{i}.png", data=_png(rng.integers(500, 60000, hw).astype(np.uint16)))
            flow = rng.integers(0, 65536, (*hw, 3)).astype(np.uint16)
            f.create_dataset(f"drive/flow_{i}.png", data=np.frombuffer(encode_png(flow, filters=(1, 4)), np.uint8))
            f.create_dataset(f"drive/points_{i}", data=rng.standard_normal((*hw, 3)).astype(np.float32))
            seqs["drive"][str(i)] = {"image": f"drive/rgb_{i}.png", "depth": f"drive/depth_{i}.png",
                                     "flow_fwd": f"drive/flow_{i}.png", "points": f"drive/points_{i}",
                                     "K": [[50.0, 0, 30.0], [0, 50.0, 20.0], [0, 0, 1]], "cam2w": np.eye(4).tolist()}
        seqs["drive"]["1"]["camera_params"] = [50.0, 50.0, 30.0, 20.0, 0.5, 1.0]
        seqs["drive"]["1"]["camera_model"] = "EUCM"
        _text(f, "train.txt", "drive 4\n")
        _text(f, "sequences.json", json.dumps(seqs))
    for test_mode in (True, False):
        kw = dict(data_root=str(tmp_path), test_mode=test_mode, image_shape=TARGET)
        port = sequence.SequenceHDF5Dataset(_spec(DatasetSpec, "sequence", "seq.hdf5"), **kw)
        jax_ = j_sequence.SequenceHDF5Dataset(_spec(JSpec, "sequence", "seq.hdf5"), **kw)
        for seed in range(4):
            rp, rj = np.random.default_rng(seed), np.random.default_rng(seed)
            _same(port.get_single_item(0, rp), jax_.get_single_item(0, rj))
        multi = dict(kw, num_frames=3, fps_range=(1, 5))
        port = sequence.SequenceHDF5Dataset(_spec(DatasetSpec, "sequence", "seq.hdf5"), **multi)
        jax_ = j_sequence.SequenceHDF5Dataset(_spec(JSpec, "sequence", "seq.hdf5"), **multi)
        frames = port.get_single_item(0, np.random.default_rng(7))
        for got, want in zip(frames, jax_.get_single_item(0, np.random.default_rng(7)), strict=True):
            _same(got, want)


def test_missing_h5py_is_named(monkeypatch, shards):
    import sys

    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="needs h5py"):
        base.make_dataset("NYUv2Depth", data_root=shards)
