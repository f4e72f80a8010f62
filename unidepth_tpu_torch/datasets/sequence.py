"""Sequence datasets over HDF5 shards (the counterpart of
unidepth_tpu/datasets/sequence.py): a sequences JSON inside the HDF5 file
maps each sequence name to its frames' fields (image and depth blob paths,
inline K or a camera parameter vector, cam2w, points, flows); frames are
drawn with fps resampling (5 fps by default, a random fps in ``fps_range``
at train time). Emits the per-frame sample dicts the transforms take; a
multi-frame draw is a list of them.
"""

from __future__ import annotations

import json

import numpy as np

from unidepth_tpu_torch.datasets.base import HDF5Dataset, decode_depth, decode_flow, decode_rgb
from unidepth_tpu_torch.datasets.specs import SPECS

__all__ = ["SequenceHDF5Dataset", "make_sequence_dataset"]


class SequenceHDF5Dataset(HDF5Dataset):
    default_fps = 5
    sequences_file = "sequences.json"

    def __init__(self, *args, num_frames: int = 1, fps_range=None, **kwargs):
        self.num_frames = num_frames
        self.fps_range = fps_range
        super().__init__(*args, **kwargs)

    def _load_split(self) -> list:
        with self._h5(0) as f:
            raw = np.array(f[self.split_file]).tobytes().decode("ascii").strip()
            try:
                seq_raw = np.array(f[self.sequences_file]).tobytes().decode("ascii")
                self.sequences = json.loads(seq_raw)
            except KeyError:
                self.sequences = {}
        samples = []
        for line in raw.split("\n"):
            parts = line.strip().split(" ")
            if len(parts) < 2:
                continue
            samples.append((parts[0], int(parts[1])))
        return samples

    def _frame_indices(self, n: int, rng: np.random.Generator) -> list[int]:
        """The fps-resampled frame window of a sequence of ``n`` frames."""
        if self.num_frames == 1:
            return [int(rng.integers(0, n))]
        if self.num_frames > n:
            raise IndexError("sequence too short")
        if self.fps_range is None:
            stride = 1.0
        else:
            min_fps, max_fps = self.fps_range
            max_fps = min(max_fps, self.default_fps)
            min_fps = max(min_fps, self.num_frames / n * self.default_fps)
            fps = float(rng.uniform(min_fps, max_fps)) if not self.test_mode else max_fps
            stride = self.default_fps / fps
        span = int(stride * (self.num_frames - 1))
        start = int(rng.integers(0, max(1, n - span)))
        return [min(n - 1, start + int(round(stride * i))) for i in range(self.num_frames)]

    def _read_frame(self, seq_name: str, frame: dict, chunk: int = 0) -> dict:
        points = flow_fwd = flow_bwd = None
        with self._h5(chunk) as f:
            image = decode_rgb(np.array(f["/" + frame["image"]]).tobytes())
            depth = None
            if "depth" in frame:
                depth = decode_depth(np.array(f["/" + frame["depth"]]).tobytes(), self.spec.depth_scale)
            # optional per-frame fields: points as raw arrays, flows as
            # 12-bit packed 16-bit PNGs
            if "points" in frame:
                points = np.array(f["/" + frame["points"]], np.float32)
            if "flow_fwd" in frame:
                flow_fwd = decode_flow(np.array(f["/" + frame["flow_fwd"]]).tobytes())
            if "flow_bwd" in frame:
                flow_bwd = decode_flow(np.array(f["/" + frame["flow_bwd"]]).tobytes())
        if "camera_params" in frame:
            # a full camera model: its parameter vector (fx, fy, cx, cy,
            # distortion ...) and its model name
            cp = np.asarray(frame["camera_params"], np.float32).reshape(-1)
            K = np.asarray([[cp[0], 0, cp[2]], [0, cp[1], cp[3]], [0, 0, 1]], np.float32)
        else:
            cp = None
            K = np.asarray(frame["K"], np.float32) if "K" in frame else self._default_K()
            if K.shape == (4, 4):
                K = K[:3, :3]
        out = {
            "image": image,
            "K": K,
            "validity": np.ones(image.shape[:2], bool),
            "flip": False,
            "si": self.spec.si,
            "ssi": self.spec.ssi,
            "dense": self.spec.dense,
            "synthetic": self.spec.synthetic,
            "quality": self.spec.quality,
            "dataset": self.spec.name,
        }
        if depth is not None:
            out["depth"] = depth
        if cp is not None:
            out["camera_params"] = cp
            out["camera_model"] = frame.get("camera_model", "Pinhole")
        if "cam2w" in frame:
            out["cam2w"] = np.asarray(frame["cam2w"], np.float32)
        if points is not None:
            out["points"] = points
        if flow_fwd is not None:
            out["flow_fwd"], out["flow_fwd_mask"] = flow_fwd
        if flow_bwd is not None:
            out["flow_bwd"], out["flow_bwd_mask"] = flow_bwd
        return out

    def read_base(self, idx: int) -> None:
        # a draw decodes a frame set chosen by the draw (fps resampling), so
        # there is no single decoded dict to replicate
        return None

    def get_single_item(self, idx: int, rng: np.random.Generator, image_shape=None, base=None) -> dict | list[dict]:
        seq_name, n = self.samples[idx]
        frames_meta = self.sequences.get(seq_name)
        if frames_meta is None:
            raise IndexError(f"no sequence metadata for {seq_name}")
        idxs = self._frame_indices(n, rng)
        out = []
        for fi in idxs:
            meta = frames_meta[str(fi)] if isinstance(frames_meta, dict) else frames_meta[fi]
            s = self._read_frame(seq_name, meta)
            if self.pre_cropper is not None:
                s = self.pre_cropper(s, rng)
            s = self.resizer(s, rng, image_shape=image_shape)
            if "depth" in s and np.count_nonzero(s["depth"] > 0) < 50:
                raise IndexError("too few valid depth points")
            if self.augmenter is not None:
                s = self.augmenter(s, rng)
            s = self.masker(s, rng)
            out.append(s)
        return out[0] if self.num_frames == 1 else out


def make_sequence_dataset(name: str, **kwargs) -> SequenceHDF5Dataset:
    return SequenceHDF5Dataset(SPECS[name], **kwargs)
