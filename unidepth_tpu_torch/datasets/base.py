"""The generic HDF5 dataset reader (the counterpart of
unidepth_tpu/datasets/base.py): one reader driven by a ``DatasetSpec``. The
split text is stored inside the HDF5 file, the image and depth blobs at
node paths; depth is 16-bit or 24-bit packed; intrinsics come from a
per-date table or a default; a failed sample is retried with a random
index. Samples are numpy dicts for the transforms (``pipelines.py``) and
the loader.

PNG blobs decode through the port's codec (``utils/png.py``) and the
native helpers; any other format (JPEG) imports PIL at the call, and h5py
is imported when a shard is opened, so importing this module needs
neither.
"""

from __future__ import annotations

import copy
import io
import os

import numpy as np

from unidepth_tpu_torch import native
from unidepth_tpu_torch.datasets.pipelines import (
    AnnotationMask,
    Compose,
    ContextCrop,
    GaussianBlur,
    KittiCrop,
    PanoCrop,
    PanoRoll,
    RandomColorJitter,
    RandomFlip,
    RandomGamma,
    RandomGrayscale,
)
from unidepth_tpu_torch.datasets.specs import INTRINSICS_TABLES, SPECS, DatasetSpec
from unidepth_tpu_torch.utils.png import is_png, png_asarray, png_samples, png_to_rgb

__all__ = ["HDF5Dataset", "decode_depth", "decode_flow", "decode_rgb", "make_dataset"]


def _pil_open(blob: bytes):
    """PIL's image of a blob the port's codec does not read (JPEG and other
    formats): PIL is imported here, and its absence named."""
    kind = "JPEG" if blob[:3] == b"\xff\xd8\xff" else f"non-PNG (magic {blob[:8]!r})"
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"decoding a {kind} image needs PIL (Pillow), which is not installed; "
                          "PNG decodes without it") from e
    return Image.open(io.BytesIO(blob))


def decode_depth(blob: bytes, depth_scale: float) -> np.ndarray:
    """Image blob -> metric depth (H, W) float32. 3-channel images carry
    24-bit packed depth, unpacked and scaled in one native pass."""
    img = png_asarray(blob) if is_png(blob) else np.asarray(_pil_open(blob))
    if img.ndim == 3:
        return native.unpack24_scale(img[..., :3], depth_scale)
    if img.dtype == np.uint16:
        return native.scale_u16(img, depth_scale)
    return (img.astype(np.float64) / depth_scale).astype(np.float32)


def decode_rgb(blob: bytes) -> np.ndarray:
    """Image blob -> (H, W, 3) uint8, as PIL's ``convert("RGB")``."""
    if is_png(blob):
        return png_to_rgb(blob)
    return np.asarray(_pil_open(blob).convert("RGB"))


def _decode_png16_rgb(blob: bytes) -> np.ndarray:
    """A 16-bit-per-channel RGB PNG -> (H, W, 3) uint16 (PIL would cut each
    sample to its high byte, destroying the 12-bit flow payload)."""
    samples, colour, _ = png_samples(blob)
    if samples.dtype != np.uint16 or colour != 2:
        raise ValueError(f"not a 16-bit RGB PNG (colour type {colour}, {samples.dtype})")
    return samples


def decode_flow(blob: bytes) -> tuple[np.ndarray, np.ndarray]:
    """16-bit PNG optical flow: channels 0 and 1 carry (u, v) packed as
    value / 2^4 - 2^11 twelve-bit fixed point; channel 2 is validity.
    Returns (flow (H, W, 2) float32, valid (H, W) bool)."""
    if is_png(blob) and blob[24] == 16 and blob[25] == 2:
        img = _decode_png16_rgb(blob).astype(np.float64)
    else:
        img = (png_asarray(blob) if is_png(blob) else np.asarray(_pil_open(blob))).astype(np.float64)
    flow = (img[..., :2] / 2.0**4) - 2.0**11
    valid = img[..., 2] > 0 if img.shape[-1] > 2 else np.ones(img.shape[:2], bool)
    return flow.astype(np.float32), valid


class HDF5Dataset:
    """One dataset: its HDF5 shard(s), its split, its spec's metadata."""

    def __init__(
        self,
        spec: DatasetSpec,
        data_root: str | None = None,
        test_mode: bool = False,
        image_shape: tuple[int, int] = (480, 640),
        augmentations: dict | None = None,
        benchmark: bool = False,
        mini: float = 1.0,
    ):
        self.spec = spec
        self.test_mode = test_mode
        self.image_shape = tuple(image_shape)
        self.data_root = data_root or os.environ.get("DATAROOT", ".")
        split = spec.test_split if test_mode else spec.train_split
        if benchmark and spec.benchmark_split:
            split = spec.benchmark_split
        self.split_file = split
        self.samples = self._load_split()
        if mini < 1.0 and not test_mode:
            n = max(1, int(len(self.samples) * mini))
            self.samples = self.samples[:: max(1, len(self.samples) // n)]
        aug = augmentations or {}
        # fixed transforms before the resizer: the KITTI family's benchmark
        # crop, or the panoramic pole trim + roll
        if spec.pre_crop:
            self.pre_cropper = KittiCrop(crop_size=spec.pre_crop)
        elif spec.pano:
            self.pre_cropper = Compose([PanoCrop(), PanoRoll(test_mode=test_mode)])
        else:
            self.pre_cropper = None
        self.resizer = ContextCrop(image_shape=self.image_shape, test_context=aug.get("test_context", 1.0),
                                   test_mode=test_mode)
        self.masker = AnnotationMask(min_value=0.0, max_value=spec.max_depth if test_mode else None,
                                     crop=spec.crop if test_mode else None)
        if test_mode:
            self.augmenter = None
        else:
            self.augmenter = Compose(
                [
                    RandomFlip(prob=aug.get("flip_p", 0.5)),
                    RandomColorJitter(strength=aug.get("random_jitter", 0.4), prob=aug.get("jitter_p", 0.8)),
                    RandomGamma(strength=aug.get("random_gamma", 0.2), prob=aug.get("gamma_p", 0.8)),
                    GaussianBlur(radius=aug.get("random_blur", 2.0), prob=aug.get("blur_p", 0.2)),
                    RandomGrayscale(prob=aug.get("grayscale_p", 0.2)),
                ]
            )

    # -- split handling ------------------------------------------------
    def _h5(self, chunk_idx: int = 0):
        """Shard ``chunk_idx`` opened read-only (h5py is imported here)."""
        try:
            import h5py
        except ImportError as e:
            raise ImportError(f"{self.spec.name}: reading HDF5 shards needs h5py, which is not installed") from e
        path = os.path.join(self.data_root, self.spec.hdf5_paths[chunk_idx])
        return h5py.File(path, "r", libver="latest", swmr=True)

    def _load_split(self) -> list[tuple]:
        with self._h5(0) as f:
            raw = np.array(f[self.split_file]).tobytes().decode("ascii").rstrip("\x00")
        samples = []
        for line in raw.strip().split("\n"):
            parts = line.strip().split(" ")
            if len(parts) < 2 or parts[1] == "None":
                continue
            chunk = int(parts[2]) if len(parts) > 2 and parts[2].isdigit() else 0
            samples.append((parts[0], parts[1], chunk))
        return samples

    def __len__(self):
        return len(self.samples)

    # -- intrinsics ----------------------------------------------------
    def _intrinsics_for(self, image_name: str) -> np.ndarray | None:
        if self.spec.intrinsics_table is None:
            return None
        table = INTRINSICS_TABLES[self.spec.intrinsics_table]
        for key, K in table.items():
            if key in image_name:
                return np.asarray(K, np.float32)
        return None

    def _default_K(self) -> np.ndarray:
        h, w = self.image_shape
        return np.asarray([[0.7 * w, 0, 0.5 * w], [0, 0.7 * w, 0.5 * h], [0, 0, 1]], np.float32)

    # -- item ----------------------------------------------------------
    def _read(self, idx: int) -> dict:
        image_name, depth_name, chunk = self.samples[idx]
        with self._h5(chunk) as f:
            image = decode_rgb(np.array(f["/" + image_name]).tobytes())
            depth = decode_depth(np.array(f["/" + depth_name]).tobytes(), self.spec.depth_scale)
        K = self._intrinsics_for(image_name)
        if K is None:
            K = self._default_K()
        return {
            "image": image,
            "depth": depth,
            "K": K,
            "validity": np.ones(depth.shape, bool),
            "flip": False,
            "si": self.spec.si,
            "ssi": self.spec.ssi,
            "dense": self.spec.dense,
            "synthetic": self.spec.synthetic,
            "quality": self.spec.quality,
            "dataset": self.spec.name,
        }

    def read_base(self, idx: int) -> dict | None:
        """The decoded, unaugmented sample ``idx``, for ``num_copies``
        replication (the loader decodes once and augments each copy).
        Readers whose samples are not one decoded dict return None."""
        return self._read(idx)

    def get_single_item(self, idx: int, rng: np.random.Generator, image_shape=None, base=None) -> dict:
        """Sample ``idx`` through the pipeline at ``image_shape`` (default:
        the reader's). ``base``: a ``read_base(idx)`` result to augment
        instead of reading again; deep-copied, as the transforms may mutate
        its arrays."""
        sample = copy.deepcopy(base) if base is not None else self._read(idx)
        if self.pre_cropper is not None:
            sample = self.pre_cropper(sample, rng)
        sample = self.resizer(sample, rng, image_shape=image_shape)
        if np.count_nonzero(sample["depth"] > 0) < 50:
            raise IndexError("too few valid depth points")
        if self.augmenter is not None:
            sample = self.augmenter(sample, rng)
        sample = self.masker(sample, rng)
        return sample

    def __getitem__(self, idx: int) -> dict:
        # in test mode the rng is seeded by the index, so frame selection
        # and the retry's replacement are the same in every run and process
        rng = np.random.default_rng(idx if self.test_mode else None)
        for _ in range(8):  # a failed sample is retried with a random index
            try:
                return self.get_single_item(idx, rng)
            except Exception:
                idx = int(rng.integers(0, len(self.samples)))
        raise RuntimeError(f"{self.spec.name}: failed to load any sample")


def make_dataset(name: str, **kwargs) -> HDF5Dataset:
    """The reader of the spec's kind: a ``SequenceHDF5Dataset`` (sequences
    JSON, fps resampling) for sequence-kind specs, else the flat reader."""
    spec = SPECS[name]
    if spec.kind == "sequence":
        from unidepth_tpu_torch.datasets.sequence import SequenceHDF5Dataset

        return SequenceHDF5Dataset(spec, **kwargs)
    return HDF5Dataset(spec, **kwargs)
