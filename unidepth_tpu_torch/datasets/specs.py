"""Declarative dataset registry (a copy of unidepth_tpu/datasets/specs.py,
which the port may not import): one ``DatasetSpec`` row a dataset, its depth
range and scale, HDF5 shards, split files, eval crop and annotation flags,
read by the HDF5 readers (``base.py``, ``sequence.py``) and the
evaluation's depth ranges.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    kind: str  # 'image' | 'sequence'
    min_depth: float
    max_depth: float
    depth_scale: float
    hdf5_paths: tuple[str, ...]
    train_split: str
    test_split: str
    crop: str | None = None  # eval mask crop: None|'garg'|'eigen'
    benchmark_split: str | None = None
    intrinsics_table: str | None = None  # key into INTRINSICS_TABLES
    pre_crop: tuple[int, int] | None = None  # fixed crop before resize (KITTI)
    pano: bool = False  # equirectangular: PanoCrop+PanoRoll before resize
    # Annotation flags (reference base_dataset.py:294-297 defaults, overridden
    # per dataset in each module's pre_pipeline): si = metric scale unknown
    # (scale-invariant supervision only), ssi = scale+shift unknown (relative
    # depth), dense = dense GT, synthetic = rendered data, quality = noise
    # tier (0 clean .. 2 noisy).
    si: bool = False
    ssi: bool = False
    dense: bool = False
    synthetic: bool = False
    quality: int = 0


# KITTI per-date intrinsics (reference kitti.py:14-50, first 3x3 block)
KITTI_INTRINSICS = {
    "2011_09_26": [[721.5377, 0.0, 609.5593], [0.0, 721.5377, 172.8540], [0.0, 0.0, 1.0]],
    "2011_09_28": [[707.0493, 0.0, 604.0814], [0.0, 707.0493, 180.5066], [0.0, 0.0, 1.0]],
    "2011_09_29": [[718.3351, 0.0, 600.3891], [0.0, 718.3351, 181.5122], [0.0, 0.0, 1.0]],
    "2011_09_30": [[707.0912, 0.0, 601.8873], [0.0, 707.0912, 183.1104], [0.0, 0.0, 1.0]],
    "2011_10_03": [[718.8560, 0.0, 607.1928], [0.0, 718.8560, 185.2157], [0.0, 0.0, 1.0]],
}

INTRINSICS_TABLES = {"kitti_dates": KITTI_INTRINSICS}


def _shards(pattern: str, n: int) -> tuple[str, ...]:
    return tuple(pattern.format(i) for i in range(n))


_ROWS = [
    # name, kind, min_d, max_d, scale, hdf5, train, test, extras
    ("2D3DS", "sequence", 0.01, 10.0, 512.0, ("2D3DS.hdf5",), "train.txt", "train.txt", {}),
    ("4DOR", "sequence", 0.01, 10.0, 1000.0, ("4DOR.hdf5",), "train.txt", "train.txt", {}),
    ("A2D2", "image", 0.01, 120.0, 256.0, ("a2d2.hdf5",), "train_clean.txt", "train_clean.txt", {}),
    ("ADT", "sequence", 0.01, 20.0, 1000.0, ("ADT.hdf5",), "train.txt", "val.txt", {}),
    ("aiMotive", "sequence", 0.01, 100.0, 256.0, ("aiMotive.hdf5",), "train.txt", "train.txt", {}),
    ("Argoverse", "image", 0.05, 120.0, 256.0, ("argoverse11.hdf5",), "argo_train.txt", "argo_val.txt", {}),
    ("Argoverse2", "sequence", 0.05, 120.0, 256.0, ("AV2_viz.hdf5",), "train.txt", "val.txt", {}),
    ("ARKit", "sequence", 0.01, 10.0, 1000.0, ("ARKitS.hdf5",), "Training.txt", "Training.txt", {}),
    ("ASE", "sequence", 0.01, 20.0, 1000.0, ("ASE.hdf5",), "train.txt", "val.txt", {}),
    ("BDD", "image", 0.01, 70.0, 256.0, ("BDD.hdf5",), "train_clean.txt", "val.txt", {}),
    # split names look swapped but match the reference verbatim
    # (reference datasets/bedlam.py:10-11: train_split="val.txt")
    ("BEDLAM", "sequence", 0.01, 256.0, 1000.0, ("BEDLAM.hdf5",), "val.txt", "train.txt", {}),
    ("Behave", "sequence", 0.01, 10.0, 1000.0, ("Behave.hdf5",), "train.txt", "train.txt", {}),
    ("BlendedMVG", "sequence", 0.01, 5000.0, 1000.0, ("BlendedMVG_.hdf5",), "train.txt", "train.txt", {}),
    ("Cityscape", "image", 0.05, 80.0, 256.0, ("cityscape.hdf5",), "train.txt", "val.txt", {}),
    ("DDAD", "image", 0.05, 120.0, 256.0, _shards("ddad/ddad_{}.hdf5", 8), "train.txt", "val.txt", {}),
    ("Deep360", "sequence", 0.1, 1000.0, 1000.0, ("Deep360.hdf5",), "train.txt", "train.txt", {}),
    ("DENSE", "image", 0.05, 80.0, 255.0, ("DENSE.hdf5",), "train.txt", "train.txt", {}),
    ("DIML", "image", 0.01, 100.0, 256.0, ("DIML.hdf5",), "train.txt", "test.txt", {}),
    ("DiodeIndoor", "image", 0.01, 25.0, 256.0, ("DiodeIndoor.hdf5",), "train.txt", "val.txt", {}),
    ("DiodeIndoor_F", "sequence", 0.01, 25.0, 1000.0, ("DiodeIndoor-F.hdf5",), "train.txt", "train.txt", {}),
    ("DiodeOutdoor", "image", 0.1, 80.0, 256.0, ("diode.hdf5",), "diode_outdoor_train.txt", "diode_outdoor_val.txt", {}),
    ("Diode", "image", 0.6, 80.0, 256.0, ("diode.hdf5",), "diode_train.txt", "diode_val.txt", {}),
    ("DL3DV", "sequence", 0.001, 250.0, 512.0, ("DL3DVcv.hdf5",), "train.txt", "train.txt", {}),
    ("DrivingStereo", "image", 0.05, 80.0, 256.0, ("DrivingStereo.hdf5",), "drivingstereo_train.txt", "drivingstereo_val.txt", {}),
    ("DTURMVD", "sequence", 0.05, 3.0, 1000.0, ("dtu_rmvd.hdf5",), "test.txt", "test.txt", {}),
    ("DynReplica", "sequence", 0.01, 20.0, 512.0, ("DynReplica.hdf5",), "train.txt", "val.txt", {}),
    ("EDEN", "sequence", 0.1, 100.0, 256.0, ("EDEN.hdf5",), "train.txt", "train.txt", {}),
    ("ETH3D", "image", 0.01, 50.0, 1000.0, ("ETH3D.hdf5",), "train.txt", "train.txt", {}),
    ("ETH3D_F", "sequence", 0.05, 60.0, 1000.0, ("ETH3D-F.hdf5",), "train.txt", "train.txt", {}),
    ("ETH3DRMVD", "sequence", 0.01, 50.0, 1000.0, ("eth3d_rmvd.hdf5",), "test.txt", "test.txt", {}),
    ("FaceDepth", "sequence", 0.01, 10.0, 1000.0, ("FaceDepth.hdf5",), "train.txt", "train.txt", {}),
    ("FLSea", "image", 0.05, 20.0, 1000.0, ("FLSea.hdf5",), "train.txt", "train.txt", {}),
    ("FutureHouse", "sequence", 0.01, 10.0, 1000.0, ("FutureHouse.hdf5",), "train.txt", "train.txt", {}),
    ("Gibson", "sequence", 0.01, 10.0, 1000.0, ("Gibson.hdf5",), "train.txt", "train.txt", {}),
    ("HAMMER", "image", 0.005, 10.0, 1000.0, ("hammer.hdf5",), "test.txt", "test.txt", {}),
    ("HM3D", "sequence", 0.01, 10.0, 1000.0, ("HM3D.hdf5",), "full.txt", "val.txt", {}),
    ("HOI4D", "sequence", 0.01, 10.0, 1000.0, ("HOI4D.hdf5",), "train.txt", "train.txt", {}),
    ("HRWSI", "image", 0.01, 1000.0, 50.0, ("HRWSI.hdf5",), "train.txt", "val.txt", {}),
    ("HyperSim", "image", 0.01, 50.0, 1000.0, _shards("hypersim/hypersim_{}.hdf5", 8), "train.txt", "val.txt", {}),
    ("IBims", "image", 0.005, 25.0, 1000.0, ("ibims.hdf5",), "ibims_val.txt", "ibims_val.txt", {}),
    ("IBims_F", "sequence", 0.01, 25.0, 1000.0, ("IBims-F.hdf5",), "train.txt", "train.txt", {}),
    ("KenBurns", "image", 0.05, 50.0, 256.0, _shards("3dkenburns/3DKenBurns_{}.hdf5", 8), "train.txt", "val.txt", {}),
    ("KITTI", "image", 0.05, 80.0, 256.0, ("kitti.hdf5",), "kitti_eigen_train.txt", "kitti_eigen_test.txt",
     {"crop": "garg", "benchmark_split": "kitti_test.txt", "intrinsics_table": "kitti_dates"}),
    ("KITTIBenchmark", "image", 0.05, 80.0, 256.0, ("kitti_benchmark.hdf5",), "val_split.txt", "test_split.txt", {}),
    ("KITTI360", "sequence", 0.01, 80.0, 256.0, ("KITTI360.hdf5",), "train.txt", "val_split.txt", {}),
    ("KITTIMulti", "sequence", 0.05, 80.0, 256.0, ("KITTI_sequence.hdf5",), "train.txt", "val.txt", {}),
    ("KITTIRMVD", "sequence", 0.05, 80.0, 256.0, ("kitti_rmvd.hdf5",), "test.txt", "test.txt", {}),
    ("Lyft", "image", 0.05, 80.0, 256.0, ("Lyft2.hdf5",), "train.txt", "test.txt", {}),
    ("Mapillary", "image", 0.01, 70.0, 256.0, ("Mapillary.hdf5",), "mapillary_train_clean.txt", "mapillary_val.txt", {}),
    ("MatrixCity", "sequence", 0.01, 200.0, 1000.0, ("MatrixCity.hdf5",), "train_full.txt", "test.txt", {}),
    ("Matterport3D", "sequence", 0.01, 10.0, 1000.0, ("Matterport3D.hdf5",), "train.txt", "train.txt", {}),
    ("MegaDepth", "image", 0.01, 1000.0, 50.0, ("MegaDepth.hdf5",), "train.txt", "test.txt", {}),
    ("MegaDepthS", "sequence", 0.001, 10000.0, 512.0, ("MegaDepthS.hdf5",), "train.txt", "train.txt", {}),
    ("MidAir", "sequence", 0.1, 1000.0, 1000.0, ("MidAir.hdf5",), "train.txt", "train.txt", {}),
    ("MIP", "sequence", 0.01, 100.0, 1000.0, ("MIP.hdf5",), "train.txt", "train.txt", {}),
    ("MS2", "sequence", 0.01, 100.0, 256.0, ("MS2.hdf5",), "train.txt", "train.txt", {}),
    ("MVImgNet", "sequence", 0.005, 10.0, 1000.0, ("MVImgNet.hdf5",), "train.txt", "train.txt", {}),
    ("MVSynth", "sequence", 0.1, 1000.0, 256.0, ("MVSynth.hdf5",), "train.txt", "val.txt", {}),
    ("NeRDS360", "sequence", 0.01, 1000.0, 1000.0, ("NeRDS360.hdf5",), "train.txt", "val.txt", {}),
    ("NianticMapFree", "sequence", 0.1, 250.0, 512.0, ("NianticMapFree.hdf5",), "train.txt", "train.txt", {}),
    ("Nuscenes", "image", 0.05, 80.0, 256.0, _shards("nuscenes/nuscenes_{}.hdf5", 8), "train.txt", "val.txt", {}),
    ("NYUv2Depth", "image", 0.005, 10.0, 1000.0, ("nyuv2.hdf5",), "nyu_train.txt", "nyu_test.txt", {"crop": "eigen"}),
    ("OASISv2", "image", 0.01, 400.0, 1000.0, ("Oasis2.hdf5",), "train.txt", "val.txt", {}),
    ("PointOdyssey", "sequence", 0.01, 250.0, 1000.0, ("PointOdyssey.hdf5",), "train.txt", "test.txt", {}),
    ("Proteus", "sequence", 0.01, 10.0, 1000.0, ("Proteus.hdf5",), "train.txt", "train.txt", {}),
    ("ScanNet", "sequence", 0.005, 10.0, 1000.0, ("ScanNetS.hdf5",), "train.txt", "test.txt", {}),
    ("ScanNetpp", "sequence", 0.001, 10.0, 1000.0, ("ScanNetpp_viz.hdf5",), "train_iphone.txt", "val_iphone.txt", {}),
    ("ScanNetpp_F", "sequence", 0.001, 10.0, 1000.0, ("ScanNetpp_F.hdf5",), "train.txt", "val_split.txt", {}),
    ("Sintel", "sequence", 0.001, 1000.0, 1000.0, ("Sintel.hdf5",), "training.txt", "training.txt", {}),
    ("SUNRGBD", "image", 0.005, 8.0, 1000.0, ("SUNRGB.hdf5",), "alltrain.txt", "alltest.txt", {}),
    ("Synscapes", "sequence", 0.1, 1000.0, 256.0, ("Synscapes.hdf5",), "train.txt", "train.txt", {}),
    ("TartanAir", "sequence", 0.01, 512.0, 1000.0, ("TartanAir.hdf5",), "train.txt", "train.txt", {}),
    ("Taskonomy", "image", 0.005, 15.0, 512.0, ("Taskonomy.hdf5",), "train_clean.txt", "val.txt", {}),
    ("TATRMVD", "sequence", 0.001, 50.0, 1000.0, ("tanks_and_temples_rmvd.hdf5",), "test.txt", "test.txt", {}),
    ("Theo", "sequence", 0.01, 10.0, 1000.0, ("THEO.hdf5",), "train.txt", "train.txt", {}),
    ("UnrealStereo4K", "sequence", 0.01, 200.0, 1000.0, ("UnrealStereo4K.hdf5",), "train.txt", "train.txt", {}),
    ("UrbanSyn", "sequence", 0.1, 1000.0, 256.0, ("UrbanSyn.hdf5",), "train.txt", "train.txt", {}),
    ("VKITTI", "sequence", 0.01, 255.0, 256.0, ("VKITTI2.hdf5",), "training.txt", "training.txt", {}),
    ("VOID", "image", 0.01, 10.0, 256.0, ("void.hdf5",), "void_train.txt", "void_val.txt", {}),
    ("Waymo", "sequence", 0.05, 70.0, 256.0, ("Waymo_viz.hdf5",), "training.txt", "validation.txt", {}),
    ("WildRGBD", "sequence", 0.01, 10.0, 1000.0, ("WildRGBD.hdf5",), "train.txt", "train.txt", {}),
]

# Per-dataset annotation flags: each entry transcribes that dataset module's
# pre_pipeline overrides in the reference (e.g. dtu_rmvd.py:57-62,
# hypersim.py, vkitti.py). Datasets absent here keep the base defaults
# (si=False, ssi=False, dense=False, synthetic=False, quality=0).
_d = dict
_FLAGS: dict[str, dict] = {
    "2D3DS": _d(dense=True, quality=1, pano=True),
    "4DOR": _d(dense=True, quality=2),
    "A2D2": _d(quality=1),
    "ADT": _d(dense=True, synthetic=True),
    "aiMotive": _d(quality=2),
    "Argoverse2": _d(quality=1),
    "ARKit": _d(dense=True, quality=2),
    "ASE": _d(dense=True, synthetic=True),
    "BDD": _d(si=True, quality=2),
    "BEDLAM": _d(dense=True, synthetic=True),
    "Behave": _d(dense=True, quality=1),
    "BlendedMVG": _d(dense=True, quality=2),
    "Cityscape": _d(quality=2),
    "DDAD": _d(quality=1),
    "Deep360": _d(dense=True, synthetic=True, pano=True),
    "DENSE": _d(quality=1),
    "DIML": _d(dense=True, quality=2),
    "Diode": _d(dense=True, quality=1),
    "DiodeIndoor": _d(dense=True, quality=1),
    "DiodeIndoor_F": _d(dense=True, quality=1),
    "DiodeOutdoor": _d(dense=True, quality=1),
    "DL3DV": _d(si=True, quality=2),
    "DrivingStereo": _d(quality=1),
    "DTURMVD": _d(si=True, dense=True, quality=1),
    "DynReplica": _d(dense=True, synthetic=True),
    "EDEN": _d(dense=True, synthetic=True),
    "ETH3D": _d(dense=True, quality=1),
    "ETH3D_F": _d(dense=True, quality=1),
    "FaceDepth": _d(dense=True, synthetic=True),
    "FLSea": _d(dense=True, quality=2),
    "FutureHouse": _d(dense=True, synthetic=True, pano=True),
    "Gibson": _d(dense=True, quality=1, synthetic=True, pano=True),
    "HAMMER": _d(dense=True, quality=1),
    "HM3D": _d(dense=True, quality=2),
    "HOI4D": _d(dense=True, quality=1),
    "HRWSI": _d(ssi=True),
    "HyperSim": _d(dense=True, synthetic=True),
    "IBims": _d(dense=True, quality=1),
    "IBims_F": _d(dense=True, quality=1),
    "KenBurns": _d(dense=True, synthetic=True),
    # KITTI composes a fixed 352x1216 benchmark crop before the resizer in
    # train and test alike (reference kitti.py:92,131).
    "KITTI": _d(quality=1, pre_crop=(352, 1216)),
    "KITTI360": _d(quality=1),
    "Mapillary": _d(si=True, quality=2),
    "MatrixCity": _d(dense=True, synthetic=True),
    "Matterport3D": _d(dense=True, quality=1, synthetic=True, pano=True),
    "MegaDepth": _d(ssi=True),
    "MegaDepthS": _d(si=True, quality=2),
    "MidAir": _d(dense=True, synthetic=True),
    "MIP": _d(si=True, dense=True, quality=2),
    "MS2": _d(quality=1),
    "MVImgNet": _d(si=True, quality=2),
    "MVSynth": _d(si=True, dense=True, synthetic=True),
    "NeRDS360": _d(dense=True, quality=1),
    "NianticMapFree": _d(si=True, quality=2),
    "Nuscenes": _d(quality=1),
    "NYUv2Depth": _d(dense=True, quality=2),
    "OASISv2": _d(ssi=True),
    "PointOdyssey": _d(dense=True, synthetic=True),
    "Proteus": _d(dense=True, synthetic=True),
    "ScanNet": _d(dense=True, quality=1),
    "ScanNetpp": _d(dense=True, quality=1),
    "ScanNetpp_F": _d(dense=True, quality=1),
    "Sintel": _d(dense=True, synthetic=True),
    "Synscapes": _d(dense=True, synthetic=True),
    "TartanAir": _d(dense=True, synthetic=True),
    "Taskonomy": _d(dense=True, quality=2),
    "TATRMVD": _d(si=True, quality=2),
    "Theo": _d(dense=True, synthetic=True),
    "UnrealStereo4K": _d(dense=True, synthetic=True),
    "UrbanSyn": _d(dense=True, synthetic=True),
    "VKITTI": _d(dense=True, synthetic=True),
    "VOID": _d(dense=True, quality=2),
    "Waymo": _d(quality=1),
    "WildRGBD": _d(dense=True, quality=1),
    # RMVD eval wrappers compose a fixed KITTI-benchmark crop before the
    # resizer (reference kitti_rmvd.py:56 and kitti.py:92).
    "KITTIRMVD": _d(pre_crop=(352, 1216), crop="garg"),
}
del _d

SPECS: dict[str, DatasetSpec] = {
    name: DatasetSpec(
        name=name,
        kind=kind,
        min_depth=mind,
        max_depth=maxd,
        depth_scale=scale,
        hdf5_paths=tuple(paths),
        train_split=train,
        test_split=test,
        **{**_FLAGS.get(name, {}), **extras},
    )
    for name, kind, mind, maxd, scale, paths, train, test, extras in _ROWS
}
