"""Data layer: the declarative dataset registry, the HDF5 and sequence
readers, their transforms and the threaded loader (the counterpart of
unidepth_tpu/datasets). Importing it needs neither PIL nor h5py."""

from unidepth_tpu_torch.datasets.base import HDF5Dataset, make_dataset
from unidepth_tpu_torch.datasets.dummy import Dummy
from unidepth_tpu_torch.datasets.loader import Loader, ShapeSampler, WeightedConcat, collate, device_prefetch, get_weights
from unidepth_tpu_torch.datasets.samplers import ShardedEvalSampler
from unidepth_tpu_torch.datasets.sequence import SequenceHDF5Dataset, make_sequence_dataset
from unidepth_tpu_torch.datasets.specs import SPECS, DatasetSpec

__all__ = [
    "HDF5Dataset",
    "SequenceHDF5Dataset",
    "Dummy",
    "Loader",
    "ShapeSampler",
    "WeightedConcat",
    "ShardedEvalSampler",
    "collate",
    "device_prefetch",
    "get_weights",
    "make_dataset",
    "make_sequence_dataset",
    "SPECS",
    "DatasetSpec",
]
