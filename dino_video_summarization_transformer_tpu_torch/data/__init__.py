from . import selection, video, windows
from .datasets import (ClipDataset, DinoLossDataset, FrameSelectionDataset,
                       build_dataset, read_csv_entries)
from .loader import PrefetchLoader, shard_indices

__all__ = [
    "selection",
    "video",
    "windows",
    "ClipDataset",
    "DinoLossDataset",
    "FrameSelectionDataset",
    "build_dataset",
    "read_csv_entries",
    "PrefetchLoader",
    "shard_indices",
]
