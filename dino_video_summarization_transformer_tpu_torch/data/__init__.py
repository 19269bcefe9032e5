from . import selection, video, windows
from .datasets import DinoLossDataset, read_csv_entries
from .loader import PrefetchLoader, shard_indices

__all__ = [
    "selection",
    "video",
    "windows",
    "DinoLossDataset",
    "read_csv_entries",
    "PrefetchLoader",
    "shard_indices",
]
