from .hierarchy import get_hierarchy_list
from .loader import DataLoader
from .partnet import PartNetDataset
from .shapenet import SEG_CLASSES, ShapeNetDataset
from .synthetic import SyntheticPartDataset
from .transforms import pc_normalize, resample, to_categorical

__all__ = [
    "DataLoader",
    "PartNetDataset",
    "SEG_CLASSES",
    "ShapeNetDataset",
    "SyntheticPartDataset",
    "get_hierarchy_list",
    "pc_normalize",
    "resample",
    "to_categorical",
]
