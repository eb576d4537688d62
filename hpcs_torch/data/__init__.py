from .synthetic import SyntheticPartDataset, pc_normalize

__all__ = ["SyntheticPartDataset", "pc_normalize"]
