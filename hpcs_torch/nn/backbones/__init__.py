from .vn_dgcnn import VNDGCNNPartSeg

__all__ = ["VNDGCNNPartSeg"]
