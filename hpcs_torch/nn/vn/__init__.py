from .layers import (
    BatchNorm,
    VNBatchNorm,
    VNLeakyReLU,
    VNLinear,
    VNLinearLeakyReLU,
    VNMaxPool,
    VNStdFeature,
    dense_block,
    invariant_project,
    mean_pool,
    vn_leaky_relu,
)

__all__ = ["BatchNorm", "VNBatchNorm", "VNLeakyReLU", "VNLinear", "VNLinearLeakyReLU",
           "VNMaxPool", "VNStdFeature", "dense_block", "invariant_project", "mean_pool",
           "vn_leaky_relu"]
