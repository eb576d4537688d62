from .layers import (
    BatchNorm,
    VNBatchNorm,
    VNLinear,
    VNLinearLeakyReLU,
    VNStdFeature,
    invariant_project,
    mean_pool,
    vn_leaky_relu,
)

__all__ = ["BatchNorm", "VNBatchNorm", "VNLinear", "VNLinearLeakyReLU", "VNStdFeature",
           "invariant_project", "mean_pool", "vn_leaky_relu"]
