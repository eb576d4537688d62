from .layers import (
    VNBatchNorm,
    VNLinear,
    VNLinearLeakyReLU,
    VNStdFeature,
    invariant_project,
    mean_pool,
    vn_leaky_relu,
)

__all__ = ["VNBatchNorm", "VNLinear", "VNLinearLeakyReLU", "VNStdFeature",
           "invariant_project", "mean_pool", "vn_leaky_relu"]
