from .lca import euc_reflection, gyro_midpoint, hyp_lca, hyp_lca_mat, hyp_lca_midpoint
from .math_ops import arcosh, arsinh, artanh, l2_normalize, tanh
from .poincare import (
    BALL_EPS_F32,
    MIN_NORM,
    egrad2rgrad,
    expmap,
    expmap0,
    get_midpoint_o,
    gyration,
    hyp_dist_o,
    hyp_distance,
    hyp_distance_mat,
    inner,
    lambda_,
    logmap0,
    mobius_add,
    mobius_mul,
    project,
    ptransp,
)

__all__ = ["arcosh", "arsinh", "artanh", "l2_normalize", "tanh", "BALL_EPS_F32", "MIN_NORM",
           "egrad2rgrad", "expmap", "expmap0", "get_midpoint_o", "gyration", "hyp_dist_o",
           "hyp_distance", "hyp_distance_mat", "inner", "lambda_", "logmap0", "mobius_add",
           "mobius_mul", "project", "ptransp", "euc_reflection", "gyro_midpoint", "hyp_lca",
           "hyp_lca_mat", "hyp_lca_midpoint"]
