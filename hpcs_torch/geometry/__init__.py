from .math_ops import arcosh, arsinh, artanh, tanh
from .poincare import BALL_EPS_F32, MIN_NORM, expmap0, logmap0, project

__all__ = ["arcosh", "arsinh", "artanh", "tanh", "BALL_EPS_F32", "MIN_NORM",
           "expmap0", "logmap0", "project"]
