"""PyTorch + CUDA port of hpcs_tpu for NVIDIA Hopper GPUs.

Imports torch and numpy only, never jax or hpcs_tpu.  Entry points put their
tensors on the GPU unless the caller asks for the CPU (`device="cpu"`, or
`--accelerator cpu` on the command line); the hand-written CUDA kernels in
`hpcs_torch/ops/csrc/` are built at first use.  The command-line entry
points are `python -m hpcs_torch.train` and `python -m hpcs_torch.infer`
(with --profile, --debug_nans and --plot_inference: utils.profiling and
utils.viz), and `python -m hpcs_torch.check_invariance`.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
