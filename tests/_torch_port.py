"""Shared helpers of the port's tests (tests/test_torch_*.py).

Inputs and weights are made with numpy from a seed and handed to both the
JAX package (the reference) and the port.
"""
import numpy as np
import pytest
import torch


def require_cuda():
    """Skip the calling test unless an NVIDIA GPU is present."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def rand_bn(rng, c):
    """Non-trivial BatchNorm parameters and running statistics."""
    return dict(scale=(1.0 + 0.2 * rng.standard_normal(c)).astype(np.float32),
                bias=(0.2 * rng.standard_normal(c)).astype(np.float32),
                mean=(0.3 * rng.standard_normal(c)).astype(np.float32),
                var=(0.5 + rng.uniform(size=c)).astype(np.float32))


def rand_vn_llr(rng, cin, cout, share=False):
    """Weights of one VNLinearLeakyReLU as (flax params, flax batch_stats,
    port state_dict)."""
    W = (rng.standard_normal((cout, cin)) / np.sqrt(cin)).astype(np.float32)
    Wd = (rng.standard_normal((1 if share else cout, cin)) / np.sqrt(cin)).astype(np.float32)
    bn = rand_bn(rng, cout)
    params = {"linear": {"kernel": W.T}, "dir_kernel": Wd.T,
              "batchnorm": {"bn": {"scale": bn["scale"], "bias": bn["bias"]}}}
    stats = {"batchnorm": {"bn": {"mean": bn["mean"], "var": bn["var"]}}}
    sd = {"map_to_feat.weight": W, "map_to_dir.weight": Wd,
          "batchnorm.bn.weight": bn["scale"], "batchnorm.bn.bias": bn["bias"],
          "batchnorm.bn.running_mean": bn["mean"], "batchnorm.bn.running_var": bn["var"],
          "batchnorm.bn.num_batches_tracked": np.array(0)}
    return params, stats, {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}


def randomize_batch_stats(tree, rng):
    """A copy of a flax batch_stats tree with random means and variances."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = randomize_batch_stats(v, rng)
        elif k == "mean":
            out[k] = (0.3 * rng.standard_normal(np.shape(v))).astype(np.float32)
        else:
            out[k] = (0.5 + rng.uniform(size=np.shape(v))).astype(np.float32)
    return out


def to_numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def tie_cloud(rng, b, n, d):
    """Clouds whose points each appear twice, so every point has an exact tie."""
    half = rng.standard_normal((b, n // 2, d)).astype(np.float32)
    return np.concatenate([half, half], axis=1)


def lattice_cloud(rng, b, n):
    """Points on a small integer lattice: many distinct neighbours at exactly
    equal distances, with scores exact in fp32."""
    return rng.integers(-3, 4, size=(b, n, 3)).astype(np.float32)
