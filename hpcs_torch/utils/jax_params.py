"""Carry weights of the JAX package's HypHCNet into the port's HypHCNet.

`from_jax_params` takes the `params` and `batch_stats` trees as nested dicts
of numpy arrays (no JAX needed) and returns a state_dict for
`hpcs_torch.models.base.HypHCNet`.  Dense kernels are [in, out] and become
[out, in] weights; BatchNorm scale/bias/mean/var become
weight/bias/running_mean/running_var.
"""
import numpy as np
import torch


def _t(w):
    return torch.tensor(np.asarray(w, np.float32).T)


def _v(a):
    return torch.tensor(np.asarray(a, np.float32))


def _bn(prefix, p, s):
    return {f"{prefix}.weight": _v(p["scale"]), f"{prefix}.bias": _v(p["bias"]),
            f"{prefix}.running_mean": _v(s["mean"]), f"{prefix}.running_var": _v(s["var"]),
            f"{prefix}.num_batches_tracked": torch.tensor(0)}


def _vn_llr(prefix, p, s):
    return {f"{prefix}.map_to_feat.weight": _t(p["linear"]["kernel"]),
            f"{prefix}.map_to_dir.weight": _t(p["dir_kernel"]),
            **_bn(f"{prefix}.batchnorm.bn", p["batchnorm"]["bn"], s["batchnorm"]["bn"])}


def from_jax_params(params, batch_stats):
    """state_dict of the port's HypHCNet from the JAX package's trees."""
    bp, bs = params["backbone"], batch_stats["backbone"]
    sd = {}
    for name in ("conv1", "conv2", "conv3", "conv4", "conv5", "conv6"):
        sd.update(_vn_llr(f"nn_feat.{name}", bp[name], bs[name]))
    sp, ss = bp["std_feature"], bs["std_feature"]
    for name in ("vn1", "vn2"):
        sd.update(_vn_llr(f"nn_feat.std_feature.{name}", sp[name], ss[name]))
    sd["nn_feat.std_feature.vn_lin.weight"] = _t(sp["frame_kernel"])
    for i in range(7, 12):
        name = f"nn_feat.conv{i}"
        sd[f"{name}.0.weight"] = _t(bp[f"conv{i}"]["Dense_0"]["kernel"])[..., None]
        sd.update(_bn(f"{name}.1", bp[f"conv{i}"]["BatchNorm_0"], bs[f"conv{i}"]["BatchNorm_0"]))
    if "Dense_0" in params.get("embedder", {}):
        sd["nn_emb.mlp.0.0.weight"] = _t(params["embedder"]["Dense_0"]["kernel"])
    sd["scale"] = _v(params["scale"]).reshape(1)
    sd["metric_hyp_loss.loss_cosface.W"] = _v(params["cosface_W"])
    return sd
