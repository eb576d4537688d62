"""Carry the JAX package's HypHCNet state into the port.

`from_jax_params` takes the `params` and `batch_stats` trees as nested dicts
of numpy arrays (no JAX needed) and returns a state_dict for
`hpcs_torch.models.base.HypHCNet`.  Dense kernels are [in, out] and become
[out, in] weights; BatchNorm scale/bias/mean/var become
weight/bias/running_mean/running_var.  `from_jax_opt_state` does the same
for the packed Riemannian Adam moments.
"""
import numpy as np
import torch


def ball_dim(name, p):
    """The axis of a port parameter whose vectors are points of the ball for
    Riemannian Adam: the flax leaf's last axis.  The weights [out, in, ...]
    are flax kernels [in, out] transposed here, so theirs is dim 0; vectors
    (BatchNorm weight and bias, `scale`) and the CosFace weights, [hyp, L]
    in both packages, keep the last."""
    return 0 if p.dim() >= 2 and not name.endswith("loss_cosface.W") else -1


def _t(w):
    return torch.tensor(np.asarray(w, np.float32).T)


def _v(a):
    return torch.tensor(np.asarray(a, np.float32))


def _bn_params(prefix, p):
    return {f"{prefix}.weight": _v(p["scale"]), f"{prefix}.bias": _v(p["bias"])}


def _bn_stats(prefix, s):
    return {f"{prefix}.running_mean": _v(s["mean"]), f"{prefix}.running_var": _v(s["var"]),
            f"{prefix}.num_batches_tracked": torch.tensor(0)}


def _vn_prefixes(tree):
    """(port prefix, the tree's VNLinearLeakyReLU subtree) pairs."""
    bb, sf = tree["backbone"], tree["backbone"]["std_feature"]
    return ([(f"nn_feat.{n}", bb[n]) for n in ("conv1", "conv2", "conv3", "conv4", "conv5",
                                                "conv6")]
            + [(f"nn_feat.std_feature.{n}", sf[n]) for n in ("vn1", "vn2")])


def _params_sd(params):
    """The port's parameters (no buffers) from a flax params tree."""
    sd = {}
    for prefix, p in _vn_prefixes(params):
        sd[f"{prefix}.map_to_feat.weight"] = _t(p["linear"]["kernel"])
        sd[f"{prefix}.map_to_dir.weight"] = _t(p["dir_kernel"])
        sd.update(_bn_params(f"{prefix}.batchnorm.bn", p["batchnorm"]["bn"]))
    bp = params["backbone"]
    sd["nn_feat.std_feature.vn_lin.weight"] = _t(bp["std_feature"]["frame_kernel"])
    for i in range(7, 12):
        sd[f"nn_feat.conv{i}.0.weight"] = _t(bp[f"conv{i}"]["Dense_0"]["kernel"])[..., None]
        sd.update(_bn_params(f"nn_feat.conv{i}.1", bp[f"conv{i}"]["BatchNorm_0"]))
    if "Dense_0" in params.get("embedder", {}):
        sd["nn_emb.mlp.0.0.weight"] = _t(params["embedder"]["Dense_0"]["kernel"])
    sd["scale"] = _v(params["scale"]).reshape(1)
    sd["metric_hyp_loss.loss_cosface.W"] = _v(params["cosface_W"])
    return sd


def from_jax_params(params, batch_stats):
    """state_dict of the port's HypHCNet from the JAX package's trees."""
    sd = _params_sd(params)
    for prefix, s in _vn_prefixes(batch_stats):
        sd.update(_bn_stats(f"{prefix}.batchnorm.bn", s["batchnorm"]["bn"]))
    for i in range(7, 12):
        sd.update(_bn_stats(f"nn_feat.conv{i}.1",
                            batch_stats["backbone"][f"conv{i}"]["BatchNorm_0"]))
    return sd


def _lane_round(d, lane=128):
    return max(lane, ((d + lane - 1) // lane) * lane)


def _unpack(packed, params):
    """The packed buckets {D: [R, D]} as a tree shaped like `params`.

    The JAX package packs the leaves in tree-flatten order (dict keys
    sorted), each leaf as rows [prod(shape[:-1]), d] zero-padded to
    _lane_round(d) columns, stacked in its bucket in that order.
    """
    offsets = {}

    def walk(tree):
        out = {}
        for key in sorted(tree):
            x = tree[key]
            if isinstance(x, dict):
                out[key] = walk(x)
                continue
            shape = np.shape(x) or (1,)
            d, rows = shape[-1], int(np.prod(shape[:-1], dtype=np.int64))
            db = _lane_round(d)
            off = offsets.get(db, 0)
            out[key] = np.asarray(packed[db])[off:off + rows, :d].reshape(np.shape(x))
            offsets[db] = off + rows
        return out

    return walk(params)


def from_jax_opt_state(opt_state, params):
    """The port's Riemannian Adam state, by parameter name, from the JAX
    package's packed optimizer state.

    opt_state: `riemannian_adam_fused`'s state (count, exp_avg, exp_avg_sq,
    the moments packed {D: [R, D]}), or the `inject_hyperparams` state
    around it, as numpy; params: the flax params tree it belongs to.
    Returns {name: {"step", "exp_avg", "exp_avg_sq"}} in the port's layout,
    the ball axis moved as `from_jax_params` moves it; exp_avg_sq, equal
    along the ball axis, keeps one entry there.
    """
    inner = getattr(opt_state, "inner_state", opt_state)
    m = _params_sd(_unpack(inner.exp_avg, params))
    v = _params_sd(_unpack(inner.exp_avg_sq, params))
    count = int(np.asarray(inner.count))
    return {name: {"step": count, "exp_avg": m[name],
                   "exp_avg_sq": v[name].narrow(ball_dim(name, v[name]), 0, 1).clone()}
            for name in m}
