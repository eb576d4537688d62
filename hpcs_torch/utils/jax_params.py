"""Carry the JAX package's HypHCNet state into the port.

`from_jax_params` takes the `params` and `batch_stats` trees as nested dicts
of numpy arrays (no JAX needed) and returns a state_dict for
`hpcs_torch.models.base.HypHCNet`.  Dense kernels are [in, out] and become
[out, in] weights; BatchNorm scale/bias/mean/var become
weight/bias/running_mean/running_var.  `from_jax_opt_state` does the same
for the packed Riemannian Adam moments, and `from_jax_hyperparams` reads
the learning rate.  Each takes the trees as the JAX package holds them or
in their state-dict form (string keys throughout, as a flax checkpoint
restores them: `utils.flax_msgpack`).
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
    return _v(w).T.contiguous()


def _v(a):
    if torch.is_tensor(a):  # a bfloat16 leaf of a flax checkpoint
        return a.float()
    return torch.tensor(np.asarray(a, np.float32))


def _bn_params(prefix, p):
    return {f"{prefix}.weight": _v(p["scale"]), f"{prefix}.bias": _v(p["bias"])}


def _bn_stats(prefix, s):
    return {f"{prefix}.running_mean": _v(s["mean"]), f"{prefix}.running_var": _v(s["var"]),
            f"{prefix}.num_batches_tracked": torch.tensor(0)}


# the auto-named modules of an STNkd in the JAX tree and their port names
_RENAMED = {**{f"_ConvBNRelu_{i}": f"blocks.{i}" for i in range(5)}, "Dense_0": "transform"}


def _backbone_sd(bb, stats):
    """A backbone's parameters (stats False) or BatchNorm running statistics
    (stats True) by port name, without `nn_feat.`, from its JAX subtree.

    The tree's modules are told apart by their leaves: VNLinearLeakyReLU
    {linear, dir_kernel, batchnorm}; a Dense -> BatchNorm block {Dense_0,
    BatchNorm_0} (`dense_block`; VN-DGCNN's head is Conv1d, its weights
    [out, in, 1]); VNBatchNorm {bn}; BatchNorm {scale, bias} or {mean, var};
    VNMaxPool {dir_kernel}; VNStdFeature's frame_kernel; and {kernel[,
    bias]}, a VNLinear in VN-PointNet (fc3, conv5), else a Dense.
    """
    conv1d_head = "std_feature" in bb and "conv_pos" not in bb
    vn_linear = {"fc3", "conv5"} if "conv_pos" in bb else set()
    sd = {}

    def bn(prefix, node):
        sd.update(_bn_stats(prefix, node) if stats else _bn_params(prefix, node))

    def walk(node, path):
        prefix = ".".join(path)
        if "batchnorm" in node:
            bn(f"{prefix}.batchnorm.bn", node["batchnorm"]["bn"])
            if not stats:
                sd[f"{prefix}.map_to_feat.weight"] = _t(node["linear"]["kernel"])
                sd[f"{prefix}.map_to_dir.weight"] = _t(node["dir_kernel"])
        elif "BatchNorm_0" in node:
            bn(f"{prefix}.1", node["BatchNorm_0"])
            if not stats:
                sd.update(_dense(f"{prefix}.0", node["Dense_0"]))
                if conv1d_head:
                    sd[f"{prefix}.0.weight"] = sd[f"{prefix}.0.weight"][..., None]
        elif "bn" in node:
            bn(f"{prefix}.bn", node["bn"])
        elif "scale" in node or "mean" in node:
            bn(prefix, node)
        elif "dir_kernel" in node:
            sd[f"{prefix}.map_to_dir.weight"] = _t(node["dir_kernel"])
        elif "kernel" in node:
            sd.update(_dense(f"{prefix}.map_to_feat" if path[-1] in vn_linear else prefix, node))
        else:
            for name, child in node.items():
                if name == "frame_kernel":
                    sd[f"{prefix}.vn_lin.weight"] = _t(child)
                else:
                    walk(child, path + [_RENAMED.get(name, name)])

    walk(bb, [])
    return sd


def _dense(prefix, p):
    """A flax Dense {kernel[, bias]} as a Linear's weight and bias."""
    sd = {f"{prefix}.weight": _t(p["kernel"])}
    if "bias" in p:
        sd[f"{prefix}.bias"] = _v(p["bias"])
    return sd


def _params_sd(params):
    """The port's parameters (no buffers) from a flax params tree."""
    sd = {f"nn_feat.{k}": v for k, v in _backbone_sd(params["backbone"], False).items()}
    if "Dense_0" in params.get("embedder", {}):
        sd["nn_emb.mlp.0.0.weight"] = _t(params["embedder"]["Dense_0"]["kernel"])
    sd["scale"] = _v(params["scale"]).reshape(1)
    sd["metric_hyp_loss.loss_cosface.W"] = _v(params["cosface_W"])
    return sd


def from_jax_params(params, batch_stats):
    """state_dict of the port's HypHCNet from the JAX package's trees, for
    any of the four backbones."""
    sd = _params_sd(params)
    sd.update({f"nn_feat.{k}": v for k, v in _backbone_sd(batch_stats["backbone"], True).items()})
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

    packed = {int(db): v for db, v in packed.items()}  # "128" in the state-dict form
    return walk(params)


def from_jax_opt_state(opt_state, params):
    """The port's Riemannian Adam state, by parameter name, from the JAX
    package's packed optimizer state.

    opt_state: `riemannian_adam_fused`'s state (count, exp_avg, exp_avg_sq,
    the moments packed {D: [R, D]}), or the `inject_hyperparams` state
    around it, as numpy, or either in its state-dict form (dicts, bucket
    keys "128"); params: the flax params tree it belongs to.
    Returns {name: {"step", "exp_avg", "exp_avg_sq"}} in the port's layout,
    the ball axis moved as `from_jax_params` moves it; exp_avg_sq, equal
    along the ball axis, keeps one entry there.
    """
    inner = _field(opt_state, "inner_state", opt_state)
    m = _params_sd(_unpack(_field(inner, "exp_avg"), params))
    v = _params_sd(_unpack(_field(inner, "exp_avg_sq"), params))
    count = int(np.asarray(_field(inner, "count")))
    return {name: {"step": count, "exp_avg": m[name],
                   "exp_avg_sq": v[name].narrow(ball_dim(name, v[name]), 0, 1).clone()}
            for name in m}


def _field(state, name, default=None):
    """Field `name` of an optax state (a NamedTuple) or of its state-dict
    form (a dict); `default` where it has none."""
    if isinstance(state, dict):
        return state.get(name, default)
    return getattr(state, name, default)


def from_jax_hyperparams(opt_state):
    """The learning rate that the JAX package's `inject_hyperparams` state
    holds (the plateau-reduced one, which `set_learning_rate` writes), as
    the port's param-group lr.

    Raises ValueError where the state's b1, b2, eps or weight_decay differ
    from the port's Riemannian Adam (`optim.radam.BETAS`, `EPS`, no weight
    decay): the port would train differently.
    """
    from ..optim.radam import BETAS, EPS

    hp = _field(opt_state, "hyperparams")
    if hp is None:
        raise ValueError("the optimizer state holds no hyperparams (inject_hyperparams)")
    want = {"b1": BETAS[0], "b2": BETAS[1], "eps": EPS, "weight_decay": 0.0}
    for name, value in want.items():
        got = np.float32(np.asarray(hp.get(name, value)))
        if got != np.float32(value):
            raise ValueError(f"optimizer hyperparameter {name} = {got}; the port's Riemannian "
                             f"Adam runs with {name} = {value}")
    return float(np.float32(np.asarray(hp["learning_rate"])))
