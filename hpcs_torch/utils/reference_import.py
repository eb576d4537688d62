"""Read the reference's (Lightning) checkpoints into the port.

The reference trains a Lightning module and saves `model.ckpt`: its
`state_dict` and, from `save_hyperparameters()`, every constructor
argument in `hyper_parameters`, the backbone module object among them.
The port names its parameters as that module does (`models/base.py`), so
the weights load by name; what this module adds is reading the file
without the reference's classes installed, and the ModelConfig its
hyperparameters give.

`load_lightning_payload` unpickles (torch.load with weights_only=False):
it runs code named by the file, so use it on trusted files only.
"""
import io
import pickle
import types

import torch


class _StubBase:
    """Attribute- and item-preserving placeholder for a class that cannot be
    imported at unpickling time (the reference's hpcs.* modules, Lightning
    containers inside `hyper_parameters`).  Scalars, tensors and plain
    attributes survive; behaviour does not, and none is needed: the
    importer only reads attributes such as k, out_features or
    num_categories.
    """

    def __init__(self, *args, **kwargs):
        self._items = {}
        self._list = []

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        elif isinstance(state, tuple) and len(state) == 2 \
                and isinstance(state[0], (dict, type(None))):
            # the (dict state, slots state) form
            self.__dict__.update(state[0] or {})
            self.__dict__.update(state[1] or {})
        else:
            self.__dict__["_state"] = state

    # a pickled dict subclass replays its items through __setitem__
    def __setitem__(self, k, v):
        self.__dict__.setdefault("_items", {})[k] = v

    # a pickled list subclass replays through append / extend
    def append(self, v):
        self.__dict__.setdefault("_list", []).append(v)

    def extend(self, vs):
        self.__dict__.setdefault("_list", []).extend(vs)


def _stub_dict(obj):
    """A plain dict view of a dict, a stub or a namespace object."""
    if obj is None:
        return {}
    if isinstance(obj, dict):
        return dict(obj)
    d = dict(getattr(obj, "_items", None) or {})
    for k, v in vars(obj).items() if hasattr(obj, "__dict__") else ():
        if k not in ("_items", "_list", "_state"):
            d.setdefault(k, v)
    return d


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            return type(name, (_StubBase,), {"__module__": module})


# the pickle module torch.load is given: classes it cannot import become stubs
_STUB_PICKLE = types.ModuleType("hpcs_torch._stub_pickle")
_STUB_PICKLE.Unpickler = _Unpickler
_STUB_PICKLE.load = lambda f, **kw: _Unpickler(f, **kw).load()
_STUB_PICKLE.loads = lambda b, **kw: _Unpickler(io.BytesIO(b), **kw).load()


def load_lightning_payload(path):
    """Read a reference (Lightning) checkpoint, or a raw state_dict:
    ({name: tensor on the CPU}, the payload dict, {} for a raw state_dict).

    Classes that cannot be imported here, such as the reference's model
    classes pickled into `hyper_parameters`, come back as
    attribute-preserving stubs instead of raising ImportError.
    """
    payload = torch.load(path, map_location="cpu", pickle_module=_STUB_PICKLE,
                         weights_only=False)
    raw_sd = payload.get("state_dict", payload) if isinstance(payload, dict) else payload
    sd = {k: v.detach().cpu() for k, v in raw_sd.items() if hasattr(v, "detach")}
    return sd, payload if isinstance(payload, dict) else {}


_REF_MODEL_NAMES = {
    "VN_DGCNN_partseg": "vn_dgcnn_partseg",
    "DGCNN_partseg": "dgcnn_partseg",
    "POINTNET_partseg": "pointnet_partseg",
    "VN_POINTNET_partseg": "vn_pointnet_partseg",
}


def reference_hparams_to_config_kwargs(payload):
    """ModelConfig keyword arguments from a Lightning payload's
    `hyper_parameters`, as the reference's `load_from_checkpoint` would
    rebuild the model: the embedding sizes, the loss and training settings,
    PartNet (one dummy category) where hierarchy arguments are present, and
    the backbone's name and k, num_categories, dropout, pooling and
    out_features read off the pickled nn_feat object, stub or real.
    Returns only the keys that could be derived.
    """
    h = _stub_dict((payload or {}).get("hyper_parameters"))
    out = {}
    for src, dst in {"euclidean_size": "eucl_dim", "hyp_size": "hyp_dim"}.items():
        if isinstance(h.get(src), (int, float)):
            out[dst] = int(h[src])
    passthrough = (
        "lr", "margin", "t_per_anchor", "fraction", "temperature",
        "anneal_factor", "anneal_step", "num_class", "trade_off", "miner",
        "cosface", "train_rotation", "test_rotation", "class_vector",
        "hierarchical",
    )
    for k in passthrough:
        if isinstance(h.get(k), (bool, int, float, str)):
            out[k] = h[k]
    # the PartNet models are the ones built with hierarchy arguments; they
    # take a single dummy category
    if any(k in h for k in ("hierarchical", "hierarchy_list", "level")):
        out["dataset"] = "partnet"
        out["num_categories"] = 1
    feat = h.get("nn_feat")
    if feat is not None:
        name = _REF_MODEL_NAMES.get(type(feat).__name__)
        if name:
            out["model_name"] = name
        for src, dst in (("k", "k"), ("num_categories", "num_categories"),
                         ("dropout", "dropout"), ("pooling", "pooling"),
                         ("out_features", "eucl_dim")):
            v = getattr(feat, src, None)
            if isinstance(v, (bool, int, float, str)):
                out.setdefault(dst, v)
    return out


def load_lightning_state(net, sd, model_name="vn_dgcnn_partseg"):
    """Load a reference Lightning state_dict `sd` into the port's HypHCNet
    `net`, in place: every backbone tensor (each must be present), and the
    radius `scale`, the CosFace weights and the embedder's weight where
    `sd` holds them.  BatchNorm's num_batches_tracked is not a weight and
    is not taken.  Leaves it does not map keep their values.
    """
    if model_name != "vn_dgcnn_partseg":
        raise NotImplementedError(
            f"checkpoint import implemented for vn_dgcnn_partseg, got {model_name}")
    own = net.state_dict()
    backbone = [k for k in own if k.startswith("nn_feat.")
                and not k.endswith("num_batches_tracked")]
    missing = [k for k in backbone if k not in sd]
    if missing:
        raise KeyError(f"the checkpoint lacks backbone tensors: {missing[:5]}"
                       + (f" and {len(missing) - 5} more" if len(missing) > 5 else ""))
    keys = backbone + [k for k in ("scale", "metric_hyp_loss.loss_cosface.W",
                                   "nn_emb.mlp.0.0.weight") if k in sd and k in own]
    picked = {k: sd[k].reshape(own[k].shape) if k == "scale" else sd[k] for k in keys}
    result = net.load_state_dict(picked, strict=False)
    assert not result.unexpected_keys, result.unexpected_keys
    return keys
