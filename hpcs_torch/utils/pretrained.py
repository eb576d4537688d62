"""Graft a pretrained VN-DGCNN backbone onto the port's model (--pretrained).

The reference's weight surgery: load a raw backbone checkpoint, copy every
module whose tensors it holds in full into the model's VN-DGCNN backbone
(load_state_dict with strict=False, module by module), and keep the
model's own conv11 when the checkpoint's head has another width (the head
swap).  The port's backbone carries the reference's key names, so a
checkpoint's tensors go in under their own names.
"""
import torch

VN_CONVS = ("conv1", "conv2", "conv3", "conv4", "conv5", "conv6")
_VN_LLR = ("map_to_feat.weight", "map_to_dir.weight", "batchnorm.bn.weight",
           "batchnorm.bn.bias", "batchnorm.bn.running_mean", "batchnorm.bn.running_var")
_HEAD = ("0.weight", "1.weight", "1.bias", "1.running_mean", "1.running_var")


def load_raw_backbone_state_dict(path):
    """The tensors of a raw backbone checkpoint, {name: tensor} on the CPU,
    in either format the reference reads:

    - `model.partseg.vn_dgcnn.aligned.t7`: a state_dict saved from
      DataParallel training, its keys prefixed `module.`;
    - `best_model.pth`: a dict whose `model_state_dict` (or `state_dict`)
      is the state_dict.

    `module.` is removed from every key.  The file is read with
    torch.load(weights_only=True): tensors and plain containers only.
    """
    payload = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("model_state_dict", "state_dict"):
        if isinstance(payload, dict) and key in payload:
            payload = payload[key]
    return {k.replace("module.", ""): v for k, v in payload.items() if torch.is_tensor(v)}


def _modules(sd, prefix, names, keys, present):
    """The keys of each module in `names` whose `present` key is in sd; the
    module's other tensors must be there too (KeyError otherwise)."""
    out = {}
    for name in names:
        if f"{prefix}{name}.{present}" in sd:
            for key in keys:
                full = f"{prefix}{name}.{key}"
                if full not in sd:
                    raise KeyError(full)
                out[full] = sd[full]
    return out


def convert_vn_dgcnn_partial(sd, prefix=""):
    """The tensors of a VN-DGCNN state_dict that a graft copies, by key:
    each VNLinearLeakyReLU (conv1..conv6, std_feature.vn1 / vn2) whose
    map_to_feat is present, std_feature.vn_lin, and each head block
    (conv7..conv11) whose Conv1d and BatchNorm weights are present; their
    num_batches_tracked stay the model's.  `prefix` is stripped from the
    keys it is given with."""
    out = _modules(sd, prefix, VN_CONVS + ("std_feature.vn1", "std_feature.vn2"), _VN_LLR,
                   "map_to_feat.weight")
    if f"{prefix}std_feature.vn_lin.weight" in sd:
        out[f"{prefix}std_feature.vn_lin.weight"] = sd[f"{prefix}std_feature.vn_lin.weight"]
    heads = [f"conv{i}" for i in range(7, 12) if f"{prefix}conv{i}.1.weight" in sd]
    out.update(_modules(sd, prefix, heads, _HEAD, "0.weight"))
    return {k[len(prefix):]: v for k, v in out.items()}


@torch.no_grad()
def graft_pretrained_backbone(backbone, sd, out_features):
    """Copy the tensors of the raw VN-DGCNN state_dict `sd` that
    convert_vn_dgcnn_partial selects into `backbone` (a VNDGCNNPartSeg),
    in place, onto its device.  When the checkpoint's conv11 is not
    `out_features` wide, conv11 keeps the backbone's own tensors (the head
    swap).  Raises ValueError on a shape mismatch, before copying anything.
    Returns whether the head was swapped."""
    from ..nn.backbones import VNDGCNNPartSeg

    if not isinstance(backbone, VNDGCNNPartSeg):
        raise ValueError(f"the pretrained backbone is VN-DGCNN's; the model's is "
                         f"{type(backbone).__name__}")
    new = convert_vn_dgcnn_partial(sd)
    head = sd.get("conv11.0.weight")
    swap_head = head is not None and head.shape[0] != out_features
    if swap_head:
        new = {k: v for k, v in new.items() if not k.startswith("conv11.")}
    own = backbone.state_dict()
    for k, v in new.items():
        if k in own and tuple(own[k].shape) != tuple(v.shape):
            raise ValueError(f"pretrained tensor {k} has shape {tuple(v.shape)}, model "
                             f"expects {tuple(own[k].shape)}")
    backbone.load_state_dict(new, strict=False)
    return swap_head
