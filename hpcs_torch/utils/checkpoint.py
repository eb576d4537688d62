"""Checkpoints of a HypHCSystem: a directory with two files.

- `model.ckpt`: `torch.save` of {"state": system.state_dict() (the net,
  the optimizer, the step), "epoch", "extra"}, tensors and plain
  containers only, so `torch.load(weights_only=True)` reads it;
- `config.json`: the ModelConfig as `dataclasses.asdict` gives it, the keys
  of the JAX package's config.json.

The JAX package's own `model.ckpt` is a flax msgpack file, which this
module does not read (ROADMAP A9).
"""
import dataclasses
import json
import os

import torch


def save_checkpoint(path, system, cfg, epoch=0, extra=None):
    """Write `system`'s state and `cfg` into the directory `path`.  `epoch`
    is the number of epochs trained, the epoch a resumed `fit` starts at."""
    os.makedirs(path, exist_ok=True)
    payload = {"state": system.state_dict(), "epoch": int(epoch), "extra": extra or {}}
    torch.save(payload, os.path.join(path, "model.ckpt"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2, default=str)


def load_config(path):
    """The config.json of the checkpoint directory `path`, as a dict (its
    hierarchy_list as nested lists)."""
    with open(os.path.join(path, "config.json")) as f:
        return json.load(f)


def restore_checkpoint(path, system):
    """Load the checkpoint at `path` (its directory or its model.ckpt) into
    `system`, onto the system's device.  Returns (epoch, extra)."""
    ckpt_file = path if os.path.isfile(path) else os.path.join(path, "model.ckpt")
    payload = torch.load(ckpt_file, map_location=system.device, weights_only=True)
    system.load_state_dict(payload["state"])
    return payload["epoch"], payload["extra"]
