"""Checkpoints of a HypHCSystem: a directory with two files.

- `model.ckpt`: `torch.save` of {"state": system.state_dict() (the net,
  the optimizer, the step), "epoch", "extra"}, tensors and plain
  containers only, so `torch.load(weights_only=True)` reads it;
- `config.json`: the ModelConfig as `dataclasses.asdict` gives it, the keys
  of the JAX package's config.json.

`restore_checkpoint` also reads the JAX package's two formats:

- its single-file checkpoint: the same two files, its `model.ckpt` the
  flax msgpack of {"state": TrainState, "epoch", "extra"}.  The first
  bytes tell the two apart: a `torch.save` file is a zip (b"PK"), a flax
  file a msgpack map (0x80-0x8f, 0xde or 0xdf);
- its multi-process checkpoint: a directory with `orbax/` (the TrainState
  as orbax writes it, `utils/orbax_dir.py`, read through libzstd with no
  orbax or tensorstore), `meta.json` ({"epoch", "extra"}) and
  `config.json`.
"""
import dataclasses
import json
import os

import torch

from . import flax_msgpack
from .jax_params import from_jax_hyperparams, from_jax_opt_state, from_jax_params
from .orbax_dir import read_orbax_state


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


def checkpoint_format(path):
    """"orbax" for the JAX package's directory with orbax/; for a file (or
    a directory's model.ckpt) "torch" for a `torch.save` file, "flax" for
    the JAX package's msgpack file; raises ValueError for anything else."""
    if os.path.isdir(os.path.join(path, "orbax")):
        return "orbax"
    ckpt_file = os.path.join(path, "model.ckpt") if os.path.isdir(path) else path
    with open(ckpt_file, "rb") as f:
        head = f.read(2)
    if head == b"PK":
        return "torch"
    if head and (0x80 <= head[0] <= 0x8f or head[0] in (0xde, 0xdf)):
        return "flax"
    raise ValueError(f"{ckpt_file} is neither a torch.save zip nor a flax msgpack checkpoint")


def restore_checkpoint(path, system):
    """Load the checkpoint at `path` (its directory or its model.ckpt) into
    `system`, onto the system's device.  Returns (epoch, extra): `epoch` is
    the number of epochs trained, where a resumed `fit` starts.

    A JAX-package checkpoint gives the net's parameters and BatchNorm
    statistics, the Riemannian Adam moments and step count, the learning
    rate its optimizer state holds (the plateau-reduced one) and the step.
    The JAX package stores the index of the epoch it had finished, and its
    own resume trains that epoch again; here the port's rule holds, so such
    a checkpoint resumes at its epoch + 1, in either of its formats.  An
    orbax directory without meta.json stored epoch 0 and no extra, as the
    JAX package reads it, so it resumes at 1.
    """
    fmt = checkpoint_format(path)
    if fmt == "orbax":
        load_jax_state(system, read_orbax_state(os.path.join(path, "orbax")))
        meta = {"epoch": 0, "extra": {}}
        meta_path = os.path.join(path, "meta.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
        return int(meta["epoch"]) + 1, meta.get("extra") or {}
    ckpt_file = path if os.path.isfile(path) else os.path.join(path, "model.ckpt")
    if fmt == "flax":
        payload = flax_msgpack.read(ckpt_file)
        load_jax_state(system, payload["state"])
        return int(payload["epoch"]) + 1, payload.get("extra") or {}
    payload = torch.load(ckpt_file, map_location=system.device, weights_only=True)
    system.load_state_dict(payload["state"])
    return payload["epoch"], payload["extra"]


def load_jax_state(system, state):
    """Load the JAX package's TrainState, in its state-dict form (nested
    dicts of numpy arrays: params, batch_stats, opt_state, step), into
    `system`."""
    params = state["params"]
    system.net.load_state_dict(from_jax_params(params, state["batch_stats"]))
    moments = from_jax_opt_state(state["opt_state"], params)
    system.optimizer.state.clear()
    for name, p in system.net.named_parameters():
        system.optimizer.state[p] = {k: v.to(p.device) if torch.is_tensor(v) else v
                                     for k, v in moments[name].items()}
    system.set_learning_rate(from_jax_hyperparams(state["opt_state"]))
    system.step = int(state["step"])
