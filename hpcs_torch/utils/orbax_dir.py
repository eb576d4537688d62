"""The JAX package's orbax checkpoint directory, read without orbax.

When it runs in more than one process the JAX package saves its TrainState
with orbax's StandardCheckpointer into `<checkpoint>/orbax/`:

- `_METADATA`: JSON whose `tree_metadata` maps each leaf to its key path
  (`key_metadata`: key_type 2 a dict key or attribute, 1 a sequence
  index) and its `value_metadata` (`value_type`; `skip_deserialize` for
  the empty containers orbax keeps as placeholders);
- the arrays, in an OCDBT database (`utils/ocdbt.py`) rooted in the same
  directory: a zarr v2 array (`utils/zarr_v2.py`) per leaf, named by its
  key path joined with ".".  Each process writes its chunks into its own
  `ocdbt.process_<i>/`, and the root manifest's tree reaches them all.

`read_orbax_state(orbax_dir)` rebuilds the tree in the form that
`utils/flax_msgpack.read(...)["state"]` gives for the same TrainState:
nested dicts with string keys (a sequence index as its decimal string),
numpy leaves, {} for an empty container and None for None, so
`utils.checkpoint.load_jax_state` takes either.
"""
import json
import os

from .ocdbt import OcdbtReader
from .zarr_v2 import read_array

_ARRAYS = ("jax.Array", "np.ndarray")
_EMPTY = {"Dict": dict, "List": dict, "Tuple": dict, "NamedTuple": dict, "None": lambda: None}
_SEQUENCE, _DICT = 1, 2


def _leaf_path(meta, where):
    path = []
    for entry in meta["key_metadata"]:
        if entry["key_type"] not in (_SEQUENCE, _DICT):
            raise ValueError(f"{where}: key type {entry['key_type']} of {entry['key']!r} "
                             "is not read (1 a sequence index, 2 a dict key)")
        path.append(str(entry["key"]))
    return path


def read_orbax_state(orbax_dir):
    """The tree saved in `orbax_dir` (a checkpoint's orbax/ directory), as
    nested dicts of numpy arrays."""
    where = os.path.join(orbax_dir, "_METADATA")
    with open(where) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt", False) or meta.get("use_zarr3", False):
        raise ValueError(f"{where}: use_ocdbt {meta.get('use_ocdbt')}, use_zarr3 "
                         f"{meta.get('use_zarr3')}: only OCDBT with zarr v2 is read")
    store = OcdbtReader(orbax_dir)
    state = {}
    for leaf in meta["tree_metadata"].values():
        path = _leaf_path(leaf, where)
        value = leaf["value_metadata"]
        kind = value["value_type"]
        if value.get("skip_deserialize"):
            if kind not in _EMPTY:
                raise ValueError(f"{where}: {'.'.join(path)} is a {kind!r} placeholder")
            x = _EMPTY[kind]()
        elif kind in _ARRAYS:
            x = read_array(store, ".".join(path))
        else:
            raise ValueError(f"{where}: {'.'.join(path)} has value type {kind!r}, not read")
        node = state
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = x
    return state
