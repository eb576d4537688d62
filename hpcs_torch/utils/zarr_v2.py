"""zarr v2 arrays read from a key-value store (`utils/ocdbt.py`'s reader).

orbax stores each leaf of the JAX package's multi-process checkpoints as a
zarr v2 array under its name: `<name>/.zarray` is the array's JSON
metadata and `<name>/<i>.<j>...` its chunks, each a C-order block of
`chunks` elements (a 0-d array has the one chunk "0").  Chunks on the
edge of the grid are stored whole and cut to `shape` here.

Read: `dimension_separator` ".", `order` "C", no filters, the compressor
`zstd` or none, and the dtypes a JAX TrainState holds: <f4, <i4, <u4, <f8,
<i8 and bfloat16 (a torch.bfloat16 tensor, as `utils/flax_msgpack.py`
gives it: numpy lacks the type).  Anything else raises ValueError naming
it, and so does a missing chunk: orbax stores every chunk
(`store_array_data_equal_to_fill_value`).
"""
import itertools
import json
import math

import numpy as np
import torch

from . import zstd

DTYPES = {"<f4": np.float32, "<i4": np.int32, "<u4": np.uint32, "<f8": np.float64,
          "<i8": np.int64, "bfloat16": np.uint16}


def _decompressor(meta, name):
    comp = meta.get("compressor")
    if comp is None:
        return lambda raw: raw
    if comp.get("id") == "zstd":
        return zstd.decompress
    raise ValueError(f"{name}: zarr compressor {comp.get('id')!r} is not read "
                     "(only zstd or none)")


def read_array(store, name):
    """The zarr v2 array `name` of `store` (an object with `read(key)` and
    `in`) as a numpy array, or a torch.bfloat16 tensor for bfloat16."""
    meta = json.loads(store.read(f"{name}/.zarray"))
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{name}: zarr_format {meta.get('zarr_format')!r}, not 2")
    dtype_name = meta["dtype"]
    if not isinstance(dtype_name, str) or dtype_name not in DTYPES:
        raise ValueError(f"{name}: zarr dtype {dtype_name!r} is not read "
                         f"(only {', '.join(DTYPES)})")
    if meta.get("order", "C") != "C":
        raise ValueError(f"{name}: zarr order {meta['order']!r} is not read (only C)")
    if meta.get("filters"):
        raise ValueError(f"{name}: zarr filters {meta['filters']!r} are not read")
    sep = meta.get("dimension_separator", ".")
    if sep != ".":
        raise ValueError(f"{name}: zarr dimension_separator {sep!r} is not read (only '.')")
    decompress = _decompressor(meta, name)
    dtype = np.dtype(DTYPES[dtype_name])
    shape, chunks = list(meta["shape"]), list(meta["chunks"])
    if len(shape) != len(chunks):
        raise ValueError(f"{name}: shape {shape} and chunks {chunks} differ in rank")
    out = np.empty(shape, dtype)
    grid = [math.ceil(s / c) if c else 0 for s, c in zip(shape, chunks)]
    for index in itertools.product(*(range(g) for g in grid)):
        key = f"{name}/{'.'.join(map(str, index)) or '0'}"
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(index, chunks, shape))
        if key not in store:
            raise ValueError(f"{name}: chunk {key!r} is missing "
                             f"(fill_value {meta.get('fill_value')!r})")
        raw = decompress(store.read(key))
        count = math.prod(chunks)
        if len(raw) != count * dtype.itemsize:
            raise ValueError(f"{name}: chunk {key!r} holds {len(raw)} bytes, "
                             f"not {count} x {dtype.itemsize}")
        block = np.frombuffer(raw, dtype.newbyteorder("<")).reshape(chunks)
        out[region] = block[tuple(slice(0, r.stop - r.start) for r in region)]
    if dtype_name == "bfloat16":
        return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
    return out
