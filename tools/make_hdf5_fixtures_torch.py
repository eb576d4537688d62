#!/usr/bin/env python
"""Write the small HDF5 fixtures that hold hpcs_torch.utils.hdf5 to the
structures h5py writes with libver="latest":

- partnet_growable.h5: a PartNet-shaped sem_seg_h5 file (data [n, 256, 3]
  float32, data_num [n] int32, label_seg [n, 256] int64), every dataset
  growable along n (maxshape None: the extensible array chunk index) and
  appended object by object; label_seg deflated and shuffled.  Its
  partnet_files.txt names it, as a PartNet split's file list does;
- dense_group.h5: a root group of DENSE_ROOT datasets and a group
  `objects` of DENSE_OBJECTS, both past h5py's 8 compact links (dense link
  storage: a fractal heap and a v2 B-tree of names), and a dataset of two
  unlimited dimensions (the v2 B-tree chunk index).

Every array comes from np.random.default_rng(SEED) through `partnet_arrays`
and `dense_arrays`, which need no h5py: a reader's check recomputes them
(tests/test_torch_hdf5_latest.py, chip_smoke.py's partnet phase).  h5py is
imported only by `write`.

    python tools/make_hdf5_fixtures_torch.py [out dir]   # default tests/fixtures/hdf5_latest
"""
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(ROOT, "tests", "fixtures", "hdf5_latest")
SEED = 0
PARTNET_OBJECTS, PARTNET_POINTS, PARTNET_CLASSES = 24, 256, 9
DENSE_ROOT, DENSE_OBJECTS = 12, 40
PARTNET_FILE, PARTNET_LIST = "partnet_growable.h5", "partnet_files.txt"
DENSE_FILE = "dense_group.h5"


def partnet_arrays(seed=SEED):
    """{"data", "data_num", "label_seg"} of the PartNet-shaped fixture."""
    rng = np.random.default_rng(seed)
    n = PARTNET_OBJECTS
    return {"data": rng.standard_normal((n, PARTNET_POINTS, 3)).astype(np.float32),
            "data_num": np.full(n, PARTNET_POINTS, np.int32),
            "label_seg": rng.integers(0, PARTNET_CLASSES, (n, PARTNET_POINTS)).astype(np.int64)}


def dense_arrays(seed=SEED):
    """{path in the file: array} of the dense-storage fixture."""
    rng = np.random.default_rng(seed + 1)
    out = {}
    for i in range(DENSE_ROOT):
        x = rng.standard_normal(i + 1)
        out[f"root_{i:02d}"] = (x.astype("<f4"), (100 * x).astype("<i2"),
                                (50 * np.abs(x)).astype("u1"), x.astype(">f8"))[i % 4]
    out.update({f"objects/o{i:03d}": rng.integers(-50, 50, (i % 6 + 1, 3)).astype("<i4")
                for i in range(DENSE_OBJECTS)})
    out["objects/grown"] = rng.standard_normal((7, 5)).astype("<f4")
    return out


def write(out=DEFAULT_OUT):
    """Write both fixtures and the file list under `out` with h5py."""
    import h5py

    os.makedirs(out, exist_ok=True)
    arrays = partnet_arrays()
    with h5py.File(os.path.join(out, PARTNET_FILE), "w", libver="latest") as f:
        filters = {"label_seg": dict(compression="gzip", shuffle=True)}
        sets = {k: f.create_dataset(k, shape=(0, *v.shape[1:]), maxshape=(None, *v.shape[1:]),
                                    dtype=v.dtype, chunks=(1, *v.shape[1:]), **filters.get(k, {}))
                for k, v in arrays.items()}
        for i in range(PARTNET_OBJECTS):  # appended as a growing file is
            for k, ds in sets.items():
                ds.resize(i + 1, axis=0)
                ds[i] = arrays[k][i]
    with open(os.path.join(out, PARTNET_LIST), "w") as f:
        f.write(PARTNET_FILE + "\n")
    with h5py.File(os.path.join(out, DENSE_FILE), "w", libver="latest") as f:
        for path, a in dense_arrays().items():
            if path == "objects/grown":
                f.create_dataset(path, data=a, maxshape=(None, None), chunks=(2, 2))
            else:
                f.create_dataset(path, data=a)
    return out


if __name__ == "__main__":
    target = write(sys.argv[1] if len(sys.argv) > 1 else DEFAULT_OUT)
    sizes = {n: os.path.getsize(os.path.join(target, n)) for n in sorted(os.listdir(target))}
    print(f"wrote {target}: {sizes} ({sum(sizes.values())} bytes)")
