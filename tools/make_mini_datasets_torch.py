#!/usr/bin/env python
"""Generate format-exact mini ShapeNet-Part and PartNet slices, with the
PyTorch port's own imports: the counterpart of tools/make_mini_datasets.py,
whose generators, draws and files it repeats, so both write the same trees.

- ShapeNet (read by hpcs_torch/data/shapenet.py):
    <root>/ShapeNet/raw/synsetoffset2category.txt      "<Name>\t<synset>"
    <root>/ShapeNet/raw/train_test_split/shuffled_{split}_file_list.json
        entries "shape_data/<synset>/<token>"
    <root>/ShapeNet/raw/<synset>/<token>.txt           rows "x y z nx ny nz seg"
  Airplane and Cap, 3 / 1 / 2 objects of ~2.6k points each per split, part
  labels from the global 50-class table (SEG_CLASSES).

- PartNet sem-seg h5 (read by hpcs_torch/data/partnet.py and
  data/hierarchy.py):
    <root>/PartNet/sem_seg_h5/<Cat>-<level>/{train,val,test}_files.txt
    <root>/PartNet/sem_seg_h5/<Cat>-<level>/<name>.h5   data [B, 10000, 3],
        data_num [B], label_seg [B, 10000]
    <root>/PartNet/after_merging_label_ids/<Cat>.txt           tree w/ 'leaf'
    <root>/PartNet/after_merging_label_ids/<Cat>-level-<L>.txt "NN name" lines
  Bottle, levels 1 and 3 (num_class 9 at level 3), the h5 files written by
  the port's own writer (hpcs_torch.utils.hdf5.write_h5, no h5py).

Geometry is synthetic but part-structured (each label a distinct gaussian
blob), so the decode's sweeps have real cluster structure to find.

Usage: python tools/make_mini_datasets_torch.py [root] [--datasets shapenet partnet]
(root defaults to data/ in the working directory).
"""
import argparse
import json
import os
import os.path as osp
import sys

import numpy as np

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

from hpcs_torch.data.shapenet import SEG_CLASSES  # noqa: E402
from hpcs_torch.utils.hdf5 import write_h5  # noqa: E402

SYNSETS = {  # real ShapeNet-Part synset offsets for the vendored categories
    "Airplane": "02691156",
    "Cap": "02954340",
    "Chair": "03001627",
}


def _part_blob(rng, n, center, axes):
    """Anisotropic gaussian blob: one labeled part."""
    return center + rng.standard_normal((n, 3)) * axes


def _object_cloud(rng, part_ids, total=2600):
    """Part-structured cloud: one primitive per part id, contiguous labels."""
    per = np.full(len(part_ids), total // len(part_ids))
    per[: total - per.sum()] += 1
    pts, seg = [], []
    for pid, n in zip(part_ids, per):
        center = rng.uniform(-0.6, 0.6, 3)
        axes = rng.uniform(0.05, 0.35, 3)
        pts.append(_part_blob(rng, n, center, axes))
        seg.append(np.full(n, pid, np.int64))
    return np.concatenate(pts), np.concatenate(seg)


def make_shapenet(root, categories=("Airplane", "Cap"), per_split=(3, 1, 2)):
    """Write the ShapeNet-Part tree under root/ShapeNet/raw; returns that
    directory."""
    raw = osp.join(root, "ShapeNet", "raw")
    os.makedirs(osp.join(raw, "train_test_split"), exist_ok=True)
    with open(osp.join(raw, "synsetoffset2category.txt"), "w") as f:
        for name in SYNSETS:
            f.write(f"{name}\t{SYNSETS[name]}\n")

    rng = np.random.default_rng(11)
    splits = {"train": [], "val": [], "test": []}
    for cat in categories:
        synset = SYNSETS[cat]
        d = osp.join(raw, synset)
        os.makedirs(d, exist_ok=True)
        idx = 0
        for split, count in zip(("train", "val", "test"), per_split):
            for _ in range(count):
                token = f"{cat.lower()}_{idx:04d}"
                pts, seg = _object_cloud(rng, SEG_CLASSES[cat])
                normals = rng.standard_normal(pts.shape)
                normals /= np.linalg.norm(normals, axis=1, keepdims=True)
                rows = np.concatenate([pts, normals, seg[:, None]], axis=1)
                np.savetxt(osp.join(d, f"{token}.txt"), rows, fmt="%.6f")
                splits[split].append(f"shape_data/{synset}/{token}")
                idx += 1
    for split, items in splits.items():
        with open(osp.join(raw, "train_test_split",
                           f"shuffled_{split}_file_list.json"), "w") as f:
            json.dump(items, f)
    print(f"ShapeNet mini: {sum(len(v) for v in splits.values())} objects "
          f"({', '.join(categories)}) under {raw}")
    return raw


BOTTLE_TREE = """\
1 bottle
2  body leaf
3  closure
4   lid leaf
5   cap leaf
6  handle leaf
7  neck leaf
8  mouth leaf
9  base leaf
10  label leaf
"""
# leaves = lines containing 'leaf' -> ids 2,4,5,6,7,8,9,10 (8 leaves)
BOTTLE_LEVELS = {
    1: ["02 bottle/body", "03 bottle/closure", "06 bottle/other"],
    3: ["02 bottle/body", "04 bottle/lid", "05 bottle/cap",
        "06 bottle/handle", "07 bottle/neck", "08 bottle/mouth",
        "09 bottle/base", "10 bottle/label"],
}


def partnet_arrays(n_points=10000, per_split=(4, 2, 2)):
    """(level, split, {"data", "data_num", "label_seg"}) of each h5 file
    make_partnet writes, in the order it draws them."""
    rng = np.random.default_rng(13)
    for lvl, lines in BOTTLE_LEVELS.items():
        num_class = len(lines) + 1  # reference: len(level file) + 1
        for split, count in zip(("train", "val", "test"), per_split):
            data = np.zeros((count, n_points, 3), np.float32)
            label = np.zeros((count, n_points), np.int64)
            for b in range(count):
                # labels 1..num_class-1 are semantic parts; 0 = unlabeled
                pts, seg = _object_cloud(rng, list(range(1, num_class)), total=n_points)
                data[b], label[b] = pts, seg
            yield lvl, split, {"data": data, "data_num": np.full(count, n_points, np.int32),
                               "label_seg": label}


def make_partnet(root, category="Bottle", n_points=10000, per_split=(4, 2, 2)):
    """Write the PartNet tree under root/PartNet; returns it."""
    hier = osp.join(root, "PartNet", "after_merging_label_ids")
    os.makedirs(hier, exist_ok=True)
    with open(osp.join(hier, f"{category}.txt"), "w") as f:
        f.write(BOTTLE_TREE)
    for lvl, lines in BOTTLE_LEVELS.items():
        with open(osp.join(hier, f"{category}-level-{lvl}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")

    for lvl, split, arrays in partnet_arrays(n_points, per_split):
        base = osp.join(root, "PartNet", "sem_seg_h5", f"{category}-{lvl}")
        os.makedirs(base, exist_ok=True)
        name = f"{split}-00.h5"
        write_h5(osp.join(base, name), arrays)
        with open(osp.join(base, f"{split}_files.txt"), "w") as f:
            f.write(name + "\n")
    out = osp.join(root, "PartNet")
    print(f"PartNet mini: {category} levels {sorted(BOTTLE_LEVELS)} "
          f"({sum(per_split)} objects/level, {n_points} pts) under {out}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", nargs="?", default="data", help="output root (default: data)")
    ap.add_argument("--datasets", nargs="+", choices=["shapenet", "partnet"],
                    default=["shapenet", "partnet"])
    args = ap.parse_args(argv)
    if "shapenet" in args.datasets:
        make_shapenet(args.root)
    if "partnet" in args.datasets:
        make_partnet(args.root)


if __name__ == "__main__":
    main()
