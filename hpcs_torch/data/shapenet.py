"""ShapeNet-Part reader, as the JAX package's.

The layout under `root`: `synsetoffset2category.txt` ("<Name> <synset>"
lines; a category's id is its line's position), the split lists
`train_test_split/shuffled_{train,val,test}_file_list.json` (entries
"shape_data/<synset>/<token>") and the clouds `<synset>/<token>.txt`, rows
"x y z nx ny nz seg".  50 part classes over 16 categories.
"""
import json
import os
import os.path as osp

import numpy as np

from .fast_txt import loadtxt
from .transforms import pc_normalize, resample

SEG_CLASSES = {
    "Earphone": [16, 17, 18], "Motorbike": [30, 31, 32, 33, 34, 35],
    "Rocket": [41, 42, 43], "Car": [8, 9, 10, 11], "Laptop": [28, 29],
    "Cap": [6, 7], "Skateboard": [44, 45, 46], "Mug": [36, 37],
    "Guitar": [19, 20, 21], "Bag": [4, 5], "Lamp": [24, 25, 26, 27],
    "Table": [47, 48, 49], "Airplane": [0, 1, 2, 3], "Pistol": [38, 39, 40],
    "Chair": [12, 13, 14, 15], "Knife": [22, 23],
}


class ShapeNetDataset:
    """Item i is (points [npoints, 3 or 6] float32, category id, seg
    [npoints] int64): the cloud normalized to the unit sphere (the normals
    kept as they are with `normal_channel`) and resampled with replacement
    to `npoints` (all points when npoints <= 0).

    The resample draws from np.random.default_rng((0, i)), a generator of
    the item's own, so items are the same in any order and from any thread.
    The normalized clouds of the first `cache_size` items read are cached.
    """

    seg_classes = SEG_CLASSES

    def __init__(self, root, npoints=2500, split="train", class_choice=None,
                 normal_channel=False, cache_size=20000):
        self.root = root
        self.npoints = npoints
        self.normal_channel = normal_channel
        self.cat = {}
        with open(osp.join(root, "synsetoffset2category.txt")) as f:
            for line in f:
                name, synset = line.strip().split()
                self.cat[name] = synset
        self.classes_original = dict(zip(self.cat, range(len(self.cat))))
        if class_choice is not None:
            self.cat = {k: v for k, v in self.cat.items() if k == class_choice}

        splits = {}
        for s in ("train", "val", "test"):
            with open(osp.join(root, "train_test_split", f"shuffled_{s}_file_list.json")) as f:
                splits[s] = set(str(d.split("/")[2]) for d in json.load(f))
        wanted = splits["train"] | splits["val"] if split == "trainval" else splits[split]

        self.datapath = []
        for item, synset in self.cat.items():
            dir_point = osp.join(root, synset)
            if not osp.isdir(dir_point):
                continue
            for fn in sorted(os.listdir(dir_point)):
                if osp.splitext(fn)[0] in wanted:
                    self.datapath.append((item, osp.join(dir_point, fn)))

        self.classes = {c: self.classes_original[c] for c in self.cat}
        self.cache = {}
        self.cache_size = cache_size
        self._seed = 0

    def __len__(self):
        return len(self.datapath)

    def __getitem__(self, index):
        if index in self.cache:
            point_set, cls, seg = self.cache[index]
        else:
            cat, path = self.datapath[index]
            cls = np.int64(self.classes[cat])
            data = loadtxt(path, n_cols=7)
            point_set = data[:, 0:6] if self.normal_channel else data[:, 0:3]
            seg = data[:, -1].astype(np.int64)
            point_set = np.concatenate([pc_normalize(point_set[:, 0:3]), point_set[:, 3:]],
                                       axis=1)
            if len(self.cache) < self.cache_size:
                self.cache[index] = (point_set, cls, seg)
        if self.npoints > 0:
            rng = np.random.default_rng((self._seed, index))
            point_set, seg = resample(rng, point_set, seg, self.npoints)
        return point_set, cls, seg
