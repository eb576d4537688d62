"""PartNet semantic-segmentation reader (h5), as the JAX package's.

`filelist` is a `{split}_files.txt` naming h5 files beside it, each with
the keys data [B, P, 3], data_num [B] and label_seg [B, P], read by the
port's own HDF5 reader (`hpcs_torch.utils.hdf5`, no h5py).
"""
import os

import numpy as np

from ..utils import hdf5
from .transforms import pc_normalize, resample


class PartNetDataset:
    """Every object of the split in memory.  Item i is (points [npoints, 3]
    float32, seg [npoints] int64): the cloud normalized to the unit sphere
    and resampled with replacement from np.random.default_rng((0, i))."""

    def __init__(self, filelist, npoints):
        points, point_nums, labels_seg = [], [], []
        folder = os.path.dirname(filelist)
        with open(filelist) as f:
            for line in f:
                with hdf5.File(os.path.join(folder, line.strip()), "r") as data:
                    points.append(data["data"][...].astype(np.float32))
                    point_nums.append(data["data_num"][...].astype(np.int32))
                    labels_seg.append(data["label_seg"][...].astype(np.int64))
        self.points = np.concatenate(points, axis=0)
        self.data_num = np.concatenate(point_nums, axis=0)
        self.label_seg = np.concatenate(labels_seg, axis=0)
        self.npoints = npoints
        self._seed = 0

    def __len__(self):
        return self.points.shape[0]

    def __getitem__(self, index):
        points = self.points[index]
        points = np.concatenate([pc_normalize(points[:, 0:3]), points[:, 3:]], axis=1)
        rng = np.random.default_rng((self._seed, index))
        points, label_seg = resample(rng, points, self.label_seg[index], self.npoints)
        return points.astype(np.float32), label_seg
