"""Procedural multi-part point clouds (numpy only).

Objects are built from labelled geometric primitives, so the forward can be
driven at realistic sizes with no dataset on disk.  The arrays equal those
of the JAX package's generator for the same seed.
"""
import numpy as np

from .transforms import pc_normalize


def _primitive(rng, kind, n):
    if kind == 0:  # sphere surface
        v = rng.normal(size=(n, 3))
        return v / np.linalg.norm(v, axis=1, keepdims=True)
    if kind == 1:  # cylinder side
        theta = rng.uniform(0, 2 * np.pi, n)
        z = rng.uniform(-1, 1, n)
        return np.stack([np.cos(theta), np.sin(theta), z], 1)
    if kind == 2:  # plane patch
        xy = rng.uniform(-1, 1, (n, 2))
        return np.concatenate([xy, np.zeros((n, 1))], 1)
    t = rng.uniform(-1, 1, (n, 1))  # line segment
    return np.concatenate([t, np.zeros((n, 2))], 1)


class SyntheticPartDataset:
    """Objects assembled from `parts_per_object` labelled primitives.

    Item i is (points [npoints, 3] float32, category, seg [npoints]); labels
    are global part ids category * parts_per_object + part.
    """

    def __init__(self, num_objects=64, npoints=512, num_categories=4,
                 parts_per_object=3, seed=0, jitter=0.02):
        self.num_objects = num_objects
        self.npoints = npoints
        self.num_categories = num_categories
        self.parts_per_object = parts_per_object
        self.num_class = num_categories * parts_per_object
        self.seed = seed
        self.jitter = jitter

    def __len__(self):
        return self.num_objects

    def __getitem__(self, index):
        rng = np.random.default_rng(self.seed * 100003 + index)
        category = index % self.num_categories
        per = self.npoints // self.parts_per_object
        pts, seg = [], []
        for p in range(self.parts_per_object):
            n = per if p < self.parts_per_object - 1 else self.npoints - per * (
                self.parts_per_object - 1)
            kind = (category + p) % 4
            prim = _primitive(rng, kind, n) * rng.uniform(0.3, 0.6)
            offset = np.zeros(3)
            offset[p % 3] = 1.2 * (p - (self.parts_per_object - 1) / 2)
            pts.append(prim + offset)
            seg.append(np.full(n, category * self.parts_per_object + p, np.int64))
        points = pc_normalize(np.concatenate(pts).astype(np.float32))
        points = points + rng.normal(scale=self.jitter, size=points.shape).astype(np.float32)
        return points, np.int64(category), np.concatenate(seg)

    def batch(self, start, size):
        """Items start .. start+size-1 stacked: (points [size, npoints, 3],
        category [size], seg [size, npoints])."""
        items = [self[i] for i in range(start, start + size)]
        return tuple(np.stack(a) for a in zip(*items))
