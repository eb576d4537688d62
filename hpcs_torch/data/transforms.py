"""Host-side point-cloud transforms (numpy), as the JAX package's.

The ShapeNet reader normalizes a copy of each cloud once and caches it
(`shapenet.py`), so no cloud is normalized twice.
"""
import numpy as np


def pc_normalize(pc):
    """Center to the centroid, scale to the unit max-radius sphere."""
    pc = np.asarray(pc, np.float32)
    pc = pc - pc.mean(axis=0)
    m = np.max(np.sqrt((pc ** 2).sum(axis=1)))
    return pc / max(m, 1e-12)


def resample(rng: np.random.Generator, points, labels, npoints):
    """Random resample with replacement to a fixed point count."""
    choice = rng.integers(0, len(labels), size=npoints)
    return points[choice], labels[choice]


def to_categorical(y, num_classes):
    """One-hot rows [..., num_classes] (float32) of the integer labels y."""
    return np.eye(num_classes, dtype=np.float32)[np.asarray(y, np.int64)]
