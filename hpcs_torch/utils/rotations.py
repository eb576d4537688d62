"""Random rotations of point clouds (the test and train augmentation).

Rotations are drawn from an explicit torch.Generator, on the generator's
device, and applied on the clouds' device.
"""
import math

import torch


def random_so3(generator, batch):
    """Uniform random rotation matrices [batch, 3, 3] (Shoemake quaternions)."""
    q = torch.randn((batch, 4), generator=generator, device=generator.device)
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def random_z(generator, batch):
    """Random yaw rotations [batch, 3, 3]."""
    a = torch.rand((batch,), generator=generator, device=generator.device) * 2 * math.pi
    c, s = torch.cos(a), torch.sin(a)
    z, o = torch.zeros_like(a), torch.ones_like(a)
    return torch.stack([torch.stack([c, -s, z], -1), torch.stack([s, c, z], -1),
                        torch.stack([z, z, o], -1)], dim=-2)


def rotate_cloud(points, R):
    """points [B, N, 3] x R [B, 3, 3] -> points @ R^T, in full fp32.

    Written as three products and two adds per coordinate, so no TF32 or
    other reduced-precision matmul can enter: a rotation applied at lower
    precision is a different cloud, and about 12 % of its kNN rows change
    neighbours.
    """
    R = R.to(points.device, points.dtype)
    p = points[..., None, :] * R[:, None, :, :]  # [B, N, 3 (out), 3 (in)]
    return p[..., 0] + p[..., 1] + p[..., 2]


def random_rotation(generator, batch, mode):
    """The rotations [batch, 3, 3] of mode 'so3' or 'z'; None for 'none'."""
    if mode == "so3":
        return random_so3(generator, batch)
    if mode == "z":
        return random_z(generator, batch)
    if mode == "none":
        return None
    raise ValueError(f"unknown rotation mode {mode!r}")


def augment(generator, points, mode):
    """mode in {'so3', 'z', 'none'} (the train/test rotation flags)."""
    R = random_rotation(generator, points.shape[0], mode)
    return points if R is None else rotate_cloud(points, R)
