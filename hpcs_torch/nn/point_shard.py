"""Where the single-device modules learn that a call runs point-sharded.

`current()` is None on the single-device path (always, unless a caller
sets it) and, inside `use(shard)`, the PointShard of
hpcs_torch.parallel.point_parallel that the call is sharded on.
HypHCSystem reads it for the rotations and the loss's whole batch,
VN-DGCNN's forward for its EdgeConv stages, the mean and max over the
points and the dropout masks, and the flax-rule BatchNorm for its batch
moments (`shard.moments(x, axes)`, all that a BatchNorm asks of it).
"""
import contextlib
import contextvars

_CURRENT = contextvars.ContextVar("point_shard", default=None)


def current():
    """The shard the running call is on, or None (unsharded)."""
    return _CURRENT.get()


@contextlib.contextmanager
def use(shard):
    """Run the block on `shard` (None: unsharded), then restore."""
    token = _CURRENT.set(shard)
    try:
        yield
    finally:
        _CURRENT.reset(token)
