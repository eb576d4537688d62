"""Where the single-device modules learn that a call runs point-sharded.

`current()` is None on the single-device path (always, unless a caller
sets it) and, inside `use(shard)`, the PointShard of
hpcs_torch.parallel.point_parallel that the call is sharded on.
HypHCSystem reads it for the rotations, the decode vector and the loss's
whole batch; the backbones for their kNN graphs (`vn_dgcnn.neighbours`),
their means and maxima over the points, their dropout masks and their
per-cloud blocks (`per_cloud`); and the flax-rule BatchNorm for its batch
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


def per_cloud():
    """A block whose BatchNorms see per-cloud tensors ([B, C]: after a pool
    over the points, or the clouds' labels), which every rank of a points
    group holds alike: their moments then come from the shard's
    `objects()`.  Unsharded, a block like any other."""
    shard = current()
    return contextlib.nullcontext() if shard is None else use(shard.objects())


def max_over_points(x):
    """The max of x [B, N, F] over the points, [B, F]: over every rank's
    points in a point-sharded call."""
    shard = current()
    return x.amax(dim=1) if shard is None else shard.max_over_points(x)
