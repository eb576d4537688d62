"""Point-axis parallelism for long clouds over torch.distributed: the
counterpart of hpcs_tpu/parallel/point_parallel.py.

The JAX package shards the point axis with GSPMD annotations and lets XLA
insert the collectives, so its sharded step is the unsharded step.  Here
the sharding is written by hand, with the same semantics, on a 2-D
("data", "points") DeviceMesh: rank (d, p) holds clouds [d B/D, (d+1) B/D)
and, of each, points [p N/P, (p+1) N/P).  Parameters are replicated.
Every backbone is sharded, as in the JAX package: VN-DGCNN (mean or max
pooling, fp32 or bf16), DGCNN, PointNet and VN-PointNet (mean or max
pooling), with or without class_vector.

- The kNN graphs (vn_dgcnn.neighbours): each rank all-gathers the
  stage's features over its "points" group and runs `knn` (kernel B1 on
  the card) for its own rows of the gathered cloud only, ranked against
  every point, as each device of the JAX program scores its own [n, N]
  block: exact, equal to the unsharded graph's rows.
- The edges: the graph features of this rank's centres against the
  gathered table (`graph_feature_vn`, `_cross_vn`, `_scalar` with
  `table=`); in training the gather carries the neighbours' gradients
  back to their ranks.  VN-DGCNN's eval stages with mean pooling run
  kernel B2 for this rank's rows of the gathered table, whose output is
  gathered as the next stage's table (stage 3's is not: no graph reads
  it).  Pools over the K neighbours are local to each point.
- The means and maxima over the points are global over the "points"
  group: a sum all-reduce (in fp32 for bf16 features, as mean_pool sums),
  the gathered local maxima's max, and `max_pool_over_points`, VNMaxPool
  over every rank's points (the first point on a tie, the gradient to the
  rank that holds it).
- The BatchNorm statistics in training cover every point of the whole
  batch: global sums of x and x^2 (flax's E[x^2] - E[x]^2 kept).  Blocks
  on per-cloud tensors (after a pool over the points: the STNs' fully
  connected layers; the labels: conv7) run under
  hpcs_torch.nn.point_shard.per_cloud: every cloud once (the "data"
  group).
- The draws: every rank draws the rotations and the dropout masks for the
  whole batch from one generator that is the same on all ranks, then keeps
  its own rows; the masks equal the unsharded step's.
- class_vector: the part-presence vector is the whole cloud's, the max of
  the ranks' over the points group (`decode_vector`).
- The loss: the miner and the losses run on the all-gathered embeddings
  and labels, the same on every rank, so every rank draws the same global
  triplet set.  The gather's backward sums the W ranks' identical copies of
  the loss's gradient, so each rank's parameter gradient is W times its
  share; their mean all-reduce is the unsharded gradient.

bf16 features are gathered exactly (collectives upcast them to fp32 and
round back: a copy).  This is not the data-parallel step
(data_parallel.py), whose batch statistics and triplets are shard-local.
"""
import torch
from torch.distributed.device_mesh import init_device_mesh

from ..models.base import decode_vector_for_batch
from ..nn import point_shard
from ..nn.vn.layers import first_argmax
from ..ops.vn_math import upcast
from ..utils.rotations import random_rotation, rotate_cloud
from . import collectives as C
from .data_parallel import default_device_type, reduce_and_apply


def make_mesh_2d(n_data, n_points, device_type=None):
    """2-D ("data", "points") DeviceMesh over the n_data x n_points ranks of
    the process group (one process per device)."""
    if n_data * n_points != C.world_size():
        raise ValueError(f"a ({n_data}, {n_points}) mesh needs {n_data * n_points} processes; "
                         f"the process group has {C.world_size()}")
    return init_device_mesh(device_type or default_device_type(), (n_data, n_points),
                            mesh_dim_names=("data", "points"))


def _sizes(mesh):
    """(D, P, d, p): the mesh's data and points sizes and this rank's
    coordinates; a mesh without a "data" axis has D = 1."""
    names = mesh.mesh_dim_names
    coord = dict(zip(names, mesh.get_coordinate()))
    size = dict(zip(names, mesh.shape))
    return size.get("data", 1), size["points"], coord.get("data", 0), coord["points"]


def shard_points_batch(mesh, batch):
    """This rank's part of a batch dict: clouds [d B/D, (d+1) B/D) and, of
    each, points [p N/P, (p+1) N/P) of "points" and "labels"; "category"
    by clouds only.  A batch that does not split over the mesh raises."""
    D, P, d, p = _sizes(mesh)
    B, N = batch["points"].shape[:2]
    if B % D or N % P:
        raise ValueError(f"batch {B} x {N} points does not split over a ({D}, {P}) mesh")
    b, n = B // D, N // P
    rows, cols = slice(d * b, (d + 1) * b), slice(p * n, (p + 1) * n)
    return {k: v[rows, cols] if k in ("points", "labels") else v[rows] for k, v in batch.items()}


class _Moments:
    """Training BatchNorm moments over `group`'s ranks (None: the world),
    each holding `copies`-th of the rows."""

    def __init__(self, group, copies):
        self.group, self.copies = group, copies

    def moments(self, x, axes):
        """(E[x], E[x^2]) over `axes` of every rank's x: global sums."""
        count = x.numel() // x.shape[[d for d in range(x.dim()) if d not in axes][0]]
        sums = torch.stack([x.sum(dim=axes), (x * x).sum(dim=axes)])
        sums = C.all_reduce_sum(sums, self.group) / (count * self.copies)
        return sums[0], sums[1]


class PointShard(_Moments):
    """A point-sharded call's shard: hpcs_torch.nn.point_shard.current()
    while the call runs (see the module docstring).  Its `moments` are the
    training BatchNorms' over every rank's rows (the whole batch)."""

    def __init__(self, mesh):
        self.D, self.P, self.d, self.p = _sizes(mesh)
        if self.D * self.P != C.world_size() or self.d * self.P + self.p != C.rank():
            raise ValueError("the point-sharded mesh must span the process group, rank "
                             "d P + p at (d, p)")
        self.points_group = mesh.get_group("points")
        self.data_group = mesh.get_group("data") if self.D > 1 else None
        super().__init__(None, self.D * self.P)

    def row_range(self, n_points):
        """(r0, r1): this rank's rows of a gathered cloud of n_points."""
        n = n_points // self.P
        return self.p * n, (self.p + 1) * n

    def gather_points(self, x):
        """x [B, n, ...] of every rank of the points group: [B, P n, ...]."""
        return C.all_gather(x, 1, self.points_group)

    def mean_over_points(self, x):
        """The mean of x [B, n, ...] over every rank's points, summed in fp32
        for bf16 features and rounded back (mean_pool's rule)."""
        total = C.all_reduce_sum(upcast(x).sum(dim=1), self.points_group)
        return (total / (x.shape[1] * self.P)).to(x.dtype)

    def max_over_points(self, x):
        """The max of x [B, n, F] over every rank's points: [B, F]."""
        return C.all_max(x, 1, self.points_group)

    def max_pool_over_points(self, pool, x):
        """VNMaxPool `pool` over every rank's points of x [B, n, C, 3]: per
        channel the vector whose score is the largest of the whole cloud,
        the first point on a tie (first_argmax over the ranks' own winners,
        the ranks in point order), [B, C, 3].  Only the scores are gathered
        without gradient: the vector's gradient reaches the rank that holds
        it."""
        dot = pool.scores(x)  # [B, n, C]
        idx = first_argmax(dot, dim=1)  # [B, C]
        best = torch.gather(dot, 1, idx[:, None]).detach()  # [B, 1, C]
        vec = torch.gather(x, 1, idx[:, None, :, None].expand(-1, 1, -1, x.shape[-1]))
        win = first_argmax(C.gather_slots(best, 1, self.points_group), dim=1)  # [B, C]
        vecs = C.all_gather(vec, 1, self.points_group)  # [B, P, C, 3]
        return torch.gather(vecs, 1, win[:, None, :, None].expand(-1, 1, -1, x.shape[-1]))[:, 0]

    def objects(self):
        """The shard of per-cloud inputs (point_shard.per_cloud: after a pool
        over the points, or the clouds' labels, which every rank of a
        points group holds alike), for their BatchNorm: moments over the
        "data" group, each cloud once; None (a rank's own rows, as
        unsharded) when D = 1."""
        return None if self.data_group is None else _Moments(self.data_group, self.D)

    def dropout(self, x, p, generator, point_dim=2):
        """vn_dgcnn.dropout on this rank's window x of the whole [B, ..., N,
        ...] tensor (clouds on dim 0, points on `point_dim`): the mask is
        drawn for the whole tensor, then sliced."""
        if p == 0.0:
            return x
        keep = 1.0 - p
        whole = list(x.shape)
        b, n = whole[0], whole[point_dim]
        whole[0], whole[point_dim] = b * self.D, n * self.P
        mask = torch.rand(whole, generator=generator, device=generator.device) < keep
        mask = mask[self.d * b:(self.d + 1) * b].narrow(point_dim, self.p * n, n)
        return torch.where(mask.to(x.device), x / keep, 0.0)

    def augment(self, generator, points, mode):
        """utils.rotations.augment on this rank's points [b, n, 3]: the
        rotations drawn for the whole batch, this rank's clouds' applied."""
        b = points.shape[0]
        R = random_rotation(generator, b * self.D, mode)
        return points if R is None else rotate_cloud(points, R[self.d * b:(self.d + 1) * b])

    def decode_vector(self, cfg, batch, device):
        """decode_vector_for_batch of this rank's part of a batch, on
        `device`: with class_vector the part-presence vector of each whole
        cloud (the max of every rank's over the points group), else the
        clouds' own."""
        dv = torch.as_tensor(decode_vector_for_batch(cfg, batch), dtype=torch.float32,
                             device=device)
        if not cfg.class_vector:
            return dv
        return C.gather_slots(dv[:, None], 1, self.points_group).amax(dim=1)

    def whole_batch(self, x, labels):
        """Every rank's embeddings x [b, n, F] (with gradient) and labels
        [b, n], reassembled into the whole batch's [B, N, F] and [B, N]."""
        b, n = labels.shape

        def assemble(t):
            t = t.reshape(self.D, self.P, b, n, -1).transpose(1, 2)
            return t.reshape(self.D * b, self.P * n, -1)

        x = assemble(C.all_gather(x, 0))
        labels = assemble(C.gather_slots(labels, 0))[..., 0]
        return x, labels


def decode_vector(mesh, cfg, part, device=None):
    """The decode vector of this rank's part of a batch (`shard_points_batch`)
    for the point-sharded forward, on `device` (None: the mesh's device
    type): with class_vector each cloud's part-presence vector over every
    rank's points (hpcs_tpu's callers pass the whole batch's), else
    decode_vector_for_batch of the part."""
    return PointShard(mesh).decode_vector(cfg, part, device or mesh.device_type)


def make_point_sharded_forward(system, mesh):
    """forward(points, decode_vector) -> (x_e, x_p): the eval forward with
    the point axis sharded over `mesh`'s "points" axis (and the clouds over
    "data" when present).  points is this rank's [B/D, N/P, 3]
    (`shard_points_batch`), decode_vector its clouds' [B/D, ...] (the
    whole clouds' with class_vector: `decode_vector`); the embeddings come
    back as this rank's rows.  The parameters are the system's, on every
    rank alike (`data_parallel.replicate`)."""
    shard = PointShard(mesh)

    @torch.no_grad()
    def forward(points, decode_vector):
        with point_shard.use(shard):
            return system.embed(points, decode_vector)

    return forward


def make_point_sharded_train_step(system, mesh):
    """train_step(batch, generator) -> logs: the whole training step (the
    forward, the miner and the joint loss, the backward, Riemannian Adam)
    with the point axis sharded.  batch is this rank's part
    (`shard_points_batch`); `generator` must be the same on every rank (the
    same seed): the rotations, the dropout masks and the triplets are the
    whole batch's, drawn alike on every rank.  The step is the unsharded
    step up to the order of its sums.  The logs are the whole batch's."""
    shard = PointShard(mesh)

    def step(batch, generator):
        with point_shard.use(shard):
            logs = system.grads_and_logs(batch, generator)
        return reduce_and_apply(system, logs)

    return step
