"""Point-axis parallelism for long clouds over torch.distributed: the
counterpart of hpcs_tpu/parallel/point_parallel.py.

The JAX package shards the point axis with GSPMD annotations and lets XLA
insert the collectives, so its sharded step is the unsharded step.  Here
the sharding is written by hand, with the same semantics, on a 2-D
("data", "points") DeviceMesh: rank (d, p) holds clouds [d B/D, (d+1) B/D)
and, of each, points [p N/P, (p+1) N/P).  Parameters are replicated.

- The three kNN graphs: each rank all-gathers the stage's features over
  its "points" group and runs `knn` (kernel B1 on the card) on the gathered
  cloud, then keeps its own rows: exact, equal to knn_plain's graph.
- The edges: in training the plain autograd stage runs for the local query
  rows against the gathered table (the gather carries the neighbours'
  gradients back to their ranks); in eval kernel B2 runs on the gathered
  table, and its whole output is the next stage's table.
- The mean and the max over the points (after conv6; the global feature)
  are global over the "points" group: a sum all-reduce, and the gathered
  local maxima's max.
- The BatchNorm statistics in training cover every point of the whole
  batch: global sums of x and x^2 (flax's E[x^2] - E[x]^2 kept); conv7's,
  over the clouds' labels, cover every cloud once (the "data" group).
- The draws: every rank draws the rotations and the dropout masks for the
  whole batch from one generator that is the same on all ranks, then keeps
  its own rows; the masks equal the unsharded step's.
- The loss: the miner and the losses run on the all-gathered embeddings
  and labels, the same on every rank, so every rank draws the same global
  triplet set.  The gather's backward sums the W ranks' identical copies of
  the loss's gradient, so each rank's parameter gradient is W times its
  share; their mean all-reduce is the unsharded gradient.

This is not the data-parallel step (data_parallel.py), whose batch
statistics and triplets are shard-local.  Only VN-DGCNN with mean pooling
in fp32 is sharded (what the JAX package's tests and __graft_entry__.py
run); other backbones, max pooling and bf16 raise NotImplementedError
(ROADMAP A11b): GSPMD gives them to the JAX package for free, here each
needs its own sharding by hand.  B1 and B2 run on the whole gathered cloud
on every rank of a points group; a launch on this rank's rows only is
later kernel work (ROADMAP A11b).
"""
import torch
from torch.distributed.device_mesh import init_device_mesh

from ..nn import point_shard
from ..nn.backbones.vn_dgcnn import VNDGCNNPartSeg, knn_graph, stage_weights
from ..nn.vn.layers import mean_pool
from ..ops.edgeconv import edgeconv_infer, graph_feature_vn
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
    by clouds only."""
    D, P, d, p = _sizes(mesh)
    B, N = batch["points"].shape[:2]
    if B % D or N % P:
        raise ValueError(f"batch {B} x {N} points does not split over a ({D}, {P}) mesh")
    b, n = B // D, N // P
    rows, cols = slice(d * b, (d + 1) * b), slice(p * n, (p + 1) * n)
    return {k: v[rows, cols] if k in ("points", "labels") else v[rows] for k, v in batch.items()}


def _check_backbone(system):
    net = system.net.nn_feat
    if not isinstance(net, VNDGCNNPartSeg):
        raise NotImplementedError(f"point sharding of {type(net).__name__}: ROADMAP A11b "
                                  "(VN-DGCNN with mean pooling in fp32 only)")
    if net.pooling != "mean":
        raise NotImplementedError("point sharding with max pooling: ROADMAP A11b")
    if net.compute_dtype not in (None, torch.float32):
        raise NotImplementedError("point sharding in bf16: ROADMAP A11b")
    if system.cfg.class_vector:
        raise NotImplementedError("point sharding with class_vector (its part-presence vector "
                                  "needs every rank's labels): ROADMAP A11b")


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

    def rows(self, x):
        """This rank's rows of x [B, N, ...] (the whole cloud's points)."""
        n = x.shape[1] // self.P
        return x[:, self.p * n:(self.p + 1) * n]

    def gather_points(self, x):
        """x [B, n, ...] of every rank of the points group: [B, P n, ...]."""
        return C.all_gather(x, 1, self.points_group)

    def edge_stages(self, net, x):
        """VN-DGCNN's three EdgeConv stages on this rank's rows x [B, n, 1, 3]
        of the points: (x1, x2, x3), this rank's rows of each."""
        stages = ((net.conv1, net.conv2), (net.conv3, net.conv4), (net.conv5,))
        table, outs = self.gather_points(x), []
        for i, convs in enumerate(stages):
            idx = knn_graph(table, net.k)  # B1 on the gathered cloud
            if net.training:
                e, _ = graph_feature_vn(x, net.k, self.rows(idx), table=table)
                for conv in convs:
                    e = conv(e)
                x = mean_pool(e)
                if i < len(stages) - 1:
                    table = self.gather_points(x)
            else:
                table = edgeconv_infer(table, idx, *stage_weights(*convs), n_convs=len(convs))
                x = self.rows(table)
            outs.append(x)
        return outs

    def mean_over_points(self, x):
        """The mean of x [B, n, ...] over every rank's points."""
        return C.all_reduce_sum(x.sum(dim=1), self.points_group) / (x.shape[1] * self.P)

    def max_over_points(self, x):
        """The max of x [B, n, F] over every rank's points: [B, F]."""
        return C.all_max(x, 1, self.points_group)

    def objects(self):
        """The shard of per-cloud inputs (conv7 on the labels, which every
        rank of a points group holds alike), for their BatchNorm: moments
        over the "data" group, each cloud once; None (a rank's own rows, as
        unsharded) when D = 1."""
        return None if self.data_group is None else _Moments(self.data_group, self.D)

    def dropout(self, x, p, generator):
        """vn_dgcnn.dropout on this rank's window x [b, C, n] of the head's
        [B, C, N]: the mask is drawn for the whole tensor, then sliced."""
        if p == 0.0:
            return x
        keep = 1.0 - p
        b, c, n = x.shape
        mask = torch.rand((b * self.D, c, n * self.P), generator=generator,
                          device=generator.device) < keep
        mask = mask[self.d * b:(self.d + 1) * b, :, self.p * n:(self.p + 1) * n]
        return torch.where(mask.to(x.device), x / keep, 0.0)

    def augment(self, generator, points, mode):
        """utils.rotations.augment on this rank's points [b, n, 3]: the
        rotations drawn for the whole batch, this rank's clouds' applied."""
        b = points.shape[0]
        R = random_rotation(generator, b * self.D, mode)
        return points if R is None else rotate_cloud(points, R[self.d * b:(self.d + 1) * b])

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


def make_point_sharded_forward(system, mesh):
    """forward(points, decode_vector) -> (x_e, x_p): the eval forward with
    the point axis sharded over `mesh`'s "points" axis (and the clouds over
    "data" when present).  points is this rank's [B/D, N/P, 3]
    (`shard_points_batch`), decode_vector its clouds' [B/D, ...]; the
    embeddings come back as this rank's rows.  The parameters are the
    system's, on every rank alike (`data_parallel.replicate`)."""
    _check_backbone(system)
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
    _check_backbone(system)
    shard = PointShard(mesh)

    def step(batch, generator):
        with point_shard.use(shard):
            logs = system.grads_and_logs(batch, generator)
        return reduce_and_apply(system, logs)

    return step
