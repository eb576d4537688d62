"""Data-parallel training and the sharded test_step over torch.distributed:
the counterpart of hpcs_tpu/parallel/data_parallel.py.

One process per device.  The parameters are replicated: every rank holds
the whole HypHCSystem, takes its own rows of each batch (as P("data")
places them, `shard_batch`), and after the backward the gradients, the
logs and the BatchNorm running statistics take a mean all-reduce, so that
every rank applies the same update (the JAX package's pmean set).

The semantics are the JAX package's shard_map step, not a synchronised
one: the forward normalises with each shard's own batch statistics (no
SyncBatchNorm), and the triplet pools are shard-local (triplets never
cross ranks).  All-reducing the running statistics after the forward gives
0.9 old + 0.1 mean(shard statistics), what pmean(new_bs) gives.  Each rank
draws from its own torch.Generator (`shard_seed`), in place of
fold_in(key, axis_index); rank 0's stream at world size 1 is exactly the
single-device step's.

The point-sharded step (point_parallel.py) is another thing: its batch
statistics and triplets cover the whole batch.
"""
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.utils._pytree import tree_leaves

from ..utils.profiling import spanned
from . import collectives as C

SEED_STRIDE = 1 << 32  # shard r's generator seed: seed + r * SEED_STRIDE


def default_device_type():
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_mesh(n_devices=None, axis="data", device_type=None):
    """A 1-D DeviceMesh ("data",) over the process group's ranks (JAX's
    Mesh of n devices).  n_devices, when given, must be the world size: one
    process per device."""
    n = n_devices or C.world_size()
    if n != C.world_size():
        raise ValueError(f"a {n}-device mesh needs {n} processes, one per device; the process "
                         f"group has {C.world_size()}")
    return init_device_mesh(device_type or default_device_type(), (n,), mesh_dim_names=(axis,))


def mesh_shard(mesh):
    """(this rank's shard index, the number of shards) of a mesh whose every
    axis shards the batch: its coordinate flattened row-major, as P(axes)
    places the rows (dcn * n_local + data on a hybrid mesh)."""
    index = 0
    for coord, size in zip(mesh.get_coordinate(), mesh.shape):
        index = index * size + coord
    return index, mesh.size()


def shard_seed(seed, shard):
    """The seed of shard `shard`'s generator; shard 0's is `seed`."""
    return seed + shard * SEED_STRIDE


def shard_batch(mesh, batch):
    """This rank's rows of a batch dict: rows [r B/P, (r+1) B/P) of each
    entry, r its shard index on `mesh`, as P("data") places them.  The
    batch size must be a multiple of the mesh's size."""
    r, n = mesh_shard(mesh)
    B = len(batch["points"])
    if B % n:
        raise ValueError(f"batch {B} is not divisible by the {n}-device mesh")
    b = B // n
    return {k: v[r * b:(r + 1) * b] for k, v in batch.items()}


def replicate(mesh, tree):
    """Rank 0's values of a pytree of tensors (a state_dict, say) on every
    rank of `mesh`, in place: a broadcast.  Returns the tree."""
    C.broadcast_([t for t in tree_leaves(tree) if torch.is_tensor(t)], src=0,
                 group=mesh.get_group() if mesh.ndim == 1 else None)
    return tree


def all_reduce_step(system, logs, group=None):
    """The data-parallel step between the backward and the update: the mean
    all-reduce over `group` of every gradient (a missing one as zeros, which
    the optimizer takes as none), of the logs (a dict of scalar tensors) and
    of the BatchNorm running statistics.  Returns the reduced logs."""
    params = list(system.net.parameters())
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    stats = [b for b in system.net.buffers() if b.is_floating_point()]
    keys = sorted(logs)
    values = torch.stack([torch.as_tensor(logs[k], dtype=stats[0].dtype,
                                          device=stats[0].device).reshape(()) for k in keys])
    C.mean_all_reduce_([p.grad for p in params] + stats + [values], group)
    return dict(zip(keys, values.unbind(0)))


def reduce_and_apply(system, logs, group=None):
    """`all_reduce_step`, then the update.  Returns the reduced logs."""
    logs = all_reduce_step(system, logs, group)
    system.apply_gradients()
    return logs


class DataParallelTrainStep:
    """step(batch, generator) -> logs: one data-parallel training step of
    `system` on this rank (built by make_data_parallel_train_step or
    make_multihost_train_step).

    `generator` is this rank's own (seeded with `seed(seed)`, shard_seed).  With
    `local` False the batch is the whole batch and the step takes its rows
    (`shard_batch`); with `local` True it is this rank's shard already
    (multihost.global_batch_from_host_shards).  A whole batch whose size
    the mesh does not divide (a ragged tail) is trained on every rank in
    full, with the JAX package's message once: rank 0 draws a seed from its
    generator and broadcasts it, every rank computes the full batch's
    gradients from that one stream, and the same mean all-reduce follows,
    so the parameters stay replicated bit for bit even where the card's
    backward is not ordered run to run."""

    def __init__(self, system, mesh, local=False):
        self.system, self.mesh, self.local = system, mesh, local
        self.shard, self.n_shards = mesh_shard(mesh)
        self.group = mesh.get_group() if mesh.ndim == 1 else None  # None: the whole world
        self.warned = False

    def seed(self, seed):
        """This rank's generator seed in a run seeded `seed` (shard_seed)."""
        return shard_seed(seed, self.shard)

    @spanned("train_step")
    def __call__(self, batch, generator):
        B = len(batch["points"])
        if self.local or B % self.n_shards == 0:
            local = batch if self.local else shard_batch(self.mesh, batch)
            logs = self.system.grads_and_logs(local, generator)
            return reduce_and_apply(self.system, logs, self.group)
        if not self.warned:
            self.warned = True
            print(f"data-parallel: batch {B} not divisible by the {self.n_shards}-device mesh; "
                  "running ragged tail unsharded (use DataLoader drop_last=True to avoid this)",
                  flush=True)
        seed = torch.randint(0, 1 << 62, (1,), generator=generator, device=generator.device)
        seed = C.broadcast_([seed.to(self.system.device)], src=0, group=self.group)[0]
        shared = torch.Generator(device=generator.device).manual_seed(int(seed))
        logs = self.system.grads_and_logs(batch, shared)
        return reduce_and_apply(self.system, logs, self.group)


def make_data_parallel_train_step(system, n_devices=None, mesh=None):
    """train_step(batch, generator) -> logs, sharded over the batch axis of
    a 1-D mesh (make_mesh(n_devices) without one): every rank calls it on
    the whole batch and its own generator (see DataParallelTrainStep)."""
    return DataParallelTrainStep(system, mesh or make_mesh(n_devices))


class DataParallelTestStep:
    """step(batch, generator) -> (logs, extras): `system.test_step` on this
    rank's objects (kernels B1 and B2 on the card), the scalar logs' mean
    over the ranks (equal shard sizes), and the per-object extras ("pred",
    "best_k", "best_score", "linkage", the embeddings) of every rank
    concatenated on the batch axis.  `generator` is this rank's own."""

    def __init__(self, system, mesh):
        self.system, self.mesh = system, mesh
        self.group = mesh.get_group() if mesh.ndim == 1 else None

    @spanned("test_step")
    def __call__(self, batch, generator):
        logs, extras = self.system.test_step(shard_batch(self.mesh, batch), generator)
        logs = C.mean_all_reduce_tree(logs, self.group)
        return logs, {k: C.gather_slots(v, 0, self.group) for k, v in extras.items()}


def make_data_parallel_test_step(system, n_devices=None, mesh=None):
    """test_step(batch, generator) -> (logs, extras) sharded over the batch
    axis (see DataParallelTestStep)."""
    return DataParallelTestStep(system, mesh or make_mesh(n_devices))
