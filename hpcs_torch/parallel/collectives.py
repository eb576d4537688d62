"""The collectives of the port's parallel paths, over torch.distributed.

The JAX package has no such file: its collectives are `jax.lax.pmean`
inside `shard_map` and whatever GSPMD inserts.  Every function here is
written on `all_reduce` and `broadcast` alone, so that gloo carries them on
CUDA tensors as well as on CPU tensors (gloo's CUDA support is narrower
than NCCL's): a gather is a sum of zero-padded slots, exact whatever the
order of the sum, since each slot holds one rank's values and zeros.

`group` is a torch.distributed process group, None for the default one.
The autograd-aware forms (`all_gather`, `all_reduce_sum`) carry gradients:
the adjoint of a gather is the sum of the gradient over the group followed
by this rank's slice, that of a sum is the sum.  A global max is
`all_gather` of each rank's local max followed by `max` over the gathered
axis (`all_max`), never an all_reduce(MAX): torch.distributed.nn's backward
for that sums the gradients, which is wrong for a max.
"""
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_unflatten


def rank(group=None):
    """This process's rank in `group`; 0 without a process group."""
    return dist.get_rank(group) if dist.is_initialized() else 0


def world_size(group=None):
    """The number of ranks in `group`; 1 without a process group."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def _buckets(tensors):
    """The tensors grouped by (dtype, device), as lists of positions."""
    out = {}
    for i, t in enumerate(tensors):
        out.setdefault((t.dtype, t.device), []).append(i)
    return out.values()


def mean_all_reduce_(tensors, group=None):
    """Replace each floating-point tensor of the list, in place, by its mean
    over `group`: the gradients, the logs and the BatchNorm buffers of the
    data-parallel step (pmean's counterpart).  One all_reduce per dtype and
    device, on a flat buffer; every rank then holds the same bits.  Returns
    the list."""
    n = world_size(group)
    for pos in _buckets(tensors):
        flat = torch.cat([tensors[i].reshape(-1) for i in pos])
        dist.all_reduce(flat, group=group)
        flat /= n
        offset = 0
        for i in pos:
            t = tensors[i]
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
    return tensors


def mean_all_reduce_tree(tree, group=None):
    """A pytree (dicts, lists) of tensors with every leaf replaced by its
    mean over `group` (new tensors; the leaves are not changed)."""
    leaves, spec = tree_flatten(tree)
    return tree_unflatten(mean_all_reduce_([t.detach().clone() for t in leaves], group), spec)


def broadcast_(tensors, src=0, group=None):
    """Overwrite each tensor of the list, in place, with rank `src`'s
    (the global rank).  Returns the list."""
    for t in tensors:
        dist.broadcast(t, src, group=group)
    return tensors


def gather_slots(x, dim=0, group=None):
    """Every rank's x concatenated along `dim` in rank order (all ranks'
    x of one shape), without gradient: rank r writes x into slot r of a
    zero buffer and the buffers are summed (bf16 as its fp32 upcast,
    rounded back: exact)."""
    if x.dtype == torch.bfloat16:
        return gather_slots(x.float(), dim, group).to(x.dtype)
    n, r = world_size(group), rank(group)
    shape = list(x.shape)
    shape.insert(0, n)
    buf = torch.zeros(shape, dtype=x.dtype, device=x.device)
    buf[r] = x
    dist.all_reduce(buf, group=group)
    return torch.cat(buf.unbind(0), dim=dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.size = dim, group, x.shape[dim]
        return gather_slots(x.detach(), dim, group)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        start = rank(ctx.group) * ctx.size
        return grad.narrow(ctx.dim, start, ctx.size), None, None


def all_gather(x, dim=0, group=None):
    """Every rank's x concatenated along `dim` in rank order, with
    gradient: the backward sums the gradient over the group, then keeps
    this rank's slice.  bf16 goes as its fp32 upcast (the gather exact,
    the gradient summed in fp32)."""
    if x.dtype == torch.bfloat16:
        return _AllGather.apply(x.float(), dim, group).to(x.dtype)
    return _AllGather.apply(x, dim, group)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.detach().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x, group=None):
    """The sum of x over the group, with gradient (the sum of the
    gradient over the group)."""
    return _AllReduceSum.apply(x, group)


def all_max(x, dim, group=None):
    """The max of x over `dim` across every rank's x (each rank holding
    its own part of that axis), with gradient to the entry that holds it:
    the ranks' local maxima gathered, then the max over them."""
    local = x.max(dim=dim, keepdim=True).values
    return all_gather(local, dim, group).max(dim=dim).values
