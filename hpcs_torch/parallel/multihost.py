"""Multi-process data parallelism: the counterpart of
hpcs_tpu/parallel/multihost.py, with one process per device.

- `initialize_distributed`: torch.distributed bring-up from its arguments
  or from the environment that `torch.distributed.run` sets (MASTER_ADDR,
  MASTER_PORT, RANK, WORLD_SIZE); a no-op when a group exists.
- `make_hybrid_mesh`: a ("dcn", "data") DeviceMesh of nodes x local ranks;
  both axes shard the batch, the parameters stay replicated.
- `make_multihost_train_step`: the data-parallel step over the whole world,
  shard id dcn * n_local + data.
- `process_indices[_with_mask]`: each rank reads only its own objects.
- `global_batch_from_host_shards`: the rank's local batch is its shard.
- `run_ranks`: start one process per rank (torch.multiprocessing, spawn),
  each with its process group, and collect what each returns.

`python -m hpcs_torch.multihost_dryrun` runs the path on the CPU: 2 "hosts"
x 2 local gloo ranks, each reading only its process_indices, one step.
"""
import datetime
import os
import pickle
import queue as queue_mod
import socket
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from . import collectives as C
from .data_parallel import DataParallelTrainStep, default_device_type, replicate

TIMEOUT_S = 600  # a collective that waits longer than this fails


def initialize_distributed(coordinator_address=None, num_processes=None, process_id=None,
                           local_device_ids=None, backend=None):
    """Bring up torch.distributed: the default process group of
    `num_processes` ranks at `coordinator_address` ("host:port"), this
    process being rank `process_id`.  Without an address it reads the
    environment of `torch.distributed.run`, and does nothing when that
    names no world either (one process).  A no-op when a group exists.

    local_device_ids: the CUDA device this process drives (its first
    entry).  backend: "nccl" or "gloo"; by default NCCL when CUDA is
    available, else gloo.  NCCL refuses two ranks on one device: ranks
    that share a card run gloo."""
    if dist.is_initialized():
        return
    if coordinator_address is None:
        if "WORLD_SIZE" not in os.environ:
            return
        init_method = "env://"
    else:
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if local_device_ids is not None and torch.cuda.is_available():
        torch.cuda.set_device(local_device_ids[0])
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id, timeout=datetime.timedelta(seconds=TIMEOUT_S))


def make_hybrid_mesh(dcn_axis="dcn", data_axis="data", n_local=None, device_type=None):
    """2-D (nodes x local ranks) DeviceMesh ("dcn", "data"): the inner axis
    holds the ranks of one node (NVLink), the outer axis spans the nodes.
    n_local: ranks per node, by default LOCAL_WORLD_SIZE (torch.distributed.run
    sets it), else the visible GPUs, else the whole world (one node)."""
    world = C.world_size()
    n_local = (n_local or int(os.environ.get("LOCAL_WORLD_SIZE", 0))
               or min(torch.cuda.device_count(), world) or world)
    if world % n_local:
        raise ValueError(f"{world} ranks do not split into nodes of {n_local}")
    return init_device_mesh(device_type or default_device_type(), (world // n_local, n_local),
                            mesh_dim_names=(dcn_axis, data_axis))


def make_multihost_train_step(system, mesh):
    """train_step(local_batch, generator) -> logs: the data-parallel step
    over a ("dcn", "data") mesh, both axes sharding the batch.  Each rank
    passes its own shard (`global_batch_from_host_shards`) and its own
    generator (`data_parallel.shard_seed` of its shard id dcn * n_local +
    data); gradients, logs and running statistics take a mean all-reduce
    over the whole world."""
    return DataParallelTrainStep(system, mesh, local=True)


def process_indices(n_items, num_processes=None, process_id=None):
    """This rank's item indices for a global dataset of n_items: each rank
    reads only its own objects.

    Every rank gets ceil(n_items / num_processes) indices (the ranks step in
    lockstep, so they must take the same number of steps); the tail wraps
    around to the front, so every object is read by at least one rank.
    Wrapped objects appear on two ranks: right for training (a reweighting
    of a few samples), double-counted in evaluation, where
    process_indices_with_mask's mask weights them.  The defaults are the
    process group's world size and rank."""
    return process_indices_with_mask(n_items, num_processes, process_id)[0]


def process_indices_with_mask(n_items, num_processes=None, process_id=None):
    """(indices, valid): `indices` as process_indices, `valid[i]` False for
    wrapped duplicates (assigned to an earlier rank already)."""
    n = C.world_size() if num_processes is None else num_processes
    r = C.rank() if process_id is None else process_id
    per = -(-n_items // n)
    raw = np.arange(r * per, (r + 1) * per)
    return raw % n_items, raw < n_items


def global_batch_from_host_shards(mesh, host_batch):
    """The global batch as this rank holds it: its local batch is its shard.

    The JAX package stitches one global array out of each host's local
    arrays without moving data (make_array_from_process_local_data).  With
    one process per device each rank's local batch already is the shard
    that P(("dcn", "data")) would place on it (rank order = shard order),
    so no data moves here either and the batch comes back as it is."""
    return host_batch


def replicate_global(mesh, tree):
    """Rank 0's values of a pytree of tensors on every rank: a broadcast
    (in place; returns the tree)."""
    return replicate(mesh, tree)


def free_port():
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, address, backend, device_ids, threads, fn, args, results):
    try:
        if threads:
            torch.set_num_threads(threads)
        ids = None if device_ids is None else [device_ids[rank]]
        initialize_distributed(address, world, rank, ids, backend)
        results.put((rank, True, pickle.dumps(fn(*args))))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world, args=(), backend="gloo", device_ids=None, threads=None,
              timeout=TIMEOUT_S):
    """Run fn(*args) in `world` new processes (torch.multiprocessing,
    spawn), rank r with its default process group of `backend` up, and
    return each rank's result in rank order.

    fn must be importable (a module-level function) and its result
    picklable; tensors come back by value.  device_ids[r] is the CUDA
    device of rank r (None: no device is set); threads, when given, each
    rank's intra-op thread count.  A rank that raises or dies fails the
    run (RuntimeError with its traceback) and the other ranks are killed;
    so are all after `timeout` seconds (None: no deadline, for runs as
    long as their work, such as training)."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    address = f"localhost:{free_port()}"
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, address, backend, device_ids, threads, fn, args,
                               results))
             for r in range(world)]
    for p in procs:
        p.start()
    out, deadline = {}, None if timeout is None else time.time() + timeout
    try:
        while len(out) < world:
            try:
                r, ok, value = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [i for i, p in enumerate(procs) if p.exitcode not in (None, 0)
                        and i not in out]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} and no result") from None
                if deadline is not None and time.time() > deadline:
                    raise RuntimeError(f"ranks timed out after {timeout} s") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {r} failed:\n{value}")
            out[r] = pickle.loads(value)
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(world)]
