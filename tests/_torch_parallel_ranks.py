"""The rank processes of the port's parallel tests
(tests/test_torch_parallel.py, tests/test_torch_point_parallel.py).

Each function runs in every rank of a gloo job on the CPU
(hpcs_torch.parallel.multihost.run_ranks) and returns numpy.  This module
imports neither JAX nor hpcs_tpu: the JAX side's weights, inputs and
triplets arrive as numpy arrays.  Importing _torch_port makes each rank's
first vectorised math calls (see there).

`EarlyRanks` starts a job before its arguments exist: the ranks spawn,
import and join their group while the parent still computes the JAX
side's inputs, which it then hands over (`when_given`).
"""
import os
import pickle
import time
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.distributed as dist

import _torch_port  # noqa: F401  (the first-call burn-in, in every rank)
from hpcs_torch.loss import joint
from hpcs_torch.models import HypHCSystem, decode_vector_for_batch
from hpcs_torch.parallel import collectives as C
from hpcs_torch.parallel import multihost
from hpcs_torch.parallel import (make_data_parallel_test_step, make_data_parallel_train_step,
                                 make_mesh, make_mesh_2d, make_point_sharded_forward,
                                 make_point_sharded_train_step, shard_points_batch)
from hpcs_torch.parallel.data_parallel import shard_batch, shard_seed
from hpcs_torch.parallel.point_parallel import PointShard
from hpcs_torch.testing import (GivenTriplets, check_train_step_card_vs_cpu, float64_train_step,
                                install_given_triplets)


def when_given(path, job):
    """job(*args) once the parent has written its args to `path` (a
    pickle); None written there instead means the parent failed."""
    while not os.path.exists(path):
        time.sleep(0.02)
    with open(path, "rb") as f:
        args = pickle.load(f)
    if args is None:
        raise RuntimeError("the parent gave no arguments")
    return job(*args)


class EarlyRanks:
    """run_ranks(job, world) started now, in a thread, on arguments given
    later (`give`); `result()` waits for the ranks' results.  Used as a
    context manager: leaving it without having given the arguments ends
    the ranks."""

    def __init__(self, job, world, directory, threads):
        self.path = os.path.join(directory, f"{job.__name__}_{world}.pickle")
        self.pool = ThreadPoolExecutor(1)
        self.future = self.pool.submit(multihost.run_ranks, when_given, world,
                                       args=(self.path, job), threads=threads)

    def give(self, *args):
        with open(self.path + ".part", "wb") as f:
            pickle.dump(args or None, f)
        os.replace(self.path + ".part", self.path)

    def result(self):
        return self.future.result()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if not os.path.exists(self.path):
            self.give()
        self.pool.shutdown()


def system_from(cfg, state_dict):
    system = HypHCSystem(cfg, device="cpu")
    system.net.load_state_dict({k: torch.as_tensor(v) for k, v in state_dict.items()})
    return system


def numpy_state(system):
    return {k: v.numpy().copy() for k, v in system.net.state_dict().items()}


def floats(logs):
    return {k: float(v) for k, v in logs.items()}


def numpy_grads(system):
    return {n: p.grad.numpy().copy() for n, p in system.net.named_parameters()}


def _with_given(given_args, fn):
    """fn() with the loss's sampler and filter serving given_args
    (GivenTriplets.set's arguments), the real ones after it."""
    real = joint.sample_balanced_triplets, joint.margin_filter
    install_given_triplets(GivenTriplets().set(*given_args))
    try:
        return fn()
    finally:
        joint.sample_balanced_triplets, joint.margin_filter = real


def data_parallel_job(cfg, state_dict, batch, given, ragged, test_cfg, rehearsal):
    """One data-parallel step from the given weights on each rank's JAX
    triplets (given[rank]): its logs, new state and the gradients it
    applied; the gradients the same step applies without their all-reduce
    (the negative control); then, from the first step's state, a ragged
    batch and a whole one on the sampler's own triplets; and the sharded
    test_step (test_cfg) beside each shard's own test_step;
    `world_size_one`; and chip_smoke's 2-rank card-vs-CPU check of the step
    (hpcs_torch.testing.check_train_step_card_vs_cpu with the mesh's group)
    with a CPU system in the card's place, on rehearsal = (config, batch);
    and `collectives_check` on the CPU."""
    rank = dist.get_rank()
    mesh = make_mesh(device_type="cpu")
    out = {}

    system = system_from(cfg, state_dict)
    step = make_data_parallel_train_step(system, mesh=mesh)
    gen = torch.Generator().manual_seed(shard_seed(0, rank))
    out["logs"] = floats(_with_given(given[rank], lambda: step(batch, gen)))
    out["state"], out["grads"] = numpy_state(system), numpy_grads(system)

    mutant = system_from(cfg, state_dict)
    real = C.mean_all_reduce_
    grads = {id(p): p for p in mutant.net.parameters()}

    def skip_gradients(tensors, group=None):
        keep = [t for t in tensors if not any(t is p.grad for p in grads.values())]
        real(keep, group)
        return tensors

    C.mean_all_reduce_ = skip_gradients
    try:
        mutant_step = make_data_parallel_train_step(mutant, mesh=mesh)
        _with_given(given[rank], lambda: mutant_step(batch, torch.Generator()))
    finally:
        C.mean_all_reduce_ = real
    out["mutant_grads"] = numpy_grads(mutant)

    out["ragged_logs"] = floats(step(ragged, gen))
    out["warned"] = step.warned
    out["after_ragged_state"] = numpy_state(system)
    step(batch, gen)
    out["final_state"] = numpy_state(system)

    tester = system_from(test_cfg, state_dict)
    logs, extras = make_data_parallel_test_step(tester, mesh=mesh)(
        batch, torch.Generator().manual_seed(shard_seed(7, rank)))
    out["test_logs"] = floats(logs)
    out["test_extras"] = {k: v.numpy() for k, v in extras.items()}
    shards = []
    for r in range(C.world_size() if rank == 0 else 0):
        b = len(batch["points"]) // C.world_size()
        part = {k: v[r * b:(r + 1) * b] for k, v in batch.items()}
        own_logs, own = tester.test_step(part, torch.Generator().manual_seed(shard_seed(7, r)))
        shards.append((floats(own_logs), {k: v.numpy() for k, v in own.items()}))
    out["test_shards"] = shards
    out["world_size_one"] = world_size_one(cfg, state_dict, batch)
    card_cfg, card_batch = rehearsal
    card = HypHCSystem(card_cfg, device="cpu")
    out["card_vs_cpu"] = check_train_step_card_vs_cpu(
        card, shard_batch(mesh, card_batch), seed=rank, group=mesh.get_group())
    out["card_vs_cpu_state"] = numpy_state(card)
    out["collectives"] = collectives_check("cpu")
    return out


def world_size_one(cfg, state_dict, batch):
    """The data-parallel step on a mesh of this rank alone and the
    single-device train_step, from the same weights and generator seed, at
    one thread (the CPU backward's sums are then in one order): (logs,
    state) of each.  Every rank must call it (it makes one group per
    rank)."""
    from torch.distributed.device_mesh import DeviceMesh

    alone = [dist.new_group([r]) for r in range(C.world_size())][dist.get_rank()]
    mesh = DeviceMesh.from_group(alone, "cpu", mesh_dim_names=("data",))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        single = system_from(cfg, state_dict)
        logs = single.train_step(batch, torch.Generator().manual_seed(0))
        dp = system_from(cfg, state_dict)
        dp_logs = make_data_parallel_train_step(dp, mesh=mesh)(
            batch, torch.Generator().manual_seed(shard_seed(0, 0)))
    finally:
        torch.set_num_threads(threads)
    return (floats(logs), numpy_state(single)), (floats(dp_logs), numpy_state(dp))


def point_parallel_job(shape, cfg, state_dict, batch, plain_cfg, given):
    """On a (D, P) mesh: the point-sharded eval forward (this rank's x_e,
    x_p); one point-sharded training step of `cfg` from generator seed 3;
    the step of plain_cfg (dropout 0, no rotation) in float64; and, with
    `given` (the JAX package's triplets and mask, or None), one fp32 step
    of plain_cfg on them: its logs, new state and the gradients it
    applied."""
    mesh = make_mesh_2d(*shape, device_type="cpu")
    part = shard_points_batch(mesh, batch)
    out = {}
    system = system_from(cfg, state_dict)
    dv = decode_vector_for_batch(cfg, part)
    x_e, x_p = make_point_sharded_forward(system, mesh)(part["points"], dv)
    out["forward"] = x_e.numpy(), x_p.numpy()
    out["logs"] = floats(make_point_sharded_train_step(system, mesh)(
        part, torch.Generator().manual_seed(3)))
    out["state"] = numpy_state(system)

    plain = system_from(plain_cfg, state_dict)
    logs64, grads64, state64 = float64_train_step(plain, part, None, shard=PointShard(mesh))
    out["float64"] = logs64, grads64, state64
    if given is not None:
        step = make_point_sharded_train_step(plain, mesh)
        out["given_logs"] = floats(_with_given(given, lambda: step(part, torch.Generator())))
        out["given_state"], out["given_grads"] = numpy_state(plain), numpy_grads(plain)
    return out



def _same_as_rank_0(system):
    """Whether this rank's parameters equal rank 0's bit for bit."""
    flat = torch.cat([p.detach().reshape(-1) for p in system.net.parameters()])
    return torch.equal(C.broadcast_([flat.clone()])[0], flat)


def point_parallel_backbones_job(shape, cases):
    """On a (D, P) mesh, for each case {name: (cfg, plain_cfg, state_dict,
    batch, given)}: the point-sharded eval forward (this rank's x_e, x_p,
    its decode vector from `point_parallel.decode_vector`); one
    point-sharded fp32 training step of cfg from generator seed 3 (its logs,
    and whether the ranks' parameters are then equal); the step of
    plain_cfg (dropout 0, no rotation) in float64; and, with `given` (the
    JAX package's triplets and mask, or None), one fp32 step of plain_cfg
    on them: its logs, new state and the gradients it applied.  The
    gradients and states come from rank 0 only (the steps leave the ranks
    equal, which each rank reports)."""
    from hpcs_torch.parallel.point_parallel import decode_vector

    mesh = make_mesh_2d(*shape, device_type="cpu")
    first = dist.get_rank() == 0
    out = {}
    for name, (cfg, plain_cfg, state_dict, batch, given) in cases.items():
        part = shard_points_batch(mesh, batch)
        r = out[name] = {}
        system = system_from(cfg, state_dict)
        x_e, x_p = make_point_sharded_forward(system, mesh)(
            part["points"], decode_vector(mesh, cfg, part))
        r["forward"] = x_e.numpy(), x_p.numpy()
        r["logs"] = floats(make_point_sharded_train_step(system, mesh)(
            part, torch.Generator().manual_seed(3)))
        r["replicated"] = _same_as_rank_0(system)
        plain = system_from(plain_cfg, state_dict)
        logs64, grads64, state64 = float64_train_step(plain, part, None, shard=PointShard(mesh))
        r["float64"] = (logs64, grads64, state64) if first else (logs64, None, None)
        if given is not None:
            step = make_point_sharded_train_step(plain, mesh)
            r["given_logs"] = floats(_with_given(given, lambda: step(part, torch.Generator())))
            r["given_replicated"] = _same_as_rank_0(plain)
            if first:
                r["given_state"], r["given_grads"] = numpy_state(plain), numpy_grads(plain)
    return out


def collectives_check(device_type):
    """hpcs_torch.parallel.collectives on this rank's device ("cpu", or
    "cuda": the current CUDA device): {check: passed} of the values and the
    gradients of each collective."""
    r, n = dist.get_rank(), dist.get_world_size()
    dev = torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda" else "cpu"
    out = {}
    x = (torch.arange(6., device=dev).reshape(2, 3) + 10 * r).requires_grad_()
    w = torch.arange(6. * n, device=dev).reshape(2, 3 * n)
    g = C.all_gather(x, 1)
    out["all_gather"] = torch.equal(g.detach(), torch.cat(
        [torch.arange(6., device=dev).reshape(2, 3) + 10 * q for q in range(n)], 1))
    (g * w).sum().backward()  # every rank's loss is the same: the adjoint sums n copies
    out["all_gather_grad"] = torch.equal(x.grad, n * w[:, 3 * r:3 * (r + 1)])
    y = torch.full((4,), float(r + 1), device=dev, requires_grad=True)
    s = C.all_reduce_sum(y)
    out["all_reduce_sum"] = torch.equal(s.detach(), torch.full((4,), n * (n + 1) / 2, device=dev))
    (2 * s).sum().backward()
    out["all_reduce_sum_grad"] = torch.equal(y.grad, torch.full((4,), 2.0 * n, device=dev))
    z = torch.tensor([[float(r), 5.0 - r]], device=dev, requires_grad=True)
    m = C.all_max(z, 0)  # column 0's max on the last rank, column 1's on rank 0
    out["all_max"] = torch.equal(m.detach(), torch.tensor([n - 1.0, 5.0], device=dev))
    m.sum().backward()
    out["all_max_grad"] = torch.equal(z.grad, torch.tensor(
        [[n * float(r == n - 1), n * float(r == 0)]], device=dev))
    mean = C.mean_all_reduce_([torch.full((3,), float(r), device=dev)])[0]
    out["mean_all_reduce"] = torch.equal(mean, torch.full((3,), (n - 1) / 2, device=dev))
    b = C.broadcast_([torch.full((2,), float(r), device=dev)])[0]
    out["broadcast"] = torch.equal(b, torch.zeros(2, device=dev))
    slots = C.gather_slots(torch.full((2,), r, dtype=torch.int64, device=dev))
    out["gather_slots_int64"] = torch.equal(
        slots, torch.arange(n, device=dev).repeat_interleave(2))
    return out
