"""Train the port: `python -m hpcs_torch.train [flags]`.

The flags are the JAX package's train.py's (hpcs_torch/cli.py); the run
goes on CUDA unless --accelerator cpu.  It trains with `trainer.fit`
(metrics to <log>/<dataset>_<model>/metrics.jsonl and .csv, checkpoints
best/ and last/ under its checkpoints/ directory, --resume from one of
them or from a JAX-package checkpoint, which resumes at its stored
epoch + 1), saves checkpoints/final from the best state, then tests it on at
most 10 test batches.  With --infer it only tests, every test batch, the
untrained system or the one --resume restores.  --pretrained grafts a raw
VN-DGCNN backbone checkpoint (--pretrained_path, or the reference's default
paths) onto the fresh system first.

--profile DIR writes one profiler trace of the training and the test
(utils.profiling.trace: a span per module call, step and kernel call) to
DIR; --debug_nans raises FloatingPointError at the first operation that
makes a NaN, naming it and the module it ran in (utils.profiling.
nan_debugging), and turns the checks off again however the run ends;
--plot_inference saves each tested object's figure under
<log>/<dataset>_<model>/plots (needs matplotlib, checked before any work).

--data_parallel N (0: every visible GPU; cli.data_parallel_size) trains on
N ranks, one process each (torch.multiprocessing, spawn): NCCL on cuda:r,
or gloo on the CPU with --accelerator cpu (the ranks share this process's
intra-op threads).  Each rank runs `fit` with
hpcs_torch.parallel's data-parallel step in lockstep; rank 0 writes the
logs and checkpoints (the single-device format: `.infer` serves them as
they are) and tests its final state on one device.  This process then
loads final/ and returns it.

Example, the flagship (ShapeNet-Part under data/ShapeNet/raw):

    python -m hpcs_torch.train --dataset shapenet --model vn_dgcnn_partseg \\
        --fixed_points 1024 --k 20 --eucl_embedding 32 --hyp_embedding 32 \\
        --margin 0.35 --t_per_anchor 50 --temperature 0.05 --epochs 50 \\
        --lr 0.05 --trade_off 0.1
"""
import argparse
import contextlib
import os
import sys

import torch

from .cli import add_train_args, configure, data_parallel_size
from .trainer import fit, test
from .utils.checkpoint import restore_checkpoint, save_checkpoint
from .utils.logging import MetricLogger
from .utils.pretrained import graft_pretrained_backbone, load_raw_backbone_state_dict
from .utils.profiling import nan_debugging, trace


def graft_pretrained(system, path=""):
    """--pretrained: graft a raw VN-DGCNN backbone checkpoint onto the
    system's backbone (`utils.pretrained`).  Without a path, PartNet's
    (num_categories 1) is model.partseg.vn_dgcnn.aligned.t7 and the others'
    checkpoints/vndgcnn_backbone/best_model.pth, in the working directory."""
    path = path or ("model.partseg.vn_dgcnn.aligned.t7" if system.cfg.num_categories == 1
                    else os.path.join("checkpoints", "vndgcnn_backbone", "best_model.pth"))
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"--pretrained requested but checkpoint not found: {path} "
            "(use --pretrained_path to point at a .t7/.pth backbone)")
    swapped = graft_pretrained_backbone(system.net.nn_feat, load_raw_backbone_state_dict(path),
                                        system.cfg.eucl_dim)
    print(f"loaded pretrained backbone from {path}"
          + (" (conv11 head re-initialized: width mismatch)" if swapped else ""), flush=True)


def _parse(argv):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_train_args(parser)
    return parser.parse_args(argv)


def _run(args, make_step=None, lead=True):
    """Configure, train (unless --infer) and test; the data-parallel ranks
    run this with make_step(system) their step, rank 0 as `lead`, which
    alone logs, writes, tests and traces.  Returns (system, the test
    results or None)."""
    with nan_debugging(args.debug_nans):
        system, train_loader, valid_loader, test_loader = configure(args)
        if args.pretrained:
            graft_pretrained(system, args.pretrained_path)
        run_name = f"{args.dataset}_{args.model}"
        ckpt_dir = os.path.join(args.log, run_name, "checkpoints")
        logger = MetricLogger(args.log, run_name, use_wandb=args.wandb == "online",
                              wandb_mode=args.wandb, config=vars(args)) if lead else None
        profiled = trace(args.profile) if args.profile and lead else contextlib.nullcontext()
        try:
            step = make_step(system) if make_step is not None else None
            with profiled:
                if args.infer:
                    if args.resume:
                        restore_checkpoint(args.resume, system)
                else:
                    fit(system, train_loader, valid_loader, epochs=args.epochs,
                        patience=args.patience, seed=args.seed, logger=logger, ckpt_dir=ckpt_dir,
                        resume=args.resume or None, train_step_fn=step)
                    if not lead:
                        return system, None
                    print("End Training", flush=True)
                    save_checkpoint(os.path.join(ckpt_dir, "final"), system, system.cfg)
                plot_dir = os.path.join(args.log, run_name, "plots") if args.plot_inference else None
                results = test(system, test_loader, seed=args.seed,
                               limit_batches=None if args.infer else 10, logger=logger,
                               plot_dir=plot_dir)
        finally:
            if logger is not None:
                logger.close()
    return system, results


def _data_parallel_step(system):
    """The rank's data-parallel step, the weights first made rank 0's."""
    from .parallel import make_data_parallel_train_step, replicate

    step = make_data_parallel_train_step(system)
    replicate(step.mesh, system.net.state_dict())
    return step


def _rank_main(argv):
    """One rank of a --data_parallel run: the test results on rank 0."""
    import torch.distributed as dist

    return _run(_parse(argv), _data_parallel_step, lead=dist.get_rank() == 0)[1]


def main(argv=None):
    """Run the CLI on `argv` (default sys.argv[1:]); returns (system, the
    test results)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parse(argv)
    world = 1 if args.infer else data_parallel_size(args)
    if world == 1:
        system, results = _run(args)
    else:
        from .parallel.multihost import run_ranks

        on_cpu = args.accelerator == "cpu"
        print(f"data-parallel over {world} devices", flush=True)
        # no deadline: a run takes as long as its epochs; a rank that dies
        # ends the wait, and a collective that waits past its group's
        # timeout fails its rank
        results = run_ranks(_rank_main, world, args=(argv,), backend="gloo" if on_cpu else "nccl",
                            device_ids=None if on_cpu else list(range(world)),
                            threads=max(1, torch.get_num_threads() // world), timeout=None)[0]
        system = configure(args)[0]
        final = os.path.join(args.log, f"{args.dataset}_{args.model}", "checkpoints", "final")
        restore_checkpoint(final, system)
    print({k: round(v, 4) for k, v in results.items()}, flush=True)
    return system, results


if __name__ == "__main__":
    main()
