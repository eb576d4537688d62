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

Example, the flagship (ShapeNet-Part under data/ShapeNet/raw):

    python -m hpcs_torch.train --dataset shapenet --model vn_dgcnn_partseg \\
        --fixed_points 1024 --k 20 --eucl_embedding 32 --hyp_embedding 32 \\
        --margin 0.35 --t_per_anchor 50 --temperature 0.05 --epochs 50 \\
        --lr 0.05 --trade_off 0.1
"""
import argparse
import os

from .cli import add_train_args, configure
from .trainer import fit, test
from .utils.checkpoint import restore_checkpoint, save_checkpoint
from .utils.logging import MetricLogger
from .utils.pretrained import graft_pretrained_backbone, load_raw_backbone_state_dict


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


def main(argv=None):
    """Run the CLI on `argv` (default sys.argv[1:]); returns (system, the
    test results)."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_train_args(parser)
    args = parser.parse_args(argv)
    system, train_loader, valid_loader, test_loader = configure(args)
    if args.pretrained:
        graft_pretrained(system, args.pretrained_path)

    run_name = f"{args.dataset}_{args.model}"
    logger = MetricLogger(args.log, run_name, use_wandb=args.wandb == "online",
                          wandb_mode=args.wandb, config=vars(args))
    ckpt_dir = os.path.join(args.log, run_name, "checkpoints")
    try:
        if args.infer:
            if args.resume:
                restore_checkpoint(args.resume, system)
        else:
            fit(system, train_loader, valid_loader, epochs=args.epochs, patience=args.patience,
                seed=args.seed, logger=logger, ckpt_dir=ckpt_dir, resume=args.resume or None)
            print("End Training", flush=True)
            save_checkpoint(os.path.join(ckpt_dir, "final"), system, system.cfg)
        results = test(system, test_loader, seed=args.seed,
                       limit_batches=None if args.infer else 10, logger=logger)
    finally:
        logger.close()
    print({k: round(v, 4) for k, v in results.items()}, flush=True)
    return system, results


if __name__ == "__main__":
    main()
