"""Test a checkpoint: `python -m hpcs_torch.infer {shapenet,partnet,synthetic}
--model_path <checkpoint> [flags]`.

The subcommands and flags are the JAX package's infer.py's; the run goes
on CUDA unless --accelerator cpu.  The checkpoint is a directory with
model.ckpt + config.json, or its model.ckpt: one the port's save_checkpoint
wrote, one the JAX package wrote (its msgpack model.ckpt), or one
`python -m hpcs_torch.import_checkpoint` made from a reference Lightning
checkpoint; or the JAX package's multi-process checkpoint, a directory with
orbax/ + meta.json + config.json (read through libzstd.so.1, no orbax).
Its config is taken with --test_rotation and --fixed_points
from the flags.  The test split (data/ShapeNet/raw, data/PartNet/sem_seg_h5/
<category>-<level>, or 16 synthetic clouds) is shuffled with --seed and
`trainer.test` runs on at most --test_batches batches.  --plot_inference
saves each object's figure as <N>.png in plots/ beside the checkpoint
(the JAX package's place: the parent of the directory given), and needs
matplotlib.
"""
import argparse
import os

from .cli import freeze_hierarchy, select_device
from .data import DataLoader, PartNetDataset, ShapeNetDataset, SyntheticPartDataset
from .models import HypHCSystem, ModelConfig
from .trainer import test
from .utils.checkpoint import load_config, restore_checkpoint
from .utils.viz import require_matplotlib


def check_model_path(model_path):
    """`model_path` when it exists; raises otherwise.  `wandb:<run>` paths
    raise: the port has no network route to fetch them."""
    if model_path.startswith("wandb:"):
        raise NotImplementedError(
            "wandb:<run_path> checkpoints are not fetched by the port; download the run's "
            "checkpoint and pass its directory")
    if os.path.exists(model_path):
        return model_path
    raise FileNotFoundError(
        f"checkpoint not found: {model_path} (expected a directory with model.ckpt + "
        "config.json, or its model.ckpt: written by hpcs_torch or hpcs_tpu, or imported from a "
        "reference Lightning checkpoint by python -m hpcs_torch.import_checkpoint; or hpcs_tpu's "
        "multi-process checkpoint, a directory with orbax/ + meta.json + config.json)")


def build_args(sub, dataset):
    sub.add_argument('--model_path', '-model_path', type=str, required=True)
    sub.add_argument('--test_batches', '-test_batches', default=10, type=int)
    sub.add_argument('--batch', '-batch', default=2, type=int)
    sub.add_argument('--fixed_points', '-fixed_points', default=512, type=int)
    sub.add_argument('--test_rotation', '-test_rotation', default='so3', type=str)
    sub.add_argument('--plot_inference', action='store_true',
                     help='save each object\'s figure under plots/ beside the checkpoint '
                          '(needs matplotlib)')
    sub.add_argument('--accelerator', '-accelerator', default='cuda', type=str,
                     help='cuda | gpu | cpu')
    sub.add_argument('--seed', type=int, default=0)
    if dataset == 'partnet':
        sub.add_argument('--category', '-category', required=True, type=str)
        sub.add_argument('--level', '-level', default=3, type=int)
    elif dataset == 'shapenet':
        sub.add_argument('--category', '-category', default=None, type=str)


def main(argv=None):
    """Run the CLI on `argv` (default sys.argv[1:]); returns (system, the
    test results)."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    subparsers = parser.add_subparsers(dest='dataset', required=True)
    for name in ('shapenet', 'partnet', 'synthetic'):
        build_args(subparsers.add_parser(name), name)
    args = parser.parse_args(argv)
    if args.plot_inference:
        require_matplotlib("--plot_inference's figures")
    device = select_device(args.accelerator)

    path = check_model_path(args.model_path)
    cfg_dict = load_config(path if os.path.isdir(path) else os.path.dirname(path))
    cfg_dict["test_rotation"] = args.test_rotation
    cfg_dict["fixed_points"] = args.fixed_points
    cfg_dict["hierarchy_list"] = freeze_hierarchy(cfg_dict.get("hierarchy_list", ()))
    system = HypHCSystem(ModelConfig(**cfg_dict), device=device)

    if args.dataset == 'shapenet':
        ds = ShapeNetDataset(root='data/ShapeNet/raw', npoints=args.fixed_points,
                             split='test', class_choice=args.category)
    elif args.dataset == 'partnet':
        base = os.path.join('data/PartNet/sem_seg_h5', f'{args.category}-{args.level}')
        ds = PartNetDataset(os.path.join(base, 'test_files.txt'), args.fixed_points)
    else:
        ds = SyntheticPartDataset(num_objects=32, npoints=args.fixed_points, seed=3)
    loader = DataLoader(ds, args.batch, shuffle=True, drop_last=False, seed=args.seed)
    restore_checkpoint(path, system)

    plot_dir = os.path.join(os.path.dirname(path) or ".", "plots") if args.plot_inference else None
    results = test(system, loader, seed=args.seed, limit_batches=args.test_batches,
                   plot_dir=plot_dir)
    print({k: round(v, 4) for k, v in results.items()}, flush=True)
    return system, results


if __name__ == "__main__":
    main()
