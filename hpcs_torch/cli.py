"""The training CLI: its flags, and the datasets, system and loaders they
configure.

The flags are the JAX package's (`hpcs_tpu/cli.py`), with the same names,
defaults and store_false traps: --miner and --hierarchical are on by
default and the flag turns them off, and CosFace is the metric loss unless
--triplet-sim.  --hierarchy_list takes JSON.  One flag differs:
--accelerator names the port's device, `cuda` (or `gpu`) by default, or
`cpu`.  The flags whose path is not ported yet raise NotImplementedError
naming their ROADMAP item: `refuse_unported` for the flags that are not
ModelConfig fields, HypHCSystem for --layout vc.  --model takes each of
the JAX package's four backbones; --bf16 computes VN-DGCNN in bf16.

Data roots are relative to the working directory, as in the JAX package:
data/ShapeNet/raw, data/PartNet/sem_seg_h5 and
data/PartNet/after_merging_label_ids.
"""
import json
import os.path as osp

from .data import DataLoader, PartNetDataset, ShapeNetDataset, SyntheticPartDataset
from .data.hierarchy import get_hierarchy_list
from .device import resolve_device
from .models import HypHCSystem, ModelConfig


def add_train_args(parser):
    parser.add_argument('--log', default='logs', type=str, help='dirname for logs')
    parser.add_argument('--dataset', '-dataset', default='shapenet', type=str,
                        help='name of dataset to use (shapenet | partnet | synthetic)')
    parser.add_argument('--category', '-category', default=None, type=str, help='category from dataset')
    parser.add_argument('--level', '-level', default=3, type=int, help='granularity level of partnet object')
    parser.add_argument('--fixed_points', '-fixed_points', default=512, type=int, help='points retained from point cloud')
    parser.add_argument('--model', '-model', default='vn_dgcnn_partseg', type=str, help='model to use to extract features')
    parser.add_argument('--train_rotation', '-train_rotation', default='so3', type=str, help='type of rotation augmentation for train')
    parser.add_argument('--test_rotation', '-test_rotation', default='so3', type=str, help='type of rotation augmentation for test')
    parser.add_argument('--eucl_embedding', '-eucl_embedding', default=2, type=int, help='dimension of euclidean space')
    parser.add_argument('--hyp_embedding', '-hyp_embedding', default=2, type=int, help='dimension of poincare space')
    parser.add_argument('--k', '-k', default=10, type=int, help='if model dgcnn, k is the number of neigh to take into account')
    parser.add_argument('--margin', '-margin', default=0.05, type=float, help='margin value to use in miner loss')
    parser.add_argument('--t_per_anchor', '-t_per_anchor', default=50, type=int, help='triplets per anchor')
    parser.add_argument('--fraction', '-fraction', default=1.2, type=float, help='number of triplets for underrepresented classes')
    parser.add_argument('--temperature', '-temperature', default=1, type=float, help='rescale softmax value used in the hyphc loss')
    parser.add_argument('--epochs', '-epochs', default=50, type=int, help='number of epochs')
    parser.add_argument('--batch', '-batch', default=6, type=int, help='batch size')
    parser.add_argument('--lr', '-lr', default=0.005, type=float, help='learning rate')
    parser.add_argument('--accelerator', '-accelerator', default='cuda', type=str,
                        help='cuda | gpu | cpu (the device the port runs on)')
    parser.add_argument('--num_workers', '-num_workers', default=0, type=int,
                        help='data-loader prefetch threads (0 = synchronous)')
    parser.add_argument('--dropout', '-dropout', default=0.5, type=float, help='dropout in the feature extractor')
    parser.add_argument('--anneal_factor', '-anneal_factor', default=2, type=float, help='annealing factor')
    parser.add_argument('--anneal_step', '-anneal_step', default=0, type=int, help='use annealing each n step')
    parser.add_argument('--patience', '-patience', default=50, type=int, help='patience value for early stopping')
    parser.add_argument('--trade_off', '-trade_off', default=1.0, type=float, help='control trade-off between two losses')
    parser.add_argument('--miner', action='store_false', help='triplet miner for hyperbolic loss (default ON)')
    parser.add_argument('--triplet-sim', dest='triplet_sim', action='store_true', help='cosface / triplet loss')
    parser.add_argument('--class_vector', action='store_true', help='class vector to decode')
    parser.add_argument('--hierarchical', action='store_false', help='hierarchical loss (default ON for partnet)')
    parser.add_argument('--hierarchy_list', '-hierarchy_list', default='[]', type=str, help='precomputed hierarchy list as JSON')
    parser.add_argument('--plot_inference', action='store_true', help='plot visualizations during testing (not ported: ROADMAP A12b)')
    parser.add_argument('--pretrained', action='store_true', help='load pretrained model')
    parser.add_argument('--pretrained_path', type=str, default='',
                        help='explicit path to a raw backbone checkpoint (.t7/.pth), with --pretrained')
    parser.add_argument('--infer', action='store_true', help='set this flag if you want only infer')
    parser.add_argument('--resume', type=str, default='', help='path to checkpoint dir to resume')
    parser.add_argument('--wandb', '-wandb', default='offline', type=str, help='online/offline/disabled wandb mode')
    parser.add_argument('--seed', type=int, default=0, help='prng seed')
    parser.add_argument('--num_triplets', type=int, default=0,
                        help='static triplet budget per step (0 = t_per_anchor * points)')
    parser.add_argument('--data_parallel', type=int, default=0,
                        help='devices to shard the batch over (0 and 1: one; more is not ported: ROADMAP A11)')
    parser.add_argument('--profile', type=str, default='',
                        help='write a profiler trace to this directory (not ported: ROADMAP A12b)')
    parser.add_argument('--debug_nans', action='store_true',
                        help='stop at the first NaN (not ported: ROADMAP A12b)')
    parser.add_argument('--bf16', action='store_true',
                        help='bf16 compute in the VN-DGCNN backbone (the other backbones stay fp32)')
    parser.add_argument('--layout', default='cv', choices=['cv', 'vc'],
                        help="VN feature layout ('vc' is the JAX package's TPU layout, not ported)")
    return parser


def select_device(accelerator):
    """The torch.device for --accelerator: `cuda` or `gpu` the GPU (raises
    when there is none), `cpu` the CPU.  Anything else raises ValueError."""
    if accelerator in ("cuda", "gpu"):
        return resolve_device()
    if accelerator == "cpu":
        return resolve_device("cpu")
    raise ValueError(f"--accelerator {accelerator!r}: the port runs on 'cuda' (or 'gpu') or "
                     "'cpu'; the JAX package (train.py) runs on the TPU")


def refuse_unported(args):
    """Raise NotImplementedError, naming the ROADMAP item, for a flag whose
    path the port does not have yet (train's flags or infer's)."""
    unported = [
        (getattr(args, 'data_parallel', 0) > 1, '--data_parallel > 1: ROADMAP A11'),
        (getattr(args, 'profile', ''), '--profile: ROADMAP A12b'),
        (getattr(args, 'debug_nans', False), '--debug_nans: ROADMAP A12b'),
        (args.plot_inference, '--plot_inference (plots): ROADMAP A12b'),
    ]
    for given, what in unported:
        if given:
            raise NotImplementedError(f"not ported yet: {what}")


def configure_data(args):
    """(train, valid, test datasets, num_class, num_categories,
    hierarchy_list) for args.dataset: shapenet, partnet or synthetic."""
    dataset = args.dataset
    if dataset == 'shapenet':
        root = 'data/ShapeNet/raw'
        train_ds, valid_ds, test_ds = (
            ShapeNetDataset(root=root, npoints=args.fixed_points, split=split,
                            class_choice=args.category) for split in ('train', 'val', 'test'))
        num_categories = 16
        num_class = 50 if args.category is None else len(train_ds.seg_classes[args.category])
        hierarchy_list = []
    elif dataset == 'partnet':
        data_folder = 'data/PartNet/sem_seg_h5/'
        hierarchy_list = []
        if args.hierarchical:
            levels = [i + 1 for i in range(3)
                      if osp.exists(osp.join(data_folder, f'{args.category}-{i + 1}',
                                             'train_files.txt'))]
            hierarchy_list = get_hierarchy_list('data/PartNet/after_merging_label_ids',
                                                args.category, levels)
        base = osp.join(data_folder, f'{args.category}-{args.level}')
        train_ds, valid_ds, test_ds = (
            PartNetDataset(osp.join(base, f'{split}_files.txt'), args.fixed_points)
            for split in ('train', 'val', 'test'))
        level_file = f'data/PartNet/after_merging_label_ids/{args.category}-level-{args.level}.txt'
        with open(level_file) as fin:
            num_class = len(fin.readlines()) + 1
        num_categories = 1
    elif dataset == 'synthetic':
        num_categories, parts = 4, 3
        num_class = num_categories * parts
        train_ds, valid_ds, test_ds = (
            SyntheticPartDataset(num_objects=n, npoints=args.fixed_points,
                                 num_categories=num_categories, parts_per_object=parts, seed=s)
            for n, s in ((64, 1), (16, 2), (16, 3)))
        hierarchy_list = []
    else:
        raise KeyError(f"Not available implementation for dataset: {dataset}")
    return train_ds, valid_ds, test_ds, num_class, num_categories, hierarchy_list


def freeze_hierarchy(h):
    """A hierarchy list (nested lists, as JSON gives it) as nested tuples,
    so the ModelConfig holding it stays hashable."""
    return tuple(tuple(tuple(ch) for ch in lvl) for lvl in h)


def configure(args):
    """(system, train_loader, valid_loader, test_loader) from parsed args;
    the system on `select_device(args.accelerator)`."""
    refuse_unported(args)
    device = select_device(args.accelerator)
    train_ds, valid_ds, test_ds, num_class, num_categories, hierarchy_list = configure_data(args)
    if args.hierarchy_list and args.hierarchy_list != '[]':
        hierarchy_list = json.loads(args.hierarchy_list)
    cfg = ModelConfig(
        dataset='partnet' if args.dataset == 'partnet' else 'shapenet',
        model_name=args.model,
        num_class=num_class,
        num_categories=num_categories,
        fixed_points=args.fixed_points,
        eucl_dim=args.eucl_embedding,
        hyp_dim=args.hyp_embedding,
        k=args.k,
        dropout=args.dropout,
        margin=args.margin,
        t_per_anchor=args.t_per_anchor,
        fraction=args.fraction,
        temperature=args.temperature,
        anneal_factor=args.anneal_factor,
        anneal_step=args.anneal_step,
        trade_off=args.trade_off,
        miner=args.miner,
        cosface=not args.triplet_sim,
        hierarchical=args.hierarchical and args.dataset == 'partnet',
        class_vector=args.class_vector,
        train_rotation=args.train_rotation,
        test_rotation=args.test_rotation,
        lr=args.lr,
        bf16=args.bf16,
        layout=args.layout,
        num_triplets=args.num_triplets or None,
        hierarchy_list=freeze_hierarchy(hierarchy_list),
    )
    system = HypHCSystem(cfg, device=device)
    workers = args.num_workers
    train_loader = DataLoader(train_ds, args.batch, shuffle=True, drop_last=True,
                              seed=args.seed, num_workers=workers)
    valid_loader = DataLoader(valid_ds, args.batch, shuffle=False, drop_last=True,
                              num_workers=workers)
    # the test loader keeps its ragged tail
    test_loader = DataLoader(test_ds, args.batch, shuffle=False, drop_last=False,
                             num_workers=workers)
    return system, train_loader, valid_loader, test_loader
