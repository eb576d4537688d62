#!/usr/bin/env python
"""Converged quality of the PyTorch port on the real dataset file formats:
train the port to convergence on the mini datasets that
tools/make_mini_datasets_torch.py writes, through its own readers and
loader, evaluate it as tools/parity_real_format.py evaluates hpcs_tpu, and
set its per-seed means beside hpcs_tpu's recorded ones.

Datasets:
  shapenet: mini-ShapeNet-Part txt under <data>/ShapeNet/raw (Airplane,
    Cap), plain CosFace;
  partnet: mini-PartNet h5 under <data>/PartNet (Bottle, level 3),
    hierarchical CosFace over levels [1, 3] (read by the port's own HDF5
    reader, hpcs_torch.utils.hdf5).

Stages:
  torch: train one seed with hpcs_torch.trainer.fit on `--device` (cuda by
    default; cpu only when asked), save the checkpoint with
    hpcs_torch.utils.checkpoint.save_checkpoint, then test it: test_step's
    loss, accuracy and IoU, the top-1 accuracy of the raw cosine logits
    (CosFace without margin or scale), the best-k decode score, and the
    purity of scipy's fcluster(..., 'maxclust') cut at the true part count.
    Writes <out>/parity_rf[_pn]_torch_s<seed>.json and the checkpoint under
    <out>/parity_rf[_pn]_torch_s<seed>/checkpoints/final.
  report: the per-seed means, standard deviations and standard errors of
    the port's results beside hpcs_tpu's (benchmarks/parity_real_format
    [_partnet].json, only read), the delta and z = delta / combined
    standard error; writes <out>/parity_real_format[_partnet]_torch.json.

    python tools/parity_real_format_torch.py torch  [--dataset shapenet] [--seed S] [--device cpu]
    python tools/parity_real_format_torch.py report [--dataset shapenet] [--seeds 0 1]

--out defaults to logs/parity_real_format_torch (ignored by git), --data to
data/ (ignored by git); --epochs overrides the recipe's 80 for a short run.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

DEFAULT_OUT = os.path.join(ROOT, "logs", "parity_real_format_torch")
DEFAULT_DATA = os.path.join(ROOT, "data")
# hpcs_tpu's converged results on the same recipes, over 8 seeds
TPU_RESULTS = {"shapenet": os.path.join(ROOT, "benchmarks", "parity_real_format.json"),
               "partnet": os.path.join(ROOT, "benchmarks", "parity_real_format_partnet.json")}

# The canonical recipes (the reference's run_train.sh for ShapeNet, its
# PartNet Bottle config.yaml) scaled to the mini datasets: the recipes of
# tools/parity_real_format.py, unchanged.  ExpMap embedder (eucl == hyp),
# miner and CosFace on, SO(3) train and test rotation.
CFGS = {
    "shapenet": dict(
        npoints=256,
        batch_size=2,
        epochs=80,
        num_class=50,      # global ShapeNet part ids (labels here: 0-3, 6-7)
        num_categories=2,  # Airplane, Cap (the mini categories)
        class_choice=["Airplane", "Cap"],
        eucl_dim=16,
        hyp_dim=16,
        k=10,
        t_per_anchor=8,
        fraction=1.2,
        temperature=0.1,
        lr=0.05,
        margin=0.35,
        trade_off=0.1,
        train_rotation="so3",
        test_rotation="so3",
        seed=0,
    ),
    "partnet": dict(
        npoints=256,
        batch_size=2,
        epochs=80,
        category="Bottle",
        level=3,
        num_class=9,       # len(Bottle-level-3.txt) + 1, like the reference
        num_categories=1,  # dummy single category (partnet_hyp_hc.py:102)
        eucl_dim=16,
        hyp_dim=16,
        k=10,
        t_per_anchor=8,
        fraction=1.2,
        temperature=0.1,
        lr=0.05,
        margin=0.35,
        trade_off=0.1,
        train_rotation="so3",
        test_rotation="so3",
        seed=0,
    ),
}
RESULT_KEYS = ("decode_purity_mean", "decode_score_mean", "test_acc", "test_acc_nomargin",
               "test_iou", "train_wall_s")


def purity_score(y_true, y_pred):
    """Majority-vote purity (the reference's scores.py:202-226): each
    predicted cluster counts its most common true label, over all points."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    _, t = np.unique(y_true, return_inverse=True)
    correct = sum(int(np.bincount(t[y_pred == c]).max()) for c in np.unique(y_pred))
    return correct / len(y_true)


def run_tag(dataset):
    return "parity_rf_torch" if dataset == "shapenet" else "parity_rf_pn_torch"


def json_path(out, dataset, seed):
    return os.path.join(out, f"{run_tag(dataset)}_s{seed}.json")


def checkpoint_dir(out, dataset, seed):
    return os.path.join(out, f"{run_tag(dataset)}_s{seed}", "checkpoints", "final")


def report_path(out, dataset):
    tag = "" if dataset == "shapenet" else "_partnet"
    return os.path.join(out, f"parity_real_format{tag}_torch.json")


def _partnet_dirs(data):
    return (os.path.join(data, "PartNet", "sem_seg_h5"),
            os.path.join(data, "PartNet", "after_merging_label_ids"))


def _partnet_levels(h5_root, category):
    return [i + 1 for i in range(3)
            if os.path.exists(os.path.join(h5_root, f"{category}-{i + 1}", "train_files.txt"))]


def datasets(dataset, c, data=DEFAULT_DATA):
    """(train, val, test datasets, hierarchy list) of the recipe `c`,
    through the port's own readers."""
    from hpcs_torch.data import PartNetDataset, ShapeNetDataset, get_hierarchy_list

    if dataset == "shapenet":
        raw = os.path.join(data, "ShapeNet", "raw")
        sets = [ShapeNetDataset(raw, npoints=c["npoints"], split=s)
                for s in ("train", "val", "test")]
        return (*sets, ())
    h5_root, hier = _partnet_dirs(data)
    base = os.path.join(h5_root, f"{c['category']}-{c['level']}")
    sets = [PartNetDataset(os.path.join(base, f"{s}_files.txt"), c["npoints"])
            for s in ("train", "val", "test")]
    return (*sets, get_hierarchy_list(hier, c["category"], _partnet_levels(h5_root,
                                                                          c["category"])))


def make_config(dataset, c, hierarchy_list=()):
    """The ModelConfig of tools/parity_real_format.py's run for recipe `c`."""
    from hpcs_torch.cli import freeze_hierarchy
    from hpcs_torch.models import ModelConfig

    return ModelConfig(
        dataset=dataset, model_name="vn_dgcnn_partseg",
        num_class=c["num_class"], num_categories=c["num_categories"],
        fixed_points=c["npoints"], eucl_dim=c["eucl_dim"], hyp_dim=c["hyp_dim"], k=c["k"],
        t_per_anchor=c["t_per_anchor"], fraction=c["fraction"],
        num_triplets=c["npoints"] * c["batch_size"] * c["t_per_anchor"],
        temperature=c["temperature"], lr=c["lr"], margin=c["margin"],
        trade_off=c["trade_off"], miner=True, cosface=True,
        hierarchical=dataset == "partnet", hierarchy_list=freeze_hierarchy(hierarchy_list),
        train_rotation=c["train_rotation"], test_rotation=c["test_rotation"])


def evaluate(system, test_loader, seed, generator_device=None):
    """The test loop of tools/parity_real_format.py on the port: test_step
    on every batch (draws from a generator seeded seed + 777 on the
    system's device, or on `generator_device`), its loss, accuracy and
    IoU, the raw-cosine accuracy,
    each object's best-k score and the purity of the maxclust cut of its
    linkage at its true part count.  Returns their means and the object
    count."""
    import torch
    from scipy.cluster.hierarchy import fcluster

    from hpcs_torch.loss import cosface_logits

    generator = torch.Generator(device=generator_device or system.device).manual_seed(seed + 777)
    W = system.net.metric_hyp_loss["loss_cosface"].W
    scores, purities, tlosses, accs, accs_nm, ious = [], [], [], [], [], []
    for batch in test_loader:
        logs, extras = system.test_step(batch, generator)
        tlosses.append(float(logs["test_loss"]))
        accs.append(float(logs["test_acc"]))
        ious.append(float(logs["test_iou"]))
        x_p = extras["x_poincare"]
        flat = x_p.reshape(-1, x_p.shape[-1])
        labels_flat = torch.as_tensor(batch["labels"], device=x_p.device).reshape(-1).long()
        with torch.no_grad():
            raw = cosface_logits(W, flat, labels_flat, margin=0.0, scale=1.0)
        accs_nm.append(float((raw.argmax(-1) == labels_flat).float().mean()))
        Zs = extras["linkage"].cpu().numpy()
        bscores = extras["best_score"].cpu().numpy()
        for oi in range(Zs.shape[0]):
            scores.append(float(bscores[oi]))
            y = batch["labels"][oi]
            y_pred = fcluster(Zs[oi], len(np.unique(y)), criterion="maxclust") - 1
            purities.append(purity_score(y, y_pred))
    return {"test_loss": float(np.mean(tlosses)), "test_acc": float(np.mean(accs)),
            "test_iou": float(np.mean(ious)), "test_acc_nomargin": float(np.mean(accs_nm)),
            "decode_score_mean": float(np.mean(scores)),
            "decode_purity_mean": float(np.mean(purities)), "n_test_objects": len(scores)}


def run_torch(dataset="shapenet", seed=0, epochs=None, device="cuda", out=DEFAULT_OUT,
              data=DEFAULT_DATA, log=print):
    """Train one seed of the recipe on `device` with trainer.fit, save its
    checkpoint, test it (`evaluate`) and write its JSON.  The seed seeds
    the weights, the loader's shuffles and fit's draws.  Returns (the
    result dict, the trained system)."""
    import torch

    from hpcs_torch import trainer
    from hpcs_torch.data import DataLoader
    from hpcs_torch.models import HypHCSystem
    from hpcs_torch.utils.checkpoint import save_checkpoint

    c = dict(CFGS[dataset], seed=seed)
    if epochs is not None:
        c["epochs"] = epochs
    train_ds, val_ds, test_ds, hierarchy_list = datasets(dataset, c, data)
    cfg = make_config(dataset, c, hierarchy_list)
    system = HypHCSystem(cfg, device=device, generator=torch.Generator().manual_seed(seed))
    train_loader = DataLoader(train_ds, c["batch_size"], shuffle=True, seed=seed)
    val_loader = DataLoader(val_ds, c["batch_size"])
    test_loader = DataLoader(test_ds, c["batch_size"])
    name = f"{run_tag(dataset)}_s{seed}"
    t0 = time.time()
    trainer.fit(system, train_loader, val_loader, epochs=c["epochs"], patience=10 ** 6,
                seed=seed, log_dir=out, run_name=name, log=lambda line: None)
    if system.device.type == "cuda":
        torch.cuda.synchronize()
    train_wall = time.time() - t0
    ckpt = checkpoint_dir(out, dataset, seed)
    save_checkpoint(ckpt, system, cfg, c["epochs"])
    result = {"train_wall_s": train_wall, **evaluate(system, test_loader, seed),
              "epochs": c["epochs"], "device": str(system.device), "checkpoint": ckpt}
    with open(json_path(out, dataset, seed), "w") as f:
        json.dump(result, f, indent=1)
    log(f"[torch {dataset} s{seed}] {json.dumps(result)}")
    return result, system


def aggregate(values):
    """mean, std (ddof 1), stderr and the values of one metric over seeds."""
    std = float(np.std(values, ddof=1)) if len(values) > 1 else 0.0
    return {"mean": float(np.mean(values)), "std": std,
            "stderr": std / np.sqrt(len(values)) if len(values) > 1 else 0.0,
            "per_seed": list(values)}


def compare(port, tpu):
    """The delta of two aggregates and its z over the combined standard
    error, with tools/parity_real_format.py's verdict at |z| = 2."""
    d = port["mean"] - tpu["mean"]
    se = float(np.hypot(port["stderr"], tpu["stderr"]))
    z = d / se if se > 0 else 0.0
    return {"delta_port_minus_hpcs_tpu": d, "combined_stderr": se, "z": z,
            "verdict": ("port ahead (significant)" if z > 2 else
                        "hpcs_tpu ahead (significant)" if z < -2 else
                        "statistically indistinguishable (unpaired seeds, |z| < 2)")}


def report(dataset, seeds, out=DEFAULT_OUT):
    """The port's per-seed results (the JSONs under `out`) beside
    hpcs_tpu's recorded ones; writes and returns the comparison."""
    results, found = [], []
    for s in seeds:
        if os.path.exists(json_path(out, dataset, s)):
            with open(json_path(out, dataset, s)) as f:
                results.append(json.load(f))
            found.append(s)
    if not results:
        raise SystemExit("no per-seed results; run the torch stage first")
    with open(TPU_RESULTS[dataset]) as f:
        tpu = json.load(f)["hpcs_tpu"]
    port = {k: aggregate([r[k] for r in results]) for k in RESULT_KEYS}
    c = {k: v for k, v in CFGS[dataset].items() if k != "seed"}
    summary = {"description": f"The port's converged train + decode quality on the real "
                              f"{dataset} file format, seeds {found}, beside "
                              f"hpcs_tpu's ({os.path.relpath(TPU_RESULTS[dataset], ROOT)}).",
               "config": c, "seeds": found, "hpcs_torch": port,
               "hpcs_tpu": {k: tpu.get(k) for k in RESULT_KEYS},
               "purity": compare(port["decode_purity_mean"], tpu["decode_purity_mean"]),
               "score": compare(port["decode_score_mean"], tpu["decode_score_mean"])}
    os.makedirs(out, exist_ok=True)
    with open(report_path(out, dataset), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({"dataset": dataset, "purity": summary["purity"],
                      "score": summary["score"]}))
    print(f"wrote {report_path(out, dataset)}")
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("stage", choices=["torch", "report"])
    ap.add_argument("--dataset", choices=list(CFGS), default="shapenet")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1], help="seeds for report")
    ap.add_argument("--epochs", type=int, default=None,
                    help="override the recipe's 80 epochs (a short run)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=DEFAULT_OUT, help="output directory")
    ap.add_argument("--data", default=DEFAULT_DATA, help="root of the mini datasets")
    args = ap.parse_args(argv)
    if args.stage == "report":
        return report(args.dataset, args.seeds, args.out)
    os.makedirs(args.out, exist_ok=True)
    return run_torch(args.dataset, args.seed, args.epochs, args.device, args.out, args.data)[0]


if __name__ == "__main__":
    main()
