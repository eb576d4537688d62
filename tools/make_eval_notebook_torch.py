#!/usr/bin/env python
"""Write examples/shapenet_eval_torch.ipynb and partnet_eval_torch.ipynb:
the per-category evaluation notebooks (the reference's
notebooks/ShapeNet.ipynb and PartNet.ipynb deliverables) on the PyTorch
port, cell for cell the notebooks that tools/make_eval_notebook.py writes.

Each restores a checkpoint (the port's own, or hpcs_tpu's msgpack
model.ckpt or multi-process orbax directory: utils.checkpoint reads all
three), runs test_step's decode per category (ShapeNet: Airplane, Cap) or
on the test split (PartNet: Bottle, level 3), and shows per object the
5-panel hyperbolic evaluation figure, a part-label confusion matrix of the
CosFace predictions and a score table; the ShapeNet notebook ends with a
precision-recall curve.

- The device: the setup cell's DEVICE is 'cuda' ('cpu' with --device cpu);
  without a GPU and without 'cpu' the notebook raises rather than carrying on.
- From a clean clone each notebook writes its mini dataset
  (tools/make_mini_datasets_torch.py) and trains its checkpoint
  (tools/parity_real_format_torch.py, seed 0, the recipe's 80 epochs) when
  they are absent, under data/ and logs/ (both ignored by git).
- Figures need matplotlib and are drawn only with PLOT = True; the summary
  is plain Python; the precision-recall cell needs sklearn and matplotlib
  and runs on the CPU only.  PartNet's h5 files are read and written by the
  port's own HDF5 code (hpcs_torch.utils.hdf5).  The card's machine has
  none of matplotlib, pandas, sklearn or h5py: there the ShapeNet notebook
  runs every cell but the precision-recall cell and the PartNet notebook
  every cell, with PLOT = False.

Usage: python tools/make_eval_notebook_torch.py [--dataset shapenet|partnet]
           [--ckpt DIR] [--device cpu] [--execute]
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# where tools/parity_real_format_torch.py's torch stage writes seed 0's
# checkpoint by default, relative to examples/
DEFAULT_CKPT = {
    "shapenet": os.path.join("..", "logs", "parity_real_format_torch", "parity_rf_torch_s0",
                             "checkpoints", "final"),
    "partnet": os.path.join("..", "logs", "parity_real_format_torch", "parity_rf_pn_torch_s0",
                            "checkpoints", "final"),
}
OUT = {"shapenet": os.path.join(ROOT, "examples", "shapenet_eval_torch.ipynb"),
       "partnet": os.path.join(ROOT, "examples", "partnet_eval_torch.ipynb")}


def code(src):
    return {"cell_type": "code", "execution_count": None, "metadata": {},
            "outputs": [], "source": src}


def md(src):
    return {"cell_type": "markdown", "metadata": {}, "source": src}


def code_cells(nb):
    """The notebook's code cells' sources, in order, without IPython magics
    (lines starting with %): what runs them outside Jupyter executes."""
    return ["\n".join(line for line in "".join(c["source"]).splitlines()
                      if not line.lstrip().startswith("%"))
            for c in nb["cells"] if c["cell_type"] == "code"]


# the setup cells' shared bootstrap: data and checkpoint when absent
BOOTSTRAP = '''\
# Bootstrap from a clean clone: write the format-exact mini dataset if it is
# absent, then train the checkpoint with the recipe of
# tools/parity_real_format_torch.py (seed 0, 80 epochs) on DEVICE.
import shutil, subprocess
_ROOT = os.path.abspath('..')
if not os.path.exists(%DATA%):
    subprocess.run([sys.executable, 'tools/make_mini_datasets_torch.py', 'data',
                    '--datasets', '%DATASET%'], cwd=_ROOT, check=True)
if not os.path.exists(os.path.join(CKPT, 'config.json')):
    print('checkpoint missing - training it now (a few minutes)...')
    _out = os.path.join(_ROOT, 'logs', 'parity_real_format_torch')
    subprocess.run([sys.executable, 'tools/parity_real_format_torch.py', 'torch',
                    '--dataset', '%DATASET%', '--seed', '0', '--device', str(device),
                    '--out', _out], cwd=_ROOT, check=True)
    _final = os.path.join(_out, '%TAG%_s0', 'checkpoints', 'final')
    if os.path.abspath(_final) != CKPT:
        os.makedirs(CKPT, exist_ok=True)
        for _f in os.listdir(_final):
            shutil.copy(os.path.join(_final, _f), CKPT)
'''

CELL_SETUP = '''\
%matplotlib inline
# Per-category evaluation on mini-ShapeNet (real txt format), on the
# PyTorch port.  Mirrors the reference's notebooks/ShapeNet.ipynb: restore a
# trained checkpoint, evaluate + render predictions per category.
import os, sys
sys.path.insert(0, os.path.abspath('..'))  # executes from examples/
import numpy as np
import torch

from hpcs_torch import resolve_device
from hpcs_torch.data import DataLoader, ShapeNetDataset
from hpcs_torch.models import HypHCSystem, ModelConfig, decode_vector_for_batch
from hpcs_torch.utils.checkpoint import load_config, restore_checkpoint

DEVICE = '%DEVICE%'  # 'cuda' raises without a GPU: write 'cpu' to run on the CPU
PLOT = True  # the figures need matplotlib
CKPT = os.path.abspath('%CKPT%')
RAW = os.path.abspath(os.path.join('..', 'data', 'ShapeNet', 'raw'))
NPOINTS, BATCH = 256, 2
device = resolve_device(DEVICE)

%BOOTSTRAP%
cfg_dict = load_config(CKPT)
cfg_dict['hierarchy_list'] = ()
cfg = ModelConfig(**cfg_dict)
system = HypHCSystem(cfg, device=device)
restore_checkpoint(CKPT, system)
print('restored config:', {k: cfg_dict[k] for k in
      ('model_name', 'eucl_dim', 'hyp_dim', 'num_class', 'k')}, 'on', device)
'''

# the helpers' shared per-batch decode: rows, the confusion matrix's inputs
# and the panels of the first two objects
EVAL_LOOP = '''\
    rows, n_shown = [], 0
    y_all, yhat_all = [], []
    # draws (rotations, triplets) on the CPU, so the card and the CPU
    # evaluate the same rotated clouds
    generator = torch.Generator().manual_seed(7)
    W = system.net.metric_hyp_loss['loss_cosface'].W
    for bi, batch in enumerate(loader):
        logs, extras = system.test_step(batch, generator)
        # CosFace class predictions for the part-label confusion matrix
        flat = extras['x_poincare'].reshape(-1, extras['x_poincare'].shape[-1])
        labels = torch.as_tensor(batch['labels'], device=system.device).reshape(-1)
        with torch.no_grad():
            logits = get_logits(system.loss_cfg, W, flat, labels)
        yhat = logits.argmax(-1).reshape(batch['labels'].shape).cpu().numpy()
        for oi in range(batch['points'].shape[0]):
            if len(rows) >= max_objects:
                break
            y = batch['labels'][oi]
            rows.append(dict(%ROW_KEY%, best_k=int(extras['best_k'][oi]),
                             true_parts=len(np.unique(y)),
                             score=float(extras['best_score'][oi])))
            y_all.append(y); yhat_all.append(yhat[oi])
            if plot and n_shown < 2:
                fig = plot_hyperbolic_eval(
                    x=batch['points'][oi], y=y,
                    y_pred=extras['pred'][oi].cpu().numpy(),
                    emb_hidden=extras['x_euclidean'][oi].cpu().numpy(),
                    emb_poincare=extras['x_poincare'][oi].cpu().numpy(),
                    linkage_matrix=extras['linkage'][oi].cpu().numpy(),
                    k=int(extras['best_k'][oi]),
                    score=float(extras['best_score'][oi]), show=True)
                plt.show()
                n_shown += 1
    y_cat = np.concatenate(y_all); yhat_cat = np.concatenate(yhat_all)
    parts = np.unique(np.concatenate([y_cat, yhat_cat]))
    lut = {p: i for i, p in enumerate(parts)}
    cm = np.zeros((len(parts), len(parts)), int)
    for t, p in zip(y_cat, yhat_cat):
        cm[lut[t], lut[p]] += 1
    confusion[%CM_KEY%] = (parts, cm)
    if plot:
        fig = plot_confusion_matrix(cm, classes=[f'part {p}' for p in parts],
                                    normalize=True, figsize=(5, 5),
                                    title=%CM_TITLE%)
        plt.show()
    return rows
'''

CELL_HELPERS = '''\
from hpcs_torch.loss import get_logits
from hpcs_torch.utils.viz import (plot_confusion_matrix, plot_hyperbolic_eval,
                                  plot_precision_recall_curve)

confusion = {}  # category -> (part ids, confusion matrix of the CosFace predictions)

def evaluate_category(category, max_objects=4, plot=True):
    """Run the full decode test path on one category's test split; returns
    per-object rows and renders the reference's per-object panels (with
    plot; matplotlib is imported only then)."""
    if plot:
        import matplotlib.pyplot as plt
    ds = ShapeNetDataset(RAW, npoints=NPOINTS, split='test',
                         class_choice=category)
    loader = DataLoader(ds, BATCH)
''' + EVAL_LOOP.replace("%ROW_KEY%", "category=category").replace(
    "%CM_KEY%", "category").replace(
    "%CM_TITLE%", "f'{category}: part label confusion '\n"
                  "                                          '(CosFace preds)'")

CELL_SUMMARY = '''\
# The per-category table in plain Python (no pandas, so it also runs on the
# card's machine): objects, mean best k, mean true parts, mean score.
per_cat = {}
for r in all_rows:
    per_cat.setdefault(r['category'], []).append(r)
per_cat = {c: dict(objects=len(rs),
                   mean_best_k=float(np.mean([r['best_k'] for r in rs])),
                   mean_true_parts=float(np.mean([r['true_parts'] for r in rs])),
                   mean_score=float(np.mean([r['score'] for r in rs])))
           for c, rs in sorted(per_cat.items())}
print(f"{'category':<10}{'objects':>8}{'mean_best_k':>13}{'mean_true_parts':>17}"
      f"{'mean_score':>12}")
for c, s in per_cat.items():
    print(f"{c:<10}{s['objects']:>8}{s['mean_best_k']:>13.4f}{s['mean_true_parts']:>17.4f}"
          f"{s['mean_score']:>12.6f}")
overall = float(np.mean([r['score'] for r in all_rows]))
print(f"\\noverall decode score (mean best-k IoU): {overall:.4f}")
'''

CELL_PR = '''\
# Precision-recall of the most frequent part class from the CosFace logits
# (exercises plot_precision_recall_curve, reference viz.py:444-468).
# Needs sklearn and matplotlib: runs on the CPU machine only.
import matplotlib.pyplot as plt
from sklearn.metrics import precision_recall_curve
ds = ShapeNetDataset(RAW, npoints=NPOINTS, split='test')
batch = next(iter(DataLoader(ds, 4)))
_, xp = system.embed(batch['points'], decode_vector_for_batch(cfg, batch))
flat = xp.reshape(-1, xp.shape[-1])
labels = torch.as_tensor(batch['labels'], device=system.device).reshape(-1)
with torch.no_grad():
    logits = get_logits(system.loss_cfg, system.net.metric_hyp_loss['loss_cosface'].W,
                        flat, labels).cpu().numpy()
labels = labels.cpu().numpy()
probs = np.exp(logits - logits.max(-1, keepdims=True))
probs /= probs.sum(-1, keepdims=True)
top = int(np.bincount(labels).argmax())
prec, rec, _ = precision_recall_curve((labels == top).astype(int), probs[:, top])
fig = plot_precision_recall_curve(prec, rec, figsize=(5, 5),
                                  xlim=[0, 1], ylim=[0, 1],
                                  title=f'part {top} PR')
plt.show()
'''

CELL_SETUP_PARTNET = '''\
%matplotlib inline
# Per-category evaluation on mini-PartNet (real h5 format, read without
# h5py) - the reference's notebooks/PartNet.ipynb deliverable on the
# PyTorch port.
import os, sys
sys.path.insert(0, os.path.abspath('..'))  # executes from examples/
import numpy as np
import torch

from hpcs_torch import resolve_device
from hpcs_torch.cli import freeze_hierarchy
from hpcs_torch.data import DataLoader, PartNetDataset
from hpcs_torch.models import HypHCSystem, ModelConfig
from hpcs_torch.utils.checkpoint import load_config, restore_checkpoint

DEVICE = '%DEVICE%'  # 'cuda' raises without a GPU: write 'cpu' to run on the CPU
PLOT = True  # the figures need matplotlib
CKPT = os.path.abspath('%CKPT%')
H5 = os.path.abspath(os.path.join('..', 'data', 'PartNet', 'sem_seg_h5',
                                  'Bottle-3'))
NPOINTS, BATCH = 256, 2
device = resolve_device(DEVICE)

%BOOTSTRAP%
cfg_dict = load_config(CKPT)
cfg_dict['hierarchy_list'] = freeze_hierarchy(cfg_dict.get('hierarchy_list', ()))
cfg = ModelConfig(**cfg_dict)
system = HypHCSystem(cfg, device=device)
restore_checkpoint(CKPT, system)
print('restored config:', {k: cfg_dict[k] for k in
      ('model_name', 'dataset', 'eucl_dim', 'hyp_dim', 'num_class', 'k',
       'hierarchical')}, 'on', device)
'''

CELL_HELPERS_PARTNET = '''\
from hpcs_torch.loss import get_logits
from hpcs_torch.utils.viz import plot_confusion_matrix, plot_hyperbolic_eval

confusion = {}  # split -> (part ids, confusion matrix of the CosFace predictions)

def evaluate_split(split='test', max_objects=4, plot=True):
    if plot:
        import matplotlib.pyplot as plt
    ds = PartNetDataset(os.path.join(H5, f'{split}_files.txt'), NPOINTS)
    loader = DataLoader(ds, BATCH)
''' + EVAL_LOOP.replace("%ROW_KEY%", "split=split").replace("%CM_KEY%", "split").replace(
    "%CM_TITLE%", "'Bottle level-3: part confusion '\n"
                  "                                          '(CosFace preds)'")

CELL_SUMMARY_PARTNET = '''\
# The per-object table in plain Python (no pandas)
print(f"{'split':<6}{'best_k':>7}{'true_parts':>11}{'score':>10}")
for r in all_rows:
    print(f"{r['split']:<6}{r['best_k']:>7}{r['true_parts']:>11}{r['score']:>10.6f}")
mean_score = float(np.mean([r['score'] for r in all_rows]))
print(f"\\nmean decode score (best-k IoU): {mean_score:.4f}")
'''

METADATA = {"kernelspec": {"display_name": "Python 3", "language": "python",
                           "name": "python3"},
            "language_info": {"name": "python"}}


def _setup(cell, ckpt, device, dataset, data, tag):
    boot = (BOOTSTRAP.replace("%DATA%", data).replace("%DATASET%", dataset)
            .replace("%TAG%", tag))
    return (cell.replace("%CKPT%", ckpt).replace("%DEVICE%", device)
            .replace("%BOOTSTRAP%", boot))


def build(ckpt=DEFAULT_CKPT["shapenet"], device="cuda"):
    """The ShapeNet notebook (a dict in nbformat 4) on checkpoint `ckpt`
    (relative to examples/ or absolute) and `device`."""
    cells = [
        md("# Per-category evaluation — mini-ShapeNet, on the PyTorch port\n\n"
           "The reference's `notebooks/ShapeNet.ipynb` deliverable "
           "(restore checkpoint → per-category predictions) on `hpcs_torch`: "
           "a checkpoint trained to convergence by "
           "`tools/parity_real_format_torch.py` on the real-format mini-ShapeNet "
           "under `data/ShapeNet/raw` (both made here when absent), or any "
           "checkpoint the port reads, `hpcs_tpu`'s included.  Per category: "
           "5-panel hyperbolic eval per object, part-label confusion matrix, "
           "score table.  `DEVICE` is the card unless set to `'cpu'`; `PLOT` "
           "needs matplotlib."),
        code(_setup(CELL_SETUP, ckpt, device, "shapenet", "RAW", "parity_rf_torch")),
        code(CELL_HELPERS),
        md("## Airplane"),
        code("all_rows = []\nall_rows += evaluate_category('Airplane', plot=PLOT)"),
        md("## Cap"),
        code("all_rows += evaluate_category('Cap', plot=PLOT)"),
        md("## Summary"),
        code(CELL_SUMMARY),
        md("## Precision-recall helper\n\n"
           "CPU only: this cell needs sklearn and matplotlib, which the GPU "
           "machine does not have."),
        code(CELL_PR),
    ]
    return {"cells": cells, "metadata": METADATA, "nbformat": 4, "nbformat_minor": 5}


def build_partnet(ckpt=DEFAULT_CKPT["partnet"], device="cuda"):
    """The PartNet notebook on checkpoint `ckpt` and `device`."""
    cells = [
        md("# Per-category evaluation — mini-PartNet (Bottle, level 3), on the "
           "PyTorch port\n\n"
           "The reference's `notebooks/PartNet.ipynb` deliverable on "
           "`hpcs_torch`: restore a converged checkpoint (hierarchical CosFace + "
           "HypHC loss, trained by `tools/parity_real_format_torch.py --dataset "
           "partnet`; both it and the data are made here when absent), render "
           "per-object hyperbolic eval panels, part confusion, score table.  "
           "`DEVICE` is the card unless set to `'cpu'`; `PLOT` needs matplotlib."),
        code(_setup(CELL_SETUP_PARTNET, ckpt, device, "partnet", "H5", "parity_rf_pn_torch")),
        code(CELL_HELPERS_PARTNET),
        md("## Bottle — test split"),
        code("all_rows = []\nall_rows += evaluate_split('test', plot=PLOT)"),
        md("## Summary"),
        code(CELL_SUMMARY_PARTNET),
    ]
    return {"cells": cells, "metadata": METADATA, "nbformat": 4, "nbformat_minor": 5}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", default=None, help="checkpoint dir (relative to examples/)")
    ap.add_argument("--dataset", default="shapenet", choices=["shapenet", "partnet"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the setup cell's DEVICE")
    ap.add_argument("--execute", action="store_true",
                    help="run it in place with jupyter nbconvert")
    args = ap.parse_args(argv)

    ckpt = args.ckpt or DEFAULT_CKPT[args.dataset]
    make = build if args.dataset == "shapenet" else build_partnet
    out = OUT[args.dataset]
    with open(out, "w") as f:
        json.dump(make(ckpt, args.device), f, indent=1)
        f.write("\n")
    print(f"wrote {out}")
    if args.execute:
        import subprocess

        subprocess.run([sys.executable, "-m", "jupyter", "nbconvert", "--to", "notebook",
                        "--execute", "--inplace", "--ExecutePreprocessor.timeout=1800", out],
                       cwd=os.path.join(ROOT, "examples"), check=True)
        print("executed in place")


if __name__ == "__main__":
    main()
