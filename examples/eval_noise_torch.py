#!/usr/bin/env python
"""Noise-robustness toy harness of the PyTorch port (reference
hpcs/utils/viz.py:470-523).

The counterpart of examples/eval_noise.py on hpcs_torch, with its sizes
and defaults.  Sweeps additive jitter over synthetic multi-part clouds,
decodes each with the linkage + best-k sweep of test_step on the device,
and saves a panel figure: ground truth, prediction, Poincare-disk
embedding, and the scores in the title.  Runs on CUDA unless --device cpu.

Usage:
    python examples/eval_noise_torch.py [--ckpt DIR] [--out eval_noise.png] [--device cpu]

--ckpt takes any checkpoint the port reads (utils.checkpoint): its own,
the JAX package's msgpack model.ckpt or its multi-process orbax directory.
Without --ckpt it evaluates an untrained model (the decode pipeline still
runs end to end; scores reflect random features, as in the reference's
toy).  --out "" skips the figure; a figure needs matplotlib.

`main(argv)` returns one dict per noise: noise, best_k, score, test_loss,
and the object's pred, x_euclidean and x_poincare on the CPU.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import torch

from hpcs_torch.data import SyntheticPartDataset
from hpcs_torch.models import HypHCSystem, ModelConfig
from hpcs_torch.utils.checkpoint import restore_checkpoint


def evaluate(system, npoints, noises):
    """test_step on one synthetic object at each jitter in `noises`."""
    results = []
    for r, noise in enumerate(noises):
        ds = SyntheticPartDataset(num_objects=1, npoints=npoints, num_categories=2,
                                  parts_per_object=3, seed=17, jitter=noise)
        pts, cat, seg = ds[0]
        batch = {"points": pts[None], "labels": seg[None].astype(np.int32),
                 "category": np.asarray([cat], np.int32)}
        generator = torch.Generator(device=system.device).manual_seed(r)
        logs, extras = system.test_step(batch, generator)
        out = dict(noise=noise, best_k=int(extras["best_k"][0]),
                   score=float(extras["best_score"][0]), test_loss=float(logs["test_loss"]),
                   points=pts, labels=seg,
                   **{k: extras[k][0].cpu() for k in ("pred", "x_euclidean", "x_poincare")})
        results.append(out)
        print(f"noise {noise:.2f}: best_k={out['best_k']} score={out['score']:.3f} "
              f"test_loss={out['test_loss']:.3f}")
    return results


def plot(results, out):
    """The panel figure of `results` (evaluate's), saved to `out`."""
    from hpcs_torch.utils.viz import require_matplotlib

    require_matplotlib("the eval_noise figure")
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(len(results), 3, figsize=(12, 3.4 * len(results)), squeeze=False)
    for r, res in enumerate(results):
        pts, seg, pred = res["points"], res["labels"], res["pred"].numpy()
        for c, (colors, title) in enumerate([
            (seg, f"ground truth (noise {res['noise']:.2f})"),
            (pred, f"prediction: {res['best_k']} clusters, IoU {res['score']:.2f}"),
        ]):
            ax = axes[r, c]
            ax.scatter(pts[:, 0], pts[:, 1], c=colors, s=4, cmap="tab10")
            ax.set_title(title, fontsize=9)
            ax.set_aspect("equal")
            ax.axis("off")
        ax = axes[r, 2]
        emb = res["x_poincare"].numpy()
        e2 = emb[:, :2] / (np.linalg.norm(emb, axis=1, keepdims=True).max() + 1e-9)
        ax.scatter(e2[:, 0], e2[:, 1], c=pred, s=4, cmap="tab10")
        ax.add_patch(plt.Circle((0, 0), 1.0, fill=False, lw=0.5))
        ax.set_xlim(-1.1, 1.1)
        ax.set_ylim(-1.1, 1.1)
        ax.set_title("Poincare embedding (first 2 dims)", fontsize=9)
        ax.axis("off")
    fig.suptitle("decode robustness vs input jitter "
                 f"(scores: {['%.2f' % r['score'] for r in results]})")
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    plt.close(fig)
    print(f"wrote {out}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", default="", help="checkpoint dir (utils.checkpoint)")
    ap.add_argument("--out", default="eval_noise.png", help='the figure; "" for none')
    ap.add_argument("--npoints", type=int, default=256)
    ap.add_argument("--noises", type=float, nargs="+", default=[0.0, 0.04, 0.08, 0.12, 0.16])
    ap.add_argument("--device", default="cuda", help="cuda | cpu")
    args = ap.parse_args(argv)
    if args.out:  # before any work, as the CLI's --plot_inference
        from hpcs_torch.utils.viz import require_matplotlib

        require_matplotlib("the eval_noise figure (--out \"\" skips it)")

    cfg = ModelConfig(dataset="shapenet", num_class=6, num_categories=2,
                      fixed_points=args.npoints, eucl_dim=8, hyp_dim=8, k=10, t_per_anchor=8,
                      num_triplets=4096, temperature=0.1, test_rotation="none")
    system = HypHCSystem(cfg, device=args.device)
    if args.ckpt:
        restore_checkpoint(args.ckpt, system)
    results = evaluate(system, args.npoints, args.noises)
    if args.out:
        plot(results, args.out)
    return results


if __name__ == "__main__":
    main()
