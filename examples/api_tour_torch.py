#!/usr/bin/env python
"""API tour of the PyTorch port: the library layers without the CLI.

The counterpart of examples/api_tour.py on hpcs_torch, at its sizes, on
procedural clouds.  Walks geometry -> backbone -> loss -> training ->
decode, printing shapes and scores at each step.  Runs on CUDA unless
--device cpu.

    python examples/api_tour_torch.py [--device cuda|cpu] [--epochs 80]

`main(argv)` returns the trained system and each section's results.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch

from hpcs_torch.data import DataLoader, SyntheticPartDataset
from hpcs_torch.decode import get_optimal_k, linkage
from hpcs_torch.geometry import expmap0, hyp_dist_o, hyp_lca
from hpcs_torch.loss.hyphc import normalize_to_radius
from hpcs_torch.models import HypHCSystem, ModelConfig

CONFIG = dict(dataset="shapenet", num_class=6, num_categories=2, fixed_points=128, eucl_dim=8,
              hyp_dim=8, k=10, temperature=0.1, t_per_anchor=20, lr=0.05, trade_off=0.1,
              num_triplets=8192)


def geometry(u):
    """1. Points on the Poincare ball from tangent vectors u [n, 2] at the
    origin: the points, their norms, the LCA depth of the first pair and
    each point's depth from the origin."""
    x = expmap0(u)
    out = dict(x=x, norms=x.norm(dim=-1),
               lca_depth=float(hyp_lca(x[0], x[1], return_coord=False)[0]),
               depth=hyp_dist_o(x)[:, 0])
    print("ball points:", tuple(x.shape), "norms:", out["norms"])
    print("LCA depth of first pair:", out["lca_depth"])
    print("depth from origin:", out["depth"])
    return out


def build(device, **over):
    """2. A system (backbone + embedder + losses) and a loader of 16
    synthetic clouds; `over` replaces CONFIG's fields."""
    cfg = ModelConfig(**{**CONFIG, **over})
    system = HypHCSystem(cfg, device=device)
    ds = SyntheticPartDataset(num_objects=16, npoints=cfg.fixed_points, num_categories=2,
                              parts_per_object=3)
    loader = DataLoader(ds, batch_size=4, shuffle=True, drop_last=True)
    print("params:", sum(p.numel() for p in system.net.parameters()), "weights")
    return system, loader


def train(system, loader, epochs, generator):
    """3. `epochs` epochs of training steps; returns the last step's logs."""
    logs = {}
    for _ in range(epochs):
        for b in loader:
            logs = system.train_step(b, generator)
    logs = {k: float(v) for k, v in logs.items()}
    print(f"after training: total_loss={logs.get('total_loss', float('nan')):.3f} "
          f"acc={logs.get('acc', 0):.3f}")
    return logs


def decode(system, batch, generator):
    """4. The decode on the system's device: test_step's mean best-k IoU
    score, then object 0 by hand (its embedding on the sphere of the
    learnt radius, complete linkage of cosine distances, the best cut)."""
    logs, extras = system.test_step(batch, generator)
    score = float(logs["score"])
    print(f"decode: mean best-k IoU score={score:.3f}")
    emb = normalize_to_radius(extras["x_poincare"][0], system.net.scale[0].detach())
    Z = linkage(emb[None], method="complete", metric="cosine")
    labels = torch.as_tensor(batch["labels"][0], device=system.device)[None]
    pred, k, best = get_optimal_k(labels, Z, num_class=system.cfg.num_class)
    print(f"object 0: best k={int(k[0])}, score={float(best[0]):.3f}")
    return dict(score=score, logs={k: float(v) for k, v in logs.items()}, extras=extras,
                pred=pred[0], best_k=int(k[0]), best_score=float(best[0]), linkage=Z[0])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda | cpu")
    ap.add_argument("--epochs", type=int, default=80)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    generator = torch.Generator(device=device).manual_seed(0)

    u = torch.randn(4, 2, generator=generator, device=device) * 0.5
    geo = geometry(u)
    system, loader = build(device)
    batch = next(iter(loader))
    logs = train(system, loader, args.epochs, generator)
    dec = decode(system, batch, generator)
    return dict(system=system, geometry=geo, train_logs=logs, decode=dec)


if __name__ == "__main__":
    main()
