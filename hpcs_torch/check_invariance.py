"""SO(3) rotation invariance of the port's embeddings:
`python -m hpcs_torch.check_invariance [flags]`, the counterpart of the
JAX package's tools/check_invariance.py, with its flags, default
configuration and printed lines.

A batch of --batch synthetic clouds of --fixed_points points (4
categories) is embedded by HypHCSystem.embed (kernels B1 and B2 on the
GPU), then each of --rotations random rotations of it (one per cloud,
drawn from a torch.Generator seeded with --seed).  It prints the embedding
scale (max |f| of the Euclidean features), the max and median over the
rotations of the largest absolute deviation from the unrotated embedding,
and the share of points whose kNN neighbour set (`ops.knn.knn`, kernel B1)
on the rotated cloud equals the one on the cloud itself, at worst over the
rotations.  The verdict holds the max deviation to the JAX tool's
tolerance relative to the scale: 0.15 in bf16, else 2e-3 on the CPU and
8e-3 on an accelerator; the exit code is 0 on PASS.

Without --model_path the system is the JAX tool's default (ShapeNet-style
conditioning on 4 categories, 12 classes, eucl = hyp = 32, --k, --bf16)
with random weights from --seed; with one, its config.json and weights (a
checkpoint of the port, of the JAX package, or imported from a reference
Lightning file: utils.checkpoint.restore_checkpoint).  The run goes on
CUDA unless --accelerator cpu.

    python -m hpcs_torch.check_invariance --rotations 8 --batch 16 --fixed_points 1024
"""
import argparse

import torch

from .cli import select_device
from .data import SyntheticPartDataset
from .models import HypHCSystem, ModelConfig, decode_vector_for_batch
from .ops.knn import knn
from .utils.checkpoint import load_config, restore_checkpoint
from .utils.rotations import random_so3, rotate_cloud


def draw_rotations(generator, count, batch):
    """`count` draws of `batch` random rotations: [count, batch, 3, 3]."""
    return torch.stack([random_so3(generator, batch) for _ in range(count)])


def measure(system, points, decode_vector, rotations, k):
    """Embed `points` [B, N, 3] and each rotation of them (`rotations`
    [R, B, 3, 3], one matrix per cloud).  Returns {"scale": max |x_e|,
    "deviations": [max |x_e(rotated) - x_e| per rotation], "graph_same":
    [share of points whose k-neighbour set is unchanged, per rotation]},
    and both per cloud: "cloud_deviations" and "cloud_graph_same", [R][B]."""
    points = torch.as_tensor(points, dtype=torch.float32, device=system.device).contiguous()
    base, _ = system.embed(points, decode_vector)
    graph0 = torch.sort(knn(points, k), dim=-1).values
    clouds, same = [], []
    for R in rotations:
        rotated = rotate_cloud(points, R).contiguous()
        out, _ = system.embed(rotated, decode_vector)
        clouds.append((out - base).abs().amax(dim=(1, 2)).tolist())
        graph = torch.sort(knn(rotated, k), dim=-1).values
        same.append((graph == graph0).all(-1).float().mean(-1).tolist())
    return {"scale": float(base.abs().max()), "deviations": [max(c) for c in clouds],
            "graph_same": [sum(s) / len(s) for s in same], "cloud_deviations": clouds,
            "cloud_graph_same": same}


def _parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model_path", default=None, help="checkpoint dir (default: fresh init)")
    ap.add_argument("--rotations", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--fixed_points", type=int, default=512)
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--seed", type=int, default=0, help="weights, clouds' order and rotations")
    ap.add_argument("--accelerator", default="cuda", help="cuda | gpu | cpu")
    return ap.parse_args(argv)


def run(argv=None):
    """Measure as the command line `argv` asks and print the report;
    returns measure's dict with "rel_tol", "verdict", "max_deviation" and
    "median_deviation" (absolute) and "graph_stability" added."""
    args = _parse(argv)
    device = select_device(args.accelerator)
    if args.model_path:
        cfg_dict = load_config(args.model_path)
        cfg_dict["hierarchy_list"] = ()
        cfg = ModelConfig(**cfg_dict)
    else:
        cfg = ModelConfig(dataset="shapenet", num_class=12, num_categories=4,
                          fixed_points=args.fixed_points, eucl_dim=32, hyp_dim=32, k=args.k,
                          bf16=args.bf16)
    system = HypHCSystem(cfg, device=device, generator=torch.Generator().manual_seed(args.seed))
    if args.model_path:
        restore_checkpoint(args.model_path, system)
    ds = SyntheticPartDataset(num_objects=args.batch, npoints=cfg.fixed_points,
                              num_categories=min(4, cfg.num_categories))
    points, category, seg = ds.batch(0, args.batch)
    dv = decode_vector_for_batch(cfg, {"points": points, "category": category, "labels": seg})
    rotations = draw_rotations(torch.Generator().manual_seed(args.seed), args.rotations,
                               args.batch)
    out = measure(system, points, dv, rotations, cfg.k)
    devs = sorted(out["deviations"])
    scale = out["scale"]
    out.update(max_deviation=devs[-1], median_deviation=devs[len(devs) // 2],
               graph_stability=min(out["graph_same"]))
    print(f"embedding scale (max |f|): {scale:.4f}")
    print(f"max abs deviation over {args.rotations} rotations: {devs[-1]:.3e} "
          f"({devs[-1] / scale * 100:.4f}% relative)")
    print(f"median abs deviation: {devs[len(devs) // 2]:.3e}")
    print(f"kNN graph stability: {min(out['graph_same']) * 100:.2f}% identical neighbor sets")
    out["rel_tol"] = 0.15 if args.bf16 or cfg.bf16 else 2e-3 if device.type == "cpu" else 8e-3
    out["verdict"] = "PASS" if devs[-1] < out["rel_tol"] * scale else "FAIL"
    print(f"invariance ({device.type}, rel tolerance {out['rel_tol']}): {out['verdict']}",
          flush=True)
    return out


def main(argv=None):
    return 0 if run(argv)["verdict"] == "PASS" else 1


if __name__ == "__main__":
    raise SystemExit(main())
