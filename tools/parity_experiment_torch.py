#!/usr/bin/env python
"""The quality-parity experiment of tools/parity_experiment.py on the
PyTorch port: the same synthetic data, recipe and seeds, trained and
served by hpcs_torch (on the card unless --device cpu), set beside
hpcs_tpu's and the reference's stored runs.

Stages:
  data: the split arrays, built with hpcs_torch.data.SyntheticPartDataset
    from CFG's seed and sliced as make_data slices them; where
    benchmarks/_parity_data.npz exists they must equal it.
  torch: train one seed with hpcs_torch.trainer.fit (shuffled training
    batches from default_rng(seed), unshuffled validation and test, patience
    10**6, a MetricLogger run directory), then test_step over the test
    batches from a generator seeded seed + 777 (parity_real_format_torch.
    evaluate: each object's best-k score and the majority-vote purity of
    scipy's fcluster(Z, k_true, "maxclust") cut).  Writes
    <out>/parity_torch[_s<seed>].json with run_jax's keys, kernels B1's and
    B2's launches, the device and, on the card, its name and power limit.
    run_jax reads its training curve from a `total_loss` column, which its
    logger names `train_total_loss` (its stored curves are empty); this
    stage reads `train_total_loss`.
  decode: the deterministic half on the port's decode, on hpcs_tpu's stored
    embeddings of each seed (benchmarks/_parity_jax_embeddings[_s<seed>].npz):
    per object the leaves on the sphere of radius scale clamped into the
    ball (decode_leaves: project(normalize_to_radius(x, scale)) with exactly
    rounded norms, what test_step decodes), cosine distances, complete
    linkage by MNN rounds, the best-k sweep (IoU) and the purity of the cut
    at the true part count; each seed's mean score held within SCORE_ATOL
    and its mean purity equal to that seed's stored decode_score_mean and
    decode_purity_mean (_parity_jax[_s<seed>].json).  Seed 0 is also set
    beside _parity_decode.json's tpu_score_mean and tpu_purity_mean, which
    hpcs_tpu's decode gave on an earlier seed-0 run's embeddings (its own
    decode of the stored ones gives the _parity_jax.json means): reported,
    not held.  Writes <out>/decode_torch.json.
  report: the port's seeds beside hpcs_tpu's 5 and the reference's 5
    (benchmarks/_parity_{jax,ref}[_s<seed>].json, only read): mean, std
    (ddof 1), standard error, the delta and z = delta / combined standard
    error for purity, score, test_acc, test_iou and test_loss, and
    tools/parity_experiment.py's three verdicts computed as report() does
    them (its run noise from std with ddof 0), with the port in hpcs_tpu's
    place, then against hpcs_tpu; writes <out>/parity_vs_reference_torch.json.

    python tools/parity_experiment_torch.py data
    python tools/parity_experiment_torch.py torch  [--seed S] [--epochs E] [--device cpu]
                                                   [--draws cpu]
    python tools/parity_experiment_torch.py decode [--seeds 0 1 2 3 4] [--device cpu]
    python tools/parity_experiment_torch.py report [--seeds 0 1 2 3 4]

--out defaults to logs/parity_experiment_torch (ignored by git); nothing is
written under benchmarks/.
"""
import argparse
import csv
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

from parity_real_format_torch import aggregate, evaluate, purity_score  # noqa: E402

BENCH = os.path.join(ROOT, "benchmarks")
DATA_NPZ = os.path.join(BENCH, "_parity_data.npz")
DECODE_JSON = os.path.join(BENCH, "_parity_decode.json")
DEFAULT_OUT = os.path.join(ROOT, "logs", "parity_experiment_torch")
SCORE_ATOL = 1e-6  # the decode's mean best-k score against hpcs_tpu's stored one
RESULT_KEYS = ("decode_purity_mean", "decode_score_mean", "test_acc", "test_iou", "test_loss")

# tools/parity_experiment.py's CFG, unchanged: the canonical ShapeNet recipe
# scaled to a CPU budget (miner and CosFace on, SO(3) train and test
# rotation, lr 0.05, temperature 0.1, trade_off 0.1, ExpMap embedder)
CFG = dict(
    num_categories=2,
    parts_per_object=3,
    num_class=6,
    npoints=256,
    batch_size=4,
    n_train=32,
    n_val=8,
    n_test=16,
    epochs=40,
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
)


def seed_suffix(seed):
    return "" if seed == 0 else f"_s{seed}"


def stored(side, seed, bench=BENCH):
    """hpcs_tpu's ("jax") or the reference's ("ref") stored result of a seed."""
    path = os.path.join(bench, f"_parity_{side}{seed_suffix(seed)}.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def json_path(out, seed):
    return os.path.join(out, f"parity_torch{seed_suffix(seed)}.json")


# --------------------------------------------------------------------- data
def make_data(c=CFG):
    """{split}_points / _cat / _seg of make_data's split, from the port's
    SyntheticPartDataset at the recipe's seed."""
    from hpcs_torch.data import SyntheticPartDataset

    total = c["n_train"] + c["n_val"] + c["n_test"]
    ds = SyntheticPartDataset(num_objects=total, npoints=c["npoints"],
                              num_categories=c["num_categories"],
                              parts_per_object=c["parts_per_object"], seed=c["seed"])
    items = [ds[i] for i in range(total)]
    pts = np.stack([it[0] for it in items])
    cat = np.array([it[1] for it in items])
    seg = np.stack([it[2] for it in items])
    bounds = {"train": (0, c["n_train"]), "val": (c["n_train"], c["n_train"] + c["n_val"]),
              "test": (c["n_train"] + c["n_val"], total)}
    out = {}
    for split, (a, b) in bounds.items():
        out.update({f"{split}_points": pts[a:b], f"{split}_cat": cat[a:b],
                    f"{split}_seg": seg[a:b]})
    return out


def check_data(arrays, path=DATA_NPZ):
    """True when `path` exists and every array equals `arrays`' (dtype,
    shape, values); None when it does not exist.  Raises where they differ."""
    if not os.path.exists(path):
        return None
    with np.load(path) as d:
        if set(d.files) != set(arrays):
            raise AssertionError(f"{path} holds {sorted(d.files)}, not {sorted(arrays)}")
        for k in d.files:
            if d[k].dtype != arrays[k].dtype or not np.array_equal(d[k], arrays[k]):
                raise AssertionError(f"{k} differs from {path}'s")
    return True


class ArraySplit:
    """One split of `make_data`'s arrays as a dataset: item i is (points,
    category, seg), which hpcs_torch.data.DataLoader collates as run_jax's
    ArrayLoader batches them (float32 points, int32 category and labels)."""

    def __init__(self, arrays, split):
        self.pts, self.cat, self.seg = (arrays[f"{split}_{k}"] for k in ("points", "cat", "seg"))

    def __len__(self):
        return len(self.pts)

    def __getitem__(self, i):
        return self.pts[i], self.cat[i], self.seg[i]


def make_config(c=CFG):
    """The ModelConfig run_jax builds from CFG (tools/parity_experiment.py)."""
    from hpcs_torch.models import ModelConfig

    return ModelConfig(
        dataset="shapenet", model_name="vn_dgcnn_partseg",
        num_class=c["num_class"], num_categories=c["num_categories"],
        fixed_points=c["npoints"], eucl_dim=c["eucl_dim"],
        hyp_dim=c["hyp_dim"], k=c["k"], t_per_anchor=c["t_per_anchor"],
        fraction=c["fraction"], num_triplets=c["npoints"] * c["batch_size"] * c["t_per_anchor"],
        temperature=c["temperature"], lr=c["lr"], margin=c["margin"],
        trade_off=c["trade_off"], miner=True, cosface=True,
        train_rotation=c["train_rotation"], test_rotation=c["test_rotation"])


# -------------------------------------------------------------------- torch
def card_identity():
    """nvidia-smi's name and power limit of the card, as one line."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def _launch_counts():
    from hpcs_torch.ops import edgeconv as E
    from hpcs_torch.ops import knn as KN

    return {"knn": KN.knn.launches, "edgeconv": E.edgeconv_infer.launches}


def _curves(run_dir):
    train, val = [], []
    path = os.path.join(run_dir, "metrics.csv")
    if os.path.exists(path):
        with open(path) as f:
            for row in csv.DictReader(f):
                for key, dest in (("train_total_loss", train), ("val_loss", val)):
                    try:
                        dest.append(float(row[key]))
                    except (KeyError, TypeError, ValueError):
                        pass
    return train, val


def run_torch(seed=0, epochs=None, device="cuda", out=DEFAULT_OUT, log=print, draws=None):
    """Train one seed of the recipe on `device` and test it; writes and
    returns its result (run_jax's keys, the launches and the device).
    The run's draws (rotations, dropout masks, triplets) come from a
    generator on `device`, or on `draws` ("cpu": a run on the card then
    draws what the same seed's CPU run draws)."""
    import torch

    from hpcs_torch import trainer
    from hpcs_torch.data import DataLoader
    from hpcs_torch.models import HypHCSystem

    c = dict(CFG, seed=seed)
    if epochs is not None:
        c["epochs"] = epochs
    arrays = make_data()  # the data stays at CFG's seed; the seed seeds the run
    system = HypHCSystem(make_config(c), device=device,
                         generator=torch.Generator().manual_seed(seed))
    B = c["batch_size"]
    train = DataLoader(ArraySplit(arrays, "train"), B, shuffle=True, seed=seed)
    val, test = (DataLoader(ArraySplit(arrays, s), B) for s in ("val", "test"))
    name = f"parity_torch_s{seed}"
    before = _launch_counts()
    t0 = time.time()
    trainer.fit(system, train, val, epochs=c["epochs"], patience=10 ** 6, seed=seed,
                log_dir=out, run_name=name, log=lambda line: None, generator_device=draws)
    if system.device.type == "cuda":
        torch.cuda.synchronize()
    train_wall = time.time() - t0
    train_curve, val_curve = _curves(os.path.join(out, name))
    tested = evaluate(system, test, seed, generator_device=draws)
    launches = {k: v - before[k] for k, v in _launch_counts().items()}
    result = {"train_loss_curve": train_curve, "val_loss_curve": val_curve,
              "train_wall_s": train_wall, **tested, "epochs": c["epochs"], "seed": seed,
              "launches": launches, "device": str(system.device),
              "draws": str(torch.device(draws or system.device)),
              "card": card_identity() if system.device.type == "cuda" else "cpu"}
    os.makedirs(out, exist_ok=True)
    with open(json_path(out, seed), "w") as f:
        json.dump(result, f, indent=1)
    log(f"[torch s{seed}] " + json.dumps({k: v for k, v in result.items() if "curve" not in k}))
    return result


# ------------------------------------------------------------------- decode
def decode_objects(x_poincare, labels, scale, device="cpu"):
    """The port's decode of each object of x_poincare [B, N, F] (float32)
    with labels [B, N] and the model's scale: [{"best_k", "score",
    "purity"}], purity at the object's true part count."""
    import torch
    from scipy.cluster.hierarchy import fcluster

    from hpcs_torch.decode import (cosine_distance_matrix, decode_leaves, get_optimal_k,
                                   linkage_from_distances_mnn)

    x = torch.from_numpy(np.array(x_poincare, np.float32)).to(device)
    y = torch.as_tensor(np.asarray(labels), device=device).long()
    leaves = decode_leaves(x, torch.tensor(float(scale), dtype=torch.float32, device=device))
    Z = linkage_from_distances_mnn(cosine_distance_matrix(leaves), method="complete")
    _, best_k, best = get_optimal_k(y, Z, num_class=int(np.asarray(labels).max()) + 1,
                                    index="iou")
    Zs, ys = Z.double().cpu().numpy(), np.asarray(labels)
    return [{"best_k": int(best_k[i]), "score": float(best[i]),
             "purity": purity_score(ys[i], fcluster(Zs[i], len(np.unique(ys[i])),
                                                     criterion="maxclust") - 1)}
            for i in range(len(ys))]


def run_decode(seeds=range(5), device="cuda", out=DEFAULT_OUT, log=print):
    """The decode stage over the seeds whose embeddings are stored; writes
    and returns {"seeds": {seed: comparison}, "ok": every seed held}."""
    per_seed = {}
    for seed in seeds:
        path = os.path.join(BENCH, f"_parity_jax_embeddings{seed_suffix(seed)}.npz")
        tpu = stored("jax", seed)
        if not os.path.exists(path) or tpu is None:
            continue
        with np.load(path) as d:
            x, labels, scale = d["x_poincare"], d["labels"], float(d["scale"])
        t = time.time()
        rows = decode_objects(x, labels, scale, device)
        score = float(np.mean([r["score"] for r in rows]))
        purity = float(np.mean([r["purity"] for r in rows]))
        row = {"n_objects": len(rows), "seconds": time.time() - t,
               "score_mean": score, "hpcs_tpu_score_mean": tpu["decode_score_mean"],
               "score_delta": score - tpu["decode_score_mean"],
               "purity_mean": purity, "hpcs_tpu_purity_mean": tpu["decode_purity_mean"],
               "purity_delta": purity - tpu["decode_purity_mean"],
               "best_k": [r["best_k"] for r in rows]}
        row["held"] = abs(row["score_delta"]) <= SCORE_ATOL and row["purity_delta"] == 0.0
        if seed == 0 and os.path.exists(DECODE_JSON):
            with open(DECODE_JSON) as f:
                dec = json.load(f)
            row["parity_decode_json"] = {
                "tpu_score_mean": dec["tpu_score_mean"], "tpu_purity_mean": dec["tpu_purity_mean"],
                "score_delta": score - dec["tpu_score_mean"],
                "purity_delta": purity - dec["tpu_purity_mean"],
                "note": "from an earlier seed-0 run's embeddings; not held"}
        per_seed[seed] = row
        log(f"[decode s{seed}] score {score:.10f} (hpcs_tpu {tpu['decode_score_mean']:.10f}), "
            f"purity {purity:.6f} (hpcs_tpu {tpu['decode_purity_mean']:.6f}): "
            f"{'held' if row['held'] else 'NOT HELD'}")
    result = {"device": device, "score_atol": SCORE_ATOL, "seeds": per_seed,
              "max_abs_score_delta": max((abs(r["score_delta"]) for r in per_seed.values()),
                                         default=None),
              "max_abs_purity_delta": max((abs(r["purity_delta"]) for r in per_seed.values()),
                                          default=None),
              "ok": bool(per_seed) and all(r["held"] for r in per_seed.values())}
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "decode_torch.json"), "w") as f:
        json.dump(result, f, indent=1)
    return result


# ------------------------------------------------------------------- report
def compare(port, other):
    """delta = port - other, its combined standard error and z."""
    d = port["mean"] - other["mean"]
    se = float(np.hypot(port["stderr"], other["stderr"]))
    return {"delta": d, "combined_stderr": se, "z": d / se if se > 0 else 0.0}


def verdicts(port_runs, other_runs, decode):
    """tools/parity_experiment.py report()'s three booleans, the port in
    hpcs_tpu's place and `other_runs` in the reference's."""
    port = [r["decode_purity_mean"] for r in port_runs]
    other = [r["decode_purity_mean"] for r in other_runs]
    delta_pct = 100.0 * abs(np.mean(other) - np.mean(port))
    noise_pct = 100.0 * float(np.hypot(np.std(other), np.std(port)))
    return {"purity_delta_pct_points": delta_pct, "purity_run_noise_pct_points": noise_pct,
            "north_star_decode_parity_exact": bool(
                decode and decode.get("max_abs_purity_delta") == 0.0),
            "north_star_purity_delta_le_0.5pct": bool(delta_pct <= 0.5
                                                      or np.mean(port) >= np.mean(other)),
            "purity_delta_within_run_noise": bool(delta_pct <= 2.0 * noise_pct)}


def report(seeds=range(5), out=DEFAULT_OUT, bench=BENCH):
    """The port's per-seed results under `out` beside the stored ones
    (under `bench`); writes and returns the comparison."""
    port = {s: json.load(open(json_path(out, s))) for s in seeds
            if os.path.exists(json_path(out, s))}
    if not port:
        raise SystemExit("no per-seed results; run the torch stage first")
    sides = {"hpcs_tpu": {}, "reference": {}}
    for s in range(100):
        for side, key in (("hpcs_tpu", "jax"), ("reference", "ref")):
            r = stored(key, s, bench)
            if r is not None:
                sides[side][s] = r
    decode_path = os.path.join(out, "decode_torch.json")
    decode = json.load(open(decode_path)) if os.path.exists(decode_path) else None
    summary = {}
    for key in RESULT_KEYS:
        aggs = {"hpcs_torch": aggregate([r[key] for r in port.values()]),
                **{side: aggregate([r[key] for r in runs.values()])
                   for side, runs in sides.items()}}
        summary[key] = {**aggs, "vs_reference": compare(aggs["hpcs_torch"], aggs["reference"]),
                        "vs_hpcs_tpu": compare(aggs["hpcs_torch"], aggs["hpcs_tpu"])}
    result = {"description": "the port (hpcs_torch) trained on the experiment's data, recipe "
                             "and seeds, beside hpcs_tpu's and the reference's stored runs "
                             "(tools/parity_experiment.py)",
              "config": {k: v for k, v in CFG.items() if k != "seed"},
              "seeds": {"hpcs_torch": sorted(port), **{s: sorted(r) for s, r in sides.items()}},
              "devices": sorted({r.get("device", "?") for r in port.values()}),
              "summary": summary,
              "vs_reference": verdicts(list(port.values()), list(sides["reference"].values()),
                                       decode),
              "vs_hpcs_tpu": verdicts(list(port.values()), list(sides["hpcs_tpu"].values()),
                                      decode),
              "hpcs_torch_runs": {s: {k: v for k, v in r.items() if "curve" not in k}
                                  for s, r in port.items()},
              "decode": decode}
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "parity_vs_reference_torch.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({"seeds": result["seeds"], "vs_reference": result["vs_reference"],
                      "vs_hpcs_tpu": result["vs_hpcs_tpu"],
                      "z_vs_hpcs_tpu": {k: summary[k]["vs_hpcs_tpu"]["z"] for k in RESULT_KEYS}}))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("stage", choices=["data", "torch", "decode", "report"])
    ap.add_argument("--seed", type=int, default=0, help="training seed (the data stays fixed)")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4],
                    help="seeds for decode and report")
    ap.add_argument("--epochs", type=int, default=None,
                    help="override the recipe's 40 epochs (a short run)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--draws", default=None,
                    help="the device of the torch stage's generator (default: --device's); "
                         "cpu pairs a run on the card with the same seed's CPU run")
    ap.add_argument("--out", default=DEFAULT_OUT, help="output directory")
    args = ap.parse_args(argv)
    if args.stage == "data":
        arrays = make_data()
        same = check_data(arrays)
        print(f"data: {', '.join(f'{k} {v.shape}' for k, v in arrays.items())}; "
              + ("equal to benchmarks/_parity_data.npz" if same else
                 "benchmarks/_parity_data.npz not found"))
        return arrays
    if args.stage == "torch":
        return run_torch(args.seed, args.epochs, args.device, args.out, draws=args.draws)
    if args.stage == "decode":
        result = run_decode(args.seeds, args.device, args.out)
        if not result["ok"]:
            raise SystemExit(f"decode: not every seed held: {json.dumps(result['seeds'])}")
        return result
    return report(args.seeds, args.out)


if __name__ == "__main__":
    main()
