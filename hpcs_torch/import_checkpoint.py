"""Convert a reference (Lightning) checkpoint into the port's checkpoint:

    python -m hpcs_torch.import_checkpoint path/to/model.ckpt out_dir [flags]

The model's settings (embedding sizes, num_class, k, backbone, loss
settings) come from the checkpoint's own `hyper_parameters`, which the
reference's `save_hyperparameters()` wrote, so a bare command imports a
ShapeNet (50 classes) or a PartNet checkpoint alike.  The layering is
documented defaults, then the checkpoint's hyperparameters, then the
flags, which only override.  A raw state_dict without hyper_parameters
takes the flags or their defaults.

Writes out_dir/model.ckpt and config.json (`utils.checkpoint.
save_checkpoint`), which `python -m hpcs_torch.infer --model_path out_dir`
serves and `python -m hpcs_torch.train --resume out_dir` trains on.  The
model is built on CUDA unless --accelerator cpu.  The file is unpickled:
import trusted files only.
"""
import argparse


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ckpt")
    ap.add_argument("out_dir")
    ap.add_argument("--eucl_embedding", type=int, default=None,
                    help="override ckpt euclidean_size (fallback default 50)")
    ap.add_argument("--hyp_embedding", type=int, default=None,
                    help="override ckpt hyp_size (fallback default 50)")
    ap.add_argument("--num_class", type=int, default=None)
    ap.add_argument("--num_categories", type=int, default=None)
    ap.add_argument("--k", type=int, default=None)
    ap.add_argument("--fixed_points", type=int, default=512)
    ap.add_argument("--model", default=None,
                    help="override ckpt backbone class (vn_dgcnn_partseg, ...)")
    ap.add_argument("--accelerator", default="cuda", help="cuda | gpu | cpu")
    return ap


def main(argv=None):
    """Run the CLI on `argv` (default sys.argv[1:]); returns the imported
    system."""
    args = build_parser().parse_args(argv)

    from .cli import select_device
    from .models import HypHCSystem, ModelConfig
    from .utils.checkpoint import save_checkpoint
    from .utils.reference_import import (load_lightning_payload, load_lightning_state,
                                         reference_hparams_to_config_kwargs)

    device = select_device(args.accelerator)
    sd, payload = load_lightning_payload(args.ckpt)
    rehydrated = reference_hparams_to_config_kwargs(payload)
    if rehydrated:
        print("rehydrated from ckpt hyper_parameters: "
              + ", ".join(f"{k}={v}" for k, v in sorted(rehydrated.items())))
    else:
        print("no hyper_parameters in checkpoint; using flags/defaults")

    # layering: documented defaults < ckpt hparams < explicit CLI overrides
    kw = dict(dataset="shapenet", model_name="vn_dgcnn_partseg",
              num_class=50, num_categories=16, eucl_dim=50, hyp_dim=50, k=10)
    kw.update(rehydrated)
    overrides = {
        "eucl_dim": args.eucl_embedding, "hyp_dim": args.hyp_embedding,
        "num_class": args.num_class, "num_categories": args.num_categories,
        "k": args.k, "model_name": args.model,
    }
    kw.update({k: v for k, v in overrides.items() if v is not None})
    kw["fixed_points"] = args.fixed_points

    cfg = ModelConfig(**kw)
    system = HypHCSystem(cfg, device=device)
    load_lightning_state(system.net, sd, model_name=cfg.model_name)
    save_checkpoint(args.out_dir, system, cfg)
    print(f"imported {len(sd)} tensors -> {args.out_dir} "
          f"(model={cfg.model_name}, eucl={cfg.eucl_dim}, hyp={cfg.hyp_dim}, "
          f"num_class={cfg.num_class}, k={cfg.k})")
    return system


if __name__ == "__main__":
    main()
