"""The training loop (`fit`) and the test loop (`test`) that the entry
points drive.  All device work happens in HypHCSystem's steps; these loops
move batches and scalars."""
import math
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from .utils.checkpoint import restore_checkpoint, save_checkpoint
from .utils.logging import MetricLogger


def _mean_logs(logs_list):
    if not logs_list:
        return {}
    return {k: float(np.mean([float(logs[k]) for logs in logs_list])) for k in logs_list[0]}


def fit(system, train_loader, valid_loader, *, epochs, patience=50, seed=0, log_dir=None,
        run_name="run", logger=None, ckpt_dir=None, resume=None, train_step_fn=None, log=print,
        generator_device=None):
    """Train with validation, the plateau LR, temperature annealing and
    early stopping; returns (state, best_val_loss).

    train_loader, valid_loader: iterables of batches (dicts with "points",
    "labels" and, for ShapeNet, "category"), iterated once per epoch.
    Each epoch runs `system.train_step` on every training batch and
    `system.eval_step` on every validation batch, then `system.epoch_end`
    on the mean val_loss.  Training stops after `patience` epochs without a
    better val_loss.  All draws come from one torch.Generator on the
    system's device, seeded with `seed` (on `generator_device` where given:
    "cpu" makes a run on the card draw a CPU run's rotations, masks and
    triplets).

    Each epoch appends one record to `logger` (a MetricLogger; without one,
    `fit` opens its own in `log_dir`/`run_name` when log_dir is given):
    epoch, the training logs' means (train_total_loss, loss_metric,
    loss_hyp, train_acc, train_iou, scale), the validation logs' (val_loss,
    acc, iou), lr, temperature and epoch_time_s, at step = the system's
    step count.  `log` takes one line per epoch.  With `ckpt_dir`, the
    state is saved to `ckpt_dir/last` after every epoch and to
    `ckpt_dir/best` when val_loss improves, with the number of epochs
    trained.  `resume`, a checkpoint (directory or model.ckpt), restores
    the state and starts at its stored epoch (a JAX-package checkpoint at
    its epoch + 1: `utils.checkpoint.restore_checkpoint`).

    The state returned (`system.state_dict()`) is the one after the epoch
    with the best val_loss, and the system is left in it; when no finite
    val_loss was seen (an empty valid loader, or NaN), it is the last state
    instead, not the untrained one.

    `train_step_fn(batch, generator) -> logs` takes the place of
    `system.train_step`.  A step that runs on several ranks has `shard`
    (its rank's index, 0 the lead), `group` (its process group, None the
    whole world) and `seed(seed)` (its rank's generator seed), as
    hpcs_torch.parallel's data-parallel step, built on every rank, has;
    `fit` then runs in lockstep on every rank: each rank draws from its
    own generator, rank 0 alone validates and broadcasts its validation
    means, so the plateau LR, the temperature, early stopping and the best
    state are decided on the same numbers on every rank; only rank 0 logs
    and writes checkpoints, and the other ranks wait for them at a barrier.
    """
    ranked = hasattr(train_step_fn, "shard")
    group = train_step_fn.group if ranked else None
    lead = not ranked or train_step_fn.shard == 0  # validates, logs and writes
    step_fn = train_step_fn or system.train_step
    generator = torch.Generator(device=generator_device or system.device).manual_seed(
        train_step_fn.seed(seed) if ranked else seed)
    if not lead:
        logger, log = None, lambda line: None
    own_logger = logger is None and log_dir is not None and lead
    if own_logger:
        logger = MetricLogger(log_dir, run_name)
    start_epoch = restore_checkpoint(resume, system)[0] if resume else 0
    best_val, best_state, bad_epochs = math.inf, None, 0
    for epoch in range(start_epoch, epochs):
        t0 = time.time()
        train_logs = [step_fn(batch, generator) for batch in train_loader]
        vl = _mean_logs([system.eval_step(batch, generator) for batch in valid_loader]) \
            if lead else None
        if ranked:
            shared = [vl]
            dist.broadcast_object_list(shared, src=0, group=group)
            vl = shared[0]
        tl = _mean_logs(train_logs)
        val_loss = vl.get("val_loss", math.inf)
        lr = system.epoch_end(epoch, val_loss)
        system.set_learning_rate(lr)
        if logger is not None:
            logger.log({"epoch": epoch,
                        **{k if k.startswith("loss") or k == "scale" else f"train_{k}": v
                           for k, v in tl.items()},
                        **vl, "lr": lr, "temperature": system.temperature,
                        "epoch_time_s": time.time() - t0}, step=system.step)
        log(f"epoch {epoch}: train_loss={tl.get('total_loss', math.nan):.4f} "
            f"val_loss={val_loss:.4f} lr={lr:.2e} ({time.time() - t0:.1f}s)")
        improved = val_loss < best_val
        if improved:
            best_val, best_state, bad_epochs = val_loss, system.state_dict(), 0
        else:
            bad_epochs += 1
        if ckpt_dir and lead:
            if improved:
                save_checkpoint(os.path.join(ckpt_dir, "best"), system, system.cfg, epoch + 1)
            save_checkpoint(os.path.join(ckpt_dir, "last"), system, system.cfg, epoch + 1)
        if ckpt_dir and ranked:
            dist.barrier(group)
        if bad_epochs >= patience:
            break
    if own_logger:
        logger.close()
    if best_state is None:
        log("warning: no finite val_loss was observed (empty valid loader or NaN); "
            "returning the last trained state")
        return system.state_dict(), best_val
    system.load_state_dict(best_state)
    return best_state, best_val


def test(system, batches, seed=0, limit_batches=None, logger=None, plot_dir=None):
    """Run `system.test_step` on each batch (at most `limit_batches`) and
    return each log's mean over the batches, as floats (test_loss, score,
    test_acc, test_iou); with `logger`, also append them as one record.
    With `plot_dir`, save each object's 5-panel evaluation figure there
    (`_plot_batch`; needs matplotlib).

    Rotations and triplets come from one torch.Generator on the system's
    device, seeded with seed + 777.
    """
    generator = torch.Generator(device=system.device).manual_seed(seed + 777)
    logs_list = []
    for i, batch in enumerate(batches):
        if limit_batches is not None and i >= limit_batches:
            break
        logs, extras = system.test_step(batch, generator)
        logs_list.append({k: float(v) for k, v in logs.items()})
        if plot_dir:
            _plot_batch(system, batch, extras, plot_dir, batch_index=i)
    out = _mean_logs(logs_list)
    if logger is not None and out:
        logger.log(out)
    return out


def _plot_batch(system, batch, extras, plot_dir, batch_index):
    """Save `plot_hyperbolic_eval` of each object of a tested batch as
    plot_dir/{batch_index * B + b}.png: the batch's points and labels, the
    test_step's prediction, best k and score, its Euclidean embedding, its
    ball embedding on the sphere of radius `scale` (normalize_to_radius)
    and its linkage.  The extras come to the host once per batch."""
    from .loss import normalize_to_radius
    from .utils.viz import plot_hyperbolic_eval

    os.makedirs(plot_dir, exist_ok=True)
    with torch.no_grad():
        emb = normalize_to_radius(extras["x_poincare"], system.net.scale[0])
    host = {k: v.detach().cpu().numpy() for k, v in dict(extras, emb=emb).items()}
    B = host["pred"].shape[0]
    for b in range(B):
        plot_hyperbolic_eval(
            x=np.asarray(batch["points"][b]), y=np.asarray(batch["labels"][b]),
            y_pred=host["pred"][b], emb_hidden=host["x_euclidean"][b],
            emb_poincare=host["emb"][b], linkage_matrix=host["linkage"][b],
            k=host["best_k"][b], score=host["best_score"][b],
            screenshot=os.path.join(plot_dir, f"{batch_index * B + b}.png"))
