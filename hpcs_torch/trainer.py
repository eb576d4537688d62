"""The training loop (`fit`) and the test loop (`test`) that the entry
points drive.  All device work happens in HypHCSystem's steps; these loops
move batches and scalars."""
import math
import os
import time

import numpy as np
import torch

from .utils.checkpoint import restore_checkpoint, save_checkpoint
from .utils.logging import MetricLogger


def _mean_logs(logs_list):
    if not logs_list:
        return {}
    return {k: float(np.mean([float(logs[k]) for logs in logs_list])) for k in logs_list[0]}


def fit(system, train_loader, valid_loader, *, epochs, patience=50, seed=0, log_dir=None,
        run_name="run", logger=None, ckpt_dir=None, resume=None, log=print):
    """Train with validation, the plateau LR, temperature annealing and
    early stopping; returns (state, best_val_loss).

    train_loader, valid_loader: iterables of batches (dicts with "points",
    "labels" and, for ShapeNet, "category"), iterated once per epoch.
    Each epoch runs `system.train_step` on every training batch and
    `system.eval_step` on every validation batch, then `system.epoch_end`
    on the mean val_loss.  Training stops after `patience` epochs without a
    better val_loss.  All draws come from one torch.Generator on the
    system's device, seeded with `seed`.

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
    """
    generator = torch.Generator(device=system.device).manual_seed(seed)
    own_logger = logger is None and log_dir is not None
    if own_logger:
        logger = MetricLogger(log_dir, run_name)
    start_epoch = restore_checkpoint(resume, system)[0] if resume else 0
    best_val, best_state, bad_epochs = math.inf, None, 0
    for epoch in range(start_epoch, epochs):
        t0 = time.time()
        train_logs = [system.train_step(batch, generator) for batch in train_loader]
        val_logs = [system.eval_step(batch, generator) for batch in valid_loader]
        tl, vl = _mean_logs(train_logs), _mean_logs(val_logs)
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
        if ckpt_dir:
            if improved:
                save_checkpoint(os.path.join(ckpt_dir, "best"), system, system.cfg, epoch + 1)
            save_checkpoint(os.path.join(ckpt_dir, "last"), system, system.cfg, epoch + 1)
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


def test(system, batches, seed=0, limit_batches=None, logger=None):
    """Run `system.test_step` on each batch (at most `limit_batches`) and
    return each log's mean over the batches, as floats (test_loss, score,
    test_acc, test_iou); with `logger`, also append them as one record.

    Rotations and triplets come from one torch.Generator on the system's
    device, seeded with seed + 777.
    """
    generator = torch.Generator(device=system.device).manual_seed(seed + 777)
    logs_list = []
    for i, batch in enumerate(batches):
        if limit_batches is not None and i >= limit_batches:
            break
        logs, _ = system.test_step(batch, generator)
        logs_list.append({k: float(v) for k, v in logs.items()})
    out = _mean_logs(logs_list)
    if logger is not None and out:
        logger.log(out)
    return out
