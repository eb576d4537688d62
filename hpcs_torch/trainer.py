"""The test loop that the inference entry point drives."""
import numpy as np
import torch


def test(system, batches, seed=0, limit_batches=None):
    """Run `system.test_step` on each batch (at most `limit_batches`) and
    return each log's mean over the batches, as floats.

    Rotations come from one torch.Generator seeded with seed + 777.
    """
    generator = torch.Generator().manual_seed(seed + 777)
    logs_list = []
    for i, batch in enumerate(batches):
        if limit_batches is not None and i >= limit_batches:
            break
        logs, _ = system.test_step(batch, generator)
        logs_list.append({k: float(v) for k, v in logs.items()})
    if not logs_list:
        return {}
    return {k: float(np.mean([logs[k] for logs in logs_list])) for k in logs_list[0]}
