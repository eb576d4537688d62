"""Multi-process dry run of the hybrid-mesh data-parallel step on the CPU:
`python -m hpcs_torch.multihost_dryrun`, the counterpart of
tools/multihost_dryrun.py.

Four gloo processes stand for 2 "hosts" x 2 local ranks on a ("dcn",
"data") DeviceMesh.  Each reads only its own objects of a 16-object
synthetic set (`process_indices`), takes them as its shard
(`global_batch_from_host_shards`), starts from rank 0's weights
(`replicate_global`) and takes two training steps of
`make_multihost_train_step`.  Prints one JSON line (the mesh, the losses,
whether the parameters stayed replicated bit for bit) and writes no file.
"""
import json
import sys
import time

import numpy as np
import torch

HOSTS, LOCAL = 2, 2
OBJECTS, POINTS = 16, 64


def _rank():
    import torch.distributed as dist

    from .data import SyntheticPartDataset
    from .data.loader import _collate
    from .models import HypHCSystem, ModelConfig
    from .parallel import collectives as C
    from .parallel.data_parallel import shard_seed
    from .parallel.multihost import (global_batch_from_host_shards, make_hybrid_mesh,
                                     make_multihost_train_step, process_indices,
                                     replicate_global)

    cfg = ModelConfig(num_class=6, num_categories=2, fixed_points=POINTS, eucl_dim=4, hyp_dim=4,
                      k=8, t_per_anchor=5, num_triplets=512, temperature=0.1, lr=0.01)
    system = HypHCSystem(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(100 + dist.get_rank()))
    mesh = make_hybrid_mesh(n_local=LOCAL, device_type="cpu")
    replicate_global(mesh, system.net.state_dict())
    data = SyntheticPartDataset(num_objects=OBJECTS, npoints=POINTS, num_categories=2,
                                parts_per_object=3)
    idxs = process_indices(OBJECTS)
    batch = global_batch_from_host_shards(mesh, _collate([data[int(i)] for i in idxs]))
    step = make_multihost_train_step(system, mesh)
    generator = torch.Generator().manual_seed(shard_seed(1, step.shard))
    losses = [float(step(batch, generator)["total_loss"]) for _ in range(2)]
    flat = torch.cat([p.detach().reshape(-1) for p in system.net.parameters()])
    gathered = C.gather_slots(flat)
    replicated = bool((gathered == flat.repeat(C.world_size())).all())
    return {"process_count": C.world_size(), "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
            "shard": step.shard, "objects": idxs.tolist(), "losses": losses,
            "replicated": replicated}


def main():
    from .parallel.multihost import run_ranks

    t0 = time.time()
    ranks = run_ranks(_rank, HOSTS * LOCAL, backend="gloo", threads=1)
    objects = sorted(i for r in ranks for i in r["objects"])
    result = {"process_count": ranks[0]["process_count"], "mesh": ranks[0]["mesh"],
              "objects_per_rank": [r["objects"] for r in ranks],
              "every_object_read_once": objects == list(range(OBJECTS)),
              "loss_step1": ranks[0]["losses"][0], "loss_step2": ranks[0]["losses"][1],
              "losses_equal_on_every_rank": all(r["losses"] == ranks[0]["losses"] for r in ranks),
              "replicated": all(r["replicated"] for r in ranks),
              "wall_s": time.time() - t0}
    result["ok"] = bool(result["every_object_read_once"] and result["replicated"]
                        and result["losses_equal_on_every_rank"]
                        and np.isfinite(ranks[0]["losses"]).all())
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
