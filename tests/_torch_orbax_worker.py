"""One process of a two-process hpcs_tpu save (tests/test_torch_orbax.py).

    python tests/_torch_orbax_worker.py <process id> <processes> <port> <msgpack dir> <out dir>

Started as tools/multihost_dryrun.py starts its workers: JAX on the CPU with
2 devices a process, jax.distributed over localhost:<port>.  Each process
restores the TrainState of <msgpack dir> (hpcs_tpu's single-file
checkpoint) onto a template from `init` (no train step is compiled),
replicates it over the global mesh and calls hpcs_tpu's save_checkpoint,
which, with process_count() == 2, writes the orbax directory <out dir>:
each process its share of every array's chunks.
"""
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(process_id, processes, port, src, out):
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from hpcs_tpu.models import HypHCSystem, ModelConfig
    from hpcs_tpu.parallel.multihost import (initialize_distributed, make_hybrid_mesh,
                                             replicate_global)
    from hpcs_tpu.utils.checkpoint import load_config, restore_checkpoint, save_checkpoint

    initialize_distributed(coordinator_address=f"localhost:{port}", num_processes=processes,
                           process_id=process_id)
    assert jax.process_count() == processes
    cfg = load_config(src)
    cfg["hierarchy_list"] = tuple(tuple(tuple(c) for c in level)
                                  for level in cfg.get("hierarchy_list", ()))
    cfg = ModelConfig(**cfg)
    n = cfg.fixed_points
    sample = {"points": np.zeros((1, n, 3), np.float32), "labels": np.zeros((1, n), np.int32),
              "category": np.zeros((1,), np.int32)}
    template = HypHCSystem(cfg).init(jax.random.PRNGKey(0), sample)
    state, epoch, extra = restore_checkpoint(src, template)
    state = replicate_global(make_hybrid_mesh(), jax.tree_util.tree_map(np.asarray, state))
    save_checkpoint(out, state, cfg, epoch=epoch, extra={**extra, "processes": processes})


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
