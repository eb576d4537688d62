"""The port's SO(3) probe (`python -m hpcs_torch.check_invariance`) against
the JAX package's tools/check_invariance.py on the CPU.

Given the same 4 rotation matrices, the same clouds and shared weights
(from_jax_params), the port's `measure` and the JAX tool's loop (written
out here with the matrices injected: the tool draws its own) give the same
kNN-graph agreement under every rotation, and deviations that agree within
2e-4 of the embedding scale.  The command line takes the tool's flags and
prints its lines, and reads a checkpoint as infer does.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_port_pair, torch_threads
from hpcs_tpu.models.base import decode_vector_for_batch as j_decode_vector
from hpcs_tpu.ops.knn import knn_auto
from hpcs_tpu.utils.rotations import rotate_cloud as j_rotate_cloud
from hpcs_torch import check_invariance
from hpcs_torch.data import SyntheticPartDataset
from hpcs_torch.models import decode_vector_for_batch
from hpcs_torch.utils.checkpoint import save_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    with torch_threads(2):
        yield


def _jax_measure(jsys, state, batch, rotations, k):
    """tools/check_invariance.py's loop, on the given rotations."""
    jbatch = {key: jnp.asarray(v) for key, v in batch.items()}
    dv = j_decode_vector(jsys.cfg, jbatch)

    @jax.jit
    def embed(points):
        return jsys.net.apply({"params": state.params, "batch_stats": state.batch_stats},
                              points, dv, train=False)[0]

    pts0 = jbatch["points"]
    base = embed(pts0)
    graph0 = np.sort(np.asarray(knn_auto(pts0, k)), -1)
    devs, same = [], []
    for R in rotations:
        rotated = j_rotate_cloud(pts0, jnp.asarray(R))
        devs.append(float(jnp.abs(embed(rotated) - base).max()))
        g = np.sort(np.asarray(knn_auto(rotated, k)), -1)
        same.append(float((g == graph0).all(-1).mean()))
    return float(jnp.abs(base).max()), devs, same


@pytest.mark.parametrize("B,N,k,seed", [(2, 128, 8, 0), (4, 96, 6, 1)])
def test_invariance_matches_jax_on_shared_rotations(B, N, k, seed):
    jsys, state, tsys, batch = jax_port_pair(eucl=8, hyp=8, B=B, N=N, k=k, seed=seed,
                                             random_stats=True, num_class=12, num_categories=4)
    rotations = check_invariance.draw_rotations(torch.Generator().manual_seed(seed + 7), 4, B)
    assert rotations.shape == (4, B, 3, 3)
    got = check_invariance.measure(tsys, batch["points"], decode_vector_for_batch(tsys.cfg, batch),
                                   rotations, k)
    scale, devs, same = _jax_measure(jsys, state, batch, rotations.numpy(), k)
    np.testing.assert_allclose(got["scale"], scale, rtol=1e-3)
    assert got["graph_same"] == same
    np.testing.assert_allclose(got["deviations"], devs, rtol=0, atol=2e-4 * scale)
    assert np.asarray(got["cloud_deviations"]).shape == (4, B)
    assert max(got["deviations"]) < 2e-3 * got["scale"]


def test_command_line_prints_the_tools_lines(capsys, monkeypatch, tmp_path):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import check_invariance as jtool
    finally:
        sys.path.remove(os.path.join(REPO, "tools"))
    argv = ["--batch", "2", "--fixed_points", "48", "--k", "4", "--rotations", "2"]
    monkeypatch.setattr(sys, "argv", ["check_invariance.py"] + argv)
    assert jtool.main() == 0
    want = capsys.readouterr().out.splitlines()
    assert check_invariance.main(argv + ["--accelerator", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0].split(" (")[0] for line in got] == [
        line.split(":")[0].split(" (")[0] for line in want]
    assert got[-1] == "invariance (cpu, rel tolerance 0.002): PASS" == want[-1]
    # a checkpoint: its config and weights, as infer reads them
    _, _, tsys, _ = jax_port_pair(eucl=8, hyp=8, B=2, N=48, k=4, num_class=12, num_categories=4)
    save_checkpoint(str(tmp_path / "ckpt"), tsys, tsys.cfg)
    r = check_invariance.run(["--model_path", str(tmp_path / "ckpt"), "--batch", "2",
                              "--rotations", "1", "--accelerator", "cpu"])
    # the clouds of the checkpoint's fixed_points, embedded by the saved weights
    pts, cat, seg = SyntheticPartDataset(2, tsys.cfg.fixed_points, 4).batch(0, 2)
    x_e, _ = tsys.embed(pts, decode_vector_for_batch(tsys.cfg, {"points": pts, "category": cat,
                                                                 "labels": seg}))
    assert r["scale"] == float(x_e.abs().max())
    assert r["verdict"] == "PASS" and len(r["deviations"]) == 1
    assert check_invariance.main(argv + ["--bf16", "--accelerator", "cpu"]) == 0
