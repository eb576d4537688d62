"""The port's per-category evaluation notebooks against hpcs_tpu's, on the
CPU: examples/shapenet_eval_torch.ipynb and partnet_eval_torch.ipynb, as
tools/make_eval_notebook_torch.py writes them, beside the notebooks that
tools/make_eval_notebook.py's build / build_partnet write.

Both run their code cells in order in one namespace, magics stripped,
NPOINTS 64 on both sides, from a directory whose ../data is the mini tree
of tools/make_mini_datasets_torch.py, on one checkpoint: hpcs_tpu's msgpack
model.ckpt after a few hpcs_tpu training steps on that tree, with
test_rotation 'none' (the packages draw rotations from different
generators).  hpcs_tpu's figures are recorded instead of drawn; the port
runs with PLOT = False.  The port's embeddings agree with hpcs_tpu's within
the eval forward's tolerance, atol 2e-4 / rtol 1e-3; a decode moves with
the rounding of near-tied cosine distances (ROADMAP C), so the port's cells
run on hpcs_tpu's own embeddings (each test_step's and the
precision-recall cell's, in order).  The precision-recall cell's CosFace
logits agree within 1e-5; its probabilities lie ulps apart (softmax over
50 classes at scale 2), where a rounding can merge two thresholds, so the
cell runs on hpcs_tpu's logits.  Then:
- the per-object rows: best k and true parts exactly, scores within 1e-6;
- the part-label confusion matrices exactly;
- the summary's per-category numbers (objects, mean best k, mean true
  parts, mean score) and overall score within 1e-6;
- the precision-recall arrays within 1e-5.
The committed notebooks are the generator's output; DEVICE 'cuda' raises
without a GPU; a missing tree is written by the setup cell; the tools, the
notebooks and chip_smoke.py import no JAX.
"""
import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from _torch_notebooks import (REPO, ROW_TOL, checkpoint, close_embeddings, jax_confusions,
                              notebooks, run_jax, run_port, same_rows, write_tree)
from _torch_port import torch_threads

import make_eval_notebook as jax_notebooks  # noqa: E402  (tools/, on the path)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    with torch_threads(2):
        yield


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_tree(tmp_path_factory.mktemp("notebooks"), ("shapenet",))


@pytest.fixture(scope="module")
def shapenet_runs(tree):
    ckpt = checkpoint(tree, "shapenet", steps=150)
    want, figures, carried = run_jax(jax_notebooks.build(ckpt), tree / "examples")
    got, own = run_port(notebooks.build(ckpt, "cpu"), tree / "examples", carried,
                         logits=np.array(want["logits"]))
    return got, want, figures, own, carried


def test_shapenet_notebook_embeds_as_hpcs_tpu(shapenet_runs):
    _, want, _, own, carried = shapenet_runs
    assert len(carried) == 3  # a test batch for each category, the precision-recall batch
    close_embeddings(own[:-1], carried)
    # the precision-recall cell's logits, from hpcs_tpu's embeddings
    np.testing.assert_allclose(own[-1], want["logits"], rtol=0, atol=1e-5)


def test_shapenet_notebook_rows_equal_hpcs_tpus(shapenet_runs):
    got, want, *_ = shapenet_runs
    assert [r["category"] for r in want["all_rows"]] == ["Airplane"] * 2 + ["Cap"] * 2
    same_rows(got["all_rows"], want["all_rows"], "category")


def test_shapenet_notebook_confusion_matrices_equal_hpcs_tpus(shapenet_runs):
    got, _, figures, *_ = shapenet_runs
    want = jax_confusions(figures)
    assert len(want) == len(got["confusion"]) == 2
    for (parts, cm), category in zip(want, ("Airplane", "Cap")):
        got_parts, got_cm = got["confusion"][category]
        assert list(got_parts) == parts
        np.testing.assert_array_equal(got_cm, cm)


def test_shapenet_notebook_summary_equals_hpcs_tpus(shapenet_runs):
    got, want, *_ = shapenet_runs
    table = want["per_cat"]
    assert list(got["per_cat"]) == list(table.index)
    for category, row in got["per_cat"].items():
        assert row["objects"] == int(table.loc[category, "objects"])
        for key in ("mean_best_k", "mean_true_parts", "mean_score"):
            assert abs(row[key] - float(table.loc[category, key])) <= ROW_TOL, (category, key)
    assert abs(got["overall"] - float(want["df"]["score"].mean())) <= ROW_TOL


def test_shapenet_notebook_precision_recall_equals_hpcs_tpus(shapenet_runs):
    got, want, figures, *_ = shapenet_runs
    assert got["top"] == want["top"]
    (prec, rec), _ = figures["plot_precision_recall_curve"].calls[0]
    for key, w in (("prec", prec), ("rec", rec)):
        assert got[key].shape == w.shape
        np.testing.assert_allclose(got[key], w, rtol=0, atol=1e-5, err_msg=key)


def test_shapenet_notebook_draws_its_figures(shapenet_runs, tree):
    """With plot=True the port's helper draws every panel (matplotlib on
    the Agg backend) and gives the rows it gives without (on the port's
    own embeddings)."""
    from hpcs_torch.loss import get_logits

    got = shapenet_runs[0]
    del got["system"].embed  # the system's own embeddings and logits again
    got["get_logits"] = get_logits
    cwd = os.getcwd()
    try:
        os.chdir(tree / "examples")
        with contextlib.redirect_stdout(io.StringIO()):
            rows = got["evaluate_category"]("Cap", plot=True)
            same_rows(rows, got["evaluate_category"]("Cap", plot=False), "category")
    finally:
        os.chdir(cwd)


@pytest.mark.parametrize("dataset", ["shapenet", "partnet"])
def test_the_committed_notebooks_are_the_generators(dataset):
    with open(notebooks.OUT[dataset]) as f:
        committed = json.load(f)
    make = notebooks.build if dataset == "shapenet" else notebooks.build_partnet
    assert committed == make()
    cells = notebooks.code_cells(committed)
    assert "DEVICE = 'cuda'" in cells[0]
    assert "DEVICE = 'cpu'" in notebooks.code_cells(make(device="cpu"))[0]
    assert not any("jax" in cell or "hpcs_tpu" in cell for cell in cells)


def test_the_setup_cell_raises_without_a_gpu(tree):
    """DEVICE = 'cuda' without a GPU raises (resolve_device) before any
    work."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    setup = notebooks.code_cells(notebooks.build(str(tree / "no_checkpoint")))[0]
    cwd = os.getcwd()
    try:
        os.chdir(tree / "examples")
        with pytest.raises(RuntimeError, match="CUDA"):
            exec(setup, {"__name__": "__main__"})
    finally:
        os.chdir(cwd)
    assert not (tree / "no_checkpoint").exists()


def test_the_setup_cell_writes_a_missing_tree(tmp_path, monkeypatch):
    """From a clean clone the setup cell writes the mini dataset with
    tools/make_mini_datasets_torch.py (here into tmp_path/data, from a
    copy of tools/ beside examples/); the checkpoint is there already."""
    import torch

    from hpcs_torch.models import HypHCSystem, ModelConfig
    from hpcs_torch.utils.checkpoint import save_checkpoint

    cfg = ModelConfig(num_class=50, num_categories=2, eucl_dim=8, hyp_dim=8, k=10)
    save_checkpoint(str(tmp_path / "ckpt"), HypHCSystem(cfg, device="cpu"), cfg)
    (tmp_path / "examples").mkdir()
    os.symlink(os.path.join(REPO, "tools"), tmp_path / "tools")
    monkeypatch.setenv("PYTHONPATH", REPO)
    setup = notebooks.code_cells(notebooks.build(str(tmp_path / "ckpt"), "cpu"))[0]
    cwd, path = os.getcwd(), list(sys.path)
    try:
        os.chdir(tmp_path / "examples")
        ns = {"__name__": "__main__"}
        with contextlib.redirect_stdout(io.StringIO()):
            exec(setup, ns)
    finally:
        os.chdir(cwd)
        sys.path[:] = path
    assert sorted(os.listdir(tmp_path / "data")) == ["ShapeNet"]
    assert ns["system"].device == torch.device("cpu") and ns["cfg"] == cfg


def test_the_new_files_import_no_jax():
    """The tools and chip_smoke.py (its notebooks phase included) import
    with jax and hpcs_tpu blocked, and the notebooks' cells compile there."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['hpcs_tpu'] = None\n"
        f"sys.path[:0] = [{REPO!r}, {os.path.join(REPO, 'tools')!r}]\n"
        "import chip_smoke, make_eval_notebook_torch, make_mini_datasets_torch\n"
        "import parity_real_format_torch\n"
        "assert callable(chip_smoke.notebooks_phase)\n"
        "for cell in make_eval_notebook_torch.code_cells(make_eval_notebook_torch.build())[1:]:\n"
        "    compile(cell, 'cell', 'exec')\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
