"""The port's PartNet evaluation notebook against hpcs_tpu's, on the CPU:
examples/partnet_eval_torch.ipynb (tools/make_eval_notebook_torch.py's
build_partnet) beside tools/make_eval_notebook.py's build_partnet, run as
tests/test_torch_notebooks.py runs the ShapeNet pair, on hpcs_tpu's
msgpack checkpoint of the hierarchical recipe (Bottle, levels 1 and 3)
after 150 hpcs_tpu training steps on the mini tree (test_rotation 'none'):
the port's embeddings within atol 2e-4 / rtol 1e-3 of hpcs_tpu's, and on
hpcs_tpu's embeddings the per-object rows (best k and true parts exactly,
scores within 1e-6), the confusion matrix exactly and the mean score
within 1e-6.
"""
import numpy as np
import pytest

from _torch_notebooks import (ROW_TOL, checkpoint, close_embeddings, jax_confusions, notebooks,
                              run_jax, run_port, same_rows, write_tree)
from _torch_port import torch_threads

import make_eval_notebook as jax_notebooks  # noqa: E402  (tools/, on the path)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    with torch_threads(2):
        yield


def test_partnet_notebook_equals_hpcs_tpus(tmp_path):
    tree = write_tree(tmp_path, ("partnet",))
    ckpt = checkpoint(tree, "partnet", steps=150)
    want, figures, carried = run_jax(jax_notebooks.build_partnet(ckpt), tree / "examples")
    got, own = run_port(notebooks.build_partnet(ckpt, "cpu"), tree / "examples", carried)
    close_embeddings(own, carried)
    assert got["cfg"].use_hierarchical and len(got["cfg"].hierarchy_list) == 2
    same_rows(got["all_rows"], want["all_rows"], "split")
    [(parts, cm)] = jax_confusions(figures)
    assert list(got["confusion"]["test"][0]) == parts
    np.testing.assert_array_equal(got["confusion"]["test"][1], cm)
    assert abs(got["mean_score"] - float(want["df"]["score"].mean())) <= ROW_TOL
