"""The port's figures (hpcs_torch.utils.viz, trainer.test's plot_dir and
the entry points' --plot_inference) against hpcs_tpu's on the CPU.

The numeric helpers equal hpcs_tpu's on the same numpy inputs:
`_tangent_project2` and `_pca2` within atol 1e-6, `get_linkage` exactly.
Every figure saves a PNG.  The plot inputs: with both packages'
plot_hyperbolic_eval replaced by a recorder, trainer.test on the same
batch and weights hands it the same points, labels and file names; the
port's decode is run on hpcs_tpu's own embeddings (an untrained decode
ties, so the port's own embeddings can cut elsewhere), so its prediction,
best k and score equal hpcs_tpu's test_step's, and its linkage has the same
merges and sizes, with heights within 2e-9 (inside hpcs_tpu's test_step
the distances are not those its returned x_poincare gives:
tests/test_torch_test_step.py); the embeddings, the port's own, agree
within the forward's atol 2e-4 / rtol 1e-3.  `import hpcs_torch` works
without matplotlib or sklearn, and --plot_inference then raises
ImportError naming matplotlib before any work.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpcs_tpu.utils.viz as jviz
from _torch_port import jax_port_pair, torch_threads
from hpcs_tpu import trainer as jtrainer
from hpcs_torch import infer, train, trainer
from hpcs_torch.models import base
from hpcs_torch.testing import write_mini_shapenet
from hpcs_torch.utils import viz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=2e-4, rtol=1e-3)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    with torch_threads(2):
        yield


def _ball(rng, n, d, rmax=0.95):
    u = rng.standard_normal((n, d))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    return (u * rng.uniform(0, rmax, (n, 1))).astype(np.float32)


@pytest.mark.parametrize("seed,n,d", [(0, 64, 8), (1, 200, 32), (2, 30, 3)])
def test_projections_equal_jax(seed, n, d):
    rng = np.random.default_rng(seed)
    emb = _ball(rng, n, d)
    np.testing.assert_allclose(viz._tangent_project2(emb), jviz._tangent_project2(emb),
                               rtol=0, atol=1e-6)
    x = rng.standard_normal((n, d)).astype(np.float32)
    np.testing.assert_allclose(viz._pca2(x), jviz._pca2(x), rtol=0, atol=1e-6)


@pytest.mark.parametrize("linkage", ["ward", "complete", "average"])
def test_get_linkage_equals_jax(linkage):
    from sklearn.cluster import AgglomerativeClustering

    x = np.random.default_rng(3).standard_normal((40, 4))
    model = AgglomerativeClustering(n_clusters=None, distance_threshold=0, linkage=linkage,
                                    compute_distances=True).fit(x)
    got, want = viz.get_linkage(model), jviz.get_linkage(model)
    assert len(got) == len(want) == 1
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0][-1, 3] == 40


def _eval_inputs(n=64, d=8, seed=0):
    rng = np.random.default_rng(seed)
    from scipy.cluster.hierarchy import linkage

    x = rng.standard_normal((n, 3)).astype(np.float32)
    return dict(x=x, y=rng.integers(0, 3, n), y_pred=rng.integers(0, 4, n),
                emb_hidden=rng.standard_normal((n, d)).astype(np.float32),
                emb_poincare=_ball(rng, n, d), linkage_matrix=linkage(x, "complete"), k=4,
                score=0.5)


@pytest.mark.parametrize("method", ["pca", "tsne"])
def test_eval_figure_saves_png(tmp_path, method):
    path = tmp_path / f"{method}.png"
    fig = viz.plot_hyperbolic_eval(**_eval_inputs(), screenshot=str(path),
                                   embedding_method=method)
    assert path.stat().st_size > 1000 and len(fig.axes) == 5


def test_other_figures_save_pngs(tmp_path):
    import matplotlib.pyplot as plt

    rng = np.random.default_rng(4)
    fig = viz.plot_confusion_matrix(rng.integers(0, 9, (3, 3)), ["a", "b", "c"], normalize=True,
                                    savefig=str(tmp_path / "cm.png"))
    plt.close(fig)
    fig = viz.plot_precision_recall_curve(np.linspace(1, 0.8, 20), np.linspace(0.8, 1, 20),
                                          savefig=str(tmp_path / "pr.png"))
    plt.close(fig)
    fig, (a1, a2) = plt.subplots(1, 2)
    x = rng.standard_normal((12, 2))
    viz.plot_clustering(a1, x, rng.integers(0, 3, 12), idx=[0, 5])
    lc = viz.plot_graph(a2, x, np.array([[0, 1, 2], [3, 4, 5]]), np.array([0.1, 0.5, 0.9]))
    assert len(lc.get_segments()) == 3
    fig.savefig(tmp_path / "graph.png")
    plt.close(fig)
    for name in ("cm", "pr", "graph"):
        assert (tmp_path / f"{name}.png").stat().st_size > 1000


def test_plot_inputs_equal_jax(tmp_path, monkeypatch):
    jsys, state, tsys, batch = jax_port_pair(eucl=8, hyp=8, B=2, N=64, k=8, random_stats=True,
                                             test_rotation="none")
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    _, jext = jsys.test_step(state, jbatch, jax.random.PRNGKey(0), jnp.float32(1.0))
    j_xp = np.array(jext["x_poincare"])
    seen = {"jax": [], "port": []}
    monkeypatch.setattr(jviz, "plot_hyperbolic_eval", lambda **kw: seen["jax"].append(kw))
    monkeypatch.setattr(viz, "plot_hyperbolic_eval", lambda **kw: seen["port"].append(kw))
    decode = base.decode_batch
    monkeypatch.setattr(base, "decode_batch", lambda x_p, labels, scale, num_class: decode(
        torch.from_numpy(j_xp), labels, scale, num_class))
    jtrainer.test(jsys, state, [batch], seed=0, plot_dir=str(tmp_path / "jax"))
    trainer.test(tsys, [batch], seed=0, plot_dir=str(tmp_path / "port"))
    assert len(seen["jax"]) == len(seen["port"]) == 2
    for got, want in zip(seen["port"], seen["jax"]):
        assert set(got) == set(want)
        for k in ("x", "y", "y_pred", "k", "score"):
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
        Z, jZ = np.asarray(got["linkage_matrix"]), np.asarray(want["linkage_matrix"])
        np.testing.assert_array_equal(Z[:, [0, 1, 3]], jZ[:, [0, 1, 3]])
        np.testing.assert_allclose(Z[:, 2], jZ[:, 2], rtol=0, atol=2e-9)
        for k in ("emb_hidden", "emb_poincare"):
            np.testing.assert_allclose(got[k], np.asarray(want[k]), **TOL, err_msg=k)
        assert os.path.basename(got["screenshot"]) == os.path.basename(want["screenshot"])
    assert os.path.isdir(tmp_path / "port")


def test_infer_plot_inference_saves_beside_the_checkpoint(tmp_path, monkeypatch):
    write_mini_shapenet(str(tmp_path / "data" / "ShapeNet" / "raw"), ("Airplane", "Chair"),
                        (2, 1, 2), seed=6, points=300)
    monkeypatch.chdir(tmp_path)
    flags = ("--dataset shapenet --fixed_points 64 --k 4 --eucl_embedding 8 --hyp_embedding 8 "
             "--t_per_anchor 4 --batch 2 --epochs 1 --accelerator cpu --log logs").split()
    train.main(flags)
    final = os.path.join("logs", "shapenet_vn_dgcnn_partseg", "checkpoints", "final")
    infer.main(["shapenet", "--model_path", final, "--fixed_points", "64", "--batch", "2",
                "--test_batches", "2", "--plot_inference", "--accelerator", "cpu"])
    plots = os.path.join("logs", "shapenet_vn_dgcnn_partseg", "checkpoints", "plots")
    assert sorted(os.listdir(plots)) == ["0.png", "1.png", "2.png", "3.png"]


def test_port_imports_without_matplotlib_and_refuses_plots_early(tmp_path):
    """hpcs_torch and its viz import with matplotlib, sklearn and umap
    unimportable; --plot_inference then raises ImportError naming
    matplotlib in configure (train) and before the checkpoint is read
    (infer)."""
    code = (
        "import sys\n"
        "for m in ('matplotlib', 'sklearn', 'umap', 'jax', 'hpcs_tpu'): sys.modules[m] = None\n"
        "import hpcs_torch, hpcs_torch.utils.viz, hpcs_torch.train, hpcs_torch.infer\n"
        "import hpcs_torch.check_invariance, hpcs_torch.utils.profiling\n"
        "from hpcs_torch import train, infer\n"
        "from hpcs_torch.ops import knn\n"
        "for main, argv in ((train.main, ['--dataset', 'synthetic', '--plot_inference',\n"
        "                                 '--accelerator', 'cpu', '--log', 'logs']),\n"
        "                   (infer.main, ['synthetic', '--model_path', 'missing',\n"
        "                                 '--plot_inference', '--accelerator', 'cpu'])):\n"
        "    try:\n"
        "        main(argv)\n"
        "        raise SystemExit('no ImportError')\n"
        "    except ImportError as e:\n"
        "        assert 'matplotlib' in str(e), e\n"
        "import os\n"
        "assert not os.path.exists('logs') and knn.knn.launches == 0\n"
        "print('refused early')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, timeout=300,
                         capture_output=True, text=True)
    assert out.returncode == 0 and "refused early" in out.stdout, out.stderr[-2000:]
