"""Kernels B1 and B2 over a range of query rows (the point-sharded
forward's rows of the gathered cloud), by their plain versions, against
hpcs_tpu on the CPU.

- knn_plain(x, k, rows=(r0, r1)) equals hpcs_tpu's XLA knn's rows r0..r1-1
  exactly, ties included (every point twice; a small integer lattice), and
  knn_plain(x, k)'s rows; `knn` on a CPU tensor is knn_plain and launches
  nothing.
- edgeconv_infer_plain(table, idx, ..., rows=(r0, r1)) equals the whole
  stage's rows and hpcs_tpu's _edgeconv_xla's at the stage tolerance of
  tests/test_torch_edgeconv.py (atol 1e-5 / rtol 1e-4), in fp32 and on
  bf16 features.
- The graph features with `table=` are the whole cloud's rows exactly.
- A range that is empty, reversed or past the cloud raises.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import lattice_cloud, rand_bn, tie_cloud
from hpcs_tpu.ops.knn import knn as j_knn
from hpcs_tpu.ops.pallas.edgeconv_pallas import _affine_from_bn, _edgeconv_xla
from hpcs_torch.ops import edgeconv as E
from hpcs_torch.ops import knn as K

TOL = dict(atol=1e-5, rtol=1e-4)
N = 96
RANGES = [(0, 48), (48, 96), (13, 50), (95, 96), (0, 96)]


def _cloud(kind, D, seed):
    rng = np.random.default_rng(seed)
    if kind == "gauss":
        return rng.standard_normal((2, N, D)).astype(np.float32)
    if kind == "ties":
        return tie_cloud(rng, 2, N, D)
    return lattice_cloud(rng, 2, N)


@pytest.mark.parametrize("rows", RANGES)
@pytest.mark.parametrize("kind,D", [("gauss", 3), ("gauss", 63), ("ties", 3), ("ties", 63),
                                    ("lattice", 3)])
def test_knn_plain_rows_match_jax_exactly(kind, D, rows):
    x = _cloud(kind, D, seed=D + rows[0])
    k = 20
    r0, r1 = rows
    got = K.knn_plain(torch.from_numpy(x), k, rows=rows).numpy()
    assert got.shape == (2, r1 - r0, k) and got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(j_knn(jnp.asarray(x), k))[:, r0:r1])
    np.testing.assert_array_equal(got, K.knn_plain(torch.from_numpy(x), k).numpy()[:, r0:r1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_knn_rows_on_cpu_take_the_plain_version(dtype):
    x = torch.from_numpy(_cloud("gauss", 21, 5)).to(dtype)
    before = (K.knn.launches, K.knn.row_launches)
    got = K.knn(x, 8, rows=(32, 64))
    torch.testing.assert_close(got, K.knn_plain(x, 8)[:, 32:64], rtol=0, atol=0)
    assert (K.knn.launches, K.knn.row_launches) == before


@pytest.mark.parametrize("rows", [(0, 0), (10, 5), (-1, 4), (90, 97)])
def test_knn_refuses_a_range_outside_the_cloud(rows):
    with pytest.raises(ValueError, match="rows"):
        K.knn(torch.zeros(1, N, 3), 4, rows=rows)


def _stage_inputs(C, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, N, C, 3)).astype(np.float32)
    idx = rng.integers(0, N, (2, N, 8)).astype(np.int32)

    def w(o, i):
        return (rng.standard_normal((o, i)) * 0.3).astype(np.float32)

    return dict(x=x, idx=idx, W1=w(21, 2 * C), Wd1=w(21, 2 * C), bn1=rand_bn(rng, 21),
                W2=w(21, 21), Wd2=w(21, 21), bn2=rand_bn(rng, 21))


def _weights(a):
    t = [torch.from_numpy(a[k]) for k in ("W1", "Wd1")]
    bn = [{k: torch.from_numpy(v) for k, v in a[b].items()} for b in ("bn1", "bn2")]
    ab = [E.fold_bn(b["scale"], b["bias"], b["mean"], b["var"]) for b in bn]
    return t + [ab[0], torch.from_numpy(a["W2"]), torch.from_numpy(a["Wd2"]), ab[1]]


@pytest.mark.parametrize("rows", [(0, 48), (48, 96), (13, 50)])
@pytest.mark.parametrize("C,n_convs", [(1, 2), (21, 2), (21, 1)])
def test_edgeconv_plain_rows_match_the_whole_stage_and_jax(C, n_convs, rows):
    a = _stage_inputs(C, seed=C + n_convs)
    r0, r1 = rows
    x, idx, w = torch.from_numpy(a["x"]), torch.from_numpy(a["idx"]), _weights(a)
    got = E.edgeconv_infer_plain(x, idx[:, r0:r1], *w, n_convs=n_convs, rows=rows)
    assert got.shape == (2, r1 - r0, 21, 3)
    whole = E.edgeconv_infer_plain(x, idx, *w, n_convs=n_convs)
    np.testing.assert_allclose(got.numpy(), whole[:, r0:r1].numpy(), **TOL)
    ab = [jnp.stack(_affine_from_bn(**{k: jnp.asarray(v) for k, v in a[b].items()}))
          for b in ("bn1", "bn2")]
    want = _edgeconv_xla(jnp.asarray(a["x"]), jnp.asarray(a["idx"]), a["W1"].T, a["Wd1"].T,
                         ab[0], a["W2"].T, a["Wd2"].T, ab[1], 0.2, n_convs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, r0:r1], **TOL)


def test_edgeconv_rows_on_cpu_take_the_plain_version_in_bf16():
    a = _stage_inputs(21, seed=7)
    x = torch.from_numpy(a["x"]).to(torch.bfloat16)
    idx, w = torch.from_numpy(a["idx"]), _weights(a)
    before = (E.edgeconv_infer.launches, E.edgeconv_infer.row_launches)
    got = E.edgeconv_infer(x, idx[:, 40:80], *w, rows=(40, 80))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 40, 21, 3)
    whole = E.edgeconv_infer_plain(x, idx, *w)
    np.testing.assert_allclose(got.float().numpy(), whole[:, 40:80].float().numpy(), **TOL)
    assert (E.edgeconv_infer.launches, E.edgeconv_infer.row_launches) == before


@pytest.mark.parametrize("rows,idx_rows", [((0, 0), 0), ((10, 5), 5), ((90, 97), 7),
                                           ((0, 48), 47)])
def test_edgeconv_refuses_a_range_outside_the_table(rows, idx_rows):
    a = _stage_inputs(1, seed=1)
    idx = torch.zeros((2, idx_rows, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="rows"):
        E.edgeconv_infer(torch.from_numpy(a["x"]), idx, *_weights(a), rows=rows)


@pytest.mark.parametrize("feature", ["vn", "cross_vn", "scalar"])
def test_graph_features_with_a_table_are_the_whole_clouds_rows(feature):
    rng = np.random.default_rng(9)
    shape = (2, N, 4) if feature == "scalar" else (2, N, 4, 3)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    fn = getattr(E, f"graph_feature_{feature}")
    whole, idx = fn(x, 8)
    got, _ = fn(x[:, 30:60], 8, idx[:, 30:60], table=x)
    torch.testing.assert_close(got, whole[:, 30:60], rtol=0, atol=0)
