"""The port's CUDA kernels against their plain versions.

Imports neither jax nor hpcs_tpu, so it also runs on a GPU machine without
JAX.  The tests marked `cuda` skip without a GPU; run them on one with

    python -m pytest tests/test_torch_cuda.py -q --noconftest -m cuda

(`--noconftest`: tests/conftest.py sets up JAX).  The wrappers' argument
checks run everywhere: they raise before anything reaches the device.
"""
import numpy as np
import pytest
import torch

from _torch_port import lattice_cloud, require_cuda, tie_cloud
from hpcs_torch.data import SyntheticPartDataset
from hpcs_torch.models import HypHCSystem, ModelConfig, decode_vector_for_batch
from hpcs_torch.ops import edgeconv as E
from hpcs_torch.ops import knn as K
from hpcs_torch.testing import check_edgeconv, check_planted_eps


def test_knn_kernel_rejects_shapes_it_does_not_take():
    with pytest.raises(ValueError, match="D <= 64"):
        K._knn_cuda(torch.zeros(1, 16, 65), 4)
    with pytest.raises(ValueError, match="k <= 32"):
        K._knn_cuda(torch.zeros(1, 64, 3), 33)
    with pytest.raises(ValueError, match="float32"):
        K._knn_cuda(torch.zeros(1, 16, 3, dtype=torch.float64), 4)
    with pytest.raises(ValueError, match="contiguous"):
        K._knn_cuda(torch.zeros(1, 3, 16).transpose(1, 2), 4)


def test_edgeconv_kernel_rejects_shapes_it_does_not_take():
    x, idx = torch.zeros(1, 8, 4, 3), torch.zeros(1, 8, 2, dtype=torch.int32)
    w, ab = torch.zeros(21, 8), torch.zeros(2, 21)
    with pytest.raises(ValueError, match="C_in"):
        E._edgeconv_cuda(x, idx, w, w, ab, None, None, None, 1)
    x, w1 = torch.zeros(1, 8, 1, 3), torch.zeros(21, 2)
    with pytest.raises(ValueError, match="idx"):
        E._edgeconv_cuda(x, idx.long(), w1, w1, ab, None, None, None, 1)
    with pytest.raises(ValueError, match="W1"):
        E._edgeconv_cuda(x, idx, w1.t(), w1.t(), ab, None, None, None, 1)
    with pytest.raises(ValueError, match="W2"):
        E._edgeconv_cuda(x, idx, w1, w1, ab, w, w, ab, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("cloud", ["random_d3", "random_d63", "ties_d3", "ties_d63", "lattice"])
def test_knn_kernel_matches_plain(cloud):
    require_cuda()
    rng = np.random.default_rng(0)
    if cloud == "lattice":
        x = lattice_cloud(rng, 4, 1024)
    elif cloud.startswith("ties"):
        # integer coordinates: every score is exact, whatever the order of the sums
        x = np.round(tie_cloud(rng, 4, 1024, int(cloud[6:])) * 2)
    else:
        x = rng.standard_normal((4, 1024, int(cloud[8:]))).astype(np.float32)
    x = torch.from_numpy(x).cuda()
    before = K.knn.launches
    got = K.knn(x, 20)
    torch.cuda.synchronize()
    assert K.knn.launches == before + 1
    want = K.knn_plain(x, 20)
    if cloud.startswith("random"):
        # fp32 sums in another order may swap near-tied neighbours
        assert (got == want).float().mean() > 0.999
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("C,n_convs", [(1, 2), (21, 2), (21, 1)])
def test_edgeconv_kernel_matches_plain(C, n_convs):
    require_cuda()
    rng = np.random.default_rng(C)
    x = torch.from_numpy(rng.standard_normal((4, 1024, C, 3)).astype(np.float32)).cuda()
    idx = torch.from_numpy(rng.integers(0, 1024, (4, 1024, 20)).astype(np.int32)).cuda()

    def w(*shape):
        return torch.from_numpy((rng.standard_normal(shape) * 0.3).astype(np.float32)).cuda()

    def ab():
        return torch.stack([1 + w(21), w(21)])

    args = (x, idx, w(21, 2 * C), w(21, 2 * C), ab(), w(21, 21), w(21, 21), ab())
    before = E.edgeconv_infer.launches
    got = E.edgeconv_infer(*args, n_convs=n_convs)
    torch.cuda.synchronize()
    assert E.edgeconv_infer.launches == before + 1
    want = E.edgeconv_infer_plain(*args, n_convs=n_convs)
    # atol 1e-5 / rtol 1e-4, or a bound scaled by the conditioning where a
    # pre-BatchNorm norm is below 1e-4 (see hpcs_torch.testing.min_prenorm)
    checked = check_edgeconv(got, want, x, idx, list(args[2:]), n_convs)
    assert checked["ill_conditioned"] < 0.001 * got.numel()


@pytest.mark.cuda
@pytest.mark.parametrize("C,n_convs,variant", [(1, 2, "conv1"), (1, 2, "conv2"), (21, 2, "conv1"),
                                               (21, 2, "conv2"), (21, 1, "conv1")])
def test_edgeconv_kernel_gate_eps_on_planted_inputs(C, n_convs, variant):
    """Pre-BatchNorm vectors near the gate's EPS, exact in fp32: every output
    within atol 1e-5 / rtol 1e-4 of the plain twin in float64."""
    require_cuda()
    before = E.edgeconv_infer.launches
    check_planted_eps(E.edgeconv_infer, 4, 1024, 20, C, n_convs, variant, "cuda")
    assert E.edgeconv_infer.launches == before + 1


@pytest.mark.cuda
def test_embed_on_gpu_goes_through_both_kernels():
    require_cuda()
    cfg = ModelConfig(num_class=10, num_categories=4, eucl_dim=8, hyp_dim=8, k=8)
    tsys = HypHCSystem(cfg)
    pts, cat, _ = SyntheticPartDataset(2, 256, 4).batch(0, 2)
    k0, e0 = K.knn.launches, E.edgeconv_infer.launches
    got_e, got_p = tsys.embed(pts, decode_vector_for_batch(cfg, cat))
    assert (K.knn.launches - k0, E.edgeconv_infer.launches - e0) == (3, 3)
    assert torch.isfinite(got_e).all() and (got_p.norm(dim=-1) < 1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,D,k", [(3, 37, 5, 4), (2, 1000, 63, 20), (1, 4096, 63, 32),
                                     (2, 4096, 3, 20)])
def test_knn_kernel_ragged_and_large_shapes(B, N, D, k):
    """Row tiles past N, column tiles past N, and the N=4096 shared-memory
    layout; integer coordinates keep every score exact, so indices match."""
    require_cuda()
    x = np.random.default_rng(N).integers(-4, 5, size=(B, N, D)).astype(np.float32)
    x = torch.from_numpy(x).cuda()
    torch.testing.assert_close(K.knn(x, k), K.knn_plain(x, k), rtol=0, atol=0)


@pytest.mark.cuda
def test_edgeconv_kernel_ragged_point_count():
    """B*N not a multiple of the warps per block, K other than 20."""
    require_cuda()
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((3, 1001, 21, 3)).astype(np.float32)).cuda()
    idx = torch.from_numpy(rng.integers(0, 1001, (3, 1001, 7)).astype(np.int32)).cuda()
    w = [torch.from_numpy((rng.standard_normal(s) * 0.3).astype(np.float32)).cuda()
         for s in ((21, 42), (21, 42), (2, 21), (21, 21), (21, 21), (2, 21))]
    w[2][0] += 1
    w[5][0] += 1
    check_edgeconv(E.edgeconv_infer(x, idx, *w), E.edgeconv_infer_plain(x, idx, *w), x, idx, w, 2)
