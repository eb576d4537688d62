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

from _torch_port import adjacent_dup_cloud, lattice_cloud, line_cloud, require_cuda, tie_cloud
from hpcs_torch.data import SyntheticPartDataset
from hpcs_torch.decode import cosine_distance_matrix, decode_leaves, linkage_from_distances_mnn
from hpcs_torch.models import HypHCSystem, ModelConfig, decode_vector_for_batch
from hpcs_torch.ops import edgeconv as E
from hpcs_torch.ops import knn as K
from hpcs_torch.testing import check_edgeconv, check_planted_eps, check_train_step_card_vs_cpu


def test_knn_kernel_rejects_shapes_it_does_not_take():
    with pytest.raises(ValueError, match="D <= 64"):
        K._knn_cuda(torch.zeros(1, 16, 65), 4)
    with pytest.raises(ValueError, match="k <= 32"):
        K._knn_cuda(torch.zeros(1, 64, 3), 33)
    with pytest.raises(ValueError, match="float32"):
        K._knn_cuda(torch.zeros(1, 16, 3, dtype=torch.float64), 4)
    with pytest.raises(ValueError, match="contiguous"):
        K._knn_cuda(torch.zeros(1, 3, 16).transpose(1, 2), 4)


def test_wide_knn_kernel_rejects_shapes_it_does_not_take():
    with pytest.raises(ValueError, match="N \\+ D <= 49136"):
        K._knn_wide_cuda(torch.zeros(1, 49100, 40), 4)
    with pytest.raises(ValueError, match="k <= N"):
        K._knn_wide_cuda(torch.zeros(1, 30, 3), 31)
    with pytest.raises(ValueError, match="float32"):
        K._knn_wide_cuda(torch.zeros(1, 16, 3, dtype=torch.float64), 4)


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
@pytest.mark.parametrize("cloud", ["random_d3", "random_d63", "random_d64", "ties_d3", "ties_d63",
                                   "ties_d64", "lattice"])
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
    got_e, got_p = tsys.embed(pts, decode_vector_for_batch(cfg, {"points": pts, "category": cat}))
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
@pytest.mark.parametrize("cloud", ["line", "adjacent_dups"])
@pytest.mark.parametrize("B,N,D,k", [(4, 1024, 3, 20), (3, 37, 5, 4)])
def test_knn_kernel_selection_worst_cases(cloud, B, N, D, k):
    """The warp queue's hard rows, with exact scores: rising scores on the
    line's last rows insert nearly every column, and adjacent duplicates tie
    inside one 32-column group."""
    require_cuda()
    if cloud == "line":
        x = line_cloud(B, N, D)
    else:
        x = adjacent_dup_cloud(np.random.default_rng(N), B, N, D)
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


def _edgeconv_case(rng, B, N, K, C):
    x = torch.from_numpy(rng.standard_normal((B, N, C, 3)).astype(np.float32)).cuda()
    idx = rng.integers(0, N, (B, N, K)).astype(np.int32)
    idx[..., 0] = np.arange(N)  # the self-edge, as a kNN graph has it
    w = [torch.from_numpy((rng.standard_normal(s) * 0.3).astype(np.float32)).cuda()
         for s in ((21, 2 * C), (21, 2 * C), (2, 21), (21, 21), (21, 21), (2, 21))]
    w[2][0] += 1
    w[5][0] += 1
    return x, torch.from_numpy(idx).cuda(), w


@pytest.mark.cuda
@pytest.mark.parametrize("K", [4, 7, 20, 32, 40])
@pytest.mark.parametrize("C,n_convs", [(1, 2), (21, 2), (21, 1), (1, 1)])
def test_edgeconv_kernel_any_k_on_ragged_blocks(C, n_convs, K):
    """Every kernel instance at K in {4, 7, 20, 32}, and K=40 (two rounds of
    32 and 8 edges), on B*N = 3003 points, which no block's point count
    divides."""
    require_cuda()
    x, idx, w = _edgeconv_case(np.random.default_rng(100 + K), 3, 1001, K, C)
    before = E.edgeconv_infer.launches
    got = E.edgeconv_infer(x, idx, *w, n_convs=n_convs)
    torch.cuda.synchronize()
    assert E.edgeconv_infer.launches == before + 1
    check_edgeconv(got, E.edgeconv_infer_plain(x, idx, *w, n_convs=n_convs), x, idx, w, n_convs)


@pytest.mark.cuda
@pytest.mark.parametrize("C,n_convs", [(1, 2), (21, 2), (21, 1)])
def test_edgeconv_kernel_out_of_cloud_index_gives_nan_for_its_point_only(C, n_convs):
    require_cuda()
    x, idx, w = _edgeconv_case(np.random.default_rng(7), 2, 256, 20, C)
    idx[0, 5, 3], idx[1, 9, 19] = 256, -1
    got = E.edgeconv_infer(x, idx, *w, n_convs=n_convs)
    nan = torch.isnan(got).all(-1).all(-1)
    assert nan[0, 5] and nan[1, 9] and int(nan.sum()) == 2
    assert int(torch.isfinite(got).sum()) == got.numel() - 2 * 63


@pytest.mark.cuda
def test_edgeconv_launches_count_one_per_stage_call():
    require_cuda()
    rng = np.random.default_rng(8)
    before = E.edgeconv_infer.launches
    for C, n_convs in ((1, 2), (21, 2), (21, 1)):
        x, idx, w = _edgeconv_case(rng, 2, 128, 20, C)
        E.edgeconv_infer(x, idx, *w, n_convs=n_convs)
    torch.cuda.synchronize()
    assert E.edgeconv_infer.launches == before + 3


def _exact_cloud(kind, B, N, D):
    """Clouds whose scores are exact in fp32 (integer coordinates, small
    enough): index-for-index equality with knn_plain holds."""
    rng = np.random.default_rng(N + D)
    if kind == "ties":
        half = rng.integers(-4, 5, size=(B, (N + 1) // 2, D)).astype(np.float32)
        x = np.concatenate([half, half], 1)[:, :N]
    elif kind == "adjacent":
        x = adjacent_dup_cloud(rng, B, N, D)
    elif kind == "line":
        x = line_cloud(B, N, D)
    else:
        x = np.full((B, N, D), 0.5, np.float32)
    return torch.from_numpy(np.ascontiguousarray(x)).cuda()


_WIDE_SHAPES = [(1024, 3, 33), (1024, 3, 40), (4097, 3, 20), (4097, 63, 20), (1024, 128, 20),
                (37, 5, 37)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,N,D,k", [(kind, *shape) for kind in ("ties", "adjacent", "line",
                                                                     "equal")
                                        for shape in _WIDE_SHAPES
                                        if kind != "line" or shape[0] <= 2048])
def test_wide_knn_kernel_matches_plain(kind, N, D, k):
    """The shapes kernel B1 refuses go to the wide kernel: exact on clouds
    whose scores are exact (the line only up to N = 2048 keeps them so)."""
    require_cuda()
    x = _exact_cloud(kind, 2, N, D)
    before, wide = K.knn.launches, K.knn.wide_launches
    got = K.knn(x, k)
    torch.cuda.synchronize()
    assert (K.knn.launches - before, K.knn.wide_launches - wide) == (1, 1)
    torch.testing.assert_close(got, K.knn_plain(x, k), rtol=0, atol=0)


@pytest.mark.cuda
def test_wide_knn_kernel_near_ties_only_on_random_clouds():
    require_cuda()
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 4200, 3))
                         .astype(np.float32)).cuda()
    got, want = K._knn_wide_cuda(x, 20), K.knn_plain(x, 20)
    assert (got == want).float().mean() > 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("N,D,k,wide", [(1024, 3, 20, False), (4096, 64, 32, False),
                                        (1024, 3, 33, True), (4097, 3, 20, True),
                                        (256, 65, 8, True)])
def test_knn_routes_by_shape(N, D, k, wide):
    require_cuda()
    x = torch.randn(1, N, D, device="cuda")
    before, wide_before = K.knn.launches, K.knn.wide_launches
    assert K.knn(x, k).shape == (1, N, k)
    assert (K.knn.launches - before, K.knn.wide_launches - wide_before) == (1, int(wide))


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["complete", "single", "average"])
@pytest.mark.parametrize("kind", ["untied", "tied"])
def test_mnn_linkage_on_gpu_equals_cpu(method, kind):
    """The same D on the card and on the CPU gives the same Z, bit for bit."""
    require_cuda()
    rng = np.random.default_rng(2)
    if kind == "tied":
        x = np.repeat(rng.standard_normal((3, 12, 5)), 25, axis=1)  # 300 points, 12 groups
    else:
        x = rng.standard_normal((3, 300, 8))
    D = torch.cdist(torch.from_numpy(x), torch.from_numpy(x)).float()
    got = linkage_from_distances_mnn(D.cuda(), method)
    torch.testing.assert_close(got.cpu(), linkage_from_distances_mnn(D, method), rtol=0, atol=0)


@pytest.mark.cuda
def test_cosine_distances_on_gpu_equal_cpu():
    """Near-parallel embeddings, as an untrained model gives: the card's
    leaves and distances are the CPU port's, bit for bit."""
    require_cuda()
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 1, 32)) + 0.05 * rng.standard_normal((2, 300, 32)))
    x = torch.from_numpy(x.astype(np.float32))
    scale = torch.tensor(1e-3)

    def distances(t, s):
        return cosine_distance_matrix(decode_leaves(t, s))

    torch.testing.assert_close(distances(x.cuda(), scale.cuda()).cpu(), distances(x, scale),
                               rtol=0, atol=0)


def _train_batch(B, N, seed=0):
    pts, cat, seg = SyntheticPartDataset(B, N, 2, seed=seed).batch(0, B)
    return {"points": pts, "category": cat, "labels": seg}


@pytest.mark.cuda
def test_train_step_on_gpu_matches_cpu():
    """One step at B=2, N=128 on the card against the CPU port from the same
    weights, triplets and kNN graphs (hpcs_torch.testing); B1 builds the
    three graphs, B2 is not launched."""
    require_cuda()
    cfg = ModelConfig(num_class=6, num_categories=2, eucl_dim=8, hyp_dim=8, k=8, dropout=0.0,
                      train_rotation="none", t_per_anchor=10, temperature=0.1)
    tsys = HypHCSystem(cfg)
    k0, e0 = K.knn.launches, E.edgeconv_infer.launches
    check_train_step_card_vs_cpu(tsys, _train_batch(2, 128))
    assert (K.knn.launches - k0, E.edgeconv_infer.launches - e0) == (3, 0)


@pytest.mark.cuda
def test_train_and_eval_steps_count_their_kernels():
    require_cuda()
    cfg = ModelConfig(num_class=6, num_categories=2, eucl_dim=8, hyp_dim=8, k=8, t_per_anchor=10)
    tsys = HypHCSystem(cfg)
    batch, gen = _train_batch(2, 128), torch.Generator(device="cuda").manual_seed(0)
    k0, e0 = K.knn.launches, E.edgeconv_infer.launches
    logs = tsys.train_step(batch, gen)
    torch.cuda.synchronize()
    assert (K.knn.launches - k0, E.edgeconv_infer.launches - e0) == (3, 0)
    assert all(torch.isfinite(v).all() for v in logs.values())
    assert all(torch.isfinite(p).all() for p in tsys.net.parameters())
    k0, e0 = K.knn.launches, E.edgeconv_infer.launches
    val = tsys.eval_step(batch, gen)
    assert (K.knn.launches - k0, E.edgeconv_infer.launches - e0) == (3, 3)
    assert torch.isfinite(val["val_loss"])


@pytest.mark.cuda
def test_entry_points_train_and_serve_on_gpu(tmp_path, monkeypatch):
    """python -m hpcs_torch.train for 1 epoch at N=256, then .infer on its
    final checkpoint, on the card (no --accelerator: the default).  B1
    builds 3 graphs a training step and B1 and B2 run 3 times a validation
    and test batch; infer gives what trainer.test gives in memory."""
    require_cuda()
    from hpcs_torch import infer, train, trainer
    from hpcs_torch.data import DataLoader, ShapeNetDataset
    from hpcs_torch.testing import check_same_test_outputs, record_test_steps, write_mini_shapenet

    # 8 training, 4 validation, 6 test clouds: 2 steps, 1 validation batch,
    # test batches of 4 and 2
    write_mini_shapenet(str(tmp_path / "data" / "ShapeNet" / "raw"), ("Airplane", "Chair"),
                        (4, 2, 3), seed=0, points=800)
    monkeypatch.chdir(tmp_path)

    def counts():
        return K.knn.launches, K.knn.wide_launches, E.edgeconv_infer.launches

    before = counts()
    trained, results = train.main(
        "--dataset shapenet --fixed_points 256 --k 20 --eucl_embedding 8 --hyp_embedding 8 "
        "--t_per_anchor 10 --temperature 0.1 --batch 4 --epochs 1".split())
    assert trained.device.type == "cuda"
    assert tuple(a - b for a, b in zip(counts(), before)) == (2 * 3 + 3 + 2 * 3, 0, 3 + 2 * 3)
    assert all(np.isfinite(v) for v in results.values())
    final = "logs/shapenet_vn_dgcnn_partseg/checkpoints/final"
    before = counts()
    with record_test_steps() as served:
        restored, _ = infer.main(["shapenet", "--model_path", final, "--fixed_points", "256",
                                  "--batch", "4", "--test_batches", "2"])
    assert tuple(a - b for a, b in zip(counts(), before)) == (2 * 3, 0, 2 * 3)
    assert [len(c["pred"]) for c in served] == [4, 2]
    for k, v in trained.net.state_dict().items():
        assert torch.equal(restored.net.state_dict()[k], v), k
    loader = DataLoader(ShapeNetDataset("data/ShapeNet/raw", 256, "test"), 4, shuffle=True, seed=0)
    with record_test_steps() as in_memory:
        trainer.test(trained, loader, seed=0, limit_batches=2)
    check_same_test_outputs(served, in_memory)


OTHER_BACKBONES = {  # (ModelConfig fields, B1 launches per forward)
    "dgcnn": (dict(model_name="dgcnn_partseg", eucl_dim=6), 4),
    "pointnet": (dict(model_name="pointnet_partseg", eucl_dim=6), 0),
    "vn_pointnet": (dict(model_name="vn_pointnet_partseg", eucl_dim=6), 1),
    "vn_dgcnn_max": (dict(model_name="vn_dgcnn_partseg", pooling="max", eucl_dim=8), 3),
}


@pytest.mark.cuda
@pytest.mark.parametrize("config", list(OTHER_BACKBONES))
def test_other_backbones_embed_on_gpu_match_plain(config, monkeypatch):
    """The eval forward of each other backbone on the card: B1 builds its
    graphs (D = 64 in DGCNN's last two) and B2 is not launched; each graph
    equals knn_plain's on the same input up to near-tied neighbours
    (99.9 %), and the output equals the plain forward on the card and the
    CPU port's on the kernel's graphs (atol 2e-4 / rtol 1e-3)."""
    require_cuda()
    from hpcs_torch.nn.backbones import vn_dgcnn

    fields, launches = OTHER_BACKBONES[config]
    cfg = ModelConfig(num_class=6, num_categories=2, hyp_dim=4, k=20, **fields)
    tsys = HypHCSystem(cfg)
    pts, cat, _ = SyntheticPartDataset(2, 512, 2).batch(0, 2)
    dv = decode_vector_for_batch(cfg, {"points": pts, "category": cat})
    inputs, graphs = [], []

    def recorded(x, k):
        inputs.append(x)
        graphs.append(K.knn(x, k))
        return graphs[-1]

    monkeypatch.setattr(vn_dgcnn, "knn", recorded)
    k0, w0, e0 = K.knn.launches, K.knn.wide_launches, E.edgeconv_infer.launches
    got = tsys.embed(pts, dv)
    torch.cuda.synchronize()
    assert (K.knn.launches - k0, K.knn.wide_launches - w0, E.edgeconv_infer.launches - e0) == (
        launches, 0, 0)
    for x, g in zip(inputs, graphs):
        assert (g == K.knn_plain(x, 20)).float().mean() > 0.999
    monkeypatch.setattr(vn_dgcnn, "knn", K.knn_plain)
    plain = tsys.embed(pts, dv, idx_override=graphs)
    cpu = HypHCSystem(cfg, device="cpu")
    cpu.net.load_state_dict({k: v.cpu() for k, v in tsys.net.state_dict().items()})
    on_cpu = cpu.embed(pts, dv, idx_override=[g.cpu() for g in graphs])
    for g, p, c in zip(got, plain, on_cpu):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, p, atol=2e-4, rtol=1e-3)
        torch.testing.assert_close(g.cpu(), c, atol=2e-4, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("config", list(OTHER_BACKBONES))
def test_other_backbones_train_step_on_gpu_matches_cpu(config):
    """One step of each other backbone at B=2, N=128 on the card against
    the CPU port (hpcs_torch.testing.check_train_step_card_vs_cpu)."""
    require_cuda()
    fields, launches = OTHER_BACKBONES[config]
    cfg = ModelConfig(num_class=6, num_categories=2, hyp_dim=4, k=8, dropout=0.0,
                      train_rotation="none", t_per_anchor=10, temperature=0.1, **fields)
    tsys = HypHCSystem(cfg)
    k0, e0 = K.knn.launches, E.edgeconv_infer.launches
    check_train_step_card_vs_cpu(tsys, _train_batch(2, 128))
    assert (K.knn.launches - k0, E.edgeconv_infer.launches - e0) == (launches, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cloud", ["random_d3", "random_d63", "ties_d3", "ties_d63", "lattice",
                                   "line", "adjacent_d3"])
def test_knn_kernel_bf16_equals_its_fp32_route(cloud):
    """B1 on bf16 features reads bf16 and ranks their fp32 values: index for
    index B1 on x.float(), and knn_plain's where the scores are exact
    (integer coordinates, exact in bf16 up to 256)."""
    require_cuda()
    rng = np.random.default_rng(1)
    if cloud == "lattice":
        x = lattice_cloud(rng, 4, 1024)
    elif cloud == "line":
        x = line_cloud(4, 1024)  # bf16 rounds j > 256: runs of equal points
    elif cloud == "adjacent_d3":
        x = adjacent_dup_cloud(rng, 4, 1024, 3)
    elif cloud.startswith("ties"):
        x = np.round(tie_cloud(rng, 4, 1024, int(cloud[6:])) * 2)
    else:
        x = rng.standard_normal((4, 1024, int(cloud[8:]))).astype(np.float32)
    x = torch.from_numpy(x).cuda().to(torch.bfloat16)
    launches, bf16 = K.knn.launches, K.knn.bf16_launches
    got = K.knn(x, 20)
    torch.cuda.synchronize()
    assert (K.knn.launches, K.knn.bf16_launches) == (launches + 1, bf16 + 1)
    torch.testing.assert_close(got, K.knn(x.float(), 20), rtol=0, atol=0)
    want = K.knn_plain(x, 20)
    if cloud.startswith("random"):
        assert (got == want).float().mean() > 0.999
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("C,n_convs", [(1, 2), (21, 2), (21, 1)])
def test_edgeconv_kernel_bf16_matches_plain(C, n_convs):
    """B2's bf16 route at the three stage shapes: bf16 in and out, held to
    its plain version (fp32 on the upcast input with bf16-rounded weights,
    rounded once) by check_edgeconv, widened by one bf16 ulp of each
    output for the two roundings."""
    require_cuda()
    x, idx, w = _edgeconv_case(np.random.default_rng(200 + C), 4, 1024, 20, C)
    x = x.to(torch.bfloat16)
    launches, bf16 = E.edgeconv_infer.launches, E.edgeconv_infer.bf16_launches
    got = E.edgeconv_infer(x, idx, *w, n_convs=n_convs)
    torch.cuda.synchronize()
    assert (E.edgeconv_infer.launches, E.edgeconv_infer.bf16_launches) == (launches + 1, bf16 + 1)
    want = E.edgeconv_infer_plain(x, idx, *w, n_convs=n_convs)
    assert got.dtype == want.dtype == torch.bfloat16
    check_edgeconv(got, want, x, idx, w, n_convs, rounding=2.0 ** -7)


@pytest.mark.cuda
@pytest.mark.parametrize("pooling", ["mean", "max"])
def test_bf16_embed_on_gpu_goes_through_the_bf16_routes(pooling, monkeypatch):
    """The bf16 eval forward on the card: B1 on bf16 three times and, with
    mean pooling, B2 on bf16 three times; against the CPU port's bf16
    forward on the card's graphs within 3 % of the output's largest entry
    (both round to bf16 at the same points but B2's, whose fp32 sums run in
    another order; the CPU tests measure 0.4-1 % between the packages)."""
    require_cuda()
    from hpcs_torch.nn.backbones import vn_dgcnn

    cfg = ModelConfig(num_class=10, num_categories=4, eucl_dim=8, hyp_dim=8, k=8, bf16=True,
                      pooling=pooling)
    tsys = HypHCSystem(cfg, generator=torch.Generator().manual_seed(0))
    pts, cat, _ = SyntheticPartDataset(2, 256, 4).batch(0, 2)
    dv = decode_vector_for_batch(cfg, {"points": pts, "category": cat})
    graphs, real = [], vn_dgcnn.knn
    monkeypatch.setattr(vn_dgcnn, "knn", lambda x, k: graphs.append(real(x, k)) or graphs[-1])
    k0, e0 = K.knn.bf16_launches, E.edgeconv_infer.bf16_launches
    got = tsys.embed(pts, dv)
    b2 = 3 if pooling == "mean" else 0
    assert (K.knn.bf16_launches - k0, E.edgeconv_infer.bf16_launches - e0) == (3, b2)
    cpu = HypHCSystem(cfg, device="cpu")
    cpu.net.load_state_dict({k: v.cpu() for k, v in tsys.net.state_dict().items()})
    want = cpu.embed(pts, dv.cpu(), idx_override=[g.cpu() for g in graphs])
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and torch.isfinite(g).all()
        assert float((g.cpu() - w).abs().max()) <= 0.03 * float(w.abs().max())


@pytest.mark.cuda
def test_bf16_train_step_on_gpu_matches_cpu():
    """One bf16 train_step on the card against the CPU port's
    (testing.check_train_step_card_vs_cpu): the card's float64 step equals
    the CPU's, and the card's bf16 step lies within the CPU's own bf16
    noise (its point orders) of float64."""
    require_cuda()
    from _torch_port import synthetic_batch

    cfg = ModelConfig(num_class=6, num_categories=2, eucl_dim=4, hyp_dim=4, k=6, t_per_anchor=5,
                      temperature=0.1, dropout=0.0, train_rotation="none", bf16=True)
    tsys = HypHCSystem(cfg, generator=torch.Generator().manual_seed(0))
    launches = K.knn.bf16_launches
    check_train_step_card_vs_cpu(tsys, synthetic_batch(2, 64, seed=4))
    assert K.knn.bf16_launches - launches == 3
