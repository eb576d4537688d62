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
    # shapes past the limits, on the meta device: refused before any memory
    with pytest.raises(ValueError, match="N <= 1073741824"):
        K._knn_wide_cuda(torch.empty(1, 2 ** 30 + 1, 3, device="meta"), 4)
    with pytest.raises(ValueError, match="D <= 1048576"):
        K._knn_wide_cuda(torch.empty(1, 16, 2 ** 20 + 1, device="meta"), 4)
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
@pytest.mark.parametrize("C,n_convs,variant", [(1, 2, "conv1"), (1, 2, "conv2"), (21, 2, "conv1"),
                                               (21, 2, "conv2"), (21, 1, "conv1")])
def test_edgeconv_kernel_bf16_gate_eps_on_planted_inputs(C, n_convs, variant):
    """The bf16 route (the two-conv stages on the tensor cores, their gates
    on the SFU's reciprocals) on the planted inputs: every output within
    atol 1e-5 / rtol 1e-4 + one bf16 ulp of the float64 twin on the
    bf16-rounded mixes."""
    require_cuda()
    before = E.edgeconv_infer.bf16_launches
    check_planted_eps(E.edgeconv_infer, 4, 1024, 20, C, n_convs, variant, "cuda",
                      dtype=torch.bfloat16)
    assert E.edgeconv_infer.bf16_launches == before + 1


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


# B1's domain corners: N around one warp's 32 lanes and at its top, k at
# its ends, D at its ends
KNN_CORNERS = sorted({(n, k) for n in (1, 31, 32, 33, 4096) for k in (1, min(n, 32))})


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [1, 64])
@pytest.mark.parametrize("N,k", KNN_CORNERS)
def test_knn_kernel_domain_corners(N, k, D, dtype):
    """Lanes with no column (N < 32), N = k, two columns in one lane (N =
    33), the largest N; integer coordinates keep every score exact (also in
    bf16), so B1 equals knn_plain index for index."""
    require_cuda()
    x = np.random.default_rng(N * 7 + k + D).integers(-2, 3, size=(2, N, D)).astype(np.float32)
    x = torch.from_numpy(x).cuda().to(dtype)
    torch.testing.assert_close(K.knn(x, k), K.knn_plain(x, k), rtol=0, atol=0)


def _ranked_without_nan(x, k, rows=None):
    """knn_plain's order over the non-NaN scores of each row, -1 past them
    (B1's rule: NaN never ranks, a slot no score reached reports -1)."""
    s = K.knn_scores(x.cpu(), rows)
    nan = torch.isnan(s)
    order = torch.sort(torch.where(nan, -torch.inf, s), dim=-1, descending=True,
                       stable=True).indices
    order = order.gather(-1, torch.sort(nan.gather(-1, order).int(), dim=-1,
                                        stable=True).indices)[..., :k]
    return torch.where(nan.gather(-1, order), -1, order).to(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,D,k,nan_points", [(40, 3, 20, 30), (1024, 63, 20, 5),
                                              (33, 64, 32, 33), (600, 3, 300, 400),
                                              (9000, 5, 300, 8800)])
def test_knn_kernel_nan_rows_and_fewer_than_k_real_scores(N, D, k, nan_points, dtype):
    """Points with a NaN coordinate: their rows' scores are all NaN (every
    slot -1) and their columns NaN in every row; with 30 of 40 points NaN a
    row has 10 real scores for k = 20 (on the radix route, k = 300: 200 and
    200 real scores)."""
    require_cuda()
    rng = np.random.default_rng(N + nan_points)
    x = rng.integers(-3, 4, size=(2, N, D)).astype(np.float32)
    x[:, rng.permutation(N)[:nan_points], rng.integers(0, D)] = np.nan
    x = torch.from_numpy(x).cuda().to(dtype)
    got = K.knn(x, k).cpu()
    torch.testing.assert_close(got, _ranked_without_nan(x.float(), k), rtol=0, atol=0)
    assert (got[torch.isnan(x.float()).any(-1).cpu()] == -1).all()
    torch.testing.assert_close(K.knn(x, k, rows=(3, N)).cpu(), got[:, 3:], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [(5, 1000), (1003, 1021)])
def test_knn_kernel_row_range_starting_mid_tile(rows, dtype):
    """A row range whose first row lies inside a row tile of 16 (and of 4
    and 8): knn_plain's rows and the whole launch's, index for index, on
    exact-score clouds at D = 3 and 63."""
    require_cuda()
    for D in (3, 63):
        x = np.random.default_rng(D).integers(-3, 4, size=(3, 1024, D)).astype(np.float32)
        x = torch.from_numpy(x).cuda().to(dtype)
        got = K.knn(x, 20, rows=rows)
        torch.testing.assert_close(got, K.knn_plain(x, 20, rows=rows), rtol=0, atol=0)
        torch.testing.assert_close(got, K.knn(x, 20)[:, rows[0]:rows[1]], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_knn_kernel_line_at_the_flagship(dtype):
    """The line x_j = (j, 0, 0) at B = 16, N = 1024: every row's scores rise
    up to its own column; exact scores (bf16 rounds j > 256 into runs of
    equal points, still exact), so B1 equals knn_plain."""
    require_cuda()
    x = torch.from_numpy(line_cloud(16, 1024)).cuda().to(dtype)
    torch.testing.assert_close(K.knn(x, 20), K.knn_plain(x, 20), rtol=0, atol=0)


def _rounding(dtype):
    """check_edgeconv's widening for the route of `dtype`: one bf16 ulp on bf16."""
    return {"rounding": 2.0 ** -7} if dtype == torch.bfloat16 else {}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_edgeconv_kernel_ragged_point_count(dtype):
    """B*N not a multiple of the warps per block, K other than 20."""
    require_cuda()
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((3, 1001, 21, 3)).astype(np.float32)).cuda()
    x = x.to(dtype)
    idx = torch.from_numpy(rng.integers(0, 1001, (3, 1001, 7)).astype(np.int32)).cuda()
    w = [torch.from_numpy((rng.standard_normal(s) * 0.3).astype(np.float32)).cuda()
         for s in ((21, 42), (21, 42), (2, 21), (21, 21), (21, 21), (2, 21))]
    w[2][0] += 1
    w[5][0] += 1
    check_edgeconv(E.edgeconv_infer(x, idx, *w), E.edgeconv_infer_plain(x, idx, *w), x, idx, w, 2,
                   **_rounding(dtype))


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [4, 7, 20, 32, 40])
@pytest.mark.parametrize("C,n_convs", [(1, 2), (21, 2), (21, 1), (1, 1)])
def test_edgeconv_kernel_any_k_on_ragged_blocks(C, n_convs, K, dtype):
    """Every kernel instance at K in {4, 7, 20, 32}, and K=40 (two rounds of
    32 and 8 edges), on B*N = 3003 points, which no block's point count
    divides; on both routes."""
    require_cuda()
    x, idx, w = _edgeconv_case(np.random.default_rng(100 + K), 3, 1001, K, C)
    x = x.to(dtype)
    before = E.edgeconv_infer.launches
    got = E.edgeconv_infer(x, idx, *w, n_convs=n_convs)
    torch.cuda.synchronize()
    assert E.edgeconv_infer.launches == before + 1
    check_edgeconv(got, E.edgeconv_infer_plain(x, idx, *w, n_convs=n_convs), x, idx, w, n_convs,
                   **_rounding(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,n_convs", [(1, 2), (21, 2), (21, 1)])
def test_edgeconv_kernel_out_of_cloud_index_gives_nan_for_its_point_only(C, n_convs, dtype):
    require_cuda()
    x, idx, w = _edgeconv_case(np.random.default_rng(7), 2, 256, 20, C)
    x = x.to(dtype)
    idx[0, 5, 3], idx[1, 9, 19] = 256, -1
    got = E.edgeconv_infer(x, idx, *w, n_convs=n_convs)
    nan = torch.isnan(got).all(-1).all(-1)
    assert nan[0, 5] and nan[1, 9] and int(nan.sum()) == 2
    assert int(torch.isfinite(got).sum()) == got.numel() - 2 * 63


@pytest.mark.cuda
def test_edgeconv_bf16_two_conv_launch_leaves_the_fp32_route_constant_slots_alone():
    """The bf16 two-conv stage reads conv2's weights from its tensors: fp32
    launches on one stream interleaved with bf16 launches of other weights
    on another give the fp32 launch's bits, and the bf16 ones their own."""
    require_cuda()
    x, idx, w = _edgeconv_case(np.random.default_rng(11), 4, 1024, 20, 21)
    _, _, w16 = _edgeconv_case(np.random.default_rng(12), 4, 1024, 20, 21)
    x16 = x.to(torch.bfloat16)
    want32 = E.edgeconv_infer(x, idx, *w)
    want16 = E.edgeconv_infer(x16, idx, *w16)
    torch.cuda.synchronize()
    streams = torch.cuda.Stream(), torch.cuda.Stream()
    got32, got16 = [], []
    for _ in range(8):
        with torch.cuda.stream(streams[0]):
            got32.append(E.edgeconv_infer(x, idx, *w))
        with torch.cuda.stream(streams[1]):
            got16.append(E.edgeconv_infer(x16, idx, *w16))
    torch.cuda.synchronize()
    assert all(torch.equal(g, want32) for g in got32)
    assert all(torch.equal(g, want16) for g in got16)


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


def test_row_ranges_outside_the_cloud_are_refused_before_the_device():
    for fn in (K._knn_cuda, K._knn_wide_cuda):
        for rows in ((0, 0), (9, 4), (-1, 3), (10, 17)):
            with pytest.raises(ValueError, match="rows"):
                fn(torch.zeros(1, 16, 3), 4, rows=rows)
    x, idx = torch.zeros(1, 16, 1, 3), torch.zeros(1, 8, 4, dtype=torch.int32)
    w1, ab = torch.zeros(21, 2), torch.zeros(2, 21)
    for rows in ((0, 0), (12, 20), (0, 9)):  # empty, past the table, 9 rows for idx's 8
        with pytest.raises(ValueError, match="rows"):
            E._edgeconv_cuda(x, idx, w1, w1, ab, None, None, None, 1, rows=rows)


# row ranges of a 1024-point cloud: the first row tile, one that starts and
# ends inside tiles and divides no tile size, the last rows, half the cloud
KNN_ROWS = [(0, 16), (500, 537), (1000, 1024), (512, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows", KNN_ROWS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("route,D,k", [("b1", 3, 20), ("b1", 63, 20), ("b1", 64, 32),
                                       ("wide", 128, 20), ("wide", 3, 40)])
def test_knn_row_ranges_equal_the_whole_launch(route, D, k, dtype, rows):
    """B1 (and its wide route) over query rows r0..r1-1 of the cloud: the
    whole launch's rows index for index, and knn_plain's rows up to
    near-ties (random clouds) or exactly (a tie cloud, D = 3 and 63)."""
    require_cuda()
    rng = np.random.default_rng(D + k + rows[0])
    x = torch.from_numpy(rng.standard_normal((3, 1024, D)).astype(np.float32)).cuda().to(dtype)
    r0, r1 = rows
    counts = K.knn.launches, K.knn.row_launches, K.knn.wide_launches
    got = K.knn(x, k, rows=rows)
    torch.cuda.synchronize()
    wide = int(route == "wide")
    assert (K.knn.launches, K.knn.row_launches, K.knn.wide_launches) == (
        counts[0] + 1, counts[1] + 1, counts[2] + wide)
    assert got.shape == (3, r1 - r0, k)
    torch.testing.assert_close(got, K.knn(x, k)[:, r0:r1], rtol=0, atol=0)
    assert (got == K.knn_plain(x, k, rows=rows)).float().mean() > 0.999
    if D in (3, 63):
        ties = torch.from_numpy(np.round(tie_cloud(rng, 3, 1024, D) * 2)).cuda().to(dtype)
        torch.testing.assert_close(K.knn(ties, k, rows=rows), K.knn_plain(ties, k, rows=rows),
                                   rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [(0, 500), (500, 1001), (333, 334), (17, 990)])
@pytest.mark.parametrize("C,n_convs,dtype", [(1, 2, torch.float32), (1, 1, torch.float32),
                                             (21, 2, torch.float32), (21, 1, torch.float32),
                                             (1, 2, torch.bfloat16), (21, 1, torch.bfloat16),
                                             (21, 2, torch.bfloat16)])
def test_edgeconv_row_ranges_equal_the_whole_launch(C, n_convs, dtype, rows):
    """B2 over the centres r0..r1-1 of a table of 3 x 1001 points (its
    projection over the whole table): the whole launch's rows bit for bit,
    and the whole launch the plain version's by check_edgeconv (one bf16
    ulp wider on bf16)."""
    require_cuda()
    x, idx, w = _edgeconv_case(np.random.default_rng(300 + C + rows[0]), 3, 1001, 20, C)
    x = x.to(dtype)
    r0, r1 = rows
    counts = E.edgeconv_infer.launches, E.edgeconv_infer.row_launches
    got = E.edgeconv_infer(x, idx[:, r0:r1].contiguous(), *w, n_convs=n_convs, rows=rows)
    torch.cuda.synchronize()
    assert (E.edgeconv_infer.launches, E.edgeconv_infer.row_launches) == (
        counts[0] + 1, counts[1] + 1)
    assert got.shape == (3, r1 - r0, 21, 3) and got.dtype == dtype
    whole = E.edgeconv_infer(x, idx, *w, n_convs=n_convs)
    assert torch.equal(got, whole[:, r0:r1])
    # the whole launch against the plain version (so the rows too), and the
    # plain version's rows against its whole stage's
    check_edgeconv(whole, E.edgeconv_infer_plain(x, idx, *w, n_convs=n_convs), x, idx, w,
                   n_convs, **({"rounding": 2.0 ** -7} if dtype == torch.bfloat16 else {}))
    want = E.edgeconv_infer_plain(x, idx[:, r0:r1], *w, n_convs=n_convs, rows=rows)
    torch.testing.assert_close(want, E.edgeconv_infer_plain(x, idx, *w, n_convs=n_convs)[
        :, r0:r1], rtol=1e-4, atol=1e-5)


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
                (37, 5, 37), (1024, 63, 64), (700, 3, 256), (8192, 63, 20), (300, 200, 40),
                (600, 3, 300)]


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
@pytest.mark.parametrize("N,D,k", [(1024, 3, 33), (4097, 63, 40), (8192, 3, 20), (8192, 63, 20),
                                   (1024, 128, 64), (600, 3, 300)])
@pytest.mark.parametrize("rows", ["whole", (0, 16), "mid_tiles", "last_rows"])
def test_wide_knn_kernel_bf16_equals_its_fp32_route(N, D, k, rows):
    """The wide route reads bf16 through its prep kernel, converting on
    load: index for index its route on x.float(), whole and over row
    ranges (one that starts and ends inside row and column tiles)."""
    require_cuda()
    rows = {"whole": None, "mid_tiles": (N // 3 + 5, N // 3 + 301),
            "last_rows": (N - 40, N)}.get(rows, rows)
    x = torch.from_numpy(np.random.default_rng(N + D).standard_normal((2, N, D))
                         .astype(np.float32)).cuda().bfloat16()
    before = K.knn.bf16_launches, K.knn.wide_launches
    got = K._knn_wide_cuda(x, k, rows=rows)
    torch.cuda.synchronize()
    assert (K.knn.bf16_launches - before[0], K.knn.wide_launches - before[1]) == (1, 1)
    torch.testing.assert_close(got, K._knn_wide_cuda(x.float(), k, rows=rows), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("N,D,k", [(8192, 63, 20), (8192, 3, 40), (4097, 128, 20)])
@pytest.mark.parametrize("rows", [(0, 1), (31, 33), (255, 513), (4000, 4097), (4096, 4097)])
def test_wide_knn_row_ranges_equal_the_whole_launch(N, D, k, rows):
    """The wide route over rows r0..r1-1 of a long cloud (row tiles that
    start inside the cloud's tiles, the last row alone): the whole launch's
    rows index for index, counted as a row-range launch."""
    require_cuda()
    x = torch.from_numpy(np.random.default_rng(D + k).standard_normal((2, N, D))
                         .astype(np.float32)).cuda()
    counts = K.knn.row_launches, K.knn.wide_launches
    got = K.knn(x, k, rows=rows)
    torch.cuda.synchronize()
    assert (K.knn.row_launches - counts[0], K.knn.wide_launches - counts[1]) == (1, 1)
    torch.testing.assert_close(got, K.knn(x, k)[:, rows[0]:rows[1]], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [3, 63, 128])
def test_wide_knn_kernel_at_65536_points(D):
    """N = 65,536 (one cloud): rows at the start, in the middle and at the
    end against knn_plain over those rows (its [rows, N] scores only), up to
    near-ties; each range launched alone equals the whole launch's rows."""
    require_cuda()
    N = 65536
    x = torch.from_numpy(np.random.default_rng(D).standard_normal((1, N, D))
                         .astype(np.float32)).cuda()
    whole = K.knn(x, 20)
    for rows in ((0, 256), (30000, 30300), (N - 256, N)):
        got = K.knn(x, 20, rows=rows)
        torch.testing.assert_close(got, whole[:, rows[0]:rows[1]], rtol=0, atol=0)
        assert (got == K.knn_plain(x, 20, rows=rows)).float().mean() > 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("D", [3, 63, 64])
@pytest.mark.parametrize("kind", ["random", "ties"])
def test_wide_knn_kernel_equals_b1_where_both_take_the_shape(D, kind):
    """On shapes B1 takes, the wide route's indices are B1's: the same prep,
    the same score FMA chains, and a total order for the selection."""
    require_cuda()
    rng = np.random.default_rng(D)
    x = (rng.standard_normal((3, 1000, D)).astype(np.float32) if kind == "random"
         else np.round(tie_cloud(rng, 3, 1000, D) * 2))
    x = torch.from_numpy(x).cuda()
    for k in (1, 20, 32):
        torch.testing.assert_close(K._knn_wide_cuda(x, k), K._knn_cuda(x, k), rtol=0, atol=0)


@pytest.mark.cuda
def test_wide_knn_one_row_kernel_serves_k_past_256_only():
    """k > 256 goes to the radix route (which took the one-row kernel's
    place), counted apart in knn.radix_launches at each launch, whole or
    over rows; k = 256 does not."""
    require_cuda()
    x = torch.randn(2, 600, 3, device="cuda")
    for k, rows, radix in ((256, None, 0), (257, None, 1), (600, None, 1), (300, (5, 77), 1)):
        before = K.knn.radix_launches, K.knn.wide_launches
        got = K.knn(x, k, rows=rows)
        torch.cuda.synchronize()
        assert (K.knn.radix_launches - before[0], K.knn.wide_launches - before[1]) == (radix, 1)
        assert (got == K.knn_plain(x, k, rows=rows)).float().mean() > 0.999


_RADIX_SHAPES = [(1024, 3, 257), (1024, 3, 300), (1024, 63, 600), (1100, 3, 1024), (1100, 3, 1100),
                 (300, 130, 300), (9000, 3, 4096), (9000, 5, 4097)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,N,D,k", [(kind, *shape) for kind in ("ties", "adjacent", "line",
                                                                     "equal")
                                        for shape in _RADIX_SHAPES
                                        if kind != "line" or shape[0] <= 2048])
def test_radix_route_matches_plain(kind, N, D, k):
    """The radix route (k > 256) on clouds whose scores are exact: knn_plain
    index for index, at k in {257, 300, 600, 1024, N}, through each of its
    branches: 256-thread selection blocks (N < 8192) and 1024-thread ones,
    the sort in shared memory (k <= 4096) and in the rows' scratch (k >
    4096), the candidates copied (most clouds) or every pass over the row
    (equal points past 2048 columns); the line only where N <= 2048 keeps
    its scores exact."""
    require_cuda()
    x = _exact_cloud(kind, 2, N, D)
    before = K.knn.radix_launches
    got = K.knn(x, k)
    torch.cuda.synchronize()
    assert K.knn.radix_launches - before == 1
    torch.testing.assert_close(got, K.knn_plain(x, k), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("N,D,k", [(49152, 3, 300), (49152, 3, 1024), (50000, 63, 600),
                                   (49152, 3, 49152)])
def test_radix_route_past_the_old_cap_on_row_ranges(N, D, k):
    """N + D > 49,136 (the one-row kernel's old cap): three row ranges of an
    integer cloud and of a Gaussian one, each launched alone, equal the
    whole launch's rows index for index; against knn_plain over those rows
    (its [rows, N] scores) exactly on the integer cloud, up to near-ties
    on the Gaussian one."""
    require_cuda()
    rng = np.random.default_rng(N + k)
    for exact in (True, False):
        x = (rng.integers(-8, 9, size=(1, N, D)) if exact else rng.standard_normal((1, N, D)))
        x = torch.from_numpy(x.astype(np.float32)).cuda()
        whole = K.knn(x, k)
        for rows in ((0, 64), (N // 2 - 32, N // 2 + 32), (N - 64, N)):
            got = K.knn(x, k, rows=rows)
            torch.testing.assert_close(got, whole[:, rows[0]:rows[1]], rtol=0, atol=0)
            agree = (got == K.knn_plain(x, k, rows=rows)).float().mean()
            assert agree == 1 if exact else agree > 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("N,D,k", [(600, 3, 300), (1024, 63, 512), (9000, 3, 300),
                                   (8192, 130, 257)])
@pytest.mark.parametrize("rows", ["whole", (0, 16), "mid", "last_rows"])
def test_radix_route_bf16_equals_its_fp32_route(N, D, k, rows):
    """bf16 through the prep kernels: index for index the radix route on
    x.float(), whole and over row ranges."""
    require_cuda()
    rows = {"whole": None, "mid": (N // 3 + 5, N // 3 + 301), "last_rows": (N - 40, N)}.get(
        rows, rows)
    x = torch.from_numpy(np.random.default_rng(N + D).standard_normal((2, N, D))
                         .astype(np.float32)).cuda().bfloat16()
    before = K.knn.bf16_launches, K.knn.radix_launches
    got = K.knn(x, k, rows=rows)
    torch.cuda.synchronize()
    assert (K.knn.bf16_launches - before[0], K.knn.radix_launches - before[1]) == (1, 1)
    torch.testing.assert_close(got, K.knn(x.float(), k, rows=rows), rtol=0, atol=0)


@pytest.mark.cuda
def test_radix_route_equals_the_wide_kernel_where_both_rank_the_same_rows():
    """The wide kernel's k = 256 and the radix route's k = 257 share the
    scores (the same sweep): the first 256 indices are equal, on a Gaussian
    cloud and a tie cloud."""
    require_cuda()
    rng = np.random.default_rng(7)
    for x in (rng.standard_normal((2, 1500, 63)), np.round(tie_cloud(rng, 2, 1500, 3) * 2)):
        x = torch.from_numpy(x.astype(np.float32)).cuda()
        torch.testing.assert_close(K.knn(x, 257)[..., :256], K.knn(x, 256), rtol=0, atol=0)


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
                                        (256, 65, 8, True), (4096, 3, 20, False),
                                        (4096, 63, 20, False), (4097, 63, 20, True),
                                        (4097, 64, 32, True)])
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


# Bottle's level tree at levels 1 and 3 (tools/make_mini_datasets_torch.py's)
BOTTLE_HIERARCHY = (((0,), (1, 2), (3, 4, 5, 6, 7)),
                    ((0,), (1,), (2,), (3,), (4,), (5,), (6,), (7,)))


@pytest.mark.cuda
@pytest.mark.parametrize("class_vector", [False, True])
def test_partnet_hierarchical_train_step_on_gpu_matches_cpu(class_vector):
    """PartNet's step: the hierarchical CosFace over two levels (its sum
    matrices on the card), with the constant or the part-presence decode
    vector, at B=2, N=128 on the card against the CPU port."""
    require_cuda()
    cfg = ModelConfig(dataset="partnet", num_class=9, num_categories=1, eucl_dim=8, hyp_dim=8,
                      k=8, dropout=0.0, train_rotation="none", t_per_anchor=10,
                      temperature=0.1, hierarchical=True, hierarchy_list=BOTTLE_HIERARCHY,
                      class_vector=class_vector)
    tsys = HypHCSystem(cfg)
    assert [m.device.type for m in tsys.hierarchy_matrices] == ["cuda", "cuda"]
    pts, _, seg = SyntheticPartDataset(2, 128, 3, seed=1).batch(0, 2)
    batch = {"points": pts, "category": np.zeros(2, np.int32), "labels": seg}
    k0, e0 = K.knn.launches, E.edgeconv_infer.launches
    check_train_step_card_vs_cpu(tsys, batch)
    assert (K.knn.launches - k0, E.edgeconv_infer.launches - e0) == (3, 0)


@pytest.mark.cuda
def test_hdf5_reader_on_a_deflated_partnet_file(tmp_path):
    """A chunked, deflated file of 10,000-point objects (as h5py writes
    gzip) read by the port's HDF5 reader to the arrays written, its clouds
    served on the card through both kernels."""
    require_cuda()
    from hpcs_torch.data import DataLoader, PartNetDataset
    from hpcs_torch.testing import write_h5_deflated
    from hpcs_torch.utils import hdf5

    rng = np.random.default_rng(0)
    arrays = {"data": rng.standard_normal((4, 10000, 3)).astype(np.float32),
              "label_seg": rng.integers(1, 9, (4, 10000)),
              "data_num": np.full(4, 10000, np.int32)}
    write_h5_deflated(str(tmp_path / "test-00.h5"), arrays, shuffle=True)
    with hdf5.File(tmp_path / "test-00.h5") as f:
        for name, want in arrays.items():
            got = f[name][...]
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    (tmp_path / "test_files.txt").write_text("test-00.h5\n")
    batch = next(iter(DataLoader(PartNetDataset(str(tmp_path / "test_files.txt"), 1024), 4)))
    cfg = ModelConfig(dataset="partnet", num_class=9, num_categories=1, eucl_dim=8, hyp_dim=8,
                      k=20)
    k0, e0 = K.knn.launches, E.edgeconv_infer.launches
    x_e, x_p = HypHCSystem(cfg).embed(batch["points"], decode_vector_for_batch(cfg, batch))
    assert (K.knn.launches - k0, E.edgeconv_infer.launches - e0) == (3, 3)
    assert x_p.shape == (4, 1024, 8) and bool(torch.isfinite(x_p).all())


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


@pytest.mark.cuda
def test_checkpoint_imports_round_trip_on_gpu(tmp_path):
    """At the flagship width on the card: hpcs_tpu's checkpoint format
    (testing.write_flax_checkpoint) and a reference Lightning checkpoint
    (python -m hpcs_torch.import_checkpoint) of the same system restore its
    weights, and serve its embeddings, through B1 and B2, bit for bit."""
    require_cuda()
    from hpcs_torch import import_checkpoint
    from hpcs_torch.testing import write_flax_checkpoint
    from hpcs_torch.utils.checkpoint import restore_checkpoint

    cfg = ModelConfig(num_class=50, num_categories=16, eucl_dim=32, hyp_dim=32, k=20)
    src = HypHCSystem(cfg, generator=torch.Generator().manual_seed(1))
    pts, cat, seg = SyntheticPartDataset(2, 1024, 16, seed=2).batch(0, 2)
    src.train_step({"points": pts, "category": cat, "labels": seg},
                   torch.Generator(device="cuda").manual_seed(0))
    write_flax_checkpoint(str(tmp_path / "flax"), src, cfg, epoch=2)
    flax = HypHCSystem(cfg, generator=torch.Generator().manual_seed(3))
    assert restore_checkpoint(str(tmp_path / "flax"), flax)[0] == 3
    assert flax.step == src.step == 1
    torch.save({"state_dict": {k: v.cpu() for k, v in src.net.state_dict().items()},
                "hyper_parameters": {"euclidean_size": 32, "hyp_size": 32, "num_class": 50}},
               str(tmp_path / "lightning.ckpt"))
    ref = import_checkpoint.main([str(tmp_path / "lightning.ckpt"), str(tmp_path / "ref"),
                                  "--k", "20", "--num_categories", "16"])
    dv = decode_vector_for_batch(cfg, {"points": pts, "category": cat})
    want = src.embed(pts, dv)
    for system in (flax, ref):
        for k, v in src.net.state_dict().items():
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(system.net.state_dict()[k], v), k
        k0, e0 = K.knn.launches, E.edgeconv_infer.launches
        got = system.embed(pts, dv)
        assert (K.knn.launches - k0, E.edgeconv_infer.launches - e0) == (3, 3)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("processes", [1, 2])
def test_an_orbax_directory_restores_and_serves_on_gpu(tmp_path, processes):
    """At the flagship width on the card, with no orbax: hpcs_tpu's
    multi-process checkpoint of a trained system (testing.
    write_orbax_checkpoint) restores its weights, moments, step and rate
    bit for bit, resumes at its epoch + 1, and serves test_step through B1
    and B2 (3 launches each) equal to the written system's."""
    require_cuda()
    from hpcs_torch.testing import write_orbax_checkpoint
    from hpcs_torch.utils.checkpoint import checkpoint_format, restore_checkpoint

    cfg = ModelConfig(num_class=50, num_categories=16, eucl_dim=32, hyp_dim=32, k=20)
    src = HypHCSystem(cfg, generator=torch.Generator().manual_seed(1))
    pts, cat, seg = SyntheticPartDataset(2, 1024, 16, seed=2).batch(0, 2)
    batch = {"points": pts, "category": cat, "labels": seg}
    src.train_step(batch, torch.Generator(device="cuda").manual_seed(0))
    src.set_learning_rate(cfg.lr / 2)
    path = str(tmp_path / "orbax_ckpt")
    write_orbax_checkpoint(path, src, cfg, epoch=2, extra={"p": processes}, processes=processes)
    assert checkpoint_format(path) == "orbax"
    got = HypHCSystem(cfg, generator=torch.Generator().manual_seed(3))
    assert restore_checkpoint(path, got) == (3, {"p": processes})
    for k, v in src.net.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got.net.state_dict()[k], v), k
    named = dict(got.net.named_parameters())
    for name, p in src.net.named_parameters():
        a, b = got.optimizer.state[named[name]], src.optimizer.state[p]
        assert a["step"] == b["step"] and torch.equal(a["exp_avg"], b["exp_avg"]) and \
            torch.equal(a["exp_avg_sq"], b["exp_avg_sq"]), name
    assert got.step == src.step == 1
    assert got.optimizer.param_groups[0]["lr"] == float(np.float32(cfg.lr / 2))
    outs = []
    for system in (src, got):
        k0, e0 = K.knn.launches, E.edgeconv_infer.launches
        outs.append(system.test_step(batch, torch.Generator(device="cuda").manual_seed(4))[1])
        assert (K.knn.launches - k0, E.edgeconv_infer.launches - e0) == (3, 3)
    for key in ("x_poincare", "pred", "best_k", "best_score", "linkage"):
        assert torch.equal(outs[0][key], outs[1][key]), key


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["complete", "single", "average"])
@pytest.mark.parametrize("kind", ["untied", "tied"])
def test_sequential_linkage_on_gpu_equals_cpu(method, kind):
    """linkage_from_distances on the card equals the CPU port's on the same
    D, bit for bit (torch.argmin's first index among tied distances on
    both), and so do the flat cuts of its Z."""
    require_cuda()
    from hpcs_torch.decode import (cut_maxclust, cut_maxclust_fcluster, eval_clustering,
                                   linkage_from_distances)

    rng = np.random.default_rng(5)
    if kind == "tied":
        x = np.repeat(rng.standard_normal((2, 12, 5)), 16, axis=1)  # 192 points, 12 groups
    else:
        x = rng.standard_normal((2, 192, 8))
    D = torch.cdist(torch.from_numpy(x), torch.from_numpy(x)).float()
    Z = linkage_from_distances(D.cuda(), method)
    Z_cpu = linkage_from_distances(D, method)
    torch.testing.assert_close(Z.cpu(), Z_cpu, rtol=0, atol=0)
    for k in (1, 2, 12, 191, 192):
        assert torch.equal(cut_maxclust(Z, k).cpu(), cut_maxclust(Z_cpu, k))
        assert torch.equal(cut_maxclust_fcluster(Z, k).cpu(), cut_maxclust_fcluster(Z_cpu, k))
    y = torch.from_numpy(rng.integers(0, 6, size=(2, 192)))
    for fc in (False, True):
        for g, w in zip(eval_clustering(y.cuda(), Z, 6, fc), eval_clustering(y, Z_cpu, 6, fc)):
            assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("backend,world", [("nccl", 1), ("gloo", 2)])
def test_collectives_on_the_card(backend, world):
    """hpcs_torch.parallel.collectives on CUDA tensors: NCCL at world size 1,
    gloo with 2 ranks sharing device 0 (NCCL refuses two ranks on one
    device); values and gradients as on the CPU (test_torch_parallel.py)."""
    require_cuda()
    import _torch_parallel_ranks as ranks
    from hpcs_torch.parallel.multihost import run_ranks

    for got in run_ranks(ranks.collectives_check, world, args=("cuda",), backend=backend,
                         device_ids=[0] * world):
        assert all(got.values()), got


@pytest.mark.cuda
def test_data_parallel_beyond_the_visible_gpus_raises_on_the_card():
    require_cuda()
    import argparse

    from hpcs_torch import cli

    n = torch.cuda.device_count() + 1
    args = cli.add_train_args(argparse.ArgumentParser()).parse_args(
        ["--data_parallel", str(n), "--batch", str(4 * n)])
    with pytest.raises(ValueError, match=f"--data_parallel {n}: {n - 1} GPUs are visible"):
        cli.data_parallel_size(args)


def _small_card_system():
    from _torch_port import synthetic_batch

    cfg = ModelConfig(num_class=6, num_categories=2, eucl_dim=8, hyp_dim=8, k=6, t_per_anchor=5)
    system = HypHCSystem(cfg, generator=torch.Generator().manual_seed(0))
    batch = synthetic_batch(2, 128, seed=2)
    return system, batch, decode_vector_for_batch(cfg, batch)


@pytest.mark.cuda
def test_trace_spans_enclose_the_kernels_on_the_card(tmp_path):
    """A trace on the card holds CUDA kernels, a span for every module of
    VN-DGCNN and for the steps, and each B1 / B2 kernel's launch inside
    its wrapper's span (chip_smoke's trace readers)."""
    require_cuda()
    import json

    import chip_smoke as cs
    from hpcs_torch.nn.backbones.vn_dgcnn import VNDGCNNPartSeg
    from hpcs_torch.utils import profiling

    system, batch, dv = _small_card_system()
    with profiling.trace(str(tmp_path)):
        system.train_step(batch, torch.Generator(device="cuda").manual_seed(0))
        system.embed(batch["points"], dv)
    assert profiling.open_spans() == []
    (path,) = profiling.trace_files(str(tmp_path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    modules = {f"nn_feat.{m}" for m, _ in VNDGCNNPartSeg(8, 6, 2).named_children()}
    assert modules | {"train_step", "embed", "optimizer.step", "knn", "edgeconv"} <= names
    kernels = cs._kernel_spans(events)
    b1 = [a for n, _, a in kernels if "knn_kernel" in n]
    b2 = [a for n, _, a in kernels if "edge_kernel" in n or "edge_mean_kernel" in n]
    assert len(b1) == 6 and len(b2) == 3
    assert all("knn" in a for a in b1) and all("edgeconv" in a for a in b2)


@pytest.mark.cuda
def test_nan_checks_name_the_kernels_on_the_card():
    """Under NaN debugging a NaN from B2 is named by its wrapper, a NaN
    feature by B1's score check, a NaN from an aten operation by its
    module; everything is off again afterwards."""
    require_cuda()
    from torch.utils._python_dispatch import _get_current_dispatch_mode

    from hpcs_torch.utils import profiling

    system, batch, dv = _small_card_system()
    with profiling.nan_debugging():
        system.embed(batch["points"], dv)  # healthy: no raise
    net = system.net.nn_feat
    with torch.no_grad():
        net.conv3.map_to_feat.weight[0, 0] = float("nan")
    with pytest.raises(FloatingPointError, match=r"edgeconv \(kernel B2\)"):
        with profiling.nan_debugging():
            system.embed(batch["points"], dv)
    nan_cloud = torch.full((1, 64, 3), float("nan"), device="cuda")  # made before the checks
    with pytest.raises(FloatingPointError, match=r"knn \(kernel B1\)"):
        with profiling.nan_debugging():
            K.knn(nan_cloud, 4)
    with torch.no_grad():
        net.conv3.map_to_feat.weight[0, 0] = 0.0
        net.conv6.map_to_feat.weight[0, 0] = float("nan")
    with pytest.raises(FloatingPointError, match="nn_feat.conv6"):
        with profiling.nan_debugging():
            system.embed(batch["points"], dv)
    assert _get_current_dispatch_mode() is None and not torch.is_anomaly_enabled()
    assert not profiling.nan_debugging_enabled()


@pytest.mark.cuda
def test_an_eval_notebook_cell_on_the_card_equals_the_cpu(tmp_path):
    """examples/shapenet_eval_torch.ipynb's setup and helper cells, then its
    Airplane cell, on a checkpoint trained 20 epochs on the card by
    tools/parity_real_format_torch.py on the mini-ShapeNet-Part tree, on the
    card and on the CPU port: the embeddings within the eval forward's
    tolerance (atol 2e-4 / rtol 1e-3) and, on the card's embeddings, the
    CPU's rows equal to the card's (best k, true parts; scores within
    1e-5): a decode moves with rounding at near-tied distances.  B1 and B2
    launch 3 times each for the category's one batch."""
    require_cuda()
    import contextlib
    import io
    import os
    import sys

    tools = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")
    sys.path.insert(0, tools)
    import make_eval_notebook_torch as nbgen
    import make_mini_datasets_torch as minidata
    import parity_real_format_torch as prf

    with contextlib.redirect_stdout(io.StringIO()):
        minidata.make_shapenet(str(tmp_path / "data"))
        prf.run_torch("shapenet", 0, epochs=20, device="cuda", out=str(tmp_path / "logs"),
                      data=str(tmp_path / "data"))
    ckpt = prf.checkpoint_dir(str(tmp_path / "logs"), "shapenet", 0)
    (tmp_path / "examples").mkdir()
    rows, embedded, cwd, path = {}, {}, os.getcwd(), list(sys.path)
    try:
        os.chdir(tmp_path / "examples")
        for run, device in (("card", "cuda"), ("cpu", "cpu"), ("cpu_held", "cpu")):
            setup, helpers, airplane = nbgen.code_cells(nbgen.build(ckpt, device))[:3]
            ns, embedded[run] = {"__name__": "__main__"}, []
            with contextlib.redirect_stdout(io.StringIO()):
                exec(setup, ns)
                exec(helpers, ns)
            system, embed = ns["system"], ns["system"].embed

            def recorded(points, dv, idx_override=None, run=run, embed=embed, system=system):
                out = embed(points, dv, idx_override)
                embedded[run].append([t.cpu() for t in out])
                if run == "cpu_held":  # the card's embeddings
                    out = tuple(t.to(system.device) for t in embedded["card"][0])
                return out

            system.embed = recorded
            ns["PLOT"] = False
            before = (K.knn.launches, E.edgeconv_infer.launches)
            with contextlib.redirect_stdout(io.StringIO()):
                exec(airplane, ns)
            launched = (K.knn.launches - before[0], E.edgeconv_infer.launches - before[1])
            assert launched == ((3, 3) if device == "cuda" else (0, 0))
            rows[run] = ns["all_rows"]
    finally:
        os.chdir(cwd)
        sys.path[:] = path
    for got, want in zip(embedded["card"][0], embedded["cpu"][0]):
        torch.testing.assert_close(got, want, atol=2e-4, rtol=1e-3)
    assert len(rows["card"]) == len(rows["cpu_held"]) == 2
    for got, want in zip(rows["card"], rows["cpu_held"]):
        assert (got["best_k"], got["true_parts"]) == (want["best_k"], want["true_parts"])
        assert abs(got["score"] - want["score"]) <= 1e-5


@pytest.mark.cuda
def test_a_step_on_the_card_with_cpu_draws_is_the_cpu_step():
    # a CPU generator gives the card the CPU run's rotation, dropout masks
    # and triplets: the same losses up to rounding; fit takes it whole
    require_cuda()
    from hpcs_torch import trainer

    cfg = ModelConfig(num_class=6, num_categories=2, eucl_dim=8, hyp_dim=8, k=10)
    pts, cat, y = SyntheticPartDataset(4, 256, 2).batch(0, 4)
    batch = {"points": pts, "category": cat, "labels": y}
    logs = {}
    for device in ("cpu", "cuda"):
        system = HypHCSystem(cfg, device=device, generator=torch.Generator().manual_seed(0))
        logs[device] = system.train_step(batch, torch.Generator().manual_seed(3))
    for key in ("total_loss", "loss_metric", "loss_hyp"):
        torch.testing.assert_close(logs["cuda"][key].cpu(), logs["cpu"][key], rtol=1e-3, atol=0)
    system = HypHCSystem(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    _, best = trainer.fit(system, [batch], [batch], epochs=1, seed=3, log=lambda line: None,
                          generator_device="cpu")
    assert np.isfinite(best)
