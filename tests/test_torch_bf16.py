"""VN-DGCNN's bf16 configuration (ModelConfig.bf16, --bf16) against hpcs_tpu
on the CPU: the VN layers, the EdgeConv stage (the plain one and kernel
B2's plain version), the eval forward with mean and max pooling, and
test_step, on shared weights (from_jax_params).

hpcs_tpu's bf16 path runs here through `bf16_einsum_on_cpu` (XLA:CPU
refuses its bf16 x bf16 = fp32 channel mixes; the replacement computes the
same function up to the order of the fp32 sums).

Tolerances.  bf16 keeps 8 significant bits: one rounding moves a value by
up to 2^-8 of itself, and one flipped rounding (two fp32 sums in another
order on either side of a bf16 boundary) by one bf16 ulp, 2^-7.  Layers
and the plain stage, where both packages round at the same points: within
BF16_ULPS bf16 ulp of the output's largest entry.  Where
the rounding points differ (B2's plain version is fp32 inside; the whole
forward) a witness holds the port: its distance from a float64 reference
(the port's float64 stage or forward on the same weights and graphs) at
most WITNESS times hpcs_tpu's bf16 distance from it, in the largest and
in the mean entry.  The two packages' bf16 outputs are then also held to
each other directly, within a share of the reference's largest entry:
STAGE_DIRECT_SHARE for a stage (2.1 % at stage 1, 0.3-0.4 % at stages 2
and 3), DIRECT_SHARE for the forward (0.9-1.0 % with mean pooling,
0.35-0.4 % with max pooling, B=2, N=64, k=8; these readings from
tools/bf16_readings.py).  Each
package builds its own graphs from its own bf16 stage inputs; the forward
is compared on the port's graphs, given to both (idx_override and
hpcs_tpu.ops.edgeconv.knn), and hpcs_tpu's kNN on the port's stage inputs
gives the port's graphs as sets (`_same_sets`).  hpcs_tpu's programs are
compiled to round where their source does (`jit_as_written`), as the port
does; the witness alone also holds the port against XLA's default
compilation, which drops some of those roundings.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (InjectedTriplets, bf16_einsum_on_cpu, jax_port_pair, jit_as_written,
                         rand_vn_llr, to_numpy_tree, torch_threads)
from hpcs_tpu.models.base import decode_vector_for_batch as j_decode_vector
from hpcs_tpu.nn.vn import layers as FL
from hpcs_tpu.ops import edgeconv as JE
from hpcs_tpu.ops.knn import knn_auto
from hpcs_torch.models.base import decode_batch
from hpcs_torch.nn.backbones import vn_dgcnn
from hpcs_torch.nn.vn import layers as TL
from hpcs_torch.ops import edgeconv as E
from hpcs_torch.ops.knn import knn_plain, knn_scores
from hpcs_torch.ops.vn_math import vn_leaky_relu

BF16_ULPS = 1
WITNESS = 2.0
DIRECT_SHARE = 0.03
STAGE_DIRECT_SHARE = 0.05
BF16 = torch.bfloat16


@pytest.fixture(scope="module", autouse=True)
def _bf16_on_cpu():
    """hpcs_tpu's bf16 einsums on this CPU, and 2 intra-op threads (small
    models: more threads per test worker only contend)."""
    with pytest.MonkeyPatch.context() as mp, torch_threads(2):
        bf16_einsum_on_cpu(mp)
        yield


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _both(x):
    """x rounded to bf16 in each package (round to nearest even in both)."""
    return torch.from_numpy(x).to(BF16), jnp.asarray(x).astype(jnp.bfloat16)


def _np(t):
    return (t.detach().float().numpy() if torch.is_tensor(t)
            else np.asarray(jnp.asarray(t).astype(jnp.float32)))


def _within_ulps(got, want, what):
    """got and want (bf16 outputs of the same function, rounded at the same
    points) within BF16_ULPS bf16 ulps of want's largest entry."""
    g, w = _np(got), _np(want)
    scale = np.abs(w).max()
    assert np.abs(g - w).max() <= BF16_ULPS * 2.0 ** -7 * scale, \
        f"{what}: {np.abs(g - w).max() / scale:.3e} of its largest entry"


@pytest.mark.parametrize("train", [False, True])
def test_vn_layers_match_jax_in_bf16(train):
    """VNLinearLeakyReLU (its BatchNorm with running statistics in eval, the
    flax rule in training, the statistics it moves), VNStdFeature, the gate,
    mean_pool and invariant_project on bf16 features: bf16 outputs."""
    rng = np.random.default_rng(1)
    params, stats, sd = rand_vn_llr(rng, 6, 7)
    x_t, x_j = _both(_x((2, 16, 6, 3), 2))
    m = TL.VNLinearLeakyReLU(6, 7).train(train)
    m.load_state_dict(sd)
    got = m(x_t)
    want = FL.VNLinearLeakyReLU(7).apply({"params": params, "batch_stats": stats}, x_j,
                                         train=train, mutable=["batch_stats"] if train else False)
    if train:
        want, new_stats = want
        bn = new_stats["batch_stats"]["batchnorm"]["bn"]
        np.testing.assert_allclose(m.batchnorm.bn.running_mean.numpy(), np.asarray(bn["mean"]),
                                   atol=1e-5, rtol=1e-4)
        np.testing.assert_allclose(m.batchnorm.bn.running_var.numpy(), np.asarray(bn["var"]),
                                   atol=1e-5, rtol=1e-4)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    _within_ulps(got, want, "VNLinearLeakyReLU")

    x_t, x_j = _both(_x((2, 8, 8, 3), 3))
    std = TL.VNStdFeature(8).train(train)
    flax = FL.VNStdFeature(normalize_frame=False)
    variables = flax.init(jax.random.PRNGKey(0), x_j.astype(jnp.float32), train=False)
    p = to_numpy_tree(variables["params"])
    for name in ("vn1", "vn2"):
        conv = getattr(std, name)
        conv.map_to_feat.weight.data = torch.from_numpy(p[name]["linear"]["kernel"].T.copy())
        conv.map_to_dir.weight.data = torch.from_numpy(p[name]["dir_kernel"].T.copy())
    std.vn_lin.weight.data = torch.from_numpy(p["frame_kernel"].T.copy())
    out = flax.apply(variables, x_j, train=train, mutable=["batch_stats"] if train else False)
    want_std, want_z0 = out[0] if train else out
    got_std, got_z0 = std(x_t)
    assert got_std.dtype == got_z0.dtype == BF16
    _within_ulps(got_z0, want_z0, "VNStdFeature frame")
    _within_ulps(got_std, want_std, "VNStdFeature features")

    (p_t, p_j), (d_t, d_j) = _both(_x((4, 9, 3), 4)), _both(_x((4, 9, 3), 5))
    np.testing.assert_array_equal(_np(vn_leaky_relu(p_t, d_t)),
                                  _np(FL._vn_leaky_relu(p_j, d_j, 0.2)))
    e_t, e_j = _both(_x((2, 5, 8, 4, 3), 6))
    np.testing.assert_array_equal(_np(TL.mean_pool(e_t)), _np(FL.mean_pool(e_j)))
    z_t, z_j = _both(_x((2, 5, 3, 3), 7))
    _within_ulps(TL.invariant_project(e_t[:, :, 0], z_t),
                 FL.invariant_project(e_j[:, :, 0], z_j), "invariant_project")


def test_vn_max_pool_matches_jax_in_bf16():
    """VNMaxPool on bf16 features: the bf16 dot products and first_argmax
    choose the same vector as hpcs_tpu's argmax, ties included."""
    x_t, x_j = _both(_x((2, 7, 8, 5, 3), 8))
    W = _x((5, 5), 9)
    m = TL.VNMaxPool(5)
    m.map_to_dir.weight.data = torch.from_numpy(W)
    want = FL.VNMaxPool().apply({"params": {"dir_kernel": W.T}}, x_j)
    np.testing.assert_array_equal(_np(m(x_t)), _np(want))


def _stage_weights(rng, c, n_convs):
    return [rand_vn_llr(rng, 2 * c, 21)] + ([rand_vn_llr(rng, 21, 21)] if n_convs == 2 else [])


@pytest.mark.parametrize("c,n_convs", [(1, 2), (21, 2), (21, 1)])
def test_edge_stage_matches_jax_in_bf16(c, n_convs):
    """One eval EdgeConv stage on bf16 features and a shared graph.  The
    plain stage (graph_feature_vn, the VNLinearLeakyReLU modules, mean_pool)
    rounds where hpcs_tpu's does: within BF16_ULPS of it.  Kernel B2's plain
    version (edgeconv_infer_plain on bf16: fp32 inside, bf16-rounded
    weights, the output rounded once) is held by the witness against the
    float64 stage."""
    rng = np.random.default_rng(10 + c)
    x = _x((2, 48, c, 3), c)
    x_t, x_j = _both(x)
    idx = knn_plain(x_t.reshape(2, 48, -1), 8)
    convs = _stage_weights(rng, c, n_convs)
    modules = []
    for _, _, sd in convs:
        m = TL.VNLinearLeakyReLU(sd["map_to_feat.weight"].shape[1], 21).eval()
        m.load_state_dict(sd)
        modules.append(m)
    e, _ = E.graph_feature_vn(x_t, 8, idx)
    for m in modules:
        e = m(e)
    plain = TL.mean_pool(e)

    e_j, _ = JE.graph_feature_vn(x_j, 8, idx=jnp.asarray(idx.numpy()))
    for params, stats, _ in convs:
        e_j = FL.VNLinearLeakyReLU(21).apply({"params": params, "batch_stats": stats}, e_j,
                                             train=False)
    want = FL.mean_pool(e_j)
    assert plain.dtype == BF16 and want.dtype == jnp.bfloat16
    _within_ulps(plain, want, "plain stage")

    weights = [w.detach() for w in vn_dgcnn.stage_weights(*modules)]
    kernel_plain = E.edgeconv_infer(x_t, idx, *weights, n_convs=n_convs)  # CPU: the plain version
    assert kernel_plain.dtype == BF16
    ref = E.edgeconv_infer_plain(x_t.double(), idx, *[w.double() for w in weights],
                                 n_convs=n_convs).numpy()
    _witness(_np(kernel_plain), _np(want), ref, "B2's plain version", STAGE_DIRECT_SHARE)


def _witness(got, want, ref, what, direct_share=DIRECT_SHARE):
    """got at most WITNESS times as far from ref as want, in the largest and
    the mean entry; got and want within `direct_share` of ref's largest
    entry.  Returns the three distances as shares of that entry."""
    scale = np.abs(ref).max()
    d, dj = np.abs(got - ref), np.abs(want - ref)
    assert d.max() <= WITNESS * dj.max(), f"{what}: {d.max():.3e} from float64, JAX {dj.max():.3e}"
    assert d.mean() <= WITNESS * dj.mean(), \
        f"{what}: mean {d.mean():.3e} from float64, JAX {dj.mean():.3e}"
    direct = np.abs(got - want).max() / scale
    assert direct <= direct_share, f"{what}: {direct:.3e} of its largest entry from JAX's"
    return d.max() / scale, dj.max() / scale, direct


def _same_sets(x, graph, k=8):
    """hpcs_tpu's kNN on the port's bf16 stage input x (both rank the fp32
    values of x) gives the port's graph as sets: each row the same
    neighbours, except where the k-th and (k+1)-th float64 scores of the
    row lie within 1e-6 of its largest |score| (a near-tie at the boundary,
    which the packages' fp32 scores may break either way); there the
    neighbours that differ must be among the near-tied ones."""
    want = np.sort(np.asarray(knn_auto(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16), k)),
                   -1)
    got = np.sort(graph.numpy(), -1)
    rows = np.nonzero((got != want).any(-1))
    if rows[0].size:
        scores = knn_scores(x.double()).numpy()[rows]  # [R, N]
        top = -np.sort(-scores, -1)
        scale = np.abs(scores).max(-1)
        assert (top[:, k - 1] - top[:, k] <= 1e-6 * scale).all(), "graphs differ beyond near-ties"
        for r, (b, n) in enumerate(zip(*rows)):
            for j in np.setxor1d(got[b, n], want[b, n]):
                assert top[r, k - 1] - scores[r, j] <= 1e-6 * scale[r]
    return len(rows[0])


def _port_graphs(tsys, points, dv):
    """The port's bf16 eval forward, its stage inputs and its graphs."""
    pairs = []
    real = vn_dgcnn.knn

    def knn(x, k):
        pairs.append((x, real(x, k)))
        return pairs[-1][1]

    vn_dgcnn.knn = knn
    try:
        out = tsys.embed(points, dv)
    finally:
        vn_dgcnn.knn = real
    return out, pairs


def _float64_forward(tsys, points, dv, graphs):
    """The port's forward on the same weights and graphs in float64
    throughout (the backbone's bf16 compute dtype dropped)."""
    net = copy.deepcopy(tsys.net).double().eval()
    net.nn_feat.compute_dtype = None
    with torch.no_grad():
        return [t.numpy() for t in net(torch.as_tensor(points).double(),
                                       torch.as_tensor(np.asarray(dv)).double(),
                                       idx_override=graphs)]


def _jax_on_graphs(monkeypatch, graphs):
    """Within the test, hpcs_tpu's EdgeConv stages take `graphs` in order."""
    it = iter([jnp.asarray(g.numpy()) for g in graphs])
    monkeypatch.setattr(JE, "knn", lambda x, k: next(it))


@pytest.fixture(scope="module", params=["mean", "max"])
def bf16_pair(request):
    """(pooling, JAX system, its state with random batch statistics, port
    system on its weights, batch), bf16, B=2, N=64, k=8."""
    jsys, state, tsys, batch = jax_port_pair(eucl=8, hyp=4, B=2, N=64, k=8, random_stats=True,
                                             bf16=True, pooling=request.param,
                                             test_rotation="none")
    return request.param, jsys, state, tsys, batch


def test_eval_forward_matches_jax_in_bf16(bf16_pair, monkeypatch):
    """The bf16 eval forward: stage 1's graph on bf16 coordinates, the three
    graphs the same sets as hpcs_tpu's kNN gives on the port's stage
    inputs, and on the port's graphs the output held by the witness
    against the port's float64 forward, and within DIRECT_SHARE of
    hpcs_tpu's bf16 output."""
    pooling, jsys, state, tsys, batch = bf16_pair
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    dv = j_decode_vector(jsys.cfg, jbatch)
    got, pairs = _port_graphs(tsys, batch["points"], np.asarray(dv))
    assert [x.dtype for x, _ in pairs] == [BF16] * 3
    torch.testing.assert_close(pairs[0][0], torch.from_numpy(batch["points"]).to(BF16))
    for x, g in pairs:
        _same_sets(x, g)
    graphs = [g for _, g in pairs]
    ref = _float64_forward(tsys, batch["points"], dv, graphs)
    args = ({"params": state.params, "batch_stats": state.batch_stats}, jbatch["points"], dv)

    def apply(v, p, d):
        return jsys.net.apply(v, p, d, train=False)

    for as_written in (True, False):
        _jax_on_graphs(monkeypatch, graphs)
        want = (jit_as_written(apply, *args) if as_written else jax.jit(apply))(*args)
        for g, w, r, what in zip(got, want, ref, ("x_euclidean", "x_poincare")):
            assert g.dtype == torch.float32 and w.dtype == jnp.float32
            if as_written:
                _witness(g.numpy(), np.asarray(w), r, f"{pooling} {what}")
            else:  # XLA's default: excess precision (jit_as_written), the witness alone
                _witness(g.numpy(), np.asarray(w), r, f"{pooling} {what}", direct_share=1.0)


def test_test_step_matches_jax_in_bf16(bf16_pair, monkeypatch):
    """test_step in bf16 on the port's graphs: the embeddings as in the eval
    forward, the losses on hpcs_tpu's triplets within the embeddings' share
    (DIRECT_SHARE, relative), and the decode of hpcs_tpu's own embeddings
    equal to its prediction, best k and best score exactly (the decode is
    fp32 in both packages)."""
    pooling, jsys, state, tsys, batch = bf16_pair
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    _, pairs = _port_graphs(tsys, batch["points"], np.asarray(j_decode_vector(jsys.cfg, jbatch)))
    _jax_on_graphs(monkeypatch, [g for _, g in pairs])
    key = jax.random.PRNGKey(1)
    args = (state, jbatch, key, jnp.float32(0.1))
    jlogs, jext = jit_as_written(jsys.test_step, *args)(*args)
    _, k_loss = jax.random.split(key)
    InjectedTriplets(monkeypatch).add(k_loss, jbatch["labels"], jext["x_poincare"], jsys.cfg)
    monkeypatch.setattr(vn_dgcnn, "knn", lambda x, k, it=iter(pairs): next(it)[1])
    tsys.temperature = 0.1
    logs, ext = tsys.test_step(batch, torch.Generator().manual_seed(1))
    np.testing.assert_allclose(float(logs["test_loss"]), float(jlogs["test_loss"]),
                               rtol=DIRECT_SHARE)
    for name in ("x_poincare", "x_euclidean"):
        g, w = ext[name].numpy(), np.asarray(jext[name])
        assert np.abs(g - w).max() <= DIRECT_SHARE * np.abs(w).max(), name
    got = decode_batch(torch.from_numpy(np.array(jext["x_poincare"])),
                       torch.from_numpy(batch["labels"]), tsys.net.scale[0].detach(), 6)
    for g, name in zip(got[:3], ("pred", "best_k", "best_score")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(jext[name]), err_msg=name)
    assert 0 <= float(logs["score"]) <= 1


def _rot(seed):
    from scipy.spatial.transform import Rotation

    return Rotation.random(random_state=seed).as_matrix().astype(np.float32)


def test_bf16_forward_is_so3_invariant():
    """The port's bf16 forward (mean pooling) on a cloud and on the cloud
    rotated, each on its own graphs, as hpcs_tpu's
    test_vn_dgcnn_bf16_so3_invariance holds its own (on the TPU): within
    0.05 of the output's largest entry + 0.02."""
    from hpcs_torch.models import HypHCSystem, ModelConfig

    cfg = ModelConfig(num_class=6, num_categories=16, eucl_dim=8, hyp_dim=4, k=8, bf16=True)
    tsys = HypHCSystem(cfg, device="cpu", generator=torch.Generator().manual_seed(2))
    pts = np.random.default_rng(3).standard_normal((2, 64, 3)).astype(np.float32)
    dv = torch.nn.functional.one_hot(torch.zeros(2, dtype=torch.int64), 16).float()
    out0 = tsys.embed(pts, dv)[0]
    out1 = tsys.embed(pts @ _rot(4).T, dv)[0]
    scale = float(out0.abs().max())
    assert float((out0 - out1).abs().max()) < 0.05 * scale + 0.02
