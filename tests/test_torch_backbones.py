"""The other backbones (DGCNN, PointNet, VN-PointNet) and VN-DGCNN with max
pooling against hpcs_tpu on the CPU: their graph features and VN layers,
the eval forward of each on shared weights (from_jax_params) with random
batch statistics, and Riemannian Adam's state on each parameter tree.

Tolerances.  Graph features: exactly equal on a shared graph.  VN layers:
atol 1e-5 / rtol 1e-4 (the same fp32 math in another order; VNMaxPool's
choice exactly, ties included).  Eval forward: atol 2e-4 / rtol 1e-3, as
tests/test_torch_forward.py.  Each package builds its own kNN graphs; the
graphs are compared first, from the port's recorded stage inputs (the
same neighbour sets exactly, see _same_graph), then the outputs.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_port_pair, numpy_opt_state, rand_vn_llr, to_numpy_tree, torch_threads
from hpcs_tpu.models.base import decode_vector_for_batch as j_decode_vector
from hpcs_tpu.nn.vn import layers as FL
from hpcs_tpu.ops import edgeconv as JE
from hpcs_tpu.ops.knn import knn_auto
from hpcs_torch.nn.backbones import vn_dgcnn
from hpcs_torch.nn.vn import layers as TL
from hpcs_torch.ops import edgeconv as E
from hpcs_torch.ops.knn import knn_plain, knn_scores
from hpcs_torch.utils.jax_params import _params_sd, from_jax_opt_state

TOL = dict(atol=2e-4, rtol=1e-3)
LAYER_TOL = dict(atol=1e-5, rtol=1e-4)
CONFIGS = {
    "dgcnn": dict(model_name="dgcnn_partseg", eucl=6),
    "pointnet": dict(model_name="pointnet_partseg", eucl=6),
    "vn_pointnet": dict(model_name="vn_pointnet_partseg", eucl=6),
    "vn_pointnet_max": dict(model_name="vn_pointnet_partseg", pooling="max", eucl=6),
    "vn_dgcnn_max": dict(model_name="vn_dgcnn_partseg", pooling="max", eucl=8),
}
GRAPHS = {"dgcnn": 4, "pointnet": 0, "vn_pointnet": 1, "vn_pointnet_max": 1, "vn_dgcnn_max": 3}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Small models: more intra-op threads per test worker only contend."""
    with torch_threads(2):
        yield


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("fn,C", [("scalar", 5), ("cross_vn", 1), ("cross_vn", 4)])
def test_graph_features_equal_jax(fn, C):
    x = _x((2, 40, C) if fn == "scalar" else (2, 40, C, 3))
    idx = knn_plain(torch.from_numpy(x.reshape(2, 40, -1)), 8)
    got, got_idx = getattr(E, f"graph_feature_{fn}")(torch.from_numpy(x), 8, idx)
    want, _ = getattr(JE, f"graph_feature_{fn}")(jnp.asarray(x), 8, idx=jnp.asarray(idx.numpy()))
    assert got_idx is idx
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # without idx each builds its graph on the flattened features: the same one
    built, built_idx = getattr(E, f"graph_feature_{fn}")(torch.from_numpy(x), 8)
    torch.testing.assert_close(built_idx, idx, rtol=0, atol=0)
    np.testing.assert_array_equal(built.numpy(), np.asarray(want))


def test_vn_max_pool_matches_jax_ties_to_the_first():
    """Identity directions make <x, d> = |x|^2; the vectors are integer
    permutations of one another, so every channel's dot products tie
    exactly between different vectors: both must take the first."""
    rng = np.random.default_rng(3)
    base = rng.integers(-3, 4, size=(2, 5, 1, 4, 3)).astype(np.float32)
    perms = [rng.permutation(3) for _ in range(6)]
    x = np.concatenate([base[..., p] for p in perms], axis=2)  # [2, 5, K=6, C=4, 3]
    W = np.eye(4, dtype=np.float32)
    m = TL.VNMaxPool(4)
    m.map_to_dir.weight.data = torch.from_numpy(W)
    got = m(torch.from_numpy(x))
    want = FL.VNMaxPool().apply({"params": {"dir_kernel": W.T}}, jnp.asarray(x))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.detach().numpy(), x[:, :, 0])  # all tie: the first
    # random directions and inputs, pooled over K and over N ([B, N, C, 3])
    for shape in ((2, 7, 8, 5, 3), (2, 9, 5, 3)):
        x = _x(shape, 4)
        W = _x((5, 5), 5)
        m.map_to_dir = torch.nn.Linear(5, 5, bias=False)
        m.map_to_dir.weight.data = torch.from_numpy(W)
        want = FL.VNMaxPool().apply({"params": {"dir_kernel": W.T}}, jnp.asarray(x))
        np.testing.assert_array_equal(m(torch.from_numpy(x)).detach().numpy(), np.asarray(want))


def test_first_argmax_takes_the_first_tie_and_nan():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0], [float("nan"), 1.0, float("nan"), 5.0],
                      [0.0, 0.0, 0.0, 0.0]])
    np.testing.assert_array_equal(TL.first_argmax(x, dim=1).numpy(),
                                  np.asarray(jnp.argmax(jnp.asarray(x.numpy()), axis=1)))
    np.testing.assert_array_equal(TL.first_argmax(x.t(), dim=0).numpy(), [1, 0, 0])


@pytest.mark.parametrize("share", [False, True])
def test_vn_leaky_relu_module_matches_jax(share):
    x = _x((2, 16, 6, 3))
    W = _x((1 if share else 6, 6), 1)
    m = TL.VNLeakyReLU(6, share_nonlinearity=share)
    m.map_to_dir.weight.data = torch.from_numpy(W)
    want = FL.VNLeakyReLU(share_nonlinearity=share).apply(
        {"params": {"dir_kernel": W.T}}, jnp.asarray(x))
    np.testing.assert_allclose(m(torch.from_numpy(x)).detach().numpy(), np.asarray(want),
                               **LAYER_TOL)


@pytest.mark.parametrize("train", [False, True])
def test_slope_zero_vn_layers_match_jax(train):
    """VN-PointNet's slope-0 VNLinearLeakyReLU, and its VNStdFeature at
    1364 channels, in eval (running statistics) and in training (batch
    statistics)."""
    rng = np.random.default_rng(6)
    params, stats, sd = rand_vn_llr(rng, 5, 7)
    x = _x((2, 16, 5, 3), 7)
    m = TL.VNLinearLeakyReLU(5, 7, negative_slope=0.0)
    m.load_state_dict(sd)
    m.train(train)
    flax = FL.VNLinearLeakyReLU(7, negative_slope=0.0)
    want = flax.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=train,
                      mutable=["batch_stats"] if train else False)
    want = want[0] if train else want
    np.testing.assert_allclose(m(torch.from_numpy(x)).detach().numpy(), np.asarray(want),
                               **LAYER_TOL)

    x = _x((2, 8, 1364, 3), 8)
    std = TL.VNStdFeature(1364, negative_slope=0.0).train(train)
    flax = FL.VNStdFeature(normalize_frame=False, negative_slope=0.0)
    variables = flax.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    p = to_numpy_tree(variables["params"])
    for name in ("vn1", "vn2"):
        conv = getattr(std, name)
        conv.map_to_feat.weight.data = torch.from_numpy(p[name]["linear"]["kernel"].T.copy())
        conv.map_to_dir.weight.data = torch.from_numpy(p[name]["dir_kernel"].T.copy())
    std.vn_lin.weight.data = torch.from_numpy(p["frame_kernel"].T.copy())
    out = flax.apply(variables, jnp.asarray(x), train=train,
                     mutable=["batch_stats"] if train else False)
    (want_std, want_z0) = out[0] if train else out
    got_std, got_z0 = std(torch.from_numpy(x))
    np.testing.assert_allclose(got_z0.detach().numpy(), np.asarray(want_z0), **TOL)
    np.testing.assert_allclose(got_std.detach().numpy(), np.asarray(want_std), **TOL)


def _same_graph(x, k=8):
    """hpcs_tpu's kNN on a stage input of the port gives the port's graph:
    the same neighbour sets exactly (every stage pools over the neighbours,
    so their order does not reach the output), in the same order except
    between two neighbours whose float64 scores differ by at most 1e-6 of
    the row's largest |score|: the packages' fp32 scores round differently
    (at N=96, D=64, DGCNN's fourth graph swaps one such pair)."""
    got, want = knn_plain(x, k).numpy(), np.asarray(knn_auto(jnp.asarray(x.numpy()), k))
    np.testing.assert_array_equal(np.sort(got, -1), np.sort(want, -1))
    b, n, j = np.nonzero(got != want)
    scores = knn_scores(x.double()).numpy()
    gap = np.abs(scores[b, n, got[b, n, j]] - scores[b, n, want[b, n, j]])
    assert (gap <= 1e-6 * np.abs(scores[b, n]).max(-1)).all()


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    """(config name, JAX system, its state with random batch statistics,
    port system on its weights, batch)."""
    over = dict(CONFIGS[request.param])
    eucl = over.pop("eucl")
    jsys, state, tsys, batch = jax_port_pair(eucl=eucl, hyp=4, B=2, N=96, k=8,
                                             random_stats=True, **over)
    return request.param, jsys, state, tsys, batch


def test_eval_forward_matches_jax(pair, monkeypatch):
    name, jsys, state, tsys, batch = pair
    inputs = []
    real_knn = vn_dgcnn.knn
    monkeypatch.setattr(vn_dgcnn, "knn", lambda x, k: inputs.append(x) or real_knn(x, k))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    dv = j_decode_vector(jsys.cfg, jbatch)
    got_e, got_p = tsys.embed(batch["points"], np.asarray(dv))
    assert len(inputs) == GRAPHS[name]
    for x in inputs:
        _same_graph(x)
    apply = jax.jit(lambda v, p, d: jsys.net.apply(v, p, d, train=False))
    want_e, want_p = apply({"params": state.params, "batch_stats": state.batch_stats},
                           jbatch["points"], dv)
    assert got_e.shape == (2, 96, jsys.cfg.eucl_dim)
    np.testing.assert_allclose(got_e.numpy(), np.asarray(want_e), **TOL)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), **TOL)
    if name.startswith(("pointnet", "vn_pointnet")):  # log-probabilities
        np.testing.assert_allclose(got_e.exp().sum(-1).numpy(), 1.0, atol=1e-5)


def test_riemannian_adam_state_matches_jax(pair):
    """One Riemannian Adam step from the same parameters and gradients in
    both packages (random gradients: no forward): the port's new
    parameters and moments equal hpcs_tpu's packed state read through
    from_jax_opt_state, so every leaf's ball axis (`ball_dim`) is the one
    hpcs_tpu packs it along.  atol 1e-6 / rtol 1e-5: the same update in
    fp32."""
    name, jsys, state, tsys, batch = pair
    tsys = copy.deepcopy(tsys)
    params = to_numpy_tree(state.params)
    rng = np.random.default_rng(1)
    grads = jax.tree_util.tree_map(
        lambda p: (0.1 * rng.standard_normal(np.shape(p))).astype(np.float32), params)
    updates, opt = jax.jit(jsys.tx.update)(grads, state.opt_state, state.params)
    new_params = to_numpy_tree(jax.tree_util.tree_map(lambda p, u: p + u, state.params, updates))
    port_grads = _params_sd(grads)
    for n, p in tsys.net.named_parameters():
        p.grad = port_grads[n].reshape(p.shape).clone()
    tsys.apply_gradients()
    moments = from_jax_opt_state(numpy_opt_state(opt), new_params)
    want = _params_sd(new_params)
    assert set(moments) == {n for n, _ in tsys.net.named_parameters()}
    for n, p in tsys.net.named_parameters():
        st = tsys.optimizer.state[p]
        np.testing.assert_allclose(p.detach().numpy(), want[n].reshape(p.shape).numpy(),
                                   atol=1e-6, rtol=1e-5, err_msg=n)
        for key in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_allclose(st[key].numpy(), moments[n][key].numpy(), atol=1e-6,
                                       rtol=1e-5, err_msg=f"{n} {key}")
        assert st["step"] == moments[n]["step"] == 1


def _near_tie_points(net, points, dv, graphs, rel=2e-6):
    """[B, N] mask of the points where a VNMaxPool over the neighbours
    chooses between two vectors whose dot products with their direction
    differ by at most `rel` of the largest |x| |d|, in a float64 copy of the
    net on the given graphs: fp32 may choose either there."""
    from hpcs_torch.ops.vn_math import channel_mix

    net64, ties = copy.deepcopy(net).double().eval(), []

    def hook(module, inputs, _):
        x = inputs[0]
        if x.dim() == 5:  # [B, N, K, C, 3]: pooled over K
            d = channel_mix(x, module.map_to_dir.weight)
            top2 = (x * d).sum(-1).topk(2, dim=2).values
            scale = (x.norm(dim=-1) * d.norm(dim=-1)).amax(dim=2)  # the dot's terms
            ties.append(((top2[:, :, 0] - top2[:, :, 1]) <= rel * scale).any(-1))

    hooks = [m.register_forward_hook(hook) for m in net64.modules()
             if isinstance(m, TL.VNMaxPool)]
    with torch.no_grad():
        net64(points.double(), dv.double(), idx_override=graphs)
    for h in hooks:
        h.remove()
    return torch.stack(ties).any(0) if ties else torch.zeros(points.shape[:2], dtype=torch.bool)


@pytest.mark.slow
@pytest.mark.parametrize("config", list(CONFIGS))
def test_eval_forward_matches_jax_at_flagship_width(config, monkeypatch):
    """As test_eval_forward_matches_jax at N=1024, k=20, 16 categories and
    50 classes, except at the points where a VNMaxPool over the neighbours
    is a near-tie in float64, its top two dot products within 2e-6 of the
    largest |x| |d| (_near_tie_points; at most 1 % of the points): at
    VN-PointNet's conv_pos one point of 2048 flips between the packages
    there (its gap 1.1e-6; 0.05 from float64 in the port, 1.5e-6 in JAX)."""
    over = dict(CONFIGS[config])
    eucl = 32 if over.pop("eucl") == 8 else 50
    jsys, state, tsys, batch = jax_port_pair(eucl=eucl, hyp=32, B=2, N=1024, k=20,
                                             random_stats=True, num_class=50,
                                             num_categories=16, **over)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    dv = j_decode_vector(jsys.cfg, jbatch)
    graphs = []
    real_knn = vn_dgcnn.knn
    monkeypatch.setattr(vn_dgcnn, "knn", lambda x, k: graphs.append(real_knn(x, k)) or graphs[-1])
    got = tsys.embed(batch["points"], np.asarray(dv))
    ties = _near_tie_points(tsys.net.nn_feat, torch.from_numpy(batch["points"]),
                            torch.from_numpy(np.asarray(dv)), graphs).numpy()
    assert ties.mean() <= 0.01
    want = jax.jit(lambda v, p, d: jsys.net.apply(v, p, d, train=False))(
        {"params": state.params, "batch_stats": state.batch_stats}, jbatch["points"], dv)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy()[~ties], np.asarray(w)[~ties], **TOL)
