"""The port's eval forward (HypHCSystem.embed on the CPU) vs hpcs_tpu's
flax graph (system.net.apply, train=False) and vn_dgcnn_fast_forward, on
shared weights with random batch statistics.  Tolerance atol 2e-4 / rtol
1e-3, as hpcs_tpu's own engine-vs-graph test uses: the head sums 2299
inputs in another order."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import randomize_batch_stats, to_numpy_tree
from hpcs_tpu.data.synthetic import SyntheticPartDataset as JSyntheticPartDataset
from hpcs_tpu.models import HypHCSystem as JSystem
from hpcs_tpu.models import ModelConfig as JConfig
from hpcs_tpu.models.inference import vn_dgcnn_fast_forward
from hpcs_torch.data import SyntheticPartDataset
from hpcs_torch.models import HypHCSystem, ModelConfig, decode_vector_for_batch
from hpcs_torch.nn.backbones.vn_dgcnn import stage_weights
from hpcs_torch.ops import edgeconv as E
from hpcs_torch.ops import knn as K
from hpcs_torch.utils.jax_params import from_jax_params

TOL = dict(atol=2e-4, rtol=1e-3)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pair(eucl, hyp, N, k, B=2, C=4, seed=0):
    """(jax system, variables, port system, points, categories) on shared weights."""
    kw = dict(num_class=10, num_categories=C, eucl_dim=eucl, hyp_dim=hyp, k=k)
    jsys = JSystem(JConfig(dataset="shapenet", fixed_points=N, **kw))
    pts, cat, _ = SyntheticPartDataset(B, N, C, seed=seed).batch(0, B)
    batch = {"points": jnp.asarray(pts), "labels": jnp.zeros((B, N), jnp.int32),
             "category": jnp.asarray(cat.astype(np.int32))}
    state = jsys.init(jax.random.PRNGKey(seed), batch)
    params = to_numpy_tree(state.params)
    stats = randomize_batch_stats(to_numpy_tree(state.batch_stats), np.random.default_rng(seed))
    tsys = HypHCSystem(ModelConfig(**kw), device="cpu")
    tsys.net.load_state_dict(from_jax_params(params, stats))
    return jsys, {"params": params, "batch_stats": stats}, tsys, pts, cat


@pytest.mark.parametrize("eucl,hyp", [(8, 8), (8, 4)])
def test_embed_matches_flax_graph_and_fast_forward(eucl, hyp):
    jsys, variables, tsys, pts, cat = _pair(eucl, hyp, N=96, k=8)
    dv = decode_vector_for_batch(tsys.cfg, {"points": pts, "category": cat})
    got_e, got_p = tsys.embed(pts, dv)
    assert got_e.shape == (2, 96, eucl) and got_p.shape == (2, 96, hyp)

    apply = jax.jit(lambda v, p, d: jsys.net.apply(v, p, d, train=False))
    want_e, want_p = apply(variables, jnp.asarray(pts), jnp.asarray(dv.numpy()))
    np.testing.assert_allclose(got_e.numpy(), np.asarray(want_e), **TOL)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), **TOL)

    fast_e, fast_p = vn_dgcnn_fast_forward(variables["params"], variables["batch_stats"],
                                           jnp.asarray(pts), jnp.asarray(dv.numpy()), k=8)
    np.testing.assert_allclose(got_e.numpy(), np.asarray(fast_e), **TOL)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(fast_p), **TOL)


@pytest.mark.slow
def test_embed_matches_flax_graph_at_flagship_width():
    jsys, variables, tsys, pts, cat = _pair(32, 32, N=1024, k=20, C=16)
    dv = decode_vector_for_batch(tsys.cfg, {"points": pts, "category": cat})
    got_e, got_p = tsys.embed(pts, dv)
    apply = jax.jit(lambda v, p, d: jsys.net.apply(v, p, d, train=False))
    want_e, want_p = apply(variables, jnp.asarray(pts), jnp.asarray(dv.numpy()))
    np.testing.assert_allclose(got_e.numpy(), np.asarray(want_e), **TOL)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), **TOL)


def test_idx_override_feeds_the_graphs():
    _, _, tsys, pts, cat = _pair(8, 8, N=64, k=8)
    dv = decode_vector_for_batch(tsys.cfg, {"points": pts, "category": cat})
    x = torch.from_numpy(pts)
    idx1 = K.knn(x, 8)
    want = tsys.embed(pts, dv)
    # the graphs the forward builds itself reproduce its output
    net = tsys.net.nn_feat
    x1 = E.edgeconv_infer(x[:, :, None], idx1, *_stage(net.conv1, net.conv2))
    idx2 = K.knn(x1.reshape(2, 64, -1), 8)
    x2 = E.edgeconv_infer(x1, idx2, *_stage(net.conv3, net.conv4))
    idx3 = K.knn(x2.reshape(2, 64, -1), 8)
    got = tsys.embed(pts, dv, idx_override=(idx1, idx2, idx3))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    # and a different graph changes it
    other = tsys.embed(pts, dv, idx_override=(idx1.flip(-1), idx2, idx3))
    assert not torch.equal(other[0], want[0])


def _stage(*convs):
    return [t.detach() for t in stage_weights(*convs)]


def test_synthetic_data_matches_jax_package():
    a, b = SyntheticPartDataset(6, 100, 4, seed=3), JSyntheticPartDataset(6, 100, 4, seed=3)
    for i in range(6):
        for x, y in zip(a[i], b[i]):
            np.testing.assert_array_equal(x, y)


def test_no_gpu_and_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HypHCSystem(ModelConfig())
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_max_pooling_config_builds_and_embeds():
    """ModelConfig(pooling="max"): VN-DGCNN with VNMaxPool after each
    EdgeConv stage (pool1..pool3), on the plain stage in eval too."""
    cfg = ModelConfig(pooling="max", num_class=6, num_categories=2, eucl_dim=4, hyp_dim=4, k=4)
    tsys = HypHCSystem(cfg, device="cpu")
    names = {n.split(".")[1] for n, _ in tsys.net.named_parameters() if n.startswith("nn_feat.")}
    assert {"pool1", "pool2", "pool3"} <= names
    pts = np.random.default_rng(0).standard_normal((2, 32, 3)).astype(np.float32)
    x_e, x_p = tsys.embed(pts, decode_vector_for_batch(cfg, {"points": pts, "category": [0, 1]}))
    assert x_e.shape == (2, 32, 4) and bool((x_p.norm(dim=-1) < 1).all())


def test_port_runs_without_jax():
    """The port imports and runs a CPU forward with jax unimportable."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['hpcs_tpu'] = None\n"
        "import numpy as np, hpcs_torch.models as m, hpcs_torch.ops.edgeconv, "
        "hpcs_torch.utils.jax_params, hpcs_torch.data, hpcs_torch.decode, "
        "hpcs_torch.trainer, hpcs_torch.utils.rotations, hpcs_torch.miner, hpcs_torch.optim, "
        "hpcs_torch.loss, hpcs_torch.utils.metrics, hpcs_torch.geometry.lca, torch\n"
        "cfg = m.ModelConfig(num_class=6, num_categories=2, eucl_dim=4, hyp_dim=3, k=4)\n"
        "s = m.HypHCSystem(cfg, device='cpu')\n"
        "x = np.random.default_rng(0).standard_normal((1, 32, 3)).astype(np.float32)\n"
        "e, p = s.embed(x, m.decode_vector_for_batch(cfg, {'points': x, 'category': [1]}))\n"
        "assert p.shape == (1, 32, 3) and bool((p.norm(dim=-1) < 1).all())\n"
        "batch = {'points': x, 'category': [1], 'labels': np.arange(32)[None] % 6}\n"
        "logs = hpcs_torch.trainer.test(s, [batch])\n"
        "assert 0 <= logs['score'] <= 1\n"
        "train = s.train_step(batch, torch.Generator().manual_seed(0))\n"
        "assert s.step == 1 and float(train['total_loss']) > 0\n"
        "state, best = hpcs_torch.trainer.fit(s, [batch], [batch], epochs=1, log=lambda m: None)\n"
        "assert state['step'] == 2\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'hpcs_tpu', 'flax'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True, timeout=300)

