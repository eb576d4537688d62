"""The port's parameter names are the reference's: its state_dict goes
through hpcs_tpu's torch importer and comes back equal to the flax params."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_port import randomize_batch_stats, to_numpy_tree
from hpcs_tpu.models import HypHCSystem as JSystem
from hpcs_tpu.models import ModelConfig as JConfig
from hpcs_tpu.utils.torch_import import convert_lightning_checkpoint, convert_vn_dgcnn
from hpcs_torch.models import HypHCSystem, ModelConfig
from hpcs_torch.utils.jax_params import from_jax_params


def _assert_trees_equal(got, want):
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.fixture(scope="module", params=[(8, 8), (8, 4)], ids=["expmap", "mlp_expmap"])
def converted(request):
    eucl, hyp = request.param
    kw = dict(num_class=10, num_categories=4, eucl_dim=eucl, hyp_dim=hyp, k=8)
    jsys = JSystem(JConfig(dataset="shapenet", fixed_points=32, **kw))
    batch = {"points": jnp.zeros((1, 32, 3)), "labels": jnp.zeros((1, 32), jnp.int32),
             "category": jnp.zeros((1,), jnp.int32)}
    state = jsys.init(jax.random.PRNGKey(1), batch)
    params = to_numpy_tree(state.params)
    stats = randomize_batch_stats(to_numpy_tree(state.batch_stats), np.random.default_rng(1))
    tsys = HypHCSystem(ModelConfig(**kw), device="cpu")
    tsys.net.load_state_dict(from_jax_params(params, stats))
    sd = {k: v.numpy() for k, v in tsys.net.state_dict().items()}
    return params, stats, sd


def test_backbone_keys_round_trip_through_convert_vn_dgcnn(converted):
    params, stats, sd = converted
    p, s = convert_vn_dgcnn(sd, prefix="nn_feat.")
    _assert_trees_equal(p, params["backbone"])
    _assert_trees_equal(s, stats["backbone"])


def test_full_net_round_trips_through_lightning_importer(converted):
    params, stats, sd = converted
    zeros = jax.tree_util.tree_map(np.zeros_like, params)
    p, s = convert_lightning_checkpoint(sd, zeros, {"backbone": {}})
    _assert_trees_equal(p, params)
    _assert_trees_equal(s, stats)


def test_state_dict_shapes_follow_the_reference(converted):
    _, _, sd = converted
    assert sd["nn_feat.conv6.map_to_dir.weight"].shape == (1, 63)  # shared nonlinearity
    assert sd["nn_feat.conv1.map_to_feat.weight"].shape == (21, 2)
    assert sd["nn_feat.std_feature.vn_lin.weight"].shape == (3, 682 // 4)
    assert sd["nn_feat.conv8.0.weight"].shape == (256, 2299, 1)
    assert sd["scale"].shape == (1,)
    assert sd["metric_hyp_loss.loss_cosface.W"].shape[1] == 10
