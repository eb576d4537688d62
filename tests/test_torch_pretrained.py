"""The pretrained-backbone graft (--pretrained) against hpcs_tpu's
(`hpcs_tpu.utils.torch_import.graft_pretrained_backbone`), on checkpoints
the tests write: a seeded VN-DGCNN backbone's state_dict in the
`model.partseg.vn_dgcnn.aligned.t7` format (`module.`-prefixed keys) and
the `best_model.pth` one (`model_state_dict`).  Both packages graft the
same file onto the same fresh model; their eval forwards must agree within
atol 2e-4 / rtol 1e-3 (tests/test_torch_forward.py's tolerance), and the
grafted tensors must equal the file's exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_port_pair, to_numpy_tree, torch_threads
from hpcs_tpu.models.base import decode_vector_for_batch as j_decode_vector
from hpcs_tpu.utils.torch_import import graft_pretrained_backbone as j_graft
from hpcs_tpu.utils.torch_import import load_raw_backbone_state_dict as j_load
from hpcs_torch import train
from hpcs_torch.models import HypHCSystem, ModelConfig
from hpcs_torch.models.base import init_parameters
from hpcs_torch.nn.backbones import VNDGCNNPartSeg
from hpcs_torch.utils.jax_params import from_jax_params
from hpcs_torch.utils.pretrained import graft_pretrained_backbone, load_raw_backbone_state_dict

TOL = dict(atol=2e-4, rtol=1e-3)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Small models: more intra-op threads per test worker only contend."""
    with torch_threads(2):
        yield


def _seeded_backbone(out_features, seed=0, num_categories=2, k=8):
    """A VN-DGCNN backbone with random weights, BatchNorm affines and
    running statistics: the reference's key names and shapes."""
    net = VNDGCNNPartSeg(out_features, k=k, num_categories=num_categories)
    gen = torch.Generator().manual_seed(seed)
    init_parameters(net, gen)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                c = m.num_features
                m.weight.copy_(1 + 0.2 * torch.randn(c, generator=gen))
                m.bias.copy_(0.2 * torch.randn(c, generator=gen))
                m.running_mean.copy_(0.3 * torch.randn(c, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(c, generator=gen))
    return net


def _write(sd, fmt, path):
    if fmt == "t7":
        torch.save({f"module.{k}": v for k, v in sd.items()}, path)
    else:
        torch.save({"model_state_dict": sd, "epoch": 3}, path)
    return path


def _graft_both(path, eucl):
    """(JAX system, its grafted variables, port system grafted, batch, JAX
    swapped, port swapped, the port backbone's state before) from one
    fresh model."""
    jsys, state, tsys, batch = jax_port_pair(eucl=eucl, hyp=eucl, B=2, N=64, k=8)
    fresh = {k: v.clone() for k, v in tsys.net.nn_feat.state_dict().items()}
    params, stats, j_swapped = j_graft(j_load(path), state.params, state.batch_stats, eucl)
    swapped = graft_pretrained_backbone(tsys.net.nn_feat, load_raw_backbone_state_dict(path),
                                        eucl)
    return (jsys, {"params": params, "batch_stats": stats}, tsys, batch, j_swapped, swapped,
            fresh)


@pytest.mark.parametrize("fmt", ["t7", "best_model"])
def test_graft_matches_jax_package(fmt, tmp_path):
    ref = _seeded_backbone(16)
    sd = ref.state_dict()
    path = _write(sd, fmt, str(tmp_path / ("model.partseg.vn_dgcnn.aligned.t7" if fmt == "t7"
                                           else "best_model.pth")))
    loaded = load_raw_backbone_state_dict(path)
    assert set(loaded) == set(sd)
    jsys, variables, tsys, batch, j_swapped, swapped, _ = _graft_both(path, 16)
    assert not swapped and not j_swapped
    got_sd = tsys.net.nn_feat.state_dict()
    for k, v in sd.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got_sd[k], v), k
    # the same net as hpcs_tpu's graft gives, tensor for tensor
    want = from_jax_params(to_numpy_tree(variables["params"]),
                           to_numpy_tree(variables["batch_stats"]))
    for k, v in tsys.net.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    dv = j_decode_vector(jsys.cfg, jbatch)
    got = tsys.embed(batch["points"], np.asarray(dv))
    want_out = jax.jit(lambda v, p, d: jsys.net.apply(v, p, d, train=False))(
        variables, jbatch["points"], dv)
    for g, w in zip(got, want_out):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    # the grafted backbone is the file's: its forward is the seeded one's
    with torch.no_grad():
        dv_t = torch.from_numpy(np.asarray(dv))
        torch.testing.assert_close(tsys.net.nn_feat(torch.from_numpy(batch["points"]), dv_t),
                                   ref.eval()(torch.from_numpy(batch["points"]), dv_t))


def test_head_swap_on_width_mismatch(tmp_path):
    """A 50-wide conv11 into a 16-wide model: conv11 stays the model's own,
    everything else comes from the file, as in hpcs_tpu."""
    ref = _seeded_backbone(50, seed=1)
    path = _write(ref.state_dict(), "best_model", str(tmp_path / "best_model.pth"))
    jsys, variables, tsys, batch, j_swapped, swapped, fresh = _graft_both(path, 16)
    assert swapped and j_swapped
    got = tsys.net.nn_feat.state_dict()
    for k, v in got.items():
        if k.startswith("conv11."):
            assert torch.equal(v, fresh[k]), k
        elif not k.endswith("num_batches_tracked"):
            assert torch.equal(v, ref.state_dict()[k]), k
    want = from_jax_params(to_numpy_tree(variables["params"]),
                           to_numpy_tree(variables["batch_stats"]))
    for k, v in tsys.net.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)


def test_partial_checkpoint_grafts_whole_modules_only(tmp_path):
    """strict=False by module: a module whose tensors are all absent keeps
    the model's; one with some present and others missing raises KeyError
    in both packages; a shape mismatch raises ValueError before anything
    is copied."""
    sd = _seeded_backbone(16, seed=2).state_dict()
    no_conv3 = {k: v for k, v in sd.items() if not k.startswith("conv3.")}
    path = _write(no_conv3, "t7", str(tmp_path / "partial.t7"))
    _, state, tsys, _ = jax_port_pair(eucl=16, hyp=16, B=2, N=64, k=8)
    fresh = {k: v.clone() for k, v in tsys.net.nn_feat.state_dict().items()}
    assert not graft_pretrained_backbone(tsys.net.nn_feat, load_raw_backbone_state_dict(path), 16)
    got = tsys.net.nn_feat.state_dict()
    assert torch.equal(got["conv3.map_to_feat.weight"], fresh["conv3.map_to_feat.weight"])
    assert torch.equal(got["conv4.map_to_feat.weight"], sd["conv4.map_to_feat.weight"])

    broken = {k: v for k, v in sd.items() if k != "conv2.map_to_dir.weight"}
    with pytest.raises(KeyError, match="conv2.map_to_dir.weight"):
        graft_pretrained_backbone(tsys.net.nn_feat, broken, 16)
    with pytest.raises(KeyError, match="conv2.map_to_dir.weight"):
        j_graft({k: v.numpy() for k, v in broken.items()}, state.params, state.batch_stats, 16)
    wrong = dict(sd, **{"conv5.map_to_feat.weight": torch.zeros(21, 40)})
    before = {k: v.clone() for k, v in tsys.net.nn_feat.state_dict().items()}
    with pytest.raises(ValueError, match="conv5.map_to_feat.weight"):
        graft_pretrained_backbone(tsys.net.nn_feat, wrong, 16)
    for k, v in tsys.net.nn_feat.state_dict().items():
        assert torch.equal(v, before[k]), k
    other = HypHCSystem(ModelConfig(model_name="pointnet_partseg", num_class=6, num_categories=2,
                                    eucl_dim=6, hyp_dim=6), device="cpu")
    with pytest.raises(ValueError, match="VN-DGCNN"):
        graft_pretrained_backbone(other.net.nn_feat, sd, 6)


def test_pretrained_flag_grafts_and_trains(tmp_path, monkeypatch, capsys):
    """python -m hpcs_torch.train --pretrained: the default path missing
    raises FileNotFoundError naming it; --pretrained_path grafts (a
    50-wide head into an 8-wide model is swapped) and the run trains."""
    monkeypatch.chdir(tmp_path)
    argv = ["--dataset", "synthetic", "--fixed_points", "32", "--k", "4", "--eucl_embedding", "8",
            "--hyp_embedding", "8", "--t_per_anchor", "4", "--batch", "16", "--epochs", "1",
            "--accelerator", "cpu", "--pretrained"]
    with pytest.raises(FileNotFoundError, match="best_model.pth"):
        train.main(argv)
    path = _write(_seeded_backbone(50, seed=3, num_categories=4, k=4).state_dict(), "t7",
                  str(tmp_path / "backbone.t7"))
    system, results = train.main(argv + ["--pretrained_path", path])
    out = capsys.readouterr().out
    assert f"loaded pretrained backbone from {path} (conv11 head re-initialized" in out
    assert "End Training" in out and np.isfinite(results["test_loss"])


def test_pretrained_default_path_for_partnet(tmp_path, monkeypatch):
    """PartNet's default checkpoint (num_categories 1) is the .t7 one."""
    monkeypatch.chdir(tmp_path)
    system = HypHCSystem(ModelConfig(num_class=6, num_categories=1, eucl_dim=16, hyp_dim=16,
                                     k=8), device="cpu")
    with pytest.raises(FileNotFoundError, match="model.partseg.vn_dgcnn.aligned.t7"):
        train.graft_pretrained(system)
    sd = _seeded_backbone(16, num_categories=1).state_dict()
    _write(sd, "t7", "model.partseg.vn_dgcnn.aligned.t7")
    train.graft_pretrained(system)
    assert torch.equal(system.net.nn_feat.conv1.map_to_feat.weight, sd["conv1.map_to_feat.weight"])
