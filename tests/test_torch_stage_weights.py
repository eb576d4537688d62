"""VN-DGCNN's EdgeConv stage weights for kernel B2 (vn_dgcnn.stage_weights).

The eval forward folds each conv's BatchNorm once for a set of values and
keeps it on the conv; load_state_dict, an optimizer step and an in-place
edit make it anew, train mode and gradients bypass it, and the forward's
bits are the same with it as without.  fp32 and bf16 features take the same
weights (on bf16 the kernels round the mixes themselves).  CPU, no JAX.
"""
import pytest
import torch

from _torch_port import torch_threads
from hpcs_torch.nn.backbones import vn_dgcnn
from hpcs_torch.nn.backbones.vn_dgcnn import VNDGCNNPartSeg, stage_weights
from hpcs_torch.ops.edgeconv import fold_bn
from hpcs_torch.optim.radam import FusedRiemannianAdam

DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture(autouse=True)
def _two_threads():
    with torch_threads(2):
        yield


def _net(dtype=torch.float32, seed=0):
    """A small VN-DGCNN in eval mode with random BatchNorm affines and
    running statistics."""
    gen = torch.Generator().manual_seed(seed)
    torch.manual_seed(seed)
    net = VNDGCNNPartSeg(8, k=4, num_categories=4, compute_dtype=dtype)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                c = m.num_features
                m.weight.copy_(1 + 0.2 * torch.randn(c, generator=gen))
                m.bias.copy_(0.2 * torch.randn(c, generator=gen))
                m.running_mean.copy_(0.3 * torch.randn(c, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(c, generator=gen))
    return net.eval()


def _stages(net):
    return (net.conv1, net.conv2), (net.conv3, net.conv4), (net.conv5,)


def _fresh(*convs):
    out = []
    for conv in convs:
        bn = conv.batchnorm.bn
        out += [conv.map_to_feat.weight, conv.map_to_dir.weight,
                fold_bn(bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps)]
    return out


def _prepared(*convs):
    with torch.no_grad():
        return stage_weights(*convs)


def _equal(got, want):
    return len(got) == len(want) and all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("dtype", DTYPES)
def test_prepared_weights_equal_fresh_ones_bit_for_bit(dtype):
    net = _net(dtype)
    for convs in _stages(net):
        first, again = _prepared(*convs), _prepared(*convs)
        assert _equal(first, _fresh(*convs))
        assert all(a is b for a, b in zip(first, again))  # the second call folds nothing
        assert first[0] is convs[0].map_to_feat.weight  # the mixes are the parameters


def test_prepared_weights_follow_load_state_dict_an_optimizer_step_and_in_place_edits():
    net, other = _net(), _net(seed=1)
    convs = (net.conv3, net.conv4)
    before = _prepared(*convs)
    net.load_state_dict(other.state_dict())
    loaded = _prepared(*convs)
    assert _equal(loaded, _fresh(*convs)) and not torch.equal(loaded[2], before[2])

    params = [p for conv in convs for p in conv.parameters()]
    opt = FusedRiemannianAdam(params, lr=0.05)
    gen = torch.Generator().manual_seed(2)
    for p in params:
        p.grad = torch.randn(p.shape, generator=gen)
    opt.step()
    stepped = _prepared(*convs)
    assert _equal(stepped, _fresh(*convs))
    assert not torch.equal(stepped[2], loaded[2]) and not torch.equal(stepped[5], loaded[5])

    net.conv4.batchnorm.bn.running_var.mul_(2.0)
    edited = _prepared(*convs)
    assert _equal(edited, _fresh(*convs))
    assert torch.equal(edited[2], stepped[2]) and not torch.equal(edited[5], stepped[5])


def test_train_mode_and_gradients_bypass_the_cache():
    net = _net()
    cached = _prepared(net.conv1)
    bn = net.conv1.batchnorm.bn
    bn.running_mean.data.add_(1.0)  # an edit through .data: no version bump
    net.train()
    trained = _prepared(net.conv1)
    assert _equal(trained, _fresh(net.conv1)) and not torch.equal(trained[2], cached[2])
    assert net.conv1.__dict__["_folded_bn"][1] is cached[2]  # train mode kept nothing
    net.eval()
    with torch.enable_grad():
        graded = stage_weights(net.conv1)
    assert graded[2].requires_grad and _equal(graded, _fresh(net.conv1))
    assert net.conv1.__dict__["_folded_bn"][1] is cached[2]


@pytest.mark.parametrize("dtype", DTYPES)
def test_eval_forward_has_the_same_bits_with_the_cache_as_without(dtype, monkeypatch):
    net = _net(dtype)
    gen = torch.Generator().manual_seed(3)
    points = torch.randn(2, 32, 3, generator=gen)
    label = torch.nn.functional.one_hot(torch.tensor([1, 3]), 4).float()
    with torch.no_grad():
        filled = net(points, label)
        cached = net(points, label)
        assert all("_folded_bn" in conv.__dict__ for convs in _stages(net) for conv in convs)
        monkeypatch.setattr(vn_dgcnn, "stage_weights", _fresh)
        fresh = net(points, label)
    assert torch.equal(filled, fresh) and torch.equal(cached, fresh)
