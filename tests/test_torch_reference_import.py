"""The reference's Lightning checkpoints imported by the port:
`python -m hpcs_torch.import_checkpoint` against hpcs_tpu's
`tools/import_checkpoint.py` on the same file, which pickles the
reference's backbone object in `hyper_parameters` (a class that cannot be
imported when the file is read), as tests/test_reference_parity.py writes
it."""
import contextlib
import importlib.util
import io
import os
import pickle
import sys
import types

import numpy as np
import pytest
import torch

from _torch_port import torch_threads
from hpcs_tpu.utils import torch_import as j_import
from hpcs_torch import import_checkpoint
from hpcs_torch.cli import freeze_hierarchy
from hpcs_torch.models import HypHCSystem, ModelConfig
from hpcs_torch.utils import reference_import
from hpcs_torch.utils.checkpoint import load_config, restore_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAKE = "hpcs_fake_reference_for_port_test"


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    with torch_threads(2):
        yield


def _fake_module():
    """A module of stand-ins for the reference's classes: the backbone
    class, a dict subclass, a list subclass and a class with slots."""
    mod = types.ModuleType(FAKE)
    for name, bases, body in (
            ("VN_DGCNN_partseg", (), {}),
            ("AttributeDict", (dict,), {}),
            ("Transforms", (list,), {}),
            ("Slotted", (), {"__slots__": ("a", "__dict__")})):
        setattr(mod, name, type(name, bases, {"__module__": FAKE, "__qualname__": name, **body}))
    return mod


def _save_with_fake_classes(payload_of, path):
    """torch.save(payload_of(module)) while the fake module is importable;
    it is not when the file is read."""
    mod = _fake_module()
    sys.modules[FAKE] = mod
    try:
        torch.save(payload_of(mod), str(path))
    finally:
        del sys.modules[FAKE]


def _lightning_payload(mod):
    """The PartNet Bottle geometry of tests/test_reference_parity.py (eucl =
    hyp = 4, num_class 9, k 12, one category): every tensor of the model,
    random weights and BatchNorm statistics, under the reference's names."""
    net = HypHCSystem(ModelConfig(dataset="partnet", num_class=9, num_categories=1, eucl_dim=4,
                                  hyp_dim=4, k=12), device="cpu",
                      generator=torch.Generator().manual_seed(5)).net
    gen = torch.Generator().manual_seed(6)
    sd = {}
    for k, v in net.state_dict().items():
        if k.endswith("running_var"):
            v = 0.5 + torch.rand(v.shape, generator=gen)
        elif v.is_floating_point():
            v = v + 0.1 * torch.randn(v.shape, generator=gen)
        sd[k] = v.clone()
    sd["scale"] = torch.tensor([0.02])
    feat = mod.VN_DGCNN_partseg()
    feat.k, feat.out_features, feat.num_categories = 12, 4, 1
    feat.dropout, feat.pooling = 0.5, "mean"
    return {"state_dict": sd, "hyper_parameters": {
        "euclidean_size": 4, "hyp_size": 4, "num_class": 9, "lr": 0.05, "margin": 0.35,
        "t_per_anchor": 50, "fraction": 1.2, "temperature": 0.1, "anneal_factor": 0.5,
        "anneal_step": 0, "trade_off": 0.1, "miner": True, "cosface": True,
        "hierarchical": False, "level": 3, "nn_feat": feat, "nn_emb": None}}


def _printed(fn):
    """(fn(), the lines it printed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue().splitlines()


def _run_tool(argv):
    """tools/import_checkpoint.py's main on argv."""
    spec = importlib.util.spec_from_file_location(
        "import_checkpoint_tool", os.path.join(REPO, "tools", "import_checkpoint.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    old = sys.argv
    sys.argv = ["import_checkpoint.py", *argv]
    try:
        tool.main()
    finally:
        sys.argv = old


def _port_system(path):
    d = load_config(path)
    d["hierarchy_list"] = freeze_hierarchy(d["hierarchy_list"])
    system = HypHCSystem(ModelConfig(**d), device="cpu", generator=torch.Generator().manual_seed(7))
    restore_checkpoint(path, system)
    return system


@pytest.fixture(scope="module")
def imported(tmp_path_factory):
    """The payload imported by both routes: (payload state_dict, the tool's
    lines and out dir, the port's lines, out dir and returned system)."""
    base = tmp_path_factory.mktemp("ref")
    ckpt = base / "model.ckpt"
    _save_with_fake_classes(_lightning_payload, ckpt)
    _, tool_lines = _printed(lambda: _run_tool([str(ckpt), str(base / "tool"),
                                                "--fixed_points", "96"]))
    port_out = str(base / "port")
    system, port_lines = _printed(lambda: import_checkpoint.main(
        [str(ckpt), port_out, "--fixed_points", "96", "--accelerator", "cpu"]))
    sd, _ = reference_import.load_lightning_payload(str(ckpt))
    return dict(sd=sd, tool_lines=tool_lines, tool_out=str(base / "tool"),
                port_lines=port_lines, port_out=port_out, system=system)


def test_config_and_lines_are_the_tools(imported):
    tool_cfg, port_cfg = load_config(imported["tool_out"]), load_config(imported["port_out"])
    assert port_cfg == tool_cfg
    assert (port_cfg["eucl_dim"], port_cfg["hyp_dim"], port_cfg["num_class"], port_cfg["k"],
            port_cfg["num_categories"], port_cfg["dataset"], port_cfg["model_name"]) == \
        (4, 4, 9, 12, 1, "partnet", "vn_dgcnn_partseg")
    strip = [line.replace(imported["tool_out"], "OUT") for line in imported["tool_lines"]]
    assert [line.replace(imported["port_out"], "OUT") for line in imported["port_lines"]] == strip
    assert strip[0].startswith("rehydrated from ckpt hyper_parameters: ")
    assert strip[-1].startswith(f"imported {len(imported['sd'])} tensors -> OUT")


def test_weights_are_the_tools_bit_for_bit(imported):
    """The tool's hpcs_tpu checkpoint, read by the port's flax reader, and
    the port's own import hold the same weights, and those are the
    payload's (num_batches_tracked, not a weight, stays 0 in both)."""
    via_tool = _port_system(imported["tool_out"]).net.state_dict()
    via_port = _port_system(imported["port_out"]).net.state_dict()
    returned = imported["system"].net.state_dict()
    assert via_tool.keys() == via_port.keys() == returned.keys()
    for k in via_tool:
        assert torch.equal(via_port[k], via_tool[k]), k
        assert torch.equal(returned[k], via_tool[k]), k
        want = torch.zeros(()) if k.endswith("num_batches_tracked") else imported["sd"][k]
        assert torch.equal(via_tool[k], want.reshape(via_tool[k].shape).to(via_tool[k].dtype)), k


@pytest.mark.parametrize("payload", [
    {},
    {"state_dict": {}},
    {"hyper_parameters": {"euclidean_size": 50, "hyp_size": 50, "num_class": 50, "lr": 0.001,
                          "class_vector": False}},
    {"hyper_parameters": {"euclidean_size": 4, "hyp_size": 4, "hierarchical": True, "level": 3}},
    {"hyper_parameters": {"hyp_size": 8.0, "miner": False, "train_rotation": "z",
                          "hierarchy_list": [[0], [1]], "temperature": None}},
    {"hyper_parameters": types.SimpleNamespace(euclidean_size=6, num_class=7, lr=0.2)},
], ids=["empty", "raw_state_dict", "shapenet", "partnet_markers", "partial", "namespace"])
def test_hparams_mapping_edge_cases(payload):
    """As hpcs_tpu's test_hparams_mapping_edge_cases: raw state dicts give
    {}, partial hparams map only what they hold, ShapeNet-style payloads
    stay dataset-agnostic, PartNet markers force the dataset and one
    category; every case equal to hpcs_tpu's mapping."""
    got = reference_import.reference_hparams_to_config_kwargs(payload)
    assert got == j_import.reference_hparams_to_config_kwargs(payload)
    h = reference_import._stub_dict(payload.get("hyper_parameters"))
    if not h:
        assert got == {}
    if "euclidean_size" in h and "class_vector" in h:
        assert (got["eucl_dim"], got["hyp_dim"], got["num_class"], got["lr"]) == (50, 50, 50, 0.001)
        assert "dataset" not in got
    if "level" in h or "hierarchy_list" in h:
        assert got["dataset"] == "partnet" and got["num_categories"] == 1


def test_pickled_reference_objects_become_stubs_as_in_hpcs_tpu(tmp_path):
    """Unimportable classes come back as attribute-preserving stubs: a plain
    object, a dict subclass, a list subclass and a slotted class."""
    def payload(mod):
        d = mod.AttributeDict(a=1, b="x")
        lst = mod.Transforms([1, 2])
        slotted = mod.Slotted()
        slotted.a, slotted.b = 3, 4
        feat = mod.VN_DGCNN_partseg()
        feat.k = 20
        return {"state_dict": {"w": torch.ones(2)},
                "hyper_parameters": {"nn_feat": feat, "d": d, "l": lst, "s": slotted}}

    _save_with_fake_classes(payload, tmp_path / "p.ckpt")
    sd, got = reference_import.load_lightning_payload(str(tmp_path / "p.ckpt"))
    want_sd, want = j_import.load_lightning_payload(str(tmp_path / "p.ckpt"))
    assert sd.keys() == want_sd.keys() and np.array_equal(sd["w"].numpy(), want_sd["w"])
    h, jh = got["hyper_parameters"], want["hyper_parameters"]
    for key in ("nn_feat", "d", "l", "s"):
        assert type(h[key]).__name__ == type(jh[key]).__name__
        assert reference_import._stub_dict(h[key]) == j_import._stub_dict(jh[key]), key
    assert h["nn_feat"].k == 20 and h["l"]._list == [1, 2]
    assert reference_import.reference_hparams_to_config_kwargs(got) == \
        j_import.reference_hparams_to_config_kwargs(want) == \
        {"k": 20, "model_name": "vn_dgcnn_partseg"}


def test_other_backbones_raise_as_hpcs_tpu(imported, tmp_path):
    with pytest.raises(NotImplementedError) as want:
        j_import.convert_lightning_checkpoint({}, {}, {}, model_name="dgcnn_partseg")
    with pytest.raises(NotImplementedError) as got:
        import_checkpoint.main([os.path.join(os.path.dirname(imported["tool_out"]), "model.ckpt"),
                                str(tmp_path / "out"), "--model", "dgcnn_partseg",
                                "--eucl_embedding", "9", "--fixed_points", "96",
                                "--accelerator", "cpu"])
    assert str(got.value) == str(want.value)
    assert not os.path.exists(tmp_path / "out")


def test_a_missing_backbone_tensor_raises(imported):
    sd = dict(imported["sd"])
    del sd["nn_feat.conv3.map_to_feat.weight"]
    net = HypHCSystem(ModelConfig(**{**load_config(imported["port_out"]), "hierarchy_list": ()}),
                      device="cpu").net
    with pytest.raises(KeyError, match="conv3.map_to_feat"):
        reference_import.load_lightning_state(net, sd)


def test_the_reader_unpickles_no_pickle_without_the_stub_module(tmp_path):
    """load_lightning_payload goes through the stub unpickler: a plain
    pickle.load of the same file fails on the unimportable class."""
    _save_with_fake_classes(_lightning_payload, tmp_path / "m.ckpt")
    with pytest.raises(Exception):
        torch.load(str(tmp_path / "m.ckpt"), pickle_module=pickle, weights_only=False)
    sd, payload = reference_import.load_lightning_payload(str(tmp_path / "m.ckpt"))
    assert type(payload["hyper_parameters"]["nn_feat"]).__module__ == FAKE
