"""The port's CLI (hpcs_torch.cli, .train, .infer) against hpcs_tpu.cli.

The parsers must agree on every flag but --accelerator; `configure` must
give a ModelConfig equal field by field to hpcs_tpu's, and loaders with
equal batches, for shapenet, partnet (hierarchical) and synthetic; --layout
vc, whose path is not ported, must raise, and --profile, --debug_nans and
--plot_inference configure and run.  --bf16 trains and serves.
"""
import argparse
import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from hpcs_tpu import cli as jcli
from _torch_port import bf16_einsum_on_cpu, torch_threads
from hpcs_torch import cli, infer, train, trainer
from hpcs_torch.data import DataLoader, ShapeNetDataset
from hpcs_torch.models import HypHCSystem, ModelConfig, decode_vector_for_batch
from hpcs_torch.testing import check_same_test_outputs, record_test_steps, write_mini_shapenet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = ("--dataset shapenet --model vn_dgcnn_partseg --fixed_points 1024 --k 20 "
            "--eucl_embedding 32 --hyp_embedding 32 --margin 0.35 --t_per_anchor 50 "
            "--temperature 0.05 --lr 0.05 --trade_off 0.1 --batch 8 --epochs 2").split()


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    with torch_threads(2):
        yield


def _parse(add_args, argv):
    return add_args(argparse.ArgumentParser()).parse_args(argv)


@pytest.mark.parametrize("argv", [
    [],
    ["--miner", "--hierarchical"],
    ["--triplet-sim", "--class_vector", "--num_triplets", "4096", "--seed", "3"],
    ["--dataset", "partnet", "--category", "Bottle", "--level", "1",
     "--hierarchy_list", "[[[0], [1, 2]], [[0], [1], [2]]]"],
    ["-k", "20", "-batch", "8", "-eucl_embedding", "32", "-hyp_embedding", "16", "-lr", "0.01",
     "-train_rotation", "z", "-test_rotation", "none", "-dropout", "0.1", "-anneal_step", "3"],
    FLAGSHIP + ["--resume", "x/checkpoints/last", "--infer", "--log", "runs", "--wandb",
                "disabled", "--num_workers", "2", "--patience", "5", "--data_parallel", "1"],
], ids=["defaults", "store_false_traps", "triplet_sim", "hierarchy_json", "short_aliases",
        "flagship"])
def test_parser_agrees_with_jax_package(argv):
    port, ref = vars(_parse(cli.add_train_args, argv)), vars(_parse(jcli.add_train_args, argv))
    assert port.pop("accelerator") == "cuda" and ref.pop("accelerator") == "tpu"
    assert port == ref


def test_parser_has_every_flag_with_its_default():
    port = cli.add_train_args(argparse.ArgumentParser())
    ref = jcli.add_train_args(argparse.ArgumentParser())

    def flags(p):
        return {a.dest: (tuple(a.option_strings), a.default, type(a).__name__)
                for a in p._actions if a.dest != "help"}

    got, want = flags(port), flags(ref)
    assert len(got) == len(want) == 43
    assert got.pop("accelerator") == (("--accelerator", "-accelerator"), "cuda", "_StoreAction")
    want.pop("accelerator")
    assert got == want


def _mini_datasets_tool():
    spec = importlib.util.spec_from_file_location(
        "make_mini_datasets", os.path.join(REPO, "tools", "make_mini_datasets.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """A working directory with data/ShapeNet/raw and data/PartNet."""
    base = tmp_path_factory.mktemp("cwd")
    write_mini_shapenet(str(base / "data" / "ShapeNet" / "raw"), ("Airplane", "Table"),
                        (3, 2, 3), seed=2, points=400)
    pytest.importorskip("h5py")
    _mini_datasets_tool().make_partnet(str(base / "data"), n_points=300, per_split=(3, 2, 3))
    return base


@pytest.mark.parametrize("argv", [
    ["--dataset", "shapenet"],
    ["--dataset", "shapenet", "--category", "Table", "--triplet-sim", "--miner"],
    ["--dataset", "partnet", "--category", "Bottle", "--level", "3"],
    ["--dataset", "partnet", "--category", "Bottle", "--level", "1", "--hierarchical",
     "--class_vector"],
    ["--dataset", "synthetic", "--num_triplets", "512", "--seed", "4"],
], ids=["shapenet", "shapenet_table", "partnet_hierarchical", "partnet_flat", "synthetic"])
def test_configure_equals_jax_package(data_dir, monkeypatch, argv):
    monkeypatch.chdir(data_dir)
    argv = argv + ["--fixed_points", "64", "--batch", "2", "--eucl_embedding", "4",
                   "--hyp_embedding", "4", "--k", "4"]
    system, *loaders = cli.configure(_parse(cli.add_train_args, argv + ["--accelerator", "cpu"]))
    jsystem, *jloaders = jcli.configure(_parse(jcli.add_train_args, argv))
    assert dataclasses.asdict(system.cfg) == dataclasses.asdict(jsystem.cfg)
    assert system.cfg == ModelConfig(**dataclasses.asdict(jsystem.cfg))
    assert system.device == torch.device("cpu")
    assert (system.hierarchy_matrices is not None) == system.cfg.use_hierarchical == (
        argv[1] == "partnet" and "--hierarchical" not in argv)
    for loader, jloader in zip(loaders, jloaders):
        assert (loader.shuffle, loader.drop_last, len(loader)) == (
            jloader.shuffle, jloader.drop_last, len(jloader))
        for _ in range(2):
            got, want = list(loader), list(jloader)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                for k in w:
                    np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("flags,item", [
    # --data_parallel (ROADMAP A11) is ported: the case now configures and asks for 2 ranks
    pytest.param(["--data_parallel", "2"], None, id="flags0-A11"),
    # --profile, --debug_nans and --plot_inference (ROADMAP A12b) are ported: each case
    # now configures and trains an epoch with its flag, under the ids it had
    pytest.param(["--profile", "trace"], None, id="flags1-A12b"),
    pytest.param(["--debug_nans"], None, id="flags2-A12b"),
    # the ids the cases had beside the --bf16 case (flags3), which went with its refusal
    pytest.param(["--layout", "vc"], "vc", id="flags4-vc"),
    pytest.param(["--plot_inference"], None, id="flags5-A12b"),
])
def test_unported_flags_raise_naming_their_item(flags, item, tmp_path, monkeypatch):
    argv = ["--dataset", "synthetic", "--fixed_points", "32", "--accelerator", "cpu"] + flags
    args = _parse(cli.add_train_args, argv)
    if item is None:
        cli.configure(args)
        if flags[0] == "--data_parallel":
            assert cli.data_parallel_size(args) == 2
            return
        monkeypatch.chdir(tmp_path)
        _, results = train.main(argv + ["--batch", "16", "--epochs", "1", "--k", "4",
                                        "--t_per_anchor", "4", "--log", "logs"])
        assert np.isfinite(results["test_loss"])
        run = tmp_path / "logs" / "synthetic_vn_dgcnn_partseg"
        if flags[0] == "--profile":
            assert [p.name.endswith(".pt.trace.json") for p in (tmp_path / "trace").iterdir()] == [
                True]
        elif flags[0] == "--plot_inference":
            assert sorted(p.name for p in (run / "plots").iterdir()) == sorted(
                f"{i}.png" for i in range(16))
        else:
            assert not torch.is_anomaly_enabled()
        return
    with pytest.raises(NotImplementedError, match=item):
        cli.configure(args)


@pytest.mark.parametrize("field,value,item", [("layout", "vc", "vc")])
def test_system_refuses_unported_configs(field, value, item):
    with pytest.raises(NotImplementedError, match=item):
        HypHCSystem(ModelConfig(**{field: value}), device="cpu")


@pytest.mark.parametrize("model", ["vn_dgcnn_partseg", "dgcnn_partseg"])
def test_bf16_configures_as_jax_and_sets_vn_dgcnn_compute(model, monkeypatch):
    """--bf16 configures as hpcs_tpu's (ModelConfigs equal field by field).
    VN-DGCNN then computes in bf16; DGCNN computes in fp32 whatever bf16
    says, as in hpcs_tpu: its output equals the fp32 configuration's
    exactly."""
    bf16_einsum_on_cpu(monkeypatch)  # hpcs_tpu's configure initialises its net in bf16
    argv = ["--dataset", "synthetic", "--fixed_points", "32", "--k", "4", "--bf16", "--model",
            model, "--eucl_embedding", "12"]
    system, *_ = cli.configure(_parse(cli.add_train_args, argv + ["--accelerator", "cpu"]))
    jsystem, *_ = jcli.configure(_parse(jcli.add_train_args, argv))
    assert dataclasses.asdict(system.cfg) == dataclasses.asdict(jsystem.cfg)
    assert system.cfg.bf16
    fp32 = HypHCSystem(dataclasses.replace(system.cfg, bf16=False), device="cpu")
    fp32.net.load_state_dict(system.net.state_dict())
    rng = np.random.default_rng(0)
    pts = rng.standard_normal((2, 32, 3)).astype(np.float32)
    dv = decode_vector_for_batch(system.cfg, {"points": pts, "category": np.array([0, 1])})
    got, want = system.embed(pts, dv), fp32.embed(pts, dv)
    if model == "dgcnn_partseg":
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    else:
        assert system.net.nn_feat.compute_dtype == torch.bfloat16
        assert fp32.net.nn_feat.compute_dtype is None
        for g, w in zip(got, want):  # bf16 noise, not garbage (hpcs_tpu's bound on the TPU)
            assert g.dtype == torch.float32 and not torch.equal(g, w)
            assert float((g - w).abs().max()) < 0.1 * float(w.abs().max())


def test_bf16_trains_and_serves_on_the_cpu(tmp_path, monkeypatch):
    """python -m hpcs_torch.train --bf16 trains VN-DGCNN in bf16 and writes
    "bf16": true into its checkpoints' config.json; python -m
    hpcs_torch.infer restores it in bf16 and serves what trainer.test gives
    on the trained system in memory (prediction, best k, best score and
    linkage exactly)."""
    write_mini_shapenet(str(tmp_path / "data" / "ShapeNet" / "raw"), ("Airplane", "Chair"),
                        (2, 2, 2), seed=3, points=300)
    monkeypatch.chdir(tmp_path)
    argv = ("--dataset shapenet --fixed_points 64 --k 4 --eucl_embedding 4 --hyp_embedding 4 "
            "--t_per_anchor 5 --batch 2 --epochs 1 --accelerator cpu --log logs --bf16").split()
    trained, results = train.main(argv)
    assert trained.cfg.bf16 and trained.net.nn_feat.compute_dtype == torch.bfloat16
    assert all(np.isfinite(v) for v in results.values())
    final = os.path.join("logs", "shapenet_vn_dgcnn_partseg", "checkpoints", "final")
    with open(os.path.join(final, "config.json")) as f:
        assert json.load(f)["bf16"] is True
    with record_test_steps() as served:
        restored, _ = infer.main(["shapenet", "--model_path", final, "--fixed_points", "64",
                                  "--batch", "2", "--test_batches", "1", "--accelerator", "cpu"])
    assert restored.cfg.bf16 and restored.net.nn_feat.compute_dtype == torch.bfloat16
    loader = DataLoader(ShapeNetDataset("data/ShapeNet/raw", 64, "test"), 2, shuffle=True, seed=0)
    with record_test_steps() as in_memory:
        trainer.test(trained, loader, seed=0, limit_batches=1)
    check_same_test_outputs(served, in_memory)


@pytest.mark.parametrize("argv", [
    ["--model", "dgcnn_partseg", "--eucl_embedding", "12"],
    ["--model", "pointnet_partseg", "--eucl_embedding", "12"],
    ["--model", "vn_pointnet_partseg", "--eucl_embedding", "12", "--hyp_embedding", "6"],
    ["--pretrained", "--pretrained_path", "backbone.t7"],
], ids=["dgcnn", "pointnet", "vn_pointnet", "pretrained"])
def test_configure_takes_every_model_and_pretrained(argv):
    """--model and --pretrained configure as in hpcs_tpu: ModelConfigs equal
    field by field, the backbone the model names (--pretrained grafts in
    train.main, after configure)."""
    argv = ["--dataset", "synthetic", "--fixed_points", "32", "--k", "4"] + argv
    system, *_ = cli.configure(_parse(cli.add_train_args, argv + ["--accelerator", "cpu"]))
    jsystem, *_ = jcli.configure(_parse(jcli.add_train_args, argv))
    assert dataclasses.asdict(system.cfg) == dataclasses.asdict(jsystem.cfg)
    backbone = {"vn_dgcnn_partseg": "VNDGCNNPartSeg", "dgcnn_partseg": "DGCNNPartSeg",
                "pointnet_partseg": "PointNetPartSeg",
                "vn_pointnet_partseg": "VNPointNetPartSeg"}[system.cfg.model_name]
    assert type(system.net.nn_feat).__name__ == type(jsystem.net.backbone).__name__ == backbone


@pytest.mark.parametrize("model", ["dgcnn_partseg", "pointnet_partseg", "vn_pointnet_partseg"])
def test_scalar_width_backbones_need_eucl_embedding_num_class(model):
    """These backbones output num_class-wide features: both packages raise
    the same ValueError for another --eucl_embedding, and for an unknown
    model name."""
    argv = ["--dataset", "synthetic", "--fixed_points", "32", "--model", model,
            "--eucl_embedding", "8"]
    with pytest.raises(ValueError) as got:
        cli.configure(_parse(cli.add_train_args, argv + ["--accelerator", "cpu"]))
    with pytest.raises(ValueError) as want:
        jcli.configure(_parse(jcli.add_train_args, argv))
    assert str(got.value) == str(want.value) and "--eucl_embedding 12" in str(got.value)
    with pytest.raises(ValueError, match="Not implemented for model_name bogus"):
        HypHCSystem(ModelConfig(model_name="bogus"), device="cpu")


def test_accelerator_names_the_device(monkeypatch):
    assert cli.select_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="tpu"):
        cli.select_device("tpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for accelerator in ("cuda", "gpu"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.select_device(accelerator)
    with pytest.raises(RuntimeError, match="no CUDA device"):  # the default: no CPU fallback
        train.main(["--dataset", "synthetic", "--fixed_points", "32"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        infer.main(["synthetic", "--model_path", REPO])


def test_infer_refuses_what_it_cannot_serve(tmp_path):
    # --plot_inference is ported (ROADMAP A12b): infer gets to the checkpoint, which is missing
    with pytest.raises(FileNotFoundError, match="config.json"):
        infer.main(["synthetic", "--model_path", str(tmp_path), "--plot_inference",
                    "--accelerator", "cpu"])
    with pytest.raises(NotImplementedError, match="wandb"):
        infer.check_model_path("wandb:entity/project/run")
    with pytest.raises(FileNotFoundError):
        infer.main(["synthetic", "--model_path", str(tmp_path / "missing"), "--accelerator",
                    "cpu"])
    with pytest.raises(KeyError, match="bogus"):
        cli.configure(_parse(cli.add_train_args, ["--dataset", "bogus", "--accelerator", "cpu"]))
