"""The port's data readers, loader and txt parser against hpcs_tpu.data.

Both packages read the same trees: the ones tools/make_mini_datasets.py
writes (3 ShapeNet categories listed, PartNet Bottle levels 1 and 3) and
one hpcs_torch.testing.write_mini_shapenet writes (all 16 categories
listed).  Arrays must be equal, item for item and batch for batch.
"""
import importlib.util
import os

import numpy as np
import pytest

from hpcs_tpu.data import DataLoader as JDataLoader
from hpcs_tpu.data import ShapeNetDataset as JShapeNetDataset
from hpcs_tpu.data import SyntheticPartDataset as JSyntheticPartDataset
from hpcs_tpu.data import fast_txt as jfast_txt
from hpcs_tpu.data.hierarchy import get_hierarchy_list as jget_hierarchy_list
from hpcs_torch.data import (SEG_CLASSES, DataLoader, ShapeNetDataset, SyntheticPartDataset,
                             get_hierarchy_list, pc_normalize, resample, to_categorical)
from hpcs_torch.data import fast_txt
from hpcs_torch.testing import SHAPENET_SYNSETS, write_mini_shapenet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mini_datasets_tool():
    spec = importlib.util.spec_from_file_location(
        "make_mini_datasets", os.path.join(REPO, "tools", "make_mini_datasets.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """{"tool": ShapeNet root, "port": ShapeNet root, "partnet": data root}."""
    base = tmp_path_factory.mktemp("data")
    tool = _mini_datasets_tool()
    tool.make_shapenet(str(base / "tool"), per_split=(3, 2, 2))
    out = {"tool": str(base / "tool" / "ShapeNet" / "raw"),
           "port": write_mini_shapenet(str(base / "port"), ("Airplane", "Lamp", "Table"),
                                       (3, 1, 2), seed=1, points=600)}
    pytest.importorskip("h5py")
    tool.make_partnet(str(base / "tool"), n_points=500, per_split=(3, 2, 2))
    out["partnet"] = str(base / "tool" / "PartNet")
    return out


def _assert_items_equal(a, b):
    assert len(a) == len(b)
    for i in range(len(a)):
        for x, y in zip(a[i], b[i]):
            np.testing.assert_array_equal(x, y)
            assert np.asarray(x).dtype == np.asarray(y).dtype


@pytest.mark.parametrize("tree", ["tool", "port"])
@pytest.mark.parametrize("split", ["train", "val", "test", "trainval"])
@pytest.mark.parametrize("class_choice", [None, "Airplane"])
@pytest.mark.parametrize("normal_channel", [False, True])
def test_shapenet_items_equal_jax_package(trees, tree, split, class_choice, normal_channel):
    kw = dict(npoints=256, split=split, class_choice=class_choice, normal_channel=normal_channel)
    port, ref = ShapeNetDataset(trees[tree], **kw), JShapeNetDataset(trees[tree], **kw)
    assert port.datapath == ref.datapath and port.classes == ref.classes
    _assert_items_equal(port, ref)
    _assert_items_equal(port, ref)  # again, from the cache of normalized clouds


def test_shapenet_all_points_and_the_written_tree(trees):
    port = ShapeNetDataset(trees["port"], npoints=0, split="test")
    _assert_items_equal(port, JShapeNetDataset(trees["port"], npoints=0, split="test"))
    assert list(port.classes_original) == sorted(SHAPENET_SYNSETS)
    assert sorted({int(port[i][1]) for i in range(len(port))}) == [0, 8, 15]
    for i in range(len(port)):
        points, cls, seg = port[i]
        assert points.shape == (600, 3)
        assert set(seg.tolist()) == set(SEG_CLASSES[port.datapath[i][0]])
        assert np.isclose(np.linalg.norm(points, axis=1).max(), 1.0, atol=1e-6)


def test_partnet_and_hierarchy_equal_jax_package(trees):
    from hpcs_tpu.data import PartNetDataset as JPartNetDataset
    from hpcs_torch.data import PartNetDataset

    for level in (1, 3):
        files = os.path.join(trees["partnet"], "sem_seg_h5", f"Bottle-{level}", "train_files.txt")
        _assert_items_equal(PartNetDataset(files, 128), JPartNetDataset(files, 128))
    hroot = os.path.join(trees["partnet"], "after_merging_label_ids")
    for levels in ([1, 3], [3]):
        assert get_hierarchy_list(hroot, "Bottle", levels) == jget_hierarchy_list(
            hroot, "Bottle", levels)


def test_partnet_without_h5py_names_it(monkeypatch, trees):
    """Without h5py the port's PartNetDataset reads the tree (its own HDF5
    reader) to the arrays h5py reads."""
    import sys

    import h5py

    from hpcs_torch.data import PartNetDataset

    files = os.path.join(trees["partnet"], "sem_seg_h5", "Bottle-3", "train_files.txt")
    with open(files) as f, h5py.File(os.path.join(os.path.dirname(files),
                                                  f.readline().strip()), "r") as h5:
        want = {key: h5[key][()] for key in ("data", "data_num", "label_seg")}
    monkeypatch.setitem(sys.modules, "h5py", None)
    got = PartNetDataset(files, 16)
    for key, attr in (("data", "points"), ("data_num", "data_num"), ("label_seg", "label_seg")):
        np.testing.assert_array_equal(getattr(got, attr), want[key], err_msg=key)


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (True, False), (False, False)])
@pytest.mark.parametrize("num_workers", [0, 2])
def test_loader_batches_equal_jax_package(trees, shuffle, drop_last, num_workers):
    kw = dict(shuffle=shuffle, drop_last=drop_last, seed=3, num_workers=num_workers)
    port = DataLoader(ShapeNetDataset(trees["port"], 128, "train"), 4, **kw)
    ref = JDataLoader(JShapeNetDataset(trees["port"], 128, "train"), 4, **kw)
    assert len(port) == len(ref) == (2 if drop_last else 3)
    for _ in range(2):  # two epochs: the shuffle moves on
        got, want = list(port), list(ref)
        assert len(got) == len(want) == len(port)
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in g:
                np.testing.assert_array_equal(g[k], w[k])
                assert g[k].dtype == w[k].dtype


def test_loader_synthetic_and_partnet_batches(trees):
    from hpcs_tpu.data import PartNetDataset as JPartNetDataset
    from hpcs_torch.data import PartNetDataset

    files = os.path.join(trees["partnet"], "sem_seg_h5", "Bottle-3", "train_files.txt")
    pairs = [(SyntheticPartDataset(10, 64, 4, seed=2), JSyntheticPartDataset(10, 64, 4, seed=2)),
             (PartNetDataset(files, 64), JPartNetDataset(files, 64))]
    for port, ref in pairs:
        for g, w in zip(DataLoader(port, 3, shuffle=True, seed=1),
                        JDataLoader(ref, 3, shuffle=True, seed=1)):
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])


def test_prefetch_loader_stops_and_raises():
    class Boom:
        def __len__(self):
            return 6

        def __getitem__(self, i):
            if i == 5:
                raise RuntimeError("boom")
            return np.zeros((8, 3), np.float32), np.int64(0), np.zeros(8, np.int64)

    with pytest.raises(RuntimeError, match="boom"):
        list(DataLoader(Boom(), 2, num_workers=2))
    it = iter(DataLoader(Boom(), 1, num_workers=2, prefetch=2))
    next(it)
    it.close()  # closing early must not hang the producer


def test_transforms_equal_jax_package():
    from hpcs_tpu.data import transforms as J

    rng = np.random.default_rng(0)
    pc = rng.standard_normal((50, 3)) * 3 + 2
    np.testing.assert_array_equal(pc_normalize(pc), J.pc_normalize(pc))
    labels = rng.integers(0, 5, 50)
    for g, w in zip(resample(np.random.default_rng(1), pc, labels, 80),
                    J.resample(np.random.default_rng(1), pc, labels, 80)):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(to_categorical(labels, 5), J.to_categorical(labels, 5))


def test_fast_txt_equals_numpy_and_jax_package(tmp_path):
    rng = np.random.default_rng(0)
    data = rng.standard_normal((700, 7)).astype(np.float32)
    data[:, 6] = rng.integers(0, 50, 700)
    path = str(tmp_path / "cloud.txt")
    np.savetxt(path, data, fmt="%.6f")
    got = fast_txt.loadtxt(path)
    assert fast_txt.available()  # the C++ parser ran: the tests expect g++, as test_fast_txt.py
    np.testing.assert_array_equal(got, np.loadtxt(path).astype(np.float32))
    np.testing.assert_array_equal(got, jfast_txt.loadtxt(path))
    odd = tmp_path / "odd.txt"
    odd.write_text("1.0 2.0 3.0\n\n4.5 5.5 6.5\n\n\n")
    np.testing.assert_array_equal(fast_txt.loadtxt(str(odd), n_cols=3),
                                  [[1.0, 2.0, 3.0], [4.5, 5.5, 6.5]])
    with pytest.raises(FileNotFoundError):
        fast_txt.loadtxt(str(tmp_path / "missing.txt"))


def test_fast_txt_falls_back_to_numpy_without_a_compiler(monkeypatch, tmp_path):
    path = str(tmp_path / "cloud.txt")
    np.savetxt(path, np.arange(21, dtype=np.float32).reshape(3, 7), fmt="%.6f")
    monkeypatch.setattr(fast_txt, "_lib", None)
    monkeypatch.setattr(fast_txt, "_tried", False)
    monkeypatch.setattr(fast_txt, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path / "no-bin"))
    assert not fast_txt.available()
    np.testing.assert_array_equal(fast_txt.loadtxt(path), np.loadtxt(path).astype(np.float32))
