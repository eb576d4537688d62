"""tools/make_mini_datasets_torch.py (the port's generator) against
tools/make_mini_datasets.py: the trees they write under two roots are
equal, every txt and json file byte for byte and each h5 file's data,
data_num and label_seg arrays exactly (h5 bytes may hold timestamps); the
port's readers read them; the generator writes only what it is asked to,
and without h5py it writes the same trees (its own HDF5 writer).
"""
import contextlib
import io
import os
import sys

import h5py
import numpy as np
import pytest

from hpcs_torch.data import SEG_CLASSES, PartNetDataset, ShapeNetDataset, get_hierarchy_list

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import make_mini_datasets as jax_generator  # noqa: E402
import make_mini_datasets_torch as generator  # noqa: E402


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    port, jax_side = (str(tmp_path_factory.mktemp(name)) for name in ("port", "jax"))
    with contextlib.redirect_stdout(io.StringIO()):
        generator.main([port])
        jax_generator.make_shapenet(jax_side)
        jax_generator.make_partnet(jax_side)
    return port, jax_side


def test_the_trees_hold_the_same_files(trees):
    port, jax_side = trees
    assert _files(port) == _files(jax_side)
    kinds = {os.path.splitext(f)[1] for f in _files(port)}
    assert kinds == {".txt", ".json", ".h5"}


@pytest.mark.parametrize("kind", [".txt", ".json"])
def test_text_files_are_equal_byte_for_byte(trees, kind):
    port, jax_side = trees
    names = [f for f in _files(port) if f.endswith(kind)]
    assert names
    for name in names:
        with open(os.path.join(port, name), "rb") as a, \
                open(os.path.join(jax_side, name), "rb") as b:
            assert a.read() == b.read(), name


def test_h5_arrays_are_equal(trees):
    port, jax_side = trees
    names = [f for f in _files(port) if f.endswith(".h5")]
    assert len(names) == 6  # two levels, three splits
    for name in names:
        with h5py.File(os.path.join(port, name), "r") as a, \
                h5py.File(os.path.join(jax_side, name), "r") as b:
            assert set(a) == set(b) == {"data", "data_num", "label_seg"}
            for key in a:
                assert a[key].dtype == b[key].dtype, (name, key)
                np.testing.assert_array_equal(a[key][...], b[key][...], err_msg=f"{name} {key}")


def test_the_port_reads_the_trees(trees):
    raw = os.path.join(trees[0], "ShapeNet", "raw")
    for cat in ("Airplane", "Cap"):
        for split, n in zip(("train", "val", "test"), (3, 1, 2)):
            ds = ShapeNetDataset(raw, npoints=128, split=split, class_choice=cat)
            assert len(ds) == n
            pts, _, seg = ds[0]
            assert pts.shape == (128, 3) and set(np.unique(seg)) <= set(SEG_CLASSES[cat])
    h5 = os.path.join(trees[0], "PartNet", "sem_seg_h5", "Bottle-3")
    ds = PartNetDataset(os.path.join(h5, "test_files.txt"), 256)
    assert len(ds) == 2 and set(np.unique(ds[0][1])) <= set(range(1, 9))
    hier = get_hierarchy_list(os.path.join(trees[0], "PartNet", "after_merging_label_ids"),
                              "Bottle", [1, 3])
    assert [sum(len(b) for b in level) for level in hier] == [8, 8]


def test_only_the_datasets_asked_for_are_written(tmp_path):
    with contextlib.redirect_stdout(io.StringIO()):
        generator.main([str(tmp_path), "--datasets", "shapenet"])
    assert os.listdir(tmp_path) == ["ShapeNet"]


def test_without_h5py_only_partnet_fails_naming_it(trees, tmp_path, monkeypatch):
    """Without h5py the generator writes both trees, the PartNet h5 arrays
    (read afterwards by h5py, the oracle) equal to the JAX generator's."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    with contextlib.redirect_stdout(io.StringIO()):
        generator.make_shapenet(str(tmp_path))
        generator.make_partnet(str(tmp_path))
    monkeypatch.undo()  # h5py imports its own modules as it reads
    assert os.path.isdir(tmp_path / "ShapeNet" / "raw")
    names = [f for f in _files(trees[1]) if f.endswith(".h5")]
    assert [f for f in _files(str(tmp_path)) if f.endswith(".h5")] == names
    for name in names:
        with h5py.File(os.path.join(tmp_path, name), "r") as a, \
                h5py.File(os.path.join(trees[1], name), "r") as b:
            assert set(a) == set(b)
            for key in a:
                assert a[key].dtype == b[key].dtype, (name, key)
                np.testing.assert_array_equal(a[key][()], b[key][()], err_msg=f"{name} {key}")
