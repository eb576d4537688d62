"""hpcs_torch.utils.hdf5, the port's HDF5 reader and writer, against h5py.

The reader reads files that h5py writes (every integer and IEEE float
dtype in both byte orders, 0-D to 3-D, compact, contiguous and chunked
layouts with edge chunks, deflate, shuffle and fletcher32, chunks never
written, deep chunk B-trees, a root group of several symbol table nodes,
libver "latest": tests/test_torch_hdf5_latest.py holds its growable datasets
and dense groups at size) to h5py's arrays and dtypes, or refuses with a ValueError
naming the feature and the file; h5py reads what the writer (and the tests'
deflated writer, hpcs_torch.testing.write_h5_deflated) writes; and both
packages' PartNetDataset read a port-written mini tree to the same arrays.
CPU only; h5py is the oracle and hpcs_torch never imports it.
"""
import contextlib
import io
import os
import sys

import h5py
import numpy as np
import pytest

from hpcs_torch.data import PartNetDataset
from hpcs_torch.testing import write_h5_deflated
from hpcs_torch.utils import hdf5

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import make_mini_datasets_torch as generator  # noqa: E402

DTYPES = ["i1", "i2", "i4", "i8", "u1", "u2", "u4", "u8", "f2", "f4", "f8",
          ">i2", ">i4", ">i8", ">u2", ">u4", ">u8", ">f2", ">f4", ">f8"]


def _data(shape, dtype="<f4", seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * (100 if np.dtype(dtype).kind != "f" else 1)
    if np.dtype(dtype).kind == "u":
        x = np.abs(x)
    return np.asarray(x.astype(dtype))


def _assert_reads_as_h5py(path, names=None):
    """Every dataset of `path` (or those named) equal and of the same dtype
    and shape through both readers; the root group's names equal."""
    with h5py.File(path, "r") as want, hdf5.File(path) as got:
        assert sorted(got.keys()) == sorted(want.keys())
        for name in names or want.keys():
            w, g = want[name][()], got[name][...]
            assert g.dtype == w.dtype and g.shape == w.shape, name
            np.testing.assert_array_equal(g, w, err_msg=name)
            assert (got[name].shape, got[name].dtype) == (w.shape, w.dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_reads_every_dtype_as_h5py(tmp_path, dtype):
    path = tmp_path / "x.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=_data((3, 5, 7), dtype))
        f.create_dataset("chunked", data=_data((9, 4), dtype, 1), chunks=(4, 3))
    _assert_reads_as_h5py(path)


def _compact(f, name, data):
    """A compact dataset (its data inside its object header), through
    h5py's low-level API."""
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_layout(h5py.h5d.COMPACT)
    ds = h5py.h5d.create(f.id, name.encode(), h5py.h5t.py_create(data.dtype),
                         h5py.h5s.create_simple(data.shape), dcpl=dcpl)
    ds.write(h5py.h5s.ALL, h5py.h5s.ALL, np.asarray(data))


RANKS = {"0d": (), "1d": (11,), "2d": (5, 6), "3d": (3, 4, 5)}


@pytest.mark.parametrize("rank,layout", [
    (rank, layout) for rank in RANKS
    for layout in ("compact", "contiguous", "chunked_whole", "chunked_edges")
    if rank != "0d" or not layout.startswith("chunked")])  # a scalar has no chunks
def test_reads_every_layout_and_rank_as_h5py(tmp_path, rank, layout):
    shape = RANKS[rank]
    path, data = tmp_path / "x.h5", _data(shape, "<f8")
    with h5py.File(path, "w") as f:
        if layout == "compact":
            _compact(f, "x", data)
        elif layout == "contiguous":
            f.create_dataset("x", data=data)
        else:  # chunks dividing the shape, or leaving partial edge chunks
            chunks = shape if layout == "chunked_whole" else tuple(max(1, s // 2) for s in shape)
            f.create_dataset("x", data=data, chunks=chunks)
    _assert_reads_as_h5py(path)


FILTERS = {"gzip1": dict(compression="gzip", compression_opts=1),
           "gzip9": dict(compression="gzip", compression_opts=9),
           "shuffle_gzip": dict(compression="gzip", shuffle=True),
           "fletcher32": dict(fletcher32=True),
           "shuffle_gzip_fletcher32": dict(compression="gzip", shuffle=True, fletcher32=True)}


@pytest.mark.parametrize("dtype", ["<f4", ">i8", "u2"])
@pytest.mark.parametrize("filters", list(FILTERS))
def test_reads_filtered_chunks_as_h5py(tmp_path, filters, dtype):
    path = tmp_path / "x.h5"
    with h5py.File(path, "w") as f:  # 7 x 5 chunks of 10 x 7, the last row and column partial
        f.create_dataset("x", data=_data((64, 33), dtype), chunks=(10, 7), **FILTERS[filters])
        # PartNet's layout: a chunk an object
        f.create_dataset("points", data=_data((3, 1000, 3), dtype, 1), chunks=(1, 1000, 3),
                         **FILTERS[filters])
    _assert_reads_as_h5py(path)


def test_chunks_never_written_read_as_the_fill_value(tmp_path):
    path = tmp_path / "x.h5"
    with h5py.File(path, "w") as f:
        d = f.create_dataset("x", shape=(20, 20), chunks=(6, 6), fillvalue=-3.5, dtype="f4",
                             compression="gzip")
        d[2:8, 13:] = 1.25  # 4 of the 16 chunks written
        f.create_dataset("zeros", shape=(9,), chunks=(4,), dtype="i2")
        f.create_dataset("empty", shape=(5, 3), dtype="<i4")  # contiguous, never allocated
    _assert_reads_as_h5py(path)
    with hdf5.File(path) as f:
        assert (f["x"][...] == -3.5).sum() == 400 - 6 * 7


def test_reads_a_chunk_btree_of_several_levels(tmp_path):
    path = tmp_path / "x.h5"
    with h5py.File(path, "w") as f:  # 400 chunks: a B-tree node holds 64
        f.create_dataset("x", data=_data((400, 7), "<f4"), chunks=(1, 7), compression="gzip")
    _assert_reads_as_h5py(path)


def test_reads_a_root_group_of_40_datasets(tmp_path):
    path = tmp_path / "x.h5"
    with h5py.File(path, "w") as f:
        for i in range(40):
            f.create_dataset(f"d{i:02d}", data=np.full((i % 5 + 1,), i, np.int16))
    with open(path, "rb") as f:  # a symbol table node holds 8 links
        assert f.read().count(b"SNOD") >= 5
    _assert_reads_as_h5py(path)


def test_reads_datasets_in_subgroups_and_after_a_user_block(tmp_path):
    path = tmp_path / "x.h5"
    with h5py.File(path, "w", userblock_size=1024) as f:
        f.create_dataset("a/b/x", data=_data((4, 3), "<f8"))
        f.create_dataset("a/y", data=_data((6,), ">i4"), chunks=(4,), compression="gzip")
    with h5py.File(path, "r") as want, hdf5.File(path) as got:
        for name in ("a/b/x", "/a/y"):
            np.testing.assert_array_equal(got[name][...], want[name][()])
        assert got["a"].keys() == ["b", "y"] and "a/b/x" in got and "a/z" not in got


LATEST = {  # what h5py writes with libver "latest", and whether the reader takes it
    "contiguous": (dict(data=_data((3, 5, 7), ">f8")), True),
    "compact_group_of_8": (dict(data=_data((6,), "i2")), True),
    "fixed_array_gzip": (dict(data=_data((50, 33), "u2"), chunks=(7, 8), compression="gzip",
                              shuffle=True), True),
    "fixed_array_fletcher32": (dict(data=_data((50, 33), "<f4"), chunks=(7, 8),
                                    fletcher32=True), True),
    "paged_fixed_array": (dict(data=_data((2500, 3), "<f4"), chunks=(1, 3),
                               compression="gzip"), True),
    "single_chunk": (dict(data=_data((4, 6), "<f8"), chunks=(4, 6), compression="gzip"), True),
    "unwritten_chunks": (dict(shape=(20, 20), chunks=(6, 6), fillvalue=7, dtype="i4"), True),
    "extensible_array": (dict(data=_data((20, 3), "<f4"), chunks=(2, 3), maxshape=(None, 3)),
                         True),
    "v2_btree": (dict(data=_data((20, 3), "<f4"), chunks=(2, 3), maxshape=(None, None)), True),
    "dense_group_of_40": (dict(data=_data((2,), "i2")), True),
}


@pytest.mark.parametrize("case", list(LATEST))
def test_libver_latest_files_read_as_h5py_or_refused_naming_the_feature(tmp_path, case):
    path, (spec, read) = tmp_path / "x.h5", LATEST[case]
    with h5py.File(path, "w", libver="latest") as f:
        for i in range(40 if case.startswith("dense") else 8 if "group" in case else 1):
            d = f.create_dataset(f"x{i}", **spec)
        if "shape" in spec:
            d[3:9, 3:9] = 1
    if read:
        _assert_reads_as_h5py(path)
        return
    with pytest.raises(ValueError, match=str(path)) as e:
        with hdf5.File(path) as f:
            f["x0"][...]
    assert "is not read" in str(e.value)
    assert any(word in str(e.value) for word in ("extensible array", "B-tree", "dense link"))


def _chunk_offset(path, name):
    with h5py.File(path, "r") as f:
        return f[name].id.get_chunk_info(1).byte_offset


def test_a_damaged_fletcher32_chunk_raises(tmp_path):
    path = tmp_path / "x.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=_data((40, 6), "<f4"), chunks=(10, 6), fletcher32=True)
    offset = _chunk_offset(path, "x")
    with open(path, "r+b") as f:
        f.seek(offset + 5)
        byte = f.read(1)
        f.seek(offset + 5)
        f.write(bytes([byte[0] ^ 0x10]))
    with h5py.File(path, "r") as f, pytest.raises(OSError):
        f["x"][()]
    with hdf5.File(path) as f, pytest.raises(ValueError, match="fletcher32 checksum"):
        f["x"][...]


@pytest.mark.parametrize("damage", ["truncated", "not_hdf5", "bad_deflate", "latest_header"])
def test_damaged_files_raise_value_errors_naming_the_file(tmp_path, damage):
    path = tmp_path / "x.h5"
    with h5py.File(path, "w", libver="latest" if damage == "latest_header" else "earliest") as f:
        f.create_dataset("x", data=_data((40, 6), "<f4"), chunks=(10, 6), compression="gzip")
        f.create_dataset("y", data=_data((400, 6), "<f8"))
    with open(path, "rb") as f:
        data = bytearray(f.read())
    if damage == "truncated":
        data = data[:len(data) - 1000]
    elif damage == "not_hdf5":
        data[:8] = b"NOT HDF5"
    elif damage == "latest_header":  # a dims byte of y's header, under its checksum
        at = data.index(b"OHDR", data.index(b"OHDR", data.index(b"OHDR") + 4) + 4)
        data[at + 30] ^= 0x40
    else:
        offset = _chunk_offset(path, "x")
        data[offset + 2:offset + 10] = b"\xff" * 8
    with open(path, "wb") as f:
        f.write(data)
    with pytest.raises(ValueError, match=str(path)):
        with hdf5.File(path) as f:
            f["x"][...], f["y"][...]


@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_random_damage_raises_a_value_error_or_reads(tmp_path, libver):
    """1-3 random bytes of a file's first 4 KiB (its metadata) changed, 1,000
    times: each read raises a ValueError or returns arrays (the data bytes
    carry no checksum, nor does version 0's metadata), never another
    exception."""
    path = tmp_path / "x.h5"
    with h5py.File(path, "w", libver=libver) as f:
        f.create_dataset("x", data=_data((40, 6), "<f4"), chunks=(10, 6), compression="gzip",
                         shuffle=True)
        f.create_dataset("y", data=_data((30, 7), ">i8"), chunks=(4, 7), fletcher32=True)
        f.create_dataset("z", data=_data((5, 3), "<f8"))
    with open(path, "rb") as f:
        clean = f.read()
    rng, outcomes = np.random.default_rng(0), {"read": 0, "refused": 0}
    for _ in range(1000):
        data = bytearray(clean)
        for at in rng.integers(0, min(len(data), 4096), rng.integers(1, 4)):
            data[at] = int(rng.integers(0, 256))
        damaged = tmp_path / "damaged.h5"
        damaged.write_bytes(bytes(data))
        try:
            with hdf5.File(damaged) as f:
                for name in f.keys():
                    f[name][...]
            outcomes["read"] += 1
        except ValueError:
            outcomes["refused"] += 1
    assert outcomes["refused"] > 0


@pytest.mark.parametrize("kind", ["string", "compound", "bool"])
def test_other_datatypes_are_refused_naming_them(tmp_path, kind):
    path = tmp_path / "x.h5"
    data = {"string": np.array([b"ab", b"cd"]), "bool": np.array([True, False]),
            "compound": np.zeros(3, [("a", "<i4"), ("b", "<f8")])}[kind]
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=data)
    name = {"string": "string", "compound": "compound", "bool": "enumerated"}[kind]
    with hdf5.File(path) as f, pytest.raises(ValueError, match=f"{name} datatype class"):
        f["x"][...]
    with pytest.raises(ValueError, match="writes integer and IEEE float"):
        hdf5.write_h5(str(tmp_path / "w.h5"), {"x": data})


@pytest.mark.parametrize("dtype", DTYPES)
def test_written_files_read_in_h5py_as_written(tmp_path, dtype):
    arrays = {"data": _data((4, 100, 3), dtype), "label_seg": _data((4, 100), dtype, 1),
              "data_num": _data((4,), dtype, 2), "scalar": _data((), dtype, 3),
              "empty": np.zeros((0, 3), dtype)}
    path = str(tmp_path / "x.h5")
    hdf5.write_h5(path, arrays)
    with h5py.File(path, "r") as f:
        assert sorted(f.keys()) == sorted(arrays)
        for name, want in arrays.items():
            got = f[name][()]
            assert got.dtype == want.dtype and got.shape == want.shape, name
            np.testing.assert_array_equal(got, want)
            assert f[name].chunks is None and f[name].compression is None
    _assert_reads_as_h5py(path)


def test_written_root_group_of_several_nodes_reads_in_h5py(tmp_path):
    arrays = {f"d{i:03d}": np.full((i % 3 + 1, 2), i, "<i8") for i in range(100)}
    path = str(tmp_path / "x.h5")
    hdf5.write_h5(path, arrays)
    _assert_reads_as_h5py(path)
    with h5py.File(path, "r+") as f:  # the library can extend it
        f.create_dataset("more", data=np.arange(3))
    _assert_reads_as_h5py(path)
    with pytest.raises(ValueError, match="writes up to 256"):
        hdf5.write_h5(path, {f"d{i}": np.zeros(1) for i in range(257)})


@pytest.mark.parametrize("rows,shuffle,level", [(1, False, 4), (3, True, 9), (2, False, 1)])
def test_the_deflated_writer_reads_in_h5py_as_written(tmp_path, rows, shuffle, level):
    arrays = {"data": _data((5, 1000, 3), "<f4"), "label_seg": _data((5, 1000), "<i8", 1),
              "data_num": np.full(5, 1000, np.int32)}
    path = str(tmp_path / "x.h5")
    write_h5_deflated(path, arrays, rows=rows, level=level, shuffle=shuffle)
    with h5py.File(path, "r") as f:
        assert f["data"].chunks == (rows, 1000, 3) and f["data"].compression == "gzip"
        assert f["data"].compression_opts == level and f["data"].shuffle == shuffle
        for name, want in arrays.items():
            np.testing.assert_array_equal(f[name][()], want)
    _assert_reads_as_h5py(path)


@pytest.fixture(scope="module")
def port_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("port"))
    with contextlib.redirect_stdout(io.StringIO()):
        generator.make_partnet(root, n_points=600, per_split=(3, 2, 2))
    return os.path.join(root, "PartNet", "sem_seg_h5")


@pytest.mark.parametrize("level", [1, 3])
@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_hpcs_tpu_reads_a_port_written_tree_as_the_port(port_tree, level, split):
    from hpcs_tpu.data import PartNetDataset as JPartNetDataset

    files = os.path.join(port_tree, f"Bottle-{level}", f"{split}_files.txt")
    port, ref = PartNetDataset(files, 256), JPartNetDataset(files, 256)
    for key in ("points", "data_num", "label_seg"):
        got, want = getattr(port, key), getattr(ref, key)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert len(port) == len(ref) == {"train": 3, "val": 2, "test": 2}[split]
    for i in range(len(port)):
        for got, want in zip(port[i], ref[i]):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_partnet_dataset_reads_deflated_files_as_contiguous_ones(tmp_path):
    rng = np.random.default_rng(3)
    arrays = {"data": rng.standard_normal((5, 10000, 3)).astype(np.float32),
              "label_seg": rng.integers(0, 9, (5, 10000)),
              "data_num": np.full(5, 10000, np.int32)}
    for name, write in (("plain", hdf5.write_h5), ("deflated", write_h5_deflated)):
        write(str(tmp_path / f"{name}.h5"), arrays)
        (tmp_path / f"{name}_files.txt").write_text(f"{name}.h5\n")
    plain, deflated = (PartNetDataset(str(tmp_path / f"{n}_files.txt"), 1024)
                       for n in ("plain", "deflated"))
    for key in ("points", "data_num", "label_seg"):
        np.testing.assert_array_equal(getattr(plain, key), getattr(deflated, key))
    np.testing.assert_array_equal(plain.points, arrays["data"])
    for i in range(5):
        for a, b in zip(plain[i], deflated[i]):
            np.testing.assert_array_equal(a, b)
