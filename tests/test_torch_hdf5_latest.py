"""hpcs_torch.utils.hdf5 on the structures h5py writes with libver="latest",
against h5py (the oracle; the port never imports it):

- growable datasets of one unlimited dimension (the extensible array chunk
  index), plain and deflated + shuffled + fletcher32, with enough chunks
  to pass through the index block's own elements, its data blocks, super
  blocks and paged data blocks (the count computed from the array's
  parameters), the unlimited dimension first or not;
- datasets of two unlimited dimensions (the version 2 B-tree chunk index),
  plain and filtered, with B-trees of depth 1 and 2;
- groups of 9, 300, 3,000 and 30,000 links in dense storage (the fractal
  heap's root a direct block, an indirect block, and an indirect block with
  indirect children), and groups tracked by creation order, read through
  either index;
- soft and external links in dense storage refused by name;
- the committed fixtures (tools/make_hdf5_fixtures_torch.py) equal to the
  arrays of the tool's seeded recipe, with and without h5py: the CPU
  rehearsal of chip_smoke.py's check on the card.
"""
import importlib.util
import os
import struct
import sys

import h5py
import numpy as np
import pytest

from hpcs_torch.data import PartNetDataset
from hpcs_torch.utils import hdf5

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import make_hdf5_fixtures_torch as fixtures  # noqa: E402

FIXTURES = os.path.join(REPO, "tests", "fixtures", "hdf5_latest")


def _assert_reads_as_h5py(path, names):
    with h5py.File(path, "r") as want, hdf5.File(path) as got:
        for name in names:
            w, g = want[name][()], got[name][...]
            assert g.dtype == w.dtype and g.shape == w.shape, name
            np.testing.assert_array_equal(g, w, err_msg=name)


def _structures_read(monkeypatch):
    """The `what` of every checksummed structure the reader reads."""
    seen, checked = set(), hdf5.File._checked

    def spy(self, addr, n, what):
        seen.add(what)
        return checked(self, addr, n, what)

    monkeypatch.setattr(hdf5.File, "_checked", spy)
    return seen


def _chunks_to_pages(path):
    """The chunks that reach the first paged data block, from the
    parameters in the file's extensible array header: the index block's
    elements, then super block u's 2^(u // 2) data blocks of
    2^((u + 1) // 2) * min elements, paged when a block holds more than a
    page."""
    data = open(path, "rb").read()
    at = data.index(b"EAHD")
    idx_elements, min_elements, _, page_bits = struct.unpack_from("<4B", data, at + 8)
    total, u = idx_elements, 0
    while (1 << ((u + 1) // 2)) * min_elements <= 1 << page_bits:
        total += (1 << (u // 2)) * (1 << ((u + 1) // 2)) * min_elements
        u += 1
    return total + 1


@pytest.mark.parametrize("filtered", [False, True], ids=["plain", "deflate_shuffle_fletcher32"])
def test_extensible_arrays_read_as_h5py_through_pages(tmp_path, monkeypatch, filtered):
    path = tmp_path / "ea.h5"
    opts = dict(compression="gzip", shuffle=True, fletcher32=True) if filtered else {}
    with h5py.File(path, "w", libver="latest") as f:  # probe: the array's parameters
        f.create_dataset("x", data=np.zeros((1, 3), "<f4"), maxshape=(None, 3), chunks=(1, 3),
                         **opts)
    n = _chunks_to_pages(path) + 1100  # into the second page of the first paged block
    rng = np.random.default_rng(0)
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("x", data=rng.standard_normal((n, 3)).astype("<f4"), maxshape=(None, 3),
                         chunks=(1, 3), **opts)
        f.create_dataset("short", data=rng.integers(0, 9, (30, 4)).astype("<i8"),
                         maxshape=(None, 4), chunks=(1, 4), **opts)  # index block and 1 block
        f.create_dataset("columns", data=rng.standard_normal((5, 300)).astype(">f8"),
                         maxshape=(5, None), chunks=(2, 3), **opts)  # unlimited last, edges
    seen = _structures_read(monkeypatch)
    _assert_reads_as_h5py(path, ["x", "short", "columns"])
    assert {"an extensible array", "an extensible array index block",
            "an extensible array data block", "an extensible array super block",
            "an extensible array data block page"} <= seen, seen


def _btree_depth(path):
    data = open(path, "rb").read()
    return max(struct.unpack_from("<H", data, at + 12)[0]
               for at in range(len(data)) if data.startswith(b"BTHD", at))


@pytest.mark.parametrize("shape,chunks,filtered,depth", [
    ((30, 40), (2, 3), False, 1), ((40, 50), (1, 1), True, 1), ((120, 100), (1, 1), False, 2)],
    ids=["depth1", "depth1_filtered", "depth2"])
def test_version_2_btree_chunk_indexes_read_as_h5py(tmp_path, shape, chunks, filtered, depth):
    path = tmp_path / "bt.h5"
    opts = dict(compression="gzip", shuffle=True, fletcher32=True) if filtered else {}
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("x", data=np.random.default_rng(1).integers(-99, 99, shape).astype("<i2"),
                         maxshape=(None, None), chunks=chunks, **opts)
        f.create_dataset("empty", shape=(3, 4), maxshape=(None, None), chunks=(2, 2), dtype="u1",
                         fillvalue=5)
    assert _btree_depth(path) == depth
    _assert_reads_as_h5py(path, ["x", "empty"])


@pytest.mark.parametrize("links", [9, 300, 3000])
def test_dense_groups_read_as_h5py(tmp_path, links):
    path = tmp_path / "g.h5"
    with h5py.File(path, "w", libver="latest") as f:
        g = f.create_group("g")
        for i in range(links):
            g.create_dataset(f"member_{i:05d}", data=np.arange(i % 5 + 1, dtype="<i4") * i)
    data = open(path, "rb").read()
    assert b"FRHP" in data and (b"FHIB" in data) == (links >= 300)
    with h5py.File(path, "r") as want, hdf5.File(path) as got:
        assert set(got["g"].keys()) == set(want["g"].keys())
        for name in list(want["g"].keys())[::max(1, links // 40)]:
            np.testing.assert_array_equal(got["g"][name][...], want["g"][name][()])


def test_a_group_of_30000_links_reads_its_heaps_indirect_children(tmp_path):
    path = tmp_path / "g.h5"
    with h5py.File(path, "w", libver="latest") as f:
        target = f.create_dataset("target", data=np.arange(4, dtype="<f8"))
        g = f.create_group("g")
        for i in range(30000):
            g[f"link_{i:05d}"] = target
    assert open(path, "rb").read().count(b"FHIB") > 1  # the root and its indirect children
    with h5py.File(path, "r") as want, hdf5.File(path) as got:
        assert set(got["g"].keys()) == set(want["g"].keys())
        np.testing.assert_array_equal(got["g/link_29999"][...], want["target"][()])


def test_groups_tracked_by_creation_order_read_through_either_index(tmp_path):
    path = tmp_path / "o.h5"
    with h5py.File(path, "w", libver="latest") as f:
        for size in (5, 300):
            g = f.create_group(f"g{size}", track_order=True)
            for i in range(size):
                g.create_dataset(f"m{(i * 7919) % size:04d}", data=np.full(2, i, "<i2"))
    with h5py.File(path, "r") as want, hdf5.File(path) as got:
        for size in (5, 300):
            assert set(got[f"g{size}"].keys()) == set(want[f"g{size}"].keys())
            for name in want[f"g{size}"].keys():
                np.testing.assert_array_equal(got[f"g{size}"][name][...],
                                              want[f"g{size}"][name][()])
        # the creation-order B-tree alone (where it is the only index)
        info = [m[2] for m in got._header(got._links["g300"][1]) if m[0] == 0x2][0]
        assert info[1] & 3 == 3  # tracked and indexed
        heap, names, order = struct.unpack_from("<QQQ", info, 10)
        by_order = got._dense_links(heap, hdf5.UNDEFINED, order, "g300")
        assert by_order == got._dense_links(heap, names, None, "g300") and len(by_order) == 300


@pytest.mark.parametrize("kind", ["soft", "external"])
@pytest.mark.parametrize("storage", ["dense", "compact_by_creation_order"])
def test_soft_and_external_links_are_refused_by_name(tmp_path, kind, storage):
    """In a group's dense storage, and in a root group of link messages
    that carry both a link type and a creation order (the type first)."""
    path = tmp_path / "l.h5"
    dense = storage == "dense"
    with h5py.File(path, "w", libver="latest", track_order=not dense) as f:
        g = f.create_group("g") if dense else f
        for i in range(12 if dense else 3):
            g.create_dataset(f"d{i}", data=np.arange(3))
        g["link"] = h5py.SoftLink("/d0") if kind == "soft" else h5py.ExternalLink("x.h5", "/d")
    with hdf5.File(path) as got:
        g = got["g"] if dense else got
        assert set(g.keys()) == {f"d{i}" for i in range(12 if dense else 3)} | {"link"}
        np.testing.assert_array_equal(g["d2"][...], np.arange(3))
        with pytest.raises(ValueError, match=f"{path}: the {kind} link 'link' is not read"):
            g["link"]


def test_the_fixtures_read_as_the_recipe_makes_them():
    partnet = os.path.join(FIXTURES, fixtures.PARTNET_FILE)
    dense = os.path.join(FIXTURES, fixtures.DENSE_FILE)
    assert sum(os.path.getsize(os.path.join(FIXTURES, n)) for n in os.listdir(FIXTURES)) \
        < 256 * 1024
    with hdf5.File(partnet) as f:
        assert set(f.keys()) == set(fixtures.partnet_arrays())
        for key, want in fixtures.partnet_arrays().items():
            got = f[key][...]
            assert got.dtype == want.dtype and np.array_equal(got, want), key
            assert f[key]._maxshape[0] == (1 << 64) - 1  # growable along n
    ds = PartNetDataset(os.path.join(FIXTURES, fixtures.PARTNET_LIST), fixtures.PARTNET_POINTS)
    want = fixtures.partnet_arrays()
    assert np.array_equal(ds.points, want["data"]) and np.array_equal(ds.label_seg,
                                                                       want["label_seg"])
    assert np.array_equal(ds.data_num, want["data_num"])
    with hdf5.File(dense) as f:
        arrays = fixtures.dense_arrays()
        assert set(f.keys()) == {k.split("/")[0] for k in arrays}
        assert set(f["objects"].keys()) == {k[8:] for k in arrays if k.startswith("objects/")}
        for key, want in arrays.items():
            got = f[key][...]
            assert got.dtype == want.dtype and np.array_equal(got, want), key
    data = open(dense, "rb").read()
    assert b"FRHP" in data and b"BTHD" in data and b"EAHD" in open(partnet, "rb").read()


def test_the_fixture_tool_writes_the_committed_arrays_and_needs_h5py_only_to_write(tmp_path):
    assert importlib.util.find_spec("h5py") is not None
    fixtures.write(str(tmp_path))
    for name in (fixtures.PARTNET_FILE, fixtures.DENSE_FILE):
        with h5py.File(tmp_path / name, "r") as new, \
                h5py.File(os.path.join(FIXTURES, name), "r") as committed:
            def arrays(f):
                out = {}
                f.visititems(lambda k, v: out.__setitem__(k, v[()])
                             if isinstance(v, h5py.Dataset) else None)
                return out
            a, b = arrays(new), arrays(committed)
            assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    src = open(os.path.join(REPO, "tools", "make_hdf5_fixtures_torch.py")).read()
    head = src[:src.index("def write(")]
    assert "import h5py" not in head and "jax" not in src and "hpcs_tpu" not in src
