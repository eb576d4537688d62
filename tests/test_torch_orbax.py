"""hpcs_tpu's multi-process (orbax) checkpoints read by the port, which has
no orbax, tensorstore or JAX: libzstd through ctypes (`utils/zstd.py`),
tensorstore's OCDBT key-value store (`utils/ocdbt.py`), zarr v2 arrays
(`utils/zarr_v2.py`) and orbax's tree (`utils/orbax_dir.py`).

The readers are held against tensorstore's own ocdbt kvstore on
directories that orbax and tensorstore write.  A small hpcs_tpu VN-DGCNN
TrainState after 2 steps, saved by hpcs_tpu's save_checkpoint as orbax
(one process here; two CPU processes of 2 devices each, over
jax.distributed, as tools/multihost_dryrun.py starts them) and as msgpack,
must read leaf for leaf, bit for bit, as the msgpack does, and restore,
serve (`infer`) and resume (`train --resume`) as it.  The port's test writer
`testing.write_orbax_checkpoint` (processes 1 and 2) must be read by
hpcs_tpu's own restore_checkpoint into the TrainState `flax_state_of`
gives.  Each refusal names its cause.
"""
import ctypes
import json
import os
import shutil
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import tensorstore as ts
import torch
from flax.serialization import to_state_dict

from _torch_port import jax_port_pair, torch_threads
from hpcs_tpu.utils.checkpoint import restore_checkpoint as j_restore
from hpcs_tpu.utils.checkpoint import save_checkpoint as j_save
from hpcs_torch import infer, train
from hpcs_torch.cli import freeze_hierarchy
from hpcs_torch.models import HypHCSystem, ModelConfig
from hpcs_torch.testing import (check_same_test_outputs, flax_state_of, record_test_steps,
                                write_orbax_checkpoint)
from hpcs_torch.utils import flax_msgpack, ocdbt, zarr_v2, zstd
from hpcs_torch.utils.checkpoint import checkpoint_format, load_config, restore_checkpoint
from hpcs_torch.utils.orbax_dir import read_orbax_state

HERE = os.path.dirname(os.path.abspath(__file__))
N = 64
EPOCH = 3  # the epoch index hpcs_tpu stores: the port resumes at EPOCH + 1
SYNTH = dict(num_class=12, num_categories=4)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    with torch_threads(2):
        yield


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """hpcs_tpu's state after 2 steps and a plateau-halved rate, saved as
    msgpack and as orbax in this process; the two-process save of the same
    state starts in the background (`two_process` collects it)."""
    jsys, state, _, batch = jax_port_pair(eucl=8, hyp=32, B=2, N=N, k=8, random_stats=True,
                                          **SYNTH)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for i in range(2):
        state, _ = jsys.train_step(state, jb, jax.random.PRNGKey(i), jnp.float32(0.1))
    state = jsys.set_learning_rate(state, 0.0025)
    root = tmp_path_factory.mktemp("saved")
    paths = {name: str(root / name) for name in ("msgpack", "orbax", "orbax2")}
    j_save(paths["msgpack"], state, jsys.cfg, epoch=EPOCH, extra={"note": "x"})
    j_save(paths["orbax"], state, jsys.cfg, epoch=EPOCH, extra={"note": "x"}, use_orbax=True)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_orbax_worker.py"), str(i), "2", str(port),
         paths["msgpack"], paths["orbax2"]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for i in range(2)]
    try:
        yield jsys, state, paths, procs
    finally:
        for p in procs:
            p.kill()
            p.communicate()


@pytest.fixture(scope="module")
def two_process(saved):
    """The two-process orbax directory, once both processes have ended."""
    *_, paths, procs = saved
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out[-3000:]
    return paths["orbax2"]


def _port_system(path):
    d = load_config(path)
    d["hierarchy_list"] = freeze_hierarchy(d["hierarchy_list"])
    return HypHCSystem(ModelConfig(**d), device="cpu", generator=torch.Generator().manual_seed(9))


def _leaves(tree, path=()):
    if isinstance(tree, dict) and tree:
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _assert_same_tree(got, want):
    """Leaf for leaf, bit for bit, the same dtype and shape; {} for {}."""
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys(), sorted(set(g) ^ set(w))
    for path, x in w.items():
        y = g[path]
        if isinstance(x, dict):
            assert y == {} and x == {}, path
            continue
        assert type(y) is type(x) and y.dtype == x.dtype and y.shape == x.shape, path
        np.testing.assert_array_equal(y, x, err_msg=str(path))


def _assert_same_system(got, want):
    assert got.net.state_dict().keys() == want.net.state_dict().keys()
    for k, v in want.net.state_dict().items():
        assert torch.equal(got.net.state_dict()[k], v), k
    named = dict(got.net.named_parameters())
    for name, p in want.net.named_parameters():
        a, b = got.optimizer.state[named[name]], want.optimizer.state[p]
        assert a["step"] == b["step"], name
        assert torch.equal(a["exp_avg"], b["exp_avg"]) and \
            torch.equal(a["exp_avg_sq"], b["exp_avg_sq"]), name
    assert [g["lr"] for g in got.optimizer.param_groups] == \
        [g["lr"] for g in want.optimizer.param_groups]
    assert got.step == want.step


# ------------------------------------------------------------------ zstd


def _unsized_frame(data):
    """A zstd frame that does not state its content size (ZSTD_c_contentSizeFlag
    0), as tensorstore's streaming writes of OCDBT nodes are."""
    lib = zstd.library()
    lib.ZSTD_createCCtx.restype = ctypes.c_void_p
    lib.ZSTD_CCtx_setParameter.restype = ctypes.c_size_t
    lib.ZSTD_CCtx_setParameter.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.ZSTD_compress2.restype = ctypes.c_size_t
    lib.ZSTD_compress2.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                                   ctypes.c_void_p, ctypes.c_size_t]
    lib.ZSTD_freeCCtx.argtypes = [ctypes.c_void_p]
    cctx = lib.ZSTD_createCCtx()
    try:
        assert not lib.ZSTD_isError(lib.ZSTD_CCtx_setParameter(cctx, 200, 0))
        dst = ctypes.create_string_buffer(lib.ZSTD_compressBound(len(data)))
        n = lib.ZSTD_compress2(cctx, dst, len(dst), data, len(data))
        assert not lib.ZSTD_isError(n)
        return dst.raw[:n]
    finally:
        lib.ZSTD_freeCCtx(cctx)


@pytest.mark.parametrize("size", [0, 1, 1000, 1 << 20])
def test_zstd_round_trips_sized_and_streamed_frames(size):
    data = np.random.default_rng(size).integers(0, 4, size, dtype=np.uint8).tobytes()
    sized = zstd.compress(data, 1)
    assert zstd.library().ZSTD_getFrameContentSize(sized, len(sized)) == size
    streamed = _unsized_frame(data)
    assert zstd.library().ZSTD_getFrameContentSize(streamed, len(streamed)) == (1 << 64) - 1
    assert zstd.decompress(sized) == zstd.decompress(streamed) == data
    # concatenated frames are one content, as the format says
    assert zstd.decompress(sized + streamed + zstd.compress(b"tail")) == data + data + b"tail"


def test_zstd_errors_carry_libzstds_text():
    frame = zstd.compress(b"x" * 5000, 1)
    with pytest.raises(zstd.ZstdError, match="no zstd frame at byte 0"):
        zstd.decompress(b"not zstd")
    with pytest.raises(zstd.ZstdError, match="ZSTD_findFrameCompressedSize: "):
        zstd.decompress(frame[:-3])  # a truncated frame: libzstd's own message
    corrupt = bytearray(frame)
    corrupt[8:12] = b"\xff\xff\xff\xff"
    with pytest.raises(zstd.ZstdError, match="ZSTD_"):
        zstd.decompress(bytes(corrupt))


def test_a_libzstd_that_cannot_be_loaded_is_named(monkeypatch, saved):
    def refuse(name, *args, **kw):
        raise OSError(f"{name}: cannot open shared object file")

    monkeypatch.setattr(zstd, "_lib", None)
    monkeypatch.setattr(zstd.ctypes, "CDLL", refuse)
    with pytest.raises(zstd.ZstdError, match="libzstd.so.1"):
        zstd.decompress(b"\x28\xb5\x2f\xfd")
    with pytest.raises(zstd.ZstdError, match="cannot load libzstd.so.1"):
        restore_checkpoint(saved[2]["orbax"], None)


# ------------------------------------------------------ OCDBT and zarr


def _tensorstore_kv(root):
    return ts.KvStore.open({"driver": "ocdbt", "base": "file://" + os.path.abspath(root)}).result()


def _assert_reads_as_tensorstore(root):
    kv = _tensorstore_kv(root)
    keys = kv.list().result()
    reader = ocdbt.OcdbtReader(root)
    assert reader.keys() == sorted(keys) and keys
    for key in keys:
        assert reader.read(key) == kv.read(key).result().value, key


def _tensorstore_db(root, config, commits, seed=0):
    """An OCDBT database written by tensorstore: `commits` transactions of
    random keys (some rewritten) and values of 0-60 bytes."""
    kv = ts.KvStore.open({"driver": "ocdbt", "base": "file://" + str(root),
                          "config": config}).result()
    rng = np.random.default_rng(seed)
    for _ in range(commits):
        with ts.Transaction() as txn:
            for _ in range(30):
                key = f"group{rng.integers(6)}/key{rng.integers(300):04d}"
                kv.with_transaction(txn).write(key, rng.bytes(int(rng.integers(0, 61)))).result()


@pytest.mark.parametrize("case", ["hpcs_tpu", "written_1", "written_2", "deep", "uncompressed"])
def test_ocdbt_reader_equals_tensorstores_kvstore(case, saved, tmp_path):
    """Keys and values as tensorstore lists and reads them: orbax's own
    directory, the test writer's, and tensorstore databases whose trees
    have interior nodes (nodes of at most 300 bytes, 40 versions, past the
    manifest's inline version entries) or no compression."""
    jsys, state, paths, _ = saved
    if case == "hpcs_tpu":
        root = os.path.join(paths["orbax"], "orbax")
    elif case.startswith("written"):
        system = _port_system(paths["msgpack"])
        restore_checkpoint(paths["msgpack"], system)
        write_orbax_checkpoint(str(tmp_path), system, system.cfg, processes=int(case[-1]))
        root = str(tmp_path / "orbax")
    elif case == "deep":
        root = tmp_path / "db"
        _tensorstore_db(root, {"max_decoded_node_bytes": 300, "max_inline_value_bytes": 20}, 40)
    else:
        root = tmp_path / "db"
        _tensorstore_db(root, {"compression": None}, 3)
    _assert_reads_as_tensorstore(root)


def test_ocdbt_refusals_name_the_file_and_offset(saved, tmp_path):
    root = str(tmp_path / "orbax")
    shutil.copytree(os.path.join(saved[2]["orbax"], "orbax"), root)
    manifest = os.path.join(root, "manifest.ocdbt")
    good = open(manifest, "rb").read()

    def broken(at, value):
        data = bytearray(good)
        data[at] = value
        with open(manifest, "wb") as f:
            f.write(bytes(data))

    broken(0, 0x0D)  # the magic
    with pytest.raises(ocdbt.OcdbtError, match=r"manifest.ocdbt at byte 0: magic 0x0ddb3a2a"):
        ocdbt.OcdbtReader(root)
    broken(12, 1)  # the format version
    with pytest.raises(ocdbt.OcdbtError, match="unknown OCDBT format version 1"):
        ocdbt.OcdbtReader(root)
    broken(13, 7)  # the compression
    with pytest.raises(ocdbt.OcdbtError, match="unknown OCDBT compression 7"):
        ocdbt.OcdbtReader(root)
    broken(len(good) - 1, good[-1] ^ 1)  # the checksum
    with pytest.raises(ocdbt.OcdbtError, match="crc32c mismatch"):
        ocdbt.OcdbtReader(root)
    # a node: the root tree's leaf, its magic broken at its own offset
    broken(0, good[0])
    node = [os.path.join(root, "d", f) for f in os.listdir(os.path.join(root, "d"))][0]
    data = bytearray(open(node, "rb").read())
    data[1] ^= 0xFF
    with open(node, "wb") as f:
        f.write(bytes(data))
    with pytest.raises(ocdbt.OcdbtError, match=rf"{os.path.basename(node)} at byte 0: magic"):
        ocdbt.OcdbtReader(root)


class _Store(dict):
    def read(self, key):
        return self[key.encode()]

    def __contains__(self, key):
        return super().__contains__(key.encode() if isinstance(key, str) else key)


def _zarray(**over):
    meta = {"chunks": [2, 3], "compressor": {"id": "zstd", "level": 1},
            "dimension_separator": ".", "dtype": "<f4", "fill_value": None, "filters": None,
            "order": "C", "shape": [3, 5], "zarr_format": 2, **over}
    return json.dumps(meta).encode()


def test_zarr_reads_tensorstores_edge_chunks_and_dtypes(tmp_path):
    """zarr arrays that tensorstore writes into an OCDBT kvstore, at
    chunk shapes that do not divide the array (edge chunks), in every
    dtype a TrainState holds, zstd-compressed and raw."""
    rng = np.random.default_rng(0)
    kv_spec = {"driver": "ocdbt", "base": "file://" + str(tmp_path)}
    cases = {"<f4": np.float32, "<i4": np.int32, "<u4": np.uint32, "<f8": np.float64,
             "<i8": np.int64}
    for i, (name, dt) in enumerate(cases.items()):
        x = (rng.standard_normal((7, 5)) * 1000).astype(dt)
        for comp in ({"id": "zstd", "level": 1}, None):
            path = f"a{i}_{comp is None}"
            arr = ts.open({"driver": "zarr", "kvstore": {**kv_spec, "path": path + "/"},
                           "metadata": {"shape": [7, 5], "chunks": [3, 2], "dtype": name,
                                        "compressor": comp}},
                          create=True).result()
            arr.write(x).result()
    reader = ocdbt.OcdbtReader(str(tmp_path))
    rng = np.random.default_rng(0)
    for i, (name, dt) in enumerate(cases.items()):
        x = (rng.standard_normal((7, 5)) * 1000).astype(dt)
        for comp in (False, True):
            got = zarr_v2.read_array(reader, f"a{i}_{comp}")
            assert got.dtype == dt
            np.testing.assert_array_equal(got, x)
    bits = np.array([[0x3F80, 0xC000], [0x7FC0, 0x0001]], np.uint16)  # 1, -2, NaN, denormal
    store = _Store({b"b/.zarray": _zarray(dtype="bfloat16", shape=[2, 2], chunks=[2, 2]),
                    b"b/0.0": zstd.compress(bits.tobytes(), 1)})
    bf = zarr_v2.read_array(store, "b")
    assert bf.dtype == torch.bfloat16 and bf[0].tolist() == [1.0, -2.0] and bf[1, 0].isnan()


@pytest.mark.parametrize("over,words", [
    (dict(compressor={"id": "blosc", "cname": "lz4"}), "compressor 'blosc'"),
    (dict(dtype="<f2"), "dtype '<f2'"),
    (dict(dtype="|b1"), "dtype '|b1'"),
    (dict(filters=[{"id": "delta"}]), "filters"),
    (dict(order="F"), "order 'F'"),
    (dict(dimension_separator="/"), "dimension_separator '/'"),
    (dict(), r"chunk 'a/1.1' is missing \(fill_value None\)"),
    (dict(fill_value=2.5), r"chunk 'a/1.1' is missing \(fill_value 2.5\)"),
])
def test_zarr_refusals_name_what_is_not_read(over, words):
    chunks = {f"a/{i}.{j}".encode(): zstd.compress(np.zeros(6, np.float32).tobytes(), 1)
              for i in range(2) for j in range(2) if (i, j) != (1, 1)}
    store = _Store({b"a/.zarray": _zarray(**over), **chunks})
    with pytest.raises(ValueError, match=words):
        zarr_v2.read_array(store, "a")


# ------------------------------------------- hpcs_tpu's orbax directories


def test_orbax_state_is_the_msgpack_state_bit_for_bit(saved):
    paths = saved[2]
    assert checkpoint_format(paths["orbax"]) == "orbax"
    assert checkpoint_format(paths["msgpack"]) == "flax"
    want = flax_msgpack.read(os.path.join(paths["msgpack"], "model.ckpt"))["state"]
    got = read_orbax_state(os.path.join(paths["orbax"], "orbax"))
    assert sorted(got) == ["batch_stats", "opt_state", "params", "step"]
    _assert_same_tree(got, want)


def test_restore_checkpoint_loads_an_orbax_directory_as_the_msgpack(saved, tmp_path):
    paths = saved[2]
    want = _port_system(paths["msgpack"])
    assert restore_checkpoint(paths["msgpack"], want) == (EPOCH + 1, {"note": "x"})
    got = _port_system(paths["orbax"])
    assert restore_checkpoint(paths["orbax"], got) == (EPOCH + 1, {"note": "x"})
    _assert_same_system(got, want)
    assert got.step == 2 and got.optimizer.param_groups[0]["lr"] == float(np.float32(0.0025))
    # without meta.json hpcs_tpu reads epoch 0 and no extra: the port resumes at 1
    bare = str(tmp_path / "bare")
    shutil.copytree(paths["orbax"], bare)
    os.remove(os.path.join(bare, "meta.json"))
    assert restore_checkpoint(bare, _port_system(bare)) == (1, {})


@pytest.mark.parametrize("processes", [1, 2])
def test_the_port_writer_restores_through_hpcs_tpu(processes, saved, tmp_path):
    """write_orbax_checkpoint's directory, read by hpcs_tpu's own
    restore_checkpoint (orbax), is the TrainState flax_state_of gives; with
    2 processes every array whose first dimension divides by the 4 devices
    is in 4 chunks, split over ocdbt.process_0 and ocdbt.process_1."""
    jsys, state, paths, _ = saved
    system = _port_system(paths["msgpack"])
    restore_checkpoint(paths["msgpack"], system)
    path = str(tmp_path / "written")
    write_orbax_checkpoint(path, system, system.cfg, epoch=EPOCH, extra={"p": processes},
                           processes=processes)
    restored, epoch, extra = j_restore(path, state)
    assert epoch == EPOCH  # hpcs_tpu drops `extra` on restore; meta.json holds it
    with open(os.path.join(path, "meta.json")) as f:
        assert json.load(f) == {"epoch": EPOCH, "extra": {"p": processes}}
    got = [(p, np.asarray(x)) for p, x in
           jax.tree_util.tree_leaves_with_path(to_state_dict(restored))]
    want = jax.tree_util.tree_leaves_with_path(flax_state_of(system))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, p
        np.testing.assert_array_equal(g, w, err_msg=str(p))
    per_process = [set(ocdbt.OcdbtReader(os.path.join(path, "orbax", f"ocdbt.process_{i}")).keys())
                   for i in range(processes)]
    whole = ocdbt.OcdbtReader(os.path.join(path, "orbax"))
    assert set(whole.keys()) == set().union(*per_process)
    kernel = b"params.backbone.conv10.Dense_0.kernel"  # [256, 128]
    if processes == 2:
        assert {k for k in per_process[1] if k.startswith(kernel)} == \
            {kernel + b"/2.0", kernel + b"/3.0"}
    assert restore_checkpoint(path, _port_system(path)) == (EPOCH + 1, {"p": processes})


def test_infer_serves_an_orbax_directory_as_the_msgpack(saved):
    paths = saved[2]
    argv = ["synthetic", "--fixed_points", str(N), "--batch", "4", "--test_batches", "2",
            "--accelerator", "cpu"]
    with record_test_steps() as from_msgpack:
        _, want = infer.main(argv + ["--model_path", paths["msgpack"]])
    with record_test_steps() as from_orbax:
        system, got = infer.main(argv + ["--model_path", paths["orbax"]])
    check_same_test_outputs(from_orbax, from_msgpack)
    assert 0.0 <= got["score"] <= 1.0 and np.isfinite(got["test_loss"])


def test_train_resumes_an_orbax_directory_at_its_epoch_plus_one(saved, tmp_path, monkeypatch):
    """`python -m hpcs_torch.train --resume <orbax dir>` on synthetic clouds:
    the first resumed step starts from the stored step and plateau-halved
    rate, and the one epoch trained is EPOCH + 1."""
    paths = saved[2]
    monkeypatch.chdir(tmp_path)
    seen, step = [], HypHCSystem.train_step

    def recorded(self, batch, generator):
        seen.append((self.step, self.optimizer.param_groups[0]["lr"]))
        return step(self, batch, generator)

    monkeypatch.setattr(HypHCSystem, "train_step", recorded)
    train.main(["--dataset", "synthetic", "--fixed_points", str(N), "--k", "8",
                "--eucl_embedding", "8", "--hyp_embedding", "32", "--batch", "16",
                "--epochs", str(EPOCH + 2), "--resume", paths["orbax"], "--accelerator", "cpu",
                "--log", "logs"])
    steps = 64 // 16  # the synthetic training split, in batches of 16
    assert seen[0] == (2, float(np.float32(0.0025)))
    assert [s for s, _ in seen] == list(range(2, 2 + steps))
    with open(os.path.join("logs", "synthetic_vn_dgcnn_partseg", "metrics.jsonl")) as f:
        epochs = [r for r in map(json.loads, f) if "epoch" in r]
    assert [(r["epoch"], r["step"]) for r in epochs] == [(EPOCH + 1, 2 + steps)]


def test_a_two_process_save_reads_as_the_msgpack(saved, two_process, tmp_path):
    """hpcs_tpu's save_checkpoint in two processes (2 devices each): every
    array with a first dimension divisible by 4 is cut into 4 chunks, 2 in
    each process's ocdbt.process_<i>; the port reads the whole state as the
    msgpack, and restore_checkpoint loads the same system.  The port's
    write_orbax_checkpoint(processes=2) of that system writes the same
    _METADATA tree and the same keys in each ocdbt.process_<i>."""
    paths = saved[2]
    orbax = os.path.join(two_process, "orbax")
    assert sorted(f for f in os.listdir(orbax) if f.startswith("ocdbt.process_")) == \
        ["ocdbt.process_0", "ocdbt.process_1"]
    kernel = b"params.backbone.conv10.Dense_0.kernel/"
    second = ocdbt.OcdbtReader(os.path.join(orbax, "ocdbt.process_1")).keys()
    assert [k for k in second if k.startswith(kernel)] == [kernel + b"2.0", kernel + b"3.0"]
    want = flax_msgpack.read(os.path.join(paths["msgpack"], "model.ckpt"))["state"]
    _assert_same_tree(read_orbax_state(orbax), want)
    _assert_reads_as_tensorstore(orbax)
    got, ref = _port_system(two_process), _port_system(paths["msgpack"])
    assert restore_checkpoint(two_process, got) == (EPOCH + 1, {"processes": 2})
    restore_checkpoint(paths["msgpack"], ref)
    _assert_same_system(got, ref)
    written = str(tmp_path / "written")
    write_orbax_checkpoint(written, ref, ref.cfg, epoch=EPOCH, processes=2)

    def tree(root):
        with open(os.path.join(root, "_METADATA")) as f:
            return json.load(f)["tree_metadata"]

    assert tree(os.path.join(written, "orbax")) == tree(orbax)
    for i in range(2):
        keys = [ocdbt.OcdbtReader(os.path.join(root, "orbax", f"ocdbt.process_{i}")).keys()
                for root in (written, two_process)]
        assert keys[0] == keys[1], i
