"""The JAX package's own checkpoints read by the port: `hpcs_tpu.utils.
checkpoint.save_checkpoint` writes a TrainState with flax's msgpack, and
the port's reader (no flax, no msgpack) must give the in-memory state bit
for bit; `python -m hpcs_torch.infer` serves it as hpcs_tpu tests it, and
`fit(resume=)` trains on at its epoch + 1.  The test writer
`hpcs_torch.testing.write_flax_checkpoint` must write what hpcs_tpu reads."""
import dataclasses
import json
import os
import subprocess
import sys

import flax.serialization
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from _torch_port import jax_port_pair, numpy_opt_state, to_numpy_tree, torch_threads
from hpcs_tpu import trainer as jtrainer
from hpcs_tpu.models import HypHCSystem as JSystem
from hpcs_tpu.models import ModelConfig as JConfig
from hpcs_tpu.utils.checkpoint import restore_checkpoint as j_restore
from hpcs_tpu.utils.checkpoint import save_checkpoint as j_save
from hpcs_torch import infer, trainer
from hpcs_torch.cli import freeze_hierarchy
from hpcs_torch.data import DataLoader, SyntheticPartDataset
from hpcs_torch.models import HypHCSystem, ModelConfig
from hpcs_torch.models.base import decode_batch
from hpcs_torch.testing import (check_same_test_outputs, msgpack_pack, record_test_steps,
                                write_flax_checkpoint)
from hpcs_torch.utils import flax_msgpack
from hpcs_torch.utils.checkpoint import checkpoint_format, load_config, restore_checkpoint
from hpcs_torch.utils.jax_params import from_jax_hyperparams, from_jax_opt_state, from_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 64
TOL = dict(atol=2e-4, rtol=1e-3)  # A5's, as tests/test_torch_forward.py
# synthetic clouds of 4 categories x 3 parts, as `infer synthetic` reads them
SYNTH = dict(num_class=12, num_categories=4)
STATES = {
    "vn_dgcnn_step0": dict(),
    "vn_dgcnn_two_steps": dict(hyp=32),  # the flagship's ball width (infer's decode)
    "vn_dgcnn_bf16": dict(bf16=True),
    "dgcnn": dict(model_name="dgcnn_partseg", eucl=12),
}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    with torch_threads(2):
        yield


def _state(name):
    """(hpcs_tpu system, its TrainState) of the case `name`, at B=2, N=64."""
    over = dict(STATES[name])
    eucl, hyp = over.pop("eucl", 8), over.pop("hyp", 8)
    jsys, state, _, batch = jax_port_pair(eucl=eucl, hyp=hyp, B=2, N=N, k=8, random_stats=True,
                                          **SYNTH, **over)
    if name == "vn_dgcnn_two_steps":
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        for i in range(2):
            state, _ = jsys.train_step(state, jb, jax.random.PRNGKey(i), jnp.float32(0.1))
        # a checkpoint written after a plateau reduction
        state = jsys.set_learning_rate(state, 0.0025)
    return jsys, state


@pytest.fixture(scope="module")
def states():
    return {name: _state(name) for name in STATES}


@pytest.fixture(scope="module")
def written(states, tmp_path_factory):
    """Each case's state written by hpcs_tpu's save_checkpoint, epoch 3."""
    out = {}
    for name, (jsys, state) in states.items():
        path = str(tmp_path_factory.mktemp(name))
        j_save(path, state, jsys.cfg, epoch=3, extra={"note": name})
        out[name] = path
    return out


def _port_system(path):
    d = load_config(path)
    d["hierarchy_list"] = freeze_hierarchy(d["hierarchy_list"])
    return HypHCSystem(ModelConfig(**d), device="cpu", generator=torch.Generator().manual_seed(9))


def _assert_port_holds(system, state):
    """The port system holds the hpcs_tpu TrainState `state` bit for bit."""
    want = from_jax_params(to_numpy_tree(state.params), to_numpy_tree(state.batch_stats))
    got = system.net.state_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    moments = from_jax_opt_state(numpy_opt_state(state.opt_state), to_numpy_tree(state.params))
    for name, p in system.net.named_parameters():
        st = system.optimizer.state[p]
        assert st["step"] == moments[name]["step"] == int(state.opt_state.inner_state.count)
        assert torch.equal(st["exp_avg"], moments[name]["exp_avg"]), name
        assert torch.equal(st["exp_avg_sq"], moments[name]["exp_avg_sq"]), name
    lr = float(np.float32(state.opt_state.hyperparams["learning_rate"]))
    assert all(g["lr"] == lr for g in system.optimizer.param_groups)
    assert system.step == int(state.step)


@pytest.mark.parametrize("name", list(STATES))
def test_reader_gives_the_in_memory_state_bit_for_bit(name, states, written):
    jsys, state = states[name]
    assert checkpoint_format(os.path.join(written[name], "model.ckpt")) == "flax"
    system = _port_system(written[name])
    assert dataclasses.asdict(system.cfg) == dataclasses.asdict(
        ModelConfig(**{**dataclasses.asdict(jsys.cfg), "hierarchy_list": ()}))
    for path in (written[name], os.path.join(written[name], "model.ckpt")):
        # the JAX package stored the index of the epoch it finished: resume after it
        assert restore_checkpoint(path, system) == (4, {"note": name})
        _assert_port_holds(system, state)


def test_config_of_each_case_is_the_jax_packages(written):
    assert load_config(written["vn_dgcnn_bf16"])["bf16"] is True
    assert load_config(written["dgcnn"])["model_name"] == "dgcnn_partseg"
    assert load_config(written["vn_dgcnn_two_steps"])["lr"] == JConfig().lr


def test_chunked_leaves_are_joined_back(states, written, tmp_path, monkeypatch):
    jsys, state = states["vn_dgcnn_two_steps"]
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 4096)
    j_save(str(tmp_path), state, jsys.cfg, epoch=3, extra={"note": "vn_dgcnn_two_steps"})
    with open(tmp_path / "model.ckpt", "rb") as f:
        assert b"__msgpack_chunked_array__" in f.read()
    chunked = flax_msgpack.read(str(tmp_path / "model.ckpt"))
    whole = flax_msgpack.read(os.path.join(written["vn_dgcnn_two_steps"], "model.ckpt"))
    flat_c, flat_w = (jax.tree_util.tree_flatten_with_path(t)[0] for t in (chunked, whole))
    assert [p for p, _ in flat_c] == [p for p, _ in flat_w]
    for (path, c), (_, w) in zip(flat_c, flat_w):
        assert np.asarray(c).dtype == np.asarray(w).dtype, path
        np.testing.assert_array_equal(c, w, err_msg=str(path))
    system = _port_system(written["vn_dgcnn_two_steps"])
    restore_checkpoint(str(tmp_path), system)
    _assert_port_holds(system, state)


def _msgpack_cases():
    big = 70000
    return {
        "scalars": [None, True, False, 0, 5, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1,
                    2 ** 32, 2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
                    -2 ** 31, -2 ** 31 - 1, -2 ** 63, 1.5, -2.25e-300],
        "strings": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "é" * big, b"", b"\x00" * 300,
                    b"\x01" * big],
        "containers": [[], list(range(15)), list(range(16)), list(range(big)),
                       {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
                       {str(i): [i] for i in range(big)}, {"nested": {"deeper": {"x": [1]}}}],
        "arrays": {f"n{n}": np.arange(n, dtype=np.uint8) for n in (0, 1, 2, 3, 4, 8, 16, 17)}
        | {"f32": np.arange(12, dtype=np.float32).reshape(3, 4), "i32_0d": np.array(7, np.int32),
           "f64_t": np.arange(6.0).reshape(2, 3).T, "big": np.arange(big, dtype=np.float32),
           "i64": np.array([-3, 2 ** 40]), "bool": np.array([True, False])},
        "numpy_scalars": [np.float32(2.5), np.int32(-4), np.float64(1e-9)],
    }


@pytest.mark.parametrize("case", list(_msgpack_cases()))
def test_reader_reads_every_msgpack_type(case):
    """flax_msgpack.unpackb equals msgpack + flax's ext hook on msgpack's own
    bytes (every width msgpack picks), and the test writer's bytes read
    back through msgpack as flax reads them."""
    obj = _msgpack_cases()[case]
    packed = msgpack.packb(obj, default=flax.serialization._msgpack_ext_pack, strict_types=True,
                           use_single_float=False)
    want = msgpack.unpackb(packed, ext_hook=flax.serialization._msgpack_ext_unpack, raw=False,
                           strict_map_key=False)
    for data in (packed, msgpack_pack(obj)):
        got = flax_msgpack.unpackb(data)
        got_flat, want_flat = (jax.tree_util.tree_leaves(t, is_leaf=lambda x: x is None)
                               for t in (got, want))
        assert jax.tree_util.tree_structure(got, is_leaf=lambda x: x is None) == \
            jax.tree_util.tree_structure(want, is_leaf=lambda x: x is None)
        for g, w in zip(got_flat, want_flat):
            assert type(g) is type(w) and np.asarray(g).dtype == np.asarray(w).dtype
            np.testing.assert_array_equal(g, w)
    # single-precision floats and bfloat16 arrays, which flax reads as its own dtype
    assert flax_msgpack.unpackb(msgpack.packb(1.5, use_single_float=True)) == 1.5
    bits = np.array([0x3f80, 0xc000, 0x7fc0], np.uint16)  # 1, -2, NaN in bfloat16
    record = msgpack.packb(([3], "bfloat16", bits.tobytes()), use_bin_type=True)
    bf = flax_msgpack.unpackb(msgpack.packb(msgpack.ExtType(1, record)))
    assert bf.dtype == torch.bfloat16 and bf[:2].tolist() == [1.0, -2.0] and bf[2].isnan()
    with pytest.raises(NotImplementedError):
        flax_msgpack.unpackb(msgpack.packb(msgpack.ExtType(2, msgpack.packb((1.0, 2.0)))))


def test_infer_serves_a_jax_checkpoint_as_the_jax_package_tests_it(states, written):
    """`python -m hpcs_torch.infer synthetic` on hpcs_tpu's directory against
    hpcs_tpu's trainer.test on the same batches without rotation, as
    tests/test_torch_test_step.py holds test_step: the embeddings within
    A5's tolerance; the port's decode of hpcs_tpu's test_step embeddings
    equal to hpcs_tpu's own decode of them (prediction, best k, best score
    and linkage; ball width 32); the accuracy and IoU means within 0.02 (a
    point across an argmax near-tie).  An untrained model's embeddings are
    near-parallel, so a decode moves with rounding: test_step's own decode
    (one XLA program) differs from its decode of the x_poincare it returns,
    and the served decode, on the port's embeddings, from both.  The served
    run is held to trainer.test of the restored system in memory instead,
    exactly.  The test loss is not compared: each package samples its own
    triplets."""
    jsys, state = states["vn_dgcnn_two_steps"]
    argv = ["synthetic", "--model_path", written["vn_dgcnn_two_steps"], "--fixed_points", str(N),
            "--batch", "4", "--test_batches", "2", "--test_rotation", "none",
            "--accelerator", "cpu"]
    with record_test_steps() as served:
        system, results = infer.main(argv)
    _assert_port_holds(system, state)
    batches = [{k: jnp.asarray(v) for k, v in b.items()} for b in
               DataLoader(SyntheticPartDataset(num_objects=32, npoints=N, seed=3), 4,
                          shuffle=True, seed=0)][:2]
    jtest = JSystem(JConfig(**{**dataclasses.asdict(jsys.cfg), "test_rotation": "none"}))
    seen, step = [], jtest.test_step

    def recorded(*args):
        out = step(*args)
        seen.append(out[1])
        return out

    jtest.test_step = recorded
    want = jtrainer.test(jtest, state, batches, seed=0)
    for b, ext in zip(batches, seen):
        dv = np.eye(4, dtype=np.float32)[np.asarray(b["category"])]
        x_e, x_p = system.embed(np.array(b["points"]), dv)
        np.testing.assert_allclose(x_e.numpy(), np.asarray(ext["x_euclidean"]), **TOL)
        np.testing.assert_allclose(x_p.numpy(), np.asarray(ext["x_poincare"]), **TOL)
        got = decode_batch(torch.from_numpy(np.array(ext["x_poincare"])),
                           torch.from_numpy(np.array(b["labels"])), system.net.scale[0].detach(),
                           system.cfg.num_class)
        for g, w in zip(got, _j_decode(ext["x_poincare"], b["labels"], state.params["scale"][0])):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for key in ("test_acc", "test_iou"):
        assert abs(results[key] - want[key]) <= 0.02, key
    assert 0.0 <= results["score"] <= 1.0 and np.isfinite(results["test_loss"])
    loader = DataLoader(SyntheticPartDataset(num_objects=32, npoints=N, seed=3), 4, shuffle=True,
                        seed=0)
    with record_test_steps() as in_memory:
        trainer.test(system, loader, seed=0, limit_batches=2)
    check_same_test_outputs(served, in_memory)


@jax.jit
def _j_decode(x_p, labels, scale):
    """hpcs_tpu's per-object decode, as its test_step writes it, alone."""
    from hpcs_tpu.decode import cosine_distance_matrix, get_optimal_k, linkage_from_distances_mnn
    from hpcs_tpu.geometry import project
    from hpcs_tpu.loss.hyphc import normalize_to_radius

    def one(emb, y):
        Z = linkage_from_distances_mnn(cosine_distance_matrix(project(
            normalize_to_radius(emb, scale))), method="complete")
        return (*get_optimal_k(y, Z, num_class=SYNTH["num_class"], index="iou"), Z)

    return jax.vmap(one)(x_p, labels)


def test_fit_resumes_a_jax_checkpoint_at_its_epoch_plus_one(states, tmp_path):
    jsys, state = states["vn_dgcnn_two_steps"]
    last = str(tmp_path / "last")
    j_save(last, state, jsys.cfg, epoch=1)  # hpcs_tpu finished its epoch index 1
    system = _port_system(last)
    seen = []
    step = system.train_step

    def recorded(batch, generator):
        seen.append((system.step, system.optimizer.param_groups[0]["lr"]))
        return step(batch, generator)

    system.train_step = recorded
    data = SyntheticPartDataset(num_objects=4, npoints=N, seed=1)
    train = DataLoader(data, 2, shuffle=True, drop_last=True, seed=0)
    valid = DataLoader(SyntheticPartDataset(num_objects=2, npoints=N, seed=2), 2, drop_last=True)
    lines = []
    trainer.fit(system, train, valid, epochs=3, resume=last, log=lines.append)
    assert len(lines) == 1 and lines[0].startswith("epoch 2:")
    # the first resumed step starts from the stored step and plateau-reduced rate
    assert seen[0] == (2, float(np.float32(0.0025)))
    assert [s for s, _ in seen] == [2, 3] and system.step == 4


def test_checkpoint_format_is_told_by_its_first_bytes(tmp_path):
    torch.save({"x": torch.zeros(2)}, str(tmp_path / "t.ckpt"))
    (tmp_path / "m.ckpt").write_bytes(msgpack.packb({"state": {}}))
    (tmp_path / "big.ckpt").write_bytes(msgpack.packb({str(i): i for i in range(20)}))
    (tmp_path / "bad.ckpt").write_bytes(b"\x00garbage")
    assert checkpoint_format(str(tmp_path / "t.ckpt")) == "torch"
    assert checkpoint_format(str(tmp_path / "m.ckpt")) == "flax"
    assert checkpoint_format(str(tmp_path / "big.ckpt")) == "flax"
    with pytest.raises(ValueError):
        checkpoint_format(str(tmp_path / "bad.ckpt"))


@pytest.mark.parametrize("name,value", [("b1", 0.8), ("b2", 0.99), ("eps", 1e-6),
                                        ("weight_decay", 1e-4)])
def test_other_adam_hyperparameters_raise(name, value):
    hp = {"b1": np.float32(0.9), "b2": np.float32(0.999), "eps": np.float32(1e-8),
          "weight_decay": np.float32(0.0), "learning_rate": np.float32(0.01)}
    assert from_jax_hyperparams({"hyperparams": hp}) == float(np.float32(0.01))
    with pytest.raises(ValueError, match=name):
        from_jax_hyperparams({"hyperparams": {**hp, name: np.float32(value)}})


@pytest.mark.parametrize("name", ["vn_dgcnn_step0", "vn_dgcnn_two_steps", "vn_dgcnn_bf16"])
def test_flax_writer_restores_into_the_jax_template(name, states, written, tmp_path):
    """write_flax_checkpoint of the port system that holds a state, read by
    hpcs_tpu's restore_checkpoint into its template, equals that state leaf
    for leaf: the stand-in for an hpcs_tpu checkpoint on the card."""
    jsys, state = states[name]
    system = _port_system(written[name])
    restore_checkpoint(written[name], system)
    write_flax_checkpoint(str(tmp_path), system, system.cfg, epoch=3, extra={"note": name})
    template = jax.tree_util.tree_map(jnp.zeros_like, state)
    got, epoch, _ = j_restore(str(tmp_path), template)  # its template's extra is {}
    assert epoch == 3 and flax_msgpack.read(str(tmp_path / "model.ckpt"))["extra"] == {"note": name}
    flat_g, flat_w = (jax.tree_util.tree_flatten_with_path(t)[0] for t in (got, state))
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, path
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(path))
    with open(tmp_path / "config.json") as f:
        assert json.load(f) == load_config(written[name])


def test_reader_and_importer_need_no_jax_flax_or_msgpack(written, tmp_path):
    """The port restores hpcs_tpu's file and writes one for it with jax,
    flax, msgpack and hpcs_tpu unimportable."""
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'msgpack', 'hpcs_tpu'): sys.modules[m] = None\n"
        "import torch\n"
        "from hpcs_torch.cli import freeze_hierarchy\n"
        "from hpcs_torch.models import HypHCSystem, ModelConfig\n"
        "from hpcs_torch.testing import write_flax_checkpoint\n"
        "from hpcs_torch.utils.checkpoint import load_config, restore_checkpoint\n"
        "import hpcs_torch.import_checkpoint, hpcs_torch.utils.reference_import\n"
        f"path = {written['vn_dgcnn_two_steps']!r}\n"
        "d = load_config(path); d['hierarchy_list'] = freeze_hierarchy(d['hierarchy_list'])\n"
        "s = HypHCSystem(ModelConfig(**d), device='cpu')\n"
        "print(restore_checkpoint(path, s)[0], s.step)\n"
        f"write_flax_checkpoint({str(tmp_path)!r}, s, s.cfg, 3)\n"
        f"print(restore_checkpoint({str(tmp_path)!r}, s)[0])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["4", "2", "4"]
