"""The port's examples against hpcs_tpu's (examples/*_torch.py and
examples/tour_torch.ipynb beside examples/api_tour.py, eval_noise.py and
tour.ipynb), on the CPU at small sizes.

- eval_noise_torch on an orbax checkpoint that hpcs_tpu's save_checkpoint
  wrote after a few training steps prints the best k that
  examples/eval_noise.py prints on it (run here through runpy with its own
  argv), with the same scores (1e-6) and embeddings within the forward's
  tolerance, atol 2e-4 / rtol 1e-3;
- api_tour_torch's geometry section equals the JAX example's section 1
  (its own lines, run on its own draw) within 1e-6; its decode section, on
  a state carried from hpcs_tpu after 2 steps, gives hpcs_tpu's
  test_step / get_optimal_k best k, labels and score on hpcs_tpu's
  embeddings; the whole script runs at --epochs 2;
- tour_torch.ipynb's code cells run in order with finite logs and a score
  in [0, 1].
"""
import contextlib
import io
import json
import os
import re
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.serialization import to_state_dict

from _torch_port import synthetic_batch, torch_threads
from hpcs_tpu.decode import cosine_distance_matrix as j_cosine
from hpcs_tpu.decode import get_optimal_k as j_get_optimal_k
from hpcs_tpu.decode import linkage as j_linkage
from hpcs_tpu.decode import linkage_from_distances_mnn as j_linkage_mnn
from hpcs_tpu.geometry import expmap0 as j_expmap0
from hpcs_tpu.geometry import hyp_dist_o as j_hyp_dist_o
from hpcs_tpu.geometry import hyp_lca as j_hyp_lca
from hpcs_tpu.geometry import project as j_project
from hpcs_tpu.loss.hyphc import normalize_to_radius as j_normalize_to_radius
from hpcs_tpu.models import HypHCSystem as JSystem
from hpcs_tpu.models import ModelConfig as JConfig
from hpcs_tpu.utils.checkpoint import save_checkpoint as j_save
from hpcs_torch.models import HypHCSystem, ModelConfig
from hpcs_torch.utils.checkpoint import load_jax_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
sys.path.insert(0, EXAMPLES)
import api_tour_torch  # noqa: E402
import eval_noise_torch  # noqa: E402

TOL = dict(atol=2e-4, rtol=1e-3)  # the eval forward's, tests/test_torch_forward.py
NPOINTS = 64
NOISES = ["0.0", "0.08"]
# examples/eval_noise.py's model (its sizes are the port's example's)
EVAL_NOISE = dict(dataset="shapenet", num_class=6, num_categories=2, eucl_dim=8, hyp_dim=8, k=10,
                  t_per_anchor=8, num_triplets=4096, temperature=0.1, test_rotation="none")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    with torch_threads(2):
        yield


def _trained_state(cfg, steps, batch_size=4, n=NPOINTS):
    """hpcs_tpu's system of `cfg` and its state after `steps` steps."""
    jsys = JSystem(cfg)
    batch = {k: jnp.asarray(v) for k, v in synthetic_batch(batch_size, n).items()}
    state = jsys.init(jax.random.PRNGKey(0), batch)
    for i in range(steps):
        state, _ = jsys.train_step(state, batch, jax.random.PRNGKey(i), jnp.float32(0.1))
    return jsys, state


def _port_system(cfg_kw, state):
    system = HypHCSystem(ModelConfig(**cfg_kw), device="cpu")
    load_jax_state(system, jax.tree_util.tree_map(np.asarray, to_state_dict(state)))
    return system


@contextlib.contextmanager
def _recorded_jax_test_steps():
    """Every hpcs_tpu HypHCSystem.test_step's extras made in the block."""
    calls, original = [], JSystem.test_step

    def recorded(self, *args):
        out = original(self, *args)
        calls.append({k: np.asarray(v) for k, v in out[1].items()})
        return out

    JSystem.test_step = recorded
    try:
        yield calls
    finally:
        JSystem.test_step = original


def _printed_best_k(text):
    return [(float(n), int(k)) for n, k in re.findall(r"noise ([\d.]+): best_k=(\d+)", text)]


def test_eval_noise_torch_matches_the_jax_example(tmp_path, monkeypatch):
    jsys, state = _trained_state(JConfig(fixed_points=NPOINTS, **EVAL_NOISE), steps=4)
    ckpt = str(tmp_path / "ckpt")
    j_save(ckpt, state, jsys.cfg, epoch=0, use_orbax=True)
    flags = ["--ckpt", ckpt, "--npoints", str(NPOINTS), "--noises", *NOISES]

    monkeypatch.setattr(sys, "argv", ["eval_noise.py", *flags, "--out",
                                      str(tmp_path / "jax.png")])
    printed = io.StringIO()
    with _recorded_jax_test_steps() as want, contextlib.redirect_stdout(printed):
        runpy.run_path(os.path.join(EXAMPLES, "eval_noise.py"), run_name="__main__")
    jax_text = printed.getvalue()

    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        got = eval_noise_torch.main(flags + ["--device", "cpu", "--out",
                                             str(tmp_path / "torch.png")])
    assert os.path.getsize(tmp_path / "torch.png") > 0
    assert _printed_best_k(printed.getvalue()) == _printed_best_k(jax_text)
    assert len(_printed_best_k(jax_text)) == len(NOISES) == len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["x_euclidean"].numpy(), w["x_euclidean"][0], **TOL)
        np.testing.assert_allclose(g["x_poincare"].numpy(), w["x_poincare"][0], **TOL)
        assert g["best_k"] == int(w["best_k"][0])
        assert abs(g["score"] - float(w["best_score"][0])) <= 1e-6
        np.testing.assert_array_equal(g["pred"].numpy(), w["pred"][0])
        assert 0.0 <= g["score"] <= 1.0


def test_api_tour_geometry_is_the_jax_examples():
    """Section 1 of examples/api_tour.py, its own lines on its own draw,
    against api_tour_torch.geometry on the same tangent vectors."""
    with open(os.path.join(EXAMPLES, "api_tour.py")) as f:
        source = f.read()
    section = source[source.index("# --- 1."):source.index("# --- 2.")]
    ns = dict(jax=jax, jnp=jnp, expmap0=j_expmap0, hyp_dist_o=j_hyp_dist_o, hyp_lca=j_hyp_lca,
              key=jax.random.PRNGKey(0))
    with contextlib.redirect_stdout(io.StringIO()):
        exec(compile(section, "api_tour.py", "exec"), ns)
        got = api_tour_torch.geometry(torch.from_numpy(np.array(ns["u"])))
    x = ns["x"]
    want = dict(x=x, norms=jnp.linalg.norm(x, axis=-1),
                lca_depth=float(j_hyp_lca(x[0], x[1], return_coord=False)[0]),
                depth=j_hyp_dist_o(x)[:, 0])
    for key, w in want.items():
        np.testing.assert_allclose(np.asarray(got[key]), np.asarray(w), rtol=0, atol=1e-6,
                                   err_msg=key)


@jax.jit
def _j_decode(x_p, labels, scale):
    """hpcs_tpu's per-object decode, as its test_step writes it, alone."""
    def one(emb, y):
        Z = j_linkage_mnn(j_cosine(j_project(j_normalize_to_radius(emb, scale))),
                          method="complete")
        return (*j_get_optimal_k(y, Z, num_class=api_tour_torch.CONFIG["num_class"]), Z)

    return jax.vmap(one)(x_p, labels)


def test_api_tour_decode_is_hpcs_tpus_on_its_state(monkeypatch):
    """The tour's decode section on a state carried from hpcs_tpu after 2
    steps, without rotation.  The port's embeddings agree with hpcs_tpu's
    test_step's within the forward's tolerance.  After 2 steps most cosine
    distances nearly tie, so a decode moves with their rounding, and
    hpcs_tpu's test_step decodes values fused inside its jit (ROADMAP §C):
    the section is held on hpcs_tpu's own embeddings instead.  Its
    test_step's per-object prediction, best k, best score and linkage, and
    their mean score, equal hpcs_tpu's decode of those embeddings; its
    object 0 by hand equals hpcs_tpu's get_optimal_k by hand (the JAX
    example's section 4)."""
    kw = {**api_tour_torch.CONFIG, "test_rotation": "none"}
    jsys, state = _trained_state(JConfig(**kw), steps=2, n=kw["fixed_points"])
    system = _port_system(kw, state)
    batch = synthetic_batch(4, kw["fixed_points"], seed=3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    _, extras = jsys.test_step(state, jb, jax.random.PRNGKey(0), jnp.float32(0.1))
    with contextlib.redirect_stdout(io.StringIO()):
        own = api_tour_torch.decode(system, batch, torch.Generator().manual_seed(0))
    for key in ("x_euclidean", "x_poincare"):
        np.testing.assert_allclose(own["extras"][key].numpy(), np.asarray(extras[key]), **TOL)

    carried = tuple(torch.from_numpy(np.array(extras[k])) for k in ("x_euclidean", "x_poincare"))
    monkeypatch.setattr(system, "embed", lambda points, dv, idx_override=None: carried)
    with contextlib.redirect_stdout(io.StringIO()):
        got = api_tour_torch.decode(system, batch, torch.Generator().manual_seed(0))
    pred, best_k, best_score, Z = _j_decode(extras["x_poincare"], jb["labels"],
                                            state.params["scale"][0])
    for key, want in (("pred", pred), ("best_k", best_k), ("best_score", best_score),
                      ("linkage", Z)):
        np.testing.assert_array_equal(got["extras"][key].numpy(), np.asarray(want), err_msg=key)
    assert got["score"] == float(np.float32(np.mean(np.asarray(best_score), dtype=np.float32)))
    emb = j_normalize_to_radius(extras["x_poincare"][0], state.params["scale"][0])
    Z0 = j_linkage(emb, method="complete", metric="cosine")
    pred0, k0, score0 = j_get_optimal_k(jb["labels"][0], Z0, num_class=kw["num_class"])
    assert got["best_k"] == int(k0) and got["best_score"] == float(score0)
    np.testing.assert_array_equal(got["pred"].numpy(), np.asarray(pred0))
    np.testing.assert_array_equal(got["linkage"].numpy(), np.asarray(Z0))


def test_api_tour_torch_runs_whole():
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        out = api_tour_torch.main(["--device", "cpu", "--epochs", "2"])
    text = printed.getvalue()
    for line in ("ball points:", "after training:", "decode: mean best-k IoU score=",
                 "object 0: best k="):
        assert line in text, text
    assert all(np.isfinite(v) for v in out["train_logs"].values())
    assert 0.0 <= out["decode"]["score"] <= 1.0 and 1 <= out["decode"]["best_k"]
    assert out["system"].step == 2 * 4  # 2 epochs of 4 batches


def test_tour_torch_notebook_runs_in_order(tmp_path):
    """The code cells in order in one namespace, on the CPU: the first
    cell's DEVICE, EPOCHS and OUT set to 'cpu', 1 and a temporary
    directory after it runs."""
    with open(os.path.join(EXAMPLES, "tour_torch.ipynb")) as f:
        cells = [("".join(c["source"])) for c in json.load(f)["cells"]
                 if c["cell_type"] == "code"]
    ns = {"__name__": "__main__"}
    cwd = os.getcwd()
    os.chdir(EXAMPLES)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            for i, cell in enumerate(cells):
                exec(compile(cell, f"tour_torch.ipynb cell {i}", "exec"), ns)
                if i == 0:
                    assert ns["DEVICE"] == "cuda"
                    ns.update(DEVICE="cpu", EPOCHS=1, OUT=str(tmp_path))
    finally:
        os.chdir(cwd)
    logs = {k: float(v) for k, v in ns["logs"].items()}
    assert all(np.isfinite(v) for v in logs.values()) and 0.0 <= logs["score"] <= 1.0
    assert np.isfinite(ns["best_val"]) and ns["system"].step == 8  # 32 clouds in batches of 4
    assert os.path.getsize(tmp_path / "tour_eval.png") > 0
