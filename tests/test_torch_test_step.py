"""The port's test_step slice against hpcs_tpu on the CPU: the conditioning
vector, the rotations, HypHCSystem.test_step and trainer.test.

The slice as a whole runs hpcs_tpu's jitted test_step and the port's on the
same weights (from_jax_params) and batch, with test_rotation="none".  The
embeddings agree within atol 2e-4 / rtol 1e-3 (the forward's tolerance).
The port's decode of JAX's own x_poincare must then equal hpcs_tpu's
decode_one (test_step's per-object decode, jitted and vmapped alone)
exactly, and test_step's prediction, best k and best score exactly.  Its
linkage has test_step's merges and sizes, but heights within 2e-9 only:
inside test_step's one XLA program the distances are not those that the
returned x_poincare gives, even to hpcs_tpu's own decode_one (near-parallel
embeddings, distances of ~3e-6 at relative 2e-5).  The ball width is 32,
the flagship's, where the port sums squares in the order of XLA's CPU code.
test_step's losses, on hpcs_tpu's own triplets (InjectedTriplets), agree
within rtol 1e-3 (the eval forward's tolerance), its accuracy and IoU
within 0.02 (a point or two on the other side of an argmax near-tie).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import InjectedTriplets, randomize_batch_stats, to_numpy_tree
from hpcs_tpu.decode import get_optimal_k as j_get_optimal_k
from hpcs_tpu.decode.linkage import cosine_distance_matrix as j_cosine
from hpcs_tpu.decode.linkage import linkage_from_distances_mnn as j_mnn
from hpcs_tpu.geometry import project as j_project
from hpcs_tpu.loss.hyphc import normalize_to_radius as j_normalize_to_radius
from hpcs_tpu.models import HypHCSystem as JSystem
from hpcs_tpu.models import ModelConfig as JConfig
from hpcs_tpu.models.base import decode_vector_for_batch as j_decode_vector
from hpcs_tpu.utils.rotations import random_so3 as j_random_so3
from hpcs_tpu.utils.rotations import rotate_cloud as j_rotate_cloud
from hpcs_torch import trainer
from hpcs_torch.data import SyntheticPartDataset
from hpcs_torch.loss import normalize_to_radius
from hpcs_torch.models import HypHCSystem, ModelConfig, decode_vector_for_batch
from hpcs_torch.models.base import decode_batch
from hpcs_torch.utils.jax_params import from_jax_params
from hpcs_torch.utils.rotations import augment, random_so3, random_z, rotate_cloud

TOL = dict(atol=2e-4, rtol=1e-3)


def _batch(B, N, C=2, seed=0):
    pts, cat, seg = SyntheticPartDataset(B, N, C, seed=seed).batch(0, B)
    return {"points": pts, "labels": seg.astype(np.int32), "category": cat.astype(np.int32)}


@pytest.mark.parametrize("dataset,class_vector", [("shapenet", False), ("shapenet", True),
                                                  ("partnet", False), ("partnet", True)])
def test_decode_vector_matches_jax(dataset, class_vector):
    kw = dict(dataset=dataset, class_vector=class_vector, num_class=6, num_categories=2)
    batch = _batch(3, 30)
    batch["labels"][1] = 4  # an object with one part only
    got = decode_vector_for_batch(ModelConfig(**kw), batch)
    want = j_decode_vector(JConfig(**kw), {k: jnp.asarray(v) for k, v in batch.items()})
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rotate_cloud_matches_jax_on_injected_rotations():
    rng = np.random.default_rng(3)
    pts = rng.standard_normal((4, 50, 3)).astype(np.float32)
    R = np.array(j_random_so3(jax.random.PRNGKey(3), 4))
    got = rotate_cloud(torch.from_numpy(pts), torch.from_numpy(R)).numpy()
    want = np.asarray(j_rotate_cloud(jnp.asarray(pts), jnp.asarray(R)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, np.einsum("bnv,bwv->bnw", pts.astype(np.float64), R),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("draw", [random_so3, random_z])
def test_random_rotations_are_rotations(draw):
    R = draw(torch.Generator().manual_seed(4), 64).double()
    eye = torch.eye(3, dtype=torch.float64).expand(64, 3, 3)
    torch.testing.assert_close(R @ R.transpose(1, 2), eye, rtol=0, atol=1e-6)
    torch.testing.assert_close(torch.linalg.det(R), torch.ones(64, dtype=torch.float64),
                               rtol=0, atol=1e-6)
    if draw is random_z:
        torch.testing.assert_close(R[:, 2], eye[:, 2], rtol=0, atol=0)
    # the same seed draws the same rotations
    torch.testing.assert_close(draw(torch.Generator().manual_seed(4), 64).double(), R)


def test_augment_modes():
    pts = torch.randn(2, 10, 3)
    assert augment(torch.Generator(), pts, "none") is pts
    rotated = augment(torch.Generator().manual_seed(0), pts, "so3")
    torch.testing.assert_close(rotated.norm(dim=-1), pts.norm(dim=-1))
    with pytest.raises(ValueError, match="rotation"):
        augment(torch.Generator(), pts, "x")


def _slice_pair(scale, N=160, B=2):
    """(JAX system and state, port system, batch) on shared weights and
    random batch statistics, the learnable radius set to `scale`."""
    kw = dict(dataset="shapenet", num_class=6, num_categories=2, eucl_dim=8, hyp_dim=32, k=8,
              test_rotation="none")
    jsys = JSystem(JConfig(fixed_points=N, **kw))
    batch = _batch(B, N)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    state = jsys.init(jax.random.PRNGKey(0), jbatch)
    params = to_numpy_tree(state.params)
    params["scale"] = np.full((1,), scale, np.float32)
    stats = randomize_batch_stats(to_numpy_tree(state.batch_stats), np.random.default_rng(0))
    state = state.replace(params=jax.tree_util.tree_map(jnp.asarray, params),
                          batch_stats=jax.tree_util.tree_map(jnp.asarray, stats))
    tsys = HypHCSystem(ModelConfig(**kw), device="cpu")
    tsys.net.load_state_dict(from_jax_params(params, stats))
    return jsys, state, jbatch, tsys, batch


@pytest.mark.parametrize("scale", [1e-3, 0.5, 0.999])
def test_test_step_matches_jax(scale, monkeypatch):
    jsys, state, jbatch, tsys, batch = _slice_pair(scale)
    key = jax.random.PRNGKey(1)
    jlogs, jext = jsys.test_step(state, jbatch, key, jnp.float32(0.1))
    _, k_loss = jax.random.split(key)  # as hpcs_tpu's test_step splits it
    InjectedTriplets(monkeypatch).add(k_loss, jbatch["labels"], jext["x_poincare"], jsys.cfg)
    tsys.temperature = 0.1
    logs, ext = tsys.test_step(batch, torch.Generator().manual_seed(1))
    assert set(logs) == set(jlogs) == {"test_loss", "score", "test_acc", "test_iou"}
    np.testing.assert_allclose(float(logs["test_loss"]), float(jlogs["test_loss"]), rtol=1e-3)
    for k in ("test_acc", "test_iou"):
        np.testing.assert_allclose(float(logs[k]), float(jlogs[k]), rtol=0, atol=0.02)
    np.testing.assert_allclose(ext["x_poincare"].numpy(), np.asarray(jext["x_poincare"]), **TOL)
    np.testing.assert_allclose(ext["x_euclidean"].numpy(), np.asarray(jext["x_euclidean"]), **TOL)
    assert ext["linkage"].shape == (2, 159, 4) and ext["pred"].shape == (2, 160)
    assert 0 <= float(logs["score"]) <= 1

    # the port's decode of JAX's own embeddings
    x_p = np.array(jext["x_poincare"])
    got = decode_batch(torch.from_numpy(x_p), torch.from_numpy(batch["labels"]),
                       torch.tensor(scale, dtype=torch.float32), 6)
    want = jax.jit(jax.vmap(_j_decode_one, in_axes=(0, 0, None)))(
        jnp.asarray(x_p), jbatch["labels"], jnp.float32(scale))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, name in zip(got[:3], ("pred", "best_k", "best_score")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(jext[name]))
    Z, jZ = got[3].numpy(), np.asarray(jext["linkage"])
    np.testing.assert_array_equal(Z[..., [0, 1, 3]], jZ[..., [0, 1, 3]])
    np.testing.assert_allclose(Z[..., 2], jZ[..., 2], rtol=0, atol=2e-9)
    assert float(got[2].mean()) == pytest.approx(float(jlogs["score"]), abs=1e-7)


def _j_decode_one(emb, labels, scale):
    """hpcs_tpu's per-object decode, as its test_step writes it."""
    Z = j_mnn(j_cosine(j_project(j_normalize_to_radius(emb, scale))), method="complete")
    pred, best_k, best_score = j_get_optimal_k(labels, Z, num_class=6, index="iou")
    return pred, best_k, best_score, Z


def test_normalize_to_radius_clamps_the_radius():
    x = torch.randn(3, 7, 32)
    for scale, radius in ((1e-6, 1e-4), (0.3, 0.3), (5.0, 1.0)):
        r = normalize_to_radius(x, torch.tensor(scale)).norm(dim=-1)
        torch.testing.assert_close(r, torch.full_like(r, radius), rtol=1e-6, atol=0)


def test_trainer_test_means_logs_over_batches():
    cfg = ModelConfig(num_class=6, num_categories=2, eucl_dim=4, hyp_dim=4, k=6)
    tsys = HypHCSystem(cfg, device="cpu")
    batches = [_batch(2, 48, seed=s) for s in range(3)]
    out = trainer.test(tsys, batches, seed=5, limit_batches=2)
    gen = torch.Generator().manual_seed(5 + 777)
    logs = [tsys.test_step(b, gen)[0] for b in batches[:2]]
    assert set(out) == {"test_loss", "score", "test_acc", "test_iou"}
    mean = {k: float(np.mean([float(lg[k]) for lg in logs])) for k in out}
    assert out["score"] == pytest.approx(mean["score"], abs=1e-7)
    for k in ("test_loss", "test_acc", "test_iou"):
        assert out[k] == pytest.approx(mean[k], rel=1e-6, abs=1e-7), k
    assert trainer.test(tsys, batches, limit_batches=0) == {}
