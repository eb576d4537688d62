"""Shared helpers of the port's tests (tests/test_torch_*.py).

Inputs and weights are made with numpy from a seed and handed to both the
JAX package (the reference) and the port.
"""
import contextlib

import numpy as np
import pytest
import torch


def _first_vectorised_math_calls():
    """Make, and discard, the process's first multi-threaded calls of the
    vectorised math functions the port's CPU paths use.

    On the CPU build of PyTorch these tests run on, the first such call of
    torch.sqrt in a fresh process has returned values off in their fourth
    significant digit in one thread's share of a [2, 128, 7, 21] float32
    output, in a small share of fresh processes; every later call in the
    process was right.  A check at atol 1e-5 that hits that first call
    fails.
    """
    x = torch.rand(1 << 17, generator=torch.Generator().manual_seed(0)) + 0.5
    for t in (x, x.double()):
        for fn in (torch.sqrt, torch.rsqrt, torch.exp, torch.log, torch.tanh):
            fn(t)


_first_vectorised_math_calls()


@contextlib.contextmanager
def torch_threads(n):
    """Run the block with n intra-op CPU threads, then restore the count.

    The entry-point tests step small models, whose tensors are too small to
    share among many threads: with one thread per core in each of several
    test workers, the threads contend and a step takes several times longer.
    """
    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def bf16_einsum_on_cpu(monkeypatch):
    """Let hpcs_tpu's bf16 path run on this CPU: replace jax.numpy.einsum,
    for the monkeypatch's duration, by one that runs an einsum of two bf16
    operands with preferred_element_type float32 on their fp32 upcasts at
    HIGHEST precision.

    XLA:CPU refuses that dot at the VN channel mixes' sizes ("Unsupported
    element type for DotThunk::Execute: BF16 x BF16 = F32"), eagerly and
    under jit.  The replacement computes the same function up to the order
    of the fp32 sum: every product of two bf16 values is exact in fp32, and
    bf16 to fp32 is exact.  Every other einsum goes to JAX's own.  Nothing
    under hpcs_tpu/ changes."""
    import jax
    import jax.numpy as jnp

    real = jnp.einsum

    def einsum(*operands, preferred_element_type=None, precision=None, **kw):
        arrays = [o for o in operands if not isinstance(o, str)]
        if preferred_element_type == jnp.float32 and all(
                getattr(a, "dtype", None) == jnp.bfloat16 for a in arrays):
            operands = [o if isinstance(o, str) else o.astype(jnp.float32) for o in operands]
            precision = jax.lax.Precision.HIGHEST
        return real(*operands, preferred_element_type=preferred_element_type,
                    precision=precision, **kw)

    monkeypatch.setattr(jnp, "einsum", einsum)


def jit_as_written(fn, *args):
    """fn compiled for args (jax.jit) with XLA's xla_allow_excess_precision
    off, so the program rounds to bf16 wherever its source casts to bf16.  By default
    XLA may keep a chain of bf16 operations in fp32 and drop the roundings
    between them (VN-DGCNN with max pooling in bf16 at B=2, N=64 then moves
    5.9-7.3 % of its output's largest entry, as far from float64 as the
    rounded program: tools/bf16_readings.py).  The port rounds where the
    source does, as JAX's eager mode does."""
    import jax

    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def require_cuda():
    """Skip the calling test unless an NVIDIA GPU is present."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def rand_bn(rng, c):
    """Non-trivial BatchNorm parameters and running statistics."""
    return dict(scale=(1.0 + 0.2 * rng.standard_normal(c)).astype(np.float32),
                bias=(0.2 * rng.standard_normal(c)).astype(np.float32),
                mean=(0.3 * rng.standard_normal(c)).astype(np.float32),
                var=(0.5 + rng.uniform(size=c)).astype(np.float32))


def rand_vn_llr(rng, cin, cout, share=False):
    """Weights of one VNLinearLeakyReLU as (flax params, flax batch_stats,
    port state_dict)."""
    W = (rng.standard_normal((cout, cin)) / np.sqrt(cin)).astype(np.float32)
    Wd = (rng.standard_normal((1 if share else cout, cin)) / np.sqrt(cin)).astype(np.float32)
    bn = rand_bn(rng, cout)
    params = {"linear": {"kernel": W.T}, "dir_kernel": Wd.T,
              "batchnorm": {"bn": {"scale": bn["scale"], "bias": bn["bias"]}}}
    stats = {"batchnorm": {"bn": {"mean": bn["mean"], "var": bn["var"]}}}
    sd = {"map_to_feat.weight": W, "map_to_dir.weight": Wd,
          "batchnorm.bn.weight": bn["scale"], "batchnorm.bn.bias": bn["bias"],
          "batchnorm.bn.running_mean": bn["mean"], "batchnorm.bn.running_var": bn["var"],
          "batchnorm.bn.num_batches_tracked": np.array(0)}
    return params, stats, {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}


def randomize_batch_stats(tree, rng):
    """A copy of a flax batch_stats tree with random means and variances."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = randomize_batch_stats(v, rng)
        elif k == "mean":
            out[k] = (0.3 * rng.standard_normal(np.shape(v))).astype(np.float32)
        else:
            out[k] = (0.5 + rng.uniform(size=np.shape(v))).astype(np.float32)
    return out


def to_numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def tie_cloud(rng, b, n, d):
    """Clouds whose points each appear twice, so every point has an exact tie."""
    half = rng.standard_normal((b, n // 2, d)).astype(np.float32)
    return np.concatenate([half, half], axis=1)


def lattice_cloud(rng, b, n):
    """Points on a small integer lattice: many distinct neighbours at exactly
    equal distances, with scores exact in fp32."""
    return rng.integers(-3, 4, size=(b, n, 3)).astype(np.float32)


def line_cloud(b, n, d=3):
    """x_j = (j, 0, ..., 0): exact scores 2 i j - j^2 (n <= 2048), which rise
    with the column index up to the row's own, so the last rows rise all
    the way."""
    x = np.zeros((b, n, d), np.float32)
    x[:, :, 0] = np.arange(n)
    return x


def adjacent_dup_cloud(rng, b, n, d, r=4):
    """Integer clouds with x[2m] == x[2m+1]: exact ties inside one 32-column
    group of the kernel's scan."""
    half = rng.integers(-r, r + 1, size=(b, (n + 1) // 2, d)).astype(np.float32)
    return np.repeat(half, 2, axis=1)[:, :n]


def synthetic_batch(B, N, categories=2, seed=0, parts=3):
    """A batch dict of synthetic part-labelled clouds (numpy)."""
    from hpcs_torch.data import SyntheticPartDataset

    pts, cat, seg = SyntheticPartDataset(B, N, categories, parts_per_object=parts,
                                         seed=seed).batch(0, B)
    return {"points": pts, "labels": seg.astype(np.int32), "category": cat.astype(np.int32)}


def jax_port_pair(eucl=8, hyp=8, B=2, N=64, k=8, seed=0, random_stats=False, **over):
    """(JAX system, its TrainState, port system on the CPU, batch) on shared
    weights (from_jax_params); `over` sets fields of both ModelConfigs.
    JAX is imported here, so test_torch_cuda.py can import this module."""
    import jax
    import jax.numpy as jnp

    from hpcs_tpu.models import HypHCSystem as JSystem
    from hpcs_tpu.models import ModelConfig as JConfig
    from hpcs_torch.models import HypHCSystem, ModelConfig
    from hpcs_torch.utils.jax_params import from_jax_params

    kw = {**dict(dataset="shapenet", num_class=6, num_categories=2, eucl_dim=eucl, hyp_dim=hyp,
                 k=k), **over}
    jsys = JSystem(JConfig(fixed_points=N, **kw))
    batch = synthetic_batch(B, N, seed=seed)
    state = jsys.init(jax.random.PRNGKey(seed), {k_: jnp.asarray(v) for k_, v in batch.items()})
    if random_stats:
        stats = randomize_batch_stats(to_numpy_tree(state.batch_stats),
                                      np.random.default_rng(seed))
        state = state.replace(batch_stats=jax.tree_util.tree_map(jnp.asarray, stats))
    tsys = HypHCSystem(ModelConfig(**kw), device="cpu")
    tsys.net.load_state_dict(from_jax_params(to_numpy_tree(state.params),
                                             to_numpy_tree(state.batch_stats)))
    return jsys, state, tsys, batch


def rotated_batch(batch, seed=3):
    """The batch with its clouds rotated by seeded random rotations, for
    steps that train with train_rotation 'none'."""
    from scipy.spatial.transform import Rotation

    R = Rotation.random(len(batch["points"]), random_state=seed).as_matrix()
    pts = np.einsum("bnv,bwv->bnw", batch["points"].astype(np.float64), R).astype(np.float32)
    return {**batch, "points": pts}


def grad_close(got, want, ref, name, share):
    """The port's gradient `got` at most 4 times as far from the float64
    gradient `ref` as JAX's `want` is (plus 1e-4 of ref's largest entry),
    and within `share` of that entry of JAX's."""
    scale = float(np.abs(ref).max())
    assert np.abs(got - ref).max() <= 4 * np.abs(want - ref).max() + 1e-4 * scale, name
    assert np.abs(got - want).max() <= share * scale, name


def numpy_opt_state(opt):
    """hpcs_tpu's inject_hyperparams(riemannian_adam_fused) state with its
    count and packed moments as numpy."""
    inner = opt.inner_state
    return opt._replace(inner_state=inner._replace(
        count=np.asarray(inner.count), exp_avg=to_numpy_tree(inner.exp_avg),
        exp_avg_sq=to_numpy_tree(inner.exp_avg_sq)))


def load_opt_state(system, moments):
    """Set the port system's optimizer state from from_jax_opt_state's
    {name: state} map."""
    for name, p in system.net.named_parameters():
        system.optimizer.state[p] = {k: v.clone() if torch.is_tensor(v) else v
                                     for k, v in moments[name].items()}


class InjectedTriplets:
    """Patches the port's sampler (hpcs_torch.loss.joint) and 'easy' filter
    with hpcs_tpu's draws from a key and its mask on JAX's embeddings
    (`add`, as hpcs_tpu's compute_losses draws them from its key).  The
    port's own mask may differ from JAX's only where |sim(a,p) - sim(a,n)|
    < NEAR_TIE.  Each `add` serves until the next one."""

    NEAR_TIE = 1e-3

    def __init__(self, monkeypatch):
        from hpcs_torch.loss import joint

        real_filter = joint.margin_filter
        monkeypatch.setattr(joint, "sample_balanced_triplets", lambda *a, **k: self.trip)

        def margin_filter(emb, trip, margin=0.0, type_of_triplets="easy"):
            if emb.dtype == torch.float32:
                got = real_filter(emb, trip, margin, type_of_triplets).mask.numpy()
                flipped = got != self.mask
                assert (np.abs(self.tm[flipped]) < self.NEAR_TIE).all()
            return trip._replace(mask=torch.from_numpy(self.mask))

        monkeypatch.setattr(joint, "margin_filter", margin_filter)

    def add(self, k_loss, labels, x_p, cfg):
        import jax

        from hpcs_tpu.miner import margin_filter as j_margin_filter
        from hpcs_tpu.miner import sample_balanced_triplets as j_balanced
        from hpcs_torch.miner import Triplets, cosine_similarity01

        k_hyp, _ = jax.random.split(k_loss)
        trip = j_balanced(k_hyp, labels.reshape(-1), cfg.num_class, cfg.t_per_anchor,
                          cfg.fraction, num_triplets=cfg.num_triplets)
        flat = x_p.reshape(-1, x_p.shape[-1])
        self.mask = np.array(j_margin_filter(flat, trip, 0.0, "easy").mask)
        a, p, n = (torch.from_numpy(np.array(t, np.int64)) for t in trip[:3])
        e = torch.from_numpy(np.array(flat))
        self.tm = (cosine_similarity01(e[a], e[p]) - cosine_similarity01(e[a], e[n])).numpy()
        self.trip = Triplets(a, p, n, torch.from_numpy(np.array(trip.mask)))
