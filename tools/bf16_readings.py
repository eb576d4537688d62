"""Readings of VN-DGCNN's bf16 configuration against hpcs_tpu on the CPU:
the gaps that tests/test_torch_bf16*.py hold within their bounds, printed
as one JSON object.

    JAX_PLATFORMS=cpu python tools/bf16_readings.py

Every distance is a share of the float64 reference's largest entry (max
and mean over the output's entries).  The float64 reference is the port's
forward or stage in float64 on the same weights and graphs.
- forward: the eval forward at B=2, N=64, k=8 (test_torch_bf16's
  fixture), mean and max pooling: the port's bf16 output, hpcs_tpu's
  compiled as written (`jit_as_written`) and with XLA's defaults;
- stages: one eval EdgeConv stage per shape (test_torch_bf16's inputs):
  B2's plain version and hpcs_tpu's bf16 stage;
- training_forward: the training forward at B=2, N=96, k=8 (the training
  test's configuration) on hpcs_tpu's graphs: the port's and hpcs_tpu's
  bf16 x_poincare.
"""
import copy
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import test_torch_bf16 as T  # noqa: E402
from _torch_port import (bf16_einsum_on_cpu, jax_port_pair, jit_as_written,  # noqa: E402
                         rotated_batch)


def gaps(a, b, ref):
    """max and mean |a - b| as shares of ref's largest entry."""
    scale = float(np.abs(ref).max())
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return {"max": float(d.max()) / scale, "mean": float(d.mean()) / scale}


def forward_readings():
    out = {}
    for pooling in ("mean", "max"):
        jsys, state, tsys, batch = jax_port_pair(eucl=8, hyp=4, B=2, N=64, k=8,
                                                 random_stats=True, bf16=True, pooling=pooling,
                                                 test_rotation="none")
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        dv = T.j_decode_vector(jsys.cfg, jbatch)
        got, pairs = T._port_graphs(tsys, batch["points"], np.asarray(dv))
        graphs = [g for _, g in pairs]
        ref = T._float64_forward(tsys, batch["points"], dv, graphs)
        args = ({"params": state.params, "batch_stats": state.batch_stats}, jbatch["points"], dv)

        def apply(v, p, d):
            return jsys.net.apply(v, p, d, train=False)

        wants = {}
        for name, compile_ in (("as_written", jit_as_written), ("xla_default", None)):
            with pytest.MonkeyPatch.context() as given:  # hpcs_tpu's stages on the port's graphs
                given.setattr(T.JE, "knn",
                              lambda x, k, it=iter(graphs): jnp.asarray(next(it).numpy()))
                fn = compile_(apply, *args) if compile_ else jax.jit(apply)
                wants[name] = fn(*args)
        for i, what in enumerate(("x_euclidean", "x_poincare")):
            g, r = got[i].numpy(), ref[i]
            out[f"{pooling}_{what}"] = {
                "port_vs_float64": gaps(g, r, r),
                **{f"jax_{n}_vs_float64": gaps(w[i], r, r) for n, w in wants.items()},
                **{f"port_vs_jax_{n}": gaps(g, w[i], r) for n, w in wants.items()}}
    return out


def stage_readings():
    out = {}
    for c, n_convs in ((1, 2), (21, 2), (21, 1)):
        rng = np.random.default_rng(10 + c)
        x_t, x_j = T._both(T._x((2, 48, c, 3), c))
        idx = T.knn_plain(x_t.reshape(2, 48, -1), 8)
        modules = []
        convs = T._stage_weights(rng, c, n_convs)
        for _, _, sd in convs:
            m = T.TL.VNLinearLeakyReLU(sd["map_to_feat.weight"].shape[1], 21).eval()
            m.load_state_dict(sd)
            modules.append(m)
        e_j, _ = T.JE.graph_feature_vn(x_j, 8, idx=jnp.asarray(idx.numpy()))
        for params, stats, _ in convs:
            e_j = T.FL.VNLinearLeakyReLU(21).apply({"params": params, "batch_stats": stats},
                                                   e_j, train=False)
        want = T._np(T.FL.mean_pool(e_j))
        weights = [w.detach() for w in T.vn_dgcnn.stage_weights(*modules)]
        with torch.no_grad():
            b2 = T._np(T.E.edgeconv_infer_plain(x_t, idx, *weights, n_convs=n_convs))
            ref = T.E.edgeconv_infer_plain(x_t.double(), idx, *[w.double() for w in weights],
                                           n_convs=n_convs).numpy()
        out[f"c{c}_convs{n_convs}"] = {"b2_plain_vs_float64": gaps(b2, ref, ref),
                                       "jax_vs_float64": gaps(want, ref, ref),
                                       "b2_plain_vs_jax": gaps(b2, want, ref)}
    return out


def training_forward_readings():
    jsys, state, tsys, batch = jax_port_pair(
        eucl=8, hyp=8, B=2, N=96, k=8, dropout=0.0, train_rotation="none", t_per_anchor=10,
        temperature=0.1, trade_off=0.1, lr=0.005, bf16=True)
    batch = rotated_batch(batch)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    dv = T.j_decode_vector(jsys.cfg, jbatch)
    real = T.JE.knn

    def forward_and_graphs(st, k_drop):
        graphs = []
        T.JE.knn = lambda x, k: graphs.append(real(x, k)) or graphs[-1]
        try:
            x_p = jsys._apply(st.params, st.batch_stats, jbatch["points"], dv, True, k_drop)[1]
        finally:
            T.JE.knn = real
        return x_p, graphs

    key = jax.random.PRNGKey(10)
    x_p, jgraphs = jit_as_written(forward_and_graphs, state, key)(state, key)
    graphs = [torch.from_numpy(np.array(g)) for g in jgraphs]
    pts = torch.from_numpy(batch["points"])
    d = torch.from_numpy(np.asarray(dv))
    net = copy.deepcopy(tsys.net).train()
    net64 = copy.deepcopy(tsys.net).double().train()
    net64.nn_feat.compute_dtype = None
    with torch.no_grad():
        port = net(pts, d, idx_override=graphs)[1].double().numpy()
        ref = net64(pts.double(), d.double(), idx_override=graphs)[1].numpy()
    return {"port_vs_float64": gaps(port, ref, ref), "jax_vs_float64": gaps(x_p, ref, ref),
            "port_vs_jax": gaps(port, x_p, ref)}


def main():
    torch.set_num_threads(4)
    with pytest.MonkeyPatch.context() as mp:
        bf16_einsum_on_cpu(mp)
        readings = {"forward": forward_readings(), "stages": stage_readings(),
                    "training_forward": training_forward_readings()}
    print(json.dumps(readings, indent=1))


if __name__ == "__main__":
    main()
