"""Helpers of the notebook tests (tests/test_torch_notebooks*.py): the mini
tree, hpcs_tpu's checkpoint on it, and runs of hpcs_tpu's and the port's
evaluation notebooks' code cells with their embeddings recorded or held."""
import contextlib
import io
import os
import sys

import numpy as np

from _torch_port import jax_trained_on_mini

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import make_eval_notebook_torch as notebooks  # noqa: E402
import make_mini_datasets_torch as minidata  # noqa: E402

NPOINTS = 64
ROW_TOL = 1e-6
TOL = dict(atol=2e-4, rtol=1e-3)  # the eval forward's, tests/test_torch_forward.py


def write_tree(root, datasets=("shapenet", "partnet")):
    """root/data (the mini tree of `datasets`) and root/examples (where the
    notebooks run)."""
    with contextlib.redirect_stdout(io.StringIO()):
        minidata.main([str(root / "data"), "--datasets", *datasets])
    (root / "examples").mkdir()
    return root


def checkpoint(tree, dataset, steps):
    """hpcs_tpu's msgpack checkpoint of its system trained `steps` steps on
    the tree's training split (test_rotation 'none'); its directory."""
    from hpcs_tpu.utils.checkpoint import save_checkpoint

    ckpt = str(tree / f"hpcs_tpu_{dataset}")
    jsys, state, _, _ = jax_trained_on_mini(dataset, str(tree / "data"), NPOINTS, steps,
                                            test_rotation="none")
    save_checkpoint(ckpt, state, jsys.cfg, epoch=0)
    return ckpt


class Recorder:
    """Stands in for a plotting function: keeps each call's arguments."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args, **kwargs):
        self.calls.append((args, kwargs))


class NoPyplot:
    @staticmethod
    def show():
        pass


def run_jax(nb, cwd):
    """hpcs_tpu's notebook `nb`: its code cells in order in one namespace
    from `cwd`, NPOINTS set to 64, its figure functions recording instead
    of drawing.  Returns (the namespace, the recorders, the (x_euclidean,
    x_poincare) of every embedding the notebook made, in order: each
    test_step's, then the precision-recall cell's net.apply)."""
    from hpcs_tpu.models import HypHCSystem as JSystem

    figures, embeddings, test_step = {}, [], JSystem.test_step

    def recorded(self, *args):
        out = test_step(self, *args)
        embeddings.append(tuple(np.asarray(out[1][k]) for k in ("x_euclidean", "x_poincare")))
        return out

    def after(i, ns):
        if i == 1:
            for name in ("plot_hyperbolic_eval", "plot_confusion_matrix",
                         "plot_precision_recall_curve"):
                figures[name] = ns[name] = Recorder()
            ns["plt"] = NoPyplot

    JSystem.test_step = recorded
    try:
        ns = run(nb, cwd, after)
    finally:
        JSystem.test_step = test_step
    if "xp" in ns:
        embeddings.append((None, np.asarray(ns["xp"])))
    return ns, figures, embeddings


def run_port(nb, cwd, carried, logits=None):
    """The port's notebook `nb` likewise, PLOT False, every embedding its
    system makes replaced by the next of `carried` (hpcs_tpu's, in the
    order _run_jax gives them) and, with `logits`, the precision-recall
    cell's CosFace logits by those.  Returns (the namespace, the port's own
    embeddings, in order, then its own precision-recall logits)."""
    import torch

    own, queue, n_cells = [], list(carried), len(notebooks.code_cells(nb))

    def after(i, ns):
        if logits is not None and i == n_cells - 2:  # before the precision-recall cell
            get_logits = ns["get_logits"]

            def held_logits(*args):
                own.append(get_logits(*args).numpy())
                return torch.from_numpy(np.array(logits))

            ns["get_logits"] = held_logits
        if i == 0:
            assert ns["DEVICE"] == "cpu" and ns["PLOT"] is True
            ns["PLOT"] = False
            system, embed = ns["system"], ns["system"].embed

            def held(points, decode_vector, idx_override=None):
                got = embed(points, decode_vector, idx_override)
                own.append(tuple(t.numpy() for t in got))
                x_e, x_p = queue.pop(0)
                return (got[0] if x_e is None else torch.from_numpy(np.array(x_e)),
                        torch.from_numpy(np.array(x_p)))

            system.embed = held

    return run(nb, cwd, after), own


def run(nb, cwd, after):
    """The code cells of `nb` in order in one namespace from `cwd`, NPOINTS
    set to 64, after(i, namespace) called after cell i."""
    ns = {"__name__": "__main__"}
    cwd0, path0 = os.getcwd(), list(sys.path)
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            for i, cell in enumerate(notebooks.code_cells(nb)):
                cell = cell.replace("NPOINTS, BATCH = 256, 2", f"NPOINTS, BATCH = {NPOINTS}, 2")
                exec(compile(cell, f"cell {i}", "exec"), ns)
                after(i, ns)
    finally:
        os.chdir(cwd0)
        sys.path[:] = path0
    return ns


def close_embeddings(own, carried):
    """The port's embeddings within the eval forward's tolerance of
    hpcs_tpu's on the same checkpoint and clouds."""
    assert len(own) == len(carried) > 0
    for (e, p), (je, jp) in zip(own, carried):
        np.testing.assert_allclose(p, jp, **TOL)
        if je is not None:
            np.testing.assert_allclose(e, je, **TOL)


def same_rows(got, want, key):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g[key], g["best_k"], g["true_parts"]) == (w[key], w["best_k"], w["true_parts"])
        assert abs(g["score"] - w["score"]) <= ROW_TOL, (g, w)


def jax_confusions(figures):
    """The confusion matrices hpcs_tpu's notebook handed to its plot, in
    order, with their part ids (from the class names)."""
    out = []
    for args, kwargs in figures["plot_confusion_matrix"].calls:
        parts = [int(name.split()[1]) for name in kwargs["classes"]]
        out.append((parts, np.asarray(args[0])))
    return out
