"""Headless figures of hierarchical segmentations: the counterpart of
hpcs_tpu/utils/viz.py, the same functions with the same arguments.

`plot_hyperbolic_eval` draws the 5-panel evaluation figure (ground-truth
cloud, predicted cloud, Euclidean embedding, Poincare-disk projection,
dendrogram) and saves it as a PNG; the other helpers draw one panel or one
figure each.  Inputs are numpy arrays (or anything np.asarray takes).

matplotlib (Agg, unless a notebook's inline backend is active), scipy's
dendrogram, sklearn's TSNE and umap are imported at first use, never when
hpcs_torch is imported: a machine without them runs everything else.
`require_matplotlib` raises the ImportError that --plot_inference gives
before any work where matplotlib is missing.
"""
import sys

import numpy as np
import torch


def require_matplotlib(what="plots"):
    """Raise ImportError naming matplotlib when it cannot be imported."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        raise ImportError(f"{what} need matplotlib, which is not installed here "
                          "(pip install matplotlib)") from e


def _pyplot():
    """matplotlib.pyplot, on the headless Agg backend unless a notebook's
    inline backend is active (figures returned to a notebook keep
    embedding)."""
    require_matplotlib()
    import matplotlib

    if "ipykernel" not in sys.modules:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _colors(labels):
    labels = np.asarray(labels)
    uniq = np.unique(labels)
    cmap = _pyplot().get_cmap("tab20")
    lut = {l: cmap(i % 20) for i, l in enumerate(uniq)}
    return [lut[l] for l in labels]


def plot_cloud(ax, points, labels=None, title=""):
    """3-D scatter of one cloud colored by labels."""
    points = np.asarray(points)
    c = _colors(labels) if labels is not None else "steelblue"
    ax.scatter(points[:, 0], points[:, 1], points[:, 2], c=c, s=3)
    ax.set_title(title)
    ax.set_axis_off()


def _pca2(x):
    x = np.asarray(x, np.float64)
    x = x - x.mean(axis=0)
    _, _, vt = np.linalg.svd(x, full_matrices=False)
    return x @ vt[:2].T


def _tangent_project2(emb):
    """Hyperbolic-aware 2-D reduction of ball embeddings [N, D]: the log map
    at the origin (the port's `geometry.logmap0`, in float64), where
    hyperbolic distances from the origin are Euclidean radii; there the
    hyperboloid UMAP layout where umap-learn is installed, else an
    uncentred SVD to 2-D (the tangent space's origin is the ball's, so
    centring would lose the radial depth); then `geometry.expmap0` back
    onto the disk.  logmap0 clamps radii at 1 - 1e-5, so points closer to
    the sphere than that project as if they were on it."""
    from ..geometry import expmap0, logmap0

    tangent = logmap0(torch.from_numpy(np.asarray(emb, np.float64))).numpy()
    try:  # optional: the hyperboloid UMAP when available
        import umap  # noqa: F401

        z = np.sqrt(1 + np.sum(tangent ** 2, axis=1, keepdims=True))
        hyperboloid = np.concatenate([tangent, z], axis=1)
        xy = umap.UMAP(output_metric="hyperboloid",
                       random_state=0).fit_transform(hyperboloid)
    except Exception:
        _, _, vt = np.linalg.svd(tangent, full_matrices=False)
        xy = tangent @ vt[:2].T
    return expmap0(torch.from_numpy(np.asarray(xy, np.float64))).numpy()


def plot_poincare_disk(ax, emb, labels, title="Poincare disk"):
    """2-D projection of ball embeddings inside the unit disk (tangent-space
    SVD, or hyperboloid UMAP when umap-learn is installed; the radii shown
    are the true per-point ball radii either way)."""
    plt = _pyplot()
    emb = np.asarray(emb)
    xy = emb[:, :2] if emb.shape[1] == 2 else _tangent_project2(emb)
    n = np.linalg.norm(xy, axis=1, keepdims=True)
    r = np.linalg.norm(np.asarray(emb), axis=1, keepdims=True)
    xy = np.where(n > 0, xy / np.where(n > 0, n, 1) * r, xy)  # keep true radii
    circle = plt.Circle((0, 0), 1.0, fill=False, color="gray", lw=0.8)
    ax.add_patch(circle)
    ax.scatter(xy[:, 0], xy[:, 1], c=_colors(labels), s=4)
    ax.set_xlim(-1.05, 1.05)
    ax.set_ylim(-1.05, 1.05)
    ax.set_aspect("equal")
    ax.set_title(title)
    ax.set_axis_off()


def plot_dendrogram(ax, Z, max_leaves=64, title="dendrogram"):
    """Merge-height profile of the linkage matrix (scipy's dendrogram
    layout where scipy imports, the sorted heights otherwise)."""
    Z = np.asarray(Z, np.float64)
    try:
        from scipy.cluster.hierarchy import dendrogram

        dendrogram(Z, ax=ax, no_labels=True, truncate_mode="lastp",
                   p=min(max_leaves, Z.shape[0] + 1), color_threshold=None)
    except Exception:
        ax.plot(np.sort(Z[:, 2]))
        ax.set_xlabel("merge")
        ax.set_ylabel("distance")
    ax.set_title(title)


def plot_hyperbolic_eval(x, y, y_pred, emb_hidden, emb_poincare, linkage_matrix,
                         k=None, score=None, screenshot=None, show=False,
                         embedding_method="pca"):
    """5-panel evaluation figure; returns the figure (saved when `screenshot`).

    x: [N, 3] points; y/y_pred: [N] labels; emb_hidden: [N, De];
    emb_poincare: [N, Dh]; linkage_matrix: [N-1, 4].
    embedding_method: 'pca' (the default, seconds faster per object) or
    'tsne' (sklearn's TSNE) for the Euclidean-embedding panel.
    """
    plt = _pyplot()
    fig = plt.figure(figsize=(18, 4))
    ax1 = fig.add_subplot(1, 5, 1, projection="3d")
    plot_cloud(ax1, x, y, title="ground truth")
    ax2 = fig.add_subplot(1, 5, 2, projection="3d")
    sub = f" (k={int(k)}, iou={float(score):.3f})" if k is not None else ""
    plot_cloud(ax2, x, y_pred, title="prediction" + sub)
    ax3 = fig.add_subplot(1, 5, 3)
    eh = np.asarray(emb_hidden)
    if eh.shape[1] == 2:
        h2 = eh
    elif embedding_method == "tsne":
        from sklearn.manifold import TSNE

        h2 = TSNE(2, init="pca", verbose=0).fit_transform(np.asarray(eh, np.float64))
    else:
        h2 = _pca2(eh)
    ax3.scatter(h2[:, 0], h2[:, 1], c=_colors(y), s=4)
    ax3.set_title(f"euclidean embedding ({embedding_method.upper()})")
    ax4 = fig.add_subplot(1, 5, 4)
    plot_poincare_disk(ax4, emb_poincare, y)
    ax5 = fig.add_subplot(1, 5, 5)
    plot_dendrogram(ax5, linkage_matrix)
    fig.tight_layout()
    if screenshot:
        fig.savefig(screenshot, dpi=110)
    if not show:
        plt.close(fig)
    return fig


def plot_clustering(ax, X, y, idx=None, eps=1e-1):
    """2-D scatter of a clustering: points colored by cluster, square
    markers at `idx` when given."""
    X = np.asarray(X)
    y = np.asarray(y)
    c = _colors(y)
    ax.scatter(X[:, 0], X[:, 1], s=15, linewidths=1.5, c=c,
               edgecolors=c, alpha=0.9)
    if idx is not None:
        idx = np.asarray(idx)
        ax.scatter(X[idx, 0], X[idx, 1], s=30,
                   c=[c[i] for i in np.atleast_1d(idx)],
                   marker="s", edgecolors="k")
    ax.set_xlim(X[:, 0].min() - eps, X[:, 0].max() + eps)
    ax.set_ylim(X[:, 1].min() - eps, X[:, 1].max() + eps)


def plot_graph(ax, x, edge_index, edge_col, colorbar=True):
    """2-D point graph with edges colored by `edge_col` in [0, 1] (a
    LineCollection under white nodes).

    x: [N, 2] positions; edge_index: [2, E] int endpoints; edge_col: [E].
    """
    require_matplotlib()
    from matplotlib.collections import LineCollection

    x = np.asarray(x)
    e = np.asarray(edge_index)
    edge_col = np.asarray(edge_col)
    segments = np.stack([x[e[0]], x[e[1]]], axis=1)
    lc = LineCollection(segments, zorder=0)
    lc.set_array(edge_col)
    lc.set_clim(vmin=0.0, vmax=1.0)
    ax.set_xticks(())
    ax.set_yticks(())
    ax.set_xlim(segments[:, :, 0].min(), segments[:, :, 0].max())
    ax.set_ylim(segments[:, :, 1].min(), segments[:, :, 1].max())
    ax.add_collection(lc)
    if colorbar:
        cb = ax.figure.colorbar(lc, ax=ax)
        cb.set_label("Edge Label")
    ax.set_aspect("equal")
    ax.scatter(x[:, 0], x[:, 1], s=20, c="w", edgecolors="k")
    return lc


def plot_confusion_matrix(cm, classes, normalize=False,
                          title="Confusion matrix", cmap="Blues",
                          figsize=(8, 8), savefig=""):
    """Annotated confusion-matrix heatmap; normalize=True makes each row sum
    to 1.  Returns the figure; saves it to `savefig` when given."""
    plt = _pyplot()
    cm = np.asarray(cm)
    if normalize:
        rows = cm.sum(axis=1, keepdims=True).astype(np.float64)
        cm_plot = np.divide(cm, rows, out=np.zeros(cm.shape, np.float64),
                            where=rows > 0)
    else:
        cm_plot = cm
    fig, ax = plt.subplots(figsize=figsize)
    im = ax.imshow(cm_plot, interpolation="nearest", cmap=cmap)
    ax.grid(False)
    ax.set_title(title)
    ticks = np.arange(len(classes))
    ax.set_xticks(ticks)
    ax.set_xticklabels(classes, rotation=45)
    ax.set_yticks(ticks)
    ax.set_yticklabels(classes)
    fmt = ".2f" if normalize else "d"
    thresh = 0.5 if normalize else (cm_plot.max() / 2 if cm_plot.size else 0)
    for i in range(cm_plot.shape[0]):
        for j in range(cm_plot.shape[1]):
            ax.text(j, i, format(cm_plot[i, j], fmt),
                    horizontalalignment="center",
                    color="white" if cm_plot[i, j] > thresh else "black")
    ax.set_ylabel("True label")
    ax.set_xlabel("Predicted label")
    fig.colorbar(im, ax=ax, fraction=0.046, pad=0.04)
    fig.tight_layout()
    if savefig:
        fig.savefig(savefig, dpi=90)
    return fig


def plot_precision_recall_curve(precision, recall, figsize=(12, 12),
                                xlim=None, ylim=None, title="", savefig=""):
    """Step-style precision-recall curve.  Returns the figure; saves it to
    `savefig` when given."""
    plt = _pyplot()
    title = title or "Precision-Recall curve"
    xlim = xlim or [0.75, 1.0]
    ylim = ylim or [0.75, 1.0]
    fig, ax = plt.subplots(figsize=figsize)
    ax.step(recall, precision, linewidth=2, color="tab:blue", where="post")
    ax.set_xlabel("Recall", fontsize=22)
    ax.set_ylabel("Precision", fontsize=22)
    ax.set_xlim(xlim)
    ax.set_ylim(ylim)
    ax.set_title(title, fontsize=24)
    fig.tight_layout()
    if savefig:
        fig.savefig(savefig, dpi=90)
    return fig


def get_linkage(model, **kwargs):
    """scipy linkage matrix from a fitted sklearn AgglomerativeClustering
    model (fitted with `compute_distances=True`), as a one-element list
    [Z].  The leaf count under each merge comes from one bottom-up pass:
    children rows only name earlier rows."""
    children = np.asarray(model.children_)
    n_samples = len(model.labels_)
    counts = np.zeros(children.shape[0])
    for i, (a, b) in enumerate(children):
        counts[i] = (1 if a < n_samples else counts[a - n_samples]) + (
            1 if b < n_samples else counts[b - n_samples])
    Z = np.column_stack([children, np.asarray(model.distances_), counts]
                        ).astype(float)
    return [Z]
