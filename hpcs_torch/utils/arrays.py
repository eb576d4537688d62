"""Array utilities for confusion-matrix condensation and set distances, in
numpy on the host: the cartesian product, the min-min distance between two
point sets, subset indices, row normalisation and confusion matrices
condensed over groups of labels."""
import numpy as np


def cartesian_product(arrays):
    """Generalized cartesian product of a list of 1-D arrays -> [prod, la]."""
    la = len(arrays)
    dtype = np.result_type(*[np.asarray(a).dtype for a in arrays])
    arr = np.empty([len(a) for a in arrays] + [la], dtype=dtype)
    for i, a in enumerate(np.ix_(*arrays)):
        arr[..., i] = a
    return arr.reshape(-1, la)


def set_distance(array1, array2, return_amin=False):
    """Min-min distance between two point sets d(A, B) = min_x min_y |x - y|;
    with return_amin, also the indices (i, j) of the closest pair."""
    a1 = np.asarray(array1, np.float64)
    a2 = np.asarray(array2, np.float64)
    d2 = ((a1[:, None, :] - a2[None, :, :]) ** 2).sum(-1)
    if return_amin:
        i, j = divmod(d2.argmin(), len(a2))
        return float(np.sqrt(d2.min())), (int(i), int(j))
    return float(np.sqrt(d2.min()))


def subset_backprojection(bool_map):
    """Indices in X of each element of the subset A indicated by bool_map."""
    return np.where(np.asarray(bool_map))[0]


def mat_renorm_rows(M):
    """Row-normalize a matrix, leaving zero rows zero."""
    M = np.asarray(M, float)
    sr = M.sum(axis=1)[:, np.newaxis]
    return np.divide(M, sr, where=sr != 0.0, out=np.zeros_like(M))


def confusion_matrix(y_true, y_pred, labels):
    """Counts [L, L] of (true, predicted) pairs over `labels`, in their
    order; pairs with a label outside them are not counted (as
    sklearn.metrics.confusion_matrix with labels=)."""
    labels = list(labels)
    index = {v: i for i, v in enumerate(labels)}
    conf = np.zeros((len(labels), len(labels)), dtype=np.int64)
    for t, p in zip(np.asarray(y_true).tolist(), np.asarray(y_pred).tolist()):
        if t in index and p in index:
            conf[index[t], index[p]] += 1
    return conf


def get_confusion_matrix(y_true, y_pred, selected_ids):
    """(confusion matrix, row-normalized confusion matrix) over selected ids."""
    conf = confusion_matrix(y_true, y_pred, selected_ids)
    return conf, mat_renorm_rows(conf)


def condense_confusion_matrix(conf_mat, input_labels, condense_list):
    """Sum confusion-matrix blocks according to groups of labels.

    condense_list: list of label groups; output is [G, G] with entry (i, j)
    the summed confusion mass between group i and group j.
    """
    conf_mat = np.asarray(conf_mat)
    idx_groups = [[input_labels.index(el) for el in group] for group in condense_list]
    g = len(idx_groups)
    out = np.zeros((g, g), dtype=conf_mat.dtype)
    for i, gi in enumerate(idx_groups):
        for j, gj in enumerate(idx_groups):
            out[i, j] = conf_mat[np.ix_(gi, gj)].sum()
    kept = sorted(sum(idx_groups, []))
    assert out.sum() == conf_mat[np.ix_(kept, kept)].sum(), \
        "condensed matrix must preserve the total count of kept labels"
    return out
