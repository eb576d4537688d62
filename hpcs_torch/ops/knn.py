"""k-nearest-neighbour graphs and neighbour gathers.

`knn` is the dispatching wrapper: a CUDA tensor goes to the hand-written
kernel in `csrc/knn.cu`, a CPU tensor to `knn_plain`.  Both rank by the
exact fp32 score 2 x_i.x_j - |x_j|^2 (the row's own -|x_i|^2 cannot change
the order), include the point itself, return nearest first, and break ties
toward the smallest index.
"""
import ctypes

import torch

from . import _build

MAX_D = 64
MAX_K = 32
MAX_N = 4096


def knn_scores(x):
    """Ranking scores [B, N, N] fp32, 2 x_i.x_j - |x_j|^2, of x [B, N, D]."""
    x = x.float()
    return 2.0 * torch.bmm(x, x.transpose(1, 2)) - torch.sum(x * x, dim=-1)[:, None, :]


def knn_plain(x, k):
    """Indices [B, N, k] (int32) of the k nearest neighbours of each point.

    x: [B, N, D].  A stable descending sort keeps tied scores in index order,
    so ties go to the smallest index (torch.topk does not promise that).
    """
    order = torch.sort(knn_scores(x), dim=-1, descending=True, stable=True).indices
    return order[..., :k].to(torch.int32).contiguous()


def _knn_cuda(x, k):
    if x.dtype != torch.float32 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"knn kernel takes a contiguous float32 [B, N, D] tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    B, N, D = x.shape
    if not (1 <= D <= MAX_D and 1 <= k <= min(MAX_K, N) and N <= MAX_N):
        raise ValueError(f"knn kernel takes D <= {MAX_D}, k <= {MAX_K}, k <= N <= "
                         f"{MAX_N}; got D={D}, k={k}, N={N}")
    idx = torch.empty((B, N, k), dtype=torch.int32, device=x.device)
    if B == 0:
        return idx
    fn = _build.function("knn", "hpcs_knn", [ctypes.c_void_p, ctypes.c_void_p,
                                              ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                              ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), idx.data_ptr(), B, N, D, k, _build.stream_of(x))
    _build.check(err, "knn")
    knn.launches += 1
    return idx


def knn(x, k):
    """k nearest neighbours [B, N, k] int32 of x [B, N, D], self included."""
    if x.is_cuda:
        return _knn_cuda(x, k)
    return knn_plain(x, k)


knn.launches = 0


def gather_neighbors(x, idx):
    """x [B, N, ...], idx [B, N, K] -> neighbour features [B, N, K, ...]."""
    B, N = x.shape[:2]
    rows = idx.long() + (torch.arange(B, device=x.device) * N)[:, None, None]
    return x.reshape(B * N, *x.shape[2:])[rows]
