"""k-nearest-neighbour graphs and neighbour gathers.

`knn` is the dispatching wrapper: a CPU tensor goes to `knn_plain`, a CUDA
tensor to one of two hand-written kernels in `csrc/knn.cu`, chosen by shape:
`knn_kernel` (kernel B1) for D <= 64, k <= 32 and N <= 4096, and
`knn_wide_kernel` for every other shape, up to N + D = WIDE_MAX_FLOATS.  All
rank by the exact fp32 score 2 x_i.x_j - |x_j|^2 (the row's own -|x_i|^2
cannot change the order), include the point itself, return nearest first,
and break ties toward the smallest index.

x may be float32 or bfloat16.  bf16 features are ranked by their fp32
values (bf16 to fp32 is exact), as the TPU kernel upcasts them: B1 reads
bf16 in the kernel and converts each value on load, so its bf16 route is
its fp32 route on x.float(), bit for bit; the wide route, which no
configuration takes, gets x.float() from the wrapper.
"""
import ctypes

import torch

from . import _build

MAX_D = 64
MAX_K = 32
MAX_N = 4096
# the wide kernel keeps a row's N scores and the row's D values in shared memory
WIDE_MAX_FLOATS = 192 * 1024 // 4 - 16
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p]


def knn_scores(x):
    """Ranking scores [B, N, N] fp32, 2 x_i.x_j - |x_j|^2, of x [B, N, D]."""
    x = x.float()
    return 2.0 * torch.bmm(x, x.transpose(1, 2)) - torch.sum(x * x, dim=-1)[:, None, :]


def knn_plain(x, k):
    """Indices [B, N, k] (int32) of the k nearest neighbours of each point.

    x: [B, N, D], ranked by the scores of its fp32 values (knn_scores).  A stable descending sort keeps tied scores in index order,
    so ties go to the smallest index (torch.topk does not promise that).
    """
    order = torch.sort(knn_scores(x), dim=-1, descending=True, stable=True).indices
    return order[..., :k].to(torch.int32).contiguous()


def _check_input(x, what):
    if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"{what} takes a contiguous float32 or bfloat16 [B, N, D] tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")


def _launch(symbol, x, k):
    B, N, D = x.shape
    idx = torch.empty((B, N, k), dtype=torch.int32, device=x.device)
    if B == 0:
        return idx
    fn = _build.function("knn", symbol, _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), idx.data_ptr(), B, N, D, k, _build.stream_of(x))
    _build.check(err, symbol)
    knn.launches += 1
    return idx


def _knn_cuda(x, k):
    _check_input(x, "knn kernel")
    B, N, D = x.shape
    if not (1 <= D <= MAX_D and 1 <= k <= min(MAX_K, N) and N <= MAX_N):
        raise ValueError(f"knn kernel takes D <= {MAX_D}, k <= {MAX_K}, k <= N <= "
                         f"{MAX_N}; got D={D}, k={k}, N={N}")
    if x.dtype == torch.bfloat16:
        idx = _launch("hpcs_knn_bf16", x, k)
        if B:
            knn.bf16_launches += 1
        return idx
    return _launch("hpcs_knn", x, k)


def _knn_wide_cuda(x, k):
    _check_input(x, "wide knn kernel")
    x = x.float()  # the wide route reads fp32: bf16 features are upcast here
    B, N, D = x.shape
    if not (D >= 1 and 1 <= k <= N and N + D <= WIDE_MAX_FLOATS):
        raise ValueError(f"wide knn kernel keeps a row's N scores and D values in 192 KiB of "
                         f"shared memory: it takes k <= N and N + D <= {WIDE_MAX_FLOATS}; "
                         f"got D={D}, k={k}, N={N}")
    idx = _launch("hpcs_knn_wide", x, k)
    if B:
        knn.wide_launches += 1
    return idx


def knn(x, k):
    """k nearest neighbours [B, N, k] int32 of x [B, N, D], self included.

    A CUDA tensor goes to kernel B1 where it takes the shape, else to the
    wide kernel; both count in `knn.launches`, the wide one also in
    `knn.wide_launches`, B1 on bf16 also in `knn.bf16_launches`.
    """
    if not x.is_cuda:
        return knn_plain(x, k)
    _, N, D = x.shape
    if D <= MAX_D and k <= MAX_K and N <= MAX_N:
        return _knn_cuda(x, k)
    return _knn_wide_cuda(x, k)


knn.launches = 0
knn.wide_launches = 0
knn.bf16_launches = 0


def gather_neighbors(x, idx):
    """x [B, N, ...], idx [B, N, K] -> neighbour features [B, N, K, ...]."""
    B, N = x.shape[:2]
    rows = idx.long() + (torch.arange(B, device=x.device) * N)[:, None, None]
    return x.reshape(B * N, *x.shape[2:])[rows]
