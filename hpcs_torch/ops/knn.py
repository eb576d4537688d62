"""k-nearest-neighbour graphs and neighbour gathers.

`knn` is the dispatching wrapper: a CPU tensor goes to `knn_plain`, a CUDA
tensor to hand-written kernels in `csrc/knn.cu`, chosen by shape.  Both
routes first run a prep kernel, which makes a padded fp32 copy of x and
|x_j|^2 in scratch the wrapper allocates; then kernel B1, `knn_kernel`, for
D <= 64, k <= 32 and N <= 4096, and the wide route for every other shape
(N <= WIDE_MAX_N, D <= WIDE_MAX_D, any k <= N): `knn_wide_kernel`, row tiles
with a streamed selection, for k <= WIDE_MAX_K, and for larger k the radix
route, `knn_keys_kernel` (the same score sweep, its scores stored as
order-preserving keys for a group of rows at a time) then
`knn_radix_kernel` (a radix select and a sort, one block a row).
Each takes a range of query rows (`rows`), ranked against every point: the
point-sharded forward's rows of the gathered cloud.  All rank by the exact
fp32 score 2 x_i.x_j - |x_j|^2 (the row's own -|x_i|^2 cannot change the
order), include the point itself, return nearest first, and break ties
toward the smallest index.

x may be float32 or bfloat16.  bf16 features are ranked by their fp32
values (bf16 to fp32 is exact), as the TPU kernel upcasts them: the prep
kernels read bf16 and convert each value on load, so each bf16 route is its
fp32 route on x.float(), bit for bit.
"""
import contextlib
import ctypes

import torch

from ..utils.profiling import check_kernel, nan_debugging_enabled, span, unchecked
from . import _build

MAX_D = 64
MAX_K = 32
MAX_N = 4096
# the wide route: int32 indices (with a tile's room past N), and a row's
# list of its best ceil(k / 32) 32 in shared memory up to WIDE_MAX_K; past
# it the radix route
WIDE_MAX_N = 1 << 30
WIDE_MAX_D = 1 << 20
WIDE_MAX_K = 256
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
# the routes' scratch at most (256 MiB; the radix route's keys take 128
# MiB of it); a larger batch goes through in groups of clouds
WORK_FLOATS = 1 << 26
_ENTRIES = {}  # the C entry points, bound at first use


def _work_floats(n, d):
    """The scratch per cloud, at least what hpcs_knn and hpcs_knn_wide
    take: the copy padded to a width of D rounded up to 4, 8 or 16, and the
    squared norms."""
    return n * (-(-d // 16) * 16 + 1)


def _row_range(rows, n):
    """(r0, r1) of `rows` (None: every row), checked against n points."""
    if rows is None:
        return 0, n
    r0, r1 = int(rows[0]), int(rows[1])
    if not 0 <= r0 < r1 <= n:
        raise ValueError(f"knn: rows {rows} is not a non-empty range of the {n} points")
    return r0, r1


def knn_scores(x, rows=None):
    """Ranking scores [B, r1 - r0, N] fp32, 2 x_i.x_j - |x_j|^2, of x
    [B, N, D] for query rows i in rows = (r0, r1) (None: all N)."""
    x = x.float()
    r0, r1 = _row_range(rows, x.shape[1])
    q = x[:, r0:r1]
    return 2.0 * torch.bmm(q, x.transpose(1, 2)) - torch.sum(x * x, dim=-1)[:, None, :]


def knn_plain(x, k, rows=None):
    """Indices [B, r1 - r0, k] (int32) of the k nearest of the N points of
    x [B, N, D] to each point of rows = (r0, r1) (None: all N); global
    indices, the point itself included.

    Ranked by the scores of x's fp32 values (knn_scores).  A stable
    descending sort keeps tied scores in index order, so ties go to the
    smallest index (torch.topk does not promise that).
    """
    order = torch.sort(knn_scores(x, rows), dim=-1, descending=True, stable=True).indices
    return order[..., :k].to(torch.int32).contiguous()


def _check_input(x, what):
    if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"{what} takes a contiguous float32 or bfloat16 [B, N, D] tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")


def _entry(symbol, argtypes=_ARGTYPES):
    fn = _ENTRIES.get(symbol)
    if fn is None:
        fn = _ENTRIES[symbol] = _build.function("knn", symbol, argtypes)
    return fn


def _radix_work(b, n, d, k, rows):
    """The floats of scratch the radix route takes for b clouds (knn.cu's
    hpcs_knn_wide_work: the prep's, then a group of rows' keys)."""
    out = ctypes.c_longlong()
    fn = _entry("hpcs_knn_wide_work", [ctypes.c_int] * 5 + [ctypes.c_void_p])
    _build.check(fn(b, n, d, k, rows, ctypes.addressof(out)), "hpcs_knn_wide_work")
    return out.value


def _launch(symbol, x, k, rows, radix=False):
    """idx [B, r1 - r0, k] from the C entry `symbol` (or its _bf16 twin) of
    csrc/knn.cu, in groups of clouds whose scratch fits WORK_FLOATS (with
    `radix`, the radix route's, from knn.cu), on the current stream; counts
    the launch in knn.launches and, where they apply, in row_launches and
    bf16_launches."""
    B, N, D = x.shape
    r0, r1 = _row_range(rows, N)
    idx = torch.empty((B, r1 - r0, k), dtype=torch.int32, device=x.device)
    if B == 0:
        return idx
    if x.dtype == torch.bfloat16:
        symbol += "_bf16"
    fn = _entry(symbol)
    if radix:
        group = B  # halved until the scratch fits
        while group > 1 and _radix_work(group, N, D, k, r1 - r0) > WORK_FLOATS:
            group = (group + 1) // 2
        # (a smaller last group may get a row more a cloud: the larger scratch)
        floats = max(_radix_work(g, N, D, k, r1 - r0) for g in {group, B % group or group})
    else:
        group = max(1, min(B, WORK_FLOATS // _work_floats(N, D)))
        floats = group * _work_floats(N, D)
    work = torch.empty(floats, dtype=torch.float32, device=x.device)
    current = x.device.index == torch.cuda.current_device()
    with contextlib.nullcontext() if current else torch.cuda.device(x.device):
        # the current stream's raw handle (torch.cuda.current_stream(...)
        # would build a Stream object a call, on a path whose host time is
        # close to the D = 3 launch's device time)
        stream = torch._C._cuda_getCurrentRawStream(x.device.index)
        for b0 in range(0, B, group):
            b1 = min(B, b0 + group)
            err = fn(x[b0].data_ptr() if b0 else x.data_ptr(),
                     idx[b0].data_ptr() if b0 else idx.data_ptr(), work.data_ptr(), b1 - b0, N,
                     D, k, r0, r1 - r0, stream)
            _build.check(err, symbol)
    knn.launches += 1
    if rows is not None:
        knn.row_launches += 1
    if x.dtype == torch.bfloat16:
        knn.bf16_launches += 1
    return idx


def _knn_cuda(x, k, rows=None):
    _check_input(x, "knn kernel")
    B, N, D = x.shape
    if not (1 <= D <= MAX_D and 1 <= k <= min(MAX_K, N) and N <= MAX_N):
        raise ValueError(f"knn kernel takes D <= {MAX_D}, k <= {MAX_K}, k <= N <= "
                         f"{MAX_N}; got D={D}, k={k}, N={N}")
    return _launch("hpcs_knn", x, k, rows)


def _knn_wide_cuda(x, k, rows=None):
    _check_input(x, "wide knn kernel")
    B, N, D = x.shape
    if not (1 <= D <= WIDE_MAX_D and 1 <= k <= N <= WIDE_MAX_N):
        raise ValueError(f"wide knn kernel takes k <= N <= {WIDE_MAX_N} and D <= "
                         f"{WIDE_MAX_D}; got D={D}, k={k}, N={N}")
    idx = _launch("hpcs_knn_wide", x, k, rows, radix=k > WIDE_MAX_K)
    if B:
        knn.wide_launches += 1
        if k > WIDE_MAX_K:
            knn.radix_launches += 1
    return idx


def knn(x, k, rows=None):
    """k nearest neighbours [B, r1 - r0, k] int32 among the N points of
    x [B, N, D] for query rows = (r0, r1) (None: all N, [B, N, k]), self
    included; global indices, equal to knn(x, k)[:, r0:r1].

    A CUDA tensor goes to kernel B1 where it takes the shape, else to the
    wide route; both count in `knn.launches`, the wide route also in
    `knn.wide_launches` (its radix route, k > WIDE_MAX_K, also in
    `knn.radix_launches`), a launch on bf16 also in `knn.bf16_launches`,
    a launch over a row range also in `knn.row_launches`.  The call is the span
    `knn` (utils.profiling).  Under NaN debugging a CUDA call first checks
    its rows' scores: a NaN score leaves the selection undefined, and the
    kernel's indices cannot show it.
    """
    with span("knn"):
        if not x.is_cuda:
            return knn_plain(x, k, rows)
        if nan_debugging_enabled():
            with unchecked():
                for b in range(x.shape[0]):
                    check_kernel("knn (kernel B1), its input's scores",
                                 knn_scores(x[b:b + 1], rows))
        _, N, D = x.shape
        if D <= MAX_D and k <= MAX_K and N <= MAX_N:
            return _knn_cuda(x, k, rows)
        return _knn_wide_cuda(x, k, rows)


knn.launches = 0
knn.wide_launches = 0
knn.radix_launches = 0
knn.bf16_launches = 0
knn.row_launches = 0

# the JAX package's dispatching name: here the same function, B1's routes
knn_auto = knn


def pairwise_neg_sqdist(x, y=None):
    """Negative squared distances [B, N, M] fp32 between x [B, N, D] and
    y [B, M, D] (None: x): 2 x.y - |x|^2 - |y|^2."""
    x = x.float()
    y = x if y is None else y.float()
    x2, y2 = torch.sum(x * x, dim=-1), torch.sum(y * y, dim=-1)
    return 2.0 * torch.bmm(x, y.transpose(1, 2)) - x2[..., :, None] - y2[..., None, :]


def gather_neighbors(x, idx):
    """x [B, N, ...], idx [B, N, K] -> neighbour features [B, N, K, ...]."""
    B, N = x.shape[:2]
    rows = idx.long() + (torch.arange(B, device=x.device) * N)[:, None, None]
    return x.reshape(B * N, *x.shape[2:])[rows]
