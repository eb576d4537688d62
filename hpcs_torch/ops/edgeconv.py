"""EdgeConv stages: graph features (vector, cross-product and scalar) and
VN-DGCNN's eval-mode fused stage.

`edgeconv_infer` is the dispatching wrapper: a CUDA tensor goes to the
hand-written kernel in `csrc/edgeconv.cu`, a CPU tensor to
`edgeconv_infer_plain`.  Weights are [out, in] as in torch's Linear; the
first conv's input is the edge feature [x_j - x_i || x_i], 2C channels.

The fused stage takes float32 or bfloat16 features.  On bf16 it is the
fp32 stage on x.float() with the channel mixes' weights rounded to bf16
(the folded BatchNorm stays fp32), its output rounded to bf16 once: the
TPU kernel computes in fp32 inside too.  The JAX package's XLA stage in
bf16 rounds at other points (the edge features, each mix), which the
kernel's conv1, split by linearity, has no place for.  Both routes take the
same fp32 weights: on bf16 the kernels round the mixes as they load them
(the two-conv stages' conv2 runs on the bf16 tensor cores, exactly, on
three bf16 limbs of its input), so the wrapper launches no cast.
"""
import ctypes

import torch

from ..utils.profiling import check_kernel, span
from . import _build
from .knn import gather_neighbors, knn
from .vn_math import BN_EPS, EPS, channel_mix, vn_leaky_relu

KERNEL_C_IN = (1, 21)
KERNEL_C_OUT = 21
WORKSPACE_ROW = 128  # floats per point in each of the kernel's two workspace arrays


def graph_feature_vn(x, k, idx=None, table=None):
    """Vector-neuron edge features [B, N, K, 2C, 3] of x [B, N, C, 3].

    Without `idx` the kNN graph is built on the features flattened to C*3
    scalars in channel-major order.  `table` [B, M, C, 3], when given, is
    what idx indexes and the neighbours come from (x's rows being centres
    only: the point-sharded stage's local rows against the gathered cloud).
    Returns (edge features, idx).
    """
    B, N, C, _ = x.shape
    if idx is None:
        idx = knn(x.reshape(B, N, C * 3).contiguous(), k)
    neighbors = gather_neighbors(x if table is None else table, idx)
    center = x[:, :, None].expand_as(neighbors)
    return torch.cat([neighbors - center, center], dim=-2), idx


def graph_feature_cross_vn(x, k, idx=None, table=None):
    """Vector-neuron edge features with cross products [B, N, K, 3C, 3] of
    x [B, N, C, 3]: [x_j - x_i || x_i || x_j x x_i].  The graph and `table`
    as in graph_feature_vn.  Returns (edge features, idx)."""
    B, N, C, _ = x.shape
    if idx is None:
        idx = knn(x.reshape(B, N, C * 3).contiguous(), k)
    neighbors = gather_neighbors(x if table is None else table, idx)
    center = x[:, :, None].expand_as(neighbors)
    cross = torch.linalg.cross(neighbors, center, dim=-1)
    return torch.cat([neighbors - center, center, cross], dim=-2), idx


def graph_feature_scalar(x, k, idx=None, table=None):
    """Scalar edge features [B, N, K, 2C] of x [B, N, C]: [x_j - x_i || x_i].
    Without `idx` the kNN graph is built on x; `table` as in
    graph_feature_vn.  Returns (edge features, idx)."""
    if idx is None:
        idx = knn(x.contiguous(), k)
    neighbors = gather_neighbors(x if table is None else table, idx)
    center = x[:, :, None].expand_as(neighbors)
    return torch.cat([neighbors - center, center], dim=-1), idx


def fold_bn(weight, bias, running_mean, running_var, eps=BN_EPS):
    """Collapse eval-mode BatchNorm to y = a x + b; returns [2, C] = (a, b)."""
    a = weight / torch.sqrt(running_var + eps)
    return torch.stack([a, bias - running_mean * a])


def _vn_llr_folded(e, W, Wd, ab):
    """VNLinearLeakyReLU on [R, C_in, 3] with BatchNorm folded to ab [2, C]."""
    p = channel_mix(e, W)
    norm = torch.sqrt(torch.sum(p * p, dim=-1) + EPS * EPS) + EPS
    p = p / norm[..., None] * (ab[0] * norm + ab[1])[..., None]
    return vn_leaky_relu(p, channel_mix(e, Wd))


def _bf16_rounded(*weights):
    """The channel mixes' weights rounded to bf16, in fp32 (None stays)."""
    return [None if w is None else w.to(torch.bfloat16).float().contiguous() for w in weights]


def _centre_rows(x, idx, rows):
    """(r0, r1) of the centres, checked against the table x [B, N, ...] and
    idx [B, r1 - r0, K] (rows None: every point)."""
    N = x.shape[1]
    r0, r1 = (0, N) if rows is None else (int(rows[0]), int(rows[1]))
    if (rows is not None and not 0 <= r0 < r1 <= N) or idx.shape[1] != r1 - r0:
        raise ValueError(f"edgeconv: rows {rows} is not a range of the table's {N} points "
                         f"with one idx row each (idx {tuple(idx.shape)})")
    return r0, r1


def edgeconv_infer_plain(x, idx, W1, Wd1, ab1, W2=None, Wd2=None, ab2=None, n_convs=2,
                         rows=None):
    """One eval-mode VN EdgeConv stage, mean-pooled over the K neighbours.

    x [B, N, C, 3], idx [B, N, K]; W1, Wd1 [C_mid, 2C]; W2, Wd2 [C_out, C_mid];
    ab* [2, C] folded BatchNorm.  Returns [B, N, C_out, 3] in x's dtype; bf16
    x is computed as x.float() with bf16-rounded W1, Wd1, W2, Wd2 and the
    output rounded to bf16.  With rows = (r0, r1) the centres are points
    r0 .. r1 - 1 of the table x, idx [B, r1 - r0, K] indexes all N, and
    the result is [B, r1 - r0, C_out, 3]: the whole stage's rows.
    """
    if x.dtype == torch.bfloat16:
        W1, Wd1, W2, Wd2 = _bf16_rounded(W1, Wd1, W2, Wd2)
        return edgeconv_infer_plain(x.float(), idx, W1, Wd1, ab1, W2, Wd2, ab2,
                                    n_convs, rows).to(torch.bfloat16)
    r0, r1 = _centre_rows(x, idx, rows)
    B, N, K = idx.shape
    e, _ = graph_feature_vn(x[:, r0:r1], K, idx, table=x)
    e = e.reshape(B * N * K, e.shape[-2], 3)
    h = _vn_llr_folded(e, W1, Wd1, ab1)
    if n_convs == 2:
        h = _vn_llr_folded(h, W2, Wd2, ab2)
    return h.reshape(B, N, K, -1, 3).mean(dim=2)


def _check(t, name, shape, dtype=torch.float32):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"edgeconv kernel: {name} must be contiguous {dtype} of shape "
                         f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)}")


def _edgeconv_cuda(x, idx, W1, Wd1, ab1, W2, Wd2, ab2, n_convs, rows=None):
    B, N, C, _ = x.shape
    K = idx.shape[-1]
    r0, r1 = _centre_rows(x, idx, rows)
    if C not in KERNEL_C_IN or n_convs not in (1, 2):
        raise ValueError(f"edgeconv kernel takes C_in in {KERNEL_C_IN} and n_convs in "
                         f"(1, 2), got C_in={C}, n_convs={n_convs}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"edgeconv kernel takes float32 or bfloat16 features, got {x.dtype}")
    _check(x, "x", (B, N, C, 3), x.dtype)
    _check(idx, "idx", (B, r1 - r0, K), torch.int32)
    bf16 = x.dtype == torch.bfloat16
    for t, name, shape in ((W1, "W1", (KERNEL_C_OUT, 2 * C)), (Wd1, "Wd1", (KERNEL_C_OUT, 2 * C)),
                           (ab1, "ab1", (2, KERNEL_C_OUT))):
        _check(t, name, shape)
    second = (W2, Wd2, ab2)
    if n_convs == 2:
        for t, name, shape in zip(second, ("W2", "Wd2", "ab2"),
                                  ((KERNEL_C_OUT, KERNEL_C_OUT),) * 2 + ((2, KERNEL_C_OUT),)):
            _check(t, name, shape)
    tensors = (x, idx, W1, Wd1, ab1) + (second if n_convs == 2 else ())
    if any(t.device != x.device for t in tensors):
        raise ValueError("edgeconv kernel: all tensors must be on one device")
    out = torch.empty((B, r1 - r0, KERNEL_C_OUT, 3), dtype=x.dtype, device=x.device)
    if B * (r1 - r0) == 0:
        return out
    # conv1's per-point products for C=21 (the kernel's projection): two
    # rows of WORKSPACE_ROW floats per point, read back from L2
    workspace = (torch.empty((2, B * N, WORKSPACE_ROW), dtype=torch.float32, device=x.device)
                 if C == 21 else None)
    ptr = ctypes.c_void_p
    symbol = "hpcs_edgeconv_bf16" if bf16 else "hpcs_edgeconv"
    fn = _build.function("edgeconv", symbol, [ptr] * 10 + [ctypes.c_int] * 7 + [ptr])
    w2_ptrs = [t.data_ptr() for t in second] if n_convs == 2 else [None] * 3
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), idx.data_ptr(), W1.data_ptr(), Wd1.data_ptr(), ab1.data_ptr(),
                 *w2_ptrs, out.data_ptr(), None if workspace is None else workspace.data_ptr(),
                 B, N, C, K, n_convs, r0, r1 - r0, _build.stream_of(x))
    _build.check(err, symbol)
    edgeconv_infer.launches += 1
    if bf16:
        edgeconv_infer.bf16_launches += 1
    if rows is not None:
        edgeconv_infer.row_launches += 1
    return out


def edgeconv_infer(x, idx, W1, Wd1, ab1, W2=None, Wd2=None, ab2=None, n_convs=2, rows=None):
    """Eval-mode VN EdgeConv stage (see edgeconv_infer_plain) on any device;
    with rows = (r0, r1) for the centres r0 .. r1 - 1 of the table x only.

    Every launch of the kernel counts in `edgeconv_infer.launches`, those on
    bf16 features also in `edgeconv_infer.bf16_launches`, those over a row
    range also in `edgeconv_infer.row_launches`.  The call is the span
    `edgeconv` (utils.profiling); under NaN debugging the kernel's output
    is checked."""
    with span("edgeconv"):
        if x.is_cuda:
            out = _edgeconv_cuda(x, idx, W1, Wd1, ab1, W2, Wd2, ab2, n_convs, rows)
            check_kernel("edgeconv (kernel B2)", out)
            return out
        return edgeconv_infer_plain(x, idx, W1, Wd1, ab1, W2, Wd2, ab2, n_convs, rows)


edgeconv_infer.launches = 0
edgeconv_infer.bf16_launches = 0
edgeconv_infer.row_launches = 0
