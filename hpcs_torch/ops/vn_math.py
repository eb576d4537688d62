"""Vector-neuron arithmetic shared by the VN layers and the EdgeConv stage.

Features use the channel-major layout [..., C, 3]: vector components last.
bf16 features follow the JAX package's rules (hpcs_tpu/nn/vn/layers.py):
channel mixes take the weight in the features' dtype and round their fp32
sums once; the gate and the norm math run in fp32 and round back.
"""
import torch

EPS = 1e-6
NEGATIVE_SLOPE = 0.2
BN_EPS = 1e-5


def upcast(t):
    """t in fp32 when it is bf16, else t itself (fp32 and float64 stay)."""
    return t.float() if t.dtype == torch.bfloat16 else t


def channel_mix(x, weight):
    """Apply an [out, in] mixing matrix over the channel axis of [..., in, 3].

    The weight is cast to x's dtype, as flax casts its kernel: bf16 features
    mix with the bf16-rounded weight, the products summed in fp32 and the
    result rounded to bf16 once."""
    return torch.einsum("...cv,dc->...dv", x, weight.to(x.dtype))


def vn_leaky_relu(p, d, negative_slope=NEGATIVE_SLOPE):
    """Direction-gated leaky ReLU: keep p where <p, d> >= 0, else remove its
    component along d, then blend with p by the slope.  bf16 inputs are
    gated in fp32 and the result rounded back to p's dtype."""
    pf, df = upcast(p), upcast(d)
    dotprod = torch.sum(pf * df, dim=-1, keepdim=True)
    d_norm_sq = torch.sum(df * df, dim=-1, keepdim=True)
    mask = (dotprod >= 0).to(pf.dtype)
    projected = pf - (dotprod / (d_norm_sq + EPS)) * df
    out = negative_slope * pf + (1 - negative_slope) * (mask * pf + (1 - mask) * projected)
    return out.to(p.dtype)
