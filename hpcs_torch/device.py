"""Device selection for the port's entry points."""
import torch


def resolve_device(device=None):
    """The device an entry point runs on: CUDA unless `device` names another.

    With no GPU and no explicit device this raises instead of carrying on on
    the CPU.  It also turns TF32 off for matmuls and cuDNN: TF32-rounded kNN
    scores flip neighbours under rotation, so the port stays in full fp32.
    And bf16 matmuls sum in fp32 only (no bf16 reductions inside cuBLAS), as
    the JAX package asks with preferred_element_type=float32.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device
