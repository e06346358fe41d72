"""RMSNorm (reference: gpu_kernels.h:72-105).

fp32 accumulation, eps 1e-5 added to the mean of squares, scale by the
elementwise weight, output cast back to the activation dtype.
"""

import torch

RMS_EPS = 1e-5


def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float = RMS_EPS) -> torch.Tensor:
    """x: (..., dim); weight: (dim,). Returns the dtype of x."""
    xf = x.float()
    ms = (xf * xf).mean(dim=-1, keepdim=True) + eps
    out = xf * torch.rsqrt(ms) * weight.float()
    return out.to(x.dtype)
