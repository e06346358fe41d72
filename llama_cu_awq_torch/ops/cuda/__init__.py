"""Hand-written CUDA kernels and their plain PyTorch versions.

Every wrapper dispatches on the device of its input: a CUDA tensor goes
to the kernel (or raises), a CPU tensor to the plain version. `plain=True`
asks for the plain version on any device; it is how a caller holds a
kernel against it. LAUNCHES counts, per kernel, the launches its wrapper
made, and VARIANT_LAUNCHES the same launches per "kernel/variant" (the
flags and shapes of the call); only count() touches them, and each
wrapper calls it once where it launches its kernel.
"""

from __future__ import annotations

import torch

LAUNCHES = {"int4_matmul_fused": 0, "int4_matmul": 0, "dense_gemv": 0,
            "attention_step": 0}
VARIANT_LAUNCHES: dict[str, int] = {}


def count(kernel: str, variant: str) -> None:
    LAUNCHES[kernel] += 1
    key = f"{kernel}/{variant}"
    VARIANT_LAUNCHES[key] = VARIANT_LAUNCHES.get(key, 0) + 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    VARIANT_LAUNCHES.clear()


def use_plain(x: torch.Tensor, plain: bool) -> bool:
    """True for the plain version: asked for, or the input lies on the
    CPU. A CUDA tensor otherwise goes to the kernel; anything else
    raises."""
    if plain or x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return False


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def check_tensor(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    require(t.device == device, f"{name} is on {t.device}, expected {device}")
    require(t.dtype == dtype, f"{name} has dtype {t.dtype}, expected {dtype}")
    require(tuple(t.shape) == tuple(shape),
            f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    require(t.is_contiguous(), f"{name} must be contiguous")


def stream_ptr() -> int:
    return torch.cuda.current_stream().cuda_stream
