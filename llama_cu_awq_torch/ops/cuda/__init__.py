"""Hand-written CUDA kernels and their plain PyTorch versions.

Every wrapper dispatches on the device of its input: a CUDA tensor goes
to the kernel (or raises), a CPU tensor to the plain version. `plain=True`
asks for the plain version on any device; it is how a caller holds a
kernel against it. LAUNCHES counts, per kernel, the launches its wrapper
made, and VARIANT_LAUNCHES the same launches per "kernel/variant" (the
flags and shapes of the call); only count() and add_launches() touch
them. Each wrapper calls count() once where it launches its kernel;
add_launches() adds back the launches a CUDA graph replays
(engine/graphs.py), which the wrappers counted once, while it was
captured.
"""

from __future__ import annotations

import math

import torch

LAUNCHES = {"int4_matmul_fused": 0, "int4_matmul": 0, "dense_gemv": 0,
            "attention_step": 0, "attention_step_kv4": 0,
            "prefill_attention": 0, "batched_decode_attention": 0,
            "down_qkv": 0, "ffn_chain": 0, "mono_layer": 0}
VARIANT_LAUNCHES: dict[str, int] = {}


def count(kernel: str, variant: str) -> None:
    LAUNCHES[kernel] += 1
    key = f"{kernel}/{variant}"
    VARIANT_LAUNCHES[key] = VARIANT_LAUNCHES.get(key, 0) + 1


def add_launches(kernels: dict[str, int], variants: dict[str, int]) -> None:
    """Add per-kernel and per-variant launch counts (negative ones take
    them back)."""
    for k, n in kernels.items():
        LAUNCHES[k] += n
    for key, n in variants.items():
        VARIANT_LAUNCHES[key] = VARIANT_LAUNCHES.get(key, 0) + n
        if VARIANT_LAUNCHES[key] == 0:
            del VARIANT_LAUNCHES[key]


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


def attn_scale(head_dim: int) -> float:
    """f32(1/sqrt(D)), as the JAX kernels' Python float meets f32 scores."""
    return float(torch.tensor(1.0 / math.sqrt(head_dim),
                              dtype=torch.float32))


def stream_ptr() -> int:
    return torch.cuda.current_stream().cuda_stream


# activation types (--act-dtype) as the kernels take them at run time:
# DT_F32, DT_BF16 and DT_F16 in csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_SHORT = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16"}


def dtype_code(dtype, name: str) -> int:
    """The kernels' code of an activation type; raises on any other."""
    require(dtype in DTYPE_CODES,
            f"{name} has dtype {dtype}, expected bfloat16, float16 or "
            f"float32")
    return DTYPE_CODES[dtype]


def dtype_name(dtype) -> str:
    """Short name of an activation type in variant keys (bf16, f16,
    f32)."""
    return _SHORT[dtype]
