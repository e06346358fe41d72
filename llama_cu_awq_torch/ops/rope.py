"""Rotary position embedding, half-rotation (HF Llama) convention.

Matches the reference kernel (gpu_kernels.h:332-355): pair (i, i+hd/2)
rotates by angle pos * theta^(-2i/hd); fp32 trig; applied to all query
heads and the kv heads.
"""

import torch


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """positions: (...,) int -> cos, sin of shape (..., head_dim//2), f32."""
    half = head_dim // 2
    idx = torch.arange(0, half, dtype=torch.float32,
                       device=positions.device)
    freqs = 1.0 / (theta ** (idx * 2.0 / head_dim))
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               angles=None) -> torch.Tensor:
    """x: (..., T, n_heads, head_dim); positions broadcastable to (..., T).
    angles: rope_angles(positions, head_dim, theta) when the caller has
    them already (one forward rotates every layer at the same positions).

    Returns x with each head's (i, i+hd/2) pair rotated, same dtype.
    """
    head_dim = x.shape[-1]
    if angles is None:
        angles = rope_angles(positions, head_dim, theta)
    cos, sin = angles  # (..., T, hd/2)
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    xf = x.float()
    x0 = xf[..., : head_dim // 2]
    x1 = xf[..., head_dim // 2:]
    out = torch.cat([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1)
    return out.to(x.dtype)
