"""KV-cache quantization: per-vector int8, and int4 packed two to a byte.

The counterpart of quantize_kv, quantize_kv4, _unpack_kv4 and dequant_kv4
in llama_cu_awq_tpu/models/llama.py. Scales are symmetric per (position,
head): absmax * f32(1/127) for int8 and absmax * f32(1/7) for int4, with a
floor of 1e-10. Inside a jit, XLA rewrites the JAX package's division by
the constant into that product, so the jitted forward's scales and those
of its attention_step kernel are it; torch.round rounds half to even, as
jnp.round. The input is any float type (the activation type under
--act-dtype); it is widened to f32 first, as the JAX functions do.

int4 codes are clipped to [-7, 7] and packed in HALVES: byte i of a head
holds lane i in its low nibble and lane i + D/2 in its high nibble, both
signed two's complement. A nibble is read back with the sign rule
((c & 0xF) ^ 8) - 8 on an int32, never by shifting int8 values left.
"""

from __future__ import annotations

import torch

INV_127 = 1.0 / 127.0
INV_7 = 1.0 / 7.0


def quantize_kv(x: torch.Tensor):
    """(..., D) float -> (int8 codes (..., D), f32 scales (...))."""
    xf = x.float()
    s = torch.clamp(xf.abs().amax(dim=-1) * INV_127, min=1e-10)
    q = torch.round(xf / s[..., None]).to(torch.int8)
    return q, s


def quantize_kv4(x: torch.Tensor):
    """(..., D) float -> (int8 packed codes (..., D//2), f32 scales (...))."""
    xf = x.float()
    s = torch.clamp(xf.abs().amax(dim=-1) * INV_7, min=1e-10)
    q = torch.clamp(torch.round(xf / s[..., None]), -7, 7).to(torch.int32)
    d2 = q.shape[-1] // 2
    packed = (q[..., :d2] & 0xF) | ((q[..., d2:] & 0xF) << 4)
    return packed.to(torch.uint8).view(torch.int8), s


def kv4_planes(codes: torch.Tensor):
    """Packed (..., D//2) int8 -> the signed (lo, hi) nibble planes as
    int32: lanes 0..D/2-1 and D/2..D-1."""
    c = codes.to(torch.int32)
    return ((c & 0xF) ^ 8) - 8, (((c >> 4) & 0xF) ^ 8) - 8


def kv4_values(codes: torch.Tensor) -> torch.Tensor:
    """Packed (..., D//2) int8 -> the (..., D) codes as f32, unscaled."""
    return torch.cat(kv4_planes(codes), dim=-1).float()


def unpack_kv4(codes: torch.Tensor, scales: torch.Tensor, dtype):
    """(..., H, D//2) codes and (..., H) scales -> the (lo, hi) halves of
    shape (..., H, D//2) in dtype, each code times its scale in dtype."""
    sc = scales[..., None].to(dtype)
    lo, hi = kv4_planes(codes)
    return lo.to(dtype) * sc, hi.to(dtype) * sc


def dequant_kv4(codes: torch.Tensor, scales: torch.Tensor,
                dtype) -> torch.Tensor:
    """The halves of unpack_kv4 put back together: (..., H, D) in dtype."""
    return torch.cat(unpack_kv4(codes, scales, dtype), dim=-1)
