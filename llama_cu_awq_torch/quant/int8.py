"""Per-output-row symmetric int8 weights for the dense lm_head
(the counterpart of llama_cu_awq_tpu/quant/int8.py).

Opt-in: the lm_head is the one unquantized weight read per token
(262 MB at 7B in bf16). Per-row int8 (scale = amax/127) halves that read;
the scale is applied to the GEMV's accumulator.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Int8Dense:
    """Row-major (n_out, n_in) int8 codes + per-row f32 scales;
    logically w[v, d] = w8[v, d] * scale[v, 0]."""

    w8: torch.Tensor     # (n_out, n_in) int8
    scale: torch.Tensor  # (n_out, 1) f32

    @property
    def shape(self):
        return tuple(self.w8.shape)

    @property
    def dtype(self):
        # activation staging dtype for the GEMV's x operand
        return torch.bfloat16

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        return (self.w8.float() * self.scale).to(dtype)


def quantize_dense_int8(w: torch.Tensor) -> Int8Dense:
    """w: (n_out, n_in) float -> Int8Dense. |w - q*s| <= s/2 per element.
    torch.round rounds half to even, as jnp.round does."""
    wf = w.float()
    s = torch.clamp(wf.abs().amax(dim=1, keepdim=True) / 127.0, min=1e-12)
    q = torch.round(wf / s).to(torch.int8)
    return Int8Dense(q, s)
