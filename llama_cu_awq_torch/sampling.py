"""Sampling: greedy argmax, temperature + top-p (nucleus).

The counterpart of llama_cu_awq_tpu/sampling.py, with the reference
sampler's semantics (sampler.h:43-82, gpu_kernels.h:448-584):

- one xorshift64* coin is consumed per step, teacher-forced prompt steps
  included, so seeded runs shift the stream identically;
- temperature == 0 -> argmax (first maximal index);
- topp outside (0, 1): CDF inversion over the unsorted softmax with
  threshold = coin;
- topp in (0, 1): probabilities sorted descending (stable), threshold =
  coin * topp against the inclusive prefix sum, token = first crossing.

The xorshift RNG runs on the host; its coins reach the device as data.
"""

from __future__ import annotations

import torch

_M64 = (1 << 64) - 1


class XorshiftRNG:
    """xorshift64* generator, bit-exact with sampler.h:31-40."""

    def __init__(self, seed: int):
        self.state = seed & _M64

    def random_u32(self) -> int:
        s = self.state
        s ^= (s >> 12)
        s ^= (s << 25) & _M64
        s ^= (s >> 27)
        self.state = s
        return ((s * 0x2545F4914F6CDD1D) & _M64) >> 32

    def random_f32(self) -> float:
        return (self.random_u32() >> 8) / 16777216.0


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """Argmax sampling (argmax_kernel, gpu_kernels.h:448-493)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample_token(logits: torch.Tensor, coin: torch.Tensor,
                 temperature: float, topp: float) -> torch.Tensor:
    """logits: (..., vocab) f32; coin: (...,) in [0, 1). Returns int32."""
    if temperature == 0.0:
        return greedy(logits)
    probs = torch.softmax(logits / temperature, dim=-1)
    V = probs.shape[-1]
    if topp <= 0.0 or topp >= 1.0:
        cdf = torch.cumsum(probs, dim=-1)
        idx = (cdf < coin[..., None]).sum(dim=-1)
        return torch.clamp(idx, max=V - 1).to(torch.int32)
    _, order = torch.sort(-probs, dim=-1, stable=True)
    cdf = torch.cumsum(torch.gather(probs, -1, order), dim=-1)
    idx = (cdf < coin[..., None] * topp).sum(dim=-1, keepdim=True)
    idx = torch.clamp(idx, max=V - 1)
    return torch.gather(order, -1, idx)[..., 0].to(torch.int32)
