"""QTensor: a packed w4-g128 weight in the GPU layout.

The layout is the `.bin` file's own, minus its alignment padding, which is
what the reference's CUDA GEMV reads (gpu_kernels.h:171-210):

  qw:     int32   (n_out, ceil(n_in/8)) -- the 8 input rows 8y..8y+7 of
          output column x sit in word [x, y], nibble i = row 8y+i
          (sequential order, not AWQ's interleaved order). Input rows are
          contiguous per output column: a 128-row group is 64 contiguous
          bytes, which one quad of lanes loads (csrc/int4_gemv.cuh).
  scales: float16 (n_out, ceil(n_in/128)) -- exact: the file stores fp16.
  zeros:  uint8   (n_out, ceil(n_in/128)).

The JAX package's TPU kernel keeps its scales in bf16 (its
packing.build_meta), up to 2^-8 relative off; this layout keeps them
exact, so the port's oracle is the JAX dequant path.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from llama_cu_awq_torch.config import GROUP_SIZE
from llama_cu_awq_torch.quant import packing


@dataclasses.dataclass
class QTensor:
    """Packed 4-bit weight of logical shape (n_in, n_out); out = x @ W."""

    qw: torch.Tensor      # int32 (n_out, ceil(n_in/8))
    scales: torch.Tensor  # float16 (n_out, G)
    zeros: torch.Tensor   # uint8 (n_out, G)
    n_in: int
    n_out: int

    @property
    def shape(self):
        return (self.n_in, self.n_out)

    @property
    def n_groups(self) -> int:
        return packing.div_up(self.n_in, GROUP_SIZE)

    @property
    def device(self) -> torch.device:
        return self.qw.device

    @classmethod
    def from_numpy(cls, qw: np.ndarray, zeros: np.ndarray,
                   scales: np.ndarray, n_in: int,
                   device: str | torch.device = "cpu") -> "QTensor":
        """From the in-memory NumPy layout: qw uint32 (ceil(n_in/8), n_out),
        zeros int (g, n_out), scales float (g, n_out) holding fp16 values."""
        qw_t = np.ascontiguousarray(np.asarray(qw, np.uint32).T).view(
            np.int32)
        s = np.asarray(scales, np.float32)
        s16 = s.astype(np.float16)
        if not np.array_equal(s16.astype(np.float32), s):
            raise ValueError("scales are not fp16-representable")
        return cls(
            torch.from_numpy(qw_t).to(device),
            torch.from_numpy(np.ascontiguousarray(s16.T)).to(device),
            torch.from_numpy(np.ascontiguousarray(
                np.asarray(zeros).astype(np.uint8).T)).to(device),
            n_in, qw_t.shape[0])

    @classmethod
    def quantize(cls, w: np.ndarray,
                 device: str | torch.device = "cpu") -> "QTensor":
        """Quantize a dense (n_in, n_out) f32 weight (tests, w4 lm_head)."""
        qw, zeros, scales = packing.quantize_np(np.asarray(w, np.float32))
        return cls.from_numpy(qw, zeros, scales, w.shape[0], device)

    def dequantize_t(self) -> torch.Tensor:
        """Dense (n_out, n_in) f32 weight; (q - z) * s per element, exact."""
        nw = self.qw.shape[1]
        shifts = 4 * torch.arange(8, device=self.qw.device,
                                  dtype=torch.int32)
        q = (self.qw[:, :, None] >> shifts) & 0xF  # (n_out, nw, 8)
        q = q.reshape(self.n_out, nw * 8)[:, : self.n_in].float()
        gidx = torch.arange(self.n_in, device=self.qw.device) // GROUP_SIZE
        z = self.zeros.float()[:, gidx]
        s = self.scales.float()[:, gidx]
        return (q - z) * s

    def dequantize(self) -> torch.Tensor:
        """Dense (n_in, n_out) f32 weight (the plain oracle)."""
        return self.dequantize_t().T

