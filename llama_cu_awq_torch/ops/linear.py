"""Matmul dispatch (the counterpart of llama_cu_awq_tpu/ops/linear.py).

`qmatmul` and `qmatmul_fused` run the w4-g128 kernels, `dense_matmul` the
lm_head GEMV. The caller fuses at the layout level (q|k|v and gate|up are
concatenated along n_out) and issues one matmul. A CUDA tensor reaches the
kernel, a CPU tensor the plain version; `plain=True` asks for the plain
version on the card too (how a whole forward is held against its plain
twin).
"""

from __future__ import annotations

import torch

from llama_cu_awq_torch.ops.cuda.dense_gemv import dense_gemv
from llama_cu_awq_torch.ops.cuda.int4_matmul import (int4_matmul,
                                                     int4_matmul_fused)
from llama_cu_awq_torch.quant.int8 import Int8Dense
from llama_cu_awq_torch.quant.qtensor import QTensor


def qmatmul(x: torch.Tensor, qt: QTensor, plain: bool = False):
    """x: (..., n_in) -> (..., n_out) f32. x is staged to bf16 (as the
    kernel takes it), the weight dequantizes as (q - z) * s in f32."""
    return int4_matmul(x, qt, plain=plain)


def qmatmul_fused(x: torch.Tensor, qt: QTensor, plain: bool = False, *,
                  prescale=None, silu_u=None, residual=None,
                  emit_ss_eps: float | None = None,
                  out_dtype=torch.bfloat16):
    """Fused layer-step matmul: optional rmsnorm-apply prologue
    (prescale = (ss, norm_w)), optional SwiGLU prologue (silu_u = up
    values), optional residual-add epilogue, optional rms-scale epilogue.
    Returns (out, ss'); ss' is None unless emit_ss_eps is given."""
    return int4_matmul_fused(x, qt, prescale=prescale, silu_u=silu_u,
                             residual=residual, emit_ss_eps=emit_ss_eps,
                             out_dtype=out_dtype, plain=plain)


def dense_matmul(x: torch.Tensor, w, plain: bool = False) -> torch.Tensor:
    """Dense matmul with f32 accumulation; w is (n_out, n_in) row-major
    like the reference's wcls, a bf16 tensor or an Int8Dense."""
    if isinstance(w, Int8Dense):
        return dense_gemv(x, w.w8, w.scale, plain=plain)
    return dense_gemv(x, w, plain=plain)
