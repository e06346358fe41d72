"""Dense GEMV for the lm_head: out[m, v] = sum_d x[m, d] * w[v, d].

Counterpart of llama_cu_awq_tpu/ops/pallas/dense_gemv.py. w is the
row-major (vocab, dim) head, bf16, or int8 with a per-row f32 scale
applied to the accumulated sum (quant/int8.py). The kernel is
`csrc/dense_gemv.cu` (one warp per vocab row, see its header).
"""

from __future__ import annotations

import ctypes
import math

import torch

from llama_cu_awq_torch.ops.cuda import (_build, check_tensor, count,
                                         require, stream_ptr, use_plain)

_SMEM_BUDGET = 200 * 1024
_MAX_ROWS = 8  # matches MAX_ROWS in csrc/dense_gemv.cu
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = [_P, _I, _P, _P, _P, _I, _I, _I, _I, _P]


def rows_per_pass(m: int, d: int, int8: bool) -> int:
    e = 16 if int8 else 8
    per_row = (d // e) * (e + 2) * 2  # padded bf16 staging
    return max(1, min(m, _MAX_ROWS, _SMEM_BUDGET // per_row))


def dense_gemv_plain(x: torch.Tensor, w: torch.Tensor,
                     scale: torch.Tensor | None = None) -> torch.Tensor:
    """x staged to the head's float dtype (bf16 for int8 codes), operands
    widened exactly to f32, f32 sums; the int8 per-row scale multiplies
    the accumulated sum."""
    lead = tuple(x.shape[:-1])
    stage = w.dtype if w.is_floating_point() else torch.bfloat16
    xb = x.reshape(-1, x.shape[-1]).to(stage).float()
    out = xb @ w.float().T
    if scale is not None:
        out = out * scale.reshape(1, -1).float()
    return out.reshape(*lead, w.shape[0])


def dense_gemv(x: torch.Tensor, w: torch.Tensor,
               scale: torch.Tensor | None = None, *,
               plain: bool = False) -> torch.Tensor:
    """x: (..., d) -> (..., v) f32; w: (v, d) bf16, or int8 with scale
    (v, 1) or (v,) f32."""
    if use_plain(x, plain):
        return dense_gemv_plain(x, w, scale)
    v, d = w.shape
    lead = tuple(x.shape[:-1])
    m = math.prod(lead)
    dev = x.device
    int8 = scale is not None
    require(d % 16 == 0, f"the kernel needs dim % 16 == 0, got {d}")
    check_tensor(w, "w", torch.int8 if int8 else torch.bfloat16, (v, d), dev)
    if int8:
        scale = scale.reshape(v)
        check_tensor(scale, "scale", torch.float32, (v,), dev)
    x2 = x.to(torch.bfloat16).reshape(m, d)
    if x2.stride(1) != 1:
        x2 = x2.contiguous()
    out = torch.empty(m, v, dtype=torch.float32, device=dev)
    fn = _build.function("dense_gemv", "dense_gemv", _ARGS)
    rc = fn(x2.data_ptr(), x2.stride(0), w.data_ptr(),
            scale.data_ptr() if int8 else None, out.data_ptr(), m, d, v,
            rows_per_pass(m, d, int8), stream_ptr())
    _build.check(rc, "dense_gemv", "dense_gemv")
    count("dense_gemv", f"{'int8' if int8 else 'bf16'}/m{m}/{v}x{d}")
    return out.reshape(*lead, v)
