"""Dense GEMV for the lm_head: out[m, v] = sum_d x[m, d] * w[v, d].

Counterpart of llama_cu_awq_tpu/ops/pallas/dense_gemv.py. w is the
row-major (vocab, dim) head, bf16, or int8 with a per-row f32 scale
applied to the accumulated sum (quant/int8.py). A CUDA call launches
`csrc/dense_gemm.cu` at every m: tensor-core tiles of 128 vocab rows by
up to 128 rows of x, each head byte read once per tile of rows (see its
header). It sums the exactly widened operands in f32, as
`dense_gemv_plain` does.
"""

from __future__ import annotations

import ctypes
import math

import torch

from llama_cu_awq_torch.ops.cuda import (_build, check_tensor, count,
                                         require, stream_ptr, use_plain)

GEMM_V_TILE = 128  # vocab rows of a tile (BV in csrc/dense_gemm.cu)
GEMM_N_TILES = (16, 32, 64, 128)  # the tile kernel's widths in rows of x
_P = ctypes.c_void_p
_I = ctypes.c_int
_GEMM_ARGS = [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]


def gemm_n_tile(m: int) -> int:
    """Rows of x a tile-kernel block takes: the narrowest width that covers
    m, else the widest (m > 128 takes several column tiles)."""
    return next((n for n in GEMM_N_TILES if n >= m), GEMM_N_TILES[-1])


def gemm_grid(m: int, v: int) -> tuple[int, int]:
    """The tile kernel's grid: (vocab tiles, column tiles); the last of
    each may be ragged (the kernel zero-fills its loads past v and m and
    skips those stores)."""
    return -(-v // GEMM_V_TILE), -(-m // gemm_n_tile(m))


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


def _launch(x2: torch.Tensor, w: torch.Tensor, scale):
    """One launch of the tile kernel on x2 (m, d) bf16; returns out (m, v)
    f32."""
    m, d = x2.shape
    v = w.shape[0]
    dev = x2.device
    int8 = scale is not None
    require(d % 16 == 0, f"the kernel needs dim % 16 == 0, got {d}")
    check_tensor(w, "w", torch.int8 if int8 else torch.bfloat16, (v, d), dev)
    if int8:
        scale = scale.reshape(v)
        check_tensor(scale, "scale", torch.float32, (v,), dev)
    require(x2.dtype == torch.bfloat16, "bad x")
    # unit element stride, and for the kernel's 16-byte copies 16-byte
    # aligned rows
    if not (x2.stride(1) == 1 and x2.stride(0) % 8 == 0
            and x2.data_ptr() % 16 == 0):
        x2 = x2.contiguous()
    out = torch.empty(m, v, dtype=torch.float32, device=dev)
    args = (x2.data_ptr(), x2.stride(0), w.data_ptr(),
            scale.data_ptr() if int8 else None, out.data_ptr(), m, d, v)
    fn = _build.function("dense_gemm", "dense_gemm", _GEMM_ARGS)
    rc = fn(*args, gemm_n_tile(m), *gemm_grid(m, v), stream_ptr())
    _build.check(rc, "dense_gemm", "dense_gemm")
    return out


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
    out = _launch(x.to(torch.bfloat16).reshape(m, d), w, scale)
    fmt = "int8" if scale is not None else "bf16"
    count("dense_gemv", f"{fmt}/m{m}/{v}x{d}")
    return out.reshape(*lead, v)
