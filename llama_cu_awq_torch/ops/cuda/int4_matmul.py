"""w4-g128 dequant matmul: `int4_matmul` and `int4_matmul_fused`.

Counterparts of llama_cu_awq_tpu/ops/pallas/int4_matmul.py. Both launch
`csrc/int4_gemv.cu` (one warp per output column, see its header);
`int4_matmul_fused` adds a prologue on x and an epilogue on the output:

  prologue  x_eff = bf16(x * ss * norm_w)      (rmsnorm apply)
         or x_eff = bf16(silu(x) * u)          (SwiGLU gate)
  matmul    acc   = x_eff @ W                  (f32 accumulation)
  epilogue  out   = (acc + residual).to(out_dtype)
            ss'   = rsqrt(mean(out^2) + eps)   (second launch, over out)

Beside each kernel, its plain PyTorch version (the same staging, with the
exactly dequantized f32 weight) serves CPU tensors and is what the card
run holds the kernel to.
"""

from __future__ import annotations

import ctypes
import math

import torch

from llama_cu_awq_torch.ops.cuda import (_build, check_tensor, count,
                                         require, stream_ptr, use_plain)
from llama_cu_awq_torch.quant.qtensor import QTensor

# shared-memory budget of one pass's staged x (of the card's 227 KB)
_SMEM_BUDGET = 200 * 1024
_MAX_ROWS = 8  # matches MAX_ROWS in csrc/int4_gemv.cu

_P = ctypes.c_void_p
_I = ctypes.c_int
_GEMV_ARGS = [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
              _I, _I, _P]
_RMS_ARGS = [_P, _I, _P, _I, _I, ctypes.c_float, _P]


def _rows(x: torch.Tensor, n_in: int):
    """The leading shape of x (..., n_in) and the number of rows in it."""
    require(x.shape[-1] == n_in,
            f"x has {x.shape[-1]} inputs, the weight {n_in}")
    lead = tuple(x.shape[:-1])
    return lead, math.prod(lead)


def rows_per_pass(m: int, n_in: int) -> int:
    per_row = (n_in // 32) * 34 * 2  # padded bf16 staging (csrc/common.cuh)
    return max(1, min(m, _MAX_ROWS, _SMEM_BUDGET // per_row))


def _as_rows(a: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """(..., n) bf16 -> (m, n) with unit element stride, as a view when
    possible (the gate and up halves of gate_up keep their row stride)."""
    a2 = a.to(torch.bfloat16).reshape(m, n)
    return a2 if a2.stride(1) == 1 else a2.contiguous()


def _launch(x2, qt: QTensor, *, u2=None, ss=None, nw=None, res=None,
            out_dtype, eps=None):
    m, n_in = x2.shape
    dev = x2.device
    require(n_in % 32 == 0, f"the kernel needs n_in % 32 == 0, got {n_in}")
    require(out_dtype in (torch.bfloat16, torch.float32),
            f"unsupported out_dtype {out_dtype}")
    check_tensor(qt.qw, "qw", torch.int32, (qt.n_out, n_in // 8), dev)
    check_tensor(qt.scales, "scales", torch.float16,
                 (qt.n_out, qt.n_groups), dev)
    check_tensor(qt.zeros, "zeros", torch.uint8, (qt.n_out, qt.n_groups),
                 dev)
    require(x2.dtype == torch.bfloat16 and x2.stride(1) == 1, "bad x")
    if u2 is not None:
        require(u2.shape == x2.shape and u2.dtype == torch.bfloat16
                and u2.stride(1) == 1 and u2.device == dev, "bad silu_u")
    if ss is not None:
        check_tensor(ss, "ss", torch.float32, (m,), dev)
        check_tensor(nw, "norm_w", torch.float32, (n_in,), dev)
    if res is not None:
        check_tensor(res, "residual", torch.bfloat16, (m, qt.n_out), dev)
    out = torch.empty(m, qt.n_out, dtype=out_dtype, device=dev)
    out_bf16 = int(out_dtype == torch.bfloat16)
    stream = stream_ptr()
    fn = _build.function("int4_gemv", "int4_gemv", _GEMV_ARGS)
    rc = fn(x2.data_ptr(), x2.stride(0),
            u2.data_ptr() if u2 is not None else None,
            u2.stride(0) if u2 is not None else 0,
            ss.data_ptr() if ss is not None else None,
            nw.data_ptr() if nw is not None else None,
            qt.qw.data_ptr(), qt.scales.data_ptr(), qt.zeros.data_ptr(),
            res.data_ptr() if res is not None else None, out.data_ptr(),
            out_bf16, m, n_in, qt.n_out, qt.n_groups,
            rows_per_pass(m, n_in), stream)
    _build.check(rc, "int4_gemv", "int4_gemv")
    ss_out = None
    if eps is not None:
        ss_out = torch.empty(m, 1, dtype=torch.float32, device=dev)
        rms = _build.function("int4_gemv", "rms_scale", _RMS_ARGS)
        rc = rms(out.data_ptr(), out_bf16, ss_out.data_ptr(), m, qt.n_out,
                 float(eps), stream)
        _build.check(rc, "int4_gemv", "rms_scale")
    return out, ss_out


# ---------------------------------------------------------------------------
# int4_matmul

def int4_matmul_plain(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """x: (..., n_in) -> (..., n_out) f32; x staged to bf16 as the kernel
    does, the weight dequantized exactly, f32 accumulation."""
    lead, m = _rows(x, qt.n_in)
    xb = x.reshape(m, qt.n_in).to(torch.bfloat16).float()
    out = xb @ qt.dequantize_t().T
    return out.reshape(*lead, qt.n_out)


def int4_matmul(x: torch.Tensor, qt: QTensor, *,
                plain: bool = False) -> torch.Tensor:
    """x: (..., n_in) any float dtype -> (..., n_out) f32."""
    if use_plain(x, plain):
        return int4_matmul_plain(x, qt)
    lead, m = _rows(x, qt.n_in)
    out, _ = _launch(_as_rows(x, m, qt.n_in), qt, out_dtype=torch.float32)
    count("int4_matmul", f"m{m}/{qt.n_in}x{qt.n_out}")
    return out.reshape(*lead, qt.n_out)


# ---------------------------------------------------------------------------
# int4_matmul_fused

def int4_matmul_fused_plain(x, qt: QTensor, *, prescale=None, silu_u=None,
                            residual=None, emit_ss_eps=None,
                            out_dtype=torch.bfloat16):
    """The unfused composite with the kernel's numerics (the staging of
    llama_cu_awq_tpu/ops/linear.py:120-137): bf16 effective x, f32
    accumulation, f32 residual add, cast, then the rms scale."""
    lead, m = _rows(x, qt.n_in)
    xf = x.to(torch.bfloat16).float()
    if prescale is not None:
        ss, norm_w = prescale
        xf = xf * ss.float() * norm_w.float()
    elif silu_u is not None:
        xf = xf * torch.sigmoid(xf) * silu_u.to(torch.bfloat16).float()
    out = int4_matmul_plain(xf.to(torch.bfloat16), qt)
    if residual is not None:
        out = out + residual.float()
    out = out.to(out_dtype)
    ss_out = None
    if emit_ss_eps is not None:
        of = out.float()
        ss_out = torch.rsqrt((of * of).mean(dim=-1, keepdim=True)
                             + emit_ss_eps)
    return out, ss_out


def int4_matmul_fused(x, qt: QTensor, *, prescale=None, silu_u=None,
                      residual=None, emit_ss_eps=None,
                      out_dtype=torch.bfloat16, plain: bool = False):
    """x: (..., n_in); prescale: (ss (..., 1) f32, norm_w (n_in,) f32);
    silu_u: (..., n_in) up values (x is then the gate); residual:
    (..., n_out) bf16; emit_ss_eps: float -> also return ss' (..., 1) f32.
    Returns (out, ss') with ss' None unless asked for."""
    require(prescale is None or silu_u is None,
            "prescale and silu_u are exclusive")
    if use_plain(x, plain):
        return int4_matmul_fused_plain(
            x, qt, prescale=prescale, silu_u=silu_u, residual=residual,
            emit_ss_eps=emit_ss_eps, out_dtype=out_dtype)
    lead, m = _rows(x, qt.n_in)
    x2 = _as_rows(x, m, qt.n_in)
    u2 = _as_rows(silu_u, m, qt.n_in) if silu_u is not None else None
    ss = nw = None
    if prescale is not None:
        ss = prescale[0].reshape(m).contiguous()
        nw = prescale[1].reshape(qt.n_in).contiguous()
    res = (residual.reshape(m, qt.n_out).contiguous()
           if residual is not None else None)
    out, ss_out = _launch(x2, qt, u2=u2, ss=ss, nw=nw, res=res,
                          out_dtype=out_dtype, eps=emit_ss_eps)
    flags = [f for f, on in (("prescale", ss is not None),
                             ("silu", u2 is not None),
                             ("residual", res is not None),
                             ("ss", emit_ss_eps is not None)) if on]
    count("int4_matmul_fused",
          f"{'+'.join(flags) or 'plain'}/m{m}/{qt.n_in}x{qt.n_out}")
    out = out.reshape(*lead, qt.n_out)
    if ss_out is not None:
        ss_out = ss_out.reshape(*lead, 1)
    return out, ss_out
