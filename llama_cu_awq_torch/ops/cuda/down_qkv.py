"""Layer l's down projection chained with layer l+1's qkv projection.

The counterpart of llama_cu_awq_tpu/ops/pallas/down_qkv.py
(`down_qkv_fused`, `supported`). It computes

    x2  = x2_dtype(silu(g) * u @ W_down + bf16(residual))
    ss2 = rsqrt(mean(x2^2) + eps)                    (over the stored x2)
    qkv = bf16(x2 * ss2 * attn_norm') @ W_qkv'       (f32 accumulation)

in one launch of `csrc/down_qkv.cu` (a cooperative launch with a grid
barrier between the two matmuls; see its header), where the standalone
path takes three: int4_matmul_fused with the SwiGLU prologue and the
residual epilogue, its rms_scale launch, and int4_matmul_fused with the
rmsnorm prologue. Each column is summed as the GEMV sums it, so on the
card the chain's outputs are bit-equal to that GEMV pair. The plain
version is the pair's plain version.

x2 is stored in the activation type (x2_dtype: bf16, fp16 or f32,
--act-dtype) and stage Q reads it back in that type, as the JAX kernel
stores x2 in out_dtype (down_qkv.py:86-91, 112-113); the residual is
rounded to bf16 first, as the JAX wrapper rounds it (down_qkv.py:238-244).
Under float16 / float32 that rounding is where the chain departs from the
standalone pair, which adds the residual in its own type; the port follows
the JAX chain.
"""

from __future__ import annotations

import ctypes
import math

import torch

from llama_cu_awq_torch.ops.cuda import (_build, check_tensor, count,
                                         dtype_code, require, stream_ptr,
                                         use_plain)
from llama_cu_awq_torch.ops.cuda.int4_matmul import (_as_rows, aligned16,
                                                     dtype_suffix,
                                                     int4_matmul_fused_plain,
                                                     int4_matmul_plain,
                                                     rows_per_pass,
                                                     rows_per_pass_raw)
from llama_cu_awq_torch.quant.qtensor import QTensor

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = [_P, _I, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _I, _I,
         _P, _P, _I, _P, _P, _I, _I, ctypes.c_float, _I, _I, _P]


def supported(w_down: QTensor, wqkv: QTensor, m: int) -> bool:
    """The kernel's own limit: qkv reads exactly the row down emits, and
    both input widths are multiples of 32 (the GEMV's 16-byte weight
    vectors). Any m >= 1 runs: rows beyond 8 take further passes. Where
    this says no, forward runs the standalone pair."""
    return (m >= 1 and w_down.n_out == wqkv.n_in and w_down.n_in % 32 == 0
            and wqkv.n_in % 32 == 0)


def down_qkv_plain(g, u, residual, w_down: QTensor, wqkv_next: QTensor,
                   attn_norm_next, *, eps: float, out_dtype=torch.float32,
                   x2_dtype=torch.bfloat16):
    """The standalone pair's plain versions on the bf16-rounded residual:
    the down GEMV with the SwiGLU prologue, residual and rms scale (x2 in
    x2_dtype), then the next qkv with the rmsnorm prologue on x2 as
    stored."""
    x2, ss2 = int4_matmul_fused_plain(g, w_down, silu_u=u,
                                      residual=residual.to(torch.bfloat16),
                                      emit_ss_eps=eps, out_dtype=x2_dtype)
    # stage Q's prologue on x2 as stored: bf16(x2 * ss2 * attn_norm'), with
    # no rounding of an fp16 or f32 x2 to bf16 first (the JAX kernel's
    # down_qkv.py:112-113; for a bf16 x2 it is the GEMV's prologue)
    lead = x2.shape[:-1]
    xq = (x2.float() * ss2 * attn_norm_next.float()).to(torch.bfloat16)
    qkv = int4_matmul_plain(xq, wqkv_next).to(out_dtype)
    return x2, ss2, qkv.reshape(*lead, wqkv_next.n_out)


def down_qkv_fused(g: torch.Tensor, u: torch.Tensor, residual: torch.Tensor,
                   w_down: QTensor, wqkv_next: QTensor,
                   attn_norm_next: torch.Tensor, *, eps: float,
                   out_dtype=torch.float32, x2_dtype=torch.bfloat16,
                   plain: bool = False):
    """x2, ss2, qkv_next = chained down projection + next layer's qkv.

    g, u: (..., hidden) SwiGLU operands (the gate_up output's halves);
    residual: (..., dim), rounded to bf16; attn_norm_next: (dim,) f32.
    Returns x2 (..., dim) in x2_dtype (the JAX function's out_dtype), ss2
    (..., 1) f32 and qkv_next (..., n_out) in out_dtype (f32, as the JAX
    function returns it, or the activation type it is cast to)."""
    if use_plain(g, plain):
        return down_qkv_plain(g, u, residual, w_down, wqkv_next,
                              attn_norm_next, eps=eps, out_dtype=out_dtype,
                              x2_dtype=x2_dtype)
    hid, dim, n_q = w_down.n_in, w_down.n_out, wqkv_next.n_out
    require(g.shape[-1] == hid and u.shape == g.shape,
            f"g and u must be (..., {hid})")
    require(residual.shape[-1] == dim, f"residual must be (..., {dim})")
    lead = tuple(g.shape[:-1])
    m = math.prod(lead)
    require(supported(w_down, wqkv_next, m),
            f"down_qkv cannot chain {hid}x{dim} with "
            f"{wqkv_next.n_in}x{n_q} at m={m}")
    qkv_dt = dtype_code(out_dtype, "qkv")
    x2_dt = dtype_code(x2_dtype, "x2")
    dev = g.device
    for qt, name in ((w_down, "w_down"), (wqkv_next, "wqkv")):
        check_tensor(qt.qw, f"{name}.qw", torch.int32,
                     (qt.n_out, qt.n_in // 8), dev)
        check_tensor(qt.scales, f"{name}.scales", torch.float16,
                     (qt.n_out, qt.n_groups), dev)
        check_tensor(qt.zeros, f"{name}.zeros", torch.uint8,
                     (qt.n_out, qt.n_groups), dev)
    g2, u2 = _as_rows(g, m, hid), _as_rows(u, m, hid)
    # the JAX wrapper's bf16 residual (down_qkv.py:238-244)
    res = residual.to(torch.bfloat16).reshape(m, dim).contiguous()
    nw = aligned16(attn_norm_next.reshape(dim).contiguous())
    check_tensor(nw, "attn_norm", torch.float32, (dim,), dev)
    check_tensor(res, "residual", torch.bfloat16, (m, dim), dev)
    h = torch.empty(m, hid, dtype=torch.bfloat16, device=dev)  # scratch
    x2 = torch.empty(m, dim, dtype=x2_dtype, device=dev)
    ss2 = torch.empty(m, dtype=torch.float32, device=dev)
    qkv = torch.empty(m, n_q, dtype=out_dtype, device=dev)
    fn = _build.function("down_qkv", "down_qkv", _ARGS)
    rc = fn(g2.data_ptr(), g2.stride(0), u2.data_ptr(), u2.stride(0),
            res.data_ptr(), nw.data_ptr(), w_down.qw.data_ptr(),
            w_down.scales.data_ptr(), w_down.zeros.data_ptr(), hid, dim,
            w_down.n_groups, wqkv_next.qw.data_ptr(),
            wqkv_next.scales.data_ptr(), wqkv_next.zeros.data_ptr(), n_q,
            wqkv_next.n_groups, h.data_ptr(), x2.data_ptr(), x2_dt,
            ss2.data_ptr(), qkv.data_ptr(), qkv_dt, m, float(eps),
            rows_per_pass(m, hid),
            rows_per_pass_raw(m, dim, x2.element_size()), stream_ptr())
    _build.check(rc, "down_qkv", "down_qkv")
    count("down_qkv", f"m{m}/{hid}x{dim}+{dim}x{n_q}"
          f"{dtype_suffix(x2_dtype, None)}")
    return (x2.reshape(*lead, dim), ss2.reshape(*lead, 1),
            qkv.reshape(*lead, n_q))
