"""w4-g128 dequant matmul: `int4_matmul` and `int4_matmul_fused`.

Counterparts of llama_cu_awq_tpu/ops/pallas/int4_matmul.py. Both take one
of two kernels by the number of rows m (`route`): below GEMM_MIN_M rows
`csrc/int4_gemv.cu` (int4_gemv.cuh's tensor-core column tile of 16
columns by up to 8 rows, decode and serving), from GEMM_MIN_M rows on
`csrc/int4_gemm.cu` (wgmma over 128-row tiles of x, prefill blocks); see
their headers. `int4_matmul_fused` adds a prologue on x and
an epilogue on the output:

  prologue  x_eff = bf16(x * ss * norm_w)      (rmsnorm apply)
         or x_eff = bf16(silu(x) * u)          (SwiGLU gate)
  matmul    acc   = x_eff @ W                  (f32 accumulation)
  epilogue  out   = (acc + residual).to(out_dtype)
            ss'   = rsqrt(mean(out^2) + eps)   (second launch, over out)

x and u are cast to bf16 before the kernel, as the JAX wrapper does
(int4_matmul.py:656-661); the residual and the output are each bf16, fp16
or f32 (--act-dtype), the residual read in f32 and the output stored in
out_dtype by the kernel itself, as the JAX kernel does (:471-475).

Beside each kernel, its plain PyTorch version (the same staging, with the
exactly dequantized f32 weight) serves CPU tensors and is what the card
run holds the kernel to.
"""

from __future__ import annotations

import ctypes
import math

import torch

from llama_cu_awq_torch.ops.cuda import (_build, check_tensor, count,
                                         dtype_code, dtype_name, require,
                                         stream_ptr, use_plain)
from llama_cu_awq_torch.quant.qtensor import QTensor

# rows from which a CUDA call takes the GEMM: below it the GEMV's
# tensor-core tile, whose passes of 8 rows each read the whole weight, is
# faster. chip_smoke.py's gemm_crossover line on the H100 (PERF.md): the
# tile ahead at every m of the sweep up to 16, the wgmma GEMM from 24 on.
GEMM_MIN_M = 17
# shared-memory budget of one pass's staged x (of the card's 227 KB)
_SMEM_BUDGET = 200 * 1024
_MAX_ROWS = 8  # matches MAX_ROWS in csrc/int4_gemv.cuh

_P = ctypes.c_void_p
_I = ctypes.c_int
_GEMV_ARGS = [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I,
              _I, _I, _I, _P]
_GEMM_ARGS = _GEMV_ARGS[:-2] + [_I, _P, _P, _P, _P]
# csrc/int4_gemm.cu's tiles: 128 output columns by 128 rows of x by one
# 128-input group, and the H100's streaming multiprocessors
_GEMM_TILE = 128
_SMS = 132
_RMS_ARGS = [_P, _I, _P, _I, _I, ctypes.c_float, _P]


def _rows(x: torch.Tensor, n_in: int):
    """The leading shape of x (..., n_in) and the number of rows in it."""
    require(x.shape[-1] == n_in,
            f"x has {x.shape[-1]} inputs, the weight {n_in}")
    lead = tuple(x.shape[:-1])
    return lead, math.prod(lead)


def route(m: int) -> str:
    """The kernel a CUDA call with m rows of x launches: "gemm" from
    GEMM_MIN_M rows on, else "gemv". Both take any n_in % 32 == 0."""
    return "gemm" if m >= GEMM_MIN_M else "gemv"


def gemm_splits(n_in: int, n_out: int) -> int:
    """Splits of the GEMM's groups (csrc/int4_gemm.cu): as many as keep
    (column tiles x splits) within one wave of 132 SMs, each split at
    least 8 groups. A function of the weight's shape alone, so a row's
    sums never depend on m."""
    tiles = -(-n_out // _GEMM_TILE)
    groups = -(-n_in // 128)
    return max(1, min(_SMS // tiles, groups // 8))


def staged_row_bytes(n_in: int) -> int:
    """Shared memory of one staged row of x (csrc/int4_gemv.cuh
    staged_bytes): 17 units of 16 bytes a 128-input group, the row padded
    to 2 mod 8 units, plus one f32 group sum a group."""
    groups = -(-n_in // 128)
    units = 17 * groups
    return (units + (2 - units) % 8) * 16 + groups * 4


def rows_per_pass(m: int, n_in: int) -> int:
    """Rows of x a pass stages."""
    return max(1, min(m, _MAX_ROWS, _SMEM_BUDGET // staged_row_bytes(n_in)))


def raw_row_bytes(n_in: int, elem: int = 2) -> int:
    """Shared memory of one staged row plus a copy of the row as it is
    (elem bytes a value: 2 for bf16 and fp16, 4 for f32): the chains'
    rmsnorm-apply stages (csrc/int4_gemv.cuh copy_rows), with 16 bytes for
    the copy's alignment."""
    return staged_row_bytes(n_in) + elem * n_in + 16


def rows_per_pass_raw(m: int, n_in: int, elem: int = 2) -> int:
    """Rows a pass of a stage that keeps the raw copy stages."""
    return max(1, min(m, _MAX_ROWS,
                      _SMEM_BUDGET // raw_row_bytes(n_in, elem)))


def dtype_suffix(out_dtype, residual) -> str:
    """The variant key's tail for an output or residual that is not bf16
    (--act-dtype float16 / float32): "" for the bf16 forms."""
    parts = [f"out_{dtype_name(out_dtype)}"] if out_dtype != torch.bfloat16 \
        else []
    if residual is not None and residual.dtype != torch.bfloat16:
        parts.append(f"res_{dtype_name(residual.dtype)}")
    return "".join("/" + p for p in parts)


def _as_rows(a: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """(..., n) bf16 -> (m, n) with unit element stride and 16-byte aligned
    rows (the GEMM's vector loads), as a view when possible (the gate and
    up halves of gate_up keep their row stride)."""
    a2 = a.to(torch.bfloat16).reshape(m, n)
    ok = (a2.stride(1) == 1 and a2.stride(0) % 8 == 0
          and a2.data_ptr() % 16 == 0)
    return a2 if ok else a2.contiguous()


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it where its data does not start on 16 bytes (the
    kernels read norm weights in 16-byte vectors)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(x2, qt: QTensor, *, u2=None, ss=None, nw=None, res=None,
            out_dtype, eps=None, kernel: str, splits: int | None = None):
    """One launch of `kernel` ("gemv" or "gemm"; callers pass route(m)),
    plus the rms_scale launch when eps is given. `splits` overrides
    gemm_splits (chip_smoke.py's sweep of the rule)."""
    m, n_in = x2.shape
    dev = x2.device
    require(n_in % 32 == 0, f"the kernel needs n_in % 32 == 0, got {n_in}")
    out_dt = dtype_code(out_dtype, "out")
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
    res_dt = 1
    if res is not None:
        res_dt = dtype_code(res.dtype, "residual")
        check_tensor(res, "residual", res.dtype, (m, qt.n_out), dev)
    out = torch.empty(m, qt.n_out, dtype=out_dtype, device=dev)
    stream = stream_ptr()
    args = [x2.data_ptr(), x2.stride(0),
            u2.data_ptr() if u2 is not None else None,
            u2.stride(0) if u2 is not None else 0,
            ss.data_ptr() if ss is not None else None,
            nw.data_ptr() if nw is not None else None,
            qt.qw.data_ptr(), qt.scales.data_ptr(), qt.zeros.data_ptr(),
            res.data_ptr() if res is not None else None, res_dt,
            out.data_ptr(), out_dt, m, n_in, qt.n_out, qt.n_groups]
    if kernel == "gemm":
        # scratch: the staged x_eff tiles and group sums, and the split
        # partials
        row_tiles = -(-m // _GEMM_TILE)
        tiles = row_tiles * qt.n_groups
        xs = torch.empty(tiles, _GEMM_TILE * 128, dtype=torch.bfloat16,
                         device=dev)
        sx = torch.empty(tiles, _GEMM_TILE, dtype=torch.float32, device=dev)
        splits = splits or gemm_splits(n_in, qt.n_out)
        part = (torch.empty(splits, m, qt.n_out, dtype=torch.float32,
                            device=dev) if splits > 1 else None)
        fn = _build.function("int4_gemm", "int4_gemm", _GEMM_ARGS)
        rc = fn(*args, splits, xs.data_ptr(), sx.data_ptr(),
                part.data_ptr() if part is not None else None, stream)
    else:
        fn = _build.function("int4_gemv", "int4_gemv", _GEMV_ARGS)
        rc = fn(*args, rows_per_pass(m, n_in), stream)
    _build.check(rc, f"int4_{kernel}", f"int4_{kernel}")
    ss_out = None
    if eps is not None:
        ss_out = torch.empty(m, 1, dtype=torch.float32, device=dev)
        rms = _build.function("int4_gemv", "rms_scale", _RMS_ARGS)
        rc = rms(out.data_ptr(), out_dt, ss_out.data_ptr(), m, qt.n_out,
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
    kernel = route(m)
    out, _ = _launch(_as_rows(x, m, qt.n_in), qt, out_dtype=torch.float32,
                     kernel=kernel)
    count("int4_matmul", f"{kernel}/m{m}/{qt.n_in}x{qt.n_out}")
    return out.reshape(*lead, qt.n_out)


# ---------------------------------------------------------------------------
# int4_matmul_fused

def int4_matmul_fused_plain(x, qt: QTensor, *, prescale=None, silu_u=None,
                            residual=None, emit_ss_eps=None,
                            out_dtype=torch.bfloat16):
    """The unfused composite with the kernel's numerics (the staging of
    llama_cu_awq_tpu/ops/linear.py:120-137, after the JAX kernel wrapper's
    casts of x and u to bf16, int4_matmul.py:656-661): bf16 effective x,
    f32 accumulation, the residual (any float type) added in f32, the cast
    to out_dtype, then the rms scale of the cast output."""
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
    (..., n_out) bf16, fp16 or f32; out_dtype bf16, fp16 or f32;
    emit_ss_eps: float -> also return ss' (..., 1) f32. Returns (out, ss')
    with ss' None unless asked for."""
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
        nw = aligned16(prescale[1].reshape(qt.n_in).contiguous())
    res = (residual.reshape(m, qt.n_out).contiguous()
           if residual is not None else None)
    kernel = route(m)
    out, ss_out = _launch(x2, qt, u2=u2, ss=ss, nw=nw, res=res,
                          out_dtype=out_dtype, eps=emit_ss_eps, kernel=kernel)
    flags = [f for f, on in (("prescale", ss is not None),
                             ("silu", u2 is not None),
                             ("residual", res is not None),
                             ("ss", emit_ss_eps is not None)) if on]
    count("int4_matmul_fused", f"{kernel}/{'+'.join(flags) or 'plain'}"
          f"/m{m}/{qt.n_in}x{qt.n_out}{dtype_suffix(out_dtype, res)}")
    out = out.reshape(*lead, qt.n_out)
    if ss_out is not None:
        ss_out = ss_out.reshape(*lead, 1)
    return out, ss_out
