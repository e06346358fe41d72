"""Decode attention (T = 1) over a cache that already holds the current row.

Counterpart of llama_cu_awq_tpu/ops/pallas/batched_attention.py
(`batched_decode_attention`, bf16 and int8 cache): slot b's query sees
cache rows s <= pos[b] (and s < attn_len). q is rounded to bf16; scores
are f32 dots of bf16 operands (not staged through bf16, as the einsum path
stages them), times k_scale (int8) before * 1/sqrt(D); masked scores are
-1e30 and their p is 0; p is multiplied by v_scale (int8) before it is
rounded to bf16 for the PV product; out = acc / l. With early_exit (attn
impl "batched") each slot reads only rows <= pos[b]; without it
("batched_static") every slot walks the whole window under the mask, which
reads every row of it.

The kernel is `csrc/batched_attention.cu` (+ `decode_attention.cuh`), the
split design of attention_step.py without its first phase: the rows split
into runs of SPLIT_ROWS, each taking one max over its
scores and p rounded to bf16 against it, and the splits combined in
order. The plain version
walks the same splits with attention_step.py's `split_partial` and
`combine_splits`, so kernel and plain version differ only in the order of
f32 sums. (The JAX kernel walks blocks of 128 to 1024 rows; against it the
two agree to bf16 rounding of p.) A split whose rows are all masked has
l = 0 and leaves the combine, and a masked row adds 0 to the sums, so both
values of early_exit give the same result up to the order of f32 sums.

Under --act-dtype float16 / float32, q and the unquantized cache are fp16
or f32 (q's type and the cache's are independent); the kernel rounds q
and every cached row to bf16 as it loads them, as the JAX kernel casts q
and its blocks (batched_attention.py:83, 100-101).
"""

from __future__ import annotations

import ctypes

import torch

from llama_cu_awq_torch.ops.cuda import (_build, attn_scale, check_tensor,
                                         count, dtype_code, require,
                                         stream_ptr, use_plain)
from llama_cu_awq_torch.ops.cuda.attention_step import (SPLIT_ROWS,
                                                        bf16_values,
                                                        cache_format,
                                                        combine_splits,
                                                        split_partial,
                                                        split_scratch)

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = [_P] * 10 + [_I] * 7 + [ctypes.c_float, _I, _I, _P]


def kernel_takes(n_heads: int, n_kv: int, head_dim: int) -> bool:
    """Whether csrc/batched_attention.cu takes these head shapes (any
    cache length): head_dim a multiple of 32 up to 256, at most 8 query
    heads per kv head."""
    return (head_dim % 32 == 0 and head_dim <= 256 and n_heads % n_kv == 0
            and n_heads // n_kv <= 8)


def batched_decode_attention_plain(q, k, v, pos, k_scale=None, v_scale=None,
                                   *, attn_len: int | None = None,
                                   early_exit: bool = True) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch (see the module docstring)."""
    B, H, D = q.shape
    _, S, n_kv, _ = k.shape
    kv_mul = H // n_kv
    window = min(attn_len or S, S)
    quantized = k_scale is not None
    scale = attn_scale(D)
    dev = q.device
    qg = q.to(torch.bfloat16).float().reshape(B, n_kv, kv_mul, D)
    # cached rows as the kernel reads them: codes, or bf16-rounded values
    values = torch.Tensor.float if quantized else bf16_values
    out = torch.empty(B, H, D, dtype=torch.float32, device=dev)
    for b in range(B):
        p0 = int(pos[b])
        n_rows = min(p0 + 1, window) if early_exit else window
        parts = []
        for r0 in range(0, n_rows, SPLIT_ROWS):
            r1 = min(r0 + SPLIT_ROWS, n_rows)
            sc = [x[b, r0:r1].T if quantized else None
                  for x in (k_scale, v_scale)]
            parts.append(split_partial(
                qg[b], values(k[b, r0:r1]).transpose(0, 1),
                values(v[b, r0:r1]).transpose(0, 1), *sc, scale,
                torch.arange(r0, r1, device=dev) <= p0))
        out[b] = combine_splits(parts).reshape(H, D)
    return out


def batched_decode_attention(q, k, v, pos, k_scale=None, v_scale=None, *,
                             attn_len: int | None = None,
                             early_exit: bool = True,
                             plain: bool = False) -> torch.Tensor:
    """q: (B, H, D) bf16, fp16 or f32; k, v: (B, S, Hkv, D) bf16, fp16 or
    f32, or int8 codes with k_scale/v_scale (B, S, Hkv) f32, read in place
    (not sliced) and
    already holding row pos[b]; pos: (B,) int32; attn_len: the window
    (default S), more than max(pos). Returns (B, H, D) f32."""
    if use_plain(q, plain):
        return batched_decode_attention_plain(
            q, k, v, pos, k_scale, v_scale, attn_len=attn_len,
            early_exit=early_exit)
    B, H, D = q.shape
    _, S, n_kv, _ = k.shape
    dev = q.device
    quantized = k_scale is not None
    q_dt = dtype_code(q.dtype, "q")
    kv_dtype = torch.int8 if quantized else k.dtype
    kv_dt = dtype_code(torch.bfloat16 if quantized else k.dtype, "k_cache")
    window = min(attn_len or S, S)
    require(kernel_takes(H, n_kv, D),
            f"the kernel cannot take n_heads={H}, n_kv={n_kv}, head_dim={D}")
    qc = q.contiguous()
    check_tensor(k, "k_cache", kv_dtype, (B, S, n_kv, D), dev)
    check_tensor(v, "v_cache", kv_dtype, (B, S, n_kv, D), dev)
    if quantized:
        check_tensor(k_scale, "k_scale", torch.float32, (B, S, n_kv), dev)
        check_tensor(v_scale, "v_scale", torch.float32, (B, S, n_kv), dev)
    check_tensor(pos, "pos", torch.int32, (B,), dev)
    require(k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0,
            "the caches must start 16-byte aligned (the kernel's vector "
            "loads)")
    out = torch.empty(B, H, D, dtype=torch.float32, device=dev)
    scratch = split_scratch(dev, B, n_kv, H // n_kv, D, window)
    fn = _build.function("batched_attention", "batched_decode_attention",
                         _ARGS)
    rc = fn(qc.data_ptr(), k.data_ptr(), v.data_ptr(),
            k_scale.data_ptr() if quantized else None,
            v_scale.data_ptr() if quantized else None, pos.data_ptr(),
            out.data_ptr(), *scratch, B, H, n_kv, D, S, window,
            int(early_exit), attn_scale(D), q_dt, kv_dt, stream_ptr())
    _build.check(rc, "batched_attention", "batched_decode_attention")
    count("batched_decode_attention",
          f"{cache_format(k)}/"
          f"{'early' if early_exit else 'static'}/B{B}/H{H}/kv{n_kv}/D{D}")
    return out
