"""Causal flash attention for a block of query tokens over the KV cache.

Counterpart of llama_cu_awq_tpu/ops/pallas/prefill_attention.py
(`prefill_attention`, bf16 and int8 cache): key s is visible to token t of
slot b iff s <= pos[b] + t (and s < attn_len); the cache already holds the
block's own k/v. q is rounded to bf16; scores are f32 dots of bf16
operands, times k_scale (int8) before * 1/sqrt(D); masked scores are -1e30
and their p is 0; p is multiplied by v_scale (int8) before it is rounded
to bf16 for the PV product; out = acc / l. The kernel is
`csrc/prefill_attention.cu` (one block per query tile of 64 rows, split
of SPLIT_ROWS keys, kv head and slot, then a merge launch; see its
header).

The keys are cut into splits of SPLIT_ROWS rows at fixed boundaries;
each split runs its own online softmax over chunks of CHUNK rows from m
= -1e30, l = 0, so p rounds to bf16 against the running max of its own
split; a row then combines the splits 0 .. horizon // SPLIT_ROWS in
order (attention_step.combine_splits). The plain version walks the same
splits and chunks; kernel and plain version then differ only in the
order of f32 sums. (The JAX kernel walks blocks of 256 to 1024 keys;
against it the two agree to bf16 rounding of p.)

Under --act-dtype float16 / float32 the unquantized cache is fp16 or f32:
its rows round to bf16 as they load, as the JAX kernel casts its blocks
(prefill_attention.py:93-94), and q is cast to bf16 before the kernel, as
the JAX wrapper does (:204).
"""

from __future__ import annotations

import ctypes

import torch

from llama_cu_awq_torch.ops.cuda import (_build, attn_scale, check_tensor,
                                         count, dtype_code, require,
                                         stream_ptr, use_plain)
from llama_cu_awq_torch.ops.cuda.attention_step import (bf16_values,
                                                        cache_format,
                                                        combine_splits)

# SPLIT and KC in csrc/prefill_attention.cu (compile-time constants there;
# tests/test_torch_prefill.py holds the three equal)
SPLIT_ROWS = 256
CHUNK = 64
_NEG = -1e30
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = [_P] * 9 + [_I] * 7 + [ctypes.c_float, _I, _P]


def kernel_takes(n_heads: int, n_kv: int, head_dim: int, T: int) -> bool:
    """Whether csrc/prefill_attention.cu takes these shapes (any window and
    any number of query rows): head_dim 64 or 128, whole query heads per
    kv head."""
    return (head_dim in (64, 128) and n_kv >= 1 and n_heads % n_kv == 0
            and T >= 1)


def n_splits(window: int) -> int:
    """Splits of a window of `window` keys: the kernel's grid and the
    rows of its scratch."""
    return -(-window // SPLIT_ROWS)


def prefill_attention_plain(q, k, v, pos, k_scale=None, v_scale=None, *,
                            attn_len: int | None = None) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch (see the module docstring)."""
    B, T, H, D = q.shape
    _, S, n_kv, _ = k.shape
    kv_mul = H // n_kv
    window = min(attn_len or S, S)
    quantized = k_scale is not None
    scale = attn_scale(D)
    dev = q.device
    qg = q.to(torch.bfloat16).float().reshape(B, T, n_kv, kv_mul, D)
    # cached rows as the kernel reads them: codes, or bf16-rounded values
    values = torch.Tensor.float if quantized else bf16_values
    t_idx = torch.arange(T, device=dev)
    out = torch.empty(B, T, H, D, dtype=torch.float32, device=dev)
    for b in range(B):
        p0 = int(pos[b])
        horizon = min(p0 + T - 1, window - 1)
        parts = []
        for s0 in range(0, horizon + 1, SPLIT_ROWS):
            # one split: its own online softmax over chunks of CHUNK keys
            # (a row that sees none of them keeps l = 0 and stays out of
            # the combine)
            m = torch.full((T, n_kv, kv_mul), _NEG, device=dev)
            l = torch.zeros(T, n_kv, kv_mul, device=dev)
            acc = torch.zeros(T, n_kv, kv_mul, D, device=dev)
            for c0 in range(s0, min(s0 + SPLIT_ROWS, horizon + 1), CHUNK):
                c1 = min(c0 + CHUNK, window)
                kb = values(k[b, c0:c1])  # (n, n_kv, D)
                vb = values(v[b, c0:c1])
                raw = torch.einsum("thgd,shd->thgs", qg[b], kb)
                if quantized:
                    raw = raw * k_scale[b, c0:c1].T[None, :, None, :]
                sc = raw * scale
                s_idx = torch.arange(c0, c1, device=dev)
                valid = (s_idx[None, :] <= p0 + t_idx[:, None])[
                    :, None, None, :]
                sc = torch.where(valid, sc, torch.full_like(sc, _NEG))
                m_new = torch.maximum(m, sc.amax(-1))
                alpha = torch.exp(m - m_new)
                p = torch.where(valid, torch.exp(sc - m_new[..., None]),
                                torch.zeros_like(sc))
                l = l * alpha + p.sum(-1)
                m = m_new
                if quantized:
                    p = p * v_scale[b, c0:c1].T[None, :, None, :]
                pv = torch.einsum("thgs,shd->thgd",
                                  p.to(torch.bfloat16).float(), vb)
                acc = acc * alpha[..., None] + pv
            parts.append((m, l, acc))
        out[b] = combine_splits(parts).reshape(T, H, D)
    return out


def prefill_attention(q, k, v, pos, k_scale=None, v_scale=None, *,
                      attn_len: int | None = None,
                      plain: bool = False) -> torch.Tensor:
    """q: (B, T, H, D); k, v: (B, S, Hkv, D) bf16, fp16 or f32, or int8
    codes with k_scale/v_scale (B, S, Hkv) f32, read in place (not sliced);
    pos: (B,)
    int32 position of each slot's first token; attn_len: the window
    (default S), at least max(pos) + T. Returns (B, T, H, D) f32."""
    if use_plain(q, plain):
        return prefill_attention_plain(q, k, v, pos, k_scale, v_scale,
                                       attn_len=attn_len)
    B, T, H, D = q.shape
    _, S, n_kv, _ = k.shape
    dev = q.device
    quantized = k_scale is not None
    kv_dtype = torch.int8 if quantized else k.dtype
    kv_dt = dtype_code(torch.bfloat16 if quantized else k.dtype, "k_cache")
    window = min(attn_len or S, S)
    require(kernel_takes(H, n_kv, D, T),
            f"the kernel cannot take n_heads={H}, n_kv={n_kv}, head_dim={D}")
    qb = q.to(torch.bfloat16).contiguous()
    check_tensor(k, "k_cache", kv_dtype, (B, S, n_kv, D), dev)
    check_tensor(v, "v_cache", kv_dtype, (B, S, n_kv, D), dev)
    if quantized:
        check_tensor(k_scale, "k_scale", torch.float32, (B, S, n_kv), dev)
        check_tensor(v_scale, "v_scale", torch.float32, (B, S, n_kv), dev)
    check_tensor(pos, "pos", torch.int32, (B,), dev)
    require(k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0,
            "the caches must start 16-byte aligned (the kernel's 16-byte "
            "copies)")
    out = torch.empty(B, T, H, D, dtype=torch.float32, device=dev)
    # the splits' partials: (m, l) and acc of every (slot, split, kv head,
    # row); a split above a row's horizon leaves its entry unwritten
    n_part = B * n_splits(window) * H * T
    part_ml = torch.empty(n_part, 2, dtype=torch.float32, device=dev)
    part_acc = torch.empty(n_part, D, dtype=torch.float32, device=dev)
    fn = _build.function("prefill_attention", "prefill_attention", _ARGS)
    rc = fn(qb.data_ptr(), k.data_ptr(), v.data_ptr(),
            k_scale.data_ptr() if quantized else None,
            v_scale.data_ptr() if quantized else None, pos.data_ptr(),
            out.data_ptr(), part_ml.data_ptr(), part_acc.data_ptr(), B, T,
            H, n_kv, D, S, window, attn_scale(D), kv_dt, stream_ptr())
    _build.check(rc, "prefill_attention", "prefill_attention")
    count("prefill_attention",
          f"{cache_format(k)}/B{B}/T{T}/H{H}/kv{n_kv}/D{D}")
    return out
