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
reads every row of it. The kernel is `csrc/batched_attention.cu` (one
block per slot and kv head, see its header).

The online softmax walks the rows in chunks of CHUNK from 0, and p rounds
to bf16 against each chunk's running max, so the plain version walks the
same chunks; kernel and plain version then differ only in the order of
f32 sums. (The JAX kernel walks blocks of 128 to 1024 rows; against it the
two agree to bf16 rounding of p.) A masked row adds 0 to the sums and a
chunk past pos[b] leaves the running max, sum and accumulator unchanged,
so both values of early_exit give the same result up to the order of f32
sums.
"""

from __future__ import annotations

import ctypes

import torch

from llama_cu_awq_torch.ops.cuda import (_build, attn_scale, check_tensor,
                                         count, require, stream_ptr,
                                         use_plain)

CHUNK = 64  # matches CHUNK in csrc/batched_attention.cu
_NEG = -1e30
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = [_P] * 7 + [_I] * 7 + [ctypes.c_float, _P]


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
    out = torch.empty(B, H, D, dtype=torch.float32, device=dev)
    for b in range(B):
        p0 = int(pos[b])
        n_rows = min(p0 + 1, window) if early_exit else window
        m = torch.full((n_kv, kv_mul), _NEG, device=dev)
        l = torch.zeros(n_kv, kv_mul, device=dev)
        acc = torch.zeros(n_kv, kv_mul, D, device=dev)
        for r0 in range(0, n_rows, CHUNK):
            r1 = min(r0 + CHUNK, n_rows)
            kb = k[b, r0:r1].float().transpose(0, 1)  # (n_kv, rows, D)
            vb = v[b, r0:r1].float().transpose(0, 1)
            raw = torch.einsum("gmd,grd->gmr", qg[b], kb)
            if quantized:
                raw = raw * k_scale[b, r0:r1].T[:, None, :]
            sc = raw * scale
            valid = (torch.arange(r0, r1, device=dev) <= p0)[None, None, :]
            sc = torch.where(valid, sc, torch.full_like(sc, _NEG))
            m_new = torch.maximum(m, sc.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.where(valid, torch.exp(sc - m_new[..., None]),
                            torch.zeros_like(sc))
            l = l * alpha + p.sum(-1)
            m = m_new
            if quantized:
                p = p * v_scale[b, r0:r1].T[:, None, :]
            pv = torch.einsum("gmr,grd->gmd", p.to(torch.bfloat16).float(),
                              vb)
            acc = acc * alpha[..., None] + pv
        out[b] = (acc / l[..., None]).reshape(H, D)
    return out


def batched_decode_attention(q, k, v, pos, k_scale=None, v_scale=None, *,
                             attn_len: int | None = None,
                             early_exit: bool = True,
                             plain: bool = False) -> torch.Tensor:
    """q: (B, H, D) f32 or bf16; k, v: (B, S, Hkv, D) bf16, or int8 codes
    with k_scale/v_scale (B, S, Hkv) f32, read in place (not sliced) and
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
    kv_dtype = torch.int8 if quantized else torch.bfloat16
    window = min(attn_len or S, S)
    require(kernel_takes(H, n_kv, D),
            f"the kernel cannot take n_heads={H}, n_kv={n_kv}, head_dim={D}")
    qb = q.to(torch.bfloat16).contiguous()
    check_tensor(k, "k_cache", kv_dtype, (B, S, n_kv, D), dev)
    check_tensor(v, "v_cache", kv_dtype, (B, S, n_kv, D), dev)
    if quantized:
        check_tensor(k_scale, "k_scale", torch.float32, (B, S, n_kv), dev)
        check_tensor(v_scale, "v_scale", torch.float32, (B, S, n_kv), dev)
    check_tensor(pos, "pos", torch.int32, (B,), dev)
    out = torch.empty(B, H, D, dtype=torch.float32, device=dev)
    fn = _build.function("batched_attention", "batched_decode_attention",
                         _ARGS)
    rc = fn(qb.data_ptr(), k.data_ptr(), v.data_ptr(),
            k_scale.data_ptr() if quantized else None,
            v_scale.data_ptr() if quantized else None, pos.data_ptr(),
            out.data_ptr(), B, H, n_kv, D, S, window, int(early_exit),
            attn_scale(D), stream_ptr())
    _build.check(rc, "batched_attention", "batched_decode_attention")
    count("batched_decode_attention",
          f"{'int8' if quantized else 'bf16'}/"
          f"{'early' if early_exit else 'static'}/B{B}/H{H}/kv{n_kv}/D{D}")
    return out
