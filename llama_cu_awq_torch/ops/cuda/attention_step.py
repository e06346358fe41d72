"""One decode attention step from the fused qkv row.

Counterpart of llama_cu_awq_tpu/ops/pallas/attention_step.py
(`attention_step`, bf16 and int8 cache): split q|k|v, RoPE with the
`rope_rows` factors, bf16 rounding of the rotated q and k, optional int8
quantization of the new k/v row (absmax * f32(1/127), floor 1e-10,
round half to even), then online-softmax GQA attention over the cache
rows below pos[b] plus the current token. The kernel is `csrc/attention_step.cu` (one block
per slot and kv head, see its header).

The online softmax visits the current token first and then the history in
chunks of CHUNK rows; p is rounded to bf16 before the PV product, so the
chunking decides where that rounding happens. The plain version walks the
same chunks, so kernel and plain version differ only in the order of f32
sums. (The JAX kernel walks blocks of its own size; against it the two
agree to bf16 rounding of p.)
"""

from __future__ import annotations

import ctypes
import math

import torch

from llama_cu_awq_torch.ops.cuda import (_build, check_tensor, count,
                                         require, stream_ptr, use_plain)
from llama_cu_awq_torch.ops.rope import rope_angles

CHUNK = 64  # matches CHUNK in csrc/attention_step.cu
# The int8 KV scale absmax/127 is taken as absmax * f32(1/127): inside a
# jit, XLA rewrites the JAX package's division by the constant into that
# product, so its KV scales (the attention_step kernel's and the jitted
# forward's) are it
INV_127 = 1.0 / 127.0
_NEG = -1e30
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = [_P] * 13 + [_I] * 5 + [_P]


def kernel_takes(n_heads: int, n_kv: int, head_dim: int) -> bool:
    """Whether csrc/attention_step.cu takes these head shapes (any cache
    length): head_dim a multiple of 32 up to 256, at most 8 query heads
    per kv head."""
    return (head_dim % 32 == 0 and head_dim <= 256 and n_heads % n_kv == 0
            and n_heads // n_kv <= 8)


def rope_rows(pos: torch.Tensor, head_dim: int, theta: float):
    """Per-step rope factor rows: (cos2, sinm), each (B, head_dim) f32
    with cos2 = [cos|cos] and sinm = [-sin|sin]."""
    cos, sin = rope_angles(pos, head_dim, theta)
    return torch.cat([cos, cos], dim=-1), torch.cat([-sin, sin], dim=-1)


def attention_step_plain(qkv, k_cache, v_cache, pos, cos2, sinm,
                         k_scale=None, v_scale=None, *, n_heads: int):
    """The kernel's arithmetic in PyTorch (see the module docstring)."""
    B = qkv.shape[0]
    _, S, n_kv, D = k_cache.shape
    H = n_heads
    kv_mul = H // n_kv
    half = D // 2
    quantized = k_scale is not None
    scale = float(torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32))
    q = qkv[:, :H * D].float().reshape(B, H, D)
    k = qkv[:, H * D:(H + n_kv) * D].float().reshape(B, n_kv, D)
    v_bf = qkv[:, (H + n_kv) * D:].to(torch.bfloat16).reshape(B, n_kv, D)
    c, s = cos2.float()[:, None, :], sinm.float()[:, None, :]

    def rope(x):
        return x * c + torch.roll(x, half, dims=-1) * s

    q_bf = rope(q).to(torch.bfloat16).float()
    k_bf = rope(k).to(torch.bfloat16)
    if quantized:
        kf, vf = k_bf.float(), v_bf.float()
        ks_new = torch.clamp(kf.abs().amax(-1) * INV_127, min=1e-10)
        vs_new = torch.clamp(vf.abs().amax(-1) * INV_127, min=1e-10)
        kcur = torch.round(kf / ks_new[..., None])
        vcur = torch.round(vf / vs_new[..., None])
        k_new, v_new = kcur.to(torch.int8), vcur.to(torch.int8)
    else:
        ks_new = vs_new = None
        kcur, vcur = k_bf.float(), v_bf.float()
        k_new, v_new = k_bf, v_bf

    attn = torch.empty(B, H, D, dtype=torch.float32, device=qkv.device)
    for b in range(B):
        qg = q_bf[b].reshape(n_kv, kv_mul, D)
        m = torch.full((n_kv, kv_mul), _NEG, device=qkv.device)
        l = torch.zeros(n_kv, kv_mul, device=qkv.device)
        acc = torch.zeros(n_kv, kv_mul, D, device=qkv.device)

        def update(kblk, vblk, ks_rows, vs_rows):
            # kblk/vblk: (n_kv, rows, D) f32; scales (n_kv, rows) or None
            nonlocal m, l, acc
            raw = torch.einsum("gmd,grd->gmr", qg, kblk)
            if ks_rows is not None:
                raw = raw * ks_rows[:, None, :]
            sc = raw * scale
            m_new = torch.maximum(m, sc.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(sc - m_new[..., None])
            l = l * alpha + p.sum(-1)
            m = m_new
            if vs_rows is not None:
                p = p * vs_rows[:, None, :]
            pv = torch.einsum("gmr,grd->gmd",
                              p.to(torch.bfloat16).float(), vblk)
            acc = acc * alpha[..., None] + pv

        update(kcur[b][:, None, :], vcur[b][:, None, :],
               ks_new[b][:, None] if quantized else None,
               vs_new[b][:, None] if quantized else None)
        n_hist = min(int(pos[b]), S)
        for r0 in range(0, n_hist, CHUNK):
            r1 = min(r0 + CHUNK, n_hist)
            update(k_cache[b, r0:r1].float().transpose(0, 1),
                   v_cache[b, r0:r1].float().transpose(0, 1),
                   k_scale[b, r0:r1].T if quantized else None,
                   v_scale[b, r0:r1].T if quantized else None)
        attn[b] = (acc / l[..., None]).reshape(H, D)
    return attn, k_new, v_new, ks_new, vs_new


def attention_step(qkv, k_cache, v_cache, pos, cos2, sinm, k_scale=None,
                   v_scale=None, *, n_heads: int, plain: bool = False):
    """qkv: (B, (H + 2*Hkv)*D) bf16, laid out [q | k | v] as the fused
    qkv matmul emits it. k_cache/v_cache: (B, S, Hkv, D) bf16, or int8
    codes with k_scale/v_scale (B, S, Hkv) f32; read-only history (rows
    at pos[b] and beyond are ignored). pos: (B,) int32. cos2/sinm: (B, D)
    f32 from rope_rows.

    Returns (attn (B, H, D) f32, k_new (B, Hkv, D) in the cache dtype,
    v_new, k_s, v_s) with k_s/v_s (B, Hkv) f32 scales, None unless
    quantized. The caller writes the new row into the cache at pos[b].
    """
    if use_plain(qkv, plain):
        return attention_step_plain(qkv, k_cache, v_cache, pos, cos2, sinm,
                                    k_scale, v_scale, n_heads=n_heads)
    B = qkv.shape[0]
    _, S, n_kv, D = k_cache.shape
    H = n_heads
    dev = qkv.device
    quantized = k_scale is not None
    kv_dtype = torch.int8 if quantized else torch.bfloat16
    require(kernel_takes(H, n_kv, D),
            f"the kernel cannot take n_heads={H}, n_kv={n_kv}, head_dim={D}")
    check_tensor(qkv, "qkv", torch.bfloat16, (B, (H + 2 * n_kv) * D), dev)
    check_tensor(k_cache, "k_cache", kv_dtype, (B, S, n_kv, D), dev)
    check_tensor(v_cache, "v_cache", kv_dtype, (B, S, n_kv, D), dev)
    if quantized:
        check_tensor(k_scale, "k_scale", torch.float32, (B, S, n_kv), dev)
        check_tensor(v_scale, "v_scale", torch.float32, (B, S, n_kv), dev)
    check_tensor(pos, "pos", torch.int32, (B,), dev)
    check_tensor(cos2, "cos2", torch.float32, (B, D), dev)
    check_tensor(sinm, "sinm", torch.float32, (B, D), dev)
    attn = torch.empty(B, H, D, dtype=torch.float32, device=dev)
    k_new = torch.empty(B, n_kv, D, dtype=kv_dtype, device=dev)
    v_new = torch.empty(B, n_kv, D, dtype=kv_dtype, device=dev)
    ks_new = vs_new = None
    if quantized:
        ks_new = torch.empty(B, n_kv, dtype=torch.float32, device=dev)
        vs_new = torch.empty(B, n_kv, dtype=torch.float32, device=dev)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    fn = _build.function("attention_step", "attention_step", _ARGS)
    rc = fn(qkv.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            ptr(k_scale), ptr(v_scale), pos.data_ptr(), cos2.data_ptr(),
            sinm.data_ptr(), attn.data_ptr(), k_new.data_ptr(),
            v_new.data_ptr(), ptr(ks_new), ptr(vs_new), B, H, n_kv, D, S,
            stream_ptr())
    _build.check(rc, "attention_step", "attention_step")
    count("attention_step",
          f"{'int8' if quantized else 'bf16'}/B{B}/H{H}/kv{n_kv}/D{D}")
    return attn, k_new, v_new, ks_new, vs_new
