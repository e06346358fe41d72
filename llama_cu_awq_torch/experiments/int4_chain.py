"""One decoder layer's matmul chain in one launch (`ffn_chain`), and the
whole layer with its decode attention in front (`mono_layer`).

The counterpart of tools/experiments/int4_chain.py, with its names and
contracts. For m rows of a T=1 step:

    x1  = bf16(attn @ W_o + x_res)              ss1 = rsqrt(mean(x1^2) + eps)
    gu  = bf16(bf16(x1 * ss1 * ffn_norm) @ W_gate_up)
    out = bf16(bf16(silu(g) * u) @ W_down + x1)  ss  = rsqrt(mean(out^2) + eps)
    qkv = bf16(bf16(out * ss * attn_norm') @ W_qkv')   (with a next layer)

which is forward's _post_attention followed by the next layer's qkv
projection. `mono_layer` runs decode attention first and feeds its rows,
rounded to bf16, to the chain; it returns the new cache rows and does not
write them (the caller scatters them, as in the JAX contract).

Each is one cooperative launch of `csrc/int4_chain.cu` (persistent blocks
with a grid barrier between the stages; see its header). Each column sums
as the standalone GEMV sums it and each rms scale as rms_scale reduces it,
so on the card ffn_chain's outputs equal the launch sequence it replaces
bit for bit. mono's attention stage walks the window unsplit in one
online softmax (csrc/attention_step.cuh attention_item), where
attention_step splits it across blocks: its new cache rows and scales
equal attention_step's bit for bit (the same phase 1), its attention rows
agree with attention_step's to bf16 rounding of p, and so do the chain's
outputs after them. The plain versions are the sequence's plain versions,
mono's attention walked unsplit (attention_step_plain(split=False)). A
CPU tensor takes the plain version; a CUDA tensor reaches the kernel or
raises.

The JAX kernels pad n_in to its planar block and assert unpadded o and
down outputs; this layout has no padding. Its own limits are in
`ffn_chain_supported` and `mono_supported`: the widths chain, every input
width is a multiple of 32 (the GEMV's 16-byte weight vectors), and one
row of every stage's staging fits a block's shared memory, so the blocks
can be co-resident at any m (rows beyond 8 take further passes). The JAX
mono_layer takes a bf16 or int8 cache; an int4 cache raises ValueError.

`decode_step` composes a whole T=1 step of the model from these layer by
layer, the way the experiment ran when it was an engine option; no engine
path calls it (the JAX package retired the hooks).
"""

from __future__ import annotations

import ctypes
import math

import torch

from llama_cu_awq_torch.models.llama import (_cache_rows, _update_cache,
                                             final_logits)
from llama_cu_awq_torch.ops.cuda import (_build, check_tensor, count,
                                         require, stream_ptr, use_plain)
from llama_cu_awq_torch.ops.cuda.attention_step import (attention_step,
                                                        attention_step_plain,
                                                        kernel_takes,
                                                        rope_rows)
from llama_cu_awq_torch.ops.cuda.int4_matmul import (_SMEM_BUDGET,
                                                     _as_rows,
                                                     int4_matmul_fused_plain,
                                                     rows_per_pass,
                                                     staged_row_bytes)
from llama_cu_awq_torch.ops.linear import qmatmul_fused
from llama_cu_awq_torch.ops.norms import RMS_EPS
from llama_cu_awq_torch.quant.qtensor import QTensor

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# ffn_chain's arguments from res on: res, ffn_norm, 3 pointers each for
# W_o, W_gate_up, W_down, attn_norm and W_qkv', n_q, x1, gu, out, ss, qkv
_CHAIN_TAIL = [_P] * 15 + [_I] + [_P] * 5
_FFN_ARGS = [_P] + _CHAIN_TAIL + [_I, _I, _I, _I, _F, _I, _I, _I, _I, _P]
_MONO_ARGS = ([_P] * 13 + [_I] * 6 + _CHAIN_TAIL
              + [_I, _I, _F, _I, _I, _I, _I, _P])


def ffn_chain_supported(wo: QTensor, w_gate_up: QTensor, w_down: QTensor,
                        m: int, wqkv_next: QTensor | None = None) -> bool:
    """The kernel's own limits (not the JAX kernel's VMEM arithmetic): o's
    output feeds gate_up and the residual, down takes gate_up's SwiGLU half
    and gives the model width back, qkv' reads that width; every input
    width is a multiple of 32; one row of each stage's staging fits a
    block's shared memory, so the persistent blocks can be co-resident at
    any m >= 1."""
    tensors = (wo, w_gate_up, w_down) + (
        (wqkv_next,) if wqkv_next is not None else ())
    if not all(isinstance(t, QTensor) for t in tensors) or m < 1:
        return False
    dim, hid = wo.n_out, w_down.n_in
    if (w_gate_up.n_in != dim or w_gate_up.n_out != 2 * hid
            or w_down.n_out != dim
            or (wqkv_next is not None and wqkv_next.n_in != dim)):
        return False
    widths = (wo.n_in, dim, hid)
    return (all(n % 32 == 0 for n in widths)
            and max(staged_row_bytes(n) for n in widths) <= _SMEM_BUDGET)


def mono_supported(wo, w_gate_up, w_down, m, head_dim, attn_len, n_heads,
                   n_kv, wqkv_next=None) -> bool:
    """ffn_chain's limits, plus attention_step's head shapes (head_dim a
    multiple of 32 up to 256, at most 8 query heads per kv head; any
    window) with the attention rows as o's input."""
    return (ffn_chain_supported(wo, w_gate_up, w_down, m, wqkv_next)
            and kernel_takes(n_heads, n_kv, head_dim)
            and n_heads * head_dim == wo.n_in and attn_len >= 1)


def _check_chain(lead, n_attn, x_res, wo, w_gate_up, w_down, wqkv_next,
                 attn_norm_next, out_dtype):
    """The shapes and options both versions take (lead: the rows' leading
    shape, n_attn: the attention rows' width)."""
    m = math.prod(lead)
    require(n_attn == wo.n_in,
            f"the attention rows have width {n_attn}, W_o takes {wo.n_in}")
    require(tuple(x_res.shape) == (*lead, wo.n_out),
            f"x_res must be {(*lead, wo.n_out)}, got {tuple(x_res.shape)}")
    require((wqkv_next is None) == (attn_norm_next is None),
            "wqkv_next and attn_norm_next come together")
    require(out_dtype == torch.bfloat16,
            f"the chain's rows are bf16; out_dtype {out_dtype}")
    require(ffn_chain_supported(wo, w_gate_up, w_down, m, wqkv_next),
            f"ffn_chain cannot take o {wo.n_in}x{wo.n_out}, gate_up "
            f"{w_gate_up.n_in}x{w_gate_up.n_out}, down "
            f"{w_down.n_in}x{w_down.n_out}"
            + (f", qkv {wqkv_next.n_in}x{wqkv_next.n_out}"
               if wqkv_next is not None else "") + f" at m={m}")


def ffn_chain_plain(attn, x_res, ffn_norm, wo: QTensor, w_gate_up: QTensor,
                    w_down: QTensor, *, eps: float, wqkv_next=None,
                    attn_norm_next=None, out_dtype=torch.bfloat16):
    """The launch sequence the kernel replaces, in its plain versions:
    forward's _post_attention, then the next layer's qkv with the rmsnorm
    prologue."""
    x, ss = int4_matmul_fused_plain(attn, wo, residual=x_res,
                                    emit_ss_eps=eps, out_dtype=out_dtype)
    gu, _ = int4_matmul_fused_plain(x, w_gate_up, prescale=(ss, ffn_norm),
                                    out_dtype=torch.bfloat16)
    g, u = gu.chunk(2, dim=-1)
    x, ss = int4_matmul_fused_plain(g, w_down, silu_u=u, residual=x,
                                    emit_ss_eps=eps, out_dtype=out_dtype)
    if wqkv_next is None:
        return x, ss
    qkv, _ = int4_matmul_fused_plain(x, wqkv_next,
                                     prescale=(ss, attn_norm_next),
                                     out_dtype=out_dtype)
    return x, ss, qkv


def _check_weights(dev, *weights):
    for name, qt in weights:
        check_tensor(qt.qw, f"{name}.qw", torch.int32,
                     (qt.n_out, qt.n_in // 8), dev)
        check_tensor(qt.scales, f"{name}.scales", torch.float16,
                     (qt.n_out, qt.n_groups), dev)
        check_tensor(qt.zeros, f"{name}.zeros", torch.uint8,
                     (qt.n_out, qt.n_groups), dev)


def _chain_tail(x_res, ffn_norm, wo, w_gate_up, w_down, wqkv_next,
                attn_norm_next, m, eps):
    """Checks and allocates what both launchers take from res on; returns
    (C arguments from res to qkv, the trailing ints and floats, outputs)."""
    dev = x_res.device
    dim, hid = wo.n_out, w_down.n_in
    has_qkv = wqkv_next is not None
    weights = [("wo", wo), ("w_gate_up", w_gate_up), ("w_down", w_down)]
    if has_qkv:
        weights.append(("wqkv_next", wqkv_next))
    _check_weights(dev, *weights)
    res = x_res.to(torch.bfloat16).reshape(m, dim).contiguous()
    check_tensor(res, "x_res", torch.bfloat16, (m, dim), dev)
    nw = ffn_norm.reshape(dim).float().contiguous()
    check_tensor(nw, "ffn_norm", torch.float32, (dim,), dev)
    nw2 = None
    if has_qkv:
        nw2 = attn_norm_next.reshape(dim).float().contiguous()
        check_tensor(nw2, "attn_norm_next", torch.float32, (dim,), dev)
    n_q = wqkv_next.n_out if has_qkv else 0

    def empty(*shape, dtype=torch.bfloat16):
        return torch.empty(*shape, dtype=dtype, device=dev)

    x1, gu, out = empty(m, dim), empty(m, 2 * hid), empty(m, dim)
    ss = empty(m, dtype=torch.float32)
    qkv = empty(m, n_q) if has_qkv else None

    def ptr(t):
        return t.data_ptr() if t is not None else None

    def w(qt):
        if qt is None:
            return [None] * 3
        return [qt.qw.data_ptr(), qt.scales.data_ptr(), qt.zeros.data_ptr()]

    args = ([res.data_ptr(), nw.data_ptr()] + w(wo) + w(w_gate_up)
            + w(w_down) + [ptr(nw2)] + w(wqkv_next)
            + [n_q, x1.data_ptr(), gu.data_ptr(), out.data_ptr(),
               ss.data_ptr(), ptr(qkv)])
    rpp = [rows_per_pass(m, wo.n_in), rows_per_pass(m, dim),
           rows_per_pass(m, hid), rows_per_pass(m, dim)]
    return args, [dim, hid, float(eps)] + rpp, (out, ss, qkv)


def _chain_variant(m, wo, w_down, wqkv_next) -> str:
    qkv = f"+qkv{wqkv_next.n_out}" if wqkv_next is not None else ""
    return f"m{m}/{wo.n_in}x{wo.n_out}/hid{w_down.n_in}{qkv}"


def ffn_chain(attn: torch.Tensor, x_res: torch.Tensor,
              ffn_norm: torch.Tensor, wo: QTensor, w_gate_up: QTensor,
              w_down: QTensor, *, eps: float, wqkv_next: QTensor | None = None,
              attn_norm_next: torch.Tensor | None = None,
              out_dtype=torch.bfloat16, plain: bool = False):
    """The inter-attention chain of one decoder layer in one launch.

    attn: (..., n_o) attention rows; x_res: (..., dim) bf16 residual
    stream; ffn_norm: (dim,) f32. Returns (x_out (..., dim) bf16, ss
    (..., 1) f32[, qkv_next (..., n_out) bf16 when wqkv_next is given,
    with attn_norm_next (dim,) f32]): the contract of the JAX ffn_chain.
    """
    lead = tuple(attn.shape[:-1])
    m = math.prod(lead)
    _check_chain(lead, attn.shape[-1], x_res, wo, w_gate_up, w_down,
                 wqkv_next, attn_norm_next, out_dtype)
    if use_plain(attn, plain):
        return ffn_chain_plain(attn, x_res, ffn_norm, wo, w_gate_up, w_down,
                               eps=eps, wqkv_next=wqkv_next,
                               attn_norm_next=attn_norm_next,
                               out_dtype=out_dtype)
    a2 = _as_rows(attn, m, wo.n_in).contiguous()
    tail, nums, (out, ss, qkv) = _chain_tail(
        x_res, ffn_norm, wo, w_gate_up, w_down, wqkv_next, attn_norm_next,
        m, eps)
    dim, hid, eps_f, *rpp = nums
    fn = _build.function("int4_chain", "ffn_chain", _FFN_ARGS)
    rc = fn(a2.data_ptr(), *tail, m, wo.n_in, dim, hid, eps_f, *rpp,
            stream_ptr())
    _build.check(rc, "int4_chain", "ffn_chain")
    count("ffn_chain", _chain_variant(m, wo, w_down, wqkv_next))
    outs = (out.reshape(*lead, dim), ss.reshape(*lead, 1))
    if qkv is None:
        return outs
    return outs + (qkv.reshape(*lead, wqkv_next.n_out),)


def mono_layer_plain(qkv, x_res, ffn_norm, wo, w_gate_up, w_down, k_cache,
                     v_cache, pos, cos2, sinm, k_scale=None, v_scale=None, *,
                     n_heads: int, win: int, eps: float, wqkv_next=None,
                     attn_norm_next=None):
    """attention_step's plain version over the window's rows, walked
    unsplit as the kernel's attention stage walks them (split=False), its
    rows rounded to bf16, then ffn_chain's plain version."""
    B = qkv.shape[0]

    def window(t):
        return t[:, :win] if t is not None else None

    attn, kn, vn, ksn, vsn = attention_step_plain(
        qkv, window(k_cache), window(v_cache), pos, cos2, sinm,
        window(k_scale), window(v_scale), n_heads=n_heads, split=False)
    chain = ffn_chain_plain(attn.reshape(B, -1).to(torch.bfloat16), x_res,
                            ffn_norm, wo, w_gate_up, w_down, eps=eps,
                            wqkv_next=wqkv_next,
                            attn_norm_next=attn_norm_next)
    return chain[:2] + (kn, vn, ksn, vsn) + chain[2:]


def mono_layer(qkv, x_res, ffn_norm, wo, w_gate_up, w_down, k_cache,
               v_cache, pos, cos2, sinm, k_scale=None, v_scale=None, *,
               n_heads: int, attn_len: int | None = None, eps: float,
               wqkv_next=None, attn_norm_next=None,
               out_dtype=torch.bfloat16, plain: bool = False):
    """One decoder layer, minus the cache row scatters, in one launch.

    qkv: (B, (H + 2*Hkv)*D) bf16, this layer's projection row (the previous
    layer's qkv_next). k_cache/v_cache: (B, S, Hkv, D) bf16, or int8 codes
    with k_scale/v_scale (B, S, Hkv) f32; rows below min(pos[b], attn_len)
    are history. pos: (B,) int32; cos2/sinm: (B, D) f32 from rope_rows;
    x_res: (B, dim) bf16. Returns (x_out (B, dim) bf16, ss (B, 1) f32,
    k_new (B, Hkv, D), v_new, k_s, v_s[, qkv_next (B, n_out) bf16]), k_s
    and v_s (B, Hkv) f32 or None for a bf16 cache: the JAX mono_layer's
    contract. The new rows are not written to the cache.
    """
    B = qkv.shape[0]
    _, S, n_kv, D = k_cache.shape
    H = n_heads
    quantized = k_scale is not None
    # the int4 cache keeps head_dim / 2 bytes a row (quant/kv.py)
    require(not (quantized and 2 * H * D == wo.n_in),
            "mono_layer takes a bf16 or int8 KV cache, as the JAX "
            "mono_layer does; this is the int4 cache (kv_bits=4)")
    win = min(attn_len or S, S)
    require(mono_supported(wo, w_gate_up, w_down, B, D, win, H, n_kv,
                           wqkv_next),
            f"mono_layer cannot take n_heads={H}, n_kv={n_kv}, "
            f"head_dim={D} with o {wo.n_in}x{wo.n_out}, gate_up "
            f"{w_gate_up.n_in}x{w_gate_up.n_out}, down "
            f"{w_down.n_in}x{w_down.n_out} at B={B}")
    _check_chain((B,), H * D, x_res, wo, w_gate_up, w_down, wqkv_next,
                 attn_norm_next, out_dtype)
    if use_plain(qkv, plain):
        return mono_layer_plain(
            qkv, x_res, ffn_norm, wo, w_gate_up, w_down, k_cache, v_cache,
            pos, cos2, sinm, k_scale, v_scale, n_heads=H, win=win, eps=eps,
            wqkv_next=wqkv_next, attn_norm_next=attn_norm_next)
    dev = qkv.device
    kv_dtype = torch.int8 if quantized else torch.bfloat16
    check_tensor(qkv, "qkv", torch.bfloat16, (B, (H + 2 * n_kv) * D), dev)
    check_tensor(k_cache, "k_cache", kv_dtype, (B, S, n_kv, D), dev)
    check_tensor(v_cache, "v_cache", kv_dtype, (B, S, n_kv, D), dev)
    if quantized:
        check_tensor(k_scale, "k_scale", torch.float32, (B, S, n_kv), dev)
        check_tensor(v_scale, "v_scale", torch.float32, (B, S, n_kv), dev)
    check_tensor(pos, "pos", torch.int32, (B,), dev)
    check_tensor(cos2, "cos2", torch.float32, (B, D), dev)
    check_tensor(sinm, "sinm", torch.float32, (B, D), dev)
    rows = torch.empty(B, H * D, dtype=torch.bfloat16, device=dev)
    k_new = torch.empty(B, n_kv, D, dtype=kv_dtype, device=dev)
    v_new = torch.empty(B, n_kv, D, dtype=kv_dtype, device=dev)
    ks_new = vs_new = None
    if quantized:
        ks_new = torch.empty(B, n_kv, dtype=torch.float32, device=dev)
        vs_new = torch.empty(B, n_kv, dtype=torch.float32, device=dev)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    tail, nums, (out, ss, qkv_next) = _chain_tail(
        x_res, ffn_norm, wo, w_gate_up, w_down, wqkv_next, attn_norm_next,
        B, eps)
    fn = _build.function("int4_chain", "mono_layer", _MONO_ARGS)
    rc = fn(qkv.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            ptr(k_scale), ptr(v_scale), pos.data_ptr(), cos2.data_ptr(),
            sinm.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            ptr(ks_new), ptr(vs_new), rows.data_ptr(), B, H, n_kv, D, S, win,
            *tail, *nums, stream_ptr())
    _build.check(rc, "int4_chain", "mono_layer")
    fmt = "int8" if quantized else "bf16"
    count("mono_layer", f"{fmt}/B{B}/H{H}/kv{n_kv}/D{D}/"
          + _chain_variant(B, wo, w_down, wqkv_next))
    outs = (out, ss.reshape(B, 1), k_new, v_new, ks_new, vs_new)
    return outs if qkv_next is None else outs + (qkv_next,)


LAYER_IMPLS = ("ffn_chain", "mono")


def decode_step(params, cfg, tokens: torch.Tensor, pos: torch.Tensor,
                cache, *, layer_impl: str, attn_len: int | None = None,
                plain: bool = False):
    """One T=1 step of the whole model, layer by layer through this module:
    layer 0's qkv projection standalone, then in every layer either
    attention_step and ffn_chain ("ffn_chain") or mono_layer ("mono"),
    each carrying the next layer's qkv row, the new cache rows scattered
    as forward scatters them, and forward's final norm and head.

    tokens: (B, 1); pos: (B,) int32; cache: a bf16 or int8 KVCache,
    updated in place. attn_len: the window (default the cache). On the
    card the "ffn_chain" logits equal forward(attn_impl="fused_step")'s bit
    for bit (the same sums in the same order); "mono" walks attention
    unsplit and agrees with them to bf16 rounding of p. Returns (logits
    (B, vocab) f32, cache)."""
    require(layer_impl in LAYER_IMPLS, f"layer_impl must be one of "
            f"{LAYER_IMPLS}, got {layer_impl!r}")
    B, T = tokens.shape
    require(T == 1, f"decode_step takes one token a slot, got T={T}")
    H, D = cfg.n_heads, cfg.head_dim
    require(not (cache.quantized and cache.k[0].shape[-1] == D // 2),
            "decode_step takes a bf16 or int8 KV cache, as the JAX "
            "mono_layer does; this is the int4 cache (kv_bits=4)")
    layers = params.layers
    act = torch.bfloat16
    x = params.embed[tokens.long()].to(act)
    xf = x.float()
    ss = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + RMS_EPS)
    rows = _cache_rows(pos[:, None].long(), cache.k[0].shape[1])
    cos2, sinm = rope_rows(pos, D, cfg.rope_theta)
    qkv, _ = qmatmul_fused(x, layers[0].wqkv, plain,
                           prescale=(ss, layers[0].attn_norm),
                           out_dtype=act)
    qkv, x = qkv[:, 0], x[:, 0]
    for l, layer in enumerate(layers):
        nxt = layers[l + 1] if l + 1 < len(layers) else None
        ks_l = cache.k_scale[l] if cache.quantized else None
        vs_l = cache.v_scale[l] if cache.quantized else None
        chain_kw = dict(eps=RMS_EPS, plain=plain,
                        wqkv_next=nxt.wqkv if nxt else None,
                        attn_norm_next=nxt.attn_norm if nxt else None)
        if layer_impl == "mono":
            outs = mono_layer(qkv, x, layer.ffn_norm, layer.wo,
                              layer.w_gate_up, layer.w_down, cache.k[l],
                              cache.v[l], pos, cos2, sinm, ks_l, vs_l,
                              n_heads=H, attn_len=attn_len, **chain_kw)
            x, ss, kn, vn, ksn, vsn = outs[:6]
        else:
            attn, kn, vn, ksn, vsn = attention_step(
                qkv, cache.k[l], cache.v[l], pos, cos2, sinm, ks_l, vs_l,
                n_heads=H, attn_len=attn_len, plain=plain)
            outs = ffn_chain(attn.reshape(B, H * D).to(act), x,
                             layer.ffn_norm, layer.wo, layer.w_gate_up,
                             layer.w_down, **chain_kw)
            x, ss = outs[:2]
        _update_cache(cache.k[l], kn[:, None], rows)
        _update_cache(cache.v[l], vn[:, None], rows)
        if cache.quantized:
            _update_cache(ks_l, ksn[:, None], rows)
            _update_cache(vs_l, vsn[:, None], rows)
        if nxt is not None:
            qkv = outs[-1]
    return final_logits(params, x[:, None], ss[:, None], act, False,
                        plain), cache
