"""One decode attention step from the fused qkv row.

Counterpart of llama_cu_awq_tpu/ops/pallas/attention_step.py
(`attention_step` for the bf16 and int8 cache, `_attention_step_kv4` for
the int4 one): split q|k|v, RoPE with the `rope_rows` factors, bf16
rounding of the rotated q and k, optional quantization of the new k/v row
(quant/kv.py: int8, or int4 packed in halves), then GQA attention over the
cache rows below min(pos[b], attn_len) plus the current token. A quantized
row enters the softmax as codes, the way a later step reads it back;
scales fold into the scores (k) and into p (v).

The kernels are in `csrc/attention_step.cu` (+ `decode_attention.cuh`):
the window split across blocks (flash-decoding). What bounds them is the
cache bytes, 24.6 MB a layer at 7B with a bf16 cache at position 1500
(7.35 us at 3.35 TB/s); one block per (slot, kv head) left most of the
card idle, so the grid is (splits, kv heads, slots), a split SPLIT_ROWS
history rows. Each split takes one max over its scores, p = exp(s - m)
rounded to bf16 (after the v scale) before the PV product, and its sum l;
split 0 visits the current token first, as the JAX kernel does (its p is
1, the split's max starts at its score); the last block of a (slot, kv
head) combines the splits in order: M = max m_i, L = sum l_i * exp(m_i -
M), out = sum acc_i * exp(m_i - M) / L. The split length is fixed, so a
slot's result depends only on its own position and cache, never on the
batch. The plain version walks the same splits (`online_partial` for
split 0, `split_partial` and `combine_splits`, the last two shared with
batched_attention.py), so kernel and plain version differ only in the
order of f32 sums.

`split=False` walks the window in one online softmax, the current token
first and then chunks of CHUNK rows, p rounded against the running max:
the unsplit walk of mono_layer's attention stage (csrc/attention_step.cuh
attention_item), which experiments/int4_chain.py's plain version runs.
(The JAX kernel walks blocks of its own size; against it both walks agree
to bf16 rounding of p.)
"""

from __future__ import annotations

import ctypes

import torch

from llama_cu_awq_torch.ops.cuda import (_build, attn_scale, check_tensor,
                                         count, require, stream_ptr,
                                         use_plain)
from llama_cu_awq_torch.ops.rope import rope_angles
from llama_cu_awq_torch.quant.kv import kv4_values, quantize_kv, quantize_kv4

# history rows of a split: SPLIT_ROWS in csrc/decode_attention.cuh, a
# compile-time constant there (tests/test_torch_decode_split.py holds the
# two equal), chosen among 64, 128 and 256 by timing on the H100 (PERF.md)
SPLIT_ROWS = 128
CHUNK = 64  # the unsplit walk's chunk (CHUNK in csrc/attention_step.cuh)
_NEG = -1e30
# per (device, stream): (f32 partials, int32 arrival counters) of the
# split kernels
_SCRATCH: dict[tuple[torch.device, int],
               tuple[torch.Tensor, torch.Tensor]] = {}
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = [_P] * 16 + [_I] * 6 + [_P]


def split_scratch(dev, B: int, n_kv: int, kv_mul: int, D: int, win: int):
    """Pointers to the split kernels' scratch for a launch over a window
    of `win` rows on the current stream: the (m, l) partials, the acc
    partials and the arrival counters, which read zero between launches
    (the last block of each (slot, kv head) resets its own). Kept per
    (device, stream), so launches that share a scratch run in order, and
    grown on demand. Growing frees the old tensors, so it is refused while
    the stream is being captured into a CUDA graph: a graph must find its
    scratch sized, for its largest batch and window, before capture."""
    n = B * n_kv * n_splits(win) * kv_mul
    key = (dev, stream_ptr())
    part, counters = _SCRATCH.get(key, (None, None))
    grow_part = part is None or part.numel() < n * (D + 2)
    grow_counters = counters is None or counters.numel() < B * n_kv
    if grow_part or grow_counters:
        require(not torch.cuda.is_current_stream_capturing(),
                "the split kernels' scratch must be sized before a CUDA "
                "graph capture (a launch larger than any before it)")
    if grow_part:
        part = torch.empty(n * (D + 2), dtype=torch.float32, device=dev)
    if grow_counters:
        counters = torch.zeros(B * n_kv, dtype=torch.int32, device=dev)
    _SCRATCH[key] = (part, counters)
    return (part.data_ptr(), part.data_ptr() + 4 * 2 * n,
            counters.data_ptr())


def kernel_takes(n_heads: int, n_kv: int, head_dim: int) -> bool:
    """Whether csrc/attention_step.cu takes these head shapes (any cache
    length, every cache format): head_dim a multiple of 32 up to 256, at
    most 8 query heads per kv head."""
    return (head_dim % 32 == 0 and head_dim <= 256 and n_heads % n_kv == 0
            and n_heads // n_kv <= 8)


def rope_rows(pos: torch.Tensor, head_dim: int, theta: float):
    """Per-step rope factor rows: (cos2, sinm), each (B, head_dim) f32
    with cos2 = [cos|cos] and sinm = [-sin|sin]."""
    cos, sin = rope_angles(pos, head_dim, theta)
    return torch.cat([cos, cos], dim=-1), torch.cat([-sin, sin], dim=-1)


def n_splits(rows: int) -> int:
    """Splits of a slot with `rows` rows to attend (at least one)."""
    return max(1, -(-rows // SPLIT_ROWS))


def split_partial(qg, kblk, vblk, ks_rows, vs_rows, scale, live=None):
    """One split of the split kernels: qg (G, M, D) f32 queries of G kv
    heads, kblk/vblk (G, R, D) f32 row values, ks_rows/vs_rows (G, R)
    scales or None, live (R,) bool or None (masked rows score -1e30 and get
    p = 0). Returns (m, l, acc): the split's max (G, M), sum of p and
    bf16-p @ v (G, M, D)."""
    raw = torch.einsum("gmd,grd->gmr", qg, kblk)
    if ks_rows is not None:
        raw = raw * ks_rows[:, None, :]
    sc = raw * scale
    if live is not None:
        sc = torch.where(live, sc, torch.full_like(sc, _NEG))
    m = sc.amax(-1)
    p = torch.exp(sc - m[..., None])
    if live is not None:
        p = torch.where(live, p, torch.zeros_like(p))
    l = p.sum(-1)
    if vs_rows is not None:
        p = p * vs_rows[:, None, :]
    acc = torch.einsum("gmr,grd->gmd", p.to(torch.bfloat16).float(), vblk)
    return m, l, acc


def combine_splits(parts):
    """The split kernels' combine of a slot's [(m, l, acc)] in split
    order: splits with l = 0 (every row masked) stay out of the max M, then
    L = sum l_i * w_i and A = sum acc_i * w_i with w_i = exp(m_i - M), each
    product and sum rounded on its own; A / L."""
    ms = torch.stack([m for m, _, _ in parts])
    ls = torch.stack([l for _, l, _ in parts])
    M = torch.where(ls > 0, ms, torch.full_like(ms, _NEG)).amax(0)
    L = torch.zeros_like(M)
    A = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        w = torch.where(l > 0, torch.exp(m - M), torch.zeros_like(m))
        L = L + l * w
        A = A + acc * w[..., None]
    return A / L[..., None]


def online_partial(qg, blocks, scale):
    """The online softmax over [(k, v, ks, vs)] blocks in order: each
    block's p rounds to bf16 against the running max, and the sums rescale
    by alpha = exp(m_old - m_new). Returns (m, l, acc). attention_step's
    split 0 is this over the current token and the split's rows; the
    unsplit walk over the current token and chunks of CHUNK rows."""
    G, M, D = qg.shape
    m = torch.full((G, M), _NEG, device=qg.device)
    l = torch.zeros(G, M, device=qg.device)
    acc = torch.zeros(G, M, D, device=qg.device)
    for kblk, vblk, ks_rows, vs_rows in blocks:
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
        pv = torch.einsum("gmr,grd->gmd", p.to(torch.bfloat16).float(), vblk)
        acc = acc * alpha[..., None] + pv
    return m, l, acc


def attention_step_plain(qkv, k_cache, v_cache, pos, cos2, sinm,
                         k_scale=None, v_scale=None, *, n_heads: int,
                         kv_bits: int = 8, attn_len: int | None = None,
                         split: bool = True):
    """The kernel's arithmetic in PyTorch (see the module docstring);
    split=False walks the window unsplit, as mono_layer's kernel does."""
    B = qkv.shape[0]
    _, S, n_kv, Dc = k_cache.shape
    kv4 = kv_bits == 4
    D = 2 * Dc if kv4 else Dc
    H = n_heads
    kv_mul = H // n_kv
    half = D // 2
    win = min(attn_len or S, S)
    quantized = k_scale is not None
    scale = attn_scale(D)
    q = qkv[:, :H * D].float().reshape(B, H, D)
    k = qkv[:, H * D:(H + n_kv) * D].float().reshape(B, n_kv, D)
    v_bf = qkv[:, (H + n_kv) * D:].to(torch.bfloat16).reshape(B, n_kv, D)
    c, s = cos2.float()[:, None, :], sinm.float()[:, None, :]

    def rope(x):
        return x * c + torch.roll(x, half, dims=-1) * s

    q_bf = rope(q).to(torch.bfloat16).float()
    k_bf = rope(k).to(torch.bfloat16)
    # a row's values as the softmax sees them: codes for a quantized
    # cache, the current row through the same unpack as a cached one
    values = kv4_values if kv4 else torch.Tensor.float
    if quantized:
        quantize = quantize_kv4 if kv4 else quantize_kv
        k_new, ks_new = quantize(k_bf)
        v_new, vs_new = quantize(v_bf)
    else:
        k_new, v_new, ks_new, vs_new = k_bf, v_bf, None, None
    kcur, vcur = values(k_new), values(v_new)

    def rows(b, r0, r1):
        """Rows r0..r1-1 of slot b: k and v as (n_kv, rows, D) f32 values,
        their scales (n_kv, rows) or None."""
        kv = [values(cache[b, r0:r1]).transpose(0, 1)
              for cache in (k_cache, v_cache)]
        sc = [x[b, r0:r1].T if quantized else None
              for x in (k_scale, v_scale)]
        return (*kv, *sc)

    attn = torch.empty(B, H, D, dtype=torch.float32, device=qkv.device)
    for b in range(B):
        qg = q_bf[b].reshape(n_kv, kv_mul, D)
        n_hist = min(int(pos[b]), win)
        cur = (kcur[b][:, None, :], vcur[b][:, None, :],
               ks_new[b][:, None] if quantized else None,
               vs_new[b][:, None] if quantized else None)
        if split:
            # split 0 visits the current token first, the later splits
            # take their own max
            first = [cur] + ([rows(b, 0, min(SPLIT_ROWS, n_hist))]
                             if n_hist else [])
            parts = [online_partial(qg, first, scale)] + [
                split_partial(qg, *rows(b, r0, min(r0 + SPLIT_ROWS, n_hist)),
                              scale)
                for r0 in range(SPLIT_ROWS, n_hist, SPLIT_ROWS)]
            out = combine_splits(parts)
        else:
            _, l, acc = online_partial(qg, [cur] + [
                rows(b, r0, min(r0 + CHUNK, n_hist))
                for r0 in range(0, n_hist, CHUNK)], scale)
            out = acc / l[..., None]
        attn[b] = out.reshape(H, D)
    return attn, k_new, v_new, ks_new, vs_new


def attention_step(qkv, k_cache, v_cache, pos, cos2, sinm, k_scale=None,
                   v_scale=None, *, n_heads: int, kv_bits: int = 8,
                   attn_len: int | None = None, plain: bool = False):
    """qkv: (B, (H + 2*Hkv)*D) bf16, laid out [q | k | v] as the fused
    qkv matmul emits it. k_cache/v_cache: (B, S, Hkv, D) bf16, or int8
    codes with k_scale/v_scale (B, S, Hkv) f32; with kv_bits=4 the codes
    are packed (B, S, Hkv, D//2) int8 (quant/kv.py) and the scales are
    required. The cache is read-only history: rows below min(pos[b],
    attn_len) are read (attn_len, the window, defaults to the cache's
    length). pos: (B,) int32. cos2/sinm: (B, D) f32 from rope_rows.

    Returns (attn (B, H, D) f32, k_new (B, Hkv, D) in the cache dtype,
    or (B, Hkv, D//2) packed with kv_bits=4, v_new, k_s, v_s) with
    k_s/v_s (B, Hkv) f32 scales, None unless quantized. The caller writes
    the new row into the cache at pos[b].
    """
    if kv_bits not in (4, 8):
        raise ValueError(f"kv_bits must be 4 or 8, got {kv_bits}")
    kv4 = kv_bits == 4
    if kv4 and k_scale is None:
        raise ValueError("kv_bits=4 needs k_scale and v_scale")
    if use_plain(qkv, plain):
        return attention_step_plain(qkv, k_cache, v_cache, pos, cos2, sinm,
                                    k_scale, v_scale, n_heads=n_heads,
                                    kv_bits=kv_bits, attn_len=attn_len)
    B = qkv.shape[0]
    _, S, n_kv, Dc = k_cache.shape
    D = 2 * Dc if kv4 else Dc
    H = n_heads
    dev = qkv.device
    quantized = k_scale is not None
    kv_dtype = torch.int8 if quantized else torch.bfloat16
    require(kernel_takes(H, n_kv, D),
            f"the kernel cannot take n_heads={H}, n_kv={n_kv}, head_dim={D}")
    check_tensor(qkv, "qkv", torch.bfloat16, (B, (H + 2 * n_kv) * D), dev)
    check_tensor(k_cache, "k_cache", kv_dtype, (B, S, n_kv, Dc), dev)
    check_tensor(v_cache, "v_cache", kv_dtype, (B, S, n_kv, Dc), dev)
    if quantized:
        check_tensor(k_scale, "k_scale", torch.float32, (B, S, n_kv), dev)
        check_tensor(v_scale, "v_scale", torch.float32, (B, S, n_kv), dev)
    require(k_cache.data_ptr() % 16 == 0 and v_cache.data_ptr() % 16 == 0,
            "the caches must start 16-byte aligned (the kernel's vector "
            "loads)")
    check_tensor(pos, "pos", torch.int32, (B,), dev)
    check_tensor(cos2, "cos2", torch.float32, (B, D), dev)
    check_tensor(sinm, "sinm", torch.float32, (B, D), dev)
    attn = torch.empty(B, H, D, dtype=torch.float32, device=dev)
    k_new = torch.empty(B, n_kv, Dc, dtype=kv_dtype, device=dev)
    v_new = torch.empty(B, n_kv, Dc, dtype=kv_dtype, device=dev)
    ks_new = vs_new = None
    if quantized:
        ks_new = torch.empty(B, n_kv, dtype=torch.float32, device=dev)
        vs_new = torch.empty(B, n_kv, dtype=torch.float32, device=dev)

    win = min(attn_len or S, S)
    scratch = split_scratch(dev, B, n_kv, H // n_kv, D, win)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    name = "attention_step_kv4" if kv4 else "attention_step"
    fn = _build.function("attention_step", name, _ARGS)
    rc = fn(qkv.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            ptr(k_scale), ptr(v_scale), pos.data_ptr(), cos2.data_ptr(),
            sinm.data_ptr(), attn.data_ptr(), k_new.data_ptr(),
            v_new.data_ptr(), ptr(ks_new), ptr(vs_new), *scratch, B, H,
            n_kv, D, S, win, stream_ptr())
    _build.check(rc, "attention_step", name)
    fmt = "int4" if kv4 else "int8" if quantized else "bf16"
    count(name, f"{fmt}/B{B}/H{H}/kv{n_kv}/D{D}")
    return attn, k_new, v_new, ks_new, vs_new
