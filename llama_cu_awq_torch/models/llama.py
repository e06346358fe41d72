"""Llama-2 forward pass over packed w4-g128 weights, in PyTorch.

The counterpart of llama_cu_awq_tpu/models/llama.py: embedding ->
N x [rmsnorm, fused-qkv matmul, RoPE, GQA attention over the KV cache,
o-proj + residual, rmsnorm, fused gate/up + SiLU, down-proj + residual]
-> final rmsnorm -> lm_head. The rmsnorm apply, SwiGLU and residual adds
run inside the int4 kernels, and the rms scale chains from one kernel's
epilogue to the next one's prologue (the JAX package's fused=True path).
Activations, the residual stream and the unquantized KV cache are in
act_dtype (bf16 by default; fp16 or f32 with --act-dtype); accumulations
and the softmax are f32, and every kernel's MMA operands are bf16, as the
JAX kernels cast theirs.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from llama_cu_awq_torch.config import ModelConfig
from llama_cu_awq_torch.device import resolve_device
from llama_cu_awq_torch.io.checkpoint import RawCheckpoint, RawQWeight
from llama_cu_awq_torch.ops.cuda import batched_attention as bda
from llama_cu_awq_torch.ops.cuda import down_qkv as dq
from llama_cu_awq_torch.ops.cuda import prefill_attention as pfa
from llama_cu_awq_torch.ops.cuda.attention_step import (attention_step,
                                                        kernel_takes,
                                                        rope_rows)
from llama_cu_awq_torch.ops.linear import dense_matmul, qmatmul, qmatmul_fused
from llama_cu_awq_torch.ops.norms import RMS_EPS
from llama_cu_awq_torch.ops.rope import apply_rope, rope_angles
from llama_cu_awq_torch.parallel.mesh import (TPGroup, all_gather_last,
                                              all_reduce_sum)
from llama_cu_awq_torch.quant.int8 import Int8Dense, quantize_dense_int8
from llama_cu_awq_torch.quant.kv import quantize_kv, quantize_kv4, unpack_kv4
from llama_cu_awq_torch.quant.qtensor import QTensor

# attn_impl "auto": plain attention below this window, the attention_step
# kernel at and above it (the JAX package's rule, models/llama.py:605-608)
FSTEP_MIN_WINDOW = 1024
# blocks of at least this many tokens take the prefill_attention kernel;
# smaller T > 1 blocks take plain attention (the JAX package's
# LLAMA_TPU_PFK_MIN_T default, models/llama.py:650)
PFK_MIN_T = 64


@dataclasses.dataclass
class LlamaLayer:
    """One decoder layer; wqkv is q|k|v along n_out, w_gate_up gate|up."""

    attn_norm: torch.Tensor  # (dim,) f32
    ffn_norm: torch.Tensor   # (dim,) f32
    wqkv: QTensor            # (dim, dim + 2*kv_dim)
    wo: QTensor              # (dim, dim)
    w_gate_up: QTensor       # (dim, 2*hidden)
    w_down: QTensor          # (hidden, dim)


@dataclasses.dataclass
class LlamaParams:
    embed: torch.Tensor      # (vocab, dim) bf16
    lm_head: object          # (vocab, dim) bf16 | Int8Dense | QTensor
    final_norm: torch.Tensor  # (dim,) f32
    layers: list             # [LlamaLayer]

    @property
    def device(self) -> torch.device:
        return self.embed.device


@dataclasses.dataclass
class KVCache:
    """Per-layer lists of (B, max_seq, n_kv_heads, head_dim) buffers in the
    activation type (bf16, fp16 or f32), or int8 codes with (B, max_seq, n_kv_heads) f32 scales (symmetric
    per-vector, quant/kv.py), or int4 codes packed two to a byte,
    (B, max_seq, n_kv_heads, head_dim // 2) int8, with the same scales.
    A last dim of head_dim // 2 is how forward tells the int4 cache."""

    k: list
    v: list
    k_scale: list = dataclasses.field(default_factory=list)
    v_scale: list = dataclasses.field(default_factory=list)

    @property
    def quantized(self) -> bool:
        return bool(self.k_scale)


def init_kv_cache(cfg: ModelConfig, batch: int, max_seq: int,
                  dtype=torch.bfloat16, quantized: bool = False,
                  kv_bits: int = 8, device="cuda",
                  n_kv_heads: int | None = None) -> KVCache:
    """n_kv_heads: the heads a rank holds under tensor parallelism
    (parallel/tp.py tp_init_kv_cache), default all of cfg's."""
    dev = resolve_device(device)
    if kv_bits not in (4, 8):
        raise ValueError(f"kv_bits must be 4 or 8, got {kv_bits}")
    shape = (batch, max_seq, n_kv_heads or cfg.n_kv_heads, cfg.head_dim)
    n = cfg.n_layers
    if not quantized:
        return KVCache([torch.zeros(shape, dtype=dtype, device=dev)
                        for _ in range(n)],
                       [torch.zeros(shape, dtype=dtype, device=dev)
                        for _ in range(n)])
    sshape = shape[:-1]
    if kv_bits == 4:
        shape = sshape + (cfg.head_dim // 2,)

    def zeros(s, dt):
        return [torch.zeros(s, dtype=dt, device=dev) for _ in range(n)]

    return KVCache(zeros(shape, torch.int8), zeros(shape, torch.int8),
                   zeros(sshape, torch.float32), zeros(sshape, torch.float32))


# ---------------------------------------------------------------------------
# parameter construction

def _fuse_q(row: list[RawQWeight], device) -> QTensor:
    qw = np.concatenate([r.qw for r in row], axis=1)
    zeros = np.concatenate([r.zeros for r in row], axis=1)
    scales = np.concatenate([r.scales for r in row], axis=1)
    return QTensor.from_numpy(qw, zeros, scales, row[0].n_in, device)


def params_from_checkpoint(ckpt: RawCheckpoint, device="cuda",
                           param_dtype=torch.bfloat16) -> LlamaParams:
    """Device-resident params from a loaded `.bin` checkpoint. embed and
    lm_head are stored in param_dtype: bf16 (the dense_gemv kernel's type)
    or f32, or with None the checkpoint's fp16 bits as they are (the JAX
    function's None, models/llama.py:211-223; what --act-dtype float16
    asks for). Norm weights are f32."""
    dev = resolve_device(device)

    def dense(a, dtype):
        # widened on the device: numpy's fp16 -> f32 is the slow part of
        # a 7B load
        t = torch.from_numpy(np.array(a)).to(dev)
        return t if dtype is None else t.float().to(dtype)

    layers = [
        LlamaLayer(
            attn_norm=dense(l.attn_norm, torch.float32),
            ffn_norm=dense(l.ffn_norm, torch.float32),
            wqkv=_fuse_q([l.wq, l.wk, l.wv], dev),
            wo=_fuse_q([l.wo], dev),
            w_gate_up=_fuse_q([l.w_gate, l.w_up], dev),
            w_down=_fuse_q([l.w_down], dev),
        )
        for l in ckpt.layers
    ]
    return LlamaParams(dense(ckpt.embed, param_dtype),
                       dense(ckpt.lm_head, param_dtype),
                       dense(ckpt.final_norm, torch.float32), layers)


def synthetic_params(cfg: ModelConfig, seed: int = 0,
                     device="cuda") -> LlamaParams:
    """Random weights generated on the device from a torch.Generator
    (benchmarks at full width without a checkpoint): uniform nibbles,
    zero point 8, fp16 scales 0.01*(1 + 0.1 N(0,1)), bf16 embed/lm_head
    0.02 N(0,1), unit norms."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    dim, kv, hid, vocab = cfg.dim, cfg.kv_dim, cfg.hidden_dim, cfg.vocab_size

    def q(n_in, n_out):
        groups = -(-n_in // 128)
        qw = torch.randint(0, 256, (n_out, -(-n_in // 8) * 4),
                           dtype=torch.uint8, device=dev,
                           generator=g).view(torch.int32)
        scales = (0.01 * (1.0 + 0.1 * torch.randn(
            n_out, groups, device=dev, generator=g))).to(torch.float16)
        zeros = torch.full((n_out, groups), 8, dtype=torch.uint8, device=dev)
        return QTensor(qw, scales, zeros, n_in, n_out)

    def layer():
        return LlamaLayer(
            attn_norm=torch.ones(dim, device=dev),
            ffn_norm=torch.ones(dim, device=dev),
            wqkv=q(dim, dim + 2 * kv), wo=q(dim, dim),
            w_gate_up=q(dim, 2 * hid), w_down=q(hid, dim))

    def dense():
        return (torch.randn(vocab, dim, device=dev, generator=g)
                * 0.02).to(torch.bfloat16)

    embed = dense()
    lm_head = dense()
    return LlamaParams(embed, lm_head, torch.ones(dim, device=dev),
                       [layer() for _ in range(cfg.n_layers)])


def quantize_lm_head(params: LlamaParams, bits: int = 8) -> LlamaParams:
    """Opt-in lm_head quantization. bits=8: per-row symmetric int8 for the
    dense_gemv kernel. bits=4: w4-g128 (grouped along dim) for the
    int4_matmul kernel, quantized on the host with the checkpoint
    quantizer."""
    if bits == 8:
        head = quantize_dense_int8(params.lm_head)
    elif bits == 4:
        w = params.lm_head.float().T.cpu().numpy()
        head = QTensor.quantize(w, params.device)
    else:
        raise ValueError(f"unsupported lm_head bits: {bits}")
    return dataclasses.replace(params, lm_head=head)


# ---------------------------------------------------------------------------
# carrying state across from the JAX package (tests)

def _tensor(a, device) -> torch.Tensor:
    """NumPy array -> tensor; ml_dtypes bfloat16 arrays keep their bits."""
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _q_from_numpy(t, device) -> QTensor:
    return QTensor.from_numpy(np.asarray(t.qw), np.asarray(t.zeros),
                              np.asarray(t.scales), int(t.n_in), device)


def params_from_numpy(tree, cfg: ModelConfig, device="cuda") -> LlamaParams:
    """The JAX package's canonical-layout LlamaParams, after
    jax.tree_util.tree_map(np.asarray, params), as the port's params.
    Attributes are read by name (QTensor fields qw, zeros, scales, n_in,
    n_out; Int8Dense fields w8, scale), so no JAX import is needed."""
    dev = resolve_device(device)
    head = tree.lm_head
    if hasattr(head, "qw"):
        lm_head = _q_from_numpy(head, dev)
    elif hasattr(head, "w8"):
        lm_head = Int8Dense(_tensor(head.w8, dev),
                            _tensor(head.scale, dev).float())
    else:
        lm_head = _tensor(head, dev)
    layers = [
        LlamaLayer(
            attn_norm=_tensor(l.attn_norm, dev).float(),
            ffn_norm=_tensor(l.ffn_norm, dev).float(),
            wqkv=_q_from_numpy(l.wqkv, dev), wo=_q_from_numpy(l.wo, dev),
            w_gate_up=_q_from_numpy(l.w_gate_up, dev),
            w_down=_q_from_numpy(l.w_down, dev))
        for l in tree.layers
    ]
    assert len(layers) == cfg.n_layers
    return LlamaParams(_tensor(tree.embed, dev), lm_head,
                       _tensor(tree.final_norm, dev).float(), layers)


def kv_cache_from_numpy(cache, device="cuda") -> KVCache:
    """The JAX package's KVCache (after tree_map(np.asarray, ...)) as the
    port's, so both packages can start at the same position."""
    dev = resolve_device(device)

    def conv(xs):
        return [_tensor(a, dev) for a in xs]

    return KVCache(conv(cache.k), conv(cache.v), conv(cache.k_scale),
                   conv(cache.v_scale))


# ---------------------------------------------------------------------------
# forward pass

def _cache_rows(positions: torch.Tensor, S: int) -> torch.Tensor:
    """Rows b*S + positions[b, t] of a cache flattened to (B*S, ...), for
    every (b, t) in order: where _update_cache writes a (B, T) block."""
    B = positions.shape[0]
    return (torch.arange(B, device=positions.device)[:, None] * S
            + positions).reshape(-1)


def _update_cache(cache_l: torch.Tensor, new: torch.Tensor,
                  rows: torch.Tensor) -> None:
    """Write new (B, T, ...) into cache_l (B, S, ...) at the _cache_rows.

    In place (index_copy_ on the flattened (B*S) axis), where the JAX
    version returns a new cache: the port's forward mutates the cache it
    is given. The engine guarantees pos[b] + T <= S.
    """
    B, S = cache_l.shape[:2]
    cache_l.view(B * S, *cache_l.shape[2:]).index_copy_(
        0, rows, new.reshape(rows.shape[0], *new.shape[2:]).to(cache_l.dtype))


def _causal_mask(positions: torch.Tensor, A: int) -> torch.Tensor:
    """(B, T, 1, 1, A) bool: cache row s is visible to token t iff
    s <= positions[b, t]."""
    s = torch.arange(A, device=positions.device)
    return (s[None, None, :] <= positions[:, :, None])[:, :, None, None, :]


def _attention(q, k_cache, v_cache, mask, act_dtype) -> torch.Tensor:
    """Plain GQA attention over the cache window (the JAX package's
    einsum path, models/llama.py:359-421): f32 scores scaled by
    1/sqrt(D), causal mask (_causal_mask), scores staged through act_dtype
    (the reference's half att buffer), f32 softmax, probabilities in
    act_dtype, f32 accumulation. q: (B, T, H, D); caches (B, A, Hkv, D)
    holding the current block, or for the int4 cache (codes, scales)
    pairs, whose nibble planes run as split dots, one per plane, each
    code times its scale in act_dtype. Returns (B, T, H*D) f32."""
    B, T, H, D = q.shape
    kv4 = isinstance(k_cache, tuple)
    n_kv = (k_cache[0] if kv4 else k_cache).shape[2]
    qg = q.reshape(B, T, n_kv, H // n_kv, D).float()

    def dot(a, b):
        return torch.einsum("bthgd,bshd->bthgs", a, b.float())

    def av(att, v):
        return torch.einsum("bthgs,bshd->bthgd", att, v.float())

    if kv4:
        d2 = D // 2
        k_lo, k_hi = unpack_kv4(*k_cache, act_dtype)
        scores = dot(qg[..., :d2], k_lo) + dot(qg[..., d2:], k_hi)
    else:
        scores = dot(qg, k_cache)
    scores = scores * (1.0 / math.sqrt(D))
    scores = scores.masked_fill(~mask, float("-inf"))
    scores = scores.to(act_dtype).float()
    att = torch.softmax(scores, dim=-1).to(act_dtype).float()
    if kv4:
        v_lo, v_hi = unpack_kv4(*v_cache, act_dtype)
        out = torch.cat([av(att, v_lo), av(att, v_hi)], dim=-1)
    else:
        out = av(att, v_cache)
    return out.reshape(B, T, H * D)


def _post_attention(attn, x, layer: LlamaLayer, plain: bool, act_dtype):
    """o-proj + residual + FFN for one layer; returns (x, next rms ss)."""
    x, ss = qmatmul_fused(attn, layer.wo, plain, residual=x,
                          emit_ss_eps=RMS_EPS, out_dtype=act_dtype)
    gu, _ = qmatmul_fused(x, layer.w_gate_up, plain,
                          prescale=(ss, layer.ffn_norm), out_dtype=act_dtype)
    g, u = gu.chunk(2, dim=-1)
    return qmatmul_fused(g, layer.w_down, plain, silu_u=u, residual=x,
                         emit_ss_eps=RMS_EPS, out_dtype=act_dtype)


def _after_sum(part, res, tp: TPGroup, act_dtype):
    """The row-parallel epilogue after the collective (the JAX forward's
    after_psum, models/llama.py:446-450): the ranks' f32 partials summed,
    the residual added in f32, the rms scale of that f32 sum, then the
    cast. The single-device kernels' epilogue takes the rms of the cast
    output instead, so it cannot serve here."""
    xf = all_reduce_sum(part, tp) + res.float()
    ss = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + RMS_EPS)
    return xf.to(act_dtype), ss


def _post_attention_tp(attn, x, layer: LlamaLayer, plain: bool, act_dtype,
                       tp: TPGroup):
    """_post_attention on one rank's shard: the row-parallel o and down
    projections give f32 partials (the same kernels, with no residual and
    no rms epilogue; the rmsnorm and SwiGLU prologues act on replicated or
    per-shard data and stay in them), each summed over the ranks by
    _after_sum (the JAX package's tp branch, models/llama.py:435-460)."""
    part, _ = qmatmul_fused(attn, layer.wo, plain, out_dtype=torch.float32)
    x, ss = _after_sum(part, x, tp, act_dtype)
    gu, _ = qmatmul_fused(x, layer.w_gate_up, plain,
                          prescale=(ss, layer.ffn_norm), out_dtype=act_dtype)
    g, u = gu.chunk(2, dim=-1)
    part, _ = qmatmul_fused(g, layer.w_down, plain, silu_u=u,
                            out_dtype=torch.float32)
    return _after_sum(part, x, tp, act_dtype)


def _post_attention_chained(attn, x, layer: LlamaLayer,
                            next_layer: LlamaLayer, plain: bool, act_dtype):
    """_post_attention whose down projection runs in one launch with the
    next layer's qkv projection (down_qkv_fused): o and gate_up stay
    standalone. Returns (x, ss, the next layer's qkv) (the JAX package's
    _post_attention_chained, models/llama.py:489-510)."""
    x, ss = qmatmul_fused(attn, layer.wo, plain, residual=x,
                          emit_ss_eps=RMS_EPS, out_dtype=act_dtype)
    gu, _ = qmatmul_fused(x, layer.w_gate_up, plain,
                          prescale=(ss, layer.ffn_norm), out_dtype=act_dtype)
    g, u = gu.chunk(2, dim=-1)
    return dq.down_qkv_fused(g, u, x, layer.w_down, next_layer.wqkv,
                             next_layer.attn_norm, eps=RMS_EPS,
                             out_dtype=act_dtype, x2_dtype=act_dtype,
                             plain=plain)


@dataclasses.dataclass(frozen=True)
class Plan:
    """What forward decides on the host for one call, from the shapes,
    the cache format, the lm_head's type, attn_impl and the environment;
    nothing in it is read from a device tensor. A CUDA graph of a forward
    holds only under the plan it was captured with: engine/graphs.py keys
    its graphs by it."""

    attn_impl: str | None  # after "auto"
    fstep: bool     # T == 1 through the attention_step kernel
    bstep: bool     # T == 1 through batched_decode_attention
    pfk: bool       # T > 1 through the prefill_attention kernel
    kv4: bool       # the int4 cache
    quantized: bool  # int8 or int4 cache
    dq_chain: bool  # the down->next-qkv chain launches
    head: str       # the lm_head's type
    tp: int = 1     # ranks of the tensor-parallel group (local heads)


def plan(params: LlamaParams, cfg: ModelConfig, cache: KVCache, B: int,
         T: int, A: int, attn_impl: str | None, tp: int = 1) -> Plan:
    """forward's choices for a (B, T) block over an A-row window (see
    forward) on one rank of tp (its n_heads / tp and n_kv_heads / tp
    heads); raises ValueError where an explicit attn_impl's kernel cannot
    take the call."""
    H, D, KV = cfg.n_heads // tp, cfg.head_dim, cfg.n_kv_heads // tp
    kv4 = cache.quantized and cache.k[0].shape[-1] == D // 2
    # under tensor parallelism the two attention kernels run per shard
    # unless switched off, read as the JAX package reads them
    # (models/llama.py:589-590, 651-652): then plain attention
    fstep_tp = tp == 1 or os.environ.get("LLAMA_TPU_FSTEP_TP", "1") == "1"
    pfk_tp = tp == 1 or os.environ.get("LLAMA_TPU_PFK_TP", "1") == "1"
    if attn_impl == "fused_step" and not fstep_tp:
        attn_impl = None
    step_ok = kernel_takes(H, KV, D)
    if attn_impl == "fused_step" and not step_ok:
        raise ValueError(
            f"attn_impl='fused_step': the attention_step kernel cannot take "
            f"n_heads={H}, n_kv_heads={KV}, head_dim={D}")
    batched = attn_impl in ("batched", "batched_static")
    if batched and kv4:
        raise ValueError(
            f"attn_impl={attn_impl!r}: the batched_decode_attention kernel "
            f"does not take the int4 KV cache (kv_bits=4)")
    if batched and not bda.kernel_takes(H, KV, D):
        raise ValueError(
            f"attn_impl={attn_impl!r}: the batched_decode_attention kernel "
            f"cannot take n_heads={H}, n_kv_heads={KV}, head_dim={D}")
    if attn_impl == "auto":
        attn_impl = ("fused_step"
                     if step_ok and fstep_tp and A >= FSTEP_MIN_WINDOW
                     else None)
    fstep = attn_impl == "fused_step" and T == 1
    # T > 1 blocks (prefill, perplexity): the flash kernel over the
    # unsliced cache (models/llama.py:637-661 of the JAX package); the
    # int4 cache takes plain attention there, as in the JAX package
    pfk = (T >= PFK_MIN_T and not kv4 and attn_impl != "einsum" and pfk_tp
           and pfa.kernel_takes(H, KV, D, T))
    # down->next-qkv chain (models/llama.py:669-677 of the JAX package):
    # opt-in, T == 1 fused_step steps only, off under tensor parallelism
    # (the row-parallel down ends in a collective); layer 0's qkv and the
    # last layer's down stay standalone
    dq_chain = (fstep and tp == 1 and len(params.layers) > 1
                and os.environ.get("LLAMA_TPU_DOWN_QKV", "0") == "1"
                and dq.supported(params.layers[0].w_down,
                                 params.layers[1].wqkv, B * T))
    return Plan(attn_impl, fstep, batched and T == 1, pfk, kv4,
                cache.quantized, dq_chain, type(params.lm_head).__name__, tp)


def forward(params: LlamaParams, cfg: ModelConfig, tokens: torch.Tensor,
            pos: torch.Tensor, cache: KVCache, *,
            attn_len: int | None = None, act_dtype=torch.bfloat16,
            attn_impl: str | None = None, logits_all: bool = False,
            no_logits: bool = False, plain: bool = False,
            tp: TPGroup | None = None):
    """Run the network over a token block.

    tokens: (B, T) int; pos: (B,) int32 absolute position of tokens[:, 0],
    on the params' device; cache: KVCache with at least attn_len rows,
    updated in place (bf16, int8, or the int4 cache, told by its halved
    last dim). attn_len: attention window (>= max(pos) + T), default the
    whole cache. attn_impl on T == 1 steps:
      None      plain attention;
      "einsum"  plain attention throughout, T > 1 blocks included;
      "fused_step"  the attention_step kernel (any cache format);
      "auto"    fused_step from a FSTEP_MIN_WINDOW window on, where the
                kernel takes the head shapes, else plain attention;
      "batched", "batched_static"  the cache row is written first, then
                the batched_decode_attention kernel reads rows <= pos[b]
                ("batched", per-slot early exit) or walks the whole
                window under the mask ("batched_static"); bf16 and int8
                caches only.
    An explicit fused_step or batched that its kernel cannot take (head
    shapes outside the kernel's rule, or batched with the int4 cache)
    raises ValueError, where the JAX package warns and runs its einsum
    path. Under every choice but "einsum", a block of T >= PFK_MIN_T
    tokens takes the prefill_attention kernel where it takes the head
    shapes and the cache is not int4; other T > 1 blocks take plain
    attention. With LLAMA_TPU_DOWN_QKV=1 in the environment (the JAX
    package's switch, read on every call as it reads it), a fused_step
    T == 1 forward of more than one layer runs each layer's down
    projection and the next layer's qkv projection as one down_qkv launch
    where down_qkv.supported holds; elsewhere the standalone pair runs.
    plain: the kernels' plain versions on any device.
    act_dtype: bf16, fp16 or f32, the type of the activations, the
    residual stream and the unquantized cache (the engines make the cache
    in it); the kernels take each of them.
    tp: this rank's TPGroup under tensor parallelism (parallel/tp.py),
    with its shard of the params and of the cache (its n_heads / tp and
    n_kv_heads / tp heads): the row-parallel o and down projections end
    in a sum over the ranks (_post_attention_tp) and the vocab-sharded
    head in a gather of the logits, so every rank returns the whole
    logits. The down_qkv chain is off; fused_step and prefill_attention
    run per shard unless LLAMA_TPU_FSTEP_TP or LLAMA_TPU_PFK_TP is "0".
    Returns (logits, cache): logits f32 (B, T, vocab) if logits_all else
    (B, vocab), None with no_logits.
    """
    if act_dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise ValueError(f"unsupported act_dtype {act_dtype}")
    if attn_impl not in (None, "auto", "einsum", "fused_step", "batched",
                         "batched_static"):
        raise ValueError(f"unknown attn_impl {attn_impl!r}")
    B, T = tokens.shape
    A = attn_len or cache.k[0].shape[1]
    n_tp = tp.size if tp is not None else 1
    # the rank's heads (models/llama.py:537-538 of the JAX package)
    H, D, KV = cfg.n_heads // n_tp, cfg.head_dim, cfg.n_kv_heads // n_tp
    p = plan(params, cfg, cache, B, T, A, attn_impl, n_tp)
    attn_impl, kv4, fstep, bstep, pfk, dq_chain = (
        p.attn_impl, p.kv4, p.fstep, p.bstep, p.pfk, p.dq_chain)
    n_layers = len(params.layers)

    x = params.embed[tokens.long()].to(act_dtype)  # (B, T, dim)
    positions = pos[:, None].long() + torch.arange(T, device=pos.device)
    xf = x.float()
    ss = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + RMS_EPS)

    # per-forward constants, shared by every layer
    rows = _cache_rows(positions, cache.k[0].shape[1])
    if fstep:
        cos2, sinm = rope_rows(pos, D, cfg.rope_theta)
    else:
        angles = rope_angles(positions, D, cfg.rope_theta)
        mask = None if pfk or bstep else _causal_mask(positions, A)

    qkv_pending = None
    for l, layer in enumerate(params.layers):
        if qkv_pending is not None:
            qkv, qkv_pending = qkv_pending, None
        else:
            qkv, _ = qmatmul_fused(x, layer.wqkv, plain,
                                   prescale=(ss, layer.attn_norm),
                                   out_dtype=act_dtype)
        ks_l = cache.k_scale[l] if cache.quantized else None
        vs_l = cache.v_scale[l] if cache.quantized else None
        if fstep:
            attn_k, kn, vn, ksn, vsn = attention_step(
                qkv[:, 0], cache.k[l], cache.v[l], pos, cos2, sinm, ks_l,
                vs_l, n_heads=H, kv_bits=4 if kv4 else 8, attn_len=A,
                plain=plain)
            _update_cache(cache.k[l], kn[:, None], rows)
            _update_cache(cache.v[l], vn[:, None], rows)
            if cache.quantized:
                _update_cache(ks_l, ksn[:, None], rows)
                _update_cache(vs_l, vsn[:, None], rows)
            attn = attn_k.reshape(B, 1, H * D).to(act_dtype)
        else:
            # q and k heads rotate in one call (rope is per element)
            heads = qkv.reshape(B, T, H + 2 * KV, D)
            qk = apply_rope(heads[:, :, :H + KV], positions, cfg.rope_theta,
                            angles)
            qh, kh = qk[:, :, :H], qk[:, :, H:]
            vh = heads[:, :, H + KV:]
            if cache.quantized:
                quantize = quantize_kv4 if kv4 else quantize_kv
                kq, ks = quantize(kh)
                vq, vs = quantize(vh)
                _update_cache(cache.k[l], kq, rows)
                _update_cache(cache.v[l], vq, rows)
                _update_cache(ks_l, ks, rows)
                _update_cache(vs_l, vs, rows)
            else:
                _update_cache(cache.k[l], kh, rows)
                _update_cache(cache.v[l], vh, rows)
            if bstep:
                # the whole cache, unsliced; the kernel reads rows <= pos
                attn = bda.batched_decode_attention(
                    qh[:, 0], cache.k[l], cache.v[l], pos, ks_l, vs_l,
                    attn_len=A, early_exit=attn_impl == "batched",
                    plain=plain).reshape(B, 1, H * D)
            elif pfk:
                # codes and scales straight from the whole cache; the
                # kernel reads only rows below each slot's horizon
                attn = pfa.prefill_attention(
                    qh, cache.k[l], cache.v[l], pos, ks_l, vs_l,
                    attn_len=A, plain=plain).reshape(B, T, H * D)
            elif kv4:
                attn = _attention(qh, (cache.k[l][:, :A], ks_l[:, :A]),
                                  (cache.v[l][:, :A], vs_l[:, :A]), mask,
                                  act_dtype)
            elif cache.quantized:
                # dequantized window, rounded to act_dtype as the JAX path
                k_att = (cache.k[l][:, :A].to(act_dtype)
                         * ks_l[:, :A, :, None].to(act_dtype))
                v_att = (cache.v[l][:, :A].to(act_dtype)
                         * vs_l[:, :A, :, None].to(act_dtype))
                attn = _attention(qh, k_att, v_att, mask, act_dtype)
            else:
                attn = _attention(qh, cache.k[l][:, :A], cache.v[l][:, :A],
                                  mask, act_dtype)
            attn = attn.to(act_dtype)
        if dq_chain and l + 1 < n_layers:
            x, ss, qkv_pending = _post_attention_chained(
                attn, x, layer, params.layers[l + 1], plain, act_dtype)
        elif n_tp > 1:
            x, ss = _post_attention_tp(attn, x, layer, plain, act_dtype, tp)
        else:
            x, ss = _post_attention(attn, x, layer, plain, act_dtype)

    if no_logits:
        return None, cache
    logits = final_logits(params, x, ss, act_dtype, logits_all, plain)
    if n_tp > 1:  # the ranks' vocab rows side by side
        logits = all_gather_last(logits, tp)
    return logits, cache


def final_logits(params: LlamaParams, x: torch.Tensor, ss: torch.Tensor,
                 act_dtype, logits_all: bool, plain: bool) -> torch.Tensor:
    """The final rmsnorm (x (B, T, dim) and its rms scale ss (B, T, 1)) and
    the lm_head: (B, T, vocab) f32 with logits_all, else the last token's
    (B, vocab). x goes to the head in act_dtype for a w4 head, else in the
    head's type (ops/linear.py dense_matmul routes a bf16 or int8 head to
    its kernel and an fp16 or f32 one to the plain product, the JAX
    rule). Under tensor parallelism the head holds the rank's vocab rows
    and forward gathers the ranks' logits."""
    x = (x.float() * ss * params.final_norm.float()).to(act_dtype)
    if not logits_all:
        x = x[:, -1, :]
    if isinstance(params.lm_head, QTensor):
        return qmatmul(x.to(act_dtype), params.lm_head, plain)
    return dense_matmul(x.to(params.lm_head.dtype), params.lm_head, plain)
