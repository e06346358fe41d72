"""Megatron-style tensor parallelism for the quantized Llama model.

The counterpart of llama_cu_awq_tpu/parallel/tp.py, as functions of one
rank: each rank is a process that holds one shard of every weight and of
the KV cache, and runs forward with its TPGroup (parallel/mesh.py). The
layout is the JAX package's:

- activations are replicated: every rank holds the whole residual stream;
- wqkv and w_gate_up are column-parallel and shard-major: rank d holds
  [q_d | k_d | v_d] (its heads) and [gate_d | up_d] (its hidden columns);
- wo and w_down are row-parallel: rank d holds input rows
  d*n/tp:(d+1)*n/tp, whole 128-row groups with their own scales and zeros,
  and forward sums the ranks' partial outputs (all_reduce_sum);
- the KV cache holds the rank's kv heads, and given a (dp, tp) Mesh its
  dp row's slots: the JAX batch_sharded=True forward, which shards the
  batch over dp and the heads over tp;
- the lm_head is vocab-sharded (rows d*V/tp:(d+1)*V/tp), and forward
  gathers the logits along the vocab (all_gather_last);
- the embed and the norm weights are replicated.

A shard is a QTensor in the port's own layout (quant/qtensor.py), so a
slice of whole words and groups is the shard, with no padding: the
kernels take any n_in % 32 == 0. _check_divisible refuses a row shard
that would cut a 128-row group, which the JAX _row_shard does not check
(ROADMAP.md, "Known defects in the reference").
"""

from __future__ import annotations

import numpy as np
import torch

from llama_cu_awq_torch.config import GROUP_SIZE, ModelConfig
from llama_cu_awq_torch.device import resolve_device
from llama_cu_awq_torch.io.checkpoint import RawCheckpoint, RawQWeight
from llama_cu_awq_torch.models.llama import (KVCache, LlamaLayer,
                                             LlamaParams, forward,
                                             init_kv_cache, synthetic_params)
from llama_cu_awq_torch.parallel.mesh import (Mesh, all_gather_last,
                                              all_reduce_sum, local_rows)
from llama_cu_awq_torch.quant.qtensor import QTensor

__all__ = ["all_gather_last", "all_reduce_sum", "make_shard_forward",
           "make_tp_forward", "shard_params", "tp_init_kv_cache",
           "tp_params_from_checkpoint", "tp_synthetic_params"]


def _check_divisible(cfg: ModelConfig, tp: int) -> None:
    """The JAX package's conditions, and whole 128-row groups in every
    row shard: (dim // tp) and (hidden_dim // tp) multiples of 128."""
    if cfg.n_kv_heads % tp or cfg.n_heads % tp:
        raise ValueError(f"tp={tp} must divide n_kv_heads={cfg.n_kv_heads}")
    if cfg.hidden_dim % tp or cfg.vocab_size % tp:
        raise ValueError(f"tp={tp} must divide hidden_dim and vocab_size")
    if tp == 1:
        return
    if (cfg.kv_dim // tp) % 128:
        raise ValueError("per-shard kv_dim must be a multiple of 128")
    for name, n in (("wo", cfg.dim), ("w_down", cfg.hidden_dim)):
        if (n // tp) % GROUP_SIZE:
            raise ValueError(
                f"tp={tp}: {name}'s row shard of {n} // {tp} = {n // tp} "
                f"inputs would split a {GROUP_SIZE}-row quantization group "
                f"(the per-shard width must be a multiple of {GROUP_SIZE})")


# ---------------------------------------------------------------------------
# shards from a checkpoint

def _col_shard(raws: list[RawQWeight], tp: int, rank: int,
               device) -> QTensor:
    """Columns rank*w:(rank+1)*w of each tensor (w = its n_out / tp),
    side by side: [q_d | k_d | v_d] or [gate_d | up_d]."""
    parts = []
    for r in raws:
        w = r.n_out // tp
        sl = slice(rank * w, (rank + 1) * w)
        parts.append((r.qw[:, sl], r.zeros[:, sl], r.scales[:, sl]))
    return QTensor.from_numpy(
        *(np.concatenate([p[i] for p in parts], axis=1) for i in range(3)),
        raws[0].n_in, device)


def _row_shard(raw: RawQWeight, tp: int, rank: int, device) -> QTensor:
    """Input rows rank*n:(rank+1)*n (n = n_in / tp, whole groups): the
    words of 8 rows and the groups' scales and zeros of that range."""
    n = raw.n_in // tp
    words, groups = slice(rank * n // 8, (rank + 1) * n // 8), \
        slice(rank * n // GROUP_SIZE, (rank + 1) * n // GROUP_SIZE)
    return QTensor.from_numpy(raw.qw[words], raw.zeros[groups],
                              raw.scales[groups], n, device)


def _dense(a: np.ndarray, dtype, device) -> torch.Tensor:
    """A dense fp16 array in dtype, or with None its fp16 bits as they
    are (params_from_checkpoint's rule)."""
    t = torch.from_numpy(np.array(a)).to(device)  # widened on the device
    return t if dtype is None else t.float().to(dtype)


def tp_params_from_checkpoint(ckpt: RawCheckpoint, tp: int, rank: int,
                              device="cuda",
                              param_dtype=torch.bfloat16) -> LlamaParams:
    """Rank `rank`'s shard of a loaded `.bin` on `device` (see the module
    docstring): the embed replicated and the lm_head's vocab rows, in
    param_dtype (bf16 by default, the JAX function's; None keeps the
    checkpoint's fp16)."""
    _check_divisible(ckpt.config, tp)
    dev = resolve_device(device)
    layers = [
        LlamaLayer(
            attn_norm=_dense(l.attn_norm, torch.float32, dev),
            ffn_norm=_dense(l.ffn_norm, torch.float32, dev),
            wqkv=_col_shard([l.wq, l.wk, l.wv], tp, rank, dev),
            wo=_row_shard(l.wo, tp, rank, dev),
            w_gate_up=_col_shard([l.w_gate, l.w_up], tp, rank, dev),
            w_down=_row_shard(l.w_down, tp, rank, dev))
        for l in ckpt.layers
    ]
    v = ckpt.config.vocab_size // tp
    return LlamaParams(_dense(ckpt.embed, param_dtype, dev),
                       _dense(ckpt.lm_head[rank * v:(rank + 1) * v],
                              param_dtype, dev),
                       _dense(ckpt.final_norm, torch.float32, dev), layers)


# ---------------------------------------------------------------------------
# shards of full params

def _q_rows(qt: QTensor, blocks) -> QTensor:
    """The output columns of qt in the (start, stop) blocks, in order."""
    def take(t):
        return torch.cat([t[a:b] for a, b in blocks]).contiguous()

    return QTensor(take(qt.qw), take(qt.scales), take(qt.zeros), qt.n_in,
                   sum(b - a for a, b in blocks))


def _q_inputs(qt: QTensor, tp: int, rank: int) -> QTensor:
    """Input rows rank*n:(rank+1)*n of qt (n = n_in / tp, whole groups)."""
    n = qt.n_in // tp
    w = qt.qw[:, rank * n // 8:(rank + 1) * n // 8]
    g = slice(rank * n // GROUP_SIZE, (rank + 1) * n // GROUP_SIZE)
    return QTensor(w.contiguous(), qt.scales[:, g].contiguous(),
                   qt.zeros[:, g].contiguous(), n, qt.n_out)


def shard_params(params: LlamaParams, cfg: ModelConfig, tp: int,
                 rank: int) -> LlamaParams:
    """Rank `rank`'s shard of full single-device params, on their device:
    the same tensors tp_params_from_checkpoint builds from the checkpoint
    those params came from. The head must be dense (the JAX CLI ignores
    --lm-head-bits under --tp)."""
    _check_divisible(cfg, tp)
    if not isinstance(params.lm_head, torch.Tensor):
        raise ValueError("tensor parallelism takes a dense lm_head, got "
                         f"{type(params.lm_head).__name__}")
    dim, kv, hid = cfg.dim, cfg.kv_dim, cfg.hidden_dim
    q_l, kv_l, h_l = dim // tp, kv // tp, hid // tp

    def block(base, w):
        return (base + rank * w, base + (rank + 1) * w)

    qkv = [block(0, q_l), block(dim, kv_l), block(dim + kv, kv_l)]
    gate_up = [block(0, h_l), block(hid, h_l)]
    layers = [
        LlamaLayer(attn_norm=l.attn_norm, ffn_norm=l.ffn_norm,
                   wqkv=_q_rows(l.wqkv, qkv),
                   wo=_q_inputs(l.wo, tp, rank),
                   w_gate_up=_q_rows(l.w_gate_up, gate_up),
                   w_down=_q_inputs(l.w_down, tp, rank))
        for l in params.layers
    ]
    v = cfg.vocab_size // tp
    head = params.lm_head[rank * v:(rank + 1) * v].contiguous()
    return LlamaParams(params.embed, head, params.final_norm, layers)


def tp_synthetic_params(cfg: ModelConfig, tp: int, rank: int, seed: int = 0,
                        device="cuda") -> LlamaParams:
    """Rank `rank`'s shard of models.llama.synthetic_params(cfg, seed): the
    full weights are made on the device and sliced, so a TP run and a
    single-device run from one seed hold the same weights."""
    _check_divisible(cfg, tp)
    return shard_params(synthetic_params(cfg, seed=seed, device=device), cfg,
                        tp, rank)


# ---------------------------------------------------------------------------
# cache and forward

def tp_init_kv_cache(cfg: ModelConfig, batch: int, max_seq: int, tp,
                     dtype=torch.bfloat16, quantized: bool = False,
                     kv_bits: int = 8, device="cuda") -> KVCache:
    """A rank's KV cache: its n_kv_heads / tp heads, in every cache format
    (act_dtype rows, int8 codes, int4 codes two a byte; the scales by the
    same heads). tp: the tp degree, or a Mesh, whose batch is sharded: the
    rank of dp row r holds slots r*B/dp:(r+1)*B/dp of the global batch B
    (the JAX cache's P("dp", None, "tp", None)); raises ValueError where
    dp does not divide B."""
    sharded = isinstance(tp, Mesh)
    n = tp.tp_group.size if sharded else tp
    _check_divisible(cfg, n)
    if sharded:
        batch = len(local_rows(range(batch), tp))
    return init_kv_cache(cfg, batch, max_seq, dtype=dtype,
                         quantized=quantized, kv_bits=kv_bits, device=device,
                         n_kv_heads=cfg.n_kv_heads // n)


def make_shard_forward(cfg: ModelConfig, tp):
    """models.llama.forward without the cfg argument, bound to this rank's
    group: what the JAX function's shard_map wrapper is, for one rank.
    Given a TPGroup, it runs the whole batch. Given a Mesh, it is the JAX
    batch_sharded=True forward: it takes the global tokens (B, T) and
    positions (B,) that every process holds, runs its dp row's slots
    (mesh.local_rows) on its tp row against its batch-sharded cache and
    returns that row's logits; all_gather_batch assembles the global
    ones."""
    sharded = isinstance(tp, Mesh)
    group = tp.tp_group if sharded else tp

    def fwd(params, tokens, pos, cache, **kw):
        if sharded:
            tokens, pos = local_rows(tokens, tp), local_rows(pos, tp)
        return forward(params, cfg, tokens, pos, cache, tp=group, **kw)

    return fwd


def make_tp_forward(cfg: ModelConfig, tp, *, attn_len: int,
                    act_dtype=torch.bfloat16, logits_all: bool = False):
    """The shard forward at a fixed window (standalone use; the engines
    call forward with their TPGroup). tp: a TPGroup, or a Mesh for the
    batch-sharded forward (make_shard_forward)."""
    sf = make_shard_forward(cfg, tp)

    def fn(params, tokens, pos, cache):
        return sf(params, tokens, pos, cache, attn_len=attn_len,
                  act_dtype=act_dtype, logits_all=logits_all)

    return fn
