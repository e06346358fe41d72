"""Packed `.bin` checkpoint reader/writer (NumPy; a copy of
llama_cu_awq_tpu/io/checkpoint.py).

Byte-compatible with the reference engine's checkpoint format so that
checkpoints produced by its weight packer run unmodified:

  [32-byte Config header]                      (common.h:9-18)
  token_embedding_table  fp16 (vocab, dim)     (llama2_q4.cu:180)
  wcls (lm head)         fp16 (vocab, dim)     (llama2_q4.cu:181)
  rms_final_weight       fp16 (dim,)           (llama2_q4.cu:182)
  per layer (llama2_q4.cu:185-197):
    q, k, v, o, up, gate, down quantized triples (qweight, qzeros, scales
      in the file layout; see quant/packing.py docstring)
    rms_att_weight fp16 (dim,), rms_ffn_weight fp16 (dim,)

Note the file stores `up` before `gate` (llama2_q4.cu:191-192,
weight_packer.cpp:283-284).
"""

from __future__ import annotations

import dataclasses
from typing import BinaryIO

import numpy as np

from llama_cu_awq_torch.config import GROUP_SIZE, HEADER_BYTES, ModelConfig
from llama_cu_awq_torch.quant import packing


@dataclasses.dataclass
class RawQWeight:
    """One quantized tensor in the in-memory layout (still NumPy)."""

    qw: np.ndarray      # uint32 (ceil(n/8), n_out)
    zeros: np.ndarray   # int8 (g, n_out)
    scales: np.ndarray  # float32 (g, n_out)
    n_in: int
    n_out: int


@dataclasses.dataclass
class RawLayer:
    wq: RawQWeight
    wk: RawQWeight
    wv: RawQWeight
    wo: RawQWeight
    w_gate: RawQWeight
    w_up: RawQWeight
    w_down: RawQWeight
    attn_norm: np.ndarray  # fp16 (dim,)
    ffn_norm: np.ndarray   # fp16 (dim,)


@dataclasses.dataclass
class RawCheckpoint:
    config: ModelConfig
    embed: np.ndarray       # fp16 (vocab, dim)
    lm_head: np.ndarray     # fp16 (vocab, dim)
    final_norm: np.ndarray  # fp16 (dim,)
    layers: list[RawLayer]


def _read(f: BinaryIO, dtype, shape) -> np.ndarray:
    count = int(np.prod(shape))
    arr = np.fromfile(f, dtype=dtype, count=count)
    if arr.size != count:
        raise EOFError("error reading weights: truncated checkpoint")
    return arr.reshape(shape)


def _read_qweight(f: BinaryIO, n_in: int, n_out: int) -> RawQWeight:
    """Read one quantized triple (llama2_q4.cu:162-170)."""
    g = packing.div_up(n_in, GROUP_SIZE)
    pwh = packing.packed_weight_height(n_in)
    pzh = packing.div_up(g, 8)
    qw_file = _read(f, np.uint32, (n_out, pwh))
    qz_file = _read(f, np.uint32, (n_out, pzh))
    s_file = _read(f, np.float16, (n_out, g))
    return RawQWeight(
        qw=packing.qweight_file_to_mem(qw_file, n_in),
        zeros=packing.zeros_file_to_mem(qz_file, n_in),
        scales=packing.scales_file_to_mem(s_file),
        n_in=n_in,
        n_out=n_out,
    )


def load_checkpoint(path: str, verbose: bool = False) -> RawCheckpoint:
    """Stream a packed `.bin` into host memory (llama2_q4.cu:172-202,408-426)."""
    with open(path, "rb") as f:
        cfg = ModelConfig.from_header(f.read(HEADER_BYTES))
        if verbose:
            print(
                f"\nModel params:- \ndim: {cfg.dim} \nhidden_dim: {cfg.hidden_dim}"
                f"\nn_heads: {cfg.n_heads}\nn_kv_heads: {cfg.n_kv_heads}"
                f"\nn_layers: {cfg.n_layers}\nseq_len: {cfg.seq_len}"
                f"\nvocab_size: {cfg.vocab_size}\nrope_theta: {cfg.rope_theta:g}"
            )
        dim, kv_dim, hidden = cfg.dim, cfg.kv_dim, cfg.hidden_dim
        embed = _read(f, np.float16, (cfg.vocab_size, dim))
        lm_head = _read(f, np.float16, (cfg.vocab_size, dim))
        final_norm = _read(f, np.float16, (dim,))
        layers = []
        for _ in range(cfg.n_layers):
            wq = _read_qweight(f, dim, dim)
            wk = _read_qweight(f, dim, kv_dim)
            wv = _read_qweight(f, dim, kv_dim)
            wo = _read_qweight(f, dim, dim)
            w_up = _read_qweight(f, dim, hidden)
            w_gate = _read_qweight(f, dim, hidden)
            w_down = _read_qweight(f, hidden, dim)
            attn_norm = _read(f, np.float16, (dim,))
            ffn_norm = _read(f, np.float16, (dim,))
            layers.append(RawLayer(wq, wk, wv, wo, w_gate, w_up, w_down,
                                   attn_norm, ffn_norm))
    return RawCheckpoint(cfg, embed, lm_head, final_norm, layers)


def _write_qweight(f: BinaryIO, qt: RawQWeight) -> None:
    packing.qweight_mem_to_file(qt.qw, qt.n_in).tofile(f)
    packing.zeros_mem_to_file(qt.zeros).tofile(f)
    packing.scales_mem_to_file(qt.scales).tofile(f)


def save_checkpoint(path: str, ckpt: RawCheckpoint) -> None:
    """Emit a packed `.bin` (weight_packer.cpp:233-297 output format)."""
    cfg = ckpt.config
    with open(path, "wb") as f:
        f.write(cfg.to_header())
        ckpt.embed.astype(np.float16).tofile(f)
        ckpt.lm_head.astype(np.float16).tofile(f)
        ckpt.final_norm.astype(np.float16).tofile(f)
        for layer in ckpt.layers:
            for qt in (layer.wq, layer.wk, layer.wv, layer.wo,
                       layer.w_up, layer.w_gate, layer.w_down):
                _write_qweight(f, qt)
            layer.attn_norm.astype(np.float16).tofile(f)
            layer.ffn_norm.astype(np.float16).tofile(f)


def random_checkpoint(cfg: ModelConfig, seed: int = 0,
                      scale: float = 0.02) -> RawCheckpoint:
    """Random checkpoint with plausible magnitudes (tests & benchmarks)."""
    rng = np.random.default_rng(seed)

    def qweight(n_in, n_out):
        w = rng.standard_normal((n_in, n_out), dtype=np.float32) * scale
        qw, zeros, scales = packing.quantize_np(w)
        return RawQWeight(qw, zeros, scales, n_in, n_out)

    def norm(n):
        return (1.0 + rng.standard_normal(n, dtype=np.float32) * 0.01).astype(
            np.float16
        )

    dim, kv_dim, hidden = cfg.dim, cfg.kv_dim, cfg.hidden_dim
    layers = [
        RawLayer(
            wq=qweight(dim, dim), wk=qweight(dim, kv_dim),
            wv=qweight(dim, kv_dim), wo=qweight(dim, dim),
            w_gate=qweight(dim, hidden), w_up=qweight(dim, hidden),
            w_down=qweight(hidden, dim),
            attn_norm=norm(dim), ffn_norm=norm(dim),
        )
        for _ in range(cfg.n_layers)
    ]
    embed = (rng.standard_normal((cfg.vocab_size, dim), dtype=np.float32)
             * scale).astype(np.float16)
    lm_head = (rng.standard_normal((cfg.vocab_size, dim), dtype=np.float32)
               * scale).astype(np.float16)
    return RawCheckpoint(cfg, embed, lm_head, norm(dim), layers)
