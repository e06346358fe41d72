"""Offline AWQ checkpoint ingest (pure NumPy; the port's copy of
llama_cu_awq_tpu/io/awq.py).

The reference's offline pipeline has two stages:

  1. `convert_awq_to_bin.py <ckpt.pt> <dir>` dumps every tensor raw;
  2. `weight_packer <config.json> <dir> <out.bin> <old_format>` repacks
     the AWQ layout into the engine's flat `.bin`
     (reference: weight_packer.cpp:233-297).

This module reads both inputs into a RawCheckpoint, which
io/checkpoint.save_checkpoint writes as the `.bin` (the tools in
llama_cu_awq_torch/tools):

  - a **safetensors** reader (no torch at load time), with sharded
    checkpoints through model.safetensors.index.json;
  - the HF `config.json` -> ModelConfig mapping (weight_packer.cpp:22-72);
  - **direct** HF-AWQ -> RawCheckpoint ingest, from safetensors or from a
    dict of tensors;
  - the per-tensor-dump path of the reference pipeline.

AWQ "old format" (llm-awq / autoawq GEMM): for a weight consumed as
out = x @ W with n_in rows ("height") and n_out columns ("width"):

  qweight: int32 (n_in, n_out/8), 8 nibbles per word along n_out,
           interleaved with order_map {0,2,4,6,1,3,5,7};
  qzeros:  int32 (ceil(n_in/128), n_out/8), the same nibble interleave;
  scales:  fp16  (ceil(n_in/128), n_out).

"New format" dumps are already nibble-packed along n_in per column
(engine layout), with scales padded to a multiple-of-8 group count that
must be stripped (weight_packer.cpp:201-212).
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np

from llama_cu_awq_torch.config import GROUP_SIZE, ModelConfig
from llama_cu_awq_torch.io.checkpoint import (RawCheckpoint, RawLayer,
                                              RawQWeight)
from llama_cu_awq_torch.quant import packing

# ---------------------------------------------------------------------------
# safetensors (pure NumPy)

_ST_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U8": np.uint8, "BOOL": np.bool_,
    # BF16 has no NumPy dtype: its raw bits as uint16
    "BF16": np.uint16,
}


def read_safetensors(path: str, names: list[str] | None = None
                     ) -> dict[str, np.ndarray]:
    """Read a .safetensors file with NumPy only (an 8-byte little-endian
    header length, a JSON header, the raw little-endian tensor buffer);
    `names` keeps only those tensors."""
    out = {}
    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen))
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + hlen)
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        if names is not None and name not in names:
            continue
        beg, end = meta["data_offsets"]
        arr = np.frombuffer(data[beg:end].tobytes(),
                            dtype=_ST_DTYPES[meta["dtype"]])
        out[name] = arr.reshape(meta["shape"])
    return out


def read_safetensors_dir(model_dir: str) -> dict[str, np.ndarray]:
    """Every tensor of a HF model directory, following
    model.safetensors.index.json when the checkpoint is sharded."""
    index = os.path.join(model_dir, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            weight_map = json.load(f)["weight_map"]
        tensors = {}
        for shard in sorted(set(weight_map.values())):
            tensors.update(read_safetensors(os.path.join(model_dir, shard)))
        return tensors
    single = os.path.join(model_dir, "model.safetensors")
    if os.path.exists(single):
        return read_safetensors(single)
    raise FileNotFoundError(f"no safetensors checkpoint under {model_dir}")


# ---------------------------------------------------------------------------
# HF config.json -> ModelConfig (weight_packer.cpp:22-72 field mapping)

def config_from_hf_json(text: str) -> ModelConfig:
    return ModelConfig.from_hf_json(text)


# ---------------------------------------------------------------------------
# AWQ tensor triples -> RawQWeight

def raw_qweight_from_awq(qweight: np.ndarray, qzeros: np.ndarray,
                         scales: np.ndarray, n_in: int, n_out: int,
                         old_format: bool = True) -> RawQWeight:
    """One projection's AWQ triple in the in-memory layout."""
    g = packing.div_up(n_in, GROUP_SIZE)
    if old_format:
        qw, zeros, s = packing.repack_awq_old_format(
            qweight.view(np.uint32).reshape(n_in, n_out // 8),
            qzeros.view(np.uint32).reshape(g, n_out // 8),
            scales.astype(np.float16).reshape(g, n_out), n_in, n_out)
        return RawQWeight(qw, zeros, s.astype(np.float32), n_in, n_out)
    # new format: the engine layout already; strip the scales' padding
    # (weight_packer.cpp:201-212)
    pzh = packing.div_up(g, 8)
    qw_file = qweight.view(np.uint32).reshape(n_out, -1)
    qz_file = qzeros.view(np.uint32).reshape(n_out, pzh)
    s_file = scales.astype(np.float16).reshape(n_out, -1)[:, :g]
    return RawQWeight(
        qw=packing.qweight_file_to_mem(qw_file, n_in),
        zeros=packing.zeros_file_to_mem(qz_file, n_in),
        scales=packing.scales_file_to_mem(s_file),
        n_in=n_in, n_out=n_out)


QUANT_NAMES = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
               "self_attn.o_proj", "mlp.up_proj", "mlp.gate_proj",
               "mlp.down_proj")


def tensor_dims(cfg: ModelConfig, name: str) -> tuple[int, int]:
    """(n_in, n_out) of each quantized projection
    (weight_packer.cpp:278-287)."""
    dim, kv, hid = cfg.dim, cfg.kv_dim, cfg.hidden_dim
    return {
        "self_attn.q_proj": (dim, dim), "self_attn.k_proj": (dim, kv),
        "self_attn.v_proj": (dim, kv), "self_attn.o_proj": (dim, dim),
        "mlp.up_proj": (dim, hid), "mlp.gate_proj": (dim, hid),
        "mlp.down_proj": (hid, dim),
    }[name]


def checkpoint_from_tensors(tensors: dict[str, np.ndarray],
                            cfg: ModelConfig,
                            old_format: bool = True) -> RawCheckpoint:
    """A RawCheckpoint from a HF-AWQ tensor dict (safetensors or an
    exploded .pt). Field order follows the reference packer's walk
    (weight_packer.cpp:261-295)."""

    def fp16(name, shape):
        t = tensors[name]
        if t.dtype == np.uint16:  # bf16 bits -> widened through f32
            t = (t.astype(np.uint32) << 16).view(np.float32).astype(
                np.float16)
        return np.ascontiguousarray(t.astype(np.float16).reshape(shape))

    embed = fp16("model.embed_tokens.weight", (cfg.vocab_size, cfg.dim))
    lm_head = fp16("lm_head.weight", (cfg.vocab_size, cfg.dim))
    final_norm = fp16("model.norm.weight", (cfg.dim,))
    layers = []
    for i in range(cfg.n_layers):
        base = f"model.layers.{i}."
        q = {}
        for name in QUANT_NAMES:
            n_in, n_out = tensor_dims(cfg, name)
            q[name] = raw_qweight_from_awq(
                tensors[base + name + ".qweight"],
                tensors[base + name + ".qzeros"],
                tensors[base + name + ".scales"],
                n_in, n_out, old_format=old_format)
        layers.append(RawLayer(
            wq=q["self_attn.q_proj"], wk=q["self_attn.k_proj"],
            wv=q["self_attn.v_proj"], wo=q["self_attn.o_proj"],
            w_gate=q["mlp.gate_proj"], w_up=q["mlp.up_proj"],
            w_down=q["mlp.down_proj"],
            attn_norm=fp16(base + "input_layernorm.weight", (cfg.dim,)),
            ffn_norm=fp16(base + "post_attention_layernorm.weight",
                          (cfg.dim,)),
        ))
    return RawCheckpoint(cfg, embed, lm_head, final_norm, layers)


def load_awq_model_dir(model_dir: str,
                       old_format: bool = True) -> RawCheckpoint:
    """The direct HF-AWQ loader: config.json and safetensors in one step,
    with no intermediate dump."""
    with open(os.path.join(model_dir, "config.json")) as f:
        cfg = config_from_hf_json(f.read())
    return checkpoint_from_tensors(read_safetensors_dir(model_dir), cfg,
                                   old_format=old_format)


# ---------------------------------------------------------------------------
# per-tensor dump directory (the reference pipeline's stage-2 input)

def _load_dump(dump_dir: str, name: str, dtype, count: int) -> np.ndarray:
    path = os.path.join(dump_dir, name + ".bin")
    arr = np.fromfile(path, dtype=dtype, count=count)
    if arr.size != count:
        raise EOFError(f"truncated tensor dump {path}")
    return arr


def checkpoint_from_dump_dir(dump_dir: str, config_json_path: str,
                             old_format: bool = True) -> RawCheckpoint:
    """A RawCheckpoint from convert_awq_to_bin-style raw dumps (the input
    contract of weight_packer.cpp:178-235)."""
    with open(config_json_path) as f:
        cfg = config_from_hf_json(f.read())
    tensors: dict[str, np.ndarray] = {}

    def grab(name, dtype, count):
        tensors[name] = _load_dump(dump_dir, name, dtype, count)

    grab("model.embed_tokens.weight", np.float16, cfg.vocab_size * cfg.dim)
    grab("lm_head.weight", np.float16, cfg.vocab_size * cfg.dim)
    grab("model.norm.weight", np.float16, cfg.dim)
    for i in range(cfg.n_layers):
        base = f"model.layers.{i}."
        for name in QUANT_NAMES:
            n_in, n_out = tensor_dims(cfg, name)
            g = packing.div_up(n_in, GROUP_SIZE)
            if old_format:
                nq, nz = n_in * (n_out // 8), g * (n_out // 8)
                ns = g * n_out
            else:
                nq = packing.div_up(n_in, 8) * n_out
                nz = packing.div_up(g, 8) * n_out
                ns = packing.div_up(g, 8) * 8 * n_out
            grab(base + name + ".qweight", np.int32, nq)
            grab(base + name + ".qzeros", np.int32, nz)
            grab(base + name + ".scales", np.float16, ns)
        grab(base + "input_layernorm.weight", np.float16, cfg.dim)
        grab(base + "post_attention_layernorm.weight", np.float16, cfg.dim)
    return checkpoint_from_tensors(tensors, cfg, old_format=old_format)
