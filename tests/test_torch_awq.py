"""The port's AWQ ingest (llama_cu_awq_torch/io/awq.py, quant/packing.py's
AWQ helpers, and the tools pack_weights and convert_awq_to_bin) against
the JAX package's (llama_cu_awq_tpu/io/awq.py, tools/*.py) on the same
synthetic inputs, made with numpy from a seed by the JAX tests' own
helpers (tests/test_weight_packer_native.py). Every comparison is exact:
the same arrays bit for bit, the same `.bin` byte for byte.
"""

import dataclasses
import importlib.util
import json
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from llama_cu_awq_torch.config import ModelConfig as TConfig
from llama_cu_awq_torch.io import awq as tawq
from llama_cu_awq_torch.io.checkpoint import load_checkpoint
from llama_cu_awq_torch.quant import packing as tpacking
from llama_cu_awq_tpu.config import GROUP_SIZE, ModelConfig
from llama_cu_awq_tpu.io import awq as jawq
from llama_cu_awq_tpu.quant import packing as jpacking
from tests.test_weight_packer_native import (dump_tensors, make_awq_tensors,
                                             make_hf_config)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = ModelConfig(dim=64, hidden_dim=160, n_layers=2, n_heads=4,
                  n_kv_heads=2, vocab_size=96, seq_len=128,
                  rope_theta=50000.0)
# a partial last quantization group (n_in 192, 416) and MHA
CFG_RAGGED = ModelConfig(dim=192, hidden_dim=416, n_layers=1, n_heads=3,
                         n_kv_heads=3, vocab_size=40, seq_len=64)
_ST_NAMES = {np.float32: "F32", np.float16: "F16", np.int32: "I32",
             np.int8: "I8", np.uint8: "U8", np.int64: "I64"}


def write_safetensors(path, tensors, bf16=()):
    """A .safetensors file of numpy arrays; names in bf16 hold uint16 bf16
    bits and are tagged BF16."""
    header, blobs, offset = {}, [], 0
    for name, a in tensors.items():
        raw = np.ascontiguousarray(a).tobytes()
        dtype = "BF16" if name in bf16 else _ST_NAMES[a.dtype.type]
        header[name] = {"dtype": dtype, "shape": list(a.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        offset += len(raw)
        blobs.append(raw)
    header["__metadata__"] = {"format": "pt"}
    hj = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hj)))
        f.write(hj)
        for b in blobs:
            f.write(b)


def write_model_dir(path, cfg, tensors, shards=1, bf16=()):
    """config.json and the tensors as one safetensors file, or `shards`
    shards behind model.safetensors.index.json."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        f.write(make_hf_config(cfg))
    names = sorted(tensors)
    if shards == 1:
        write_safetensors(os.path.join(path, "model.safetensors"), tensors,
                          bf16)
        return
    weight_map = {}
    for i in range(shards):
        shard = f"model-{i + 1:05d}-of-{shards:05d}.safetensors"
        part = {n: tensors[n] for n in names[i::shards]}
        write_safetensors(os.path.join(path, shard), part, bf16)
        weight_map.update({n: shard for n in part})
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {}, "weight_map": weight_map}, f)


def bf16_bits(a):
    """fp16 values as bf16 bits (uint16), rounded to nearest even."""
    t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return t.view(torch.int16).numpy().view(np.uint16)


def assert_checkpoints_equal(got, want):
    """Every field of two RawCheckpoints (the port's and the JAX
    package's) bit-equal, dtypes included."""
    assert dataclasses.asdict(got.config) == dataclasses.asdict(want.config)

    def same(a, b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)

    for name in ("embed", "lm_head", "final_norm"):
        same(getattr(got, name), getattr(want, name))
    assert len(got.layers) == len(want.layers)
    for lg, lw in zip(got.layers, want.layers):
        for name in ("attn_norm", "ffn_norm"):
            same(getattr(lg, name), getattr(lw, name))
        for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
            qg, qw = getattr(lg, name), getattr(lw, name)
            assert (qg.n_in, qg.n_out) == (qw.n_in, qw.n_out)
            for field in ("qw", "zeros", "scales"):
                same(getattr(qg, field), getattr(qw, field))


def _jax_tool(name):
    """tools/<name>.py of the repository as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_port_tool(name, *args):
    """python -m llama_cu_awq_torch.tools.<name> args..., from the repo."""
    return subprocess.run(
        [sys.executable, "-m", f"llama_cu_awq_torch.tools.{name}",
         *map(str, args)], cwd=REPO, capture_output=True, text=True,
        check=True, timeout=120)


# ---------------------------------------------------------------------------
# safetensors and config

@pytest.mark.parametrize("shards", [1, 3])
def test_safetensors_reader_matches_jax(tmp_path, rng, shards):
    """One file and a 3-shard index: every dtype the AWQ export writes,
    BF16 read as its uint16 bits, the same arrays as the JAX reader's."""
    arrs = {
        "a": rng.standard_normal((4, 6)).astype(np.float32),
        "b": rng.integers(-100, 100, (3, 5)).astype(np.int32),
        "c": rng.standard_normal(7).astype(np.float16),
        "d": rng.integers(-128, 128, (2, 8)).astype(np.int8),
        "e": bf16_bits(rng.standard_normal((5, 3))),
    }
    write_model_dir(tmp_path, CFG, arrs, shards=shards, bf16=("e",))
    got = tawq.read_safetensors_dir(str(tmp_path))
    want = jawq.read_safetensors_dir(str(tmp_path))
    assert sorted(got) == sorted(want) == sorted(arrs)
    for name, a in arrs.items():
        assert got[name].dtype == want[name].dtype == a.dtype
        np.testing.assert_array_equal(got[name], want[name])
        np.testing.assert_array_equal(got[name], a)
    if shards == 1:
        path = str(tmp_path / "model.safetensors")
        sub = tawq.read_safetensors(path, names=["b", "e"])
        assert sorted(sub) == ["b", "e"]
        np.testing.assert_array_equal(sub["e"], arrs["e"])
    with pytest.raises(FileNotFoundError):
        tawq.read_safetensors_dir(str(tmp_path / "nowhere"))


@pytest.mark.parametrize("drop", [(), ("num_key_value_heads",),
                                  ("rope_theta",)])
def test_hf_config_mapping_matches_jax(drop):
    """The seven fields of weight_packer.cpp:22-72, and its defaults for a
    missing num_key_value_heads and rope_theta."""
    d = json.loads(make_hf_config(CFG))
    for k in drop:
        del d[k]
    text = json.dumps(d)
    got, want = tawq.config_from_hf_json(text), jawq.config_from_hf_json(text)
    assert isinstance(got, TConfig)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_awq_interleave_helpers_match_jax(rng):
    """awq_pack_interleaved and its inverse, and repack_awq_old_format, on
    a ragged height (200 rows: two groups, the last partial)."""
    h, w = 200, 48
    vals = rng.integers(0, 16, (h, w))
    packed = tpacking.awq_pack_interleaved(vals)
    np.testing.assert_array_equal(packed, jpacking.awq_pack_interleaved(vals))
    assert packed.dtype == np.uint32
    np.testing.assert_array_equal(
        tpacking.awq_unpack_interleaved(packed, h, w), vals)
    g = -(-h // GROUP_SIZE)
    zeros = tpacking.awq_pack_interleaved(rng.integers(0, 16, (g, w)))
    scales = rng.random((g, w)).astype(np.float16)
    got = tpacking.repack_awq_old_format(packed, zeros, scales, h, w)
    want = jpacking.repack_awq_old_format(packed, zeros, scales, h, w)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# RawCheckpoints

@pytest.mark.parametrize("cfg", [CFG, CFG_RAGGED], ids=["gqa", "ragged"])
@pytest.mark.parametrize("old_format", [True, False])
def test_dump_dir_matches_jax(tmp_path, rng, cfg, old_format):
    """The reference pipeline's per-tensor dumps, old (AWQ interleaved)
    and new (engine layout, padded scales) formats."""
    dump_tensors(make_awq_tensors(cfg, rng, old_format), tmp_path / "dump")
    (tmp_path / "config.json").write_text(make_hf_config(cfg))
    args = (str(tmp_path / "dump"), str(tmp_path / "config.json"))
    assert_checkpoints_equal(
        tawq.checkpoint_from_dump_dir(*args, old_format=old_format),
        jawq.checkpoint_from_dump_dir(*args, old_format=old_format))


def test_truncated_dump_raises(tmp_path, rng):
    dump_tensors(make_awq_tensors(CFG, rng, True), tmp_path)
    path = tmp_path / "model.norm.weight.bin"
    path.write_bytes(path.read_bytes()[:-2])
    (tmp_path / "config.json").write_text(make_hf_config(CFG))
    with pytest.raises(EOFError, match="truncated"):
        tawq.checkpoint_from_dump_dir(str(tmp_path),
                                      str(tmp_path / "config.json"))


@pytest.mark.parametrize("old_format", [True, False])
@pytest.mark.parametrize("shards,bf16", [(1, False), (2, True)])
def test_load_awq_model_dir_matches_jax(tmp_path, rng, old_format, shards,
                                        bf16):
    """config.json plus safetensors, one file or two shards; with bf16 the
    embed, head and norms are stored as BF16 (widened to fp16 through f32
    by both loaders)."""
    tensors = make_awq_tensors(CFG, rng, old_format)
    dense = [n for n in tensors if not n.endswith(
        (".qweight", ".qzeros", ".scales"))]
    if bf16:
        tensors.update({n: bf16_bits(tensors[n]) for n in dense})
    write_model_dir(tmp_path, CFG, tensors, shards=shards,
                    bf16=dense if bf16 else ())
    got = tawq.load_awq_model_dir(str(tmp_path), old_format=old_format)
    assert_checkpoints_equal(
        got, jawq.load_awq_model_dir(str(tmp_path), old_format=old_format))
    assert got.embed.dtype == np.float16


# ---------------------------------------------------------------------------
# the tools

@pytest.mark.parametrize("old_format", [True, False])
def test_pack_weights_dump_mode_matches_jax_tool(tmp_path, rng, old_format,
                                                 monkeypatch):
    """`python -m llama_cu_awq_torch.tools.pack_weights <config.json>
    <dump_dir> <out.bin> <old_format>` writes the bytes of the repo's
    tools/pack_weights.py; the .bin loads through the port's loader."""
    dump_tensors(make_awq_tensors(CFG, rng, old_format), tmp_path / "dump")
    (tmp_path / "config.json").write_text(make_hf_config(CFG))
    args = [tmp_path / "config.json", tmp_path / "dump"]
    out = _run_port_tool("pack_weights", *args, tmp_path / "port.bin",
                         int(old_format))
    assert "packed 2-layer model" in out.stdout
    monkeypatch.setattr(sys, "argv", ["pack_weights.py", *map(str, args),
                                      str(tmp_path / "jax.bin"),
                                      str(int(old_format))])
    assert _jax_tool("pack_weights").main() == 0
    assert (tmp_path / "port.bin").read_bytes() == \
        (tmp_path / "jax.bin").read_bytes()
    loaded = load_checkpoint(str(tmp_path / "port.bin"))
    assert loaded.config.n_layers == CFG.n_layers


def test_pack_weights_model_dir_mode_matches_jax_tool(tmp_path, rng,
                                                      monkeypatch):
    """--model-dir: a sharded safetensors directory straight to the .bin,
    byte-identical to the JAX tool's; the packed layer 0 dequantizes to
    the source's (q - z) * s."""
    tensors = make_awq_tensors(CFG, rng, True)
    write_model_dir(tmp_path / "hf", CFG, tensors, shards=2)
    _run_port_tool("pack_weights", "--model-dir", tmp_path / "hf",
                   tmp_path / "port.bin")
    monkeypatch.setattr(sys, "argv", ["pack_weights.py", "--model-dir",
                                      str(tmp_path / "hf"),
                                      str(tmp_path / "jax.bin")])
    assert _jax_tool("pack_weights").main() == 0
    assert (tmp_path / "port.bin").read_bytes() == \
        (tmp_path / "jax.bin").read_bytes()
    loaded = load_checkpoint(str(tmp_path / "port.bin"))
    for name, attr in (("self_attn.q_proj", "wq"), ("mlp.down_proj",
                                                    "w_down")):
        n_in, n_out = tawq.tensor_dims(loaded.config, name)
        qt = getattr(loaded.layers[0], attr)
        w = tpacking.dequantize_np(qt.qw, qt.zeros, qt.scales, qt.n_in)
        base = "model.layers.0." + name
        q = tpacking.awq_unpack_interleaved(
            tensors[base + ".qweight"].view(np.uint32), n_in, n_out)
        z = tpacking.awq_unpack_interleaved(
            tensors[base + ".qzeros"].view(np.uint32),
            -(-n_in // GROUP_SIZE), n_out)
        s = tensors[base + ".scales"].astype(np.float32)
        groups = np.arange(n_in) // GROUP_SIZE
        np.testing.assert_array_equal(
            w, (q - z[groups]).astype(np.float32) * s[groups])
    np.testing.assert_array_equal(loaded.embed,
                                  tensors["model.embed_tokens.weight"])


def test_pack_weights_usage(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "llama_cu_awq_torch.tools.pack_weights"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 1 and "Usage" in out.stderr


@pytest.mark.parametrize("src", ["safetensors", "model_dir", "pt"])
def test_convert_awq_to_bin_matches_jax_tool(tmp_path, rng, src,
                                             monkeypatch):
    """Stage 1 from a .safetensors file, a sharded model directory and a
    .pt state dict: the same dump files, byte for byte, as the repo's
    tools/convert_awq_to_bin.py; the dumps then pack like the source."""
    tensors = make_awq_tensors(CFG, rng, True)
    if src == "safetensors":
        path = tmp_path / "ckpt.safetensors"
        write_safetensors(path, tensors)
    elif src == "model_dir":
        path = tmp_path / "hf"
        write_model_dir(path, CFG, tensors, shards=2)
    else:
        path = tmp_path / "ckpt.pt"
        torch.save({k: torch.from_numpy(v.copy()) for k, v in
                    tensors.items()}, path)
    _run_port_tool("convert_awq_to_bin", path, tmp_path / "port")
    monkeypatch.setattr(sys, "argv", ["convert_awq_to_bin.py", str(path),
                                      str(tmp_path / "jax")])
    assert _jax_tool("convert_awq_to_bin").main() == 0
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    assert len(names) == len(tensors)
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == \
            (tmp_path / "jax" / n).read_bytes()
    (tmp_path / "config.json").write_text(make_hf_config(CFG))
    assert_checkpoints_equal(
        tawq.checkpoint_from_dump_dir(str(tmp_path / "port"),
                                      str(tmp_path / "config.json")),
        jawq.checkpoint_from_tensors(tensors, CFG))


def test_convert_pt_dumps_bf16_bits(tmp_path, rng):
    """A bf16 tensor of a .pt file dumps its raw bits (the JAX tool's
    .numpy() cannot take bf16), which the dump loader's fp16 widening
    reads as the safetensors BF16 path does."""
    a = rng.standard_normal((6, 4)).astype(np.float32)
    torch.save({"w": torch.from_numpy(a).to(torch.bfloat16),
                "i": torch.arange(5, dtype=torch.int32)},
               tmp_path / "m.pt")
    _run_port_tool("convert_awq_to_bin", tmp_path / "m.pt", tmp_path / "out")
    got = np.fromfile(tmp_path / "out" / "w.bin", dtype=np.uint16)
    np.testing.assert_array_equal(got, bf16_bits(a).reshape(-1))
    np.testing.assert_array_equal(
        np.fromfile(tmp_path / "out" / "i.bin", dtype=np.int32),
        np.arange(5, dtype=np.int32))
