"""The PyTorch port's weight formats against the JAX package, and the
port's independence from JAX.

A `.bin` written by the JAX package's random_checkpoint + save_checkpoint
is loaded by both packages; the dequantized weights must be bit-equal
(tolerance 0: both compute (q - z) * s exactly in f32 from the same
nibbles and fp16 scales).
"""

import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from llama_cu_awq_torch.io.checkpoint import load_checkpoint as t_load
from llama_cu_awq_torch.io.checkpoint import save_checkpoint as t_save
from llama_cu_awq_torch.models import params_from_checkpoint
from llama_cu_awq_torch.quant.packing import dequantize_np as t_dequant_np
from llama_cu_awq_torch.quant.qtensor import QTensor
from llama_cu_awq_tpu.io.checkpoint import load_checkpoint as j_load
from llama_cu_awq_tpu.io.checkpoint import random_checkpoint, save_checkpoint
from llama_cu_awq_tpu.quant.packing import dequantize_np as j_dequant_np

# one intra-op thread per process: the suite runs in several worker
# processes, and torch's default pool in each oversubscribes the cores
# (tens of times slower on small tensors); it also fixes the CPU sum order
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_QNAMES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


@pytest.mark.parametrize("cfg_name", ["tiny_config", "tiny_mha_config"])
def test_bin_roundtrip_bit_equal(request, tmp_path, cfg_name):
    cfg = request.getfixturevalue(cfg_name)
    path = str(tmp_path / "model.bin")
    save_checkpoint(path, random_checkpoint(cfg, seed=7))
    jc, tc = j_load(path), t_load(path)
    assert dataclasses.astuple(tc.config) == dataclasses.astuple(jc.config)
    for a, b in ((jc.embed, tc.embed), (jc.lm_head, tc.lm_head),
                 (jc.final_norm, tc.final_norm)):
        assert np.array_equal(a, b)
    for jl, tl in zip(jc.layers, tc.layers):
        for name in _QNAMES:
            jq, tq = getattr(jl, name), getattr(tl, name)
            want = j_dequant_np(jq.qw, jq.zeros, jq.scales, jq.n_in)
            assert np.array_equal(
                t_dequant_np(tq.qw, tq.zeros, tq.scales, tq.n_in), want)
            gpu = QTensor.from_numpy(tq.qw, tq.zeros, tq.scales, tq.n_in)
            assert np.array_equal(gpu.dequantize().numpy(), want)
    # the port writes the same bytes back
    out = str(tmp_path / "again.bin")
    t_save(out, tc)
    with open(path, "rb") as f1, open(out, "rb") as f2:
        assert f1.read() == f2.read()


def test_gpu_layout_is_the_file_layout(tmp_path, tiny_config):
    """qw is the file's (n_out, packed_height) uint32 array minus its
    alignment padding; scales and zeros are the file's (n_out, g)."""
    path = str(tmp_path / "model.bin")
    ckpt = random_checkpoint(tiny_config, seed=3)
    save_checkpoint(path, ckpt)
    raw = t_load(path).layers[0].w_down  # n_in = hidden_dim = 160
    qt = QTensor.from_numpy(raw.qw, raw.zeros, raw.scales, raw.n_in)
    assert qt.qw.dtype == torch.int32
    assert tuple(qt.qw.shape) == (raw.n_out, -(-raw.n_in // 8))
    assert np.array_equal(qt.qw.numpy().view(np.uint32), raw.qw.T)
    assert qt.scales.dtype == torch.float16
    assert np.array_equal(qt.scales.float().numpy(), raw.scales.T)
    assert np.array_equal(qt.zeros.numpy(), raw.zeros.T.astype(np.uint8))


def test_params_fuse_qkv_and_gate_up(tiny_config):
    ckpt = random_checkpoint(tiny_config, seed=5)
    p = params_from_checkpoint(ckpt, device="cpu")
    l0 = ckpt.layers[0]
    wqkv = p.layers[0].wqkv.dequantize().numpy()
    parts = [j_dequant_np(q.qw, q.zeros, q.scales, q.n_in)
             for q in (l0.wq, l0.wk, l0.wv)]
    assert np.array_equal(wqkv, np.concatenate(parts, axis=1))
    gu = p.layers[0].w_gate_up.dequantize().numpy()
    parts = [j_dequant_np(q.qw, q.zeros, q.scales, q.n_in)
             for q in (l0.w_gate, l0.w_up)]
    assert np.array_equal(gu, np.concatenate(parts, axis=1))
    assert p.embed.dtype == torch.bfloat16


def test_import_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import llama_cu_awq_torch, llama_cu_awq_torch.cli\n"
        "import llama_cu_awq_torch.engine, llama_cu_awq_torch.models\n"
        "import llama_cu_awq_torch.ops.cuda.attention_step\n"
        "import llama_cu_awq_torch.ops.cuda.dense_gemv\n"
        "import llama_cu_awq_torch.ops.cuda.int4_matmul\n"
        "bad = [m for m in sys.modules if m.startswith('llama_cu_awq_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


_IMPORT_RE = re.compile(
    r"^\s*(import|from)\s+(jax|ml_dtypes|llama_cu_awq_tpu)\b", re.M)


def test_no_jax_import_in_port_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "llama_cu_awq_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 15
    for f in files:
        with open(f) as fh:
            src = fh.read()
        assert not _IMPORT_RE.search(src), f
        assert "__import__(" not in src, f


def test_entry_points_refuse_missing_cuda(monkeypatch, tiny_config):
    """The entry points default to the card and raise without one; they
    never move to the CPU on their own."""
    from llama_cu_awq_torch.cli import main
    from llama_cu_awq_torch.models import synthetic_params

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        synthetic_params(tiny_config)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_checkpoint(random_checkpoint(tiny_config, seed=1))
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["missing.bin", "-n", "4"])
