"""The port's real-model tools held to the JAX package's tools/ on the CPU.

- ppl_matrix: the port's rows (plain versions of the kernels on the
  CPU) against the JAX tool's own run (its stepwise_dataset_ppl and
  MATRIX over the JAX InferenceEngine), on the same `.bin` and text:
  every row within rel 2e-3 (tests/test_torch_prefill.py's perplexity
  bar), the same labels, order and sequence counts, the same Markdown
  table and JSON keys (with `device` for `platform`). The model has
  head_dim 128, so the fused_step rows take the attention_step path
  (tools/real_model_e2e.sh:20-25 says why that matters).
- make_test_model: byte-identical model.bin and tokenizer.bin.
- export_tokenizer: byte-identical output from a sentencepiece .model
  and from --from-bin; garbage rejected as the JAX tool rejects it.
"""

import json
import os
import struct
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from llama_cu_awq_torch.config import ModelConfig as TModelConfig
from llama_cu_awq_torch.io.checkpoint import random_checkpoint as t_random
from llama_cu_awq_torch.io.checkpoint import save_checkpoint as t_save
from llama_cu_awq_torch.tools import export_tokenizer as t_export
from llama_cu_awq_torch.tools import make_test_model as t_make
from llama_cu_awq_torch.tools import ppl_matrix as t_ppl
from tests.test_export_tokenizer import make_sp_model
from tests.test_tokenizer import write_toy_tokenizer
from tests.test_torch_engine import _toy_vocab
from tools import export_tokenizer as j_export
from tools import make_test_model as j_make
from tools import ppl_matrix as j_ppl

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "OMP_NUM_THREADS": "1"}

# head_dim 128: the attention_step kernel's path on the fused_step rows
CFG = TModelConfig(dim=256, hidden_dim=512, n_layers=2, n_heads=2,
                   n_kv_heads=2, vocab_size=512, seq_len=256)
TEXT = ("the cat sat on the mat<|endoftext|>a cat sat on a mat the cat"
        "<|endoftext|>the mat sat on the cat on the mat")


def _run_jax_main(monkeypatch, module, argv):
    """A JAX tool's main() on argv (sys.argv), without the JAX tool's
    persistent compilation cache outside the checkout."""
    real = jax.config.update

    def update(name, value):
        if name != "jax_compilation_cache_dir":
            real(name, value)

    monkeypatch.setattr(jax.config, "update", update)
    monkeypatch.setattr(sys, "argv", [module.__file__, *argv])
    return module.main()


@pytest.fixture(scope="module")
def ppl_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ppl")
    paths = {k: str(tmp / n) for k, n in (("bin", "m.bin"),
                                          ("tok", "tok.bin"),
                                          ("text", "valid.txt"))}
    t_save(paths["bin"], t_random(CFG, seed=3))
    write_toy_tokenizer(paths["tok"], _toy_vocab(CFG.vocab_size))
    with open(paths["text"], "w") as f:
        f.write(TEXT)
    return tmp, paths


@pytest.fixture(scope="module")
def jax_matrix(ppl_files):
    """The JAX tool's whole matrix: its printed table and its JSON."""
    tmp, p = ppl_files
    out = str(tmp / "jax.json")
    with pytest.MonkeyPatch.context() as mp:
        import contextlib
        import io

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            _run_jax_main(mp, j_ppl, [p["bin"], "-z", p["tok"], "-q",
                                      p["text"], "--json", out])
    with open(out) as f:
        return buf.getvalue(), json.load(f)


def test_ppl_matrix_rows_match_the_jax_tool(ppl_files, jax_matrix, capsys):
    """`python -m llama_cu_awq_torch.tools.ppl_matrix ... --device cpu`:
    the JAX tool's labels, order and sequence counts, every row within
    rel 2e-3, its Markdown table's form and its JSON keys."""
    tmp, p = ppl_files
    jtable, jjson = jax_matrix
    out = str(tmp / "torch.json")
    assert t_ppl.main([p["bin"], "-z", p["tok"], "-q", p["text"],
                       "--device", "cpu", "--json", out]) == 0
    table = capsys.readouterr().out
    with open(out) as f:
        tjson = json.load(f)
    assert [label for label, _, _ in t_ppl.MATRIX] == \
        [label for label, _, _ in j_ppl.MATRIX]
    assert [r["config"] for r in tjson["rows"]] == \
        [r["config"] for r in jjson["rows"]] == \
        [label for label, _, _ in j_ppl.MATRIX]
    assert [r["sequences"] for r in tjson["rows"]] == \
        [r["sequences"] for r in jjson["rows"]] == [3] * 8
    for t, j in zip(tjson["rows"], jjson["rows"]):
        assert np.isfinite(t["geomean_ppl"])
        assert t["geomean_ppl"] == pytest.approx(j["geomean_ppl"],
                                                 rel=2e-3), t["config"]
    # the port's table of the JAX rows is the JAX tool's table
    assert t_ppl.table(jjson["rows"]) + "\n" == jtable
    assert table == t_ppl.table(tjson["rows"]) + "\n"
    assert set(tjson) - {"device"} == set(jjson) - {"platform"}
    assert tjson["device"] == "cpu" and tjson["seqs"] == jjson["seqs"]
    assert t_ppl.fused_step_taken(CFG)


def test_ppl_matrix_only_and_stepwise(ppl_files, jax_matrix, capsys):
    """--only filters by label substring (the table then compares to the
    first row it ran) and no match exits; score_row, called as a
    library, gives the tool's row."""
    tmp, p = ppl_files
    _, jjson = jax_matrix
    out = str(tmp / "only.json")
    assert t_ppl.main([p["bin"], "-z", p["tok"], "-q", p["text"],
                       "--device", "cpu", "--only", "int8 KV",
                       "--json", out]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "| Config | geomean PPL | vs int8 KV, einsum |"
    with open(out) as f:
        rows = json.load(f)["rows"]
    assert [r["config"] for r in rows] == ["int8 KV, einsum",
                                           "int8 KV, fused_step"]
    with pytest.raises(SystemExit, match="matched no matrix configs"):
        t_ppl.main([p["bin"], "-z", p["tok"], "-q", p["text"],
                    "--device", "cpu", "--only", "nothing"])
    params, cfg, tok = t_ppl.load(p["bin"], p["tok"], "cpu")
    assert params.lm_head.dtype == torch.float16  # the JAX tool's head
    label, kw, bits = t_ppl.MATRIX[3]
    row = t_ppl.score_row(params, cfg, tok, TEXT, 30, label, kw, bits,
                          "cpu")
    assert row == rows[1]
    assert row["geomean_ppl"] == pytest.approx(
        jjson["rows"][3]["geomean_ppl"], rel=2e-3)


def test_ppl_matrix_falls_back_where_the_kernel_cannot_take(tmp_path,
                                                            capsys):
    """head_dim 16 (make_test_model's model): attention_step does not
    take it, the tool says so, and the fused_step rows run plain
    attention, as the JAX tool's fall back to einsum."""
    assert t_make.main([str(tmp_path)]) == 0
    capsys.readouterr()
    text = tmp_path / "t.txt"
    text.write_text("hello world<|endoftext|>a b c d")
    assert t_ppl.main([str(tmp_path / "model.bin"), "-z",
                       str(tmp_path / "tokenizer.bin"), "-q", str(text),
                       "--device", "cpu", "--only", "bf16"]) == 0
    cap = capsys.readouterr()
    assert "does not take head_dim=16" in cap.err
    vals = [ln.split("|")[2] for ln in cap.out.splitlines()[2:]]
    assert len(vals) == 2 and vals[0] == vals[1]


# ---------------------------------------------------------------------------
# make_test_model

@pytest.mark.parametrize("opts", [[], ["--vocab-size", "300", "--dim", "128",
                                       "--layers", "1", "--seq-len", "64"]])
def test_make_test_model_bytes_match_the_jax_tool(tmp_path, monkeypatch,
                                                  capsys, opts):
    """model.bin and tokenizer.bin byte for byte the JAX tool's."""
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    _run_jax_main(monkeypatch, j_make, [str(jdir), *opts])
    assert t_make.main([str(tdir), *opts]) == 0
    assert "wrote" in capsys.readouterr().out
    for name in ("model.bin", "tokenizer.bin"):
        assert (tdir / name).read_bytes() == (jdir / name).read_bytes()
    (tmp_path / "w.bin").write_bytes(b"")
    t_make.write_byte_tokenizer(str(tmp_path / "w.bin"), 300)
    j_make.write_byte_tokenizer(str(tmp_path / "wj.bin"), 300)
    assert (tmp_path / "w.bin").read_bytes() == \
        (tmp_path / "wj.bin").read_bytes()


# ---------------------------------------------------------------------------
# export_tokenizer

SP_PIECES = [(b"<unk>", 0.0, 2), (b"<s>", 0.0, 3), (b"</s>", 0.0, 3),
             (b"<0x41>", 0.0, 6), ("▁hello".encode(), -1.5, 1),
             (b"world", -2.25, 1), ("▁w".encode(), -3.0, 1)]


def test_export_from_sentencepiece_matches_the_jax_tool(tmp_path):
    """The wire-format walker and the llama2.c writer: the JAX tool's
    pieces and bytes, through the function and through `python -m`."""
    model = tmp_path / "tok.model"
    model.write_bytes(make_sp_model(SP_PIECES))
    assert t_export.parse_sentencepiece_model(str(model)) == \
        j_export.parse_sentencepiece_model(str(model))
    n = t_export.export_from_sentencepiece(str(model),
                                           str(tmp_path / "t.bin"))
    assert n == j_export.export_from_sentencepiece(str(model),
                                                   str(tmp_path / "j.bin"))
    want = (tmp_path / "j.bin").read_bytes()
    assert (tmp_path / "t.bin").read_bytes() == want
    r = subprocess.run(
        [sys.executable, "-m", "llama_cu_awq_torch.tools.export_tokenizer",
         "--from-sentencepiece", str(model), "-o", str(tmp_path / "m.bin")],
        cwd=REPO, env=ENV, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert f"{len(SP_PIECES)} pieces" in r.stdout
    assert (tmp_path / "m.bin").read_bytes() == want


def test_export_from_bin_matches_the_jax_tool(tmp_path):
    """--from-bin validates a toy tokenizer.bin through the port's
    Tokenizer and copies it byte for byte, as the JAX tool does."""
    src = tmp_path / "toy.bin"
    write_toy_tokenizer(str(src), _toy_vocab(512))
    assert t_export.copy_validated_bin(str(src), str(tmp_path / "t.bin"),
                                       512) == 512
    assert j_export.copy_validated_bin(str(src), str(tmp_path / "j.bin"),
                                       512) == 512
    assert (tmp_path / "t.bin").read_bytes() == src.read_bytes() == \
        (tmp_path / "j.bin").read_bytes()
    assert t_export.main(["--from-bin", str(src), "-o",
                          str(tmp_path / "m.bin"), "--vocab-size",
                          "512"]) == 0
    assert (tmp_path / "m.bin").read_bytes() == src.read_bytes()


@pytest.mark.parametrize("garbage", [b"\x01\x02\x03",
                                     struct.pack("<i", 4) + b"\x00" * 6])
def test_export_rejects_garbage_as_the_jax_tool(tmp_path, garbage):
    """A truncated or malformed file raises the JAX tool's exception and
    writes nothing."""
    bad = tmp_path / "bad.bin"
    bad.write_bytes(garbage)
    with pytest.raises(Exception) as je:
        j_export.copy_validated_bin(str(bad), str(tmp_path / "j.bin"), 512)
    with pytest.raises(type(je.value)):
        t_export.copy_validated_bin(str(bad), str(tmp_path / "t.bin"), 512)
    assert not (tmp_path / "t.bin").exists()
    with pytest.raises(SystemExit):
        t_export.main([])  # one source is required
