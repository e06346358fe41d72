"""The port's corpus builder and end-to-end script against the JAX tools.

- build_corpus: both tools run on the same tree of fake package roots
  (importlib.util.find_spec patched to find them, and to miss the
  packages that are not there) and must write byte-equal train.txt and
  valid.txt: .md and .rst files, then docstrings, the 400-character floor,
  duplicates dropped, and the budget cut in the doc files, in the
  docstrings and not at all.
- real_model_e2e.sh: it parses (bash -n), and every module it runs with
  `python -m` is the port's and exists.
"""

import importlib.util
import os
import re
import subprocess
import sys
import types

import pytest

from llama_cu_awq_torch.tools import build_corpus as tb
from tools import build_corpus as jb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "llama_cu_awq_torch", "tools",
                      "real_model_e2e.sh")


def _prose(seed: int, n: int) -> str:
    """n characters of word-like text, distinct for each seed."""
    words = ["gradient", "array", "module", "install", "function", "value",
             "returns", "the", "of", "a", "shape", "axis", "default"]
    out, i = [], seed
    while sum(map(len, out)) + len(out) < n:
        i = (i * 1103515245 + 12345) % (1 << 31)
        out.append(words[i % len(words)])
    return (" ".join(out))[:n]


def _write(path, text):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        f.write(text)


@pytest.fixture
def fake_packages(tmp_path, monkeypatch):
    """Two installed packages of PACKAGES (numpy, torch) and one that is
    not (the rest): doc files long and short, a duplicate, a non-UTF-8
    byte, nested directories, and sources with long and short docstrings
    and one that does not parse."""
    roots = {"numpy": tmp_path / "site" / "numpy",
             "torch": tmp_path / "site" / "torch"}
    np_root, t_root = map(str, roots.values())
    dup = _prose(3, 900)
    _write(f"{np_root}/README.md", _prose(1, 1200))
    _write(f"{np_root}/doc/guide.rst", _prose(2, 2500) + "\n\n")
    _write(f"{np_root}/doc/short.md", _prose(4, 399))
    _write(f"{np_root}/doc/exact.md", "  " + _prose(5, 400) + "\n")
    _write(f"{np_root}/doc/copy_a.md", dup)
    _write(f"{t_root}/docs/copy_b.rst", "\n" + dup + "\n")
    _write(f"{t_root}/docs/deep/notes.md", _prose(6, 3000))
    with open(f"{t_root}/docs/latin1.md", "wb") as f:
        f.write(_prose(7, 700).encode() + b"\xe9\xff more text")
    src = '''"""{m}"""


class Thing:
    """{c}"""

    def method(self):
        """{s}"""


async def run():
    """{f}"""
'''
    _write(f"{np_root}/core/mod.py", src.format(
        m=_prose(8, 1500), c=_prose(9, 600), s=_prose(10, 100),
        f=_prose(11, 401)))
    _write(f"{np_root}/core/other.py", src.format(
        m=_prose(12, 2000), c=_prose(13, 450), s=_prose(14, 800),
        f=_prose(15, 300)))
    _write(f"{t_root}/nn/layer.py", src.format(
        m=_prose(16, 900), c=_prose(9, 600), s=_prose(17, 1000),
        f=_prose(18, 1200)))
    _write(f"{t_root}/nn/broken.py", "def f(:\n    pass\n")

    def find_spec(name, package=None):
        if name in roots:
            return types.SimpleNamespace(
                submodule_search_locations=[str(roots[name])])
        return None

    monkeypatch.setattr(importlib.util, "find_spec", find_spec)
    return tmp_path


def _run_both(tmp_path, monkeypatch, argv):
    out = {}
    for name in ("jax", "torch"):
        dest = str(tmp_path / f"out_{name}")
        if name == "jax":
            monkeypatch.setattr(sys, "argv",
                                ["build_corpus.py", "--out", dest, *argv])
            assert jb.main() == 0
        else:
            assert tb.main(["--out", dest, *argv]) == 0
        out[name] = {f: open(os.path.join(dest, f), "rb").read()
                     for f in ("train.txt", "valid.txt")}
    return out


@pytest.mark.parametrize("argv", [
    [],                                     # everything, docstrings too
    ["--max-mb", "0.005"],                  # cut inside the doc files
    ["--max-mb", "0.0125"],                 # cut inside the docstrings
    ["--max-mb", "1", "--valid-frac", "0.3"],
], ids=["all", "cut_docfiles", "cut_docstrings", "valid_frac"])
def test_build_corpus_matches_jax(fake_packages, monkeypatch, argv):
    out = _run_both(fake_packages, monkeypatch, argv)
    assert out["torch"] == out["jax"]
    docs = [d for f in ("train.txt", "valid.txt")
            for d in out["torch"][f].decode().split(tb.SEP)]
    assert all(len(d) >= tb.MIN_CHARS for d in docs)
    assert len(set(docs)) == len(docs)
    assert len(out["torch"]["valid.txt"].decode().split(tb.SEP)) >= 2


def test_build_corpus_takes_what_the_budget_allows(fake_packages,
                                                   monkeypatch):
    """The floor keeps a 400-character text and drops a 399-character one;
    a duplicate goes; the doc files come first, then docstrings of more
    than 400 characters; a cut budget ends the corpus."""
    full = _run_both(fake_packages, monkeypatch, [])["torch"]
    cut = _run_both(fake_packages, monkeypatch,
                    ["--max-mb", "0.005"])["torch"]
    text = full["train.txt"] + full["valid.txt"]
    assert _prose(5, 400).encode() in text
    assert _prose(4, 399).encode() not in text
    assert text.count(_prose(3, 900).encode()) == 1
    assert _prose(8, 1500).encode() in text      # a module docstring
    assert _prose(11, 401).encode() in text      # just over the floor
    assert _prose(15, 300).encode() not in text  # under it
    assert text.count(_prose(9, 600).encode()) == 1  # one copy
    cut_text = cut["train.txt"] + cut["valid.txt"]
    assert len(cut_text) < len(text)
    assert _prose(8, 1500).encode() not in cut_text


def test_real_model_e2e_script_parses():
    subprocess.run(["bash", "-n", SCRIPT], check=True)


def test_real_model_e2e_runs_only_port_modules():
    """Every `python -m` module of the script is the port's and exists;
    no JAX tool is left in it, and its bench run is the port's bench."""
    with open(SCRIPT) as f:
        body = "\n".join(line for line in f
                         if not line.lstrip().startswith("#"))
    mods = re.findall(r"python(?: -u)? -m (\S+)", body)
    assert set(mods) == {
        "llama_cu_awq_torch", "llama_cu_awq_torch.tools.build_corpus",
        "llama_cu_awq_torch.tools.train_tiny",
        "llama_cu_awq_torch.tools.pack_weights",
        "llama_cu_awq_torch.tools.ppl_matrix", "llama_cu_awq_torch.bench"}
    for m in mods:
        assert importlib.util.find_spec(m) is not None, m
    assert "llama_cu_awq_tpu" not in body and "tools/" not in body
    assert "bench.py" not in body and "--platform" not in body
