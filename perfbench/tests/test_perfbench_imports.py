"""What the benchmark loads: never JAX or the JAX package, compared by
whole top-level name, and a reference that imports nothing of the
program."""

import ast
import os
import subprocess
import sys

import pytest

from perfbench import run

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def test_whole_top_level_names(monkeypatch):
    for name in ("llama_cu_awq_torch", "llama_cu_awq_torch.engine",
                 "jaxtyping", "flax_like"):
        monkeypatch.setitem(sys.modules, name, object())
    for bad in ("jax", "jaxlib", "flax", "llama_cu_awq_tpu"):
        monkeypatch.delitem(sys.modules, bad, raising=False)
    assert run.forbidden_modules() == []
    for bad in ("jax.numpy", "llama_cu_awq_tpu.engine"):
        monkeypatch.setitem(sys.modules, bad, object())
    assert run.forbidden_modules() == ["jax", "llama_cu_awq_tpu"]


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module)
    return out


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            tops = {m.split(".")[0] for m in _imports(os.path.join(ref, f))}
            assert tops <= {"__future__", "math", "torch"}, (f, tops)


def test_no_benchmark_source_names_jax():
    for dirpath, _, files in os.walk(BENCH):
        if os.path.basename(dirpath) == "tests":
            continue
        for f in files:
            if f.endswith(".py"):
                tops = {m.split(".")[0] for m in
                        _imports(os.path.join(dirpath, f))}
                assert not tops & set(run.FORBIDDEN), (f, tops)


def test_a_run_loads_no_jax():
    """Import what a run imports, the program's engines with it, in a
    fresh interpreter, and look at sys.modules."""
    code = ("import sys; sys.path.insert(0, %r); "
            "from perfbench import run, port, judge, control, check_line; "
            "port.program(); "
            "from perfbench.drivers import batch, sequence; "
            "print(run.forbidden_modules())" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_a_checkout_without_the_program_prints_no_result(tmp_path):
    """A directory with only BENCHMARK.json and perfbench/: no result
    line, a non-zero exit."""
    import shutil
    shutil.copytree(BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "mistral-7b.decode_b1", "--seed", "3", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card(tmp_path):
    """One short run of the first cell on the card, its line checked."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from perfbench import check_line
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "mistral-7b.decode_b1", "--seed", "2147483999", "--seconds", "3",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    (tmp_path / "out.txt").write_text(out.stdout)
    assert check_line.main(["--workload", "mistral-7b.decode_b1",
                            "--trace", "0", str(tmp_path / "out.txt")]) == 0
