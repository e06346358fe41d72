"""Assemble a real-text training corpus from the documentation shipped with
installed Python packages (markdown and rst files, then module, class and
function docstrings): human-written English technical prose, the only
sizable natural text on a machine without a network.

The port's copy of tools/build_corpus.py: the same package list and order,
the same 400-character floor, budget and interleaved holdout, so the same
package roots give byte-equal train.txt and valid.txt. A package that is
not installed (jax, flax and optax where only the port runs) is skipped.

Documents are separated by <|endoftext|>, the delimiter the perplexity
harness splits on (engine/perplexity.py), so the corpus doubles as a
perplexity dataset.

Usage:
  python -m llama_cu_awq_torch.tools.build_corpus --out <dir> [--max-mb 12] [--valid-frac 0.02]
"""

from __future__ import annotations

import argparse
import ast
import glob
import os
import sys

PACKAGES = ["numpy", "scipy", "jax", "pandas", "sklearn", "torch",
            "transformers", "matplotlib", "sympy", "networkx", "PIL",
            "seaborn", "statsmodels", "nltk", "flax", "optax"]

SEP = "<|endoftext|>"
MIN_CHARS = 400  # shorter texts are headings, stubs and tables


def iter_docfiles(roots):
    for root in roots:
        for pat in ("**/*.md", "**/*.rst"):
            yield from glob.glob(os.path.join(root, pat), recursive=True)


def docstrings_from_py(path: str):
    """The module, class and function docstrings of a source file that are
    longer than MIN_CHARS."""
    try:
        with open(path, encoding="utf-8", errors="ignore") as f:
            tree = ast.parse(f.read())
    except (SyntaxError, ValueError, RecursionError):
        return
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            doc = ast.get_docstring(node, clean=True)
            if doc and len(doc) > MIN_CHARS:
                yield doc


def package_roots() -> list[str]:
    """The first search location of each installed package of PACKAGES."""
    import importlib.util

    roots = []
    for pkg in PACKAGES:
        spec = importlib.util.find_spec(pkg)
        if spec and spec.submodule_search_locations:
            roots.append(list(spec.submodule_search_locations)[0])
    return roots


def collect(roots, budget: int) -> list[str]:
    """Documents in order (doc files sorted by path, then docstrings root
    by root), each stripped, at least MIN_CHARS long and new, until their
    characters pass `budget`."""
    docs: list[str] = []
    seen: set[int] = set()
    total = 0

    def add(text: str):
        nonlocal total
        text = text.strip()
        h = hash(text)
        if len(text) < MIN_CHARS or h in seen:
            return
        seen.add(h)
        docs.append(text)
        total += len(text)

    for f in sorted(iter_docfiles(roots)):
        try:
            with open(f, encoding="utf-8", errors="ignore") as fh:
                add(fh.read())
        except OSError:
            continue
        if total > budget:
            break
    if total < budget:
        for root in roots:
            for f in sorted(glob.glob(os.path.join(root, "**/*.py"),
                                      recursive=True)):
                for doc in docstrings_from_py(f):
                    add(doc)
                    if total > budget:
                        break
                if total > budget:
                    break
            if total > budget:
                break
    return docs


def split(docs: list[str], valid_frac: float):
    """(train, valid): a deterministic interleaved holdout, since documents
    arrive grouped by package and a tail split would make validation all
    one package."""
    n_valid = max(2, int(len(docs) * valid_frac))
    valid = docs[:: max(len(docs) // n_valid, 1)][:n_valid]
    vset = {id(d) for d in valid}
    return [d for d in docs if id(d) not in vset], valid


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m llama_cu_awq_torch.tools.build_corpus",
        description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--max-mb", type=float, default=12.0)
    ap.add_argument("--valid-frac", type=float, default=0.02)
    args = ap.parse_args(argv)

    docs = collect(package_roots(), int(args.max_mb * 1e6))
    os.makedirs(args.out, exist_ok=True)
    train, valid = split(docs, args.valid_frac)
    for name, part in (("train.txt", train), ("valid.txt", valid)):
        with open(os.path.join(args.out, name), "w", encoding="utf-8") as f:
            f.write(SEP.join(part))
    print(f"corpus: {len(train)} train docs ({sum(map(len, train))/1e6:.1f}"
          f" MB), {len(valid)} valid docs "
          f"({sum(map(len, valid))/1e6:.2f} MB)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
