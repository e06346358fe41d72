"""Write a tiny random model.bin and a matching llama2.c tokenizer.bin,
to try the CLI and the server without a real AWQ checkpoint.

The port's copy of tools/make_test_model.py: the same configuration and
the same bytes (io/checkpoint.py random_checkpoint of seed 0 and
save_checkpoint; a byte-fallback tokenizer).

Usage:
  python -m llama_cu_awq_torch.tools.make_test_model <outdir> [--vocab-size N] [--dim D] [--layers L] [--seq-len S]
"""

from __future__ import annotations

import argparse
import os
import struct
import sys


def write_byte_tokenizer(path: str, vocab_size: int) -> None:
    """A tokenizer whose vocab is the specials, the 256 raw bytes and
    filler (valid llama2.c format, byte fallback only)."""
    vocab = [(b"<unk>", 0.0), (b"<s>", 0.0), (b"</s>", 0.0)]
    vocab += [(bytes([b]), -1.0) for b in range(256)]
    while len(vocab) < vocab_size:
        vocab.append((b"<pad%d>" % len(vocab), -1000.0))
    with open(path, "wb") as f:
        f.write(struct.pack("<i", max(len(v) for v, _ in vocab)))
        for piece, score in vocab[:vocab_size]:
            f.write(struct.pack("<fi", score, len(piece)))
            f.write(piece)


def main(argv=None) -> int:
    from llama_cu_awq_torch.config import ModelConfig
    from llama_cu_awq_torch.io.checkpoint import (random_checkpoint,
                                                  save_checkpoint)

    ap = argparse.ArgumentParser(
        prog="python -m llama_cu_awq_torch.tools.make_test_model",
        description=__doc__.splitlines()[0])
    ap.add_argument("outdir")
    ap.add_argument("--vocab-size", type=int, default=512)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=256)
    args = ap.parse_args(argv)

    os.makedirs(args.outdir, exist_ok=True)
    cfg = ModelConfig(dim=args.dim, hidden_dim=args.dim * 2 + args.dim // 2,
                      n_layers=args.layers, n_heads=4, n_kv_heads=2,
                      vocab_size=args.vocab_size, seq_len=args.seq_len)
    ckpt = random_checkpoint(cfg, seed=0)
    model_path = os.path.join(args.outdir, "model.bin")
    tok_path = os.path.join(args.outdir, "tokenizer.bin")
    save_checkpoint(model_path, ckpt)
    write_byte_tokenizer(tok_path, cfg.vocab_size)
    print(f"wrote {model_path} and {tok_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
