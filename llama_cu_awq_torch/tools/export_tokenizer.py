"""Write the engine's `tokenizer.bin` vocab file.

The port's copy of tools/export_tokenizer.py, with its command line and
its bytes. The reference ships a 433 KB `tokenizer.bin` (llama2.c
format, read by tokenizer.h:47-58); this repository checks in no binary
files, so a fresh checkout makes one with this tool, from a llama-2
sentencepiece model (an HF checkout's tokenizer.model) or by validating
and copying an existing llama2.c-format file.

Output format (llama2.c, identical to the reference's file):
  int32 max_token_length, then vocab_size x (float32 score, int32 len,
  len bytes of the piece). Byte pieces `<0xXX>` are written as the raw
  byte and sentencepiece's U+2581 word-boundary marker becomes a plain
  space, as llama2.c's tokenizer export does.

The sentencepiece path needs no sentencepiece install: a .model file is
a protobuf whose `pieces` records (field 1) carry piece (field 1,
string), score (field 2, float) and type (field 3, enum); the minimal
wire-format walker below reads exactly those.

Usage:
  python -m llama_cu_awq_torch.tools.export_tokenizer --from-sentencepiece tokenizer.model -o tokenizer.bin
  python -m llama_cu_awq_torch.tools.export_tokenizer --from-bin /path/to/tokenizer.bin -o tokenizer.bin [--vocab-size 32000]
"""

from __future__ import annotations

import argparse
import os
import struct
import sys


def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    shift = 0
    val = 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def _skip_field(buf: bytes, i: int, wire: int) -> int:
    if wire == 0:
        _, i = _read_varint(buf, i)
    elif wire == 1:
        i += 8
    elif wire == 2:
        ln, i = _read_varint(buf, i)
        i += ln
    elif wire == 5:
        i += 4
    else:
        raise ValueError(f"unsupported protobuf wire type {wire}")
    return i


def parse_sentencepiece_model(path: str):
    """[(piece_bytes, score, type)] from a sentencepiece .model protobuf.

    ModelProto.pieces = repeated SentencePiece (field 1); SentencePiece:
    piece (1, bytes), score (2, float), type (3, enum; NORMAL=1,
    UNKNOWN=2, CONTROL=3, USER_DEFINED=4, BYTE=6, UNUSED=5).
    """
    with open(path, "rb") as f:
        buf = f.read()
    pieces = []
    i, n = 0, len(buf)
    while i < n:
        tag, i = _read_varint(buf, i)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:  # one SentencePiece message
            ln, i = _read_varint(buf, i)
            sub = buf[i:i + ln]
            i += ln
            piece, score, ptype = b"", 0.0, 1
            j = 0
            while j < len(sub):
                t, j = _read_varint(sub, j)
                f_, w = t >> 3, t & 7
                if f_ == 1 and w == 2:
                    pl_, j = _read_varint(sub, j)
                    piece = sub[j:j + pl_]
                    j += pl_
                elif f_ == 2 and w == 5:
                    (score,) = struct.unpack("<f", sub[j:j + 4])
                    j += 4
                elif f_ == 3 and w == 0:
                    ptype, j = _read_varint(sub, j)
                else:
                    j = _skip_field(sub, j, w)
            pieces.append((piece, score, ptype))
        else:
            i = _skip_field(buf, i, wire)
    return pieces


def export_from_sentencepiece(model_path: str, out_path: str) -> int:
    """sentencepiece .model -> llama2.c tokenizer.bin (llama2.c's
    tokenizer export semantics: <0xXX> BYTE pieces -> the raw byte,
    U+2581 -> ' ')."""
    pieces = parse_sentencepiece_model(model_path)
    if not pieces:
        raise SystemExit(f"{model_path}: no sentencepiece pieces found")
    records = []
    for piece, score, ptype in pieces:
        if ptype == 6 and piece.startswith(b"<0x") and piece.endswith(b">"):
            data = bytes([int(piece[3:5], 16)])  # BYTE piece -> raw byte
        else:
            data = piece.replace("▁".encode(), b" ")
        records.append((data, score))
    max_len = max(len(d) for d, _ in records)
    with open(out_path, "wb") as f:
        f.write(struct.pack("<i", max_len))
        for data, score in records:
            f.write(struct.pack("<fi", score, len(data)))
            f.write(data)
    return len(records)


def copy_validated_bin(src: str, out_path: str, vocab_size: int) -> int:
    """Validate an existing llama2.c tokenizer.bin through the port's
    Tokenizer, then copy it."""
    from llama_cu_awq_torch.tokenizer import Tokenizer

    tok = Tokenizer(src, vocab_size)  # raises on malformed input
    probe = tok.encode("hello world", bos=True, eos=False)
    if len(probe) < 2:
        raise SystemExit(f"{src}: vocab loads but encoding is degenerate")
    with open(src, "rb") as fi, open(out_path, "wb") as fo:
        fo.write(fi.read())
    return tok.vocab_size


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m llama_cu_awq_torch.tools.export_tokenizer",
        description=__doc__.splitlines()[0])
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--from-sentencepiece", metavar="MODEL",
                     help="llama-2 tokenizer.model (HF checkout)")
    src.add_argument("--from-bin", metavar="BIN",
                     help="existing llama2.c-format tokenizer.bin")
    ap.add_argument("-o", "--out", default="tokenizer.bin")
    ap.add_argument("--vocab-size", type=int, default=32000,
                    help="expected vocab size for --from-bin validation")
    args = ap.parse_args(argv)
    if args.from_sentencepiece:
        n = export_from_sentencepiece(args.from_sentencepiece, args.out)
    else:
        n = copy_validated_bin(args.from_bin, args.out, args.vocab_size)
    print(f"wrote {args.out}: {n} pieces "
          f"({os.path.getsize(args.out)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
