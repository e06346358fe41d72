"""llama2.c-format BPE tokenizer (a copy of llama_cu_awq_tpu/tokenizer.py).

Behavioral re-implementation of the reference's host tokenizer
(reference: tokenizer.h:1-223): binary vocab file, greedy highest-score
pair merges, UTF-8 byte-fallback with the +3 offset, dummy-prefix space,
BOS-leading-space strip on decode, and `<0xXX>` byte-piece handling.

A native C++ fast path (O(n log n) merge loop) is used automatically when
the optional shared library built from native/bpe_tokenizer.cpp is present.
"""

from __future__ import annotations

import os
import struct

BOS_TOKEN = 1  # reference: tokenizer.h:8
EOS_TOKEN = 2  # reference: tokenizer.h:9


def _resolve_lookup(vocab: list[bytes]) -> dict[bytes, int]:
    """piece -> token id, resolving DUPLICATE pieces exactly as the
    reference's `str_lookup` does (tokenizer.h:95-100).

    The llama-2 tokenizer.bin stores byte-fallback pieces as raw bytes,
    so every printable ASCII char (and 108 two-byte UTF-8 sequences)
    appears TWICE: once as the byte token (id = byte + 3) and once as a
    real sentencepiece piece (e.g. 'x' at both 123 and 29916). The
    reference qsorts (str, id) records by strcmp and bsearches — which
    duplicate it returns is whatever the search lands on, and the
    engine's encodings (initial codepoint lookups AND merge-concat
    lookups, which set merge scores) depend on that choice. Reproduce it
    exactly: stable-sort by the C-string key (strcmp stops at NUL), then
    walk glibc bsearch's midpoint sequence to find the landing index.
    Validated piece-for-piece against a compiled reference harness over
    all 255 single-byte strings (tests/test_reference_parity.py)."""
    def ckey(p: bytes) -> bytes:
        i = p.find(b"\0")
        return p if i < 0 else p[:i]

    order = sorted(range(len(vocab)), key=lambda i: ckey(vocab[i]))
    keys = [ckey(vocab[i]) for i in order]
    n = len(keys)
    resolved: dict[bytes, int] = {}
    for i, piece in enumerate(vocab):
        key = ckey(piece)
        if key in resolved:
            continue
        lo, hi = 0, n
        while lo < hi:
            mid = (lo + hi) // 2
            if key < keys[mid]:
                hi = mid
            elif key > keys[mid]:
                lo = mid + 1
            else:
                resolved[key] = order[mid]
                break
    return resolved


class Tokenizer:
    def __init__(self, path: str, vocab_size: int):
        """Load a llama2.c tokenizer.bin (reference: tokenizer.h:35-59).

        File format: int32 max_token_length, then vocab_size records of
        (float32 score, int32 len, len bytes).
        """
        self.vocab_size = vocab_size
        self.vocab: list[bytes] = []
        self.scores: list[float] = []
        with open(path, "rb") as f:
            (self.max_token_length,) = struct.unpack("<i", f.read(4))
            for _ in range(vocab_size):
                score, ln = struct.unpack("<fi", f.read(8))
                self.vocab.append(f.read(ln))
                self.scores.append(score)
        self._lookup = _resolve_lookup(self.vocab)
        self._native = _load_native_for(self)

    def str_lookup(self, piece: bytes) -> int:
        if b"\0" in piece:  # C-string semantics (strcmp stops at NUL)
            piece = piece.split(b"\0", 1)[0]
        return self._lookup.get(piece, -1)

    def encode(self, text: str | bytes, bos: bool, eos: bool) -> list[int]:
        """Encode text to token ids (reference: tokenizer.h:102-223)."""
        if isinstance(text, str):
            text = text.encode("utf-8")
        tokens: list[int] = []
        if bos:
            tokens.append(BOS_TOKEN)
        if text != b"":
            # add_dummy_prefix (reference: tokenizer.h:128-136)
            tokens.append(self._lookup[b" "])

        # split raw bytes into UTF-8 codepoints (max 4 bytes), with byte
        # fallback (+3 offset: first 3 vocab slots are <unk>,<s>,</s>)
        i, n = 0, len(text)
        while i < n:
            j = i + 1
            # consume continuation bytes (10xxxxxx), capped at 4 total
            while j < n and (text[j] & 0xC0) == 0x80 and (j - i) < 4:
                j += 1
            chunk = text[i:j]
            tid = self.str_lookup(chunk)
            if tid != -1:
                tokens.append(tid)
            else:
                tokens.extend(b + 3 for b in chunk)
            i = j

        start = 1 if bos else 0
        if self._native is not None:
            merged = self._native.merge(tokens[start:])
            tokens = tokens[:start] + merged
        else:
            tokens = tokens[:start] + self._merge_py(tokens[start:])
        if eos:
            tokens.append(EOS_TOKEN)
        return tokens

    def _merge_py(self, tokens: list[int]) -> list[int]:
        """Greedy best-scoring pair merge (reference: tokenizer.h:188-217).

        The reference rescans the sequence per merge (O(n^2)); this uses
        a linked list + lazy max-heap of candidate pairs (O(n log n)) —
        the same algorithm as native/bpe_tokenizer.cpp. Tie-break parity:
        a merged node keeps its LEFT constituent's slot index, so slot
        order equals list order and (score desc, slot asc) reproduces
        the reference's left-to-right strict-> argmax scan exactly."""
        import heapq

        n = len(tokens)
        if n <= 1:
            return list(tokens)
        vocab, scores, lookup = self.vocab, self.scores, self._lookup
        ids = list(tokens)
        nxt = list(range(1, n)) + [-1]
        prv = [-1] + list(range(n - 1))
        stamp = [0] * n
        heap: list = []

        def push(a: int):
            b = nxt[a]
            if a < 0 or b < 0:
                return
            tid = lookup.get(vocab[ids[a]] + vocab[ids[b]], -1)
            if tid != -1:
                heapq.heappush(
                    heap, (-scores[tid], a, b, stamp[a], stamp[b], tid))

        for i in range(n - 1):
            push(i)
        while heap:
            _, a, b, sa, sb, tid = heapq.heappop(heap)
            if stamp[a] != sa or stamp[b] != sb or nxt[a] != b:
                continue  # stale candidate
            ids[a] = tid
            stamp[a] += 1
            stamp[b] += 1  # right node dies
            after = nxt[b]
            nxt[a] = after
            if after >= 0:
                prv[after] = a
            if prv[a] >= 0:
                push(prv[a])
            push(a)
        out = []
        i = 0
        while i >= 0:
            out.append(ids[i])
            i = nxt[i]
        return out

    def decode(self, prev_token: int, token: int) -> bytes:
        """Token id -> piece bytes (reference: tokenizer.h:68-79)."""
        piece = self.vocab[token]
        if prev_token == BOS_TOKEN and piece.startswith(b" "):
            piece = piece[1:]
        if len(piece) == 6 and piece.startswith(b"<0x") and piece.endswith(b">"):
            try:
                return bytes([int(piece[3:5], 16)])
            except ValueError:
                pass
        return piece

    @staticmethod
    def safe_piece(piece: bytes) -> str:
        """Printable-filtered piece (reference: tokenizer.h:81-93)."""
        if not piece:
            return ""
        if len(piece) == 1:
            b = piece[0]
            # isprint || isspace
            if not (32 <= b < 127 or b in (9, 10, 11, 12, 13, 32)):
                return ""
        return piece.decode("utf-8", errors="replace")


class _NativeMerger:
    """ctypes wrapper over the optional C++ merge loop."""

    def __init__(self, lib, tok: "Tokenizer"):
        import ctypes

        self._ctypes = ctypes
        self._lib = lib
        n = tok.vocab_size
        flat = b"\0".join(tok.vocab) + b"\0"
        self._flat = ctypes.create_string_buffer(flat, len(flat))
        lens = (ctypes.c_int * n)(*[len(v) for v in tok.vocab])
        scores = (ctypes.c_float * n)(*tok.scores)
        # duplicate-piece resolution (see _resolve_lookup): the id a
        # lookup of vocab[i]'s string must return
        resolved = (ctypes.c_int * n)(
            *[tok.str_lookup(v) for v in tok.vocab])
        lib.bpe_create.restype = ctypes.c_void_p
        lib.bpe_create.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                                   ctypes.POINTER(ctypes.c_float),
                                   ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        lib.bpe_destroy.argtypes = [ctypes.c_void_p]
        lib.bpe_merge.restype = ctypes.c_int
        lib.bpe_merge.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                                  ctypes.c_int]
        self._handle = lib.bpe_create(self._flat, lens, scores, resolved, n)

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.bpe_destroy(self._handle)
            self._handle = None

    def merge(self, tokens: list[int]) -> list[int]:
        ct = self._ctypes
        buf = (ct.c_int * len(tokens))(*tokens)
        out_n = self._lib.bpe_merge(self._handle, buf, len(tokens))
        return list(buf[:out_n])


def _load_native():
    """Locate (or g++-compile on demand, mirroring engine/scheduler.py)
    the shared library built from native/bpe_tokenizer.cpp."""
    native_dir = os.path.abspath(os.path.join(os.path.dirname(__file__),
                                              "..", "native"))
    src = os.path.join(native_dir, "bpe_tokenizer.cpp")
    prebuilt = os.path.join(native_dir, "build", "libbpe_tokenizer.so")
    lib_path = None
    if os.path.exists(prebuilt) and (
            not os.path.exists(src)
            or os.path.getmtime(prebuilt) >= os.path.getmtime(src)):
        lib_path = prebuilt
    elif os.path.exists(src):
        import shutil
        import subprocess
        import tempfile

        gxx = shutil.which("g++")
        if gxx is None:
            return None
        cache = os.path.join(tempfile.gettempdir(),
                             f"llama_torch_native_{os.getuid()}")
        os.makedirs(cache, exist_ok=True)
        lib_path = os.path.join(cache, "libbpe_tokenizer.so")
        if (not os.path.exists(lib_path)
                or os.path.getmtime(lib_path) < os.path.getmtime(src)):
            tmp = lib_path + ".tmp"
            try:
                subprocess.run([gxx, "-O2", "-std=c++17", "-shared",
                                "-fPIC", "-o", tmp, src], check=True)
            except subprocess.CalledProcessError:
                return None
            os.replace(tmp, lib_path)
    if lib_path is None:
        return None
    try:
        import ctypes

        return ctypes.CDLL(lib_path)
    except OSError:
        return None


def _load_native_for(tok: Tokenizer):
    if os.environ.get("LLAMA_TPU_NO_NATIVE_TOKENIZER"):
        return None
    lib = _load_native()
    if lib is None:
        return None
    try:
        return _NativeMerger(lib, tok)
    except Exception:
        return None
