"""Model configuration (a copy of llama_cu_awq_tpu/config.py).

Mirrors the 8-field `Config` struct of the reference engine, which doubles
as the 32-byte binary header of the packed checkpoint format
(reference: common.h:9-18, weight_packer.cpp:9-18,256).
"""

from __future__ import annotations

import dataclasses
import json
import struct

# struct Config { int dim, hidden_dim, n_layers, n_heads, n_kv_heads,
#                 vocab_size, seq_len; float rope_theta; }  -- 32 bytes LE
_HEADER_FMT = "<7if"
HEADER_BYTES = struct.calcsize(_HEADER_FMT)
assert HEADER_BYTES == 32

GROUP_SIZE = 128  # AWQ quantization group size, hardcoded like the reference
                  # (reference: llama2_q4.cu:31, weight_packer.cpp:7)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Llama-2 architecture hyperparameters (reference: common.h:9-18)."""

    dim: int            # transformer (model) dimension
    hidden_dim: int     # FFN intermediate dimension
    n_layers: int       # number of decoder layers
    n_heads: int        # number of query heads
    n_kv_heads: int     # number of key/value heads (GQA when < n_heads)
    vocab_size: int     # vocabulary size (32000 for llama2)
    seq_len: int        # maximum sequence length
    rope_theta: float = 10000.0  # RoPE base frequency

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def kv_dim(self) -> int:
        # (reference: llama2_q4.cu:39)
        return (self.dim * self.n_kv_heads) // self.n_heads

    @property
    def kv_mul(self) -> int:
        """GQA query-head to kv-head multiplicity (reference: llama2_q4.cu:292)."""
        return self.n_heads // self.n_kv_heads

    def __post_init__(self):
        if min(self.dim, self.hidden_dim, self.n_layers, self.n_heads,
               self.n_kv_heads, self.vocab_size, self.seq_len) <= 0:
            raise ValueError(
                f"invalid model config (corrupt checkpoint header?): {self}")
        if self.dim % self.n_heads:
            raise ValueError(f"dim {self.dim} not divisible by n_heads {self.n_heads}")
        if self.n_heads % self.n_kv_heads:
            raise ValueError(
                f"n_heads {self.n_heads} not divisible by n_kv_heads {self.n_kv_heads}"
            )

    # ---- binary header (checkpoint .bin) ----

    def to_header(self) -> bytes:
        return struct.pack(
            _HEADER_FMT,
            self.dim, self.hidden_dim, self.n_layers, self.n_heads,
            self.n_kv_heads, self.vocab_size, self.seq_len, self.rope_theta,
        )

    @classmethod
    def from_header(cls, raw: bytes) -> "ModelConfig":
        if len(raw) < HEADER_BYTES:
            raise ValueError("Invalid header size")
        vals = struct.unpack(_HEADER_FMT, raw[:HEADER_BYTES])
        return cls(*vals)

    # ---- HuggingFace config.json (offline pipeline) ----

    @classmethod
    def from_hf_json(cls, path_or_str) -> "ModelConfig":
        """Parse a HuggingFace config.json.

        Field mapping and defaults follow the reference weight packer
        (reference: weight_packer.cpp:22-68): missing num_key_value_heads
        defaults to num_attention_heads; missing rope_theta defaults to 1e4.
        """
        if isinstance(path_or_str, (str, bytes)) and "{" not in str(path_or_str):
            with open(path_or_str) as f:
                d = json.load(f)
        else:
            d = json.loads(path_or_str)
        n_heads = d["num_attention_heads"]
        return cls(
            dim=d["hidden_size"],
            hidden_dim=d["intermediate_size"],
            n_layers=d["num_hidden_layers"],
            n_heads=n_heads,
            n_kv_heads=d.get("num_key_value_heads", n_heads),
            vocab_size=d["vocab_size"],
            seq_len=d["max_position_embeddings"],
            rope_theta=float(d.get("rope_theta", 10000.0)),
        )


# Well-known configurations, for tests and synthetic benchmarks.
LLAMA2_7B = ModelConfig(dim=4096, hidden_dim=11008, n_layers=32, n_heads=32,
                        n_kv_heads=32, vocab_size=32000, seq_len=4096)
LLAMA2_13B = ModelConfig(dim=5120, hidden_dim=13824, n_layers=40, n_heads=40,
                         n_kv_heads=40, vocab_size=32000, seq_len=4096)
