"""Operations and bytes: what a launch or a forward pass needs.

Counted from the configuration's widths and a launch's variant key,
never read from the program. A byte is counted once per launch however
often a kernel reads it again (an m=16 GEMV runs as two passes of 8 rows
and reads its weights twice: they count once), and an operation is a
multiply or an add of the arithmetic the model asks for (2 per
multiply-add).

The peaks are the published ones of one NVIDIA H100 SXM (dense bf16
tensor-core rate and HBM3 bandwidth, at its 700 W power limit); the run
prints the card's own power limit beside them.
"""

from __future__ import annotations

import dataclasses
import json
import os

PEAK_FLOPS = 989e12   # bf16 dense, tensor cores
PEAK_BYTES = 3.35e12  # HBM3
GROUP = 128

_BYTES = {"bf16": 2, "f16": 2, "f32": 4}
HERE = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass(frozen=True)
class Launch:
    """A parsed variant key of the w4 matmul wrappers:
    int4_matmul_fused/<gemv|gemm>/<flags>/m<m>/<n_in>x<n_out>[/out_..]
    [/res_..] or int4_matmul/<gemv|gemm>/m<m>/<n_in>x<n_out> (f32
    out)."""

    wrapper: str
    kernel: str
    flags: tuple
    m: int
    n_in: int
    n_out: int
    out: str
    res: str

    @classmethod
    def parse(cls, key: str) -> "Launch | None":
        parts = key.split("/")
        if parts[0] == "int4_matmul_fused" and len(parts) >= 5:
            flags = () if parts[2] == "plain" else tuple(parts[2].split("+"))
            m, shape, tail = parts[3], parts[4], parts[5:]
            out = "bf16"
        elif parts[0] == "int4_matmul" and len(parts) == 4:
            flags, m, shape, tail, out = (), parts[2], parts[3], [], "f32"
        else:
            return None
        n_in, n_out = (int(v) for v in shape.split("x"))
        res = "bf16"
        for t in tail:
            if t.startswith("out_"):
                out = t[4:]
            elif t.startswith("res_"):
                res = t[4:]
        return cls(parts[0], parts[1], flags, int(m[1:]), n_in, n_out, out,
                   res)


def w4_weight_bytes(n_in: int, n_out: int) -> int:
    """Packed codes, fp16 scales and uint8 zeros of one projection."""
    groups = -(-n_in // GROUP)
    return n_in * n_out // 2 + n_out * groups * 3


def w4_bytes(l: Launch, m: int | None = None) -> int:
    """The bytes one launch needs with m rows (default the key's): the
    weights, x, the SwiGLU up values, the rmsnorm scale and weight, the
    residual, the output and the emitted rms scale, each once."""
    m = l.m if m is None else m
    b = w4_weight_bytes(l.n_in, l.n_out) + m * l.n_in * 2
    if "silu" in l.flags:
        b += m * l.n_in * 2
    if "prescale" in l.flags:
        b += m * 4 + l.n_in * 4
    if "residual" in l.flags:
        b += m * l.n_out * _BYTES[l.res]
    b += m * l.n_out * _BYTES[l.out]
    if "ss" in l.flags:
        b += m * 4
    return b


def w4_ops(l: Launch, m: int | None = None) -> int:
    m = l.m if m is None else m
    return 2 * m * l.n_in * l.n_out


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of its compute and
    its memory bound."""
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES)


# ---------------------------------------------------------------------------
# forward passes

def layer_params(shape) -> int:
    return sum(i * o for i, o in shape.projections().values())


def layer_weight_bytes(shape) -> int:
    """Every decoder layer's w4 weights and its two f32 norm weights."""
    return shape.layers * (sum(w4_weight_bytes(i, o) for i, o in
                               shape.projections().values())
                           + 2 * shape.dim * 4)


def head_bytes(shape) -> int:
    return shape.vocab * shape.dim * 2 + shape.dim * 4


def kv_row_bytes(shape) -> int:
    """A position's keys and values in every layer (bf16)."""
    return shape.layers * 2 * shape.kv_dim * 2


def row_ops(shape, position: int, head: bool, attend: bool = True) -> int:
    """A token row's operations at position p: every projection, its
    attention over the p + 1 positions it sees (with attend), and the
    lm_head where it runs."""
    ops = 2 * shape.layers * layer_params(shape)
    if attend:
        ops += 4 * shape.layers * shape.heads * shape.head_dim * (position + 1)
    if head:
        ops += 2 * shape.vocab * shape.dim
    return ops


def row_bytes(shape, position: int, attend: bool = True) -> int:
    """A token row's own bytes: its embedding row, the keys and values it
    reads (positions 0..p, with attend) and the row it writes."""
    b = shape.dim * 2 + kv_row_bytes(shape)
    if attend:
        b += kv_row_bytes(shape) * (position + 1)
    return b


def load_family(name: str) -> dict:
    with open(os.path.join(HERE, "families", f"{name}.json")) as f:
        return json.load(f)


def passes(launches: dict, shape) -> dict[int, float]:
    """Forward passes by rows m, from the launch counters: each pass
    launches its layers' fused qkv projection (rmsnorm prologue, n_in =
    dim, n_out = dim + 2 kv_dim) once a layer."""
    qkv = (shape.dim, shape.dim + 2 * shape.kv_dim)
    out: dict[int, float] = {}
    for key, n in launches.items():
        l = Launch.parse(key)
        if l and "prescale" in l.flags and (l.n_in, l.n_out) == qkv:
            out[l.m] = out.get(l.m, 0) + n / shape.layers
    return out


def head_launches(launches: dict, shape) -> int:
    """lm_head launches (dense_gemv over vocab x dim), any rows."""
    tail = f"/{shape.vocab}x{shape.dim}"
    return sum(n for key, n in launches.items()
               if key.startswith("dense_gemv/") and key.endswith(tail))
