"""The weights of a run, made on the device from the seed.

One torch.Generator on the run's device, a few large calls: the packed
codes of each projection kind for all layers at once, then their scales,
then the embedding and the head. The layout is the w4-g128 one both
sides read: for a projection of n_in inputs and n_out outputs, `qw`
(layers, n_out, n_in / 8) int32 words whose nibble i of word y holds
input row 8y + i, `scales` (layers, n_out, groups) fp16 and `zeros`
(layers, n_out, groups) uint8 with groups = ceil(n_in / 128). A weight
is (code - zero) * scale. The program gets these tensors as they are;
the reference dequantizes them with its own code.
"""

from __future__ import annotations

import dataclasses

import torch

GROUP = 128


@dataclasses.dataclass(frozen=True)
class Shape:
    """The widths of a configuration file (Hugging Face keys)."""

    dim: int
    hidden: int
    layers: int
    heads: int
    kv_heads: int
    vocab: int
    rope_theta: float
    eps: float
    max_positions: int

    @classmethod
    def from_config(cls, c: dict) -> "Shape":
        return cls(c["hidden_size"], c["intermediate_size"],
                   c["num_hidden_layers"], c["num_attention_heads"],
                   c.get("num_key_value_heads", c["num_attention_heads"]),
                   c["vocab_size"], float(c.get("rope_theta", 10000.0)),
                   float(c["rms_norm_eps"]), c["max_position_embeddings"])

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads

    @property
    def kv_dim(self) -> int:
        return self.kv_heads * self.head_dim

    def projections(self) -> dict[str, tuple[int, int]]:
        """(n_in, n_out) of each decoder projection: q|k|v fused, o,
        gate|up fused, down."""
        return {"wqkv": (self.dim, self.dim + 2 * self.kv_dim),
                "wo": (self.dim, self.dim),
                "w_gate_up": (self.dim, 2 * self.hidden),
                "w_down": (self.hidden, self.dim)}


@dataclasses.dataclass
class Packed:
    qw: torch.Tensor      # (layers, n_out, n_in / 8) int32
    scales: torch.Tensor  # (layers, n_out, groups) fp16
    zeros: torch.Tensor   # (layers, n_out, groups) uint8
    n_in: int
    n_out: int


@dataclasses.dataclass
class Weights:
    shape: Shape
    proj: dict            # name -> Packed
    embed: torch.Tensor   # (vocab, dim) bf16
    head: torch.Tensor    # (vocab, dim) bf16
    norms: torch.Tensor   # (layers, 2, dim) f32: attention, ffn
    final_norm: torch.Tensor  # (dim,) f32


# a uniform 4-bit code less a zero point of 7 or 8 (drawn per group, so
# that no output shares a common offset with every other) has mean 0 and
# mean square 21.5
CODE_RMS = 21.5 ** 0.5


def unit_scale(n_in: int) -> float:
    """The scale at which a projection of n_in inputs keeps the rms of
    its input: every layer then adds to the residual about what it holds,
    as in a trained model, and rounding is not blown up layer by layer."""
    return 1.0 / (CODE_RMS * n_in ** 0.5)


def make(shape: Shape, seed: int, device) -> Weights:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    L = shape.layers
    proj = {}
    for name, (n_in, n_out) in shape.projections().items():
        groups = -(-n_in // GROUP)
        qw = torch.randint(0, 256, (L, n_out, -(-n_in // 8) * 4),
                           dtype=torch.uint8, device=device,
                           generator=g).view(torch.int32)
        proj[name] = Packed(qw, None, None, n_in, n_out)
    for name, p in proj.items():
        groups = -(-p.n_in // GROUP)
        p.scales = (unit_scale(p.n_in) * (1.0 + 0.1 * torch.randn(
            L, p.n_out, groups, device=device, generator=g))).to(
                torch.float16)
        p.zeros = torch.randint(7, 9, (L, p.n_out, groups),
                                dtype=torch.uint8, device=device,
                                generator=g)
    embed = (torch.randn(shape.vocab, shape.dim, device=device, generator=g)
             * 0.02).to(torch.bfloat16)
    head = (torch.randn(shape.vocab, shape.dim, device=device, generator=g)
            * 0.02).to(torch.bfloat16)
    norms = torch.ones(L, 2, shape.dim, device=device)
    return Weights(shape, proj, embed, head, norms,
                   torch.ones(shape.dim, device=device))

