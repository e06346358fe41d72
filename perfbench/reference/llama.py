"""A plain float32 PyTorch forward of the benchmark's models.

The decoder of Llama-architecture models (Mistral-7B-v0.1, Yi-6B and
the like), as their published description has it: token embedding, then
per layer rmsnorm, q|k|v projections, rotary embedding of q and k (the
half-rotation convention, base rope_theta), causal attention with
grouped kv heads, o projection and residual, rmsnorm, SiLU(gate) * up,
down projection and residual; the final rmsnorm and the lm_head. Every
sequence is run whole from position 0, with no cache, no batching and no
kernel: the same answer a server's prefill and decode through its cache
must give. TF32 is off, so every product is float32.

It reads the run's weight tensors (perfbench/weights.py) and dequantizes
the w4-g128 projections itself. It imports nothing of the program.

`precision="fp8"` is the control: the same forward, with every input of
a projection or of the head, and every key and value row, rounded to
float8 e4m3 with one scale a row (its absolute maximum over 448), the
step below the bfloat16 activations the configurations serve in.
"""

from __future__ import annotations

import math

import torch

GROUP = 128
E4M3_MAX = 448.0


def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def dequantize(qw, scales, zeros, n_in: int, rows: int = 8192):
    """(n_out, n_in) float32 weights of one packed projection."""
    n_out = qw.shape[0]
    out = torch.empty(n_out, n_in, dtype=torch.float32, device=qw.device)
    shifts = 4 * torch.arange(8, device=qw.device, dtype=torch.int32)
    group = torch.arange(n_in, device=qw.device) // GROUP
    for r in range(0, n_out, rows):
        w = qw[r:r + rows]
        codes = ((w[:, :, None] >> shifts) & 0xF).reshape(w.shape[0], -1)
        codes = codes[:, :n_in].float()
        z = zeros[r:r + rows].float()[:, group]
        s = scales[r:r + rows].float()[:, group]
        out[r:r + rows] = (codes - z) * s
    return out


def fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per row (last dim)."""
    s = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-30) / E4M3_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


class Reference:
    def __init__(self, weights, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.w = weights
        self.s = weights.shape
        self.round = fp8_rows if precision == "fp8" else (lambda x: x)
        if weights.embed.device.type == "cuda":
            no_tf32()

    def _rms(self, x, weight):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True)
                               + self.s.eps) * weight

    def _rope(self, x, pos):
        """x: (T, heads, D); the pair (i, i + D/2) turned by pos *
        theta^(-2i/D)."""
        D = x.shape[-1]
        i = torch.arange(D // 2, device=x.device, dtype=torch.float64)
        freq = self.s.rope_theta ** (-2.0 * i / D)
        ang = (pos.double()[:, None] * freq).float()
        cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
        a, b = x[..., :D // 2], x[..., D // 2:]
        return torch.cat([a * cos - b * sin, a * sin + b * cos], dim=-1)

    def _attention(self, q, k, v, rows: int = 256):
        """Causal attention of (T, H, D) queries over (T, KV, D) keys and
        values; (T, H * D)."""
        T, H, D = q.shape
        rep = H // k.shape[1]
        k = k.repeat_interleave(rep, dim=1).transpose(0, 1)  # (H, T, D)
        v = v.repeat_interleave(rep, dim=1).transpose(0, 1)
        out = torch.empty(T, H, D, dtype=torch.float32, device=q.device)
        scale = 1.0 / math.sqrt(D)
        for r in range(0, T, rows):
            qb = q[r:r + rows].transpose(0, 1)  # (H, n, D)
            n = qb.shape[1]
            sc = torch.matmul(qb, k[:, :r + n].transpose(1, 2)) * scale
            mask = (torch.arange(r + n, device=q.device)[None, :]
                    > torch.arange(r, r + n, device=q.device)[:, None])
            sc = sc.masked_fill(mask[None], float("-inf"))
            out[r:r + n] = torch.matmul(torch.softmax(sc, dim=-1),
                                        v[:, :r + n]).transpose(0, 1)
        return out.reshape(T, H * D)

    def logits(self, seqs: list[list[int]],
               positions: list[list[int]]) -> list[torch.Tensor]:
        """For each token sequence, the float32 logits (len(p), vocab) at
        its positions p: the next-token logits after seq[:i + 1]."""
        s, w, rnd = self.s, self.w, self.round
        dev = w.embed.device
        H, KV, D = s.heads, s.kv_heads, s.head_dim
        xs = [w.embed[torch.tensor(t, device=dev)].float() for t in seqs]
        pos = [torch.arange(len(t), device=dev) for t in seqs]
        for l in range(s.layers):
            mats = {name: dequantize(p.qw[l], p.scales[l], p.zeros[l],
                                     p.n_in)
                    for name, p in w.proj.items()}
            for i, x in enumerate(xs):
                h = rnd(self._rms(x, w.norms[l, 0]))
                qkv = h @ mats["wqkv"].T
                q = qkv[:, :H * D].reshape(-1, H, D)
                k = qkv[:, H * D:(H + KV) * D].reshape(-1, KV, D)
                v = qkv[:, (H + KV) * D:].reshape(-1, KV, D)
                q, k = self._rope(q, pos[i]), self._rope(k, pos[i])
                a = self._attention(q, rnd(k), rnd(v))
                x = x + rnd(a) @ mats["wo"].T
                h = rnd(self._rms(x, w.norms[l, 1]))
                gu = h @ mats["w_gate_up"].T
                g, u = gu[:, :s.hidden], gu[:, s.hidden:]
                xs[i] = x + rnd(torch.nn.functional.silu(g) * u) \
                    @ mats["w_down"].T
            del mats
        head = w.head.float()
        out = []
        for x, p in zip(xs, positions):
            h = rnd(self._rms(x[torch.tensor(p, device=dev)], w.final_norm))
            out.append(h @ head.T)
        return out
