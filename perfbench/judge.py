"""Whether the served tokens are right: the comparison that decides
`correct`.

After the window closes and the program's state is freed, a sample drawn
from the seed of the greedy requests the program finished (the one with
the most tokens, prompt and served, always in it) is run through the
plain reference (reference/llama.py) over its prompt and its served
tokens. At each served position the reference's logits give the gap by
which the served token's logit lies below the best one. A greedy server
that computes what the model says serves the best token up to rounding,
so the widest gap over the sample is the number compared; its limit is
in limits/<cell>.json, with the readings it was set from in PERF.md.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from perfbench.reference.llama import Reference


@dataclasses.dataclass
class Served:
    prompt: list[int]
    tokens: list[int]


def pick(served: list[Served], seed: int, tokens: int,
         max_requests: int) -> list[Served]:
    """The sample: the longest, then others in an order drawn from the
    seed, until `tokens` served tokens or `max_requests` requests."""
    done = [s for s in served if s.tokens]
    if not done:
        return []
    longest = max(range(len(done)),
                  key=lambda i: len(done[i].prompt) + len(done[i].tokens))
    order = [longest] + [int(i) for i in np.random.default_rng(
        seed ^ 0x5EED).permutation(len(done)) if i != longest]
    out, n = [], 0
    for i in order:
        if n >= tokens or len(out) >= max_requests:
            break
        out.append(done[i])
        n += len(done[i].tokens)
    return out


def inputs(sample: list[Served]):
    """Each request's sequence (prompt and served tokens but the last)
    and the positions whose logits chose the served tokens."""
    seqs = [s.prompt + s.tokens[:-1] for s in sample]
    pos = [list(range(len(s.prompt) - 1, len(s.prompt) - 1 + len(s.tokens)))
           for s in sample]
    return seqs, pos


def gaps(weights, sample: list[Served], control: bool = False) -> dict:
    """widest_gap of the served tokens; with control, also the widest gap
    of the tokens the fp8 control puts first at the same positions."""
    seqs, pos = inputs(sample)
    with torch.no_grad():
        ref = Reference(weights).logits(seqs, pos)
        ctl = (Reference(weights, "fp8").logits(seqs, pos)
               if control else None)
    widest, widest_ctl, n = 0.0, 0.0, 0
    for i, s in enumerate(sample):
        z = ref[i]
        best = z.max(dim=-1).values
        tok = torch.tensor(s.tokens, device=z.device)
        if int(tok.min()) < 0 or int(tok.max()) >= z.shape[1]:
            widest = float("inf")  # a token the vocabulary does not hold
            n += len(s.tokens)
            continue
        g = best - z.gather(1, tok[:, None])[:, 0]
        if not torch.isfinite(g).all():
            widest = float("inf")
        else:
            widest = max(widest, float(g.max()))
        n += len(s.tokens)
        if ctl is not None:
            c = ctl[i].argmax(dim=-1)
            gc = best - z.gather(1, c[:, None])[:, 0]
            widest_ctl = max(widest_ctl, float(gc.max()))
    out = {"widest_gap": widest, "compared_tokens": n,
           "compared_requests": len(sample)}
    if control:
        out["control_gap"] = widest_ctl
    return out
