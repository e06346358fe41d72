"""Train a small float Llama on real text, then export it as an
original-format AWQ dump for the offline pipeline (pack_weights, then the
engine).

The port's copy of tools/train_tiny.py, with its command line (--device
cuda|cpu in place of --platform) and its output files. The architecture is
the engine's (it imports the port's rmsnorm and apply_rope: eps 1e-5, GQA,
SwiGLU, a separate lm_head), trained in plain f32 (no TF32) with autograd.
The optimizer is the JAX tool's optax chain, rebuilt: clip by global norm
1.0 as optax clips (scale only when the norm reaches the bound), then AdamW
(b1 0.9, b2 0.95, eps 1e-8, weight decay 0.01 on every leaf) at a linear
warmup of min(200, steps // 10) updates from 0 to --lr and a cosine decay
to 0.1 * --lr at --steps, the rate of each update read at the count before
it. Batches come from numpy's default_rng(--seed) in the JAX loop's
order, so both tools see the same batches from the same corpus. The
quantizer is quant/packing.py's w4-g128 quantize_np, so the same float
parameters give byte-equal dumps.

Example (a real corpus, then the engine on the packed model):
    python -m llama_cu_awq_torch.tools.build_corpus --out /tmp/corpus
    python -m llama_cu_awq_torch.tools.train_tiny --corpus /tmp/corpus \\
        --out /tmp/tinyllama --heads 4 --kv-heads 4 --steps 3000
    python -m llama_cu_awq_torch.tools.pack_weights \\
        /tmp/tinyllama/awq/config.json /tmp/tinyllama/awq \\
        /tmp/tinyllama/model.bin 1
    python -m llama_cu_awq_torch /tmp/tinyllama/model.bin \\
        -z tokenizer.bin -i "The gradient of" -t 0.0
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

# a layer's leaves, in the order of the JAX tool's params after a tree map
LAYER_KEYS = ("attn_norm", "ffn_norm", "w_down", "w_gate", "w_up", "wk",
              "wo", "wq", "wv")
# the dump's name of each quantized leaf (HF Llama's), in the JAX tool's
# order
PROJECTIONS = (("self_attn.q_proj", "wq"), ("self_attn.k_proj", "wk"),
               ("self_attn.v_proj", "wv"), ("self_attn.o_proj", "wo"),
               ("mlp.gate_proj", "w_gate"), ("mlp.up_proj", "w_up"),
               ("mlp.down_proj", "w_down"))
MAX_NORM = 1.0
BETAS = (0.9, 0.95)
EPS = 1e-8
WEIGHT_DECAY = 0.01
LOG_EVERY = 200
VALID_BATCHES = 4


def log(msg):
    print(msg, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# data

def load_tokens(corpus_dir: str, split: str, tokenizer) -> np.ndarray:
    """Tokenize a split (cached next to the corpus, keyed by mtime)."""
    path = os.path.join(corpus_dir, f"{split}.txt")
    cache = os.path.join(corpus_dir, f"{split}.tokens.npy")
    if (os.path.exists(cache)
            and os.path.getmtime(cache) >= os.path.getmtime(path)):
        return np.load(cache)
    with open(path, encoding="utf-8") as f:
        docs = f.read().split("<|endoftext|>")
    ids: list[int] = []
    t0 = time.time()
    for d in docs:
        ids.extend(tokenizer.encode(d, bos=True, eos=True))
    arr = np.asarray(ids, np.int32)
    np.save(cache, arr)
    log(f"tokenized {split}: {len(docs)} docs -> {len(arr)} tokens "
        f"({time.time()-t0:.1f}s)")
    return arr


# ---------------------------------------------------------------------------
# model (float training twin of models/llama.py's forward)

def init_params(cfg, generator: torch.Generator, device="cpu") -> dict:
    """Normal(0, 0.02) matrices as (n_in, n_out), 0.02 / sqrt(2L) where
    n_in is not dim, wo and w_down further divided by sqrt(2L); embed and
    lm_head (vocab, dim); norms 1. Drawn on the generator's device, then
    moved to `device`, so one seed gives one model on every device."""
    dim, hid, kv_dim = cfg.dim, cfg.hidden_dim, cfg.kv_dim
    depth = math.sqrt(2 * cfg.n_layers)

    def normal(*shape):
        return torch.randn(*shape, generator=generator,
                           device=generator.device).to(device)

    def mat(n_in, n_out):
        return normal(n_in, n_out) * (0.02 if n_in == dim else 0.02 / depth)

    def ones():
        return torch.ones(dim, device=device)

    layers = []
    for _ in range(cfg.n_layers):
        wq, wk, wv = mat(dim, dim), mat(dim, kv_dim), mat(dim, kv_dim)
        wo = mat(dim, dim) / depth
        w_gate, w_up = mat(dim, hid), mat(dim, hid)
        w_down = mat(hid, dim) / depth
        layers.append(dict(attn_norm=ones(), ffn_norm=ones(), wq=wq, wk=wk,
                           wv=wv, wo=wo, w_gate=w_gate, w_up=w_up,
                           w_down=w_down))
    params = dict(embed=normal(cfg.vocab_size, dim) * 0.02,
                  lm_head=normal(cfg.vocab_size, dim) * 0.02,
                  final_norm=ones(), layers=layers)
    for p in leaves(params):
        p.requires_grad_(True)
    return params


def leaf_names(n_layers: int) -> list[str]:
    """The leaves' names in float_params.npz's order."""
    return ["embed", "lm_head", "final_norm"] + [
        f"l{i}_{k}" for i in range(n_layers) for k in LAYER_KEYS]


def leaves(params: dict) -> list[torch.Tensor]:
    """The leaves in leaf_names' order."""
    return [params["embed"], params["lm_head"], params["final_norm"]] + [
        l[k] for l in params["layers"] for k in LAYER_KEYS]


def params_to_numpy(params: dict) -> dict[str, np.ndarray]:
    """The float_params.npz layout: {name: f32 array} in leaf_names'
    order."""
    return {n: p.detach().cpu().numpy() for n, p in
            zip(leaf_names(len(params["layers"])), leaves(params))}


def params_from_numpy(d, device="cpu") -> dict:
    """Trainable params on `device` from the float_params.npz layout (a
    dict or an np.load of the file): the JAX tool's saved params, or
    params_to_numpy's."""
    n_layers = sum(1 for k in d.keys() if k.endswith("_attn_norm"))

    def t(name):
        return torch.tensor(np.asarray(d[name], np.float32), device=device,
                            requires_grad=True)

    return dict(embed=t("embed"), lm_head=t("lm_head"),
                final_norm=t("final_norm"),
                layers=[{k: t(f"l{i}_{k}") for k in LAYER_KEYS}
                        for i in range(n_layers)])


def forward_loss(params: dict, tokens: torch.Tensor, cfg) -> torch.Tensor:
    """tokens (B, T+1) -> mean next-token cross-entropy. The JAX tool's
    forward_loss (the inference forward's math in plain f32)."""
    from llama_cu_awq_torch.ops.norms import rmsnorm
    from llama_cu_awq_torch.ops.rope import apply_rope, rope_angles

    tokens = tokens.long()
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    B, T = inp.shape
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    x = F.embedding(inp, params["embed"])
    positions = torch.arange(T, device=tokens.device)[None, :]
    angles = rope_angles(positions, D, cfg.rope_theta)
    mask = torch.ones(T, T, dtype=torch.bool, device=tokens.device).tril()
    for l in params["layers"]:
        h = rmsnorm(x, l["attn_norm"])
        q = (h @ l["wq"]).reshape(B, T, H, D)
        k = (h @ l["wk"]).reshape(B, T, KV, D)
        v = (h @ l["wv"]).reshape(B, T, KV, D)
        q = apply_rope(q, positions, cfg.rope_theta, angles)
        k = apply_rope(k, positions, cfg.rope_theta, angles)
        qg = q.reshape(B, T, KV, H // KV, D)
        s = torch.einsum("bthgd,bshd->bhgts", qg, k) / math.sqrt(D)
        s = s.masked_fill(~mask, -math.inf)
        a = torch.softmax(s, dim=-1)
        o = torch.einsum("bhgts,bshd->bthgd", a, v).reshape(B, T, H * D)
        x = x + o @ l["wo"]
        h = rmsnorm(x, l["ffn_norm"])
        g = h @ l["w_gate"]
        x = x + (g * torch.sigmoid(g) * (h @ l["w_up"])) @ l["w_down"]
    x = rmsnorm(x, params["final_norm"])
    logits = x @ params["lm_head"].T
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, tgt[..., None])[..., 0]
    return nll.mean()


def loss_and_grads(params: dict, tokens: torch.Tensor, cfg):
    """(loss, the gradient of each leaf in leaves' order): the JAX tool's
    jax.value_and_grad(forward_loss)."""
    loss = forward_loss(params, tokens, cfg)
    return loss.detach(), list(torch.autograd.grad(loss, leaves(params)))


# ---------------------------------------------------------------------------
# optimizer: the JAX tool's optax chain

def lr_at(count: int, lr: float, steps: int) -> float:
    """optax.warmup_cosine_decay_schedule(0, lr, min(200, steps // 10),
    steps, 0.1 * lr) at update count `count`: a linear warmup from 0, then
    a cosine from lr down to 0.1 * lr at `steps`, held there after. A
    warmup of 0 (steps < 10) starts on the cosine at lr."""
    warmup = min(200, steps // 10)
    if count < warmup:
        return (0.0 - lr) * (1 - count / warmup) + lr
    decay = steps - warmup
    alpha = 0.0 if lr == 0.0 else 0.1 * lr / lr
    t = min(count - warmup, decay)
    cosine = 0.5 * (1 + math.cos(math.pi * t / decay))
    return lr * ((1 - alpha) * cosine + alpha)


def clip_by_global_norm(grads: list[torch.Tensor],
                        max_norm: float = MAX_NORM) -> list[torch.Tensor]:
    """optax.clip_by_global_norm: each gradient divided by the global norm
    and multiplied by max_norm where that norm is max_norm or more, else
    as it is (no epsilon; on the device, without a host sync)."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    return [torch.where(keep, g, g / norm * max_norm) for g in grads]


def make_optimizer(params: dict) -> torch.optim.AdamW:
    """optax.adamw(b2=0.95, weight_decay=0.01) over every leaf; train_step
    sets the rate of each update."""
    return torch.optim.AdamW(leaves(params), lr=0.0, betas=BETAS, eps=EPS,
                             weight_decay=WEIGHT_DECAY)


def train_step(params: dict, opt: torch.optim.Optimizer,
               tokens: torch.Tensor, cfg, lr: float) -> torch.Tensor:
    """One update at rate lr: loss and gradients, the clip, AdamW. Returns
    the loss before the update (a device scalar)."""
    loss, grads = loss_and_grads(params, tokens, cfg)
    for p, g in zip(leaves(params), clip_by_global_norm(grads)):
        p.grad = g
    for group in opt.param_groups:
        group["lr"] = lr
    opt.step()
    return loss


# ---------------------------------------------------------------------------
# AWQ export (original interleaved format, the input of pack_weights ... 1)

def export_awq(host, cfg, outdir: str) -> None:
    """Write the dump from params in the float_params.npz layout
    (params_to_numpy's, or the JAX tool's)."""
    from llama_cu_awq_torch.quant.packing import (awq_pack_interleaved,
                                                  quantize_np,
                                                  unpack_nibbles)

    os.makedirs(outdir, exist_ok=True)

    def dump(name, arr):
        with open(os.path.join(outdir, name + ".bin"), "wb") as f:
            f.write(np.ascontiguousarray(arr).tobytes())

    def dump_q(name, w):
        """w (n_in, n_out) float -> old-format qweight/qzeros/scales."""
        n_in, _ = w.shape
        qw_mem, zeros, scales = quantize_np(np.asarray(w, np.float32))
        q = unpack_nibbles(qw_mem, n_in)
        dump(name + ".qweight", awq_pack_interleaved(q).view(np.int32))
        dump(name + ".qzeros",
             awq_pack_interleaved(zeros.astype(np.int32)).view(np.int32))
        dump(name + ".scales", scales.astype(np.float16))

    def f16(name):
        return np.asarray(host[name], np.float16)

    dump("model.embed_tokens.weight", f16("embed"))
    dump("lm_head.weight", f16("lm_head"))
    dump("model.norm.weight", f16("final_norm"))
    for i in range(cfg.n_layers):
        base, l = f"model.layers.{i}.", f"l{i}_"
        for name, key in PROJECTIONS:
            dump_q(base + name, host[l + key])
        dump(base + "input_layernorm.weight", f16(l + "attn_norm"))
        dump(base + "post_attention_layernorm.weight", f16(l + "ffn_norm"))
    with open(os.path.join(outdir, "config.json"), "w") as f:
        json.dump({
            "hidden_size": cfg.dim, "intermediate_size": cfg.hidden_dim,
            "num_hidden_layers": cfg.n_layers,
            "num_attention_heads": cfg.n_heads,
            "num_key_value_heads": cfg.n_kv_heads,
            "vocab_size": cfg.vocab_size,
            "max_position_embeddings": cfg.seq_len,
            "rope_theta": cfg.rope_theta,
        }, f)


# ---------------------------------------------------------------------------

def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m llama_cu_awq_torch.tools.train_tiny",
        description=__doc__.splitlines()[0])
    ap.add_argument("--corpus", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--tokenizer", default="tokenizer.bin",
                    help="llama2.c tokenizer.bin (the Llama-2 vocab)")
    ap.add_argument("--dim", type=int, default=512)
    ap.add_argument("--hidden", type=int, default=1536)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--kv-heads", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--lr", type=float, default=6e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="train on the card (default) or the CPU")
    return ap


def run(argv=None) -> dict:
    """main()'s work. Returns the run's record: cfg, the trained params,
    each logged step's losses (`log`), each train step's milliseconds
    (`step_ms`: CUDA events around the step on the card, the host clock on
    the CPU), the parameter and token counts and the device."""
    from llama_cu_awq_torch.config import ModelConfig
    from llama_cu_awq_torch.device import resolve_device
    from llama_cu_awq_torch.tokenizer import Tokenizer

    args = build_argparser().parse_args(argv)
    if args.steps <= 0:
        raise SystemExit("--steps must be positive")
    dev = resolve_device(args.device)
    # plain f32 products, as the JAX tool trains
    torch.set_float32_matmul_precision("highest")
    cfg = ModelConfig(dim=args.dim, hidden_dim=args.hidden,
                      n_layers=args.layers, n_heads=args.heads,
                      n_kv_heads=args.kv_heads, vocab_size=32000,
                      seq_len=2048)
    tok = Tokenizer(args.tokenizer, cfg.vocab_size)
    train = load_tokens(args.corpus, "train", tok)
    valid = load_tokens(args.corpus, "valid", tok)

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    params = init_params(cfg, gen, dev)
    n_params = sum(p.numel() for p in leaves(params))
    log(f"model: {n_params/1e6:.1f}M params, "
        f"{len(train)/1e6:.1f}M train tokens on {dev.type}")
    opt = make_optimizer(params)

    rng = np.random.default_rng(args.seed)
    span = args.seq + 1

    def sample_batch(data):
        starts = rng.integers(0, len(data) - span, size=args.batch)
        return torch.from_numpy(
            np.stack([data[s:s + span] for s in starts])).to(dev)

    cuda = dev.type == "cuda"

    def stamp():
        """A point on the card's stream (no host sync), or the host clock
        on the CPU."""
        if not cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    marks = []  # (start, end) of each train step
    record = []
    t0 = time.time()
    for step in range(args.steps):
        batch = sample_batch(train)
        start = stamp()
        loss = train_step(params, opt, batch, cfg,
                          lr_at(step, args.lr, args.steps))
        marks.append((start, stamp()))
        if step % LOG_EVERY == 0 or step == args.steps - 1:
            with torch.no_grad():
                vl = np.mean([float(forward_loss(params, sample_batch(valid),
                                                 cfg))
                              for _ in range(VALID_BATCHES)])
            record.append(dict(step=step, train_loss=float(loss),
                               valid_loss=float(vl),
                               seconds=time.time() - t0))
            log(f"step {step}: train loss {float(loss):.3f}, valid loss "
                f"{vl:.3f} (ppl {np.exp(vl):.1f}), "
                f"{time.time()-t0:.0f}s")
    if cuda:
        torch.cuda.synchronize(dev)
        step_ms = [s.elapsed_time(e) for s, e in marks]
    else:
        step_ms = [(e - s) * 1e3 for s, e in marks]

    os.makedirs(args.out, exist_ok=True)
    host = params_to_numpy(params)
    np.savez(os.path.join(args.out, "float_params.npz"), **host)
    export_awq(host, cfg, os.path.join(args.out, "awq"))
    log(f"exported AWQ dump to {args.out}/awq (pack with "
        f"python -m llama_cu_awq_torch.tools.pack_weights)")
    return dict(cfg=cfg, params=params, log=record, step_ms=step_ms,
                n_params=n_params, train_tokens=len(train),
                valid_tokens=len(valid), device=str(dev))


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
