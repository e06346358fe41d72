"""Perplexity matrix over the engine's quantization levers.

The port's copy of tools/ppl_matrix.py. On a real checkpoint it scores
each quantization and kernel choice the engine offers against the
BASELINE quality bar (perplexity within 0.05 of the reference's,
perplexity.h:99-139; docs/PPL_RUNBOOK.md):

    KV cache   : bf16 / int8 / int4  (each with plain attention and with
                 the fused_step attention kernel)
    lm_head    : the checkpoint's fp16 / int8 per-row / w4-g128

Scoring runs stepwise through the decode path: one T=1 step a token
(engine._prefill of one token with its logits), the steps that decoding
runs, the fused_step attention kernel included, which a teacher-forced
block would not reach. The protocol is engine/perplexity.py's: BOS
first, an f32 softmax, f64 log sums, the geometric mean over sequences.
On the card the kernels run; with --device cpu their plain versions.
The embed and head keep the checkpoint's fp16, as the JAX tool's do.

Usage:
  python -m llama_cu_awq_torch.tools.ppl_matrix <model.bin> -z <tokenizer.bin> -q <valid.txt> [--seqs 30] [--only LABELS] [--device cuda|cpu] [--json OUT]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def stepwise_dataset_ppl(engine, dataset_text: str, max_seqs: int):
    """Geomean perplexity scored one token a forward (the decode path),
    and the number of sequences it took."""
    from llama_cu_awq_torch.engine.perplexity import END_OF_TEXT, _softmax_f32
    from llama_cu_awq_torch.tokenizer import BOS_TOKEN

    values = []
    for seq in dataset_text.split(END_OF_TEXT)[:max_seqs]:
        toks = engine.tokenizer.encode(seq, bos=False, eos=False)
        n = min(len(toks), engine.cfg.seq_len - 1, engine.max_seq - 1)
        if n == 0:
            continue
        engine.reset()
        total = 0.0
        for i, t in enumerate([BOS_TOKEN] + toks[: n - 1]):
            row = engine._prefill([t], collect_logits=True)[0].numpy()
            probs = _softmax_f32(row)
            total += float(np.log(np.float64(probs[toks[i]])))
        ppl = float(np.exp(-total / n))
        if np.isfinite(ppl):  # engine/perplexity.py skips non-finite
            values.append(ppl)  # sequences (f32 underflow)
    if not values:
        return float("nan"), 0
    return float(np.exp(np.mean([np.log(v) for v in values]))), len(values)


MATRIX = [
    # (label, engine kwargs, lm_head bits)
    ("bf16 KV, einsum", {}, None),
    ("bf16 KV, fused_step", {"attn_impl": "fused_step"}, None),
    ("int8 KV, einsum", {"kv_quant": True}, None),
    ("int8 KV, fused_step", {"kv_quant": True,
                             "attn_impl": "fused_step"}, None),
    ("int4 KV, einsum", {"kv_quant": 4}, None),
    ("int4 KV, fused_step", {"kv_quant": 4,
                             "attn_impl": "fused_step"}, None),
    ("int8 lm_head", {}, 8),
    ("w4-g128 lm_head", {}, 4),
]


def fused_step_taken(cfg) -> bool:
    """Whether the attention_step kernel takes cfg's heads (its
    kernel_takes: head_dim a multiple of 32 up to 256); where it does
    not, the fused_step rows run plain attention, as the JAX tool's fall
    back to einsum."""
    from llama_cu_awq_torch.ops.cuda.attention_step import kernel_takes

    return kernel_takes(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)


def load(checkpoint: str, tokenizer: str, device: str):
    """(params with the checkpoint's fp16 embed and head, cfg, Tokenizer)."""
    from llama_cu_awq_torch.io.checkpoint import load_checkpoint
    from llama_cu_awq_torch.models import params_from_checkpoint
    from llama_cu_awq_torch.tokenizer import Tokenizer

    ckpt = load_checkpoint(checkpoint)
    cfg = ckpt.config
    params = params_from_checkpoint(ckpt, device=device, param_dtype=None)
    return params, cfg, Tokenizer(tokenizer, cfg.vocab_size)


def score_row(base_params, cfg, tok, text: str, seqs: int, label: str,
              kw: dict, head_bits, device: str) -> dict:
    """One MATRIX row: {"config", "geomean_ppl", "sequences"}."""
    import torch

    from llama_cu_awq_torch.engine import InferenceEngine
    from llama_cu_awq_torch.models import quantize_lm_head

    params = base_params
    if head_bits:
        params = quantize_lm_head(base_params, bits=head_bits)
    if kw.get("attn_impl") == "fused_step" and not fused_step_taken(cfg):
        kw = {k: v for k, v in kw.items() if k != "attn_impl"}
    eng = InferenceEngine(params, cfg, tokenizer=tok, temperature=0.0,
                          act_dtype=torch.bfloat16, device=device, **kw)
    ppl, n = stepwise_dataset_ppl(eng, text, seqs)
    return {"config": label, "geomean_ppl": round(ppl, 6), "sequences": n}


def table(rows: list[dict]) -> str:
    """The Markdown table: each row's geomean and its change against the
    bf16 einsum row where it ran (an --only run may leave it out), else
    against the first row."""
    base_row = next((r for r in rows
                     if r["config"] == "bf16 KV, einsum"), None)
    base = (base_row or rows[0])["geomean_ppl"]
    ref = "bf16" if base_row else rows[0]["config"]
    lines = [f"| Config | geomean PPL | vs {ref} |", "|---|---|---|"]
    for r in rows:
        d = r["geomean_ppl"] / base - 1.0
        lines.append(f"| {r['config']} | {r['geomean_ppl']:.6f} | {d:+.2%} |")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m llama_cu_awq_torch.tools.ppl_matrix",
        description=__doc__.splitlines()[0])
    ap.add_argument("checkpoint")
    ap.add_argument("-z", "--tokenizer", required=True)
    ap.add_argument("-q", "--dataset", required=True)
    ap.add_argument("--seqs", type=int, default=30,
                    help="sequence budget per config (138 in the full "
                         "valid split; 30 keeps the matrix to minutes)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the card's kernels (default) or their plain "
                         "versions on the CPU")
    ap.add_argument("--json", default=None, metavar="OUT")
    ap.add_argument("--only", default=None,
                    help="comma-separated substring filter over config "
                         "labels (resume a partial matrix run)")
    args = ap.parse_args(argv)

    import torch

    from llama_cu_awq_torch.device import resolve_device

    dev = resolve_device(args.device)
    base_params, cfg, tok = load(args.checkpoint, args.tokenizer,
                                 args.device)
    with open(args.dataset) as f:
        text = f.read()

    if not fused_step_taken(cfg):
        log(f"NOTE: the attention_step kernel does not take head_dim="
            f"{cfg.head_dim} — the fused_step rows will fall back to "
            "einsum (train the proxy model with head_dim 128, e.g. --dim "
            "512 --heads 4, to exercise the kernel; tools/real_model_e2e.sh "
            "does)")

    rows = []
    wanted = ([s.strip() for s in args.only.split(",")]
              if args.only else None)
    for label, kw, head_bits in MATRIX:
        if wanted and not any(w in label for w in wanted):
            continue
        row = score_row(base_params, cfg, tok, text, args.seqs, label, kw,
                        head_bits, args.device)
        rows.append(row)
        log(f"{label:24s}  {row['geomean_ppl']:.6f}  "
            f"({row['sequences']} seqs)")

    if not rows:
        raise SystemExit("--only matched no matrix configs")
    print(table(rows))
    if args.json:
        device = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                  else "cpu")
        with open(args.json, "w") as f:
            json.dump({"rows": rows, "checkpoint": args.checkpoint,
                       "seqs": args.seqs, "device": device}, f, indent=1)
        log(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
