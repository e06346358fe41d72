"""Command-line driver, flag-compatible with llama_cu_awq_tpu/cli.py (and
so with the reference engine, llama2_q4.cu:604-720) for what the port
supports: positional checkpoint plus

  -n <int>    max number of steps, default = max_seq_len
  -i <string> input prompt
  -f <string> path to file containing input prompt (overrides -i)
  -t <float>  temperature, default 0.5
  -p <float>  top-p, default 0.6 (out-of-range values reset to 0.9)
  -s <int>    random seed, default time(NULL)
  -z <string> path to custom tokenizer (default: tokenizer.bin)
  -m <string> mode: generate|chat (perplexity is not ported yet)
  -y <string> system prompt for chat mode
  --device {cuda,cpu}  default cuda; cpu runs the kernels' plain versions
"""

from __future__ import annotations

import argparse
import sys
import time


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="llama-torch",
        description="INT4 AWQ Llama-2 inference engine (PyTorch + CUDA)",
        usage="%(prog)s <checkpoint> [options]  "
              "(example: %(prog)s model.bin -n 256 -i \"Write a poem\")")
    ap.add_argument("checkpoint", help="packed .bin model checkpoint")
    ap.add_argument("-n", dest="steps", type=int, default=0)
    ap.add_argument("-i", dest="prompt", default=None)
    ap.add_argument("-f", dest="prompt_file", default=None)
    ap.add_argument("-t", dest="temperature", type=float, default=0.5)
    ap.add_argument("-p", dest="topp", type=float, default=0.6)
    ap.add_argument("-s", dest="seed", type=int, default=0)
    ap.add_argument("-z", dest="tokenizer", default="tokenizer.bin")
    ap.add_argument("-m", dest="mode", default="generate",
                    choices=["generate", "chat", "perplexity"])
    ap.add_argument("-y", dest="system_prompt", default=None)
    ap.add_argument("-q", dest="dataset", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="run on the card (default) or the CPU")
    ap.add_argument("--act-dtype", default="bfloat16",
                    choices=["bfloat16", "float16", "float32"])
    ap.add_argument("--max-seq", type=int, default=None,
                    help="cap the KV cache length below the model seq_len")
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8-quantize the KV cache")
    ap.add_argument("--kv-bits", type=int, default=8, choices=[8, 4])
    ap.add_argument("--attn-impl", default=None,
                    choices=["auto", "einsum", "batched", "batched_static",
                             "fused_step"],
                    help="decode attention: einsum (plain), fused_step "
                         "(the attention_step kernel) or auto (fused_step "
                         "at windows of 1024 and more)")
    ap.add_argument("--spec", default=None, choices=["ngram"])
    ap.add_argument("--spec-k", type=int, default=7, metavar="K")
    ap.add_argument("--tp", type=int, default=1, metavar="N")
    ap.add_argument("--lm-head-8bit", dest="lm_head_bits",
                    action="store_const", const=8,
                    help="per-row int8 lm_head")
    ap.add_argument("--lm-head-bits", dest="lm_head_bits", type=int,
                    default=None, choices=[8, 4],
                    help="quantize the lm_head (8: per-row int8, 4: w4-g128)")
    return ap


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)

    # the options of the JAX package that the port has not reached yet
    if args.mode == "perplexity":
        raise NotImplementedError("-m perplexity is not ported yet")
    if args.spec:
        raise NotImplementedError("--spec is not ported yet")
    if args.kv_bits == 4:
        raise NotImplementedError("--kv-bits 4 is not ported yet")
    if args.tp > 1:
        raise NotImplementedError("--tp is not ported yet")
    if args.attn_impl in ("batched", "batched_static"):
        raise NotImplementedError("--attn-impl batched is not ported yet")
    if args.act_dtype != "bfloat16":
        raise NotImplementedError("the port runs bf16 activations only")

    # parameter validation/overrides (llama2_q4.cu:680-685)
    if args.seed <= 0:
        args.seed = int(time.time())
    if args.temperature < 0.0:
        args.temperature = 0.0
    if args.topp < 0.0 or args.topp > 1.0:
        args.topp = 0.9
    if args.dataset:
        print("Warning: dataset path is ignored in non-perplexity mode")

    prompt = args.prompt
    if args.prompt_file:
        if prompt:
            print("Warning: -f overrides -i")
        with open(args.prompt_file) as f:
            prompt = f.read()

    from llama_cu_awq_torch.device import resolve_device
    from llama_cu_awq_torch.engine import InferenceEngine
    from llama_cu_awq_torch.io.checkpoint import load_checkpoint
    from llama_cu_awq_torch.models import (params_from_checkpoint,
                                           quantize_lm_head)
    from llama_cu_awq_torch.tokenizer import Tokenizer

    device = resolve_device(args.device)
    ckpt = load_checkpoint(args.checkpoint, verbose=True)
    print("\nLoading Weights... ", end="", flush=True)
    params = params_from_checkpoint(ckpt, device=device)
    if args.lm_head_bits:
        params = quantize_lm_head(params, bits=args.lm_head_bits)
    print("done!")

    tokenizer = Tokenizer(args.tokenizer, ckpt.config.vocab_size)
    engine = InferenceEngine(
        params, ckpt.config, tokenizer, attn_impl=args.attn_impl,
        kv_quant=args.kv_quant, temperature=args.temperature,
        topp=args.topp, seed=args.seed,
        max_seq=args.max_seq or ckpt.config.seq_len, device=device)

    if args.mode == "generate":
        print("\nEncoding Prompt... Done!")

        def emit(piece):
            print(piece, end="", flush=True)

        _, stats = engine.generate(prompt or "", args.steps, on_piece=emit,
                                   echo=True)
        print(f"\n\nachieved tok/s: {stats['tok_per_s']:f}. "
              f"Tokens: {stats['tokens']}, seconds: {stats['seconds']:g}")
    else:
        engine.chat_loop(prompt, args.system_prompt, args.steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
