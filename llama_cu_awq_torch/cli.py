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
  -m <string> mode: generate|chat|perplexity, default generate
  -y <string> system prompt for chat mode
  -q <string> dataset file for perplexity mode (sequences separated by
              <|endoftext|>)
  --device {cuda,cpu}  default cuda; cpu runs the kernels' plain versions

and the JAX CLI's options --max-seq, --kv-quant, --kv-bits, --attn-impl,
--spec, --spec-k, --lm-head-bits, --act-dtype bfloat16|float16|float32
(the activations' and the unquantized KV cache's type; float16 keeps the
checkpoint's fp16 embed and lm_head, float32 stores them in f32, as the
JAX CLI does), --profile DIR (a torch.profiler Chrome trace of the run,
utils/profiling.py) and --tp N.

--tp N runs tensor parallelism over N ranks (parallel/tp.py): this
process is rank 0, and it starts ranks 1..N-1 itself, one process each
(torch.multiprocessing, spawn). With --device cuda (N cards at least)
rank r computes on cuda:r and the ranks join over nccl; with --device cpu
they join over gloo. Every rank reads the checkpoint and builds its own
shard, and runs the same program; only rank 0 prints (and, in chat mode,
reads the terminal, broadcasting each line to the others). On the card
each rank's steps run on CUDA graphs split at the collectives
(engine/graphs.py). As in the JAX CLI, --lm-head-bits is ignored
with --tp, and the embed and head are stored in act_dtype (bf16 by
default).
"""

from __future__ import annotations

import argparse
import contextlib
import os
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
    ap.add_argument("--kv-bits", type=int, default=8, choices=[8, 4],
                    help="quantized KV width: 8 (default) or 4 (two codes "
                         "a byte; implies --kv-quant)")
    ap.add_argument("--attn-impl", default=None,
                    choices=["auto", "einsum", "batched", "batched_static",
                             "fused_step"],
                    help="decode attention: einsum (plain), fused_step "
                         "(the attention_step kernel), batched (the "
                         "batched_decode_attention kernel; batched_static "
                         "reads the whole window) or auto (fused_step at "
                         "windows of 1024 and more)")
    ap.add_argument("--spec", default=None, choices=["ngram"],
                    help="speculative decoding: prompt-lookup n-gram "
                         "proposals verified in one teacher-forced pass; "
                         "the same tokens as plain decode")
    ap.add_argument("--spec-k", type=int, default=7, metavar="K",
                    help="proposed tokens per verify (default 7)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler Chrome trace of the run "
                         "to DIR/trace.json")
    ap.add_argument("--tp", type=int, default=1, metavar="N",
                    help="tensor-parallel over N ranks, one process and "
                         "(with --device cuda) one card each")
    ap.add_argument("--lm-head-8bit", dest="lm_head_bits",
                    action="store_const", const=8,
                    help="per-row int8 lm_head")
    ap.add_argument("--lm-head-bits", dest="lm_head_bits", type=int,
                    default=None, choices=[8, 4],
                    help="quantize the lm_head (8: per-row int8, 4: w4-g128)")
    return ap


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)

    # parameter validation/overrides (llama2_q4.cu:680-685)
    if args.seed <= 0:
        args.seed = int(time.time())
    if args.temperature < 0.0:
        args.temperature = 0.0
    if args.topp < 0.0 or args.topp > 1.0:
        args.topp = 0.9
    perplexity = args.mode == "perplexity"
    if not perplexity and args.dataset:
        print("Warning: dataset path is ignored in non-perplexity mode")

    prompt = args.prompt
    if args.prompt_file:
        if prompt:
            print("Warning: -f overrides -i")
        with open(args.prompt_file) as f:
            prompt = f.read()

    from llama_cu_awq_torch.device import resolve_device
    from llama_cu_awq_torch.io.checkpoint import load_checkpoint

    resolve_device(args.device)
    if args.tp > 1 and args.device == "cuda":
        import torch

        have = torch.cuda.device_count()
        if args.tp > have:
            raise SystemExit(f"--tp {args.tp} needs {args.tp} cards, "
                             f"have {have}")
    ckpt = load_checkpoint(args.checkpoint, verbose=True)
    if args.tp == 1:
        return _rank(args, prompt, ckpt)

    from llama_cu_awq_torch.parallel.tp import _check_divisible

    # refused here, before any rank starts
    _check_divisible(ckpt.config, args.tp)
    from llama_cu_awq_torch.parallel.multihost import run_ranks

    return run_ranks(args.tp, lambda init: _rank(args, prompt, ckpt, 0,
                                                 args.tp, init),
                     _follower, (args, prompt))


def _follower(rank: int, n: int, init: str, args, prompt) -> None:
    """Rank 1..n-1 of `--tp n` (a spawned process): the rank's own copy
    of the checkpoint, then _rank; it prints nothing."""
    import signal

    from llama_cu_awq_torch.io.checkpoint import load_checkpoint

    # rank 0 takes the interrupt; multihost.run_ranks stops this process
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    sys.stdout = open(os.devnull, "w")  # noqa: SIM115 (the process's)
    sys.exit(_rank(args, prompt, load_checkpoint(args.checkpoint), rank, n,
                   init))


def _rank(args, prompt, ckpt, rank: int = 0, n: int = 1,
          init: str | None = None) -> int:
    """Build the engine (rank `rank` of n under --tp) and run the mode."""
    import torch

    from llama_cu_awq_torch.engine import InferenceEngine
    from llama_cu_awq_torch.models import (params_from_checkpoint,
                                           quantize_lm_head)
    from llama_cu_awq_torch.tokenizer import Tokenizer

    act_dtype = getattr(torch, args.act_dtype)
    # the JAX CLI's rule (cli.py:131): float16 keeps the checkpoint's fp16
    # embed and lm_head (None), the other types store them in act_dtype;
    # under --tp they are stored in act_dtype (cli.py:139-140)
    param_dtype = None if args.act_dtype == "float16" else act_dtype
    tp = None
    if n > 1:
        from llama_cu_awq_torch.parallel import init_multihost, make_mesh
        from llama_cu_awq_torch.parallel.tp import tp_params_from_checkpoint

        device = (torch.device("cuda", rank) if args.device == "cuda"
                  else torch.device("cpu"))
        if device.type == "cuda":
            torch.cuda.set_device(device)
        init_multihost(init, n, rank,
                       backend="nccl" if device.type == "cuda" else "gloo")
        tp = make_mesh(tp=n, dp=1, device=device).tp_group
    else:
        device = torch.device(args.device)
    try:
        print("\nLoading Weights... ", end="", flush=True)
        if tp is not None:
            params = tp_params_from_checkpoint(
                ckpt, n, rank, device=device,
                param_dtype=param_dtype or act_dtype)
        else:
            params = params_from_checkpoint(ckpt, device=device,
                                            param_dtype=param_dtype)
            if args.lm_head_bits:
                params = quantize_lm_head(params, bits=args.lm_head_bits)
        if args.lm_head_bits and tp is not None:
            print("Warning: --lm-head-bits is ignored with --tp")
        print("done!")

        tokenizer = Tokenizer(args.tokenizer, ckpt.config.vocab_size)
        engine = InferenceEngine(
            params, ckpt.config, tokenizer, attn_impl=args.attn_impl,
            kv_quant=4 if args.kv_bits == 4 else args.kv_quant,
            temperature=args.temperature, topp=args.topp, seed=args.seed,
            spec=args.spec, spec_k=args.spec_k,
            max_seq=args.max_seq or ckpt.config.seq_len, device=device,
            act_dtype=act_dtype, tp=tp)

        if args.profile and rank == 0:
            from llama_cu_awq_torch.utils.profiling import profile_trace

            profile_cm = profile_trace(args.profile)
        else:
            profile_cm = contextlib.nullcontext()
        with profile_cm:
            return _run_mode(args, engine, prompt, args.mode == "perplexity")
    finally:
        if tp is not None:
            import torch.distributed as dist

            dist.destroy_process_group()


def _shared_input(tp):
    """chat mode's input under --tp: rank 0 reads the terminal and sends
    each line (or its end of input) to the other ranks."""
    import torch.distributed as dist

    def read(prompt_text):
        box = [None]
        if tp.rank == 0:
            try:
                box[0] = input(prompt_text)
            except EOFError:
                pass
        dist.broadcast_object_list(box, src=tp.src, group=tp.group)
        if box[0] is None:
            raise EOFError
        return box[0]

    return read


def _run_mode(args, engine, prompt, perplexity: bool) -> int:
    from llama_cu_awq_torch.engine.perplexity import dataset_perplexity

    if perplexity:
        if not args.dataset:
            print("perplexity mode requires -q <dataset file>",
                  file=sys.stderr)
            return 1
        print("\nLoading Dataset...", end="", flush=True)
        with open(args.dataset, "rb") as f:
            text = f.read().decode("utf-8", errors="replace")
        print("done!")
        geo, count, _ = dataset_perplexity(engine, text, verbose=True)
        print(f"\nGeomean perplexity on {count} sequences: {geo:f}\n")
    elif args.mode == "generate":
        print("\nEncoding Prompt... Done!")

        def emit(piece):
            print(piece, end="", flush=True)

        _, stats = engine.generate(prompt or "", args.steps, on_piece=emit,
                                   echo=True)
        print(f"\n\nachieved tok/s: {stats['tok_per_s']:f}. "
              f"Tokens: {stats['tokens']}, seconds: {stats['seconds']:g}")
        if engine.spec:
            ss = engine.spec_stats
            rate = ss["accepted"] / ss["proposed"] if ss["proposed"] else 0.0
            print(f"spec: {ss['verifies']} verifies, "
                  f"{ss['accepted']}/{ss['proposed']} proposals "
                  f"accepted ({rate:.0%})")
    elif engine.tp is not None:
        engine.chat_loop(prompt, args.system_prompt, args.steps,
                         input_fn=_shared_input(engine.tp))
    else:
        engine.chat_loop(prompt, args.system_prompt, args.steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
