"""The bench: 7B w4-g128 decode, prefill and serving tokens/s on one card.

The counterpart of the repository's bench.py, with its interface and its
output:

    python -m llama_cu_awq_torch.bench [--config 7b|13b|tiny]
        [--mode decode|prefill|batch] [--device cuda|cpu] [options]

The last line of stdout is ONE JSON object, with bench.py's keys and
metric names for the same flags: "metric", "value", "unit", and
"vs_baseline" = value / 200.787402 (the reference's batch-1 decode on an
RTX 4090); "spec_acceptance" and "spec_workload" when speculative decoding
ran. The log goes to stderr, with a "launches {...}" line per timed leg:
the kernel launches of its timed runs (ops/cuda LAUNCHES, counted from 0
after the warm-up), "graph_pool_bytes" where the engine captured graphs,
and what each gate read.

Weights are synthetic (models/llama.py synthetic_params, seed 0) at the
configuration's exact shapes, or a packed checkpoint with --model BIN
(then "config" is "real" and vs_baseline is null). Modes:
- decode (default): an 8-token prompt (range(5, 13)) and --steps 256
  greedy steps through InferenceEngine.generate_benchmark, one untimed
  warm-up run (it captures the CUDA graphs), then the best of --repeats.
  By default plain decode, then speculative decode (--spec ngram) in a
  process of its own (leg_command: this run's flags, the stream handed
  back through --leg-out), then a 3-repeat plain re-bracket on the plain
  leg's engine, in one line with "decode_tok_s_plain",
  "decode_tok_s_spec", "plain_rebracket", "window_drift" and the faster
  leg's keys as the headline. --spec none|ngram runs one leg.
  --decode-steps N prefills the whole --prompt-len prompt untimed and
  times N decode steps: decode at depth (metric suffix _ctx{prompt_len}).
- prefill: _prefill of a --prompt-len prompt (ids 5 + i % 500), timed to
  a synchronize of the card; best of --repeats; vs_baseline null.
- batch: BatchEngine with --slots (16) serving --requests (32) greedy
  requests of --steps tokens; aggregate tok/s over the best run.
  --admit-long N gives every 4th request an N-token prompt; --prompt-file
  (one prompt a line, with -z) takes real prompts.
--tp N runs N ranks (parallel/multihost.py run_ranks; this process is
rank 0 and prints): over nccl where N cards are visible, one each;
otherwise over gloo with every rank on cuda:0, whose collectives go
through the host, so the number is no TP speed (the log says so). TP
engines run on CUDA graphs split at the collectives (engine/graphs.py);
the gates' replay engine runs eagerly, as at tp 1. --profile DIR traces
run 0 with utils/profiling.py profile_trace and prints
tools/trace_summary.py's summary of DIR/trace.json to stderr.

Gates (a failed gate exits non-zero and prints no result line):
- every timed run of a greedy leg returns the warm-up's tokens;
- the speculative stream equals the plain stream, or, where they part at
  a near-tie, each speculative token lies within SPEC_GAP (0.1) of the
  argmax of plain T=1 decode fed the speculative stream, and the top-2
  margin where it parts is below SPEC_GAP (chip_smoke.py replay_check,
  tests/test_spec_decode.py:44-63);
- in batch mode, requests 0, 1 and the last are replayed the same way
  (under --admit-long request 0 has the long prompt): every token within
  SPEC_GAP of the replayed argmax;
- prefill: the last block's logits are finite.

Where the port differs from bench.py:
- The default decode run's plain legs share this process and its
  weights; the speculative leg runs in a child process. bench.py runs
  every leg in a process of its own for its TPU compiler profile. Here
  the reason is measured: with the speculative leg in the same process,
  the re-bracket read 8 % below the plain leg (215 against 235 tok/s on
  an H100 80GB HBM3 at 700 W, chip_smoke.py phase 14 and probes), while
  plain decode after plain decode, and a new process after a
  speculative one, read level (PERF.md, sections 6 and 7). A leg that
  fails fails the run (bench.py carries on when one of two legs fails),
  and the child's leg comes back as a JSON file it wrote whole, not as
  parsed output, so bench.py:406's unguarded json.loads has no
  counterpart.
- --spec both with --decode-steps runs both legs at depth (bench.py
  turns it into the tuned spec leg alone); --spec both in prefill or
  batch mode is an argparse error (bench.py drops it silently).
- No tuned defaults: bench_defaults.json holds XLA flags, manual-DMA
  variables and choices measured on a TPU, and is not read. Each default
  here is bench.py's argparse default. bench.py's tuned file would make
  the plain leg use the int8 lm_head and the batch mode speculative:
  chip_smoke.py reads the int8 head at m=1 at 89.0 us against the bf16
  head's 111.1 (PERF.md section 6, row 3), 0.02 ms of a 4.2 ms token,
  and no real checkpoint has passed the perplexity bar with it on the
  card; spec serving depends on the text's acceptance. Ask for either
  with --lm-head-bits 8 or --spec ngram.
- --device cuda|cpu replaces --platform; cpu runs the kernels' plain
  versions (the tests), cuda without a card raises.
- --model with --tp shards the checkpoint (bench.py ignores --tp there).
  With --model the embed and head keep the checkpoint's fp16, as
  bench.py's params_from_checkpoint does, so the head runs its plain f32
  product (ops/linear.dense_matmul's rule, the JAX package's).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

BASELINE_TOK_S = 200.787402  # the reference's transcript (README.md:111)
# the largest logit gap to the replayed argmax a token may have
# (tests/test_spec_decode.py:44-63's tol, chip_smoke.py's SPEC_GAP)
SPEC_GAP = 0.1
REBRACKET_REPEATS = 3


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m llama_cu_awq_torch.bench",
        description="decode, prefill and serving tokens/s of the port")
    ap.add_argument("--config", default="7b", choices=["7b", "13b", "tiny"])
    ap.add_argument("--mode", default="decode",
                    choices=["decode", "batch", "prefill"],
                    help="decode: batch-1 tok/s (headline); batch: "
                         "continuous-batching aggregate tok/s; prefill: "
                         "prompt tok/s (the time-to-first-token side)")
    ap.add_argument("--steps", type=int, default=256)
    ap.add_argument("--decode-steps", type=int, default=None,
                    help="prefill the whole prompt untimed, then time N "
                         "decode steps: decode tok/s at depth")
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=None,
                    help="KV cache rows (default min(512, seq_len))")
    ap.add_argument("--chunk-size", type=int, default=None,
                    help="decode steps a host sync (default 128 for "
                         "decode, 16 for --mode batch)")
    ap.add_argument("--repeats", type=int, default=6,
                    help="timed runs after the warm-up; the best counts")
    ap.add_argument("--slots", type=int, default=16)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="trace run 0 with torch.profiler into "
                         "DIR/trace.json and summarize it on stderr")
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 KV cache")
    ap.add_argument("--kv-bits", type=int, default=8, choices=[8, 4],
                    help="quantized-KV width; 4 implies --kv-quant")
    ap.add_argument("--admit-long", type=int, default=0, metavar="N",
                    help="batch mode: every 4th request arrives with an "
                         "N-token prompt (block prefill mixed into decode)")
    ap.add_argument("--attn-impl", default=None,
                    choices=["auto", "einsum", "batched", "batched_static",
                             "fused_step"],
                    help="decode attention (default auto: attention_step "
                         "at windows of 1024 and more)")
    ap.add_argument("--lm-head-8bit", dest="lm_head_bits",
                    action="store_const", const=8,
                    help="per-row int8 lm_head")
    ap.add_argument("--lm-head-bits", dest="lm_head_bits", type=int,
                    default=None, choices=[8, 4],
                    help="quantize the lm_head (8: per-row int8, 4: w4-g128)")
    ap.add_argument("--spec", default=None, choices=["ngram", "none", "both"],
                    help="decode mode: plain and speculative legs by "
                         "default ('both'); 'none' or 'ngram' runs one; "
                         "batch mode: 'ngram' serves speculatively")
    ap.add_argument("--spec-k", type=int, default=7)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the card (default) or the plain versions on the "
                         "CPU")
    ap.add_argument("--model", default=None, metavar="BIN",
                    help="a packed checkpoint instead of synthetic weights "
                         "(its header sets the config)")
    ap.add_argument("-z", "--tokenizer", default=None,
                    help="tokenizer.bin: with --model, real prompts")
    ap.add_argument("--prompt-file", default=None, metavar="TXT",
                    help="prompts, one a line (-z needed); decode mode "
                         "takes the first")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel over N ranks")
    ap.add_argument("--leg-out", default=None, metavar="JSON",
                    help="a single decode leg: write its result, prompt "
                         "and token stream to JSON (the default run's "
                         "speculative leg hands its stream back so)")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    ap = build_argparser()
    argv = list(sys.argv[1:] if argv is None else argv)
    args = ap.parse_args(argv)
    args.argv = argv  # the speculative leg's process reruns them
    if args.spec == "both" and args.mode != "decode":
        ap.error(f"--spec both measures two decode legs; --mode "
                 f"{args.mode} takes --spec ngram or none")
    if args.prompt_file and not args.tokenizer:
        ap.error("--prompt-file needs -z tokenizer.bin")
    if args.tp < 1:
        ap.error("--tp must be at least 1")
    if args.leg_out and (args.mode != "decode"
                         or args.spec not in ("none", "ngram")):
        ap.error("--leg-out writes one decode leg: --spec none or ngram")
    if args.chunk_size is None:
        args.chunk_size = 16 if args.mode == "batch" else 128
    return args


# ---------------------------------------------------------------------------
# set-up


def tiny_config():
    from llama_cu_awq_torch.config import ModelConfig

    return ModelConfig(dim=256, hidden_dim=512, n_layers=2, n_heads=4,
                       n_kv_heads=4, vocab_size=512, seq_len=512)


def model_config(name: str):
    from llama_cu_awq_torch.config import LLAMA2_7B, LLAMA2_13B

    return {"7b": LLAMA2_7B, "13b": LLAMA2_13B}.get(name) or tiny_config()


def config_of(args):
    """The synthetic weights' ModelConfig: args.model_cfg where a caller
    set one (tools/bench_scaling.py's configurations), else --config's."""
    return getattr(args, "model_cfg", None) or model_config(args.config)


@dataclasses.dataclass
class Setup:
    """One rank's model and what the runs share."""

    args: argparse.Namespace
    cfg: object
    params: object
    max_seq: int
    device: object
    tp: object = None  # this rank's TPGroup under --tp

    @property
    def leader(self) -> bool:
        return self.tp is None or self.tp.rank == 0

    def kv_quant(self):
        return 4 if self.args.kv_bits == 4 else self.args.kv_quant


def load(args, device, tp=None, ckpt=None) -> Setup:
    """The params on `device` (this rank's shard under tp)."""
    from llama_cu_awq_torch.models import (params_from_checkpoint,
                                           quantize_lm_head,
                                           synthetic_params)

    t0 = time.time()
    n = tp.size if tp is not None else 1
    rank = tp.rank if tp is not None else 0
    if args.model:
        cfg = ckpt.config
        if tp is not None:
            from llama_cu_awq_torch.parallel.tp import (
                tp_params_from_checkpoint)

            params = tp_params_from_checkpoint(ckpt, n, rank, device=device)
        else:
            params = params_from_checkpoint(ckpt, device=device,
                                            param_dtype=None)
    else:
        cfg = config_of(args)
        if tp is not None:
            from llama_cu_awq_torch.parallel.tp import tp_synthetic_params

            params = tp_synthetic_params(cfg, n, rank, seed=0, device=device)
        else:
            params = synthetic_params(cfg, seed=0, device=device)
    if args.lm_head_bits:
        if tp is None:
            params = quantize_lm_head(params, bits=args.lm_head_bits)
        elif rank == 0:
            log("warning: --lm-head-bits is ignored with --tp (the "
                "metric keeps bench.py's _lmh suffix)")
    sync(device)
    if rank == 0:
        log(f"params ready in {time.time() - t0:.1f}s ({args.config}, "
            f"{device}, tp={n})")
    return Setup(args, cfg, params, args.max_seq or min(512, cfg.seq_len),
                 device, tp)


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def reset_launches() -> None:
    from llama_cu_awq_torch.ops.cuda import reset_launches as reset

    reset()


def read_counts() -> dict:
    from llama_cu_awq_torch.ops.cuda import LAUNCHES, VARIANT_LAUNCHES

    return {"kernels": {k: n for k, n in LAUNCHES.items() if n},
            "variants": dict(sorted(VARIANT_LAUNCHES.items()))}


def pool_bytes(eng) -> int | None:
    graphs = getattr(eng, "_graphs", None)
    if graphs is None:
        return None
    return sum(g.pool_bytes for g in graphs.graphs.values())


@contextlib.contextmanager
def maybe_profile(s: Setup, on: bool):
    """profile_trace(--profile) around the block on the leader when `on`,
    then the trace's summary on stderr."""
    if not (on and s.args.profile and s.leader):
        yield
        return
    from llama_cu_awq_torch.tools.trace_summary import summarize
    from llama_cu_awq_torch.utils.profiling import profile_trace

    with profile_trace(s.args.profile):
        yield
    log(f"profiler trace written to {s.args.profile}")
    summarize(s.args.profile, top=20, families=True, out=sys.stderr)


def report(s: Setup, leg: str, runs: int, tokens: int, eng=None) -> None:
    """The leader's launches line for a leg's timed runs."""
    if not s.leader:
        return
    line = {"leg": leg, "runs": runs, "tokens_per_run": tokens,
            **read_counts()}
    if eng is not None:
        line["graph_pool_bytes"] = pool_bytes(eng)
    log("launches " + json.dumps(line))


# ---------------------------------------------------------------------------
# replay: a stream fed through plain T=1 decode


def replay(s: Setup, prompt: list[int], stream: list[int],
           windows: dict[int, int] | None = None):
    """Plain T=1 decode (a capture=False engine with the run's cache and
    attention) fed `stream` after the prompt: per token, the gap of its
    logit to that step's argmax and the step's top-2 margin.

    Without `windows`, prompt[:-1] goes through _prefill and each step
    takes its own window. With `windows` (position -> the attention
    window the batch engine's step there ran at, its window_log), the
    replay takes the batch's path: the prompt as BatchEngine feeds it
    (forced T=1 steps up to FORCED_PROMPT_MAX tokens, else blocks) and
    every step at the batch's window, so that forward makes the batch's
    choice between attention_step and plain attention at each position
    (models/llama.plan). A slot's result in either does not depend on the
    other slots, so the replay meets the batch's rounding; across the two
    paths it does not, and on synthetic 7B weights a difference in
    rounding can, hundreds of steps on, turn the argmax over (PERF.md,
    section 6: a gap of 10.5 logits at position 222, from caches within
    a bf16 rounding of each other)."""
    import torch

    from llama_cu_awq_torch.engine import BatchEngine, InferenceEngine
    from llama_cu_awq_torch.models import forward

    eng = InferenceEngine(s.params, s.cfg, None, temperature=0.0,
                          max_seq=s.max_seq, kv_quant=s.kv_quant(),
                          attn_impl=s.args.attn_impl, device=s.device,
                          capture=False, tp=s.tp)
    feed = [prompt[-1]] + stream[:-1]
    if windows is not None and len(prompt) <= BatchEngine.FORCED_PROMPT_MAX:
        feed = prompt + stream[:-1]
    elif len(prompt) > 1:
        # a block prefill for a batch engine's long prompt, as its slot
        # prefill runs it
        eng._prefill(prompt[:-1], collect_logits=windows is not None)
    first = len(prompt) - 1  # the position whose step emits stream[0]
    gaps, margins = [], []
    for t_in in feed:
        p = eng.pos
        window = (windows.get(p) if windows else None) or \
            eng._bucket_for(p + 1)
        logits, _ = forward(
            s.params, s.cfg,
            torch.tensor([[t_in]], dtype=torch.int32, device=s.device),
            torch.tensor([p], dtype=torch.int32, device=s.device),
            eng.cache, attn_len=window, attn_impl=eng.attn_impl,
            no_logits=p < first, tp=s.tp)
        eng.pos += 1
        if p < first:
            continue
        top2 = logits[0].float().topk(2).values
        gaps.append(top2[0] - logits[0, stream[p - first]].float())
        margins.append(top2[0] - top2[1])
    del eng
    return torch.stack(gaps).tolist(), torch.stack(margins).tolist()


# ---------------------------------------------------------------------------
# decode


@dataclasses.dataclass
class Leg:
    result: dict
    tokens: list
    prompt: list
    engine: object


def decode_prompt(s: Setup) -> list[int]:
    args = s.args
    if args.model and args.tokenizer:
        from llama_cu_awq_torch.tokenizer import Tokenizer

        tk = Tokenizer(args.tokenizer, s.cfg.vocab_size)
        if args.prompt_file:
            with open(args.prompt_file) as f:
                text = f.readline().strip()
        else:
            text = "Once upon a time"
        prompt = tk.encode(text, bos=True, eos=False)
        if s.leader:
            log(f"real prompt: {len(prompt)} tokens")
        return prompt
    return list(range(5, 5 + args.prompt_len))


def decode_metric(args, spec) -> str:
    return (f"decode_tok_s_{args.config}_w4g128_b1"
            + (f"_tp{args.tp}" if args.tp > 1 else "")
            + (f"_lmh{args.lm_head_bits}" if args.lm_head_bits else "")
            + (f"_kv{args.kv_bits}" if (args.kv_quant or args.kv_bits == 4)
               else "")
            + (f"_spec{args.spec_k}" if spec else "")
            + (f"_ctx{args.prompt_len}" if args.decode_steps else ""))


def vs_baseline(args, value):
    return (None if args.model and args.config != "7b"
            else round(value / BASELINE_TOK_S, 4))


def decode_leg(s: Setup, spec: str | None, repeats: int, name: str,
               engine=None, profile: bool = True) -> Leg:
    """One decode leg: a warm-up run (skipped when `engine` is given, whose
    graphs are captured), then the best of `repeats` timed runs, each
    returning the warm-up's tokens."""
    from llama_cu_awq_torch.engine import InferenceEngine

    args = s.args
    eng = engine or InferenceEngine(
        s.params, s.cfg, None, attn_impl=args.attn_impl,
        kv_quant=s.kv_quant(), max_seq=s.max_seq, temperature=0.0,
        seed=1234, chunk_size=args.chunk_size, spec=spec,
        spec_k=args.spec_k, device=s.device, tp=s.tp)
    prompt = decode_prompt(s)
    untimed = bool(args.decode_steps)
    if untimed:
        steps = min(args.prompt_len + args.decode_steps, s.max_seq - 2)
    else:
        steps = min(args.steps, s.max_seq - 2)
    want = None
    if engine is None:
        if s.leader:
            log(f"[{name}] warm-up (captures the graphs)...")
        t0 = time.time()
        want, _, _ = eng.generate_benchmark(prompt, steps, untimed)
        if s.leader:
            log(f"[{name}] warm-up done in {time.time() - t0:.1f}s")
    sync(s.device)
    reset_launches()
    best = 0.0
    for i in range(repeats):
        with maybe_profile(s, profile and i == 0):
            tokens, dt, tok_s = eng.generate_benchmark(prompt, steps,
                                                       untimed)
        if s.leader:
            log(f"[{name}] run {i}: {len(tokens)} generated, "
                f"{len(tokens) if untimed else steps - 1} timed steps in "
                f"{dt:.3f}s -> {tok_s:.2f} tok/s")
        if want is None:
            want = tokens
        if tokens != want:
            raise SystemExit(f"bench: {name} run {i} returned other tokens "
                             f"than the first run of the greedy leg")
        best = max(best, tok_s)
    sync(s.device)
    report(s, name, repeats, len(want), eng)
    bad = [t for t in want if not 0 <= t < s.cfg.vocab_size]
    if not want or bad:
        raise SystemExit(f"bench: {name} emitted {len(want)} tokens, "
                         f"{len(bad)} out of the vocabulary")
    result = {"metric": decode_metric(args, spec), "value": round(best, 2),
              "unit": "tok/s", "vs_baseline": vs_baseline(args, best)}
    if spec:
        ss = eng.spec_stats
        if ss.get("proposed"):
            acc = ss["accepted"] / ss["proposed"]
            if s.leader:
                log(f"[{name}] spec acceptance: {ss['accepted']}/"
                    f"{ss['proposed']} ({acc:.1%}) over {ss['verifies']} "
                    f"verifies")
            result["spec_acceptance"] = round(acc, 4)
            result["spec_workload"] = ("real" if args.model and args.tokenizer
                                       else "synthetic")
    n_pref = min(len(prompt), steps)
    return Leg(result, want, prompt[:n_pref], eng)


def spec_gate(s: Setup, plain: Leg, spec: Leg) -> dict:
    """The speculative stream against the plain one: equal, or parted at a
    near-tie that plain decode's replay confirms (the module docstring)."""
    split = next((i for i, (a, b) in enumerate(zip(spec.tokens,
                                                   plain.tokens)) if a != b),
                 None)
    if split is None and len(spec.tokens) == len(plain.tokens):
        if s.leader:
            log(f"spec gate: the spec stream equals the plain stream "
                f"({len(plain.tokens)} tokens)")
        return {"equal": True}
    gaps, margins = replay(s, spec.prompt, spec.tokens)
    split = len(plain.tokens) if split is None else split
    margin = margins[split] if split < len(margins) else None
    line = {"equal": False, "first_divergence_from_plain": split,
            "max_gap": max(gaps), "margin_there": margin,
            "tolerance": SPEC_GAP}
    if s.leader:
        log("spec gate: the streams part; replay " + json.dumps(line))
    if max(gaps) >= SPEC_GAP:
        raise SystemExit(f"bench: spec token {gaps.index(max(gaps))} is "
                         f"{max(gaps)} below the replayed argmax")
    if margin is not None and margin >= SPEC_GAP:
        raise SystemExit(f"bench: the spec stream parts from plain at "
                         f"{split} where the top-2 margin is {margin}")
    return line


def leg_command(args, out: str) -> list[str]:
    """The command of the default run's speculative leg: this run's flags
    with --spec ngram, its prompt and stream written to `out`."""
    return [sys.executable, "-m", "llama_cu_awq_torch.bench", *args.argv,
            "--spec", "ngram", "--leg-out", out]


def spec_leg(s: Setup) -> Leg:
    """The speculative leg in a process of its own (the module docstring),
    started by the leader; its Leg on every rank (no engine)."""
    import subprocess
    import tempfile

    import torch.distributed as dist

    box = [None]
    if s.leader:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (root, env.get("PYTHONPATH")) if p)
        with tempfile.TemporaryDirectory(prefix="bench_leg_") as tmp:
            out = os.path.join(tmp, "leg.json")
            rc = subprocess.run(leg_command(s.args, out), env=env,
                                stdout=subprocess.DEVNULL).returncode
            if rc:
                raise SystemExit(f"bench: the spec leg's process exited "
                                 f"with {rc}")
            with open(out) as f:
                box[0] = json.load(f)
    if s.tp is not None:
        dist.broadcast_object_list(box, src=s.tp.src, group=s.tp.group)
    return Leg(box[0]["result"], box[0]["tokens"], box[0]["prompt"], None)


def write_leg(path: str, leg: Leg) -> None:
    with open(path, "w") as f:
        json.dump({"result": leg.result, "tokens": leg.tokens,
                   "prompt": leg.prompt}, f)


def dual_run(s: Setup) -> dict:
    """Plain decode, then speculative decode in a process of its own, then
    a short plain re-bracket on the plain leg's engine, then the gate, in
    one line (the module docstring)."""
    plain = decode_leg(s, None, s.args.repeats, "plain")
    spec = spec_leg(s)
    again = decode_leg(s, None, REBRACKET_REPEATS, "rebracket",
                       engine=plain.engine, profile=False)
    if again.tokens != plain.tokens:
        raise SystemExit("bench: the re-bracket's tokens differ from the "
                         "plain leg's")
    re_val = again.result["value"]
    del again
    plain.engine = None  # its graph pool, before the gate's replay
    spec_gate(s, plain, spec)
    p_val, s_val = plain.result["value"], spec.result["value"]
    result = dict(max((plain.result, spec.result), key=lambda r: r["value"]))
    result["decode_tok_s_plain"] = p_val
    result["decode_tok_s_spec"] = s_val
    if spec.result.get("spec_acceptance") is not None:
        result["spec_acceptance"] = spec.result["spec_acceptance"]
        result["spec_workload"] = spec.result["spec_workload"]
    if p_val:
        result["plain_rebracket"] = re_val
        result["window_drift"] = round(re_val / p_val, 4)
    return result


# ---------------------------------------------------------------------------
# prefill


def bench_prefill(s: Setup) -> dict:
    """Prompt tok/s: _prefill of an n-token prompt (PREFILL_BLOCK-wide
    blocks, the lm_head on the last), timed to a synchronize."""
    import torch

    from llama_cu_awq_torch.engine import InferenceEngine

    args = s.args
    if (args.kv_quant or args.kv_bits == 4) and s.leader:
        log("warning: --mode prefill runs the bf16 cache, as bench.py does")
    eng = InferenceEngine(s.params, s.cfg, None, attn_impl=args.attn_impl,
                          max_seq=s.max_seq, temperature=0.0, seed=1234,
                          chunk_size=args.chunk_size, device=s.device,
                          tp=s.tp)
    n = min(args.prompt_len, s.max_seq - 2)
    prompt = [5 + i % 500 for i in range(n)]

    def one_run():
        eng.reset()
        sync(s.device)
        t0 = time.time()
        last = eng._prefill(prompt)
        sync(s.device)
        dt = time.time() - t0
        if last is not None and not bool(torch.isfinite(last).all()):
            raise SystemExit("bench: the prompt's last logits are not "
                             "finite")
        return dt

    if s.leader:
        log(f"warm-up (captures the blocks of a {n}-token prompt)...")
    one_run()
    reset_launches()
    best = None
    for i in range(args.repeats):
        with maybe_profile(s, i == 0):
            dt = one_run()
        if s.leader:
            log(f"run {i}: {n} prompt tokens in {dt * 1e3:.1f}ms -> "
                f"{n / dt:.0f} tok/s prefill")
        best = dt if best is None else min(best, dt)
    report(s, "prefill", args.repeats, n, eng)
    return {"metric": f"prefill_tok_s_{args.config}_w4g128_p{n}"
                      + (f"_tp{args.tp}" if args.tp > 1 else ""),
            "value": round(n / best, 1), "unit": "tok/s",
            # the reference publishes no prefill number
            "vs_baseline": None}


# ---------------------------------------------------------------------------
# batch


def batch_prompts(s: Setup):
    """(prompts, steps) as bench.py's bench_batch makes them."""
    from llama_cu_awq_torch.tokenizer import BOS_TOKEN, Tokenizer

    args, max_seq = s.args, s.max_seq
    if args.prompt_file:
        tk = Tokenizer(args.tokenizer, s.cfg.vocab_size)
        with open(args.prompt_file) as f:
            lines = [ln.strip() for ln in f if ln.strip()]
        texts = [lines[i % len(lines)] for i in range(args.requests)]
        prompts = [tk.encode(t, bos=True, eos=False)[:max_seq // 2]
                   for t in texts]
        longest = max(len(p) for p in prompts)
    else:
        longest = max(args.prompt_len, args.admit_long)
        prompts = [[BOS_TOKEN] + [5 + (i + j) % 500
                                  for j in range(args.prompt_len - 1)]
                   for i in range(args.requests)]
    steps = min(args.steps, max_seq - 2 - longest)
    if args.admit_long:
        for i in range(0, args.requests, 4):
            prompts[i] = [BOS_TOKEN] + [7 + (i + j) % 500
                                        for j in range(args.admit_long - 1)]
    return prompts, steps


def batch_metric(args) -> str:
    return (f"batch_tok_s_{args.config}_w4g128_s{args.slots}"
            f"_r{args.requests}"
            + ("_kvq4" if args.kv_bits == 4
               else ("_kvq8" if args.kv_quant else ""))
            + (f"_tp{args.tp}" if args.tp > 1 else "")
            + (f"_spec{args.spec_k}" if args.spec == "ngram" else "")
            + (f"_admL{args.admit_long}" if args.admit_long else ""))


def bench_batch(s: Setup) -> dict | None:
    """Continuous-batching aggregate tok/s: --requests over --slots, the
    best of --repeats runs (run 0 is not counted when it is profiled, as
    in bench.py), then three requests' streams replayed."""
    import torch.distributed as dist

    from llama_cu_awq_torch.engine import BatchEngine

    args = s.args
    spec = "ngram" if args.spec == "ngram" else None
    prompts, steps = batch_prompts(s)
    if steps < 1:
        raise SystemExit(f"bench: no room to decode: max_seq {s.max_seq} "
                         f"after prompts of up to "
                         f"{max(len(p) for p in prompts)} tokens")
    eng = BatchEngine(s.params, s.cfg, None, n_slots=args.slots,
                      max_seq=s.max_seq, kv_quant=s.kv_quant(),
                      attn_impl=args.attn_impl, temperature=0.0,
                      chunk_size=args.chunk_size, spec=spec,
                      spec_k=args.spec_k, device=s.device, tp=s.tp)
    best, out, windows = 0.0, None, {}
    if s.leader:
        def one_run():
            eng.reset()
            rids = [eng.submit(p, max_new=steps) for p in prompts]
            t0 = time.time()
            res = eng.run()
            dt = time.time() - t0
            streams = [res[r] for r in rids]
            return streams, sum(len(v) for v in streams), dt, rids

        try:
            log("warm-up (captures the chunk, prefill and spec graphs)...")
            eng.window_log = windows
            out, _, _, rids = one_run()
            eng.window_log = None
            # the windows each request's positions ran at, by request
            windows = [windows.get(r, {}) for r in rids]
            reset_launches()
            for i in range(args.repeats):
                with maybe_profile(s, i == 0):
                    res, total, dt, _ = one_run()
                if res != out:
                    raise SystemExit(f"bench: batch run {i} returned other "
                                     f"streams than the first run")
                if i == 0 and args.profile:
                    continue
                log(f"run {i}: {args.requests} requests, {total} tokens in "
                    f"{dt:.2f}s -> {total / dt:.1f} tok/s aggregate")
                best = max(best, total / dt)
            report(s, "batch", args.repeats, sum(map(len, out)), eng)
            if spec:
                ss = eng.spec_stats
                if ss.get("proposed"):
                    log(f"spec acceptance: {ss['accepted']}/{ss['proposed']}"
                        f" ({ss['accepted'] / ss['proposed']:.1%}) over "
                        f"{ss['blocks']} blocks"
                        + (" [real prose]" if args.prompt_file else
                           " [synthetic]"))
        finally:
            eng.stop_followers()
    else:
        eng.follow()
    del eng
    # the replayed requests: the first (the long one under --admit-long),
    # the second and the last
    picks = sorted({0, min(1, args.requests - 1), args.requests - 1})
    box = [None if out is None else [(prompts[i], out[i], windows[i])
                                     for i in picks]]
    if s.tp is not None:
        dist.broadcast_object_list(box, src=s.tp.src, group=s.tp.group)
    worst = []
    for (prompt, stream, wins), i in zip(box[0], picks):
        bad = [t for t in stream if not 0 <= t < s.cfg.vocab_size]
        if not stream or len(stream) > steps or bad:
            raise SystemExit(f"bench: request {i} returned {len(stream)} "
                             f"tokens ({len(bad)} out of the vocabulary)")
        gaps, _ = replay(s, prompt, stream, wins)
        worst.append(max(gaps))
        if max(gaps) >= SPEC_GAP:
            raise SystemExit(f"bench: request {i}'s token "
                             f"{gaps.index(max(gaps))} is {max(gaps)} below "
                             f"the replayed argmax")
    if not s.leader:
        return None
    log("batch gate: " + json.dumps({
        "replayed_requests": picks,
        "prompt_tokens": [len(p) for p, _, _ in box[0]],
        "max_gap": worst, "tolerance": SPEC_GAP}))
    return {"metric": batch_metric(args), "value": round(best, 1),
            "unit": "tok/s",
            "vs_baseline": (None if args.model
                            else round(best / BASELINE_TOK_S, 4))}


# ---------------------------------------------------------------------------
# entry points


def run_mode(s: Setup) -> dict | None:
    args = s.args
    if args.mode == "batch":
        return bench_batch(s)
    if args.mode == "prefill":
        return bench_prefill(s)
    if args.spec == "both" or (args.spec is None and not args.decode_steps):
        return dual_run(s)
    spec = "ngram" if args.spec == "ngram" else None
    leg = decode_leg(s, spec, args.repeats, "spec" if spec else "plain",
                     profile=not args.leg_out)
    if args.leg_out and s.leader:
        write_leg(args.leg_out, leg)
    return leg.result


def first_card(args) -> int:
    """The card of a --tp run's rank 0: K of --device cuda:K (0 for cuda;
    tools/bench_scaling.py gives each of its processes its own)."""
    import torch

    return torch.device(args.device).index or 0


def tp_backend(args) -> str:
    """nccl where --tp cards are visible from first_card, else gloo."""
    from llama_cu_awq_torch.parallel.multihost import host_backend

    return host_backend(args.device, args.tp, first_card(args))


def rank_device(args, rank: int, backend: str):
    """cuda:K+rank under nccl (K = first_card), cuda:K for every rank
    under gloo, or the CPU."""
    from llama_cu_awq_torch.parallel import multihost

    return multihost.rank_device(rank, args.device, backend,
                                 first_card(args))


def run_rank(args, ckpt, rank: int, init: str, backend: str):
    """Rank `rank` of --tp N: join, build the shard, run the mode. Returns
    the result on rank 0."""
    import datetime

    import torch
    import torch.distributed as dist

    from llama_cu_awq_torch.parallel import init_multihost, make_mesh

    device = rank_device(args, rank, backend)
    threads = torch.get_num_threads()
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        # ranks sharing the cores would oversubscribe them many times over
        torch.set_num_threads(1)
    init_multihost(init, args.tp, rank, backend=backend,
                   timeout=datetime.timedelta(seconds=900))
    try:
        tp = make_mesh(tp=args.tp, dp=1, device=device).tp_group
        return run_mode(load(args, device, tp, ckpt))
    finally:
        dist.destroy_process_group()
        torch.set_num_threads(threads)


def _follower(rank: int, n: int, init: str, args, backend) -> None:
    """Ranks 1..n-1 of --tp n (spawned processes): each reads the
    checkpoint itself; they print nothing."""
    import signal

    signal.signal(signal.SIGINT, signal.SIG_IGN)
    sys.stdout = open(os.devnull, "w")  # noqa: SIM115 (the process's)
    ckpt = None
    if args.model:
        from llama_cu_awq_torch.io.checkpoint import load_checkpoint

        ckpt = load_checkpoint(args.model)
    run_rank(args, ckpt, rank, init, backend)


def run(argv=None) -> dict:
    """Parse argv, run the bench and return the result line's object."""
    return run_args(parse_args(argv))


def run_args(args) -> dict:
    """The bench on parsed arguments (parse_args): one process, or --tp
    ranks with this one as rank 0."""
    from llama_cu_awq_torch.device import resolve_device

    device = resolve_device(args.device)
    ckpt = None
    if args.model:
        from llama_cu_awq_torch.io.checkpoint import load_checkpoint

        log(f"loading checkpoint {args.model}...")
        ckpt = load_checkpoint(args.model)
        args.config = "real"
    if args.tp == 1:
        return run_mode(load(args, device, None, ckpt))

    from llama_cu_awq_torch.parallel.multihost import run_ranks
    from llama_cu_awq_torch.parallel.tp import _check_divisible

    # refused here, before any rank starts
    _check_divisible(ckpt.config if ckpt else config_of(args), args.tp)
    backend = tp_backend(args)
    if backend == "gloo" and args.device != "cpu":
        log(f"--tp {args.tp}: {args.tp} ranks share cuda:{first_card(args)}"
            f" over gloo (collectives through the host): this number is no "
            f"TP speed")
    box = {}

    def leader(init):
        box["result"] = run_rank(args, ckpt, 0, init, backend)
        return 0

    rc = run_ranks(args.tp, leader, _follower, (args, backend))
    if rc:
        raise SystemExit(f"bench: a --tp rank exited with {rc}")
    return box["result"]


def main(argv=None) -> int:
    print(json.dumps(run(argv)), flush=True)
    return 0


if __name__ == "__main__":
    # through the package's name, so the spawned --tp ranks find _follower
    from llama_cu_awq_torch.bench import main as _main

    sys.exit(_main())
