#!/bin/bash
# Real-model end to end on the port: train a small float Llama on real
# text, export it as an original-format AWQ dump, pack it with the port's
# pack_weights, then generate, speculative decoding, perplexity, the
# bench and the perplexity matrix through the port's engine and kernels. The steps of
# tools/real_model_e2e.sh, with the port's modules in place of the JAX
# package's and of the native packer.
#
# The tokenizer is the Llama-2 vocab as a llama2.c tokenizer.bin at the
# repository's root (.gitignore admits it there; tools/export_tokenizer
# writes it from a sentencepiece tokenizer.model).
#
# Usage: bash llama_cu_awq_torch/tools/real_model_e2e.sh [outdir] [steps]
set -euo pipefail
cd "$(dirname "$0")/../.."

OUT=${1:-${TMPDIR:-/tmp}/tinyllama}
STEPS=${2:-3000}
CORPUS=${REAL_E2E_CORPUS:-${TMPDIR:-/tmp}/corpus}
TOK=tokenizer.bin

[ -f "$CORPUS/train.txt" ] || \
    python -m llama_cu_awq_torch.tools.build_corpus --out "$CORPUS"

# 1. train (dim 512 / hidden 1536 / 8 layers / 4 heads, about 60M
# parameters) on the card. 4 heads, not the tool's default 8, so head_dim
# is 128 and the decode kernels (fused_step attention) run in the
# perplexity matrix below.
python -u -m llama_cu_awq_torch.tools.train_tiny --corpus "$CORPUS" \
    --out "$OUT" --steps "$STEPS" --heads 4 --kv-heads 4 --tokenizer "$TOK"

# 2. pack through the offline pipeline (the old AWQ format)
python -m llama_cu_awq_torch.tools.pack_weights "$OUT/awq/config.json" \
    "$OUT/awq" "$OUT/model.bin" 1

# 3. transcripts: greedy, and the reference's default sampling
python -m llama_cu_awq_torch "$OUT/model.bin" -z "$TOK" -t 0.0 -n 64 \
    -i "The gradient of a function" | tee "$OUT/transcript_greedy.txt"
python -m llama_cu_awq_torch "$OUT/model.bin" -z "$TOK" -t 0.5 -p 0.6 \
    -s 1234 -n 64 -i "To install the package," \
    | tee "$OUT/transcript_sampled.txt"

# 3b. speculative decoding on real text: the same greedy prompt without
# and with --spec; the output must match, and spec reports its acceptance
python -m llama_cu_awq_torch "$OUT/model.bin" -z "$TOK" -t 0.0 -n 128 \
    -i "The derivative of a function measures" \
    | tee "$OUT/transcript_plain.txt"
python -m llama_cu_awq_torch "$OUT/model.bin" -z "$TOK" -t 0.0 -n 128 \
    -i "The derivative of a function measures" --spec ngram \
    | tee "$OUT/transcript_spec.txt"

# 4. perplexity: the kernels on the card against their plain versions on
# the CPU
python -m llama_cu_awq_torch "$OUT/model.bin" -z "$TOK" -m perplexity \
    -q "$CORPUS/valid.txt" | tee "$OUT/ppl_kernels.txt"
python -m llama_cu_awq_torch "$OUT/model.bin" -z "$TOK" -m perplexity \
    -q "$CORPUS/valid.txt" --device cpu | tee "$OUT/ppl_plain.txt"

grep -h "Geomean perplexity" "$OUT/ppl_kernels.txt" "$OUT/ppl_plain.txt"

# 5. decode throughput on the real checkpoint: loader, tokenizer, kernels
# and sampler at speed; the default run reports plain and spec tok/s with
# the acceptance on a real prompt
python -m llama_cu_awq_torch.bench --model "$OUT/model.bin" -z "$TOK" \
    --steps 128 --repeats 3 | tee "$OUT/bench_decode_real.json"

# 6. the perplexity matrix over every quantization lever, scored stepwise
# through the decode path (one forward a token)
python -m llama_cu_awq_torch.tools.ppl_matrix "$OUT/model.bin" -z "$TOK" \
    -q "$CORPUS/valid.txt" --seqs 12 --json "$OUT/ppl_matrix.json" \
    | tee "$OUT/ppl_matrix.md"
