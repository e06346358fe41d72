"""Block prefill and perplexity in the port, held to the JAX package on the
CPU.

Inputs are made from a seed with numpy and handed to both packages. The
JAX side runs its Pallas kernels in interpret mode. Its engine is driven
with its forward bound to fused=True (the fused staging the port runs;
on the CPU the JAX engine would otherwise pick the unfused path, which
rounds differently), as tests/test_torch_engine.py's replay does.

Tolerances: the JAX prefill kernel walks 256 to 1024 keys per step, the
port 64, so p rounds to bf16 against another running max and the two
agree to bf16 rounding of p (rtol 2e-2, atol 2e-3, the bar of
tests/test_torch_ops.py for attention_step); logits of two paths that
round differently are held to the JAX package's bar of
tests/test_fused_path.py:51-52 (rtol/atol 2e-2); greedy streams must be
identical.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cu_awq_torch.config import ModelConfig as TModelConfig
from llama_cu_awq_torch.engine import InferenceEngine as TEngine
from llama_cu_awq_torch.engine import engine as t_engine_mod
from llama_cu_awq_torch.engine import perplexity as t_ppl
from llama_cu_awq_torch.io.checkpoint import random_checkpoint as t_random
from llama_cu_awq_torch.models import llama as tl
from llama_cu_awq_torch.ops.cuda.int4_matmul import (gemm_splits,
                                                     int4_matmul,
                                                     int4_matmul_fused)
from llama_cu_awq_torch.ops.cuda.prefill_attention import (
    CHUNK, SPLIT_ROWS)
from llama_cu_awq_torch.ops.cuda.prefill_attention import (
    prefill_attention as t_prefill_attention)
from llama_cu_awq_torch.tokenizer import Tokenizer as TTokenizer
from llama_cu_awq_tpu.config import ModelConfig
from llama_cu_awq_tpu.engine import perplexity as j_ppl
from llama_cu_awq_tpu.engine.engine import InferenceEngine as JEngine
from llama_cu_awq_tpu.io.checkpoint import random_checkpoint
from llama_cu_awq_tpu.models import llama as jl
from llama_cu_awq_tpu.models.llama import quantize_kv as j_quantize_kv
from llama_cu_awq_tpu.ops.linear import qmatmul as j_qmatmul
from llama_cu_awq_tpu.ops.linear import qmatmul_fused as j_qmatmul_fused
from llama_cu_awq_tpu.ops.pallas.prefill_attention import (
    prefill_attention as j_prefill_attention)
from llama_cu_awq_tpu.quant.qtensor import to_tpu_layout
from llama_cu_awq_tpu.tokenizer import Tokenizer as JTokenizer
from tests.test_tokenizer import write_toy_tokenizer
from tests.test_torch_engine import _toy_vocab
from tests.test_torch_ops import _bf16, _np, _qtensors, _variant_args

# one intra-op thread per process: the suite runs in several worker
# processes, and torch's default pool in each oversubscribes the cores
# (tens of times slower on small tensors); it also fixes the CPU sum order
torch.set_num_threads(1)

# head_dim 128 and a 256-row cache, so the JAX forward engages its Pallas
# prefill kernel (prefill_attention.supports); GQA 2/1
CFG = ModelConfig(dim=256, hidden_dim=384, n_layers=2, n_heads=2,
                  n_kv_heads=1, vocab_size=512, seq_len=256)
ATTN = dict(rtol=2e-2, atol=2e-3)
LOGITS = dict(rtol=2e-2, atol=2e-2)


# ---------------------------------------------------------------------------
# prefill_attention

def _attn_inputs(rng, B, T, A, H, n_kv, D):
    """bf16 q, k, v with the same bits in both packages (the port's cache
    is bf16; the JAX kernel rounds q, k and v to bf16 itself)."""
    q = rng.standard_normal((B, T, H, D), dtype=np.float32)
    k = rng.standard_normal((B, A, n_kv, D), dtype=np.float32) * 0.3
    v = rng.standard_normal((B, A, n_kv, D), dtype=np.float32) * 0.3
    return _bf16(q), _bf16(k), _bf16(v)


@pytest.mark.parametrize("B,T,A,H,n_kv,D,pos", [
    (1, 16, 256, 4, 4, 128, 0),     # MHA, block at the start
    (1, 32, 256, 4, 4, 128, 100),   # mid-window block (partial past)
    (2, 16, 256, 4, 2, 128, 37),    # GQA kv_mul=2, two slots
    (1, 128, 128, 2, 2, 128, 0),    # block == whole window
    (2, 8, 512, 4, 4, 128, None),   # per-slot positions, deep window
    (1, 16, 256, 16, 16, 128, 60),  # G=8 head groups, n_groups=2
])
def test_prefill_attention_plain_matches_pallas_interpret(rng, B, T, A, H,
                                                          n_kv, D, pos):
    """The cases of tests/test_prefill_attention.py:23-30."""
    (jq, tq), (jk, tk), (jv, tv) = _attn_inputs(rng, B, T, A, H, n_kv, D)
    p = (np.full(B, pos, np.int32) if pos is not None
         else rng.integers(0, A - T, B).astype(np.int32))
    want = j_prefill_attention(jq, jk, jv, jnp.asarray(p), interpret=True)
    got = t_prefill_attention(tq, tk, tv, torch.from_numpy(p))
    np.testing.assert_allclose(_np(got), _np(want), **ATTN)


def test_prefill_attention_int8_plain_matches_pallas_interpret(rng):
    """Codes and scales into both: tests/test_prefill_attention.py:45."""
    B, T, A, H, n_kv, D = 2, 16, 256, 4, 2, 128
    (jq, tq), (jk, _), (jv, _) = _attn_inputs(rng, B, T, A, H, n_kv, D)
    p = np.array([100, 31], np.int32)
    jkq, jks = j_quantize_kv(jk)
    jvq, jvs = j_quantize_kv(jv)
    want = j_prefill_attention(jq, jkq, jvq, jnp.asarray(p), jks, jvs,
                               interpret=True)
    got = t_prefill_attention(tq, *(torch.from_numpy(np.array(a)) for a in (
        jkq, jvq)), torch.from_numpy(p),
        *(torch.from_numpy(np.array(a)) for a in (jks, jvs)))
    np.testing.assert_allclose(_np(got), _np(want), **ATTN)


# blocks whose keys cross no split boundary, one, and three: the last key
# (pos + T - 1) at 115, at SPLIT_ROWS (one row past the first split) and
# at 3 * SPLIT_ROWS + 47
_SPLIT_CASES = {"none": (16, 100), "one": (16, SPLIT_ROWS - 15),
                "several": (32, 3 * SPLIT_ROWS + 16)}


@pytest.mark.parametrize("kind", ["bf16", "int8", "gqa"])
@pytest.mark.parametrize("case", sorted(_SPLIT_CASES))
def test_prefill_attention_splits_match_pallas_interpret(rng, kind, case):
    """The plain version's split walk and merge against the Pallas kernel
    in interpret mode, for blocks whose keys cross 0, 1 and 3 split
    boundaries: MHA bf16, MHA int8 (codes and scales into both) and GQA
    2/1 bf16."""
    T, pos = _SPLIT_CASES[case]
    B, A, H, D = 1, 4 * SPLIT_ROWS, 2, 128
    n_kv = 1 if kind == "gqa" else 2
    (jq, tq), (jk, tk), (jv, tv) = _attn_inputs(rng, B, T, A, H, n_kv, D)
    p = np.full(B, pos, np.int32)
    if kind == "int8":
        jkq, jks = j_quantize_kv(jk)
        jvq, jvs = j_quantize_kv(jv)
        want = j_prefill_attention(jq, jkq, jvq, jnp.asarray(p), jks, jvs,
                                   interpret=True)
        tk, tv, tks, tvs = (torch.from_numpy(np.array(a))
                            for a in (jkq, jvq, jks, jvs))
        got = t_prefill_attention(tq, tk, tv, torch.from_numpy(p), tks, tvs)
    else:
        want = j_prefill_attention(jq, jk, jv, jnp.asarray(p),
                                   interpret=True)
        got = t_prefill_attention(tq, tk, tv, torch.from_numpy(p))
    np.testing.assert_allclose(_np(got), _np(want), **ATTN)


def test_prefill_split_constants_match_the_kernel():
    """The plain version splits and chunks where the kernel does: SPLIT
    and KC are compile-time constants of csrc/prefill_attention.cu."""
    import re
    from pathlib import Path

    import llama_cu_awq_torch

    src = (Path(llama_cu_awq_torch.__file__).parent / "csrc"
           / "prefill_attention.cu").read_text()
    assert re.findall(r"constexpr int SPLIT = (\d+);", src) == [
        str(SPLIT_ROWS)]
    assert re.findall(r"constexpr int KC = (\d+);", src) == [str(CHUNK)]


@pytest.mark.parametrize("quant", [False, True])
def test_prefill_attention_causal(rng, quant):
    """Keys past pos + t do not change the output: poisoning them leaves
    it bit-identical."""
    B, T, A, H, n_kv, D = 2, 16, 256, 4, 4, 128
    _, (_, k), (_, v) = _attn_inputs(rng, B, T, A, H, n_kv, D)
    q = _bf16(rng.standard_normal((B, T, H, D), dtype=np.float32))[1]
    pos = torch.tensor([40, 200], dtype=torch.int32)
    scales = (None, None)
    if quant:
        (k, ks), (v, vs) = tl.quantize_kv(k), tl.quantize_kv(v)
        scales = (ks, vs)
    base = t_prefill_attention(q, k, v, pos, *scales)
    k2, v2 = k.clone(), v.clone()
    fill = 100 if quant else 1e4
    k2[0, 40 + T:], v2[0, 40 + T:] = fill, -fill
    k2[1, 200 + T:], v2[1, 200 + T:] = fill, -fill
    got = t_prefill_attention(q, k2, v2, pos, *scales)
    assert torch.equal(base, got)


# ---------------------------------------------------------------------------
# the int4 matmuls at a 128-row block

@pytest.mark.parametrize("variant", ["qkv_prescale", "o_residual_ss",
                                     "gate_up_prescale",
                                     "down_silu_residual_ss"])
def test_int4_matmul_fused_plain_m128_matches_pallas_interpret(rng, variant):
    n_in, n_out = 512, 256
    jq, tq = _qtensors(rng, n_in, n_out, bf16_scales=True)
    jx, tx, jk, tk = _variant_args(rng, variant, 128, n_in, n_out)
    got, ss_t = int4_matmul_fused(tx, tq, **tk)
    want, ss_j = j_qmatmul_fused(jx, to_tpu_layout(jq), "pallas", **jk)
    # the int4 bar (tests/test_pallas_int4.py:68) with bf16-exact scales,
    # as tests/test_torch_ops.py holds the m=2 kernel
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-2, atol=2e-3)
    if ss_j is not None:
        np.testing.assert_allclose(_np(ss_t), _np(ss_j), rtol=2e-2)


@pytest.mark.parametrize("n_in,n_out,splits", [
    (4096, 3 * 4096, 1), (4096, 4096, 4), (4096, 2 * 11008, 1),
    (11008, 4096, 4),                       # 7B: qkv, o, gate_up, down
    (5120, 3 * 5120, 1), (5120, 5120, 3), (5120, 2 * 13824, 1),
    (13824, 5120, 3),                       # 13B
    (320, 200, 1), (2048, 384, 2), (11008, 200, 10)])
def test_gemm_splits(n_in, n_out, splits):
    """The GEMM's split rule at the 7B and 13B projections and the card
    tests' shapes: no more (column tiles x splits) than 132 SMs, at least
    8 groups a split, and no split where the tiles alone fill a wave."""
    assert gemm_splits(n_in, n_out) == splits
    tiles, groups = -(-n_out // 128), -(-n_in // 128)
    assert splits == 1 or (tiles * splits <= 132 and groups // splits >= 8)


def test_int4_matmul_plain_m128_matches_pallas_interpret(rng):
    jq, tq = _qtensors(rng, 1024, 256, bf16_scales=True)
    jx, tx = _bf16(rng.standard_normal((128, 1024), dtype=np.float32))
    got = _np(int4_matmul(tx, tq))
    want = _np(j_qmatmul(jx, to_tpu_layout(jq), "pallas"))
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-3)


# ---------------------------------------------------------------------------
# forward at T = 128

@functools.lru_cache(maxsize=None)
def _params(seed=3):
    jp = jl.params_from_checkpoint(random_checkpoint(CFG, seed=seed),
                                   param_dtype=jnp.bfloat16)
    tp = tl.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), CFG,
                              device="cpu")
    return jp, tp


@pytest.mark.parametrize("quantized", [False, True])
def test_forward_block_matches_jax(quantized):
    """Two 128-token blocks with logits_all (the second reads the first's
    cache rows), the JAX forward on its Pallas prefill kernel."""
    jp, tp = _params()
    rng = np.random.default_rng(7)
    toks = rng.integers(3, CFG.vocab_size, (2, 128)).astype(np.int32)
    jc = jl.init_kv_cache(CFG, 1, 256, quantized=quantized)
    tc = tl.init_kv_cache(CFG, 1, 256, quantized=quantized, device="cpu")
    for blk in range(2):
        pos = np.array([128 * blk], np.int32)
        jlog, jc = jl.forward(jp, CFG, jnp.asarray(toks[blk:blk + 1]),
                              jnp.asarray(pos), jc, attn_len=256,
                              fused=True, matmul_impl="dequant",
                              logits_all=True)
        tlog, tc = tl.forward(tp, CFG, torch.from_numpy(toks[blk:blk + 1]),
                              torch.from_numpy(pos), tc, attn_len=256,
                              logits_all=True)
        want, got = np.asarray(jlog), tlog.numpy()
        assert got.shape == want.shape == (1, 128, CFG.vocab_size)
        np.testing.assert_allclose(got, want, **LOGITS)
    for a, b in zip(jc.k + jc.v, tc.k + tc.v):
        # int8 codes may differ by one where a bf16 k rounds apart
        np.testing.assert_allclose(np.asarray(a, np.float32),
                                   b.float().numpy(), rtol=2e-2,
                                   atol=1.0 if quantized else 2e-2)


# ---------------------------------------------------------------------------
# the engine's block prefill

def _fused_fwd(params, tokens, pos, cache, **kw):
    return jl.forward(params, CFG, tokens, pos, cache, fused=True, **kw)


@pytest.fixture(scope="module")
def toy_tok(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tok") / "tok.bin")
    write_toy_tokenizer(path, _toy_vocab(CFG.vocab_size))
    return path


@pytest.fixture(scope="module")
def engines(toy_tok):
    """The JAX engine (fused forward) and the port's, on the same weights
    and toy tokenizer, greedy; shared so the JAX side compiles once."""
    jp, tp = _params()
    je = JEngine(jp, CFG, JTokenizer(toy_tok, CFG.vocab_size),
                 temperature=0.0, max_seq=256)
    je._fwd = _fused_fwd
    te = TEngine(tp, CFG, TTokenizer(toy_tok, CFG.vocab_size),
                 temperature=0.0, max_seq=256, device="cpu")
    return je, te


PROMPT = [1] + [3 + (37 * i) % 500 for i in range(249)]


def test_block_prefill_matches_t1_path(monkeypatch):
    """150 tokens in a full and a padded block against the same tokens one
    T=1 step each (PREFILL_BLOCK 1): the same cache rows and last logits."""
    _, tp = _params()
    out = {}
    for block in (128, 1):
        monkeypatch.setattr(t_engine_mod, "PREFILL_BLOCK", block)
        e = TEngine(tp, CFG, None, max_seq=256, device="cpu")
        last = e._prefill(PROMPT[:150])
        assert e.pos == 150 and last.shape == (CFG.vocab_size,)
        out[block] = (last, e.cache)
    (l1, c1), (l2, c2) = out[128], out[1]
    # flash attention against plain attention, which stages scores through
    # bf16: two paths that round differently
    torch.testing.assert_close(l1, l2, **LOGITS)
    for a, b in zip(c1.k + c1.v, c2.k + c2.v):
        torch.testing.assert_close(a[:, :150].float(), b[:, :150].float(),
                                   rtol=2e-2, atol=2e-2)


def test_block_prefill_matches_jax_prefill(engines):
    """From position 10 (ten tokens through the short-prompt path) a full
    block to 138, where a padded block would pass max_seq 256: the last
    112 tokens go in single steps. Then a perplexity-style pass with every
    row's logits: a full and a padded block."""
    je, te = engines
    for e in (je, te):
        e.reset()
        assert e._prefill(PROMPT[:10]) is None
    want = np.asarray(je._prefill(PROMPT[10:250]))
    got = te._prefill(PROMPT[10:250]).numpy()
    assert je.pos == te.pos == 250
    np.testing.assert_allclose(got, want, **LOGITS)
    for a, b in zip(je.cache.k + je.cache.v, te.cache.k + te.cache.v):
        np.testing.assert_allclose(np.asarray(a, np.float32)[:, :250],
                                   b.float().numpy()[:, :250], rtol=2e-2,
                                   atol=2e-2)
    for e in (je, te):
        e.reset()
    want = je._prefill(PROMPT[:150], collect_logits=True)
    got = te._prefill(PROMPT[:150], collect_logits=True)
    assert got.shape == want.shape == (150, CFG.vocab_size)
    assert got.device.type == "cpu" and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **LOGITS)


def test_generate_long_prompt_matches_jax(engines):
    """A prompt of more than 64 tokens takes block prefill in both engines;
    the greedy streams, printed text and coin accounting are identical."""
    je, te = engines
    text = "the cat sat on the mat " * 12
    prompt = je.tokenizer.encode(text, bos=True, eos=False)
    assert len(prompt) >= 64
    assert te.tokenizer.encode(text, bos=True, eos=False) == prompt
    jt, js = je.generate(text, steps=len(prompt) + 40)
    tt, ts = te.generate(text, steps=len(prompt) + 40)
    assert tt == jt
    assert ts["generated"] == js["generated"] and ts["tokens"] == js["tokens"]
    assert te.rng.state == je.rng.state


def test_perplexity_matches_jax(engines):
    """sequence_perplexity with truncation at seq_len - 1, and
    dataset_perplexity's split and geometric mean."""
    je, te = engines
    long_text = "the cat sat on the mat " * 60
    assert len(te.tokenizer.encode(long_text, bos=False, eos=False)) > 256
    for text in ("the cat sat on a mat", long_text):
        want = j_ppl.sequence_perplexity(je, text)
        got = t_ppl.sequence_perplexity(te, text)
        # the f64 mean of log p over rows whose logits agree to 2e-2
        assert got == pytest.approx(want, rel=2e-3)
    dataset = "the cat<|endoftext|>sat on mat<|endoftext|>"
    jg, jn, jv = j_ppl.dataset_perplexity(je, dataset)
    tg, tn, tv = t_ppl.dataset_perplexity(te, dataset)
    assert tn == jn == 2
    np.testing.assert_allclose(tv, jv, rtol=2e-3)
    assert tg == pytest.approx(float(np.exp(np.mean(np.log(tv)))))


def test_token_perplexity_needs_no_tokenizer():
    """token_perplexity runs on token ids alone (the card's synthetic
    run), and an empty sequence is NaN."""
    _, tp = _params()
    e = TEngine(tp, CFG, None, max_seq=256, device="cpu")
    ppl = t_ppl.token_perplexity(e, PROMPT[1:80])
    assert np.isfinite(ppl) and ppl > 1
    assert np.isnan(t_ppl.token_perplexity(e, []))


def test_perplexity_past_max_seq_scores_the_truncation():
    """A sequence longer than the engine's max_seq (below seq_len) scores
    as its truncation to max_seq - 1 tokens, where the engine's _prefill
    would raise on the whole sequence."""
    _, tp = _params()
    e = TEngine(tp, CFG, None, max_seq=128, device="cpu")
    ids = PROMPT[1:200]
    assert 128 < len(ids) < CFG.seq_len
    got = t_ppl.token_perplexity(e, ids, verbose=True)
    want = t_ppl.token_perplexity(e, ids[:127])
    assert np.isfinite(got) and got == want
    assert e.pos == 127


def test_prefill_runs_the_head_once_a_prompt(monkeypatch):
    """A prompt of 3 full blocks and a 10-token tail computes the lm_head
    once, on its last (padded) block, as the JAX engine's scan skips it on
    the earlier blocks; perplexity (collect_logits) computes it on every
    block. The last logits are the same bits either way."""
    cfg = TModelConfig(dim=64, hidden_dim=96, n_layers=1, n_heads=2,
                       n_kv_heads=2, vocab_size=256, seq_len=512)
    tp = tl.params_from_checkpoint(t_random(cfg, seed=5), device="cpu")
    heads = []
    real = tl.final_logits

    def counting(params, x, *args, **kw):
        heads.append(x.shape[1])
        return real(params, x, *args, **kw)

    monkeypatch.setattr(tl, "final_logits", counting)
    toks = [1] + [3 + (7 * i) % 250 for i in range(3 * 128 + 9)]
    e = TEngine(tp, cfg, None, max_seq=512, device="cpu")
    last = e._prefill(toks)
    assert e.pos == len(toks) and heads == [128]
    e.reset()
    heads.clear()
    rows = e._prefill(toks, collect_logits=True)
    assert heads == [128] * 4 and rows.shape == (len(toks), 256)
    assert torch.equal(rows[-1], last)
    e.reset()
    heads.clear()
    assert np.isfinite(t_ppl.token_perplexity(e, toks[1:]))
    assert heads == [128] * 4
