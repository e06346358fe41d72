"""--act-dtype float16 / float32 in the port, held to the JAX package on
the CPU, every test for both types.

The same inputs, made with numpy from a seed, go through the JAX function
and the port's. Oracles:
  - the kernels: the JAX Pallas kernels in interpret mode (the int4 one
    with bf16-exact scales, which its bf16 metadata then holds exactly,
    as tests/test_torch_ops.py does);
  - the model and the engines: the JAX forward with fused=True on the
    dequant matmuls, whose qmatmul_fused is given the Pallas wrapper's
    casts of x and u to bf16 (ops/pallas/int4_matmul.py:656-661; `_staged`
    below): the numerics of the JAX kernel path, which the port's kernels
    and plain versions follow. Under bf16 the casts change nothing. (The
    composite alone rounds x * ss * norm_w once, the kernel path rounds x
    to bf16 first.) Nothing in the JAX package changes.
Tolerances, stated where they apply: the int4 bar of
tests/test_pallas_int4.py:68 (rtol 2e-2, atol 2e-3) against the Pallas
kernels; the JAX package's bar for two differently rounded paths
(tests/test_fused_path.py:51-52, 2e-2) for logits through the attention
kernels, which walk their windows in other blocks; token streams equal.
"""

import functools
import io
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cu_awq_torch.cli import main as t_main
from llama_cu_awq_torch.engine import BatchEngine as TBatchEngine
from llama_cu_awq_torch.engine import InferenceEngine as TEngine
from llama_cu_awq_torch.engine import perplexity as t_ppl
from llama_cu_awq_torch.io.checkpoint import load_checkpoint as t_load
from llama_cu_awq_torch.models import llama as tl
from llama_cu_awq_torch.ops.cuda.attention_step import (
    attention_step as t_attention_step)
from llama_cu_awq_torch.ops.cuda.batched_attention import (
    batched_decode_attention as t_batched)
from llama_cu_awq_torch.ops.cuda.down_qkv import down_qkv_fused as t_dq
from llama_cu_awq_torch.ops.cuda.prefill_attention import (
    prefill_attention as t_prefill)
from llama_cu_awq_torch.ops.linear import qmatmul_fused as t_qmatmul_fused
from llama_cu_awq_torch.quant.kv import quantize_kv as t_quantize_kv
from llama_cu_awq_torch.quant.kv import quantize_kv4 as t_quantize_kv4
from llama_cu_awq_torch.quant.qtensor import QTensor as TQ
from llama_cu_awq_tpu.config import ModelConfig
from llama_cu_awq_tpu.engine import engine as j_engine_mod
from llama_cu_awq_tpu.engine import perplexity as j_ppl
from llama_cu_awq_tpu.engine.batch import BatchEngine as JBatchEngine
from llama_cu_awq_tpu.engine.engine import InferenceEngine as JEngine
from llama_cu_awq_tpu.io.checkpoint import random_checkpoint
from llama_cu_awq_tpu.models import llama as jl
from llama_cu_awq_tpu.ops.pallas import attention_step as j_as
from llama_cu_awq_tpu.ops.pallas import batched_attention as j_ba
from llama_cu_awq_tpu.ops.pallas import down_qkv as j_dq
from llama_cu_awq_tpu.ops.pallas import prefill_attention as j_pf
from llama_cu_awq_tpu.ops.pallas.int4_matmul import (int4_matmul_fused as
                                                     j_int4_matmul_fused)
from llama_cu_awq_tpu.quant import packing
from llama_cu_awq_tpu.quant.qtensor import QTensor as JQ
from llama_cu_awq_tpu.quant.qtensor import to_tpu_layout
from tests.test_torch_engine import _write_model

# one intra-op thread per process: the suite runs in several worker
# processes, and torch's default pool in each oversubscribes the cores
torch.set_num_threads(1)

ACTS = [(jnp.float16, torch.float16), (jnp.float32, torch.float32)]
ACT_IDS = ["float16", "float32"]
INT4_BAR = dict(rtol=2e-2, atol=2e-3)
PATHS_BAR = dict(rtol=2e-2, atol=2e-2)


def _pair(a, jdt, tdt):
    """numpy f32 -> (jax array, torch tensor) of the same values in the
    given types (rounded once, by JAX)."""
    j = jnp.asarray(a, jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _staged(orig):
    """The JAX qmatmul_fused with the Pallas wrapper's casts of x and u to
    bf16 before it (ops/pallas/int4_matmul.py:656-661)."""
    def fn(x, qt, impl=None, *, silu_u=None, **kw):
        if silu_u is not None:
            silu_u = silu_u.astype(jnp.bfloat16)
        return orig(x.astype(jnp.bfloat16), qt, impl, silu_u=silu_u, **kw)
    return fn


@pytest.fixture
def jax_kernel_path(monkeypatch):
    """The JAX forward and engines on the kernel path's numerics: fused
    staging, the Pallas wrapper's casts (see the module docstring)."""
    monkeypatch.setattr(jl, "qmatmul_fused", _staged(jl.qmatmul_fused))
    monkeypatch.setattr(j_engine_mod, "forward",
                        functools.partial(jl.forward, fused=True))


# ---------------------------------------------------------------------------
# each kernel's plain version against the JAX kernel


def _qtensors(rng, n, d):
    """One quantized weight for both packages, its fp16 scales rounded to
    bf16 values (the JAX kernel's bf16 metadata holds them exactly)."""
    w = rng.standard_normal((n, d), dtype=np.float32) * 0.1
    qw, zeros, scales = packing.quantize_np(w)
    scales = np.asarray(jnp.asarray(scales, jnp.bfloat16), np.float32)
    j = JQ(jnp.asarray(qw), jnp.asarray(zeros), jnp.asarray(scales), n, d)
    return to_tpu_layout(j), TQ.from_numpy(qw, zeros, scales, n)


@pytest.mark.parametrize("jdt,tdt", ACTS, ids=ACT_IDS)
@pytest.mark.parametrize("variant", ["plain", "qkv_prescale",
                                     "o_residual_ss", "gate_up_prescale",
                                     "down_silu_residual_ss"])
def test_int4_fused_plain_matches_pallas(rng, jdt, tdt, variant):
    """Every prologue and epilogue of int4_matmul_fused with x, u and the
    residual in the activation type and the output stored in it; n_out
    256, which the TPU layout leaves unpadded, as its epilogues need. The
    int4 bar."""
    n_in, n_out, m = 512, 256, 3
    jq, tq = _qtensors(rng, n_in, n_out)
    jx, tx = _pair(rng.standard_normal((m, n_in)), jdt, tdt)
    jk, tk = {}, {}
    if variant.endswith("prescale"):
        ss = (0.5 + rng.random((m, 1))).astype(np.float32)
        nw = (0.5 + rng.random(n_in)).astype(np.float32)
        jk["prescale"] = (jnp.asarray(ss), jnp.asarray(nw))
        tk["prescale"] = (torch.from_numpy(ss), torch.from_numpy(nw))
    elif variant != "plain":
        jk["residual"], tk["residual"] = _pair(
            rng.standard_normal((m, n_out)) * 4, jdt, tdt)
        jk["emit_ss_eps"] = tk["emit_ss_eps"] = 1e-5
        if "silu" in variant:
            jk["silu_u"], tk["silu_u"] = _pair(
                rng.standard_normal((m, n_in)), jdt, tdt)
    got, ss_t = t_qmatmul_fused(tx, tq, out_dtype=tdt, **tk)
    want, ss_j = j_int4_matmul_fused(jx, jq, interpret=True, out_dtype=jdt,
                                     **jk)
    assert got.dtype == tdt and want.dtype == jdt
    np.testing.assert_allclose(_np(got), _np(want), **INT4_BAR)
    if ss_j is not None:
        np.testing.assert_allclose(_np(ss_t), _np(ss_j), rtol=2e-2)


def _caches(rng, fmt, B, A, n_kv, D, jdt, tdt):
    """(jax (k, v, ks, vs), torch (k, v, ks, vs)) of one cache format: the
    activation type, int8 codes, or int4 codes packed in halves."""
    if fmt == "act":
        k = _pair(rng.standard_normal((B, A, n_kv, D)), jdt, tdt)
        v = _pair(rng.standard_normal((B, A, n_kv, D)), jdt, tdt)
        return (k[0], v[0], None, None), (k[1], v[1], None, None)
    width, lo = (D // 2, -128) if fmt == "int4" else (D, -127)
    smax = 0.2 if fmt == "int4" else 0.02
    k, v = (rng.integers(lo, 128, (B, A, n_kv, width)).astype(np.int8)
            for _ in range(2))
    ks, vs = (rng.uniform(smax / 4, smax, (B, A, n_kv)).astype(np.float32)
              for _ in range(2))
    return (tuple(jnp.asarray(a) for a in (k, v, ks, vs)),
            tuple(torch.from_numpy(a) for a in (k, v, ks, vs)))


@pytest.mark.parametrize("jdt,tdt", ACTS, ids=ACT_IDS)
@pytest.mark.parametrize("fmt", ["act", "int8", "int4"])
def test_attention_step_plain_matches_pallas(rng, jdt, tdt, fmt):
    """attention_step (and _attention_step_kv4 for the int4 cache) over an
    fp16 or f32 qkv row and cache: the attention within the int4 bar (the
    JAX kernel walks its window in one block, the port in splits, so p
    rounds to bf16 against another max), the new cache rows and scales
    bit-equal with the JAX rope rows (XLA's astype: the bf16-rounded k
    widened to the cache's type)."""
    B, A, H, n_kv, D = 3, 256, 4, 2, 128
    kv_bits = 4 if fmt == "int4" else 8
    jqkv, tqkv = _pair(rng.standard_normal((B, (H + 2 * n_kv) * D)), jdt,
                       tdt)
    pos = np.array([5, A - 3, 130], np.int32)
    jc, tc = _caches(rng, fmt, B, A, n_kv, D, jdt, tdt)
    cj, sj = j_as.rope_rows(jnp.asarray(pos), D, 10000.0)
    want = j_as.attention_step(jqkv, jc[0], jc[1], jnp.asarray(pos), cj, sj,
                               jc[2], jc[3], n_heads=H, kv_bits=kv_bits,
                               interpret=True)
    got = t_attention_step(tqkv, tc[0], tc[1], torch.from_numpy(pos),
                           torch.from_numpy(np.array(cj)),
                           torch.from_numpy(np.array(sj)), tc[2], tc[3],
                           n_heads=H, kv_bits=kv_bits)
    np.testing.assert_allclose(_np(got[0]), _np(want[0]), **INT4_BAR)
    for i in range(1, 3 if fmt == "act" else 5):
        g, w = got[i], np.asarray(want[i])
        if fmt == "act":
            assert g.dtype == tdt and w.dtype == jdt
        np.testing.assert_array_equal(_np(g), w.astype(np.float32))


@pytest.mark.parametrize("jdt,tdt", ACTS, ids=ACT_IDS)
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("early_exit", [True, False])
def test_batched_plain_matches_pallas(rng, jdt, tdt, quantized, early_exit):
    """batched_decode_attention with an fp16 or f32 q over a cache of its
    type, or int8: slots at position 0, mid-window and the window's last
    row (attn_len 256 of a 384-row cache). The int4 bar."""
    B, A, H, n_kv, D = 3, 384, 4, 2, 128
    pos = np.array([0, 131, 255], np.int32)
    jq, tq = _pair(rng.standard_normal((B, H, D)), jdt, tdt)
    jc, tc = _caches(rng, "int8" if quantized else "act", B, A, n_kv, D, jdt,
                     tdt)
    want = j_ba.batched_decode_attention(
        jq, jc[0], jc[1], jnp.asarray(pos), jc[2], jc[3], interpret=True,
        early_exit=early_exit, attn_len=256)
    got = t_batched(tq, tc[0], tc[1], torch.from_numpy(pos), tc[2], tc[3],
                    attn_len=256, early_exit=early_exit)
    np.testing.assert_allclose(_np(got), _np(want), **INT4_BAR)


@pytest.mark.parametrize("jdt,tdt", ACTS, ids=ACT_IDS)
@pytest.mark.parametrize("quantized", [False, True])
def test_prefill_plain_matches_pallas(rng, jdt, tdt, quantized):
    """prefill_attention of a 128-token block at positions 0 and 200 over
    a 512-row cache of the activation type, or int8 (q in the activation
    type: both wrappers cast it to bf16). The int4 bar."""
    B, T, A, H, n_kv, D = 2, 128, 512, 4, 2, 128
    pos = np.array([0, 200], np.int32)
    jq, tq = _pair(rng.standard_normal((B, T, H, D)), jdt, tdt)
    jc, tc = _caches(rng, "int8" if quantized else "act", B, A, n_kv, D, jdt,
                     tdt)
    want = j_pf.prefill_attention(jq, jc[0], jc[1], jnp.asarray(pos), jc[2],
                                  jc[3], attn_len=A, interpret=True)
    got = t_prefill(tq, tc[0], tc[1], torch.from_numpy(pos), tc[2], tc[3],
                    attn_len=A)
    np.testing.assert_allclose(_np(got), _np(want), **INT4_BAR)


@pytest.mark.parametrize("jdt,tdt", ACTS, ids=ACT_IDS)
def test_down_qkv_plain_matches_pallas(rng, jdt, tdt):
    """down_qkv with the activation type as out_dtype: x2 stored in it, the
    residual rounded to bf16 and stage Q reading x2 as stored, as the JAX
    kernel does; qkv in f32, as the JAX function returns it. The int4
    bar (x2 also one stored ulp, after sums in another order)."""
    m, dim, hid, n_q = 3, 256, 384, 512
    jd, td = _qtensors(rng, hid, dim)
    jqk, tqk = _qtensors(rng, dim, n_q)
    jg, tg = _pair(rng.standard_normal((m, hid)), jdt, tdt)
    ju, tu = _pair(rng.standard_normal((m, hid)), jdt, tdt)
    jr, tr = _pair(rng.standard_normal((m, dim)) * 4, jdt, tdt)
    nw = (0.5 + rng.random(dim)).astype(np.float32)
    want = j_dq.down_qkv_fused(jg, ju, jr, jd, jqk, jnp.asarray(nw),
                               eps=1e-5, out_dtype=jdt, interpret=True)
    got = t_dq(tg, tu, tr, td, tqk, torch.from_numpy(nw), eps=1e-5,
               out_dtype=torch.float32, x2_dtype=tdt)
    assert got[0].dtype == tdt and want[0].dtype == jdt
    rtol = 2 ** -7 if tdt == torch.float16 else 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=2e-2 + rtol,
                                   atol=2e-3)


@pytest.mark.parametrize("jdt,tdt", ACTS, ids=ACT_IDS)
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_kv_from_act_bit_equal(rng, jdt, tdt, bits):
    """The int8 and int4 rows quantized from fp16 or f32 values: the jitted
    JAX functions (where XLA turns absmax/127 and absmax/7 into products,
    the port's rule) give the same codes and scales."""
    jx, tx = _pair(rng.standard_normal((2, 3, 4, 16)) * 3, jdt, tdt)
    jfn = jax.jit(jl.quantize_kv4 if bits == 4 else jl.quantize_kv)
    tfn = t_quantize_kv4 if bits == 4 else t_quantize_kv
    (jq, js), (tq, ts) = jfn(jx), tfn(tx)
    np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())


# ---------------------------------------------------------------------------
# the model

# head_dim 128 and a 256-row cache: the JAX forward's kernels (fused_step,
# batched, prefill_attention, the int4 cache's fused_step) take these
# shapes in interpret mode, and so do the port's
CFG = ModelConfig(dim=256, hidden_dim=384, n_layers=2, n_heads=2,
                  n_kv_heads=2, vocab_size=256, seq_len=256)


def _params(cfg, jdt, tdt, seed=3):
    """The JAX CLI's params for the activation type (cli.py:131): float16
    keeps the checkpoint's fp16 embed and head (None), float32 stores f32;
    carried to the port bit for bit."""
    ckpt = random_checkpoint(cfg, seed=seed)
    jp = jl.params_from_checkpoint(
        ckpt, param_dtype=None if jdt == jnp.float16 else jdt)
    tp = tl.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg,
                              device="cpu")
    return jp, tp


@pytest.mark.parametrize("jdt,tdt", ACTS, ids=ACT_IDS)
@pytest.mark.parametrize("attn_impl,cache", [
    ("einsum", "act"), ("einsum", "int8"), ("einsum", "int4"),
    ("fused_step", "act"), ("fused_step", "int8"), ("fused_step", "int4"),
    ("batched", "act"), ("batched", "int8")])
def test_forward_matches_jax(jdt, tdt, attn_impl, cache, jax_kernel_path):
    """A 128-token block at position 0 (every row's logits; the
    prefill_attention kernel in both packages, plain attention over the
    int4 cache and under einsum), then 3 decode steps through attn_impl,
    over a cache of the activation type, int8 or int4. (batched over the
    int4 cache raises in the port; the JAX package warns and runs einsum.)
    The logits within the bar for two differently rounded paths, the same
    argmax on every row whose top-2 gap is wider than it."""
    jp, tp = _params(CFG, jdt, tdt)
    quantized, kv_bits = cache != "act", 4 if cache == "int4" else 8
    jc = jl.init_kv_cache(CFG, 1, 256, dtype=jdt, quantized=quantized,
                          kv_bits=kv_bits)
    tc = tl.init_kv_cache(CFG, 1, 256, dtype=tdt, quantized=quantized,
                          kv_bits=kv_bits, device="cpu")
    block = np.array([[1 + (37 * i) % 250 for i in range(128)]], np.int32)
    steps = [(block, 0, None, True)] + [
        (np.array([[t]], np.int32), 128 + i, attn_impl, False)
        for i, t in enumerate((7, 42, 3))]
    for toks, pos, impl, every in steps:
        # jitted, as the JAX engine runs it (XLA's absmax * f32(1/7) and
        # f32(1/127) for the cache scales exist only under a jit)
        fwd = jax.jit(functools.partial(
            jl.forward, cfg=CFG, fused=True, matmul_impl="dequant",
            act_dtype=jdt, attn_impl=impl, logits_all=every))
        want, jc = fwd(jp, tokens=jnp.asarray(toks),
                       pos=jnp.asarray([pos], jnp.int32), cache=jc)
        got, tc = tl.forward(tp, CFG, torch.from_numpy(toks),
                             torch.tensor([pos], dtype=torch.int32), tc,
                             act_dtype=tdt, attn_impl=impl, logits_all=every)
        g = _np(got).reshape(-1, CFG.vocab_size)
        w = _np(want).reshape(-1, CFG.vocab_size)
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, **PATHS_BAR)
        top2 = np.sort(w, axis=-1)[:, -2:]
        decided = top2[:, 1] - top2[:, 0] > 4e-2
        assert (g.argmax(-1) == w.argmax(-1))[decided].all()
    assert tc.k[0].dtype == (torch.int8 if quantized else tdt)


@pytest.mark.parametrize("jdt,tdt", ACTS, ids=ACT_IDS)
def test_params_from_checkpoint_keeps_fp16_bits(jdt, tdt):
    """param_dtype=None keeps the checkpoint's fp16 embed and head bit for
    bit, as the JAX function does; f32 widens them exactly; norms are f32
    either way."""
    ckpt = random_checkpoint(CFG, seed=3)
    pd_t = None if tdt == torch.float16 else tdt
    tp = tl.params_from_checkpoint(ckpt, device="cpu", param_dtype=pd_t)
    jp = jl.params_from_checkpoint(
        ckpt, param_dtype=None if jdt == jnp.float16 else jdt)
    assert tp.embed.dtype == tdt and tp.lm_head.dtype == tdt
    assert tp.final_norm.dtype == torch.float32
    assert tp.layers[0].attn_norm.dtype == torch.float32
    for t, j, raw in ((tp.embed, jp.embed, ckpt.embed),
                      (tp.lm_head, jp.lm_head, ckpt.lm_head)):
        np.testing.assert_array_equal(t.float().numpy(),
                                      raw.astype(np.float32))
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    if tdt == torch.float16:
        np.testing.assert_array_equal(tp.embed.numpy().view(np.uint16),
                                      ckpt.embed.view(np.uint16))


# ---------------------------------------------------------------------------
# the engines, perplexity and the CLI

# head_dim 16: plain attention throughout in both packages
SMALL = ModelConfig(dim=64, hidden_dim=160, n_layers=2, n_heads=4,
                    n_kv_heads=2, vocab_size=256, seq_len=128)
PROMPT = [1, 5, 9, 13, 7, 5, 9, 13]


@pytest.mark.parametrize("jdt,tdt", ACTS, ids=ACT_IDS)
@pytest.mark.parametrize("spec", [None, "ngram"])
def test_greedy_streams_match_jax_engine(jdt, tdt, spec, jax_kernel_path):
    """InferenceEngine with act_dtype, plain and speculative: the same
    greedy stream and spec counters as the JAX engine's, and the spec
    stream equals the plain one; the cache is in the activation type."""
    jp, tp = _params(SMALL, jdt, tdt, seed=4)
    kw = dict(temperature=0.0, max_seq=128, chunk_size=8, spec=spec,
              spec_k=4)
    te = TEngine(tp, SMALL, None, device="cpu", act_dtype=tdt, **kw)
    je = JEngine(jp, SMALL, None, act_dtype=jdt, **kw)
    got, _, _ = te.generate_benchmark(PROMPT, 60)
    want, _, _ = je.generate_benchmark(PROMPT, 60)
    assert got == want and len(got) == 60 - len(PROMPT) + 1
    assert te.cache.k[0].dtype == tdt
    if spec:
        assert te.spec_stats == je.spec_stats
        assert te.spec_stats["verifies"] > 0
        plain = TEngine(tp, SMALL, None, device="cpu", act_dtype=tdt,
                        **{**kw, "spec": None})
        assert plain.generate_benchmark(PROMPT, 60)[0] == got


@pytest.mark.parametrize("jdt,tdt", ACTS, ids=ACT_IDS)
@pytest.mark.parametrize("spec", [None, "ngram"])
def test_batch_engine_streams_match_jax(jdt, tdt, spec, jax_kernel_path):
    """BatchEngine with act_dtype over 3 slots: 5 greedy requests (one
    over FORCED_PROMPT_MAX, prefilled in a block on its slot), with and
    without speculative blocks; the same streams and finished counts as
    the JAX BatchEngine's."""
    jp, tp = _params(SMALL, jdt, tdt, seed=7)
    prompts = [[1, 5, 9, 100], [1, 42], [1] + [(17 * i) % 200
                                               for i in range(60)],
               [1, 5, 9, 13, 5, 9, 13, 5, 9], [1, 250]]
    kw = dict(n_slots=3, max_seq=128, chunk_size=4, spec=spec, spec_k=4)
    out = []
    for be in (JBatchEngine(jp, SMALL, act_dtype=jdt, **kw),
               TBatchEngine(tp, SMALL, device="cpu", act_dtype=tdt, **kw)):
        rids = [be.submit(p, max_new=12) for p in prompts]
        res = be.run()
        out.append(([res[r] for r in rids], be.stats()["finished"]))
    assert out[0] == out[1]
    assert all(len(s) == 12 for s in out[1][0])


@pytest.mark.parametrize("jdt,tdt", ACTS, ids=ACT_IDS)
def test_perplexity_matches_jax(jdt, tdt, jax_kernel_path, tmp_path):
    """token_perplexity of 200 ids (BOS and 199 of them: a 128-token block
    through prefill_attention, then a partial one) against the JAX
    engine's sequence_perplexity on the same ids; the f64 mean of log p
    over rows whose logits agree to 2e-2."""
    jp, tp = _params(CFG, jdt, tdt, seed=9)
    ids = [3 + (29 * i) % 250 for i in range(200)]

    class Ids:
        """A tokenizer whose text is the id list itself."""

        def encode(self, text, bos=True, eos=False):
            return list(ids)

    je = JEngine(jp, CFG, Ids(), act_dtype=jdt, max_seq=256,
                 temperature=0.0)
    want = j_ppl.sequence_perplexity(je, "ids")
    te = TEngine(tp, CFG, None, device="cpu", act_dtype=tdt, max_seq=256,
                 temperature=0.0)
    got = t_ppl.token_perplexity(te, ids)
    assert np.isfinite(got) and got == pytest.approx(want, rel=2e-3)


@pytest.mark.parametrize("act", ["float16", "float32"])
@pytest.mark.parametrize("mode", ["generate", "perplexity"])
def test_cli_act_dtype_matches_jax_cli(tmp_path, capsys, monkeypatch, act,
                                       mode, jax_kernel_path):
    """python -m llama_cu_awq_torch model.bin --act-dtype ... --device cpu
    against the JAX CLI with the same flags (its engine on the kernel
    path's numerics): the same generated text, or the same sequence count
    and a perplexity that agrees to f32 sum order."""
    from llama_cu_awq_tpu.cli import main as j_main

    path, tok_path = _write_model(tmp_path, SMALL, seed=5)
    args = [path, "-m", mode, "-z", tok_path, "-t", "0", "-s", "3",
            "--act-dtype", act]
    if mode == "perplexity":
        data = tmp_path / "data.txt"
        data.write_text("the cat sat on the mat<|endoftext|>"
                        + "the cat sat " * 30)
        args += ["-q", str(data)]
    else:
        args += ["-n", "40", "-i", "the cat sat on the mat"]

    def lines():
        out = capsys.readouterr().out
        return [ln for ln in out.splitlines() if "tok/s" not in ln]

    assert t_main([*args, "--device", "cpu"]) == 0
    got = lines()
    assert j_main(args) == 0
    want = lines()
    if mode == "perplexity":
        (t_line,) = [ln for ln in got if ln.startswith("Geomean")]
        (j_line,) = [ln for ln in want if ln.startswith("Geomean")]
        assert t_line.rsplit(" ", 1)[0] == j_line.rsplit(" ", 1)[0]
        assert float(t_line.rsplit(" ", 1)[1]) == pytest.approx(
            float(j_line.rsplit(" ", 1)[1]), rel=1e-3)
        return
    assert got == want
    ckpt = t_load(path)
    assert ckpt.config.vocab_size == SMALL.vocab_size


def test_cli_chat_act_dtype_on_cpu(tmp_path, capsys, monkeypatch):
    """--act-dtype float16 in chat mode answers a turn."""
    path, tok_path = _write_model(tmp_path, SMALL, seed=5)
    monkeypatch.setattr(sys, "stdin", io.StringIO(""))  # one turn
    assert t_main([path, "-m", "chat", "-i", "the cat", "-y", "be brief",
                   "-t", "0", "-z", tok_path, "--act-dtype", "float16",
                   "--device", "cpu"]) == 0
    reply = capsys.readouterr().out.split("Assistant: ", 1)[1]
    assert reply.split("\nUser: ")[0].strip()
