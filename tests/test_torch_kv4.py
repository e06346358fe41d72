"""The int4 KV cache in the port, held to the JAX package on the CPU.

Inputs are made from a seed with numpy and handed to both packages. The
JAX attention_step runs its Pallas kernel (_attention_step_kv4) in
interpret mode; the JAX forward runs jitted, as the JAX engine runs it,
so its int4 scales are absmax * f32(1/7) (XLA's form of absmax/7 inside a
jit, which the port follows) and its codes match the port's bit for bit
where the rotated k rounds alike. The JAX engine is driven with its
forward bound to fused=True (the fused staging the port runs), as
tests/test_torch_engine.py's replay does.

Tolerances: the JAX kernel walks its window in one block, the port in
chunks of 64, so p rounds to bf16 against another running max and the two
agree to bf16 rounding of p (rtol 2e-2, atol 2e-3, the attention_step bar
of tests/test_torch_ops.py); logits of two paths that round differently
are held to the JAX package's bar of tests/test_fused_path.py:51-52 (rtol
and atol 2e-2); codes are within one step of each other where a bf16 k
may round one ulp apart; greedy streams must be identical.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cu_awq_torch.engine import InferenceEngine as TEngine
from llama_cu_awq_torch.models import llama as tl
from llama_cu_awq_torch.ops.cuda.attention_step import (
    attention_step as t_attention_step)
from llama_cu_awq_torch.ops.cuda.attention_step import rope_rows as t_rope_rows
from llama_cu_awq_torch.quant import kv as tkv
from llama_cu_awq_tpu.config import ModelConfig
from llama_cu_awq_tpu.engine.engine import InferenceEngine as JEngine
from llama_cu_awq_tpu.io.checkpoint import random_checkpoint
from llama_cu_awq_tpu.models import llama as jl
from llama_cu_awq_tpu.ops.pallas.attention_step import (
    attention_step as j_attention_step)
from llama_cu_awq_tpu.ops.pallas.attention_step import rope_rows as j_rope_rows
from tests.test_torch_ops import _bf16, _np

# one intra-op thread per process: the suite runs in several worker
# processes, and torch's default pool in each oversubscribes the cores
# (tens of times slower on small tensors); it also fixes the CPU sum order
torch.set_num_threads(1)

# head_dim 128 and an even number of kv heads: the JAX fused_step takes
# the int4 cache (models/llama.py:576-582); GQA 4/2
CFG = ModelConfig(dim=512, hidden_dim=384, n_layers=2, n_heads=4,
                  n_kv_heads=2, vocab_size=512, seq_len=256)
ATTN = dict(rtol=2e-2, atol=2e-3)
LOGITS = dict(rtol=2e-2, atol=2e-2)


def _planes(codes):
    """Packed codes of either package -> (lo, hi) int32 planes."""
    c = torch.from_numpy(np.array(codes)) if not isinstance(
        codes, torch.Tensor) else codes
    return [p.numpy() for p in tkv.kv4_planes(c)]


def _codes_within_one(a, b):
    for pa, pb in zip(_planes(a), _planes(b)):
        assert np.abs(pa - pb).max() <= 1


# ---------------------------------------------------------------------------
# the format

@pytest.mark.parametrize("shape", [(2, 3, 4, 16), (1, 64, 2, 128)])
def test_quantize_kv4_bit_equal_to_jitted_jax(rng, shape):
    """Codes and scales bit-equal to the JAX quantize_kv4 under jit (the
    form every JAX path that writes the cache runs in)."""
    jx, tx = _bf16(rng.standard_normal(shape, dtype=np.float32) * 2.0)
    jq, js = jax.jit(jl.quantize_kv4)(jx)
    tq, ts = tkv.quantize_kv4(tx)
    assert tq.dtype == torch.int8 and tq.shape == shape[:-1] + (
        shape[-1] // 2,)
    assert np.array_equal(np.asarray(jq), tq.numpy())
    assert np.array_equal(np.asarray(js), ts.numpy())


def test_dequant_kv4_round_trip(rng):
    """The bound of tests/test_kv_quant.py:96-114, and dequant_kv4 and the
    split halves equal to the JAX functions on the same codes."""
    x = torch.from_numpy(rng.standard_normal((2, 5, 4, 64)).astype(
        np.float32) * 3.0)
    q, s = tkv.quantize_kv4(x)
    deq = tkv.dequant_kv4(q, s, torch.float32)
    assert deq.shape == x.shape
    # symmetric int4: |x - q*s| <= s/2
    assert bool(((x - deq).abs() < s[..., None] * (0.5 + 1e-5)).all())
    codes = rng.integers(-7, 8, size=(1, 3, 2, 16)).astype(np.float32)
    xr = torch.from_numpy(codes * 0.125)
    deq2 = tkv.dequant_kv4(*tkv.quantize_kv4(xr), torch.float32)
    torch.testing.assert_close(deq2, xr, rtol=1e-6, atol=1e-6)
    # every byte, against the JAX unpack
    allb = np.arange(-128, 128, dtype=np.int8).reshape(1, 8, 32)
    sc = rng.uniform(0.05, 0.2, (1, 8)).astype(np.float32)
    for dtype, jdt in ((torch.float32, jnp.float32),
                       (torch.bfloat16, jnp.bfloat16)):
        want = jl.dequant_kv4(jnp.asarray(allb), jnp.asarray(sc), jdt)
        got = tkv.dequant_kv4(torch.from_numpy(allb), torch.from_numpy(sc),
                              dtype)
        assert np.array_equal(_np(got), _np(want))


def test_init_kv_cache_kv4():
    c = tl.init_kv_cache(CFG, 2, 32, quantized=True, kv_bits=4, device="cpu")
    assert c.k[0].shape == (2, 32, CFG.n_kv_heads, CFG.head_dim // 2)
    assert c.k[0].dtype == torch.int8 and c.k_scale[0].shape == (2, 32, 2)
    with pytest.raises(ValueError, match="kv_bits"):
        tl.init_kv_cache(CFG, 1, 32, quantized=True, kv_bits=3, device="cpu")


# ---------------------------------------------------------------------------
# attention_step with kv_bits=4

def _kv4_inputs(rng, B, A, H, n_kv, D):
    qkv = rng.standard_normal((B, (H + 2 * n_kv) * D), dtype=np.float32)
    k4 = rng.integers(-128, 128, (B, A, n_kv, D // 2)).astype(np.int8)
    v4 = rng.integers(-128, 128, (B, A, n_kv, D // 2)).astype(np.int8)
    ks = rng.uniform(0.05, 0.2, (B, A, n_kv)).astype(np.float32)
    vs = rng.uniform(0.05, 0.2, (B, A, n_kv)).astype(np.float32)
    return _bf16(qkv), [(jnp.asarray(a), torch.from_numpy(a))
                        for a in (k4, v4, ks, vs)]


@pytest.mark.parametrize("H,n_kv", [(4, 4), (8, 4), (8, 2)])
@pytest.mark.parametrize("positions", [(0, 5, 255), (130, 64, 1)])
def test_attention_step_kv4_plain_matches_pallas_interpret(rng, H, n_kv,
                                                           positions):
    B, A, D = 3, 256, 128
    (jqkv, tqkv), arrs = _kv4_inputs(rng, B, A, H, n_kv, D)
    (jk, tk), (jv, tv), (jks, tks), (jvs, tvs) = arrs
    p = np.array(positions, np.int32)
    jpos, tpos = jnp.asarray(p), torch.from_numpy(p)
    cj, sj = j_rope_rows(jpos, D, 10000.0)
    want = j_attention_step(jqkv, jk, jv, jpos, cj, sj, jks, jvs, n_heads=H,
                            attn_len=A, kv_bits=4, interpret=True)
    ct, st = t_rope_rows(tpos, D, 10000.0)
    got = t_attention_step(tqkv, tk, tv, tpos, ct, st, tks, tvs, n_heads=H,
                           kv_bits=4)
    assert got[1].shape == (B, n_kv, D // 2) and got[1].dtype == torch.int8
    np.testing.assert_allclose(_np(got[0]), _np(want[0]), **ATTN)
    # with the JAX rope rows (f32 cos/sin may differ in the last bit
    # between the libraries) the packed rows and scales are bit-equal
    own = t_attention_step(tqkv, tk, tv, tpos,
                           torch.from_numpy(np.array(cj)),
                           torch.from_numpy(np.array(sj)), tks, tvs,
                           n_heads=H, kv_bits=4)
    for i in range(1, 5):
        assert np.array_equal(own[i].numpy(), np.asarray(want[i])), i
    np.testing.assert_allclose(_np(own[0]), _np(want[0]), **ATTN)


def test_attention_step_kv4_needs_scales(rng):
    (_, tqkv), arrs = _kv4_inputs(rng, 1, 64, 2, 2, 128)
    pos = torch.tensor([3], dtype=torch.int32)
    c, s = t_rope_rows(pos, 128, 10000.0)
    with pytest.raises(ValueError, match="k_scale"):
        t_attention_step(tqkv, arrs[0][1], arrs[1][1], pos, c, s,
                         n_heads=2, kv_bits=4)


# ---------------------------------------------------------------------------
# forward with the int4 cache

@functools.lru_cache(maxsize=None)
def _params(seed=3):
    jp = jl.params_from_checkpoint(random_checkpoint(CFG, seed=seed),
                                   param_dtype=jnp.bfloat16)
    tp = tl.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), CFG,
                              device="cpu")
    return jp, tp


@functools.lru_cache(maxsize=None)
def _jax_forward(attn_impl, logits_all):
    """The JAX fused forward, jitted, as its engine runs it."""
    def fwd(params, tokens, pos, cache):
        return jl.forward(params, CFG, tokens, pos, cache, attn_len=256,
                          fused=True, matmul_impl="dequant",
                          attn_impl=attn_impl, logits_all=logits_all)
    return jax.jit(fwd)


def _check_caches(jc, tc, n):
    for a, b in zip(jc.k + jc.v, tc.k + tc.v):
        _codes_within_one(np.asarray(a)[:, :n], b[:, :n])
    for a, b in zip(jc.k_scale + jc.v_scale, tc.k_scale + tc.v_scale):
        np.testing.assert_allclose(np.asarray(a)[:, :n], b[:, :n].numpy(),
                                   rtol=2e-2)


@pytest.mark.parametrize("attn_impl", [None, "fused_step"])
def test_forward_kv4_steps_match_jax(attn_impl):
    """T=1 steps over the int4 cache: plain attention (split-plane dots)
    and fused_step (the JAX kernel in interpret mode against the port's
    plain version), each step reading the rows the earlier ones packed."""
    jp, tp = _params()
    jc = jl.init_kv_cache(CFG, 1, 256, quantized=True, kv_bits=4)
    tc = tl.init_kv_cache(CFG, 1, 256, quantized=True, kv_bits=4,
                          device="cpu")
    jf = _jax_forward(attn_impl, False)
    toks = [1, 7, 42, 3, 200, 99]
    for step, t in enumerate(toks):
        jlog, jc = jf(jp, jnp.asarray([[t]], jnp.int32),
                      jnp.asarray([step], jnp.int32), jc)
        tlog, tc = tl.forward(tp, CFG, torch.tensor([[t]]),
                              torch.tensor([step], dtype=torch.int32), tc,
                              attn_len=256, attn_impl=attn_impl)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGITS)
        assert tlog.numpy().argmax() == np.asarray(jlog).argmax()
    _check_caches(jc, tc, len(toks))


def test_forward_kv4_block_matches_jax():
    """Two 128-token blocks with every row's logits: the int4 cache takes
    plain attention at T > 1 in both packages (no prefill kernel)."""
    jp, tp = _params()
    rng = np.random.default_rng(7)
    toks = rng.integers(3, CFG.vocab_size, (2, 128)).astype(np.int32)
    jc = jl.init_kv_cache(CFG, 1, 256, quantized=True, kv_bits=4)
    tc = tl.init_kv_cache(CFG, 1, 256, quantized=True, kv_bits=4,
                          device="cpu")
    jf = _jax_forward(None, True)
    for blk in range(2):
        pos = np.array([128 * blk], np.int32)
        jlog, jc = jf(jp, jnp.asarray(toks[blk:blk + 1]), jnp.asarray(pos),
                      jc)
        tlog, tc = tl.forward(tp, CFG, torch.from_numpy(toks[blk:blk + 1]),
                              torch.from_numpy(pos), tc, attn_len=256,
                              logits_all=True)
        assert tlog.shape == (1, 128, CFG.vocab_size)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGITS)
    _check_caches(jc, tc, 256)


def test_kv_cache_from_numpy_carries_kv4():
    """A JAX int4 cache crosses bit for bit, and the port continues from
    it with the JAX package's logits."""
    jp, tp = _params()
    jc = jl.init_kv_cache(CFG, 1, 256, quantized=True, kv_bits=4)
    jf = _jax_forward(None, False)
    for step, t in enumerate([1, 9, 33]):
        _, jc = jf(jp, jnp.asarray([[t]], jnp.int32),
                   jnp.asarray([step], jnp.int32), jc)
    tc = tl.kv_cache_from_numpy(jax.tree_util.tree_map(np.asarray, jc),
                                device="cpu")
    for a, b in zip(jc.k + jc.v + jc.k_scale + jc.v_scale,
                    tc.k + tc.v + tc.k_scale + tc.v_scale):
        assert b.dtype == (torch.int8 if a.dtype == jnp.int8
                           else torch.float32)
        assert np.array_equal(np.asarray(a), b.numpy())
    jlog, _ = jf(jp, jnp.asarray([[5]], jnp.int32),
                 jnp.asarray([3], jnp.int32), jc)
    tlog, _ = tl.forward(tp, CFG, torch.tensor([[5]]),
                         torch.tensor([3], dtype=torch.int32), tc,
                         attn_len=256)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGITS)


# ---------------------------------------------------------------------------
# the engine

def _fused_fwd(params, tokens, pos, cache, **kw):
    return jl.forward(params, CFG, tokens, pos, cache, fused=True, **kw)


@pytest.mark.parametrize("prompt_len", [5, 150])
def test_engine_kv4_greedy_stream_matches_jax(prompt_len):
    """kv_quant=4 greedy streams, a short prompt (T=1 steps) and one of
    150 tokens (a full and a padded 128-token block through plain
    attention over the int4 cache), equal to the JAX engine's."""
    jp, tp = _params()
    prompt = [1] + [3 + (37 * i) % 500 for i in range(prompt_len - 1)]
    je = JEngine(jp, CFG, None, temperature=0.0, kv_quant=4, max_seq=256)
    je._fwd = _fused_fwd
    te = TEngine(tp, CFG, None, temperature=0.0, kv_quant=4, max_seq=256,
                 device="cpu")
    assert te.kv_bits == 4 and te.cache.k[0].shape[-1] == CFG.head_dim // 2
    steps = prompt_len + 30
    want, _, _ = je.generate_benchmark(prompt, steps)
    got, _, _ = te.generate_benchmark(prompt, steps)
    assert got == want and len(got) == 31
