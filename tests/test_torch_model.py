"""The port's forward against the JAX forward on the CPU.

The oracle is the JAX `forward(..., fused=True, matmul_impl="dequant")`
(the JAX engine on the CPU would pick fused=False, which rounds
differently), run step by step from the same weights: a checkpoint made
with numpy from a seed, carried across with params_from_numpy.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cu_awq_torch.models import llama as tl
from llama_cu_awq_tpu.config import ModelConfig
from llama_cu_awq_tpu.io.checkpoint import random_checkpoint
from llama_cu_awq_tpu.models import llama as jl

# one intra-op thread per process: the suite runs in several worker
# processes, and torch's default pool in each oversubscribes the cores
# (tens of times slower on small tensors); it also fixes the CPU sum order
torch.set_num_threads(1)

TOKENS = [1, 7, 42, 3, 200, 99]


def _params(cfg, seed=3, lm_head_bits=None):
    jp = jl.params_from_checkpoint(random_checkpoint(cfg, seed=seed),
                                   param_dtype=jnp.bfloat16)
    if lm_head_bits:
        jp = jl.quantize_lm_head(jp, bits=lm_head_bits, tpu_layout=False)
    tp = tl.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg,
                              device="cpu")
    return jp, tp


def _run_both(cfg, jp, tp, quantized, attn_impl, max_seq, tokens=TOKENS,
              jax_attn_impl=None):
    jc = jl.init_kv_cache(cfg, 1, max_seq, quantized=quantized)
    tc = tl.init_kv_cache(cfg, 1, max_seq, quantized=quantized,
                          device="cpu")
    out = []
    for step, t in enumerate(tokens):
        jlog, jc = jl.forward(jp, cfg, jnp.asarray([[t]], jnp.int32),
                              jnp.asarray([step], jnp.int32), jc,
                              fused=True, matmul_impl="dequant",
                              attn_impl=jax_attn_impl or attn_impl)
        tlog, tc = tl.forward(tp, cfg, torch.tensor([[t]]),
                              torch.tensor([step], dtype=torch.int32), tc,
                              attn_impl=attn_impl)
        out.append((np.asarray(jlog), tlog.numpy()))
    return out, jc, tc


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("cfg_name", ["tiny_config", "tiny_mha_config"])
def test_forward_logits_match_jax(request, cfg_name, quantized):
    cfg = request.getfixturevalue(cfg_name)
    jp, tp = _params(cfg)
    steps, jc, tc = _run_both(cfg, jp, tp, quantized, "auto", cfg.seq_len)
    _check_steps(cfg, steps, jc, tc, quantized)


def _check_steps(cfg, steps, jc, tc, quantized):
    for want, got in steps:
        assert got.shape == want.shape == (1, cfg.vocab_size)
        # identical staging end to end; f32 sums run in another order, which
        # can round a bf16 activation one ulp apart now and then
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
        assert got.argmax() == want.argmax()
    # the caches hold the same rows (int8 codes may differ by one where a
    # bf16 k rounds apart; scales to f32 rounding)
    n = len(TOKENS)
    for a, b in zip(jc.k + jc.v, tc.k + tc.v):
        np.testing.assert_allclose(np.asarray(a, np.float32)[:, :n],
                                   b.float().numpy()[:, :n], rtol=1e-2,
                                   atol=1.0 if quantized else 1e-2)


@pytest.mark.parametrize("bits", [8, 4])
def test_forward_quantized_lm_head_matches_jax(tiny_config, bits):
    jp, tp = _params(tiny_config, lm_head_bits=bits)
    steps, _, _ = _run_both(tiny_config, jp, tp, False, "auto",
                            tiny_config.seq_len, TOKENS[:3])
    for want, got in steps:
        # as above; the w4 head stages x to bf16 in both packages
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("n_heads,n_kv", [(2, 2), (4, 2)])
def test_forward_fused_step_matches_jax(quantized, n_heads, n_kv):
    """head_dim 128 under attn_impl='fused_step': the port's attention_step
    (plain version on the CPU) against the JAX kernel in interpret mode."""
    cfg = ModelConfig(dim=128 * n_heads, hidden_dim=384, n_layers=2,
                      n_heads=n_heads, n_kv_heads=n_kv, vocab_size=256,
                      seq_len=256)
    jp, tp = _params(cfg, seed=11)
    steps, _, _ = _run_both(cfg, jp, tp, quantized, "fused_step", 256,
                            TOKENS[:4])
    for want, got in steps:
        # the JAX kernel walks its window in one block, the port in chunks
        # of 64, so p rounds to bf16 against another running max and a bf16
        # activation may round one ulp apart in the next layer: the JAX
        # package's own bar for logits of two differently rounded paths
        # (tests/test_fused_path.py:51-52)
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
        assert got.argmax() == want.argmax()


@pytest.mark.parametrize("quantized", [False, True])
def test_forward_fused_step_head_dim_64(quantized):
    """attn_impl='fused_step' runs attention_step for every head shape
    its CUDA kernel takes, here head_dim 64 over a 200-row cache, which the
    JAX kernel does not take: held to the JAX einsum forward."""
    cfg = ModelConfig(dim=256, hidden_dim=384, n_layers=2, n_heads=4,
                      n_kv_heads=2, vocab_size=256, seq_len=200)
    jp, tp = _params(cfg, seed=5)
    steps, _, _ = _run_both(cfg, jp, tp, quantized, "fused_step", 200,
                            TOKENS[:4], jax_attn_impl="einsum")
    for want, got in steps:
        # the einsum path stages scores through bf16, the kernel does not:
        # the JAX package's bar for logits of two differently rounded paths
        # (tests/test_fused_path.py:51-52)
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
        assert got.argmax() == want.argmax()


def test_forward_fused_step_rejects_head_shapes(tiny_config):
    """Asked for explicitly, fused_step raises on head shapes its kernel
    cannot take (head_dim 16) rather than running other attention; "auto"
    picks plain attention for them."""
    _, tp = _params(tiny_config)
    cache = tl.init_kv_cache(tiny_config, 1, 2048, device="cpu")
    tok = torch.tensor([[5]])
    pos = torch.tensor([0], dtype=torch.int32)
    with pytest.raises(ValueError, match="head_dim=16"):
        tl.forward(tp, tiny_config, tok, pos, cache, attn_impl="fused_step")
    logits, _ = tl.forward(tp, tiny_config, tok, pos, cache,
                           attn_impl="auto")
    assert logits.shape == (1, tiny_config.vocab_size)


def test_forward_plain_flag_and_no_logits(tiny_config):
    """no_logits returns only the cache; logits_all returns every row; the
    plain flag changes nothing on the CPU."""
    _, tp = _params(tiny_config)
    c1 = tl.init_kv_cache(tiny_config, 1, 16, device="cpu")
    c2 = tl.init_kv_cache(tiny_config, 1, 16, device="cpu")
    tok = torch.tensor([[5, 6, 7]])
    pos = torch.tensor([0], dtype=torch.int32)
    none, c1 = tl.forward(tp, tiny_config, tok, pos, c1, no_logits=True)
    assert none is None
    allp, c2 = tl.forward(tp, tiny_config, tok, pos, c2, logits_all=True,
                          plain=True)
    assert allp.shape == (1, 3, tiny_config.vocab_size)
    for a, b in zip(c1.k, c2.k):
        assert torch.equal(a, b)


def test_kv_cache_from_numpy_continues_jax_state(tiny_config):
    """A JAX cache carried across lets the port continue at the same
    position with the same logits."""
    jp, tp = _params(tiny_config)
    _, jc, _ = _run_both(tiny_config, jp, tp, True, "auto", 32, TOKENS[:3])
    tc = tl.kv_cache_from_numpy(jax.tree_util.tree_map(np.asarray, jc),
                                device="cpu")
    assert tc.quantized and tc.k[0].dtype == torch.int8
    jlog, _ = jl.forward(jp, tiny_config, jnp.asarray([[9]], jnp.int32),
                         jnp.asarray([3], jnp.int32), jc, fused=True,
                         matmul_impl="dequant")
    tlog, _ = tl.forward(tp, tiny_config, torch.tensor([[9]]),
                         torch.tensor([3], dtype=torch.int32), tc)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-3,
                               atol=1e-4)


def test_unported_options_raise(tiny_config):
    """What forward and the cache still refuse: a KV width other than 4 or
    8, an unknown attn_impl, activations other than bf16, fp16 and f32
    (f32 over an f32 cache runs), and an explicit batched that its kernel
    cannot take (the int4 cache, head_dim 16)."""
    _, tp = _params(tiny_config)
    with pytest.raises(ValueError, match="kv_bits"):
        tl.init_kv_cache(tiny_config, 1, 16, quantized=True, kv_bits=3,
                         device="cpu")
    tok = torch.tensor([[1]])
    pos = torch.tensor([0], dtype=torch.int32)
    cache = tl.init_kv_cache(tiny_config, 1, 16, device="cpu")
    with pytest.raises(ValueError, match="unknown attn_impl"):
        tl.forward(tp, tiny_config, tok, pos, cache, attn_impl="mono")
    c32 = tl.init_kv_cache(tiny_config, 1, 16, dtype=torch.float32,
                           device="cpu")
    logits, _ = tl.forward(tp, tiny_config, tok, pos, c32,
                           act_dtype=torch.float32)
    assert logits.shape == (1, tiny_config.vocab_size)
    assert bool(torch.isfinite(logits).all())
    assert bool(c32.k[0][0, 0].abs().sum() > 0)
    with pytest.raises(ValueError, match="act_dtype"):
        tl.forward(tp, tiny_config, tok, pos, cache,
                   act_dtype=torch.float64)
    with pytest.raises(ValueError, match="head_dim=16"):
        tl.forward(tp, tiny_config, tok, pos, cache, attn_impl="batched")
    kv4 = tl.init_kv_cache(tiny_config, 1, 16, quantized=True, kv_bits=4,
                           device="cpu")
    for impl in ("batched", "batched_static"):
        with pytest.raises(ValueError, match="int4 KV cache"):
            tl.forward(tp, tiny_config, tok, pos, kv4, attn_impl=impl)
    assert dataclasses.is_dataclass(tp)
