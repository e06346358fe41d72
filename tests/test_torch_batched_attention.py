"""batched_decode_attention in the port, held to the JAX package on the CPU.

Inputs are made from a seed with numpy and handed to both packages; the
JAX kernel runs in interpret mode. Tolerances: the JAX kernel walks its
window in blocks of 128 to 1024 rows, the port in chunks of 64, so p
rounds to bf16 against another running max and the two agree to bf16
rounding of p (rtol 2e-2, atol 2e-3, the attention_step bar of
tests/test_torch_ops.py); logits of two paths that round differently are
held to the JAX package's bar of tests/test_fused_path.py:51-52 (rtol and
atol 2e-2).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cu_awq_torch.models import llama as tl
from llama_cu_awq_torch.ops.cuda.batched_attention import (
    batched_decode_attention as t_bda)
from llama_cu_awq_torch.quant.kv import quantize_kv as t_quantize_kv
from llama_cu_awq_tpu.config import ModelConfig
from llama_cu_awq_tpu.io.checkpoint import random_checkpoint
from llama_cu_awq_tpu.models import llama as jl
from llama_cu_awq_tpu.ops.pallas.batched_attention import (
    batched_decode_attention as j_bda)
from tests.test_torch_ops import _bf16, _np

# one intra-op thread per process: the suite runs in several worker
# processes, and torch's default pool in each oversubscribes the cores
# (tens of times slower on small tensors); it also fixes the CPU sum order
torch.set_num_threads(1)

ATTN = dict(rtol=2e-2, atol=2e-3)
LOGITS = dict(rtol=2e-2, atol=2e-2)


def _inputs(rng, B, A, H, n_kv, D, quantized):
    """bf16 q and cache (or int8 codes and scales made by the JAX
    quantize_kv), the same bits in both packages."""
    q = _bf16(rng.standard_normal((B, H, D), dtype=np.float32))
    k = rng.standard_normal((B, A, n_kv, D), dtype=np.float32) * 0.3
    v = rng.standard_normal((B, A, n_kv, D), dtype=np.float32) * 0.3
    (jk, tk), (jv, tv) = _bf16(k), _bf16(v)
    if not quantized:
        return q, (jk, tk), (jv, tv), (None, None), (None, None)
    out = []
    for j in (jk, jv):
        codes, scales = jl.quantize_kv(j)
        out.append(((codes, torch.from_numpy(np.array(codes))),
                    (scales, torch.from_numpy(np.array(scales)))))
    (kc, ks), (vc, vs) = out
    return q, kc, vc, ks, vs


@pytest.mark.parametrize("early_exit", [True, False])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("B,H,n_kv,positions", [
    (1, 4, 4, (200,)),            # one slot, MHA
    (3, 8, 2, (0, 131, 255)),     # mixed positions, GQA, first and last row
])
def test_plain_matches_pallas_interpret(rng, early_exit, quantized, B, H,
                                        n_kv, positions):
    A, D = 256, 128
    (jq, tq), (jk, tk), (jv, tv), (jks, tks), (jvs, tvs) = _inputs(
        rng, B, A, H, n_kv, D, quantized)
    p = np.array(positions, np.int32)
    want = j_bda(jq, jk, jv, jnp.asarray(p), jks, jvs, interpret=True,
                 early_exit=early_exit, attn_len=A)
    got = t_bda(tq, tk, tv, torch.from_numpy(p), tks, tvs, attn_len=A,
                early_exit=early_exit)
    assert got.shape == (B, H, D) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **ATTN)


@pytest.mark.parametrize("quantized", [False, True])
def test_early_exit_and_mask(rng, quantized):
    """Rows past pos[b] do not change the output: poisoning them leaves
    it bit-identical under the mask (tests/test_batched_attention.py:
    62-95), and a shorter window above pos reads the same rows. The two
    values of early_exit agree to the order of f32 sums (the static walk
    adds masked rows' zeros into sums that torch vectorizes)."""
    B, A, H, n_kv, D = 2, 320, 4, 2, 128
    (_, q), (_, k), (_, v), (_, ks), (_, vs) = _inputs(
        rng, B, A, H, n_kv, D, quantized)
    pos = torch.tensor([57, 200], dtype=torch.int32)
    base = t_bda(q, k, v, pos, ks, vs, attn_len=A)
    assert torch.equal(base, t_bda(q, k, v, pos, ks, vs, attn_len=256))
    static = t_bda(q, k, v, pos, ks, vs, attn_len=A, early_exit=False)
    torch.testing.assert_close(static, base, rtol=1e-5, atol=1e-7)
    k2, v2 = k.clone(), v.clone()
    fill = 100 if quantized else 1e4
    k2[0, 58:], v2[0, 58:] = fill, -fill
    k2[1, 201:], v2[1, 201:] = fill, -fill
    assert torch.equal(base, t_bda(q, k2, v2, pos, ks, vs, attn_len=A))
    assert torch.equal(static, t_bda(q, k2, v2, pos, ks, vs, attn_len=A,
                                     early_exit=False))


# ---------------------------------------------------------------------------
# forward(attn_impl="batched")

# head_dim 128: the JAX forward takes its batched kernel (interpret mode)
CFG = ModelConfig(dim=512, hidden_dim=384, n_layers=2, n_heads=4,
                  n_kv_heads=2, vocab_size=512, seq_len=256)


@functools.lru_cache(maxsize=None)
def _params(seed=3):
    jp = jl.params_from_checkpoint(random_checkpoint(CFG, seed=seed),
                                   param_dtype=jnp.bfloat16)
    tp = tl.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), CFG,
                              device="cpu")
    return jp, tp


@pytest.mark.parametrize("attn_impl", ["batched", "batched_static"])
@pytest.mark.parametrize("quantized", [False, True])
def test_forward_batched_matches_jax(attn_impl, quantized):
    """Three slots at different positions, four T=1 steps each reading
    the rows the earlier ones wrote."""
    jp, tp = _params()
    B = 3
    jc = jl.init_kv_cache(CFG, B, 256, quantized=quantized)
    tc = tl.init_kv_cache(CFG, B, 256, quantized=quantized, device="cpu")
    start = np.array([0, 5, 40], np.int32)
    rng = np.random.default_rng(11)
    for step in range(4):
        toks = rng.integers(3, CFG.vocab_size, (B, 1)).astype(np.int32)
        pos = start + step
        jlog, jc = jl.forward(jp, CFG, jnp.asarray(toks), jnp.asarray(pos),
                              jc, attn_len=256, fused=True,
                              matmul_impl="dequant", attn_impl=attn_impl)
        tlog, tc = tl.forward(tp, CFG, torch.from_numpy(toks),
                              torch.from_numpy(pos), tc, attn_len=256,
                              attn_impl=attn_impl)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGITS)
        assert (tlog.numpy().argmax(-1) == np.asarray(jlog).argmax(-1)).all()


def test_forward_batched_block_takes_prefill_kernel():
    """At T >= PFK_MIN_T attn_impl='batched' takes prefill_attention, as
    the JAX forward does: the same logits and cache as attn_impl=None."""
    _, tp = _params()
    toks = torch.randint(3, CFG.vocab_size, (1, 128),
                         generator=torch.Generator().manual_seed(0))
    pos = torch.tensor([0], dtype=torch.int32)
    out = []
    for impl in (None, "batched"):
        c = tl.init_kv_cache(CFG, 1, 256, device="cpu")
        out.append(tl.forward(tp, CFG, toks, pos, c, attn_len=256,
                              attn_impl=impl, logits_all=True))
    (l1, c1), (l2, c2) = out
    assert torch.equal(l1, l2)
    assert all(torch.equal(a, b) for a, b in zip(c1.k + c1.v, c2.k + c2.v))


def test_quantize_kv_bit_equal_to_jitted_jax(rng):
    """The int8 rows the batched path writes: bit-equal to the JAX
    quantize_kv under jit, over a window large enough that absmax/127 and
    absmax * f32(1/127) part somewhere."""
    jx, tx = _bf16(rng.standard_normal((1, 256, 2, 128), dtype=np.float32))
    jq, js = jax.jit(jl.quantize_kv)(jx)
    tq, ts = t_quantize_kv(tx)
    assert np.array_equal(np.asarray(jq), tq.numpy())
    assert np.array_equal(np.asarray(js), ts.numpy())
