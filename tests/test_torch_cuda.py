"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: every test here needs an NVIDIA card and skips without
one. The file imports neither jax nor the JAX package, so on a machine
without jax it runs with the repository's conftest left out:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Shapes are small but ragged (partial last group, column tails, more rows
of x than one pass holds, position 0), where chip_smoke.py checks the 7B
shapes. Tolerances: the int4 bar of tests/test_pallas_int4.py:68 (rtol
2e-2, atol 2e-3) where a bf16 output or a bf16 p may round one ulp apart
after f32 sums in another order; f32 sum order only for the dense GEMV;
bit-equal for the new cache rows, int8 codes and scales.
"""

import pytest
import torch

from llama_cu_awq_torch.config import ModelConfig
from llama_cu_awq_torch.engine import InferenceEngine
from llama_cu_awq_torch.io.checkpoint import random_checkpoint
from llama_cu_awq_torch.models import (forward, init_kv_cache,
                                       params_from_checkpoint)
from llama_cu_awq_torch.ops.cuda import (LAUNCHES, VARIANT_LAUNCHES,
                                         reset_launches)
from llama_cu_awq_torch.ops.cuda.attention_step import (attention_step,
                                                        rope_rows)
from llama_cu_awq_torch.ops.cuda.dense_gemv import dense_gemv
from llama_cu_awq_torch.ops.cuda.int4_matmul import (int4_matmul,
                                                     int4_matmul_fused)
from llama_cu_awq_torch.quant.int8 import quantize_dense_int8
from llama_cu_awq_torch.quant.qtensor import QTensor

pytestmark = pytest.mark.cuda

INT4 = dict(rtol=2e-2, atol=2e-3)


@pytest.fixture
def gen():
    """A seeded generator on the card; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is "
                    "False")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _randn(g, *shape, dtype=torch.bfloat16):
    return torch.randn(*shape, device="cuda", generator=g).to(dtype)


def _qtensor(g, n_in, n_out):
    groups = -(-n_in // 128)
    qw = torch.randint(0, 256, (n_out, n_in // 2), dtype=torch.uint8,
                       device="cuda", generator=g).view(torch.int32)
    scales = (0.02 * (1 + 0.1 * _randn(g, n_out, groups,
                                       dtype=torch.float32))).half()
    zeros = torch.randint(0, 16, (n_out, groups), dtype=torch.uint8,
                          device="cuda", generator=g)
    return QTensor(qw, scales, zeros, n_in, n_out)


def _close(got, want, rtol, atol):
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("variant", ["prescale", "residual", "silu"])
@pytest.mark.parametrize("m", [1, 3, 11])
def test_int4_matmul_fused_matches_plain(gen, variant, m):
    n_in, n_out = 320, 200  # a partial last group; a tail of columns
    qt = _qtensor(gen, n_in, n_out)
    x = _randn(gen, m, n_in)
    kw = {}
    if variant == "prescale":
        kw["prescale"] = (torch.rand(m, 1, device="cuda", generator=gen)
                          + 0.5, torch.rand(n_in, device="cuda",
                                            generator=gen) + 0.5)
    else:
        kw.update(residual=_randn(gen, m, n_out), emit_ss_eps=1e-5)
        if variant == "silu":
            kw["silu_u"] = _randn(gen, m, n_in)
    before = LAUNCHES["int4_matmul_fused"]
    out, ss = int4_matmul_fused(x, qt, **kw)
    ref, ss_ref = int4_matmul_fused(x, qt, plain=True, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["int4_matmul_fused"] == before + 1
    _close(out, ref, **INT4)
    if ss_ref is not None:
        _close(ss, ss_ref, **INT4)


@pytest.mark.parametrize("m", [1, 16])
def test_int4_matmul_matches_plain(gen, m):
    qt = _qtensor(gen, 512, 300)
    x = _randn(gen, 2, m, 512)  # leading dims fold into rows
    out = int4_matmul(x, qt)
    assert out.shape == (2, m, 300) and out.dtype == torch.float32
    _close(out, int4_matmul(x, qt, plain=True), **INT4)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("m", [1, 5, 9])
def test_dense_gemv_matches_plain(gen, int8, m):
    w = (_randn(gen, 1000, 256, dtype=torch.float32) * 0.05).bfloat16()
    args = (quantize_dense_int8(w).w8, quantize_dense_int8(w).scale) \
        if int8 else (w,)
    x = _randn(gen, m, 256)
    # operands widen exactly to f32; only the order of f32 sums differs
    _close(dense_gemv(x, *args), dense_gemv(x, *args, plain=True),
           rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("H,n_kv,D", [(4, 4, 128), (8, 2, 128), (32, 4, 64)])
def test_attention_step_matches_plain(gen, quant, H, n_kv, D):
    B, S = 3, 320
    pos = torch.tensor([0, 77, 319], dtype=torch.int32, device="cuda")
    cos2, sinm = rope_rows(pos, D, 10000.0)
    qkv = _randn(gen, B, (H + 2 * n_kv) * D)
    if quant:
        kc = torch.randint(-127, 128, (B, S, n_kv, D), dtype=torch.int8,
                           device="cuda", generator=gen)
        vc = torch.randint(-127, 128, (B, S, n_kv, D), dtype=torch.int8,
                           device="cuda", generator=gen)
        ks = torch.rand(B, S, n_kv, device="cuda", generator=gen) * 0.02
        vs = torch.rand(B, S, n_kv, device="cuda", generator=gen) * 0.02
    else:
        kc, vc = _randn(gen, B, S, n_kv, D), _randn(gen, B, S, n_kv, D)
        ks = vs = None
    args = (qkv, kc, vc, pos, cos2, sinm, ks, vs)
    got = attention_step(*args, n_heads=H)
    want = attention_step(*args, n_heads=H, plain=True)
    torch.cuda.synchronize()
    _close(got[0], want[0], **INT4)
    for g, w in zip(got[1:], want[1:]):
        assert (g is None) == (w is None)
        if w is not None:
            assert torch.equal(g, w)


def test_wrappers_raise_on_bad_input(gen):
    qt = _qtensor(gen, 256, 64)
    x = _randn(gen, 1, 256)
    with pytest.raises(ValueError, match="residual"):
        int4_matmul_fused(x, qt, residual=_randn(gen, 1, 64,
                                                 dtype=torch.float32))
    with pytest.raises(ValueError, match="inputs"):
        int4_matmul(_randn(gen, 1, 240), qt)
    with pytest.raises(ValueError, match="w"):
        dense_gemv(x, _randn(gen, 64, 256, dtype=torch.float16))


_CFG = ModelConfig(dim=256, hidden_dim=384, n_layers=2, n_heads=2,
                   n_kv_heads=1, vocab_size=512, seq_len=256)


@pytest.mark.parametrize("attn_impl", ["auto", "fused_step"])
@pytest.mark.parametrize("quantized", [False, True])
def test_forward_on_card_matches_cpu(gen, attn_impl, quantized):
    """Kernels on the card against the plain versions on the CPU, from
    the same checkpoint: the JAX package's bar for logits of two paths
    that round differently (tests/test_fused_path.py:51-52)."""
    ckpt = random_checkpoint(_CFG, seed=3)
    out = {}
    reset_launches()
    for dev in ("cpu", "cuda"):
        p = params_from_checkpoint(ckpt, device=dev)
        c = init_kv_cache(_CFG, 1, 256, quantized=quantized, device=dev)
        logits = []
        for step, t in enumerate([1, 7, 42, 3, 200]):
            lg, c = forward(p, _CFG, torch.tensor([[t]], device=dev),
                            torch.tensor([step], dtype=torch.int32,
                                         device=dev), c,
                            attn_impl=attn_impl)
            logits.append(lg.float().cpu())
        out[dev] = torch.stack(logits)
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=2e-2,
                               atol=2e-2)
    assert LAUNCHES["int4_matmul_fused"] == 5 * 4 * _CFG.n_layers
    assert LAUNCHES["dense_gemv"] == 5
    assert LAUNCHES["attention_step"] == (
        5 * _CFG.n_layers if attn_impl == "fused_step" else 0)
    # the same launches per variant: the qkv projection with its rmsnorm
    # prologue, and the lm_head GEMV
    assert VARIANT_LAUNCHES["int4_matmul_fused/prescale/m1/256x512"] == (
        5 * _CFG.n_layers)
    assert VARIANT_LAUNCHES["dense_gemv/bf16/m1/512x256"] == 5
    for kernel, n in LAUNCHES.items():
        assert n == sum(v for k, v in VARIANT_LAUNCHES.items()
                        if k.startswith(kernel + "/"))


def test_engine_generates_on_card(gen):
    params = params_from_checkpoint(random_checkpoint(_CFG, seed=4))
    eng = InferenceEngine(params, _CFG, None, temperature=0.0)
    toks, _, _ = eng.generate_benchmark([1, 5, 9], 40)
    assert len(toks) == 38
    assert all(0 <= t < _CFG.vocab_size for t in toks)
