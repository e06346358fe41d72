"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: every test here needs an NVIDIA card and skips without
one. The file imports neither jax nor the JAX package, so on a machine
without jax it runs with the repository's conftest left out:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Shapes are small but ragged (partial last group, column tails, more rows
of x than one pass or one GEMM tile holds, a partial query tile, position
0), where chip_smoke.py checks the 7B shapes. Tolerances: the int4 bar of
tests/test_pallas_int4.py:68 (rtol 2e-2, atol 2e-3) where a bf16 output or
a bf16 p may round one ulp apart after f32 sums in another order; f32 sum
order only for the dense GEMV; bit-equal for the new cache rows, int8
and int4 codes and scales; token for token for the speculative stream
against the plain one.
"""

import math

import pytest
import torch

from llama_cu_awq_torch.config import ModelConfig
from llama_cu_awq_torch.engine import InferenceEngine
from llama_cu_awq_torch.io.checkpoint import random_checkpoint
from llama_cu_awq_torch.models import (forward, init_kv_cache,
                                       params_from_checkpoint)
from llama_cu_awq_torch.ops.cuda import (LAUNCHES, VARIANT_LAUNCHES,
                                         reset_launches)
from llama_cu_awq_torch.ops.cuda.attention_step import (
    SPLIT_ROWS, attention_step, attention_step_plain, rope_rows)
from llama_cu_awq_torch.ops.cuda.batched_attention import (
    batched_decode_attention)
from llama_cu_awq_torch.ops.cuda.dense_gemv import dense_gemv
from llama_cu_awq_torch.ops.cuda.int4_matmul import (GEMM_MIN_M,
                                                     int4_matmul,
                                                     int4_matmul_fused)
from llama_cu_awq_torch.ops.cuda.prefill_attention import prefill_attention
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


def _fused_kwargs(gen, variant, m, n_in, n_out):
    kw = {}
    if variant == "prescale":
        kw["prescale"] = (torch.rand(m, 1, device="cuda", generator=gen)
                          + 0.5, torch.rand(n_in, device="cuda",
                                            generator=gen) + 0.5)
    else:
        kw.update(residual=_randn(gen, m, n_out), emit_ss_eps=1e-5)
        if variant == "silu":
            kw["silu_u"] = _randn(gen, m, n_in)
    return kw


@pytest.mark.parametrize("variant", ["prescale", "residual", "silu"])
@pytest.mark.parametrize("m", [1, 3, 11])
def test_int4_matmul_fused_matches_plain(gen, variant, m):
    n_in, n_out = 320, 200  # a partial last group; a tail of columns
    qt = _qtensor(gen, n_in, n_out)
    x = _randn(gen, m, n_in)
    kw = _fused_kwargs(gen, variant, m, n_in, n_out)
    before = LAUNCHES["int4_matmul_fused"]
    out, ss = int4_matmul_fused(x, qt, **kw)
    ref, ss_ref = int4_matmul_fused(x, qt, plain=True, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["int4_matmul_fused"] == before + 1
    _close(out, ref, **INT4)
    if ss_ref is not None:
        _close(ss, ss_ref, **INT4)


@pytest.mark.parametrize("variant", ["prescale", "residual", "silu",
                                     "silu_gate_up_halves"])
@pytest.mark.parametrize("m", [GEMM_MIN_M, 128, 200])
def test_int4_gemm_matches_plain(gen, variant, m):
    """The tensor-core GEMM from GEMM_MIN_M rows on: the four prologue and
    epilogue forms, a whole 128-row tile, and 200 rows (a partial second
    tile), over a partial last group and a tail of columns; the SwiGLU
    form also from the gate and up halves of one (m, 2 * n_in) tensor,
    as the forward passes them."""
    n_in, n_out = 320, 200
    qt = _qtensor(gen, n_in, n_out)
    if variant == "silu_gate_up_halves":
        x, up = _randn(gen, m, 2 * n_in).chunk(2, dim=-1)
        kw = dict(silu_u=up, residual=_randn(gen, m, n_out), emit_ss_eps=1e-5)
    else:
        x = _randn(gen, m, n_in)
        kw = _fused_kwargs(gen, variant, m, n_in, n_out)
    reset_launches()
    out, ss = int4_matmul_fused(x, qt, **kw)
    ref, ss_ref = int4_matmul_fused(x, qt, plain=True, **kw)
    torch.cuda.synchronize()
    (key,) = VARIANT_LAUNCHES
    assert key.startswith("int4_matmul_fused/gemm/") and key.endswith(
        f"/m{m}/{n_in}x{n_out}")
    _close(out, ref, **INT4)
    if ss_ref is not None:
        _close(ss, ss_ref, **INT4)


def test_int4_matmul_route_by_rows(gen):
    """The documented rule on shapes: fewer than GEMM_MIN_M rows take the
    GEMV, GEMM_MIN_M and more the GEMM, as the variant counters show."""
    qt = _qtensor(gen, 256, 96)
    reset_launches()
    for m in (GEMM_MIN_M - 1, GEMM_MIN_M):
        x = _randn(gen, m, 256)
        _close(int4_matmul(x, qt), int4_matmul(x, qt, plain=True), **INT4)
    assert VARIANT_LAUNCHES == {
        f"int4_matmul/gemv/m{GEMM_MIN_M - 1}/256x96": 1,
        f"int4_matmul/gemm/m{GEMM_MIN_M}/256x96": 1}


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


@pytest.mark.parametrize("H,n_kv,D", [(4, 4, 128), (8, 2, 128), (32, 4, 64)])
def test_attention_step_kv4_matches_plain(gen, H, n_kv, D):
    """The int4 cache: every byte value in the history (codes -8..7), the
    new row packed and scaled bit-equal to the plain version."""
    B, S = 3, 320
    pos = torch.tensor([0, 77, 319], dtype=torch.int32, device="cuda")
    cos2, sinm = rope_rows(pos, D, 10000.0)
    qkv = _randn(gen, B, (H + 2 * n_kv) * D)
    kc, vc = (torch.randint(-128, 128, (B, S, n_kv, D // 2),
                            dtype=torch.int8, device="cuda", generator=gen)
              for _ in range(2))
    ks, vs = (torch.rand(B, S, n_kv, device="cuda", generator=gen) * 0.2
              for _ in range(2))
    args = (qkv, kc, vc, pos, cos2, sinm, ks, vs)
    reset_launches()
    got = attention_step(*args, n_heads=H, kv_bits=4)
    want = attention_step(*args, n_heads=H, kv_bits=4, plain=True)
    torch.cuda.synchronize()
    assert LAUNCHES["attention_step_kv4"] == 1
    assert LAUNCHES["attention_step"] == 0
    _close(got[0], want[0], **INT4)
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g, w)


@pytest.mark.parametrize("early_exit", [True, False])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("H,n_kv,D", [(4, 4, 128), (8, 2, 128), (32, 4, 64)])
def test_batched_attention_matches_plain(gen, early_exit, quant, H, n_kv, D):
    """Three slots at position 0, mid-window and the window's last row,
    attn_len 320 short of the 384-row cache."""
    B, S, attn_len = 3, 384, 320
    pos = torch.tensor([0, 150, 319], dtype=torch.int32, device="cuda")
    q = _randn(gen, B, H, D)
    if quant:
        kc, vc = (torch.randint(-127, 128, (B, S, n_kv, D), dtype=torch.int8,
                                device="cuda", generator=gen)
                  for _ in range(2))
        ks, vs = (torch.rand(B, S, n_kv, device="cuda", generator=gen)
                  * 0.02 for _ in range(2))
    else:
        kc, vc = _randn(gen, B, S, n_kv, D), _randn(gen, B, S, n_kv, D)
        ks = vs = None
    args = (q, kc, vc, pos, ks, vs)
    reset_launches()
    got = batched_decode_attention(*args, attn_len=attn_len,
                                   early_exit=early_exit)
    want = batched_decode_attention(*args, attn_len=attn_len,
                                    early_exit=early_exit, plain=True)
    torch.cuda.synchronize()
    assert LAUNCHES["batched_decode_attention"] == 1
    assert got.shape == (B, H, D) and got.dtype == torch.float32
    _close(got, want, **INT4)


# slots on either side of the split boundaries, one deep slot alone, and
# mixed positions in one batch
_SPLIT_CASES = ((0, SPLIT_ROWS - 1, SPLIT_ROWS, SPLIT_ROWS + 1),
                (3 * SPLIT_ROWS + 5,), (7, SPLIT_ROWS, 3 * SPLIT_ROWS + 5))


def _split_cache(gen, B, S, n_kv, D, fmt):
    """k, v and scales: bf16 values, int8 codes or packed int4 bytes."""
    if fmt == "bf16":
        return (_randn(gen, B, S, n_kv, D), _randn(gen, B, S, n_kv, D),
                None, None)
    width, top = (D, 127) if fmt == "int8" else (D // 2, 128)
    k, v = (torch.randint(-top, 128, (B, S, n_kv, width), dtype=torch.int8,
                          device="cuda", generator=gen) for _ in range(2))
    amp = 0.02 if fmt == "int8" else 0.2
    ks, vs = (torch.rand(B, S, n_kv, device="cuda", generator=gen) * amp
              for _ in range(2))
    return k, v, ks, vs


def _counters_zero():
    from llama_cu_awq_torch.ops.cuda.attention_step import _SCRATCH

    return all(int(c.abs().sum()) == 0 for _, c in _SCRATCH.values())


@pytest.mark.parametrize("fmt", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("H,n_kv,D", [(4, 4, 128), (8, 2, 128), (32, 4, 64)])
@pytest.mark.parametrize("case", range(len(_SPLIT_CASES)))
def test_attention_step_splits_match_plain(gen, fmt, H, n_kv, D, case):
    """The split kernel at the split boundaries (a window of 4 splits,
    shorter than the cache) against its plain version; the new rows,
    codes and scales bit-equal; a second launch gives the same bits; the
    arrival counters read zero after; each slot alone gives the bits of
    its row in the batch."""
    positions = _SPLIT_CASES[case]
    B, S, win = len(positions), 4 * SPLIT_ROWS + 16, 4 * SPLIT_ROWS
    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
    cos2, sinm = rope_rows(pos, D, 10000.0)
    qkv = _randn(gen, B, (H + 2 * n_kv) * D)
    k, v, ks, vs = _split_cache(gen, B, S, n_kv, D, fmt)
    args = (qkv, k, v, pos, cos2, sinm, ks, vs)
    kw = dict(n_heads=H, kv_bits=4 if fmt == "int4" else 8, attn_len=win)
    reset_launches()
    got = attention_step(*args, **kw)
    again = attention_step(*args, **kw)
    want = attention_step(*args, plain=True, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["attention_step_kv4" if fmt == "int4"
                    else "attention_step"] == 2
    _close(got[0], want[0], **INT4)
    for g, a, w in zip(got, again, want):
        assert (g is None) == (a is None) == (w is None)
        if g is not None:
            assert torch.equal(g, a)
    for g, w in zip(got[1:], want[1:]):
        if w is not None:
            assert torch.equal(g, w)
    assert _counters_zero()
    for b in range(B):
        one = attention_step(*(x[b:b + 1] if x is not None else None
                               for x in args), **kw)
        assert torch.equal(one[0][0], got[0][b])


@pytest.mark.parametrize("early_exit", [True, False])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("H,n_kv,D", [(4, 4, 128), (8, 2, 128), (32, 4, 64)])
@pytest.mark.parametrize("case", range(len(_SPLIT_CASES)))
def test_batched_attention_splits_match_plain(gen, early_exit, quant, H,
                                              n_kv, D, case):
    """The batched split kernel at the split boundaries against its plain
    version; without early exit the splits past a slot's position are
    wholly masked. Repeatable bits, counters back at zero, and each slot
    alone equal to its row in the batch."""
    positions = _SPLIT_CASES[case]
    B, S, win = len(positions), 4 * SPLIT_ROWS + 16, 4 * SPLIT_ROWS
    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
    k, v, ks, vs = _split_cache(gen, B, S, n_kv, D,
                                "int8" if quant else "bf16")
    args = (_randn(gen, B, H, D), k, v, pos, ks, vs)
    kw = dict(attn_len=win, early_exit=early_exit)
    reset_launches()
    got = batched_decode_attention(*args, **kw)
    again = batched_decode_attention(*args, **kw)
    want = batched_decode_attention(*args, plain=True, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["batched_decode_attention"] == 2
    _close(got, want, **INT4)
    assert torch.equal(got, again)
    assert _counters_zero()
    for b in range(B):
        one = batched_decode_attention(
            *(x[b:b + 1] if x is not None else None for x in args), **kw)
        assert torch.equal(one[0], got[b])


def test_split_kernels_refuse_a_misaligned_cache(gen):
    """The kernels read the cache as 16-byte vectors: a contiguous cache
    that starts off a 16-byte boundary raises before any launch."""
    B, S, n_kv, H, D = 1, 64, 2, 4, 128
    n = B * S * n_kv * D
    k = _randn(gen, n + 8)[7:n + 7].view(B, S, n_kv, D)
    v = _randn(gen, B, S, n_kv, D)
    pos = torch.tensor([5], dtype=torch.int32, device="cuda")
    cos2, sinm = rope_rows(pos, D, 10000.0)
    reset_launches()
    with pytest.raises(ValueError, match="aligned"):
        attention_step(_randn(gen, B, (H + 2 * n_kv) * D), k, v, pos, cos2,
                       sinm, n_heads=H)
    with pytest.raises(ValueError, match="aligned"):
        batched_decode_attention(_randn(gen, B, H, D), k, v, pos)
    assert LAUNCHES["attention_step"] == 0
    assert LAUNCHES["batched_decode_attention"] == 0


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("H,n_kv,D", [(4, 4, 128), (8, 2, 128), (32, 4, 64)])
@pytest.mark.parametrize("positions", [(0,), (150,), (0, 201)])
def test_prefill_attention_matches_plain(gen, quant, H, n_kv, D, positions):
    """MHA and GQA, bf16 and int8, a block at position 0, one mid-window,
    and two slots at different positions; T = 80 leaves a partial query
    tile, and attn_len 320 stops short of the 384-row cache."""
    B, S, T, attn_len = len(positions), 384, 80, 320
    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
    q = _randn(gen, B, T, H, D)
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
    args = (q, kc, vc, pos, ks, vs)
    reset_launches()
    got = prefill_attention(*args, attn_len=attn_len)
    want = prefill_attention(*args, attn_len=attn_len, plain=True)
    torch.cuda.synchronize()
    assert LAUNCHES["prefill_attention"] == 1
    assert got.shape == (B, T, H, D) and got.dtype == torch.float32
    _close(got, want, **INT4)


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
    assert VARIANT_LAUNCHES["int4_matmul_fused/gemv/prescale/m1/256x512"] == (
        5 * _CFG.n_layers)
    assert VARIANT_LAUNCHES["dense_gemv/bf16/m1/512x256"] == 5
    for kernel, n in LAUNCHES.items():
        assert n == sum(v for k, v in VARIANT_LAUNCHES.items()
                        if k.startswith(kernel + "/"))


@pytest.mark.parametrize("attn_impl,kv", [
    ("fused_step", 4), ("auto", 4), ("batched", 0), ("batched", 8),
    ("batched_static", 0)])
def test_forward_new_paths_on_card_matches_cpu(gen, attn_impl, kv):
    """The int4 cache (attention_step_kv4 under fused_step, plain
    split-plane attention under auto at this window) and the batched
    kernel over bf16 and int8 caches, five steps on the card against the
    CPU; the same bar as test_forward_on_card_matches_cpu."""
    ckpt = random_checkpoint(_CFG, seed=3)
    out = {}
    for dev in ("cpu", "cuda"):
        p = params_from_checkpoint(ckpt, device=dev)
        c = init_kv_cache(_CFG, 1, 256, quantized=kv > 0,
                          kv_bits=4 if kv == 4 else 8, device=dev)
        reset_launches()
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
    want = 5 * _CFG.n_layers
    assert LAUNCHES["attention_step_kv4"] == (
        want if attn_impl == "fused_step" else 0)
    assert LAUNCHES["batched_decode_attention"] == (
        want if attn_impl.startswith("batched") else 0)
    assert LAUNCHES["attention_step"] == 0


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_spec_engine_on_card_matches_plain(gen, temperature):
    """The speculative stream on the card is the plain stream on the card:
    verify blocks of T = 5 against T = 1 steps, greedy and sampled."""
    params = params_from_checkpoint(random_checkpoint(_CFG, seed=4))
    prompt = [1, 5, 9, 13, 7, 5, 9, 13]
    streams = []
    for spec in (None, "ngram"):
        eng = InferenceEngine(params, _CFG, None, temperature=temperature,
                              seed=7, spec=spec, spec_k=4, max_seq=128)
        streams.append(eng.generate_benchmark(prompt, 80)[0])
    assert streams[0] == streams[1]
    assert eng.spec_stats["verifies"] > 0


@pytest.mark.parametrize("quantized", [False, True])
def test_block_prefill_on_card_matches_cpu(gen, quantized):
    """A 150-token prompt through block prefill (a full block and a padded
    one): the kernels on the card against the plain versions on the CPU,
    with prefill_attention and the GEMM on the path."""
    ckpt = random_checkpoint(_CFG, seed=3)
    prompt = [1 + (7 * i) % 500 for i in range(150)]
    out = {}
    for dev in ("cpu", "cuda"):
        eng = InferenceEngine(params_from_checkpoint(ckpt, device=dev), _CFG,
                              None, kv_quant=quantized, device=dev)
        reset_launches()
        out[dev] = eng._prefill(prompt, collect_logits=True)
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=2e-2, atol=2e-2)
    assert LAUNCHES["prefill_attention"] == 2 * _CFG.n_layers
    assert VARIANT_LAUNCHES[
        "int4_matmul_fused/gemm/prescale/m128/256x512"] == 2 * _CFG.n_layers
    assert VARIANT_LAUNCHES["dense_gemv/bf16/m128/512x256"] == 2


def test_engine_generates_on_card(gen):
    params = params_from_checkpoint(random_checkpoint(_CFG, seed=4))
    eng = InferenceEngine(params, _CFG, None, temperature=0.0)
    toks, _, _ = eng.generate_benchmark([1, 5, 9], 40)
    assert len(toks) == 38
    assert all(0 <= t < _CFG.vocab_size for t in toks)


@pytest.mark.parametrize("m", [1, 3, 11])
def test_down_qkv_matches_plain_and_gemv_pair(gen, m):
    """The chained down->qkv launch against its plain version (the int4
    bar) and bit for bit against the standalone GEMV launches it replaces
    (each column sums in the GEMV's order, each row's rms scale in
    rms_scale's); 11 rows take two passes of 8."""
    from llama_cu_awq_torch.ops.cuda.down_qkv import down_qkv_fused
    from llama_cu_awq_torch.ops.cuda.int4_matmul import _launch

    hid, dim, n_q = 384, 256, 320
    wd, wq = _qtensor(gen, hid, dim), _qtensor(gen, dim, n_q)
    g, u = _randn(gen, m, 2 * hid).chunk(2, dim=-1)
    res = _randn(gen, m, dim)
    nw = torch.rand(dim, device="cuda", generator=gen) + 0.5
    for out_dtype in (torch.bfloat16, torch.float32):
        reset_launches()
        x2, ss2, qkv = down_qkv_fused(g, u, res, wd, wq, nw, eps=1e-5,
                                      out_dtype=out_dtype)
        assert LAUNCHES["down_qkv"] == 1 and LAUNCHES["int4_matmul_fused"] == 0
        rx2, rss2, rqkv = down_qkv_fused(g, u, res, wd, wq, nw, eps=1e-5,
                                         out_dtype=out_dtype, plain=True)
        px2, pss2 = _launch(g, wd, u2=u, res=res, out_dtype=torch.bfloat16,
                            eps=1e-5, kernel="gemv")
        pqkv, _ = _launch(px2, wq, ss=pss2.reshape(m), nw=nw,
                          out_dtype=out_dtype, kernel="gemv")
        torch.cuda.synchronize()
        assert qkv.shape == (m, n_q) and qkv.dtype == out_dtype
        _close(qkv, rqkv, **INT4)
        _close(x2, rx2, **INT4)
        assert torch.equal(x2, px2) and torch.equal(qkv, pqkv)
        assert torch.equal(ss2.reshape(-1), pss2.reshape(-1))


@pytest.mark.parametrize("chain", [False, True])
def test_batch_engine_on_card_matches_single_engine(gen, monkeypatch, chain):
    """A BatchEngine on the card (3 slots, 4 requests, fused_step
    attention) gives each request the single-sequence engine's greedy
    stream; with LLAMA_TPU_DOWN_QKV=1 the chain runs at m=3 and changes
    nothing."""
    from llama_cu_awq_torch.engine import BatchEngine

    monkeypatch.setenv("LLAMA_TPU_DOWN_QKV", "1" if chain else "0")
    params = params_from_checkpoint(random_checkpoint(_CFG, seed=4))
    prompts = [[1, 5, 9, 100], [1, 42], [1, 7, 8, 9, 10, 11, 12], [1, 250]]
    reset_launches()
    be = BatchEngine(params, _CFG, None, n_slots=3, max_seq=128,
                     chunk_size=4, attn_impl="fused_step")
    rids = [be.submit(p, max_new=12) for p in prompts]
    out = be.run()
    assert (LAUNCHES["down_qkv"] > 0) == chain
    assert LAUNCHES["attention_step"] > 0
    for rid, p in zip(rids, prompts):
        eng = InferenceEngine(params, _CFG, None, temperature=0.0,
                              attn_impl="fused_step", max_seq=128)
        want = eng.generate_benchmark(p, len(p) + 11)[0]
        got = out[rid]
        assert got == want[:len(got)]
        assert len(got) == 12 or want[len(got)] == 2  # EOS ends it early


def test_batch_dispatch_does_not_sync(gen):
    """Dispatching a chunk while another is in flight synchronizes with
    neither the stream nor the device (sync debug mode "error" raises on
    either), so run()'s next chunk queues behind the one in flight; a
    sampled request draws its coins in the same dispatch."""
    from llama_cu_awq_torch.engine import BatchEngine

    params = params_from_checkpoint(random_checkpoint(_CFG, seed=4))
    be = BatchEngine(params, _CFG, None, n_slots=3, max_seq=128,
                     chunk_size=4, attn_impl="fused_step")
    be.submit([1, 5, 9, 100], max_new=16)
    be.submit([1, 42], max_new=16, temperature=0.8)
    be.step()
    first = be._dispatch_chunk()
    torch.cuda.set_sync_debug_mode("error")
    try:
        second = be._dispatch_chunk()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert be._process_chunk(first) and be._process_chunk(second)


def _chain_close(got, want):
    """The chain kernels against their plain versions: the int4 bar per
    stage, plus one bf16 ulp at the output's largest magnitude. Kernel and
    plain sum each stage in another f32 order, so a bf16 row of one stage
    (x1, gate_up, the attention rows) may round one ulp apart, and
    out = down + x1 carries a flip of x1 unchanged."""
    top = float(want.float().abs().max())
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0
    _close(got, want, rtol=INT4["rtol"], atol=INT4["atol"] + ulp)


def _chain_case(gen, m, n_o, dim, hid, n_q):
    """Weights and rows for the chain kernels: W_o, W_gate_up, W_down and
    (n_q > 0) the next W_qkv; attn, x_res and the two rms weights."""
    ws = [_qtensor(gen, n_o, dim), _qtensor(gen, dim, 2 * hid),
          _qtensor(gen, hid, dim)]
    kw = {}
    if n_q:
        kw = dict(wqkv_next=_qtensor(gen, dim, n_q),
                  attn_norm_next=torch.rand(dim, device="cuda",
                                            generator=gen) + 0.5)
    nw = torch.rand(dim, device="cuda", generator=gen) + 0.5
    return ws, nw, kw, _randn(gen, m, n_o), _randn(gen, m, dim)


def _gemv_sequence(attn, x, nw, wo, wgu, wd, wqkv_next=None,
                   attn_norm_next=None):
    """The standalone launches the chain replaces, forced onto the GEMV
    (not counted): o with the residual, rms_scale, gate_up with the
    rmsnorm prologue, down with SwiGLU and the residual, rms_scale, and
    the next qkv with the rmsnorm prologue."""
    from llama_cu_awq_torch.ops.cuda.int4_matmul import _launch

    m = attn.shape[0]
    bf16 = torch.bfloat16
    x1, ss1 = _launch(attn, wo, res=x, out_dtype=bf16, eps=1e-5,
                      kernel="gemv")
    gu, _ = _launch(x1, wgu, ss=ss1.reshape(m), nw=nw, out_dtype=bf16,
                    kernel="gemv")
    g, u = gu.chunk(2, dim=-1)
    out, ss = _launch(g, wd, u2=u, res=x1, out_dtype=bf16, eps=1e-5,
                      kernel="gemv")
    if wqkv_next is None:
        return out, ss
    qkv, _ = _launch(out, wqkv_next, ss=ss.reshape(m), nw=attn_norm_next,
                     out_dtype=bf16, kernel="gemv")
    return out, ss, qkv


@pytest.mark.parametrize("has_qkv", [False, True])
@pytest.mark.parametrize("m", [1, 3, 8, 11])
def test_ffn_chain_matches_plain_and_gemv_sequence(gen, m, has_qkv):
    """The chain in one launch against its plain version (the int4 bar)
    and bit for bit against the GEMV launches it replaces (each column
    sums in the GEMV's order, each rms scale in rms_scale's); 11 rows
    take two passes of 8."""
    from llama_cu_awq_torch.experiments.int4_chain import ffn_chain

    ws, nw, kw, attn, x = _chain_case(gen, m, 256, 288, 384,
                                      320 if has_qkv else 0)
    reset_launches()
    got = ffn_chain(attn, x, nw, *ws, eps=1e-5, **kw)
    assert LAUNCHES["ffn_chain"] == 1 and LAUNCHES["int4_matmul_fused"] == 0
    ref = ffn_chain(attn, x, nw, *ws, eps=1e-5, plain=True, **kw)
    seq = _gemv_sequence(attn, x, nw, *ws, **kw)
    torch.cuda.synchronize()
    assert len(got) == len(ref) == len(seq) == (3 if has_qkv else 2)
    for a, b, c in zip(got, ref, seq):
        _chain_close(a, b)
        assert torch.equal(a, c.reshape(a.shape))


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("B", [1, 3, 8, 11])
def test_mono_layer_matches_plain_and_launch_sequence(gen, B, quant):
    """The whole layer in one launch against its plain version, and
    against the launch sequence: attention_step's new rows and scales bit
    for bit (the same phase 1), and the GEMV launches of the chain over
    the attention rows walked unsplit as mono walks them, rounded to bf16,
    to the chain bar; GQA 4/2 over a 200-row cache (positions from 0 up,
    a window of 160 rows), bf16 and int8."""
    from llama_cu_awq_torch.experiments.int4_chain import mono_layer

    H, n_kv, D, S, win = 4, 2, 128, 200, 160
    ws, nw, kw, _, x = _chain_case(gen, B, H * D, 256, 384,
                                   (H + 2 * n_kv) * D)
    qkv = _randn(gen, B, (H + 2 * n_kv) * D)
    pos = torch.tensor([(0, 150, 199, 37, 64, 128, 159, 1, 100, 63,
                         65)[b] for b in range(B)], dtype=torch.int32,
                       device="cuda")
    cos2, sinm = rope_rows(pos, D, 10000.0)
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
    args = (qkv, x, nw, *ws, kc, vc, pos, cos2, sinm, ks, vs)
    reset_launches()
    got = mono_layer(*args, n_heads=H, attn_len=win, eps=1e-5, **kw)
    assert LAUNCHES["mono_layer"] == 1 and LAUNCHES["attention_step"] == 0
    ref = mono_layer(*args, n_heads=H, attn_len=win, eps=1e-5, plain=True,
                     **kw)
    window = [t[:, :win].contiguous() if t is not None else None
              for t in (kc, vc, ks, vs)]
    _, kn, vn, ksn, vsn = attention_step(qkv, window[0], window[1], pos,
                                         cos2, sinm, *window[2:], n_heads=H)
    # the attention rows walked unsplit, as mono's stage walks them (the
    # split attention_step rounds p against other maxima)
    attn = attention_step_plain(qkv, window[0], window[1], pos, cos2, sinm,
                                *window[2:], n_heads=H, split=False)[0]
    seq = _gemv_sequence(attn.reshape(B, H * D).bfloat16(), x, nw, *ws,
                         **kw)
    torch.cuda.synchronize()
    want = seq[:2] + (kn, vn, ksn, vsn) + seq[2:]
    assert len(got) == len(ref) == len(want) == 7
    for i, (a, b, c) in enumerate(zip(got, ref, want)):
        if c is None:
            assert a is None and b is None
            continue
        if i in (2, 3, 4, 5):  # new rows and scales: same IEEE arithmetic
            assert torch.equal(a, b)
            assert torch.equal(a, c.reshape(a.shape))
        else:
            _chain_close(a, b)
            _chain_close(a, c.reshape(a.shape))


def test_cooperative_kernels_raise_where_not_co_resident(gen, monkeypatch):
    """A launch whose blocks cannot be resident (here 8 rows of a
    14336-wide down staged at once: 244 KB of shared memory, more than a
    block's 227 KB) is refused by the C launcher, and the wrapper raises;
    the next launches, PyTorch's included, run and are right (the
    refusal's error was cleared). The int4 cache raises ValueError before
    any launch."""
    from llama_cu_awq_torch.experiments import int4_chain
    from llama_cu_awq_torch.ops.cuda import down_qkv

    ws, nw, _, attn, x = _chain_case(gen, 8, 64, 64, 14336, 0)
    g, u = _randn(gen, 8, 2 * 14336).chunk(2, dim=-1)
    wq = _qtensor(gen, 64, 96)
    for mod in (int4_chain, down_qkv):
        monkeypatch.setattr(mod, "rows_per_pass", lambda m, n_in: min(m, 8))
    with pytest.raises(RuntimeError, match="ffn_chain failed"):
        int4_chain.ffn_chain(attn, x, nw, *ws, eps=1e-5)
    assert float((x.float() * 2).sum().isfinite())
    with pytest.raises(RuntimeError, match="down_qkv failed"):
        down_qkv.down_qkv_fused(g, u, x, ws[2], wq, nw, eps=1e-5)
    monkeypatch.undo()
    got = int4_chain.ffn_chain(attn, x, nw, *ws, eps=1e-5)
    ref = int4_chain.ffn_chain(attn, x, nw, *ws, eps=1e-5, plain=True)
    dq = down_qkv.down_qkv_fused(g, u, x, ws[2], wq, nw, eps=1e-5)
    dq_ref = down_qkv.down_qkv_fused(g, u, x, ws[2], wq, nw, eps=1e-5,
                                     plain=True)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        _chain_close(a, b)
    for a, b in zip(dq, dq_ref):
        _close(a, b, **INT4)

    H, n_kv, D = 2, 2, 32
    ws, nw, _, _, x = _chain_case(gen, 1, H * D, 64, 96, 0)
    kv4 = torch.zeros(1, 16, n_kv, D // 2, dtype=torch.int8, device="cuda")
    sc = torch.ones(1, 16, n_kv, device="cuda")
    pos = torch.tensor([3], dtype=torch.int32, device="cuda")
    cos2, sinm = rope_rows(pos, D, 10000.0)
    with pytest.raises(ValueError, match="int4"):
        int4_chain.mono_layer(_randn(gen, 1, (H + 2 * n_kv) * D), x, nw,
                              *ws, kv4, kv4, pos, cos2, sinm, sc, sc,
                              n_heads=H, eps=1e-5)


@pytest.mark.parametrize("quantized", [False, True])
def test_decode_step_on_card_equals_forward(gen, quantized):
    """Whole decode steps composed through ffn_chain give
    forward(attn_impl="fused_step")'s logits and cache bit for bit on the
    card, at B=2, launching their kernels once a layer; through mono_layer
    (attention walked unsplit) the logits agree to the bar of two paths
    that round differently (tests/test_fused_path.py:51-52) and every new
    cache row of layer 0 is bit-equal."""
    from llama_cu_awq_torch.experiments import int4_chain

    cfg = ModelConfig(dim=256, hidden_dim=384, n_layers=2, n_heads=2,
                      n_kv_heads=2, vocab_size=512, seq_len=256)
    params = params_from_checkpoint(random_checkpoint(cfg, seed=3))
    caches = {k: init_kv_cache(cfg, 2, 256, quantized=quantized)
              for k in ("forward",) + int4_chain.LAYER_IMPLS}
    for step, t in enumerate([1, 7, 42, 3, 200]):
        tok = torch.tensor([[t], [t + 1]], device="cuda")
        pos = torch.tensor([step, step + 30], dtype=torch.int32,
                           device="cuda")
        want, _ = forward(params, cfg, tok, pos, caches["forward"],
                          attn_impl="fused_step")
        for impl in int4_chain.LAYER_IMPLS:
            reset_launches()
            got, _ = int4_chain.decode_step(params, cfg, tok, pos,
                                            caches[impl], layer_impl=impl)
            kernel = "mono_layer" if impl == "mono" else "ffn_chain"
            assert LAUNCHES[kernel] == cfg.n_layers
            if impl == "mono":
                torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)
            else:
                assert torch.equal(got, want), impl
    for impl in int4_chain.LAYER_IMPLS:
        c, r = caches[impl], caches["forward"]
        for i, (a, b) in enumerate(zip(c.k + c.v + c.k_scale + c.v_scale,
                                       r.k + r.v + r.k_scale + r.v_scale)):
            if impl != "mono" or i % cfg.n_layers == 0:  # layer 0's rows
                assert torch.equal(a, b)
            elif a.dtype == torch.int8:  # codes: at most one apart
                torch.testing.assert_close(a.float(), b.float(), rtol=0,
                                           atol=1)
            else:  # bf16 rows and the scales
                torch.testing.assert_close(a.float(), b.float(), rtol=2e-2,
                                           atol=2e-2)
