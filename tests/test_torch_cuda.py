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
from llama_cu_awq_torch.ops.cuda.prefill_attention import (
    SPLIT_ROWS as PFA_SPLIT)
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
@pytest.mark.parametrize("m", [1, 2, 3, 5, 7, 8, 11])
@pytest.mark.parametrize("n_in,n_out", [(320, 200), (288, 40), (352, 23)])
def test_int4_matmul_fused_matches_plain(gen, variant, m, n_in, n_out):
    """Every row count of the GEMV's tile (1 to 8 in one pass, 11 in two)
    at widths whose last 128-row group is partial (n_in % 128 of 64, 32
    and 96) and whose last 16-column tile is partial (n_out % 16 of 8, 8
    and 7)."""
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
@pytest.mark.parametrize("m", [GEMM_MIN_M, 65, 100, 128, 200])
@pytest.mark.parametrize("n_in,n_out", [(320, 200), (2048, 384),
                                        (11008, 200)])
def test_int4_gemm_matches_plain(gen, variant, m, n_in, n_out):
    """The wgmma GEMM from GEMM_MIN_M rows on: the four prologue and
    epilogue forms, partial and whole 128-row tiles of x and 200 rows (a
    partial second tile), over a partial last group (320), two splits of
    the groups (2048) and 86 groups in ten splits (11008, down's n_in),
    with column counts that are not a multiple of the 128-column tile;
    the SwiGLU form also from the gate and up halves of one (m, 2 * n_in)
    tensor, as the forward passes them."""
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


@pytest.mark.parametrize("variant", ["prescale", "residual", "silu"])
@pytest.mark.parametrize("n_in,n_out", [(320, 200), (2048, 384)])
def test_int4_gemm_rows_are_independent_and_repeatable(gen, variant, n_in,
                                                       n_out):
    """The first GEMM_MIN_M, 65 and 100 rows of a 128-row GEMM call, each
    called alone, give the same bits as in the 128-row call (the order of
    every sum depends on the weight's shape, never on m), and a second
    128-row call gives the same bits as the first (no atomics), with one
    split and with two."""
    m = 128
    qt = _qtensor(gen, n_in, n_out)
    x = _randn(gen, m, n_in)
    kw = _fused_kwargs(gen, variant, m, n_in, n_out)

    def run(rows):
        k = {name: ((v[0][:rows], v[1]) if name == "prescale"
                    else v[:rows] if isinstance(v, torch.Tensor) else v)
             for name, v in kw.items()}
        return int4_matmul_fused(x[:rows], qt, **k)

    full = run(m)
    for rows in (GEMM_MIN_M, 65, 100, m):
        for a, b in zip(full, run(rows)):
            if a is not None:
                assert torch.equal(a[:rows], b), (
                    f"the first {rows} rows differ from the 128-row call")


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
@pytest.mark.parametrize("m", [1, 5, 8, 9, 16, 128, 200])
def test_dense_gemv_matches_plain(gen, int8, m):
    """The tile kernel at every m: a 1000-row head (a ragged last tile of
    104 vocab rows), 5, 9 and 200 rows of x (ragged column tiles; 200
    takes two), d = 256 (four K stages)."""
    w = (_randn(gen, 1000, 256, dtype=torch.float32) * 0.05).bfloat16()
    args = (quantize_dense_int8(w).w8, quantize_dense_int8(w).scale) \
        if int8 else (w,)
    x = _randn(gen, m, 256)
    want = dense_gemv(x, *args, plain=True)
    # operands widen exactly to f32; only the order of f32 sums differs
    _close(dense_gemv(x, *args), want, rtol=1e-3, atol=1e-4)


def test_dense_gemv_counts_one_launch_per_call(gen):
    """The 128-row head (a prefill block, perplexity), decode's one row
    and the serving step's 8 each launch the tile kernel once."""
    w = _randn(gen, 1000, 256)
    reset_launches()
    for m in (128, 1, 8):
        dense_gemv(_randn(gen, m, 256), w)
    assert VARIANT_LAUNCHES == {f"dense_gemv/bf16/m{m}/1000x256": 1
                                for m in (128, 1, 8)}


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
    that starts off a 16-byte boundary raises before any launch, mono_layer's
    cooperative one included."""
    from llama_cu_awq_torch.experiments.int4_chain import mono_layer

    B, S, n_kv, H, D = 1, 64, 2, 4, 128
    n = B * S * n_kv * D
    k = _randn(gen, n + 8)[7:n + 7].view(B, S, n_kv, D)
    v = _randn(gen, B, S, n_kv, D)
    pos = torch.tensor([5], dtype=torch.int32, device="cuda")
    cos2, sinm = rope_rows(pos, D, 10000.0)
    qkv = _randn(gen, B, (H + 2 * n_kv) * D)
    ws, nw, kw, _, x = _chain_case(gen, B, H * D, 256, 384,
                                   (H + 2 * n_kv) * D)
    reset_launches()
    with pytest.raises(ValueError, match="aligned"):
        attention_step(qkv, k, v, pos, cos2, sinm, n_heads=H)
    with pytest.raises(ValueError, match="aligned"):
        batched_decode_attention(_randn(gen, B, H, D), k, v, pos)
    with pytest.raises(ValueError, match="aligned"):
        mono_layer(qkv, x, nw, *ws, k, v, pos, cos2, sinm, n_heads=H,
                   eps=1e-5, **kw)
    assert LAUNCHES["attention_step"] == 0
    assert LAUNCHES["batched_decode_attention"] == 0
    assert LAUNCHES["mono_layer"] == 0


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("H,n_kv,D", [(4, 4, 128), (8, 2, 128), (32, 4, 64)])
@pytest.mark.parametrize("positions", [
    (0,), (150,), (0, 201), (PFA_SPLIT - 80,), (PFA_SPLIT - 79, 0)])
def test_prefill_attention_matches_plain(gen, quant, H, n_kv, D, positions):
    """MHA and GQA, bf16 and int8, a block at position 0, one mid-window,
    two slots at different positions, and blocks whose last key (pos + T
    - 1) is the last row of the first split and the first row of the
    second; T = 80 leaves a partial query tile, and attn_len 320 stops
    short of the 384-row cache."""
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
                                                 dtype=torch.float64))
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


@pytest.mark.parametrize("kernel", ["gemv_prescale", "gemv_residual",
                                    "gemv_silu", "down_qkv", "ffn_chain"])
def test_rows_match_single_row_calls(gen, kernel):
    """Each row of an 8-row call bit for bit against the call on that row
    alone: the tile's sums depend on n_in alone (csrc/int4_gemv.cuh), not
    on the rows beside a row, the grid or the pass."""
    from llama_cu_awq_torch.experiments.int4_chain import ffn_chain
    from llama_cu_awq_torch.ops.cuda.down_qkv import down_qkv_fused

    m, n_in, n_out = 8, 352, 200
    if kernel.startswith("gemv"):
        qt = _qtensor(gen, n_in, n_out)
        x = _randn(gen, m, n_in)
        kw = _fused_kwargs(gen, kernel[5:], m, n_in, n_out)

        def run(r):
            k = {name: ((v[0][r], v[1]) if name == "prescale"
                        else v[r] if isinstance(v, torch.Tensor) else v)
                 for name, v in kw.items()}
            return int4_matmul_fused(x[r], qt, **k)
    elif kernel == "down_qkv":
        hid, dim, n_q = 352, 288, 200
        wd, wq = _qtensor(gen, hid, dim), _qtensor(gen, dim, n_q)
        g, u = _randn(gen, m, 2 * hid).chunk(2, dim=-1)
        res = _randn(gen, m, dim)
        nw = torch.rand(dim, device="cuda", generator=gen) + 0.5

        def run(r):
            return down_qkv_fused(g[r], u[r], res[r], wd, wq, nw, eps=1e-5)
    else:
        ws, nw, kw, attn, x = _chain_case(gen, m, 256, 288, 352, 200)

        def run(r):
            return ffn_chain(attn[r], x[r], nw, *ws, eps=1e-5, **kw)
    full = run(slice(0, m))
    for i in range(m):
        one = run(slice(i, i + 1))
        for a, b in zip(full, one):
            if a is None:
                assert b is None
                continue
            assert torch.equal(a.reshape(m, -1)[i], b.reshape(-1)), (
                f"row {i} of {kernel} differs from its single-row call")


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
    """The whole layer in one launch against its plain version (the chain
    bar; new rows and scales bit for bit) and bit for bit against the
    launch sequence it replaces (attention_step's split kernel, then the
    GEMV launches of the chain over its rows rounded to bf16), whose
    attention rows agree with the unsplit walk to bf16 rounding of p (the
    int4 bar; through the chain a one-ulp flip of an attention row grows
    past the chain bar: 22 of 3072 qkv values at B=3); GQA 4/2 over a
    420-row cache (positions from 0 up, a window of 400 rows: up to 4
    splits), bf16 and int8."""
    from llama_cu_awq_torch.experiments.int4_chain import mono_layer

    H, n_kv, D, S, win = 4, 2, 128, 420, 400
    ws, nw, kw, _, x = _chain_case(gen, B, H * D, 256, 384,
                                   (H + 2 * n_kv) * D)
    qkv = _randn(gen, B, (H + 2 * n_kv) * D)
    pos = torch.tensor([(0, 350, 419, 37, 264, 128, 259, 1, 300, 63,
                         385)[b] for b in range(B)], dtype=torch.int32,
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
    attn, kn, vn, ksn, vsn = attention_step(qkv, window[0], window[1], pos,
                                            cos2, sinm, *window[2:],
                                            n_heads=H)
    seq = _gemv_sequence(attn.reshape(B, H * D).bfloat16(), x, nw, *ws,
                         **kw)
    unsplit = attention_step_plain(qkv, window[0], window[1], pos, cos2,
                                   sinm, *window[2:], n_heads=H,
                                   split=False)[0]
    torch.cuda.synchronize()
    _close(attn, unsplit, **INT4)
    want = seq[:2] + (kn, vn, ksn, vsn) + seq[2:]
    assert len(got) == len(ref) == len(want) == 7
    for i, (a, b, c) in enumerate(zip(got, ref, want)):
        if c is None:
            assert a is None and b is None
            continue
        assert torch.equal(a, c.reshape(a.shape)), i
        if i in (2, 3, 4, 5):  # new rows and scales: same IEEE arithmetic
            assert torch.equal(a, b)
        else:
            _chain_close(a, b)


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
    """Whole decode steps composed through ffn_chain and through
    mono_layer give forward(attn_impl="fused_step")'s logits and cache bit
    for bit on the card, at B=2, launching their kernels once a layer."""
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
            assert torch.equal(got, want), impl
    for impl in int4_chain.LAYER_IMPLS:
        c, r = caches[impl], caches["forward"]
        for a, b in zip(c.k + c.v + c.k_scale + c.v_scale,
                        r.k + r.v + r.k_scale + r.v_scale):
            assert torch.equal(a, b), impl


# ---------------------------------------------------------------------------
# the engine's CUDA graphs (engine/graphs.py) against eager launches

_CFG2K = ModelConfig(dim=256, hidden_dim=384, n_layers=2, n_heads=2,
                     n_kv_heads=1, vocab_size=512, seq_len=2048)


def _counted(fn):
    """fn()'s result and the launches it counted, the device idle after."""
    reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(LAUNCHES), dict(VARIANT_LAUNCHES)


def _caches_equal(a, b):
    for x, y in zip(a.cache.k + a.cache.v + a.cache.k_scale + a.cache.v_scale,
                    b.cache.k + b.cache.v + b.cache.k_scale + b.cache.v_scale):
        assert torch.equal(x, y)


def _graph_and_eager(fn, params, cfg, **kw):
    """fn(engine) on an engine that replays graphs and on one that launches
    eagerly: equal results, caches and launch counts, bit for bit.
    Returns the graph engine and its launches per kernel."""
    engines = [InferenceEngine(params, cfg, None, capture=c, **kw)
               for c in (True, False)]
    got, want = [_counted(lambda e=e: fn(e)) for e in engines]
    if torch.is_tensor(want[0]):
        assert torch.equal(got[0], want[0])
    else:
        assert got[0] == want[0]
    assert got[1:] == want[1:]
    _caches_equal(*engines)
    assert engines[0]._graphs.graphs and engines[1]._graphs is None
    return engines[0], got[1]


@pytest.mark.parametrize("temperature", [0.0, 0.5])
def test_graph_decode_matches_eager(gen, temperature):
    """Greedy and sampled (topp 0.6) decode across the 128 and 256 buckets
    in chunks of 16 with a short last one, then reset() and a second
    prompt, which replays the same graphs after the other bucket's ran in
    the pool: one graph per kind and bucket, none per chunk length."""
    params = params_from_checkpoint(random_checkpoint(_CFG, seed=4))

    def run(e):
        a = e.generate_benchmark([1, 5, 9, 13, 7], 203)[0]
        b = e.generate_benchmark([1, 42, 7], 150)[0]
        return a + b

    eng, _ = _graph_and_eager(run, params, _CFG, temperature=temperature,
                              topp=0.6, seed=11)
    kinds = [(k[0], k[2]) for k in eng._graphs.graphs]
    assert sorted(map(repr, kinds)) == sorted(map(repr, [
        ("decode", 128), ("decode", 256), (("prompt", False), 128)]))


@pytest.mark.parametrize("kv", [0, 8, 4])
def test_graph_fused_step_2048_matches_eager(gen, kv):
    """fused_step over bf16, int8 and int4 caches: a 1100-token prompt in 9
    blocks (the last padded), then 40 steps at the 2048 bucket."""
    params = params_from_checkpoint(random_checkpoint(_CFG2K, seed=5))
    prompt = [1] + [3 + (7 * i) % 500 for i in range(1099)]
    eng, _ = _graph_and_eager(
        lambda e: e.generate_benchmark(prompt, 1140)[0], params, _CFG2K,
        temperature=0.0, attn_impl="fused_step",
        kv_quant=4 if kv == 4 else bool(kv))
    assert any(k[0] == "decode" and k[2] == 2048 for k in eng._graphs.graphs)


@pytest.mark.parametrize("impl", ["batched", "batched_static"])
def test_graph_batched_matches_eager(gen, impl):
    params = params_from_checkpoint(random_checkpoint(_CFG, seed=4))
    _graph_and_eager(lambda e: e.generate_benchmark([1, 5, 9], 60)[0],
                     params, _CFG, temperature=0.0, attn_impl=impl,
                     max_seq=128)


def test_graph_down_qkv_matches_eager(gen, monkeypatch):
    """LLAMA_TPU_DOWN_QKV=1 under fused_step: the cooperative chain launch
    inside the graphs, a graph of its own beside the standalone pair's."""
    params = params_from_checkpoint(random_checkpoint(_CFG, seed=4))

    def run(e):
        out = []
        for on in ("1", "0", "1"):
            monkeypatch.setenv("LLAMA_TPU_DOWN_QKV", on)
            out += e.generate_benchmark([1, 5, 9, 13], 40)[0]
        return out

    eng, launches = _graph_and_eager(run, params, _CFG, temperature=0.0,
                                     attn_impl="fused_step", max_seq=128)
    assert launches["down_qkv"] > 0
    decode = [k for k in eng._graphs.graphs if k[0] == "decode"]
    assert sorted(k[3].dq_chain for k in decode) == [False, True]


@pytest.mark.parametrize("quantized", [False, True])
def test_graph_prefill_and_perplexity_match_eager(gen, quantized):
    """A 3-block prompt (the last block padded, the head on it) and the
    perplexity of a 300-token sequence (the head on every block): equal
    logits, perplexities, caches and launches. The GEMM's tensor maps,
    baked into the block graphs, stay right after the other graphs ran."""
    from llama_cu_awq_torch.engine.perplexity import token_perplexity

    params = params_from_checkpoint(random_checkpoint(_CFG2K, seed=6))
    prompt = [1] + [3 + (11 * i) % 500 for i in range(299)]

    def run(e):
        last = e._prefill(prompt)
        ppl = token_perplexity(e, prompt[1:])
        e.reset()
        return torch.cat([last.cpu(), e._prefill(prompt).cpu(),
                          torch.tensor([ppl])])

    _graph_and_eager(run, params, _CFG2K, kv_quant=quantized,
                     temperature=0.0, max_seq=512)


def test_capture_survives_a_collection_of_old_graphs(gen, monkeypatch):
    """An old engine's graphs held only by a garbage cycle made as a
    capture begins, and the collector set to run at every allocation: the
    capture must not collect them (destroying a graph inside a capture
    invalidates it; engine/graphs.py collector_off), and they go at the
    first collection after."""
    import gc
    import weakref

    params = params_from_checkpoint(random_checkpoint(_CFG, seed=4))
    old = InferenceEngine(params, _CFG, None, temperature=0.0)
    want, _, _ = old.generate_benchmark([1, 5, 9], 24)
    doomed = list(old._graphs.graphs.values())
    old._graphs.graphs.clear()
    del old
    assert doomed
    refs = [weakref.ref(g) for g in doomed]
    begin = torch.cuda.CUDAGraph.capture_begin

    def capture_begin(self, *args, **kwargs):
        begin(self, *args, **kwargs)
        if doomed:  # the first capture: a young cycle holds them alone
            box = [doomed.copy()]
            box.append(box)
            doomed.clear()

    monkeypatch.setattr(torch.cuda.CUDAGraph, "capture_begin",
                        capture_begin)
    thresholds = gc.get_threshold()
    gc.set_threshold(1)
    try:
        eng = InferenceEngine(params, _CFG, None, temperature=0.0)
        got, _, _ = eng.generate_benchmark([1, 5, 9], 24)
    finally:
        gc.set_threshold(*thresholds)
    assert got == want
    gc.collect()
    assert all(r() is None for r in refs)


def test_capture_needs_the_split_scratch_sized(gen):
    """A GraphSet whose capture stream has no split scratch refuses to
    capture a fused_step forward (the scratch may not grow during a
    capture); sized with reserve_split_scratch, the same body captures
    and its replays match eager launches."""
    from llama_cu_awq_torch.engine.graphs import GraphSet
    from llama_cu_awq_torch.ops.cuda import attention_step as step_mod
    from llama_cu_awq_torch.ops.cuda.attention_step import (
        reserve_split_scratch)

    params = params_from_checkpoint(random_checkpoint(_CFG, seed=4))
    cache = init_kv_cache(_CFG, 1, 256)
    tok = torch.tensor([[7]], device="cuda")
    pos = torch.tensor([200], dtype=torch.int32, device="cuda")
    out = torch.zeros(_CFG.vocab_size, device="cuda")

    def body():
        logits, _ = forward(params, _CFG, tok, pos, cache, attn_len=256,
                            attn_impl="fused_step")
        out.copy_(logits[0])

    dev = torch.device("cuda", torch.cuda.current_device())
    unsized = GraphSet(dev, lambda: None)
    # PyTorch hands out pooled streams: drop what an earlier set left on
    # this one
    step_mod._SCRATCH.pop((dev, unsized.stream.cuda_stream), None)
    with pytest.raises(ValueError, match="sized before a CUDA graph"):
        unsized.run(("step",), body, 2)
    gs = GraphSet(dev, lambda: reserve_split_scratch(dev, 1, 1, 2, 128, 256))
    gs.run(("step",), body, 1)
    want = out.clone()
    gs.run(("step",), body, 2)
    torch.cuda.synchronize()
    assert torch.equal(out, want)


def _toy_tokenizer(path, vocab_size):
    """A tokenizer.bin in the reference's format: the special pieces, the
    256 single bytes and padding pieces."""
    import struct

    vocab = [(b"<unk>", 0.0), (b"<s>", 0.0), (b"</s>", 0.0)]
    vocab += [(bytes([b]), -1000.0) for b in range(256)]
    vocab += [(b"<pad%d>" % i, -2000.0)
              for i in range(vocab_size - len(vocab))]
    with open(path, "wb") as f:
        f.write(struct.pack("<i", max(len(p) for p, _ in vocab)))
        for piece, score in vocab:
            f.write(struct.pack("<fi", score, len(piece)))
            f.write(piece)
    return path


def test_graph_generate_and_chat_match_eager(gen, tmp_path):
    """generate() and two chat_turn()s, sampled: the same text, caches and
    launches from graphs as from eager launches."""
    from llama_cu_awq_torch.tokenizer import Tokenizer

    tok = Tokenizer(_toy_tokenizer(str(tmp_path / "tok.bin"),
                                   _CFG.vocab_size), _CFG.vocab_size)
    params = params_from_checkpoint(random_checkpoint(_CFG, seed=4))

    def run(e):
        e.tokenizer = tok
        text, _ = e.generate("the cat sat on the mat", steps=120)
        e.reset()
        return [text, e.chat_turn("the cat", "be brief", steps=60),
                e.chat_turn("sat on", None, steps=200)]

    eng, _ = _graph_and_eager(run, params, _CFG, temperature=0.5, topp=0.6,
                              seed=3)
    assert any(k[0] == "decode" for k in eng._graphs.graphs)


# ---------------------------------------------------------------------------
# BatchEngine's graphs and the speculative verify's, against eager launches

_LOOPY = [[1, 5, 9, 13, 5, 9, 13, 5, 9], [1, 42, 43, 42, 43, 42],
          [1, 7, 8, 9, 7, 8]]
# a prompt of more than one 128-token block: slot prefill, a prefix entry
_LONG = [1] + [(7 + 3 * i) % 200 for i in range(168)]


def _batch_graph_and_eager(fn, params, cfg, **kw):
    """fn(engine) on a BatchEngine that replays graphs and on one that
    launches eagerly: equal results, caches and launch counts, bit for
    bit. Returns the graph engine."""
    from llama_cu_awq_torch.engine import BatchEngine

    engines = [BatchEngine(params, cfg, None, capture=c, **kw)
               for c in (True, False)]
    got, want = [_counted(lambda e=e: fn(e)) for e in engines]
    assert got[0] == want[0]
    assert got[1:] == want[1:]
    _caches_equal(*engines)
    assert engines[0]._graphs.graphs and engines[1]._graphs is None
    return engines[0]


def _serve_all(prompts, max_new, temps=(0.0,)):
    def run(be):
        rids = [be.submit(p, max_new=max_new,
                          temperature=temps[i % len(temps)], topp=0.9)
                for i, p in enumerate(prompts)]
        out = be.run()
        return [out[r] for r in rids], be.rng.state
    return run


@pytest.mark.parametrize("attn_impl", [None, "fused_step"])
def test_batch_graph_mixed_sampling_matches_eager(gen, attn_impl):
    """Greedy and sampled requests (per-request temperature) over 3
    slots, decoding across the 128 and 256 buckets; the long prompt's
    slot prefill blocks too. One chunk graph per window and sampled, one
    prefill graph per slot, block width and window."""
    params = params_from_checkpoint(random_checkpoint(_CFG, seed=4))
    prompts = [[1, 5, 9, 100], [1, 42], _LONG, [1, 7, 8, 9, 10, 11, 12]]

    def run(be):  # mixed chunks, then all-greedy ones
        return (_serve_all(prompts, 100, temps=(0.0, 0.8))(be),
                _serve_all([[1, 42]], 8)(be))

    eng = _batch_graph_and_eager(run, params, _CFG, n_slots=3, max_seq=256,
                                 chunk_size=4, attn_impl=attn_impl)
    kinds = {k[0] for k in eng._graphs.graphs}
    assert {("chunk", True), ("chunk", False)} <= kinds
    assert any(k[0] == "prefill" for k in kinds)
    windows = {k[2] for k in eng._graphs.graphs if k[0][0] == "chunk"}
    assert windows == {128, 256}


def test_batch_graph_prefix_cache_and_reset_match_eager(gen):
    """A prefix-cache hit (the row copies stay eager), then reset() and
    the same requests again, replaying the graphs of the first run."""
    params = params_from_checkpoint(random_checkpoint(_CFG, seed=4))

    def run(be):
        outs = []
        for _ in range(2):
            be.reset()
            for p, t in ((_LONG, 0.0), (_LONG + [11, 12], 0.7),
                         ([1, 42], 0.7)):
                outs += _serve_all([p], 12, temps=(t,))(be)[0]
        return outs, be.stats()["prefix_cache"]

    eng = _batch_graph_and_eager(run, params, _CFG, n_slots=2, max_seq=256,
                                 chunk_size=4, prefix_cache_size=2)
    assert eng.stats()["prefix_cache"]["hits"] == 3


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_batch_graph_spec_matches_eager(gen, temperature):
    """spec="ngram" serving: (S, T) spec blocks, plain-chunk fallbacks
    with the carry seeded from the host, the long prompt's prefill."""
    params = params_from_checkpoint(random_checkpoint(_CFG, seed=4))

    def run(be):
        out = _serve_all(_LOOPY + [_LONG], 40, temps=(temperature,))(be)
        return out, be.spec_stats

    eng = _batch_graph_and_eager(run, params, _CFG, n_slots=3, max_seq=256,
                                 chunk_size=4, spec="ngram", spec_k=4)
    assert eng.spec_stats["blocks"] > 0
    assert any(k[0] == ("spec", temperature > 0) and k[1] == 5
               for k in eng._graphs.graphs)


def test_batch_graph_down_qkv_matches_eager(gen, monkeypatch):
    """LLAMA_TPU_DOWN_QKV=1 under fused_step: the m=3 chain launch inside
    the chunk graphs."""
    monkeypatch.setenv("LLAMA_TPU_DOWN_QKV", "1")
    params = params_from_checkpoint(random_checkpoint(_CFG, seed=4))
    _batch_graph_and_eager(_serve_all(_LOOPY + [[1, 250]], 20), params,
                           _CFG, n_slots=3, max_seq=128, chunk_size=4,
                           attn_impl="fused_step")
    reset_launches()
    from llama_cu_awq_torch.engine import BatchEngine
    be = BatchEngine(params, _CFG, None, n_slots=3, max_seq=128,
                     chunk_size=4, attn_impl="fused_step")
    _serve_all(_LOOPY, 8)(be)
    assert LAUNCHES["down_qkv"] > 0
    assert all(k[3].dq_chain for k in be._graphs.graphs
               if k[0][0] == "chunk")


@pytest.mark.parametrize("temperature", [0.0, 0.5])
def test_graph_spec_verify_matches_eager(gen, temperature):
    """InferenceEngine spec decode, greedy and sampled (peeked coins):
    the verifies replay one graph per window."""
    params = params_from_checkpoint(random_checkpoint(_CFG, seed=4))
    prompt = [1, 5, 9, 13, 7, 5, 9, 13] * 4

    def run(e):
        toks = e.generate_benchmark(prompt, 200)[0]
        return toks, e.spec_stats, e.rng.state

    eng, _ = _graph_and_eager(run, params, _CFG, temperature=temperature,
                              topp=0.9, seed=5, spec="ngram", spec_k=4)
    assert any(k[0] == "verify" and k[1] == 5 for k in eng._graphs.graphs)


def test_batch_capture_needs_the_split_scratch_for_all_slots(gen):
    """A BatchEngine whose capture stream has the split scratch of one
    slot only refuses to capture its 3-slot fused_step chunk."""
    from llama_cu_awq_torch.engine import BatchEngine
    from llama_cu_awq_torch.engine.graphs import GraphSet
    from llama_cu_awq_torch.ops.cuda import attention_step as step_mod
    from llama_cu_awq_torch.ops.cuda.attention_step import (
        reserve_split_scratch)

    params = params_from_checkpoint(random_checkpoint(_CFG, seed=4))
    be = BatchEngine(params, _CFG, None, n_slots=3, max_seq=256,
                     chunk_size=4, attn_impl="fused_step")
    dev = torch.device("cuda", torch.cuda.current_device())
    gs = GraphSet(dev, lambda: None)
    # PyTorch hands out pooled streams: drop what an earlier set left on
    # this one, then size it for one slot
    step_mod._SCRATCH.pop((dev, gs.stream.cuda_stream), None)
    with torch.cuda.stream(gs.stream):
        reserve_split_scratch(dev, 1, 1, 2, 128, 256)
    be._graphs = gs
    be.submit([1, 5, 9], max_new=8)
    with pytest.raises(ValueError, match="sized before a CUDA graph"):
        be.run()


# --act-dtype float16 / float32: each kernel's fp16 and f32 forms against
# its plain version at small ragged shapes (the int4 bar: a stored fp16 or
# bf16 value, or a bf16 p, may round one ulp apart after f32 sums in
# another order)

ACT = [torch.float16, torch.float32]
_SHORT = {torch.float16: "f16", torch.float32: "f32"}


@pytest.mark.parametrize("act", ACT)
@pytest.mark.parametrize("variant", ["prescale", "residual", "silu"])
@pytest.mark.parametrize("m", [1, 8, 11, GEMM_MIN_M, 130])
def test_int4_matmul_fused_act_dtype_matches_plain(gen, act, variant, m):
    """x, u and the residual in act and the output stored in act: the
    GEMV at 1, 8 and 11 rows (two passes), the GEMM at GEMM_MIN_M and 130
    rows (a partial second tile), over a partial last group and column
    tile (320 x 200)."""
    n_in, n_out = 320, 200
    qt = _qtensor(gen, n_in, n_out)
    x = _randn(gen, m, n_in, dtype=act)
    kw = _fused_kwargs(gen, variant, m, n_in, n_out)
    for name in ("residual", "silu_u"):
        if name in kw:
            kw[name] = kw[name].to(act)
    reset_launches()
    out, ss = int4_matmul_fused(x, qt, out_dtype=act, **kw)
    ref, ss_ref = int4_matmul_fused(x, qt, out_dtype=act, plain=True, **kw)
    torch.cuda.synchronize()
    (key,) = VARIANT_LAUNCHES
    tail = f"/out_{_SHORT[act]}" + (f"/res_{_SHORT[act]}"
                                    if "residual" in kw else "")
    assert key.endswith(tail), key
    assert out.dtype == act and bool(out.float().isfinite().all())
    _close(out, ref, **INT4)
    if ss_ref is not None:
        _close(ss, ss_ref, **INT4)


def _act_caches(gen, fmt, act, B, S, n_kv, D):
    """k, v caches and scales of one format: "act" (the activation type),
    "int8" codes or "int4" packed codes with f32 scales."""
    if fmt == "act":
        return (_randn(gen, B, S, n_kv, D, dtype=act),
                _randn(gen, B, S, n_kv, D, dtype=act), None, None)
    width = D // 2 if fmt == "int4" else D
    lo, smax = (-128, 0.2) if fmt == "int4" else (-127, 0.02)
    kc, vc = (torch.randint(lo, 128, (B, S, n_kv, width), dtype=torch.int8,
                            device="cuda", generator=gen) for _ in range(2))
    ks, vs = (torch.rand(B, S, n_kv, device="cuda", generator=gen) * smax
              for _ in range(2))
    return kc, vc, ks, vs


@pytest.mark.parametrize("act", ACT)
@pytest.mark.parametrize("fmt", ["act", "int8", "int4"])
@pytest.mark.parametrize("H,n_kv,D", [(4, 4, 128), (8, 2, 64)])
def test_attention_step_act_dtype_matches_plain(gen, act, fmt, H, n_kv, D):
    """An fp16 or f32 qkv row over a cache of its type, int8 or int4: slots
    with 0, SPLIT_ROWS - 1, SPLIT_ROWS and SPLIT_ROWS + 1 history rows
    (one split, a full one, and the first row of a second); the new rows
    and scales bit-equal."""
    B, S = 4, 2 * SPLIT_ROWS + 64
    pos = torch.tensor([0, SPLIT_ROWS - 1, SPLIT_ROWS, SPLIT_ROWS + 1],
                       dtype=torch.int32, device="cuda")
    cos2, sinm = rope_rows(pos, D, 10000.0)
    qkv = _randn(gen, B, (H + 2 * n_kv) * D, dtype=act)
    kc, vc, ks, vs = _act_caches(gen, fmt, act, B, S, n_kv, D)
    args = (qkv, kc, vc, pos, cos2, sinm, ks, vs)
    kw = dict(n_heads=H, kv_bits=4 if fmt == "int4" else 8)
    reset_launches()
    got = attention_step(*args, **kw)
    want = attention_step(*args, plain=True, **kw)
    torch.cuda.synchronize()
    (key,) = VARIANT_LAUNCHES
    assert key.split("/")[1] == (_SHORT[act] if fmt == "act" else fmt)
    _close(got[0], want[0], **INT4)
    for g, w in zip(got[1:], want[1:]):
        assert (g is None) == (w is None)
        if w is not None:
            assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("act", ACT)
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("early_exit", [True, False])
def test_batched_attention_act_dtype_matches_plain(gen, act, quant,
                                                   early_exit):
    """An fp16 or f32 q over a cache of its type or int8: slots with
    SPLIT_ROWS - 1, SPLIT_ROWS and SPLIT_ROWS + 1 rows to read and one at
    position 0, attn_len 320 short of the 384-row cache."""
    H, n_kv, D = 8, 2, 128
    B, S, attn_len = 4, 384, 320
    pos = torch.tensor([0, SPLIT_ROWS - 2, SPLIT_ROWS - 1, SPLIT_ROWS],
                       dtype=torch.int32, device="cuda")
    kc, vc, ks, vs = _act_caches(gen, "int8" if quant else "act", act, B, S,
                                 n_kv, D)
    args = (_randn(gen, B, H, D, dtype=act), kc, vc, pos, ks, vs)
    kw = dict(attn_len=attn_len, early_exit=early_exit)
    reset_launches()
    got = batched_decode_attention(*args, **kw)
    want = batched_decode_attention(*args, plain=True, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["batched_decode_attention"] == 1
    _close(got, want, **INT4)


@pytest.mark.parametrize("act", ACT)
@pytest.mark.parametrize("H,n_kv,D", [(4, 4, 128), (8, 2, 64)])
@pytest.mark.parametrize("positions", [
    (0,), (PFA_SPLIT - 80,), (PFA_SPLIT - 79, 0), (150, 7)])
def test_prefill_attention_act_dtype_matches_plain(gen, act, H, n_kv, D,
                                                   positions):
    """fp16 and f32 caches (and q): the ring of raw rows rounded to bf16
    as each chunk lands; blocks whose last key is the last row of the
    first split and the first row of the second, T = 80 (a partial query
    tile), attn_len 320 short of the 384-row cache."""
    B, S, T, attn_len = len(positions), 384, 80, 320
    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
    kc, vc, _, _ = _act_caches(gen, "act", act, B, S, n_kv, D)
    args = (_randn(gen, B, T, H, D, dtype=act), kc, vc, pos)
    reset_launches()
    got = prefill_attention(*args, attn_len=attn_len)
    want = prefill_attention(*args, attn_len=attn_len, plain=True)
    torch.cuda.synchronize()
    (key,) = VARIANT_LAUNCHES
    assert key.split("/")[1] == _SHORT[act]
    _close(got, want, **INT4)


@pytest.mark.parametrize("act", ACT)
@pytest.mark.parametrize("m", [1, 3, 11])
def test_down_qkv_act_dtype_matches_plain(gen, act, m):
    """x2 stored in act and read back in act by stage Q, the residual
    rounded to bf16 (the JAX chain); x2 and ss2 bit-equal to the down GEMV
    on the bf16 residual, qkv within the int4 bar of the plain version."""
    from llama_cu_awq_torch.ops.cuda.down_qkv import down_qkv_fused
    from llama_cu_awq_torch.ops.cuda.int4_matmul import _launch

    hid, dim, n_q = 384, 256, 320
    wd, wq = _qtensor(gen, hid, dim), _qtensor(gen, dim, n_q)
    g, u = _randn(gen, m, 2 * hid, dtype=act).chunk(2, dim=-1)
    res = _randn(gen, m, dim, dtype=act)
    nw = torch.rand(dim, device="cuda", generator=gen) + 0.5
    kw = dict(eps=1e-5, out_dtype=act, x2_dtype=act)
    reset_launches()
    x2, ss2, qkv = down_qkv_fused(g, u, res, wd, wq, nw, **kw)
    rx2, rss2, rqkv = down_qkv_fused(g, u, res, wd, wq, nw, plain=True, **kw)
    px2, pss2 = _launch(g.bfloat16(), wd, u2=u.bfloat16(),
                        res=res.bfloat16(), out_dtype=act, eps=1e-5,
                        kernel="gemv")
    torch.cuda.synchronize()
    assert LAUNCHES["down_qkv"] == 1
    assert x2.dtype == act and qkv.dtype == act
    assert torch.equal(x2, px2)
    assert torch.equal(ss2.reshape(-1), pss2.reshape(-1))
    _close(x2, rx2, **INT4)
    _close(qkv, rqkv, **INT4)


@pytest.mark.parametrize("act", ACT)
@pytest.mark.parametrize("attn_impl", ["auto", "fused_step", "batched"])
@pytest.mark.parametrize("quantized", [False, True])
def test_forward_act_dtype_on_card_matches_cpu(gen, act, attn_impl,
                                               quantized):
    """fp16 and f32 activations over a cache of that type (or int8), with
    the JAX CLI's params (fp16 embed and head for float16, f32 for
    float32): an 80-token block (prefill_attention), then five steps,
    kernels on the card against the plain versions on the CPU, within the
    JAX package's bar for two paths that round differently
    (tests/test_fused_path.py:51-52)."""
    ckpt = random_checkpoint(_CFG, seed=3)
    param_dtype = None if act == torch.float16 else act
    out = {}
    for dev in ("cpu", "cuda"):
        p = params_from_checkpoint(ckpt, device=dev, param_dtype=param_dtype)
        c = init_kv_cache(_CFG, 1, 256, dtype=act, quantized=quantized,
                          device=dev)
        block = torch.tensor([[1 + (7 * i) % 500 for i in range(80)]],
                             device=dev)
        zero = torch.tensor([0], dtype=torch.int32, device=dev)
        first, c = forward(p, _CFG, block, zero, c, act_dtype=act)
        logits = [first.float().cpu()]
        for step, t in enumerate([1, 7, 42, 3, 200]):
            lg, c = forward(p, _CFG, torch.tensor([[t]], device=dev),
                            torch.tensor([80 + step], dtype=torch.int32,
                                         device=dev), c,
                            attn_impl=attn_impl, act_dtype=act)
            logits.append(lg.float().cpu())
        out[dev] = torch.stack(logits)
    assert bool(out["cuda"].isfinite().all())
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("act", ["float16", "float32"])
@pytest.mark.parametrize("mode", ["generate", "chat", "perplexity"])
def test_cli_act_dtype_on_card(gen, tmp_path, capsys, monkeypatch, act,
                               mode):
    """python -m llama_cu_awq_torch model.bin --act-dtype float16|float32
    runs generate, chat and perplexity on the card (a random 2-layer
    checkpoint, a toy tokenizer): the text, the reply or a finite
    perplexity line."""
    import io
    import struct
    import sys

    from llama_cu_awq_torch.cli import main
    from llama_cu_awq_torch.io.checkpoint import save_checkpoint

    path = str(tmp_path / "model.bin")
    save_checkpoint(path, random_checkpoint(_CFG, seed=5))
    tok = str(tmp_path / "tok.bin")
    vocab = [(b"<unk>", 0.0), (b"<s>", 0.0), (b"</s>", 0.0)]
    vocab += [(bytes([b]), -1000.0) for b in range(256)]
    vocab += [(w, -float(i)) for i, w in enumerate(
        [b" the", b" cat", b" sat", b" on", b" mat"])]
    vocab += [(b"<pad%d>" % i, -2000.0)
              for i in range(_CFG.vocab_size - len(vocab))]
    with open(tok, "wb") as f:
        f.write(struct.pack("<i", max(len(p) for p, _ in vocab)))
        for piece, score in vocab:
            f.write(struct.pack("<fi", score, len(piece)) + piece)
    args = [path, "-m", mode, "-z", tok, "-t", "0", "--act-dtype", act]
    if mode == "perplexity":
        data = tmp_path / "data.txt"
        data.write_text("the cat sat on the mat<|endoftext|>the cat sat")
        args += ["-q", str(data)]
    elif mode == "generate":
        args += ["-n", "24", "-i", "the cat"]
    else:
        args += ["-i", "the cat", "-y", "be brief"]
        monkeypatch.setattr(sys, "stdin", io.StringIO(""))  # one turn
    assert main(args) == 0
    out = capsys.readouterr().out
    if mode == "perplexity":
        (line,) = [ln for ln in out.splitlines()
                   if ln.startswith("Geomean perplexity on 2 sequences: ")]
        assert math.isfinite(float(line.rsplit(" ", 1)[1]))
    elif mode == "chat":
        assert out.split("Assistant: ", 1)[1].split("\nUser: ")[0].strip()
    else:
        assert "achieved tok/s" in out


@pytest.mark.parametrize("case", ["steps_fused_step", "block_prefill",
                                  "steps_int8"])
def test_tp_forward_on_card_matches_single_device(gen, tmp_path, case):
    """Two ranks sharing the card over gloo (tests/torch_tp_ranks.py): the
    per-shard kernels (the w4 GEMV and GEMM with the f32 partials, the
    vocab-sharded head, attention_step and prefill_attention over the
    rank's heads) and the collectives on CUDA tensors, against the
    single-device forward on the card, f32 activations. The bar is
    tests/test_tp.py:77's for the same comparison: the ranks' sums add in
    another order, which the kernels' bf16 staging of x can carry one
    bf16 ulp."""
    from llama_cu_awq_torch.io.checkpoint import (load_checkpoint,
                                                  save_checkpoint)
    import torch_tp_ranks as ranks

    cfg = ModelConfig(dim=512, hidden_dim=1024, n_layers=2, n_heads=4,
                      n_kv_heads=4, vocab_size=512, seq_len=256)
    path = str(tmp_path / "tp.bin")
    save_checkpoint(path, random_checkpoint(cfg, seed=78))
    mode, what = case.split("_", 1)
    job = dict(kind="forward", name=case, device="cuda", act="float32",
               cache="int8" if what == "int8" else "plain", max_seq=256,
               mode=mode, attn_impl="fused_step",
               tokens=([3, 141, 59, 26, 500] if mode == "steps" else
                       [1 + (7 * i) % 500 for i in range(80)]))
    got, calls = ranks.spawn_ranks(2, tmp_path, path, [job])[case]
    want, _ = ranks.forward_job(job, load_checkpoint(path))
    assert got.shape == want.shape and bool(torch.isfinite(
        torch.from_numpy(got)).all())
    torch.testing.assert_close(torch.from_numpy(got), torch.from_numpy(want),
                               rtol=5e-3, atol=5e-3)
    kernel = "attention_step" if mode == "steps" else "prefill_attention"
    assert calls.get(kernel, 0) >= cfg.n_layers


def test_tp_graphs_match_eager_on_card(gen, tmp_path):
    """Two ranks sharing the card over gloo (tests/torch_tp_ranks.py
    graphs_job): a TP InferenceEngine (decode, forced prompt steps, prompt
    blocks, perplexity, the spec verify) and a TP BatchEngine (chunks,
    slot prefill blocks, spec blocks, the follower's follow() loop) made
    with capture=True, whose graphs split at the collectives, equal the
    same engines made with capture=False bit for bit on both ranks:
    streams and whole caches. A T=1 key with the head is 2 * n_layers + 2
    segments (2 all-reduces a layer and the logits' gather), a prefill
    block without it 2 * n_layers + 1."""
    from llama_cu_awq_torch.io.checkpoint import save_checkpoint
    import torch_tp_ranks as ranks

    cfg = ModelConfig(dim=256, hidden_dim=512, n_layers=2, n_heads=2,
                      n_kv_heads=2, vocab_size=512, seq_len=256)
    path = str(tmp_path / "tp.bin")
    save_checkpoint(path, random_checkpoint(cfg, seed=5))
    job = dict(kind="graphs", name="graphs", device="cuda")
    res = ranks.spawn_ranks(2, tmp_path, path, [job])["graphs"]
    for name in ("engine", "engine_spec", "batch", "batch_spec"):
        assert res[name]["equal"], name
    assert all(res["engine"]["streams"]) and all(res["batch"]["streams"][0])
    seg = res["segments"]
    L = cfg.n_layers
    assert seg["engine/decode/T1"] == seg["batch/chunk/T1"] == 2 * L + 2
    assert seg["batch/prefill/T128"] == 2 * L + 1
    assert seg["engine_spec/verify/T5"] == 2 * L + 2


def test_dp_tp_forward_on_card(gen, tmp_path):
    """The batch-sharded TP forward (parallel/tp.py, given a Mesh)
    on 4 ranks sharing the card over gloo as dp 2 x tp 2
    (tests/torch_tp_ranks.py dp_forward_job): 4 T=1 steps of a batch of
    4 at their own positions, the cache carried; each rank's logits are
    its dp row's rows of the single-device forward's on the card
    (tests/test_torch_tp.py's bar for TP against one device, 5e-3), and
    the rows gathered over dp are the whole batch's."""
    from llama_cu_awq_torch.io.checkpoint import (load_checkpoint,
                                                  save_checkpoint)
    import torch_tp_ranks as ranks

    cfg = ModelConfig(dim=512, hidden_dim=1024, n_layers=2, n_heads=4,
                      n_kv_heads=4, vocab_size=512, seq_len=128)
    path = str(tmp_path / "dp_tp.bin")
    save_checkpoint(path, random_checkpoint(cfg, seed=78))
    tokens = [[3, 141, 59, 26], [500, 7, 42, 9], [11, 300, 2, 77],
              [8, 64, 128, 5]]
    offsets = [0, 2, 1, 3]
    job = dict(kind="dp_forward", name="dp", device="cuda", act="float32",
               cache="plain", max_seq=32, tokens=tokens, offsets=offsets,
               tp=2, dp=2)
    res = ranks.spawn_ranks(4, tmp_path, path, [job])["dp"]
    params = params_from_checkpoint(load_checkpoint(path), device="cuda",
                                    param_dtype=torch.float32)
    cache = init_kv_cache(cfg, 4, 32, dtype=torch.float32, device="cuda")
    want = []
    for i, step in enumerate(tokens):
        logits, cache = forward(
            params, cfg, torch.tensor(step, device="cuda")[:, None],
            torch.tensor(offsets, dtype=torch.int32, device="cuda") + i,
            cache, attn_len=32, act_dtype=torch.float32)
        want.append(logits.float().cpu())
    want = torch.stack(want)
    assert sorted((r["dp_index"], r["tp_rank"]) for r in res) == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    for r in res:
        rows = slice(2 * r["dp_index"], 2 * r["dp_index"] + 2)
        torch.testing.assert_close(torch.from_numpy(r["logits"]),
                                   want[:, rows], rtol=5e-3, atol=5e-3)
        torch.testing.assert_close(torch.from_numpy(r["gathered"]),
                                   want[-1], rtol=5e-3, atol=5e-3)


# the trained model of tools/train_tiny (chip_smoke.py phase 13): dim 512,
# hidden 1536 (4 groups of 128 in n_in for qkv, o and gate_up, 12 for
# down), 4 heads of 128, the Llama-2 vocab
_TRAINED = ModelConfig(dim=512, hidden_dim=1536, n_layers=2, n_heads=4,
                       n_kv_heads=4, vocab_size=32000, seq_len=2048)


@pytest.mark.parametrize("m", [1, 8, 128])
def test_trained_model_shapes_match_plain(gen, m):
    """Each w4 projection of the trained model (qkv and gate_up with their
    rmsnorm prologue, o with its residual, down with SwiGLU and its
    residual) and each of its heads (bf16 and int8 rows through
    dense_gemm, the w4 head through int4_matmul) at m = 1 (decode), 8
    (spec verify blocks) and 128 (perplexity blocks: the GEMM, whose
    split rule keeps one split over these 4 and 12 groups), against the
    plain versions: the int4 bar, and f32 sum order for the dense head."""
    from llama_cu_awq_torch.ops.cuda.int4_matmul import gemm_splits, route

    dim, hid, V = _TRAINED.dim, _TRAINED.hidden_dim, _TRAINED.vocab_size
    projections = [(dim, 3 * dim, "prescale"), (dim, dim, "residual"),
                   (dim, 2 * hid, "prescale"), (hid, dim, "silu")]
    reset_launches()
    for n_in, n_out, variant in projections:
        assert gemm_splits(n_in, n_out) == 1
        qt = _qtensor(gen, n_in, n_out)
        x = _randn(gen, m, n_in)
        kw = _fused_kwargs(gen, variant, m, n_in, n_out)
        out, ss = int4_matmul_fused(x, qt, **kw)
        ref, ss_ref = int4_matmul_fused(x, qt, plain=True, **kw)
        _close(out, ref, **INT4)
        if ss_ref is not None:
            _close(ss, ss_ref, **INT4)
    w = (_randn(gen, V, dim, dtype=torch.float32) * 0.05).bfloat16()
    q8 = quantize_dense_int8(w)
    x = _randn(gen, m, dim)
    for args in ((w,), (q8.w8, q8.scale)):
        _close(dense_gemv(x, *args), dense_gemv(x, *args, plain=True),
               rtol=1e-3, atol=1e-4)
    head = _qtensor(gen, dim, V)
    _close(int4_matmul(x, head), int4_matmul(x, head, plain=True), **INT4)
    torch.cuda.synchronize()
    assert LAUNCHES["int4_matmul_fused"] == 4
    assert LAUNCHES["dense_gemv"] == 2 and LAUNCHES["int4_matmul"] == 1
    assert all(k.split("/")[1] == route(m) for k in VARIANT_LAUNCHES
               if k.startswith("int4_matmul"))


@pytest.mark.parametrize("fmt", ["bf16", "int8", "int4"])
def test_trained_model_attention_matches_plain(gen, fmt):
    """The trained model's 4 heads of 128 over the CLI's 2048-row cache:
    attention_step over each cache format at positions 0, 700 and 2047
    (the ppl matrix's fused_step rows), and prefill_attention over a
    128-token block at positions 0 and 1024 over the bf16 and int8 caches
    (perplexity), against the plain versions."""
    H = n_kv = _TRAINED.n_heads
    D, S, B = _TRAINED.head_dim, _TRAINED.seq_len, 3
    pos = torch.tensor([0, 700, S - 1], dtype=torch.int32, device="cuda")
    cos2, sinm = rope_rows(pos, D, _TRAINED.rope_theta)
    qkv = _randn(gen, B, (H + 2 * n_kv) * D)
    width = D // 2 if fmt == "int4" else D
    if fmt == "bf16":
        kc, vc = _randn(gen, B, S, n_kv, D), _randn(gen, B, S, n_kv, D)
        ks = vs = None
    else:
        lo, hi = (-128, 128) if fmt == "int4" else (-127, 128)
        kc, vc = (torch.randint(lo, hi, (B, S, n_kv, width),
                                dtype=torch.int8, device="cuda",
                                generator=gen) for _ in range(2))
        ks, vs = (torch.rand(B, S, n_kv, device="cuda", generator=gen)
                  * 0.02 for _ in range(2))
    bits = 4 if fmt == "int4" else 8
    args = (qkv, kc, vc, pos, cos2, sinm, ks, vs)
    got = attention_step(*args, n_heads=H, kv_bits=bits)
    want = attention_step(*args, n_heads=H, kv_bits=bits, plain=True)
    torch.cuda.synchronize()
    _close(got[0], want[0], **INT4)
    for g, w in zip(got[1:], want[1:]):
        assert (g is None) == (w is None)
        if w is not None:
            assert torch.equal(g, w)
    if fmt == "int4":
        return
    q = _randn(gen, 2, 128, H, D)
    bpos = torch.tensor([0, 1024], dtype=torch.int32, device="cuda")
    blk = (q, kc[:2], vc[:2], bpos,
           None if ks is None else ks[:2], None if vs is None else vs[:2])
    reset_launches()
    got = prefill_attention(*blk, attn_len=S)
    want = prefill_attention(*blk, attn_len=S, plain=True)
    torch.cuda.synchronize()
    assert LAUNCHES["prefill_attention"] == 1
    _close(got, want, **INT4)


@pytest.mark.parametrize("T", [1, 8, 128])
def test_trained_config_forward_on_card_matches_cpu(gen, T):
    """The trained model's configuration (2 of its 8 layers, random
    weights) through forward on the card against the CPU: one decode
    step through attention_step, an 8-token block (the GEMV at m=8,
    plain attention) and a 128-token block (the GEMM and
    prefill_attention), after a 128-token prompt; the JAX package's bar
    for logits of two paths (tests/test_fused_path.py:51-52)."""
    ckpt = random_checkpoint(_TRAINED, seed=15)
    prompt = [1 + (37 * i) % 255 for i in range(128)]
    block = [3 + (11 * i) % 255 for i in range(T)]
    out = {}
    for dev in ("cpu", "cuda"):
        p = params_from_checkpoint(ckpt, device=dev)
        c = init_kv_cache(_TRAINED, 1, 512, device=dev)
        forward(p, _TRAINED, torch.tensor([prompt], device=dev),
                torch.zeros(1, dtype=torch.int32, device=dev), c,
                no_logits=True)
        reset_launches()
        logits, _ = forward(p, _TRAINED, torch.tensor([block], device=dev),
                            torch.tensor([128], dtype=torch.int32,
                                         device=dev), c,
                            attn_impl="fused_step", logits_all=True)
        out[dev] = logits.float().cpu()
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=2e-2, atol=2e-2)
    assert LAUNCHES["int4_matmul_fused"] == 4 * _TRAINED.n_layers
    assert LAUNCHES["dense_gemv"] == 1
    assert LAUNCHES["attention_step"] == (_TRAINED.n_layers if T == 1
                                          else 0)
    assert LAUNCHES["prefill_attention"] == (_TRAINED.n_layers if T == 128
                                             else 0)


def test_train_step_on_card_matches_cpu(gen):
    """One train step of tools/train_tiny from the same params and batch
    on the card and on the CPU, plain f32 on both (no TF32): the loss
    within rel 1e-4, and each gradient leaf, and each leaf after the
    global-norm clip, within rel 1e-4 of its norm (the same f32 sums in
    other orders; the embedding's scatter adds in the card's order)."""
    from llama_cu_awq_torch.tools import train_tiny as tt

    cfg = ModelConfig(dim=128, hidden_dim=384, n_layers=2, n_heads=4,
                      n_kv_heads=2, vocab_size=512, seq_len=64)
    g = torch.Generator()
    g.manual_seed(0)
    host = tt.params_to_numpy(tt.init_params(cfg, g))
    tokens = torch.randint(0, 512, (4, 65), generator=g, dtype=torch.int32)
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {}
    for dev in ("cpu", "cuda"):
        loss, grads = tt.loss_and_grads(tt.params_from_numpy(host, dev),
                                        tokens.to(dev), cfg)
        res[dev] = (float(loss), [x.cpu() for x in grads],
                    [x.cpu() for x in tt.clip_by_global_norm(grads, 0.01)])
    assert res["cuda"][0] == pytest.approx(res["cpu"][0], rel=1e-4)
    for i in (1, 2):
        for name, a, b in zip(tt.leaf_names(cfg.n_layers), res["cuda"][i],
                              res["cpu"][i]):
            assert float((a - b).norm()) <= 1e-4 * float(b.norm()), name


def test_bench_tiny_on_card(gen):
    """The bench's default decode run (plain, spec, re-bracket) at tiny on
    the card: bench.py's keys, and the re-bracket's timed runs launched
    the w4 GEMV and the lm_head."""
    from llama_cu_awq_torch import bench

    res = bench.run(["--config", "tiny", "--steps", "24", "--repeats", "1"])
    spec_keys = {"spec_acceptance", "spec_workload"}  # where it proposed
    assert set(res) - spec_keys == {
        "metric", "value", "unit", "vs_baseline", "decode_tok_s_plain",
        "decode_tok_s_spec", "plain_rebracket", "window_drift"}
    assert len(spec_keys & set(res)) in (0, 2)
    assert res["metric"] in ("decode_tok_s_tiny_w4g128_b1",
                             "decode_tok_s_tiny_w4g128_b1_spec7")
    assert res["decode_tok_s_plain"] > 0 and res["decode_tok_s_spec"] > 0
    assert LAUNCHES["int4_matmul_fused"] > 0 and LAUNCHES["dense_gemv"] > 0
