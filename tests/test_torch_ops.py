"""The port's ops and the plain versions of its kernels against the JAX
package, on the CPU, with inputs made from a seed with numpy.

Oracles: the JAX dequant path (f32 scales that are exactly the fp16 file
values) for the matmuls, and the JAX Pallas kernels in interpret mode.
The JAX int4 kernel keeps its scales in bf16 (packing.build_meta), up to
2^-8 relative off, so against it the bar is the int4 one of
tests/test_pallas_int4.py:68 (rtol=2e-2, atol=2e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cu_awq_torch.models.llama import quantize_kv as t_quantize_kv
from llama_cu_awq_torch.ops.cuda import LAUNCHES, VARIANT_LAUNCHES
from llama_cu_awq_torch.ops.cuda.attention_step import (
    attention_step as t_attention_step)
from llama_cu_awq_torch.ops.cuda.attention_step import rope_rows as t_rope_rows
from llama_cu_awq_torch.ops.cuda import dense_gemv as t_dense_gemv_mod
from llama_cu_awq_torch.ops.cuda.int4_matmul import int4_matmul
from llama_cu_awq_torch.ops.linear import dense_matmul as t_dense_matmul
from llama_cu_awq_torch.ops.linear import qmatmul as t_qmatmul
from llama_cu_awq_torch.ops.linear import qmatmul_fused as t_qmatmul_fused
from llama_cu_awq_torch.ops.norms import rmsnorm as t_rmsnorm
from llama_cu_awq_torch.ops.rope import apply_rope as t_apply_rope
from llama_cu_awq_torch.quant.int8 import Int8Dense as TInt8Dense
from llama_cu_awq_torch.quant.int8 import quantize_dense_int8 as t_q8
from llama_cu_awq_torch.quant.qtensor import QTensor as TQ
from llama_cu_awq_tpu.models.llama import quantize_kv as j_quantize_kv
from llama_cu_awq_tpu.ops.linear import dense_matmul as j_dense_matmul
from llama_cu_awq_tpu.ops.linear import qmatmul as j_qmatmul
from llama_cu_awq_tpu.ops.linear import qmatmul_fused as j_qmatmul_fused
from llama_cu_awq_tpu.ops.norms import rmsnorm as j_rmsnorm
from llama_cu_awq_tpu.ops.pallas.attention_step import (
    attention_step as j_attention_step)
from llama_cu_awq_tpu.ops.pallas.attention_step import rope_rows as j_rope_rows
from llama_cu_awq_tpu.ops.pallas.dense_gemv import dense_gemv as j_dense_gemv
from llama_cu_awq_tpu.ops.pallas.int4_matmul import (int4_matmul_fused as
                                                     j_int4_matmul_fused)
from llama_cu_awq_tpu.ops.rope import apply_rope as j_apply_rope
from llama_cu_awq_tpu.quant import packing
from llama_cu_awq_tpu.quant.int8 import quantize_dense_int8 as j_q8
from llama_cu_awq_tpu.quant.qtensor import QTensor as JQ
from llama_cu_awq_tpu.quant.qtensor import to_tpu_layout

# one intra-op thread per process: the suite runs in several worker
# processes, and torch's default pool in each oversubscribes the cores
# (tens of times slower on small tensors); it also fixes the CPU sum order
torch.set_num_threads(1)


def _bf16(a):
    """numpy f32 -> (jax bf16 array, torch bf16 tensor) with equal bits."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j, np.float32)).bfloat16()


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _qtensors(rng, n, d, bf16_scales=False):
    """The same quantized weight for both packages. bf16_scales rounds the
    fp16 scales to bf16 values (still fp16-exact), which the TPU kernel's
    bf16 metadata then holds exactly."""
    w = rng.standard_normal((n, d), dtype=np.float32) * 0.1
    qw, zeros, scales = packing.quantize_np(w)
    if bf16_scales:
        scales = np.asarray(jnp.asarray(scales, jnp.bfloat16), np.float32)
    j = JQ(jnp.asarray(qw), jnp.asarray(zeros), jnp.asarray(scales), n, d)
    return j, TQ.from_numpy(qw, zeros, scales, n)


def test_rmsnorm(rng):
    x = rng.standard_normal((3, 64), dtype=np.float32)
    w = 1 + 0.1 * rng.standard_normal(64, dtype=np.float32)
    for dt_j, dt_t in ((jnp.float32, torch.float32),
                       (jnp.bfloat16, torch.bfloat16)):
        jx = jnp.asarray(x, dt_j)
        tx = torch.from_numpy(np.array(jx, np.float32)).to(dt_t)
        got = _np(t_rmsnorm(tx, torch.from_numpy(w)))
        want = _np(j_rmsnorm(jx, jnp.asarray(w)))
        # f32: one rounding apart at most; bf16 output: one bf16 ulp
        tol = 1e-6 if dt_t == torch.float32 else 2 ** -8
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("theta", [10000.0, 50000.0])
def test_rope(rng, theta):
    x = rng.standard_normal((2, 3, 4, 16), dtype=np.float32)
    pos = np.array([[0, 5, 90], [7, 8, 1000]], np.int32)
    jx, tx = _bf16(x)
    got = _np(t_apply_rope(tx, torch.from_numpy(pos), theta))
    want = _np(j_apply_rope(jx, jnp.asarray(pos), theta))
    # f32 trig of the two libraries may differ in the last bit, which can
    # move the bf16 result by one ulp
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6)
    cj, sj = j_rope_rows(jnp.asarray(pos[:, 0]), 128, theta)
    ct, st = t_rope_rows(torch.from_numpy(pos[:, 0]), 128, theta)
    np.testing.assert_allclose(_np(ct), _np(cj), atol=2e-6)
    np.testing.assert_allclose(_np(st), _np(sj), atol=2e-6)


def test_qmatmul_plain_matches_dequant(rng):
    jq, tq = _qtensors(rng, 160, 96)
    x = rng.standard_normal((3, 160), dtype=np.float32)
    jx, tx = _bf16(x)
    got = _np(t_qmatmul(tx, tq))
    want = _np(j_qmatmul(jx, jq, "dequant"))
    # both f32 exact dequant + f32 sums; the order of the sums differs
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert LAUNCHES["int4_matmul"] == 0  # a CPU tensor takes the plain path


_VARIANTS = ["qkv_prescale", "o_residual_ss", "gate_up_prescale",
             "down_silu_residual_ss"]


def _variant_args(rng, variant, m, n_in, n_out):
    """Inputs of one fused variant as (jax kwargs, torch kwargs, x)."""
    x = rng.standard_normal((m, n_in), dtype=np.float32)
    jx, tx = _bf16(x)
    jk, tk = {}, {}
    if variant.endswith("prescale"):
        ss = (0.5 + rng.random((m, 1))).astype(np.float32)
        nw = (0.5 + rng.random(n_in)).astype(np.float32)
        jk["prescale"] = (jnp.asarray(ss), jnp.asarray(nw))
        tk["prescale"] = (torch.from_numpy(ss), torch.from_numpy(nw))
    else:
        ju, tu = _bf16(rng.standard_normal((m, n_out), dtype=np.float32))
        jk.update(residual=ju, emit_ss_eps=1e-5)
        tk.update(residual=tu, emit_ss_eps=1e-5)
        if "silu" in variant:
            jv, tv = _bf16(rng.standard_normal((m, n_in), dtype=np.float32))
            jk["silu_u"], tk["silu_u"] = jv, tv
    return jx, tx, jk, tk


@pytest.mark.parametrize("variant", _VARIANTS)
@pytest.mark.parametrize("m,n_in", [(1, 256), (3, 256), (8, 256), (8, 160)],
                         ids=["1", "3", "8", "8-n160"])
def test_qmatmul_fused_plain_matches_dequant(rng, variant, m, n_in):
    """m=8 is the serving step's row count (the card kernel's one pass);
    n_in 160 (tiny_config's hidden) ends in a partial 128-row group."""
    n_out = 192
    jq, tq = _qtensors(rng, n_in, n_out)
    jx, tx, jk, tk = _variant_args(rng, variant, m, n_in, n_out)
    got, ss_t = t_qmatmul_fused(tx, tq, **tk)
    want, ss_j = j_qmatmul_fused(jx, jq, "dequant", **jk)
    # identical staging (bf16 effective x, f32 sums, f32 residual, bf16
    # out); f32 sums in another order can round the bf16 output one ulp
    # apart, and torch's sigmoid may differ from jax's in the last f32 bit
    np.testing.assert_allclose(_np(got), _np(want), rtol=2 ** -7, atol=1e-5)
    if ss_j is not None:
        np.testing.assert_allclose(_np(ss_t), _np(ss_j), rtol=1e-3)


@pytest.mark.parametrize("variant", _VARIANTS)
def test_qmatmul_fused_plain_matches_pallas_interpret(rng, variant):
    # n_out 256: the TPU layout leaves it unpadded, as its epilogues need
    n_in, n_out = 512, 256
    jq, tq = _qtensors(rng, n_in, n_out, bf16_scales=True)
    jx, tx, jk, tk = _variant_args(rng, variant, 2, n_in, n_out)
    got, ss_t = t_qmatmul_fused(tx, tq, **tk)
    want, ss_j = j_int4_matmul_fused(jx, to_tpu_layout(jq), interpret=True,
                                     **jk)
    # the int4 bar. The TPU kernel keeps scales in bf16, up to 2^-8 off an
    # fp16 scale, an error that grows with the sum, not with each output;
    # with bf16-exact scales both kernels dequantize alike and differ by
    # the order of f32 sums and one-ulp bf16 output roundings
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-2, atol=2e-3)
    if ss_j is not None:
        np.testing.assert_allclose(_np(ss_t), _np(ss_j), rtol=2e-2)


def test_int4_matmul_plain_matches_pallas_interpret(rng):
    from llama_cu_awq_tpu.ops.pallas.int4_matmul import (int4_matmul as
                                                         j_int4_matmul)

    jq, tq = _qtensors(rng, 1024, 256, bf16_scales=True)
    jx, tx = _bf16(rng.standard_normal((4, 1024), dtype=np.float32))
    got = _np(int4_matmul(tx, tq))
    want = _np(j_int4_matmul(jx, to_tpu_layout(jq), interpret=True))
    # the int4 bar, with bf16-exact scales as above
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-3)


@pytest.mark.parametrize("m", [2, 128])
@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_dense_matmul_plain_matches_jax(rng, kind, m):
    """Against the JAX dequant path and the JAX dense_gemv kernel in
    interpret mode (its vocab tiles need v a multiple of 128: 384); m = 2
    is a decode step's few rows, m = 128 a prefill block's, the port's
    tile kernel's route."""
    w = rng.standard_normal((384, 128), dtype=np.float32) * 0.05
    jw, tw = _bf16(w)
    jx, tx = _bf16(rng.standard_normal((m, 128), dtype=np.float32))
    if kind == "int8":
        jw, tw = j_q8(jw), t_q8(tw)
        # the same codes and scales: round half to even in both
        assert np.array_equal(np.asarray(jw.w8), tw.w8.numpy())
        assert np.array_equal(np.asarray(jw.scale), tw.scale.numpy())
        assert isinstance(tw, TInt8Dense)
        kernel = j_dense_gemv(jx, jw.w8, jw.scale.reshape(1, -1),
                              interpret=True)
    else:
        kernel = j_dense_gemv(jx, jw, interpret=True)
    got = _np(t_dense_matmul(tx, tw))
    # operands widen exactly to f32; only the order of f32 sums differs
    for want in (j_dense_matmul(jx, jw, "dequant"), kernel):
        np.testing.assert_allclose(got, _np(want), rtol=1e-5, atol=1e-6)


def test_dense_gemv_route_and_tiles():
    """The tile kernel's widths and ragged-edge grid, as the wrapper
    computes them for the C launcher (which checks them)."""
    mod = t_dense_gemv_mod
    assert [mod.gemm_n_tile(m) for m in (1, 16, 17, 32, 33, 64, 65, 128,
                                         129, 200, 4096)] == [
        16, 16, 32, 32, 64, 64, 128, 128, 128, 128, 128]
    # 7B's head at a block: 250 vocab tiles, one column tile
    assert mod.gemm_grid(128, 32000) == (250, 1)
    # a 1000-row head: 7 full tiles and one of 104 rows; 200 rows of x:
    # a full column tile and one of 72 rows; 9 rows: one tile of 16
    assert mod.gemm_grid(200, 1000) == (8, 2)
    assert mod.gemm_grid(9, 1000) == (8, 1) and mod.gemm_n_tile(9) == 16
    assert mod.gemm_grid(1, 1) == (1, 1)


def test_quantize_kv_bit_equal(rng):
    jx, tx = _bf16(rng.standard_normal((2, 3, 4, 16), dtype=np.float32))
    jq, js = j_quantize_kv(jx)
    tq, ts = t_quantize_kv(tx)
    assert np.array_equal(np.asarray(jq), tq.numpy())
    assert np.array_equal(np.asarray(js), ts.numpy())


def _attn_inputs(rng, B, A, H, n_kv, D, quantized):
    qkv = rng.standard_normal((B, (H + 2 * n_kv) * D), dtype=np.float32)
    pos = np.array([5, A - 3, 70, 128][:B], np.int32)
    jqkv, tqkv = _bf16(qkv)
    if quantized:
        k = rng.integers(-127, 128, (B, A, n_kv, D)).astype(np.int8)
        v = rng.integers(-127, 128, (B, A, n_kv, D)).astype(np.int8)
        ks = rng.uniform(0.005, 0.02, (B, A, n_kv)).astype(np.float32)
        vs = rng.uniform(0.005, 0.02, (B, A, n_kv)).astype(np.float32)
        j = (jqkv, jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos))
        t = (tqkv, torch.from_numpy(k), torch.from_numpy(v),
             torch.from_numpy(pos))
        return j, t, (jnp.asarray(ks), jnp.asarray(vs)), (
            torch.from_numpy(ks), torch.from_numpy(vs))
    jk, tk = _bf16(rng.standard_normal((B, A, n_kv, D), dtype=np.float32))
    jv, tv = _bf16(rng.standard_normal((B, A, n_kv, D), dtype=np.float32))
    return ((jqkv, jk, jv, jnp.asarray(pos)),
            (tqkv, tk, tv, torch.from_numpy(pos)), (None, None),
            (None, None))


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("H,n_kv", [(4, 4), (8, 2)])
def test_attention_step_plain_matches_pallas_interpret(rng, quantized, H,
                                                       n_kv):
    B, A, D = 3, 256, 128
    j, t, jsc, tsc = _attn_inputs(rng, B, A, H, n_kv, D, quantized)
    cj, sj = j_rope_rows(j[3], D, 10000.0)
    ct, st = t_rope_rows(t[3], D, 10000.0)
    want = j_attention_step(j[0], j[1], j[2], j[3], cj, sj, *jsc,
                            n_heads=H, interpret=True)
    got = t_attention_step(t[0], t[1], t[2], t[3], ct, st, *tsc, n_heads=H)
    # the JAX kernel walks the window in one 256-row block, the port in
    # chunks of 64: p is rounded to bf16 against another running max, so
    # the two agree to bf16 rounding of p, not bit for bit
    np.testing.assert_allclose(_np(got[0]), _np(want[0]), rtol=2e-2,
                               atol=2e-3)
    # the new cache rows (and int8 codes and scales) are bit-equal when the
    # rope factors agree; a last-bit difference of f32 cos/sin between the
    # libraries may move a bf16 k by one ulp, so compare with the port's
    # own rope rows too
    got_own = t_attention_step(t[0], t[1], t[2], t[3],
                               torch.from_numpy(np.array(cj)),
                               torch.from_numpy(np.array(sj)), *tsc,
                               n_heads=H)
    for i in range(1, 5 if quantized else 3):
        assert np.array_equal(_np(got_own[i]), _np(want[i])), i
    np.testing.assert_allclose(_np(got_own[0]), _np(want[0]), rtol=2e-2,
                               atol=2e-3)


def test_wrappers_dispatch_by_device(rng):
    """A CPU tensor takes the plain version and launches nothing; a tensor
    on another device raises instead of falling back."""
    before = dict(LAUNCHES), dict(VARIANT_LAUNCHES)
    _, tq = _qtensors(rng, 128, 64)
    x = torch.zeros(1, 128, dtype=torch.bfloat16)
    t_qmatmul_fused(x, tq)
    t_dense_matmul(x, torch.zeros(64, 128, dtype=torch.bfloat16))
    assert (LAUNCHES, VARIANT_LAUNCHES) == before
    with pytest.raises(ValueError, match="device"):
        int4_matmul(x.to("meta"), tq)
    with pytest.raises(ValueError, match="inputs"):
        int4_matmul(torch.zeros(1, 96), tq)
