"""The split decode attention of the port, held to the JAX package on the CPU.

attention_step (bf16, int8 and int4 caches) and batched_decode_attention
split the window into runs of SPLIT_ROWS rows; their plain versions walk
the same splits. Inputs are made from a seed with numpy and handed to
both packages; the JAX kernels run in interpret mode, at positions on
either side of the split boundaries (0, SPLIT_ROWS - 1, SPLIT_ROWS,
SPLIT_ROWS + 1, 3 * SPLIT_ROWS + 5, mixed per slot) and, for
batched_static, over splits whose rows are all masked. Tolerance: the JAX
attention_step walks its window in one block and the batched kernel in
blocks of 128 to 1024 rows, the port splits it, so p rounds to bf16
against another max and the two agree to bf16 rounding of p (ATTN, the
attention_step bar of tests/test_torch_ops.py). The new cache rows, codes
and scales are bit-equal to the jitted JAX kernel's with its rope rows,
and a slot's output is bit-equal whether it runs alone or in a batch (the
split length depends on nothing but SPLIT_ROWS).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cu_awq_torch.ops.cuda.attention_step import (
    SPLIT_ROWS, n_splits)
from llama_cu_awq_torch.ops.cuda.attention_step import (
    attention_step as t_attention_step)
from llama_cu_awq_torch.ops.cuda.attention_step import (
    attention_step_plain as t_attention_step_plain)
from llama_cu_awq_torch.ops.cuda.attention_step import rope_rows as t_rope_rows
from llama_cu_awq_torch.ops.cuda.batched_attention import (
    batched_decode_attention as t_bda)
from llama_cu_awq_tpu.ops.pallas.attention_step import (
    attention_step as j_attention_step)
from llama_cu_awq_tpu.ops.pallas.attention_step import rope_rows as j_rope_rows
from llama_cu_awq_tpu.ops.pallas.batched_attention import (
    batched_decode_attention as j_bda)
from tests.test_torch_ops import _bf16, _np

# one intra-op thread per process: the suite runs in several worker
# processes, and torch's default pool in each oversubscribes the cores
torch.set_num_threads(1)

ATTN = dict(rtol=2e-2, atol=2e-3)
A, D = 4 * SPLIT_ROWS, 128
# slots on either side of the split boundaries, one deep slot alone, and
# mixed positions in one batch
POSITIONS = {
    "edges": (0, SPLIT_ROWS - 1, SPLIT_ROWS, SPLIT_ROWS + 1),
    "deep": (3 * SPLIT_ROWS + 5,),
    "mixed": (7, SPLIT_ROWS, 3 * SPLIT_ROWS + 5),
}


def _cache(rng, B, n_kv, fmt):
    """(jax, torch) pairs of k, v and their scales (None for bf16): bf16
    values, int8 codes, or int4 codes packed two a byte (every byte)."""
    if fmt == "bf16":
        k, v = (_bf16(rng.standard_normal((B, A, n_kv, D), dtype=np.float32)
                      * 0.3) for _ in range(2))
        return k, v, (None, None), (None, None)
    if fmt == "int8":
        codes = [rng.integers(-127, 128, (B, A, n_kv, D)).astype(np.int8)
                 for _ in range(2)]
        scales = [rng.uniform(0.005, 0.02, (B, A, n_kv)).astype(np.float32)
                  for _ in range(2)]
    else:
        codes = [rng.integers(-128, 128, (B, A, n_kv, D // 2)).astype(np.int8)
                 for _ in range(2)]
        scales = [rng.uniform(0.05, 0.2, (B, A, n_kv)).astype(np.float32)
                  for _ in range(2)]
    return tuple((jnp.asarray(a), torch.from_numpy(a))
                 for a in codes + scales)


@pytest.mark.parametrize("fmt", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("H,n_kv", [(4, 4), (8, 2)])
@pytest.mark.parametrize("case", list(POSITIONS))
def test_attention_step_split_matches_pallas_interpret(rng, fmt, H, n_kv,
                                                       case):
    p = np.array(POSITIONS[case], np.int32)
    B = len(p)
    (jqkv, tqkv) = _bf16(rng.standard_normal((B, (H + 2 * n_kv) * D),
                                             dtype=np.float32))
    (jk, tk), (jv, tv), (jks, tks), (jvs, tvs) = _cache(rng, B, n_kv, fmt)
    kv_bits = 4 if fmt == "int4" else 8
    jpos, tpos = jnp.asarray(p), torch.from_numpy(p)
    cj, sj = j_rope_rows(jpos, D, 10000.0)
    want = j_attention_step(jqkv, jk, jv, jpos, cj, sj, jks, jvs, n_heads=H,
                            attn_len=A, kv_bits=kv_bits, interpret=True)
    ct, st = t_rope_rows(tpos, D, 10000.0)
    got = t_attention_step(tqkv, tk, tv, tpos, ct, st, tks, tvs, n_heads=H,
                           kv_bits=kv_bits, attn_len=A)
    assert got[0].shape == (B, H, D) and got[0].dtype == torch.float32
    np.testing.assert_allclose(_np(got[0]), _np(want[0]), **ATTN)
    # with the JAX rope rows (f32 cos/sin may differ in the last bit
    # between the libraries) the new rows, codes and scales are bit-equal
    own = t_attention_step(tqkv, tk, tv, tpos,
                           torch.from_numpy(np.array(cj)),
                           torch.from_numpy(np.array(sj)), tks, tvs,
                           n_heads=H, kv_bits=kv_bits, attn_len=A)
    for i in range(1, 3 if fmt == "bf16" else 5):
        assert np.array_equal(_np(own[i]), _np(want[i])), i
    np.testing.assert_allclose(_np(own[0]), _np(want[0]), **ATTN)


@pytest.mark.parametrize("early_exit", [True, False])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("H,n_kv", [(4, 4), (8, 2)])
@pytest.mark.parametrize("case", ["edges", "mixed"])
def test_batched_split_matches_pallas_interpret(rng, early_exit, quantized,
                                                H, n_kv, case):
    """Without early exit every slot walks all four splits of the window,
    the ones past its position wholly masked."""
    p = np.array(POSITIONS[case], np.int32)
    B = len(p)
    jq, tq = _bf16(rng.standard_normal((B, H, D), dtype=np.float32))
    (jk, tk), (jv, tv), (jks, tks), (jvs, tvs) = _cache(
        rng, B, n_kv, "int8" if quantized else "bf16")
    want = j_bda(jq, jk, jv, jnp.asarray(p), jks, jvs, interpret=True,
                 early_exit=early_exit, attn_len=A)
    got = t_bda(tq, tk, tv, torch.from_numpy(p), tks, tvs, attn_len=A,
                early_exit=early_exit)
    assert got.shape == (B, H, D) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **ATTN)


@pytest.mark.parametrize("fmt", ["bf16", "int8", "int4"])
def test_attention_step_slot_alone_equals_batch(rng, fmt):
    """Each slot of a mixed batch gives the same bits alone, and the split
    walk agrees with the unsplit one (mono_layer's) to bf16 rounding of
    p."""
    p = np.array(POSITIONS["mixed"], np.int32)
    B, H, n_kv = len(p), 8, 2
    _, qkv = _bf16(rng.standard_normal((B, (H + 2 * n_kv) * D),
                                       dtype=np.float32))
    k, v, ks, vs = (x[1] for x in _cache(rng, B, n_kv, fmt))
    pos = torch.from_numpy(p)
    cos2, sinm = t_rope_rows(pos, D, 10000.0)
    kw = dict(n_heads=H, kv_bits=4 if fmt == "int4" else 8)
    batch = t_attention_step(qkv, k, v, pos, cos2, sinm, ks, vs, **kw)
    for b in range(B):
        one = t_attention_step(
            qkv[b:b + 1], k[b:b + 1], v[b:b + 1], pos[b:b + 1],
            cos2[b:b + 1], sinm[b:b + 1],
            *(x[b:b + 1] if x is not None else None for x in (ks, vs)), **kw)
        for x, y in zip(one, batch):
            assert (x is None and y is None) or torch.equal(x[0], y[b])
    unsplit = t_attention_step_plain(qkv, k, v, pos, cos2, sinm, ks, vs,
                                     split=False, **kw)
    np.testing.assert_allclose(_np(batch[0]), _np(unsplit[0]), **ATTN)
    for x, y in zip(batch[1:], unsplit[1:]):
        assert (x is None and y is None) or torch.equal(x, y)


@pytest.mark.parametrize("early_exit", [True, False])
@pytest.mark.parametrize("quantized", [False, True])
def test_batched_slot_alone_equals_batch(rng, early_exit, quantized):
    p = np.array(POSITIONS["mixed"], np.int32)
    B, H, n_kv = len(p), 8, 2
    _, q = _bf16(rng.standard_normal((B, H, D), dtype=np.float32))
    k, v, ks, vs = (x[1] for x in _cache(rng, B, n_kv,
                                         "int8" if quantized else "bf16"))
    pos = torch.from_numpy(p)
    kw = dict(attn_len=A, early_exit=early_exit)
    batch = t_bda(q, k, v, pos, ks, vs, **kw)
    for b in range(B):
        one = t_bda(q[b:b + 1], k[b:b + 1], v[b:b + 1], pos[b:b + 1],
                    *(x[b:b + 1] if x is not None else None
                      for x in (ks, vs)), **kw)
        assert torch.equal(one[0], batch[b])


def test_split_counts():
    """A slot's splits: one for no history rows, then one per SPLIT_ROWS
    rows or part of it."""
    assert SPLIT_ROWS % 64 == 0
    assert [n_splits(r) for r in (0, 1, SPLIT_ROWS, SPLIT_ROWS + 1,
                                  3 * SPLIT_ROWS + 5)] == [1, 1, 1, 2, 4]


def test_split_rows_matches_the_kernels():
    """The plain versions and the scratch sizes split at the same length
    as the kernels, whose SPLIT_ROWS is a constant of
    csrc/decode_attention.cuh."""
    import re
    from pathlib import Path

    import llama_cu_awq_torch

    header = (Path(llama_cu_awq_torch.__file__).parent / "csrc"
              / "decode_attention.cuh").read_text()
    found = re.findall(r"constexpr int SPLIT_ROWS = (\d+);", header)
    assert found == [str(SPLIT_ROWS)]
