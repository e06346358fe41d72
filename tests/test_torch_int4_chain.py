"""The port's chain experiment against the JAX package's, on the CPU.

llama_cu_awq_torch/experiments/int4_chain.py's plain versions (what a CPU
tensor takes) against tools/experiments/int4_chain.py's Pallas kernels in
interpret mode, loaded by path as tests/test_experimental_chain.py loads
them, on inputs made from a seed with numpy, with that file's shapes and
tolerances; against the port's own launch sequence bit for bit; the
`supported` gates and the refusals; and a whole decode step composed
layer by layer through ffn_chain and through mono_layer against the JAX
forward under attn_impl="fused_step". The kernels themselves run in
tests/test_torch_cuda.py on the card.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cu_awq_torch.config import ModelConfig as TModelConfig
from llama_cu_awq_torch.experiments import int4_chain as tch
from llama_cu_awq_torch.models import llama as tl
from llama_cu_awq_torch.ops.cuda.attention_step import (
    attention_step_plain as t_attention_step_plain)
from llama_cu_awq_torch.ops.linear import qmatmul_fused as t_qmatmul_fused
from llama_cu_awq_torch.ops.norms import RMS_EPS
from llama_cu_awq_torch.quant.qtensor import QTensor as TQ
from llama_cu_awq_tpu.config import ModelConfig
from llama_cu_awq_tpu.io.checkpoint import random_checkpoint
from llama_cu_awq_tpu.models import llama as jl
from llama_cu_awq_tpu.ops.pallas.attention_step import (
    attention_step as j_attention_step)
from llama_cu_awq_tpu.ops.pallas.attention_step import rope_rows
from llama_cu_awq_tpu.quant import packing
from llama_cu_awq_tpu.quant.qtensor import QTensor as JQ
from llama_cu_awq_tpu.quant.qtensor import to_tpu_layout

_spec = importlib.util.spec_from_file_location(
    "int4_chain_experiment",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "tools", "experiments", "int4_chain.py"))
jch = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jch)

# one intra-op thread per process: the suite runs in several worker
# processes, and torch's default pool in each oversubscribes the cores
torch.set_num_threads(1)


def _qtensors(rng, n_in, n_out):
    """The same quantized weight for both packages (the JAX one in the
    TPU kernel's planar layout). The TPU layout keeps the scales in bf16
    (packing.build_meta), the port's exact in fp16; scales rounded to
    bf16 here, which fp16 also holds exactly, give both packages the same
    dequantized weight, so what differs is the order of the f32 sums."""
    w = rng.normal(size=(n_in, n_out)).astype(np.float32) * 0.05
    qw, zeros, scales = packing.quantize_np(w)
    scales = np.asarray(jnp.asarray(scales, jnp.bfloat16), np.float32)
    j = JQ(jnp.asarray(qw), jnp.asarray(zeros), jnp.asarray(scales), n_in,
           n_out)
    return to_tpu_layout(j), TQ.from_numpy(qw, zeros, scales, n_in)


def _bf16(a):
    """numpy -> (jax bf16 array, torch bf16 tensor) with equal bits."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j, np.float32)).bfloat16()


def _f32(a):
    a = np.asarray(a, np.float32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _layer(rng, dim, hidden, qkv_dim=None):
    """(jax, torch) pairs of W_o, W_gate_up, W_down and, with qkv_dim,
    the next layer's W_qkv."""
    ws = [_qtensors(rng, dim, dim), _qtensors(rng, dim, 2 * hidden),
          _qtensors(rng, hidden, dim)]
    if qkv_dim:
        ws.append(_qtensors(rng, dim, qkv_dim))
    return [w[0] for w in ws], [w[1] for w in ws]


def _rows(rng, lead, dim):
    """attn, x_res (bf16) and the two rms weights (f32), as pairs."""
    attn = _bf16(rng.normal(size=(*lead, dim)))
    x = _bf16(rng.normal(size=(*lead, dim)))
    nw = _f32(rng.normal(size=(dim,)))
    nw2 = _f32(rng.normal(size=(dim,)))
    return attn, x, nw, nw2


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


def _run_chain(rng, lead, dim, hidden, qkv_dim=None):
    jw, tw = _layer(rng, dim, hidden, qkv_dim)
    attn, x, nw, nw2 = _rows(rng, lead, dim)
    kw_j, kw_t = {}, {}
    if qkv_dim:
        kw_j = dict(wqkv_next=jw[3], attn_norm_next=nw2[0])
        kw_t = dict(wqkv_next=tw[3], attn_norm_next=nw2[1])
    want = jch.ffn_chain(attn[0], x[0], nw[0], *jw[:3], eps=RMS_EPS,
                         interpret=True, **kw_j)
    got = tch.ffn_chain(attn[1], x[1], nw[1], *tw[:3], eps=RMS_EPS, **kw_t)
    return got, want


# the JAX test's bars (tests/test_experimental_chain.py:67-71, 128-135):
# the two packages sum in another order, so a bf16 row may round one ulp
# apart and carry that into the next stage
X_TOL = dict(rtol=3e-2, atol=3e-2)
SS_TOL = dict(rtol=1e-2, atol=1e-4)
QKV_TOL = dict(rtol=4e-2, atol=4e-2)


@pytest.mark.parametrize("m", [1, 4, 8])
@pytest.mark.parametrize("dim,hidden", [(512, 1024), (512, 1408)])
def test_ffn_chain_plain_matches_jax(rng, m, dim, hidden):
    (x, ss), (want_x, want_ss) = _run_chain(rng, (m,), dim, hidden)
    assert x.shape == (m, dim) and x.dtype == torch.bfloat16
    assert ss.shape == (m, 1) and ss.dtype == torch.float32
    _close(x, want_x, **X_TOL)
    _close(ss, want_ss, **SS_TOL)


@pytest.mark.parametrize("m", [1, 3])
def test_ffn_chain_qkv_stage_matches_jax(rng, m):
    (x, ss, qkv), (want_x, want_ss, want_qkv) = _run_chain(
        rng, (m,), 512, 1024, qkv_dim=1024)
    assert qkv.shape == (m, 1024) and qkv.dtype == torch.bfloat16
    _close(x, want_x, **X_TOL)
    _close(ss, want_ss, **SS_TOL)
    _close(qkv, want_qkv, **QKV_TOL)


def test_ffn_chain_3d_lead_shape(rng):
    (x, ss, qkv), (want_x, want_ss, want_qkv) = _run_chain(
        rng, (3, 1), 512, 1024, qkv_dim=768)
    assert x.shape == (3, 1, 512) and ss.shape == (3, 1, 1)
    assert qkv.shape == (3, 1, 768)
    _close(x, want_x, **X_TOL)
    _close(ss, want_ss, **SS_TOL)
    _close(qkv, want_qkv, **QKV_TOL)


@pytest.mark.parametrize("has_qkv", [False, True])
def test_ffn_chain_plain_equals_launch_sequence(rng, has_qkv):
    """The chain is the sequence it replaces: forward's _post_attention
    (o with the residual and rms scale, gate_up with the rmsnorm prologue,
    down with SwiGLU, residual and rms scale), then the next qkv with the
    rmsnorm prologue; equal bit for bit."""
    m, dim, hidden = 3, 256, 384
    _, tw = _layer(rng, dim, hidden, 320 if has_qkv else None)
    (_, attn), (_, x), (_, nw), (_, nw2) = _rows(rng, (m,), dim)
    kw = dict(wqkv_next=tw[3], attn_norm_next=nw2) if has_qkv else {}
    got = tch.ffn_chain(attn, x, nw, *tw[:3], eps=RMS_EPS, **kw)
    x1, ss1 = t_qmatmul_fused(attn, tw[0], residual=x, emit_ss_eps=RMS_EPS)
    gu, _ = t_qmatmul_fused(x1, tw[1], prescale=(ss1, nw))
    g, u = gu.chunk(2, dim=-1)
    want = t_qmatmul_fused(g, tw[2], silu_u=u, residual=x1,
                           emit_ss_eps=RMS_EPS)
    if has_qkv:
        want += (t_qmatmul_fused(want[0], tw[3],
                                 prescale=(want[1], nw2))[0],)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _attention_inputs(rng, B, A, H, n_kv, D, quantized):
    """qkv rows, the cache (bf16, or int8 codes with f32 scales), pos and
    the rope rows, as (jax, torch) pairs (tests/test_experimental_chain.py
    :155-176)."""
    qkv = _bf16(rng.standard_normal((B, (H + 2 * n_kv) * D)))
    pos = jnp.asarray([3, 255][:B], jnp.int32)
    cos2, sinm = rope_rows(pos, D, 10000.0)
    pos = (pos, torch.from_numpy(np.asarray(pos).copy()))
    cos2, sinm = _f32(cos2), _f32(sinm)
    if quantized:
        def codes():
            a = rng.integers(-127, 128, (B, A, n_kv, D)).astype(np.int8)
            return jnp.asarray(a), torch.from_numpy(a)
        kc, vc = codes(), codes()
        ks = _f32(rng.uniform(0.005, 0.02, (B, A, n_kv)))
        vs = _f32(rng.uniform(0.005, 0.02, (B, A, n_kv)))
    else:
        kc = _bf16(rng.standard_normal((B, A, n_kv, D)) * .3)
        vc = _bf16(rng.standard_normal((B, A, n_kv, D)) * .3)
        ks = vs = (None, None)
    return qkv, kc, vc, pos, cos2, sinm, ks, vs


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("has_qkv", [False, True])
def test_mono_layer_plain_matches_jax(rng, quantized, has_qkv):
    """tests/test_experimental_chain.py:141-214's case on both packages.

    x_out and ss to the JAX test's bars: the JAX mono_layer walks the
    window in blocks of batched_attention._pick_blk rows and rounds p to
    bf16 per block, the port in chunks of 64, and the scales differ as in
    the chain tests. The new k and v rows are equal: both sides rotate
    and round alike, and for int8 the codes rint(k / scale) agree. The
    int8 scales: the JAX kernel computes absmax / 127.0, the port
    absmax * f32(1/127) (what XLA makes of the JAX package's division
    inside a jit, quant/kv.py); the two differ by at most one f32 ulp, so
    rtol=1e-6, the JAX test's own bar for ksn."""
    B, A, H, n_kv, D = 2, 256, 4, 2, 128
    dim, hidden = H * D, 1024
    jw, tw = _layer(rng, dim, hidden, (H + 2 * n_kv) * D if has_qkv else 0)
    qkv, kc, vc, pos, cos2, sinm, ks, vs = _attention_inputs(
        rng, B, A, H, n_kv, D, quantized)
    x = _bf16(rng.standard_normal((B, dim)))
    nw, nw2 = _f32(rng.normal(size=(dim,))), _f32(rng.normal(size=(dim,)))
    assert tch.mono_supported(*tw[:3], B, D, A, H, n_kv,
                              tw[3] if has_qkv else None)
    args = [qkv, x, nw, None, None, None, kc, vc, pos, cos2, sinm, ks, vs]

    def side(i, w, mono):
        a = [p[i] if p is not None else None for p in args]
        a[3:6] = w[:3]
        kw = dict(n_heads=H, attn_len=A, eps=RMS_EPS)
        if has_qkv:
            kw.update(wqkv_next=w[3], attn_norm_next=nw2[i])
        if i == 0:
            kw["interpret"] = True
        return mono(*a, **kw)

    want = side(0, jw, jch.mono_layer)
    got = side(1, tw, tch.mono_layer)
    assert len(got) == len(want) == (7 if has_qkv else 6)
    _close(got[0], want[0], **X_TOL)
    _close(got[1], want[1], **SS_TOL)
    for g_, w_ in zip(got[2:4], want[2:4]):
        assert g_.dtype == (torch.int8 if quantized else torch.bfloat16)
        np.testing.assert_array_equal(g_.float().numpy(),
                                      np.asarray(w_, np.float32))
    if quantized:
        for g_, w_ in zip(got[4:6], want[4:6]):
            np.testing.assert_allclose(g_.numpy(), np.asarray(w_),
                                       rtol=1e-6)
    else:
        assert got[4] is None and got[5] is None
    if has_qkv:
        _close(got[6], want[6], **QKV_TOL)

    # against JAX attention_step (jitted by its own caller in forward; the
    # scale rule above): the same new rows
    j_attn = j_attention_step(qkv[0], kc[0], vc[0], pos[0], cos2[0],
                              sinm[0], ks[0], vs[0], n_heads=H, attn_len=A,
                              interpret=True)
    for g_, w_ in zip(got[2:4], j_attn[1:3]):
        np.testing.assert_array_equal(g_.float().numpy(),
                                      np.asarray(w_, np.float32))

    # and the port's own two-launch sequence: bit for bit where attention
    # walks the window's splits, as attention_step and mono's kernel do;
    # against the unsplit walk the new rows are bit-equal and the rest
    # agree to the JAX bars above
    kw = dict(wqkv_next=tw[3], attn_norm_next=nw2[1]) if has_qkv else {}
    for split in (True, False):
        attn, kn, vn, ksn, vsn = t_attention_step_plain(
            qkv[1], kc[1], vc[1], pos[1], cos2[1], sinm[1], ks[1], vs[1],
            n_heads=H, split=split)
        chain = tch.ffn_chain(attn.reshape(B, dim).bfloat16(), x[1], nw[1],
                              *tw[:3], eps=RMS_EPS, **kw)
        seq = chain[:2] + (kn, vn, ksn, vsn) + chain[2:]
        for i, (a, b) in enumerate(zip(got, seq)):
            if a is None or b is None:
                assert a is None and b is None
            elif split or i in (2, 3, 4, 5):
                assert torch.equal(a, b)
            else:
                _close(a, b.float().numpy(),
                       **(X_TOL, SS_TOL, None, None, None, None,
                          QKV_TOL)[i])


def test_supported_gates(rng):
    """The port kernel's own limits, not the TPU's VMEM arithmetic."""
    _, (wo, wgu, wd) = _layer(rng, 256, 384)
    _, wq = _qtensors(rng, 256, 320)
    assert tch.ffn_chain_supported(wo, wgu, wd, 1)
    assert tch.ffn_chain_supported(wo, wgu, wd, 10_000, wq)  # more passes
    assert not tch.ffn_chain_supported(wo, wgu, wd, 0)
    _, wq_other = _qtensors(rng, 288, 320)
    assert not tch.ffn_chain_supported(wo, wgu, wd, 1, wq_other)
    _, wd_other = _qtensors(rng, 416, 256)  # down takes 416, gate_up 384
    assert not tch.ffn_chain_supported(wo, wgu, wd_other, 1)
    _, (wo_odd, wgu_odd, wd_odd) = _layer(rng, 256, 400)  # 400 % 32 != 0
    assert not tch.ffn_chain_supported(wo_odd, wgu_odd, wd_odd, 1)
    # one staged row of 110592 inputs (235 KB) fits no block: never
    # co-resident
    wide = 110_592
    fake = TQ(torch.empty(0), torch.empty(0), torch.empty(0), wide, 256)
    fake_gu = TQ(torch.empty(0), torch.empty(0), torch.empty(0), 256,
                 2 * wide)
    assert not tch.ffn_chain_supported(wo, fake_gu, fake, 1)
    assert tch.mono_supported(wo, wgu, wd, 2, 128, 200, 2, 2, wq)
    assert tch.mono_supported(wo, wgu, wd, 2, 64, 200, 4, 1)  # GQA 4/1
    assert not tch.mono_supported(wo, wgu, wd, 2, 16, 200, 16, 16)
    assert not tch.mono_supported(wo, wgu, wd, 2, 128, 200, 4, 4)  # 512
    assert tch.mono_supported(wo, wgu, wd, 2, 32, 200, 8, 1)  # kv_mul 8


def test_refusals(rng):
    """Shapes the kernel cannot take raise ValueError on every device, and
    the int4 KV cache raises: the JAX mono_layer takes bf16 or int8.
    Nothing falls back."""
    B, H, n_kv, D, A = 1, 2, 2, 128, 64
    dim = H * D
    _, (wo, wgu, wd) = _layer(rng, dim, 384)
    attn = torch.zeros(B, dim, dtype=torch.bfloat16)
    x = torch.zeros(B, dim, dtype=torch.bfloat16)
    nw = torch.ones(dim)
    with pytest.raises(ValueError, match="width 128"):
        tch.ffn_chain(attn[:, :128], x, nw, wo, wgu, wd, eps=RMS_EPS)
    with pytest.raises(ValueError, match="x_res"):
        tch.ffn_chain(attn, x[:, :128], nw, wo, wgu, wd, eps=RMS_EPS)
    _, wd_other = _qtensors(rng, 416, dim)
    with pytest.raises(ValueError, match="cannot take"):
        tch.ffn_chain(attn, x, nw, wo, wgu, wd_other, eps=RMS_EPS)
    with pytest.raises(ValueError, match="together"):
        tch.ffn_chain(attn, x, nw, wo, wgu, wd, eps=RMS_EPS,
                      wqkv_next=wo)
    with pytest.raises(ValueError, match="bf16"):
        tch.ffn_chain(attn, x, nw, wo, wgu, wd, eps=RMS_EPS,
                      out_dtype=torch.float32)

    qkv = torch.zeros(B, (H + 2 * n_kv) * D, dtype=torch.bfloat16)
    pos = torch.tensor([5], dtype=torch.int32)
    rot = torch.zeros(B, D)
    scale = torch.ones(B, A, n_kv)
    kv4 = torch.zeros(B, A, n_kv, D // 2, dtype=torch.int8)
    with pytest.raises(ValueError, match="int4"):
        tch.mono_layer(qkv, x, nw, wo, wgu, wd, kv4, kv4, pos, rot, rot,
                       scale, scale, n_heads=H, eps=RMS_EPS)
    kv = torch.zeros(B, A, n_kv, D, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="n_heads=4"):
        tch.mono_layer(qkv, x, nw, wo, wgu, wd, kv, kv, pos, rot, rot,
                       n_heads=4, eps=RMS_EPS)
    cfg = TModelConfig(dim=dim, hidden_dim=384, n_layers=1, n_heads=H,
                         n_kv_heads=n_kv, vocab_size=32, seq_len=A)
    params = tl.LlamaParams(torch.zeros(32, dim, dtype=torch.bfloat16),
                            torch.zeros(32, dim, dtype=torch.bfloat16),
                            nw, [tl.LlamaLayer(nw, nw, wo, wo, wgu, wd)])
    cache4 = tl.init_kv_cache(cfg, 1, A, quantized=True, kv_bits=4,
                              device="cpu")
    tok = torch.tensor([[3]])
    with pytest.raises(ValueError, match="int4"):
        tch.decode_step(params, cfg, tok, pos, cache4, layer_impl="mono")
    cache = tl.init_kv_cache(cfg, 1, A, device="cpu")
    with pytest.raises(ValueError, match="layer_impl"):
        tch.decode_step(params, cfg, tok, pos, cache, layer_impl="chain")


SLICE_CFG = ModelConfig(dim=256, hidden_dim=384, n_layers=2, n_heads=2,
                        n_kv_heads=2, vocab_size=256, seq_len=256)
TOKENS = [1, 7, 42, 3]


@pytest.mark.parametrize("quantized", [False, True])
def test_decode_step_matches_jax_forward(quantized):
    """The slice as a whole: T=1 decode steps composed layer by layer
    through attention_step + ffn_chain (with the next layer's qkv) and
    through mono_layer, on the plain versions, against the JAX forward
    under attn_impl="fused_step" (its attention_step kernel in interpret
    mode). head_dim 128: the conftest's tiny configs have head_dim 16,
    which fused_step refuses. Logits to the bar of
    tests/test_torch_model.py's fused_step test (the JAX kernel walks its
    window in one block, the port in chunks of 64, and bf16 activations
    may round one ulp apart after); both compositions equal the port's
    own forward(attn_impl="fused_step") bit for bit, caches included."""
    cfg = SLICE_CFG
    jp = jl.params_from_checkpoint(random_checkpoint(cfg, seed=11),
                                   param_dtype=jnp.bfloat16)
    tp = tl.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg,
                              device="cpu")
    jc = jl.init_kv_cache(cfg, 1, 256, quantized=quantized)
    caches = {k: tl.init_kv_cache(cfg, 1, 256, quantized=quantized,
                                  device="cpu")
              for k in ("forward", "ffn_chain", "mono")}
    for step, t in enumerate(TOKENS):
        want, jc = jl.forward(jp, cfg, jnp.asarray([[t]], jnp.int32),
                              jnp.asarray([step], jnp.int32), jc,
                              fused=True, matmul_impl="dequant",
                              attn_impl="fused_step")
        tok = torch.tensor([[t]])
        pos = torch.tensor([step], dtype=torch.int32)
        ref, _ = tl.forward(tp, cfg, tok, pos, caches["forward"],
                            attn_impl="fused_step")
        for impl in tch.LAYER_IMPLS:
            got, _ = tch.decode_step(tp, cfg, tok, pos, caches[impl],
                                     layer_impl=impl)
            assert got.shape == (1, cfg.vocab_size)
            assert torch.equal(got, ref), impl
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=2e-2, atol=2e-2)
            assert got.argmax() == int(np.asarray(want).argmax())
    for impl in tch.LAYER_IMPLS:
        c, r = caches[impl], caches["forward"]
        for a, b in zip(c.k + c.v + c.k_scale + c.v_scale,
                        r.k + r.v + r.k_scale + r.v_scale):
            assert torch.equal(a, b)
